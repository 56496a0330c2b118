// int8 convolution for Hopper (sm_90a): y_i32 = conv(x_i8, w_i8), then the
// f32 epilogue of the JAX executor's int8 branch.
//
// Replaces the int8 branch of complex_yolov4_tpu/models/network.py apply
// (lines 456-501), which XLA computes on the TPU; there is no Pallas
// original, and torch has no int8 conv2d on CUDA. Built with the other
// kernels by ops/_build.py (nvcc, plain C interface, ctypes); launches on
// the stream it is given, allocates nothing, returns cudaGetLastError().
//
// Function. x (B, H, W, C_in) int8 NHWC, w (C_out, K) int8 with K = k*k*C_in
// in (ky, kx, ci) order, k in {1, 3}, stride 1 or 2, symmetric padding
// (k-1)/2 (stride 2 reads input rows 2i-1..2i+1, as F.conv2d). Epilogue, in
// f32 and in the JAX order: h = y * (s_x * w_scale[oc]) + b, then the
// activation; then one of
//   mode 0: bf16(h);
//   mode 1: int8 clip(rint(h * inv_s_next), -127, 127) (round half to
//           even), the chained requantization to the consumer's domain;
//   mode 2: the raw int32 sum y (for checks).
// __fmul_rn / __fadd_rn / __fdiv_rn keep nvcc from contracting the epilogue
// into FMAs, so it rounds as the plain PyTorch version's separate ops do.
//
// What bounds it: complex_yolov4's 68 int8 convs at 608 (batch 8) run at
// 76, 38 and 19 px with C_in 256-2048: implicit GEMMs of M = 2,888-46,208
// pixels, N = 128-1024, K = 256-4,608. A 3x3 512 -> 1024 at 19 px is 2 x
// 2,888 x 1,024 x 4,608 = 27 GOP against 3 MB of input and 4.7 MB of
// weights: far above the ridge, bounded by the tensor cores' int8 rate
// (1,979 TOP/s dense), which only wgmma reaches.
//
// What the design does (simple and correct first): implicit GEMM, no
// im2col in device memory. A block owns 64 output pixels x 64 output
// channels; per 64-deep K step it gathers its pixels' patch rows straight
// from NHWC (16-byte loads of 16 channels; C_in % 16 == 0, so a load never
// straddles two taps; zeros for padding) and the weight slice into shared
// memory, stored as four 16-deep sub-tiles so every WMMA pointer is 256-bit
// aligned. Four warps (2 x 2, 32 x 32 each) run WMMA s8 16x16x16 with int32
// accumulation. The int32 tile goes through shared memory to the f32
// epilogue and one store per 8 channels. cp.async, TMA and wgmma (s8
// m64nNk32) are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

namespace wmma = nvcuda::wmma;

constexpr int IBM = 64;   // output pixels per block
constexpr int IBN = 64;   // output channels per block
constexpr int IBK = 64;   // contraction depth (bytes) per step
constexpr int IKS = IBK / 16;
constexpr int IC_LD = IBN + 4;
constexpr int I8_THREADS = 128;
enum Act { ACT_LINEAR = 0, ACT_MISH = 1, ACT_LEAKY = 2, ACT_RELU = 3 };
enum Mode { OUT_BF16 = 0, OUT_INT8 = 1, OUT_INT32 = 2 };

// The port's f32 activations (ops/activations.py act), each op rounded
// once as PyTorch's separate f32 ops are.
__device__ __forceinline__ float act_f32(float x, int act) {
  if (act == ACT_MISH) {
    const float s = expf(fminf(x, 20.0f));
    const float q = __fadd_rn(__fmul_rn(s, s), __fmul_rn(2.0f, s));
    return x > 20.0f ? x : __fdiv_rn(__fmul_rn(x, q), __fadd_rn(q, 2.0f));
  }
  if (act == ACT_LEAKY) return x > 0.0f ? x : __fmul_rn(x, 0.1f);
  if (act == ACT_RELU) return fmaxf(x, 0.0f);
  return x;
}

__global__ void __launch_bounds__(I8_THREADS)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ w_scale, const float* __restrict__ bias,
                 void* __restrict__ out, int B, int H, int W, int C_in, int C_out,
                 int ksize, int stride, float s_x, int act, int mode, float inv_s_next) {
  __shared__ __align__(128) int8_t As[IKS][IBM * 16];
  __shared__ __align__(128) int8_t Bs[IKS][IBN * 16];
  __shared__ __align__(128) int Cs[IBM * IC_LD];
  __shared__ int row_n[IBM], row_ih[IBM], row_iw[IBM];

  const int pad = (ksize - 1) / 2;
  const int Ho = (H + 2 * pad - ksize) / stride + 1;
  const int Wo = (W + 2 * pad - ksize) / stride + 1;
  const long long M = (long long)B * Ho * Wo;
  const int K = ksize * ksize * C_in;
  const long long m0 = (long long)blockIdx.x * IBM;
  const int n0 = blockIdx.y * IBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;

  if (tid < IBM) {
    const long long m = m0 + tid;
    if (m < M) {
      const int ow = (int)(m % Wo);
      const int oh = (int)((m / Wo) % Ho);
      row_n[tid] = (int)(m / ((long long)Wo * Ho));
      row_ih[tid] = oh * stride - pad;
      row_iw[tid] = ow * stride - pad;
    } else {
      row_n[tid] = -1;
      row_ih[tid] = 0;
      row_iw[tid] = 0;
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += IBK) {
    // A: 64 rows x 4 chunks of 16 channels; chunk q of row r -> As[q][r]
    for (int c = tid; c < IBM * IKS; c += I8_THREADS) {
      const int r = c / IKS, q = c % IKS;
      const int k = k0 + q * 16;
      uint4 v = make_uint4(0, 0, 0, 0);
      const int n = row_n[r];
      if (n >= 0 && k < K) {
        const int tap = k / C_in, ci = k - tap * C_in;
        const int ih = row_ih[r] + tap / ksize, iw = row_iw[r] + tap % ksize;
        if (ih >= 0 && ih < H && iw >= 0 && iw < W)
          v = *reinterpret_cast<const uint4*>(x + (((long long)n * H + ih) * W + iw) * C_in + ci);
      }
      *reinterpret_cast<uint4*>(&As[q][r * 16]) = v;
    }
    // B: 64 output channels x 4 chunks of 16 k; (k, n) at Bs[q][n*16 + k%16]
    for (int c = tid; c < IBN * IKS; c += I8_THREADS) {
      const int nn = c / IKS, q = c % IKS;
      const int k = k0 + q * 16, n = n0 + nn;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k < K && n < C_out) v = *reinterpret_cast<const uint4*>(w + (long long)n * K + k);
      *reinterpret_cast<uint4*>(&Bs[q][nn * 16]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < IKS; ++q) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[q][(wm * 32 + i * 16) * 16], 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[q][(wn * 32 + j * 16) * 16], 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm * 32 + i * 16) * IC_LD + wn * 32 + j * 16], acc[i][j],
                              IC_LD, wmma::mem_row_major);
  __syncthreads();

  for (int c = tid; c < IBM * (IBN / 8); c += I8_THREADS) {
    const int r = c / (IBN / 8), nc = (c % (IBN / 8)) * 8;
    const long long m = m0 + r;
    const int n = n0 + nc;
    if (m >= M || n >= C_out) continue;
    const int* y = &Cs[r * IC_LD + nc];
    if (mode == OUT_INT32) {
      int4* dst = reinterpret_cast<int4*>(static_cast<int*>(out) + m * C_out + n);
      dst[0] = make_int4(y[0], y[1], y[2], y[3]);
      dst[1] = make_int4(y[4], y[5], y[6], y[7]);
      continue;
    }
    float h[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float scale = __fmul_rn(s_x, w_scale[n + t]);
      h[t] = act_f32(__fadd_rn(__fmul_rn((float)y[t], scale), bias[n + t]), act);
    }
    if (mode == OUT_INT8) {
      uint2 v;
      int8_t* p = reinterpret_cast<int8_t*>(&v);
#pragma unroll
      for (int t = 0; t < 8; ++t)
        p[t] = (int8_t)fminf(fmaxf(rintf(__fmul_rn(h[t], inv_s_next)), -127.0f), 127.0f);
      *reinterpret_cast<uint2*>(static_cast<int8_t*>(out) + m * C_out + n) = v;
    } else {
      uint4 v;
      uint32_t* p = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        __nv_bfloat162 b2 = __floats2bfloat162_rn(h[2 * t], h[2 * t + 1]);
        p[t] = *reinterpret_cast<uint32_t*>(&b2);
      }
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + m * C_out + n) = v;
    }
  }
}

}  // namespace

extern "C" {

// x (B, H, W, C_in) int8 NHWC; w (C_out, k*k*C_in) int8; w_scale, bias
// (C_out,) f32; out (B, Ho, Wo, C_out) bf16 (mode 0), int8 (mode 1) or
// int32 (mode 2). C_in % 16 == 0, C_out % 8 == 0.
int cyv4_int8_conv(const void* x, const void* w, const void* w_scale, const void* bias,
                   void* out, int B, int H, int W, int C_in, int C_out, int ksize,
                   int stride, float s_x, int act, int mode, float inv_s_next,
                   void* stream) {
  if (C_in % 16 || C_out % 8 || (ksize != 1 && ksize != 3) || (stride != 1 && stride != 2))
    return (int)cudaErrorInvalidValue;
  const int pad = (ksize - 1) / 2;
  const long long M = (long long)B * ((H + 2 * pad - ksize) / stride + 1) *
                      ((W + 2 * pad - ksize) / stride + 1);
  dim3 grid((unsigned)((M + IBM - 1) / IBM), (unsigned)((C_out + IBN - 1) / IBN));
  int8_conv_kernel<<<grid, I8_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(w_scale), static_cast<const float*>(bias), out, B, H, W,
      C_in, C_out, ksize, stride, s_x, act, mode, inv_s_next);
  return (int)cudaGetLastError();
}

}  // extern "C"
