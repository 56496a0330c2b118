// Fused CSP stage for Hopper (sm_90a): one launch runs a whole stride-1
// segment of the early backbone (1x1 and 3x3 convs, shortcut, concat, CSP
// slice), and no intermediate goes to device memory.
//
// Replaces complex_yolov4_tpu/ops/fused_stage.py apply_segment (pallas_call
// at :531). Built with the other kernels by ops/_build.py (nvcc, plain C
// interface, ctypes); launches on the stream it is given, allocates
// nothing, returns cudaGetLastError() of its launch.
//
// What bounds it: run layer by layer, segment 2-10 of complex_yolov4 at 304
// (batch 8, 739,328 pixels) does 81,920 FLOP per pixel (60.6 GFLOP) and
// moves 1,216 bf16 channels per pixel through device memory (each layer
// reads its inputs and writes its output: 1.8 GB), ~34 FLOP/byte, far below
// the card's ~295 FLOP/byte bf16 ridge: bounded by bytes. Fused, the stage
// reads 64 and writes 64 channels per pixel (189 MB), ~320 FLOP/byte.
//
// What the design does. The TPU kernel keeps a full-width row tile in 100+
// MB of VMEM; a Hopper block has 227 KB of shared memory, and one 152-pixel
// row of segment 12-23 with its 256 live channels is 78 KB. So a block owns
// a 2-D window of win_h x win_w pixels (win_w a multiple of 16) of one
// frame and writes the (win_h - 2*halo) x (win_w - 2*halo) tile at its
// centre, halo = the segment's number of 3x3 convs. Every op is computed on
// the whole window; each 3x3 invalidates one more ring at the window's
// edge, and after `halo` of them the centre tile is still exact. The
// window's arithmetic, chosen by ops/fused_stage.py pick_tile (the largest
// share of useful output pixels whose buffers fit 227 KB), for
// complex_yolov4:
//   seg 2-10  (halo 1): peak 256 live channels = 512 B/px; a 22 x 16
//     window is (22+2) x (16+2) stored px x 512 B = 221 KB, plus 8 KB of
//     epilogue staging = 229,376 B; it writes 20 x 14 of 352 pixels (80%);
//   seg 12-23 (halo 2): peak 256 channels; the same 22 x 16 window and
//     229,376 B; it writes 18 x 12 of 352 pixels (61%: the 2-pixel halo
//     costs 1.6x recompute). A 16 x 16 output tile (20 x 20 window) would
//     need (22 x 22) x 512 B = 248 KB with the border: it does not fit.
// 152 and 304 are not multiples of the output tile, so edge tiles are
// ragged and masked on store.
//
// Values. Each buffer (the input, each conv and shortcut output) is a
// (win_h+2) x (win_w+2) pixel slot of C bf16 channels in shared memory; the
// one-pixel border lets the 16 pixels of a WMMA row tile, shifted by a 3x3
// tap, be one strided load. Identity, slice and concat are aliases: a
// value is a list of parts (offset, row stride, channels), and a conv over
// a concat runs as a K-split over its parts. The planner (Python) places
// the buffers greedily by size over their live ranges and hands the kernel an
// int32 op table: the segment is data, one generic kernel runs all.
//
// Padding. The TPU kernel zeroes out-of-image rows before each 3x3 and
// gets its column padding from jnp.pad. Here a window reaches past the
// image on both axes. Every epilogue (and the input load) stores zero at
// out-of-image positions, so each 3x3 reads zero padding on rows and
// columns; in-image values are exactly those of zero-padding each 3x3's
// input, since pointwise ops never move values across positions.
//
// Math. Each conv is a GEMM over the window's pixels: WMMA bf16 16x16x16
// with f32 accumulation, a warp owning 16 output channels x 4 row tiles of
// 16 pixels. Weights are read as WMMA fragments straight from device memory
// (the segment's whole set, <= 237 KB, stays in L2), each fragment feeding
// 4 mma; shared memory holds the values. Epilogues follow the Pallas
// kernel's plain layout and its activation formulas: bf16(acc + b), then
// the activation with every step rounded to bf16 as PyTorch's bf16 ops do.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (batch 8): a first cut that
// gave each warp 16 pixels x all C_out (one weight fragment per mma) took
// the same time, 4.87 ms for segment 2-10; truncating the op table showed
// the bf16 mish epilogues take 38% of it and a 1x1 64 -> 64 runs at ~20
// TFLOP/s, so neither the weight loads nor their order bound it.
// Simple and correct first: no cp.async, TMA or wgmma; the window is
// recomputed on every op instead of shrinking.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

namespace wmma = nvcuda::wmma;

constexpr int FS_THREADS = 256;
constexpr int FS_WARPS = FS_THREADS / 32;
constexpr int HDR = 20;  // header ints (ops/fused_stage.py build_program)
constexpr int ROW = 20;  // ints per op row
enum Kind { K_CONV1 = 0, K_CONV3 = 1, K_SHORTCUT = 2 };
enum Act { ACT_LINEAR = 0, ACT_MISH = 1, ACT_LEAKY = 2, ACT_RELU = 3 };

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The Pallas kernel's activations (ops/fused_stage.py seg_act) on a bf16
// value, each PyTorch bf16 op rounded to bf16: mish = x * (q / (q + 2)),
// q = s*s + 2s, s = exp(min(x, 20)), no branch; leaky = max(x, 0.1x).
__device__ __forceinline__ float act_bf16(float x, int act) {
  if (act == ACT_MISH) {
    const float s = bf(expf(fminf(x, 20.0f)));
    const float q = bf(bf(s * s) + bf(2.0f * s));
    return bf(x * bf(q / bf(q + 2.0f)));
  }
  if (act == ACT_LEAKY) return fmaxf(x, bf(x * 0.1f));
  if (act == ACT_RELU) return fmaxf(x, 0.0f);
  return x;
}

__device__ __forceinline__ void unpack8(uint4 v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 t = __bfloat1622float2(h[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 r;
  uint32_t* p = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    p[j] = *reinterpret_cast<uint32_t*>(&h);
  }
  return r;
}

struct Window {
  int win_h, win_w, ws;  // computed window, stored row width (win_w + 2)
  int gy0, gx0;          // image coordinates of window pixel (0, 0)
  int H, W;
  __device__ bool in_image(int r, int c) const {
    const int gy = gy0 + r, gx = gx0 + c;
    return gy >= 0 && gy < H && gx >= 0 && gx < W;
  }
};

// One conv op (1x1 or 3x3) over the window: out = act(bf16(sum + b)). A
// warp's work item is one 16-channel output slice of MG row tiles (16
// pixels each): every weight fragment, read from device memory (L2), feeds
// MG mma, and the MG A fragments come from shared memory.
constexpr int MG = 4;

__device__ void conv_op(const int* op, __nv_bfloat16* vals, float* stage,
                        const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ bias, const Window& win) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool is3 = op[0] == K_CONV3;
  const int act = op[1], cout = op[2], out_off = op[3], nparts = op[6];
  const __nv_bfloat16* wp = w + op[4];
  const float* bp = bias + op[5];
  int cin = 0;
  for (int p = 0; p < nparts; ++p) cin += op[9 + 3 * p];
  const int tiles_per_row = win.win_w / 16;
  const int n_mt = win.win_h * tiles_per_row;
  const int n_groups = (n_mt + MG - 1) / MG;
  const int nj = cout / 16;
  const int ntaps = is3 ? 9 : 1;

  for (int item = warp; item < nj * n_groups; item += FS_WARPS) {
    const int j = item % nj, mt0 = (item / nj) * MG;
    int pix[MG];  // stored offset of each row tile's first pixel
#pragma unroll
    for (int i = 0; i < MG; ++i) {
      const int mt = min(mt0 + i, n_mt - 1);
      pix[i] = (mt / tiles_per_row) * win.ws + (mt % tiles_per_row) * 16;
    }
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MG];
#pragma unroll
    for (int i = 0; i < MG; ++i) wmma::fill_fragment(acc[i], 0.0f);
    for (int tap = 0; tap < ntaps; ++tap) {
      // stored position of window pixel (r, c) is (r + 1, c + 1); tap
      // (ky, kx) of output (r, c) reads window pixel (r + ky - 1, c + kx - 1)
      const int ky = is3 ? tap / 3 : 1, kx = is3 ? tap % 3 : 1;
      const int shift = ky * win.ws + kx;
      int krow = tap * cin;
      for (int p = 0; p < nparts; ++p) {
        const int off = op[7 + 3 * p], ld = op[8 + 3 * p], c = op[9 + 3 * p];
        for (int k = 0; k < c; k += 16) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, wp + (long long)(krow + k) * cout + j * 16, cout);
#pragma unroll
          for (int i = 0; i < MG; ++i) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
            wmma::load_matrix_sync(a, vals + off + (pix[i] + shift) * ld + k, ld);
            wmma::mma_sync(acc[i], a, b, acc[i]);
          }
        }
        krow += c;
      }
    }
    // epilogue: lane -> pixel lane/2, channels (lane%2)*8 .. +7 of the slice
    const int px = lane / 2, ch0 = (lane % 2) * 8;
#pragma unroll
    for (int i = 0; i < MG; ++i) {
      if (mt0 + i >= n_mt) break;
      const int mt = mt0 + i;
      const int r = mt / tiles_per_row, c0 = (mt % tiles_per_row) * 16;
      wmma::store_matrix_sync(stage, acc[i], 16, wmma::mem_row_major);
      __syncwarp();
      const bool inside = win.in_image(r, c0 + px);
      float v[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float y = bf(stage[px * 16 + ch0 + t] + bp[j * 16 + ch0 + t]);
        v[t] = inside ? act_bf16(y, act) : 0.0f;
      }
      *reinterpret_cast<uint4*>(
          vals + out_off + ((r + 1) * win.ws + c0 + px + 1) * cout + j * 16 + ch0) = pack8(v);
      __syncwarp();
    }
  }
}

// out = act(bf16(a + b)) over the window; zero outside the image.
__device__ void shortcut_op(const int* op, __nv_bfloat16* vals, const Window& win) {
  const int act = op[1], cout = op[2], out_off = op[3];
  const int a_off = op[7], a_ld = op[8], b_off = op[10], b_ld = op[11];
  const int c8 = cout / 8;
  const int n = win.win_h * win.win_w * c8;
  for (int e = threadIdx.x; e < n; e += FS_THREADS) {
    const int ch = (e % c8) * 8, p = e / c8;
    const int r = p / win.win_w, c = p % win.win_w;
    const int sp = (r + 1) * win.ws + c + 1;
    float v[8];
    if (win.in_image(r, c)) {
      float a[8], b[8];
      unpack8(*reinterpret_cast<const uint4*>(vals + a_off + sp * a_ld + ch), a);
      unpack8(*reinterpret_cast<const uint4*>(vals + b_off + sp * b_ld + ch), b);
#pragma unroll
      for (int t = 0; t < 8; ++t) v[t] = act_bf16(bf(a[t] + b[t]), act);
    } else {
#pragma unroll
      for (int t = 0; t < 8; ++t) v[t] = 0.0f;
    }
    *reinterpret_cast<uint4*>(vals + out_off + sp * cout + ch) = pack8(v);
  }
}

__global__ void __launch_bounds__(FS_THREADS)
fused_stage_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ bias, const int* __restrict__ prog,
                   __nv_bfloat16* __restrict__ out, int B, int H, int W, int C_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_rows = prog[0], halo = prog[3], in_off = prog[4], cin = prog[5];
  const int vals_elems = prog[6];
  __nv_bfloat16* vals = reinterpret_cast<__nv_bfloat16*>(smem);
  float* stage = reinterpret_cast<float*>(smem + (size_t)vals_elems * 2) +
                 (threadIdx.x / 32) * 256;
  Window win;
  win.win_w = prog[1];
  win.win_h = prog[2];
  win.ws = win.win_w + 2;
  win.H = H;
  win.W = W;
  const int ty = win.win_h - 2 * halo, tx = win.win_w - 2 * halo;
  const int n = blockIdx.z;
  win.gy0 = blockIdx.y * ty - halo;
  win.gx0 = blockIdx.x * tx - halo;

  // Zero the value slots (their borders are read by edge taps).
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < vals_elems / 8; i += FS_THREADS)
    reinterpret_cast<uint4*>(vals)[i] = zero;
  __syncthreads();

  // Input window, zero outside the image.
  const int cv = cin / 8;
  for (int e = threadIdx.x; e < win.win_h * win.win_w * cv; e += FS_THREADS) {
    const int ch = (e % cv) * 8, p = e / cv;
    const int r = p / win.win_w, c = p % win.win_w;
    uint4 v = zero;
    if (win.in_image(r, c))
      v = *reinterpret_cast<const uint4*>(
          x + (((long long)n * H + win.gy0 + r) * W + win.gx0 + c) * cin + ch);
    *reinterpret_cast<uint4*>(vals + in_off + ((r + 1) * win.ws + c + 1) * cin + ch) = v;
  }
  __syncthreads();

  for (int oi = 0; oi < n_rows; ++oi) {
    const int* op = prog + HDR + oi * ROW;
    if (op[0] == K_SHORTCUT) {
      shortcut_op(op, vals, win);
    } else {
      conv_op(op, vals, stage, w, bias, win);
    }
    __syncthreads();
  }

  // The centre tile of the last value, written where it lies in the image.
  const int n_out = prog[7];
  const int c8 = C_out / 8;
  for (int e = threadIdx.x; e < ty * tx * c8; e += FS_THREADS) {
    int ch = (e % c8) * 8;
    const int p = e / c8;
    const int oy = p / tx, ox = p % tx;
    const int gy = blockIdx.y * ty + oy, gx = blockIdx.x * tx + ox;
    if (gy >= H || gx >= W) continue;
    const int sp = (halo + oy + 1) * win.ws + halo + ox + 1;
    const int out_ch = ch;
    int q = 0;
    while (q < n_out - 1 && ch >= prog[10 + 3 * q]) {
      ch -= prog[10 + 3 * q];
      ++q;
    }
    const uint4 v = *reinterpret_cast<const uint4*>(
        vals + prog[8 + 3 * q] + sp * prog[9 + 3 * q] + ch);
    *reinterpret_cast<uint4*>(out + (((long long)n * H + gy) * W + gx) * C_out + out_ch) = v;
  }
}

}  // namespace

extern "C" {

// x (B, H, W, C_in) bf16 NHWC; w, bias: the segment's packed weights;
// prog: the int32 op table on the device; out (B, H, W, C_out) bf16.
// win_h x win_w: the computed window; smem_bytes: its shared memory.
int cyv4_fused_stage(const void* x, const void* w, const void* bias, const void* prog,
                     void* out, int B, int H, int W, int C_in, int C_out, int win_h,
                     int win_w, int halo, int smem_bytes, void* stream) {
  if (C_in % 8 || C_out % 8 || win_w % 16 || win_h <= 2 * halo || win_w <= 2 * halo)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fused_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int ty = win_h - 2 * halo, tx = win_w - 2 * halo;
  dim3 grid((unsigned)((W + tx - 1) / tx), (unsigned)((H + ty - 1) / ty), (unsigned)B);
  fused_stage_kernel<<<grid, FS_THREADS, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(prog),
      static_cast<__nv_bfloat16*>(out), B, H, W, C_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
