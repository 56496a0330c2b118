// int8 convolution for Hopper (sm_90a): y_i32 = conv(q(x), w_i8), then the
// f32 epilogue of the JAX executor's int8 branch.
//
// Replaces the int8 branch of complex_yolov4_tpu/models/network.py apply
// (lines 456-501), which XLA computes on the TPU; there is no Pallas
// original, and torch has no int8 conv2d on CUDA. Built with the other
// kernels by ops/_build.py (nvcc, plain C interface, ctypes); launches on
// the stream it is given, allocates nothing, returns cudaGetLastError().
//
// Function. x (B, H, W, C_in) NHWC, either int8 (a chained producer already
// requantized it) or the compute dtype, bf16 or f32, which the kernel
// quantizes on its way into shared memory as network.py:480-482 does: q =
// clip(rint(x * inv_s_x), -127, 127), the product rounded once (__fmul_rn),
// ties to even. w (C_out, K) int8 with K = k*k*C_in in (ky, kx, ci) order,
// k in {1, 3}, stride 1 or 2, symmetric padding (k-1)/2 (stride 2 reads
// input rows 2i-1..2i+1, as F.conv2d). Epilogue, in f32 and in the JAX
// order: h = y * (s_x * w_scale[oc]) + b, then the activation; then one of
//   mode 0: bf16(h);
//   mode 1: int8 clip(rint(h * inv_s_next), -127, 127) (round half to
//           even), the chained requantization to the consumer's domain;
//   mode 2: the raw int32 sum y (for checks);
//   mode 3: h itself, f32 (f32 compute: network.py:496 casts the epilogue
//           to the f32 compute dtype).
// h = y * scale + b is rounded as the plain version's separate ops are
// (__fmul_rn / __fadd_rn keep nvcc from contracting it into an FMA); the
// activation uses the fast exp and divide.
//
// What bounds it: complex_yolov4's 68 int8 convs at 608 (batch 8) run at
// 76, 38 and 19 px with C_in 256-2048: implicit GEMMs of M = 2,888-46,208
// pixels, N = 128-1024, K = 256-4,608, 614 GOP in all. A 3x3 512 -> 1024 at
// 19 px is 2 x 2,888 x 1,024 x 4,608 = 27 GOP against 3 MB of input and 4.7
// MB of weights: far above the ridge, bounded by the tensor cores' int8
// rate (1,979 TOP/s dense), which only wgmma reaches.
//
// What the design does: an implicit GEMM, no im2col in device memory, over
// 128-byte K steps. A persistent grid (one 512-thread block per SM) walks
// the output tiles; in each block producer warpgroups keep a ring of (A, B)
// stages in flight while two consumer warpgroups multiply, so one tile's
// epilogue runs while the next tile's loads land. Each consumer owns a
// 64-pixel x 128-channel part of the tile: the tile is 128 x 128, split by
// rows, or, for a bf16 input with more than 128 output channels, 64 x 256,
// split by columns, so that each input row is quantized once for 256
// output channels (Tile). B, the (C_out, K) K-major weight slice, arrives by
// TMA in the 128-byte swizzle. A, the tile's patch rows of one K step, is
//   - for an int8 1x1 stride-1 conv, a TMA box of the (M, C_in) matrix;
//   - for another int8 conv, one TMA load in im2col mode: 128 consecutive
//     output pixels' input pixels at one filter tap, the tensor map's
//     bounding box and element strides giving the padding (zero fill) and
//     the stride, 128 channels each (C_in % 128 == 0: a step is one tap);
//   - for a bf16 or f32 input, the rows read into registers by two
//     producer warpgroups on alternate steps (16-byte loads), quantized
//     there and stored as int8: the quantize pass and its copy never touch
//     device memory.
// A is stored in the same 128-byte swizzle as B, so both operands go to
// wgmma m64n128k32 s8 by shared-memory descriptors (int32 accumulators in
// registers). The epilogue runs on the accumulator registers, with the
// activation and output mode fixed at compile time, writes the consumer's
// 64 x 128 output into shared memory and sends it out with TMA stores (an
// f32 output, 32 KB against the 16 KB output tile, in two halves of 64
// channels, the second written once the first has been read). The
// tile's w_scale and bias are fetched before the K loop and read from
// shared memory: read from device memory inside the epilogue, their loads
// waited on each other's stores and took most of a small layer's time.
//
// The f32 contract (f32 compute: an f32 x on the 38 non-chained convs, int8
// out on the 30 chained ones, f32 out on the rest). What bounds it: its
// f32 input and output bytes (the 1x1 convs at 76 and 38 px are bounded by
// bytes, the 3x3 convs by the int8 rate): 4 bytes an input and an output
// value against the bf16 contract's 2, so its bound is higher
// (chip_smoke.py phase 3 prints both). What the design does: the producer
// threads read the f32 rows with 16-byte loads (a 16-channel chunk is four
// of them), four rows at a time, quantize them in registers with the bf16
// route's rounding and store int8 into the A stage, so no quantized copy
// of x is written to or read from device memory; the f32 output leaves by
// TMA stores like the others.

#include <cuda_bf16.h>

#include <mutex>

#include "hopper.cuh"

// The library build compiles this file in two parts, in parallel, so that
// nvcc's work on the six kernel instances splits two ways (ops/_build.py
// PARTS): CYV4_PART 1 the int8 and bf16 input routes and the entry point,
// 2 the f32 input routes, which part 1 reaches through
// cyv4_int8_launch_f32. Without CYV4_PART both are compiled.
#ifndef CYV4_PART
#define CYV4_PART 0
#endif
#define CYV4_HAS_PART(p) (CYV4_PART == 0 || CYV4_PART == (p))

namespace {

constexpr int BK = 128;          // contraction bytes per stage: one 128-byte swizzle row
constexpr int THREADS = 512;     // two producer warpgroups + two consumer warpgroups
constexpr int WG_ROWS = 64;      // a consumer warpgroup's output tile: 64 pixels
constexpr int WG_COLS = 128;     // x 128 channels
constexpr int STAGE_OUT = WG_ROWS * WG_COLS * 2;  // its bf16 output tile
constexpr int EPI_BYTES = 2 * WG_COLS * 4;        // its channels' w_scale and bias
enum Act { ACT_LINEAR = 0, ACT_MISH = 1, ACT_LEAKY = 2, ACT_RELU = 3 };
enum Mode { OUT_BF16 = 0, OUT_INT8 = 1, OUT_INT32 = 2, OUT_F32 = 3 };
// How A reaches shared memory (*_WIDE: with the wide tile).
enum ALoad { A_IM2COL = 0, A_BF16 = 1, A_TMA = 2, A_BF16_WIDE = 3, A_F32 = 4, A_F32_WIDE = 5 };
// The input dtype codes of Int8ConvArgs::x_dtype.
enum XDtype { X_INT8 = 0, X_BF16 = 1, X_F32 = 2 };

// The tile of a route. The two consumer warpgroups split a 128 x 128 tile
// by rows, or, for a bf16 or f32 input with more than 128 output channels,
// a 64 x 256 tile by columns: then each input row is loaded and quantized
// once for 256 output channels, not once for every 128.
template <int AL>
struct Tile {
  static constexpr bool WIDE = AL == A_BF16_WIDE || AL == A_F32_WIDE;
  static constexpr bool F32 = AL == A_F32 || AL == A_F32_WIDE;  // A from f32 rows
  // A from bf16 or f32 rows, quantized by the producer threads
  static constexpr bool QUANT = AL == A_BF16 || AL == A_BF16_WIDE || F32;
  static constexpr int BM = WIDE ? 64 : 128;   // output pixels
  static constexpr int BN = WIDE ? 256 : 128;  // output channels
  static constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK;
  static constexpr int STAGES = WIDE ? 4 : 5;
  static constexpr int SMEM =
      1024 + STAGES * (A_BYTES + B_BYTES) + 2 * STAGE_OUT + 2 * EPI_BYTES + 2 * STAGES * 8;
};

struct Geom {
  int H, W, C_in, C_out, ksize, stride, pad, Ho, Wo;
  int M, K, nk;            // output pixels, contraction bytes, K steps
  int n_tiles, tiles;      // channel tiles, all tiles
  float s_x, inv_s_x, inv_s_next;
  int act, mode;
  int tma_out;             // the output leaves by TMA stores (bf16 and int8 modes)
};

// The port's f32 activations (ops/activations.py act) with the fast exp
// and divide: a few f32 ulps from the plain version's separately rounded
// ops, which moves a bf16 output by at most one ulp and a requantized int8
// by at most one step, the checks both are held to.
template <int ACT>
__device__ __forceinline__ float act_f32(float x) {
  if (ACT == ACT_MISH) {
    const float s = __expf(fminf(x, 20.0f));
    const float q = s * s + 2.0f * s;
    return x > 20.0f ? x : __fdividef(x * q, q + 2.0f);
  }
  if (ACT == ACT_LEAKY) return x > 0.0f ? x : x * 0.1f;
  if (ACT == ACT_RELU) return fmaxf(x, 0.0f);
  return x;
}

// The activation of a run-time code, for the rare direct-store epilogue.
__device__ __forceinline__ float act_f32(float x, int act) {
  if (act == ACT_MISH) return act_f32<ACT_MISH>(x);
  if (act == ACT_LEAKY) return act_f32<ACT_LEAKY>(x);
  if (act == ACT_RELU) return act_f32<ACT_RELU>(x);
  return x;
}

// Shared-memory descriptor of a K-major tile in the 128-byte swizzle: rows
// of 128 bytes, 8-row atoms 1024 bytes apart (the stride byte offset); the
// leading byte offset is unused in this layout. `addr` is the tile's
// 1024-byte aligned start plus the K step's byte offset inside the row.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// TMA store of a box from shared memory, tracked by the thread's bulk
// groups; the tensor map clips what lies past the tensor's edge.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Barrier of one warpgroup (named barrier `id`).
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Keep the compiler from moving accumulator registers across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128 int32: row 16w + l/4 (+8), channels 8j + 2(l%4) + {0, 1} in
// d[4j + {0, 1}] (+8 rows: d[4j + {2, 3}])) += A (64 x 32) * B (32 x 128)^T,
// both s8 read from shared memory by descriptor.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Four f32 values -> four int8 clip(rint(v * inv), -127, 127) in one word,
// the product rounded once, ties to even: the clipped product plus 1.5 *
// 2^23 rounds to an integer (ties to even) whose two's-complement low byte
// is the int8, and byte permutes pack four of them, so no conversion
// instruction runs.
__device__ __forceinline__ uint32_t quantize4f(float4 v, float inv) {
  const float f[4] = {v.x, v.y, v.z, v.w};
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float c = fminf(fmaxf(__fmul_rn(f[i], inv), -127.0f), 127.0f);
    r[i] = __float_as_uint(__fadd_rn(c, 12582912.0f));
  }
  return __byte_perm(__byte_perm(r[0], r[1], 0x0040), __byte_perm(r[2], r[3], 0x0040), 0x5410);
}

// The same for four bf16 values in two words.
__device__ __forceinline__ uint32_t quantize4(uint32_t lo, uint32_t hi, float inv) {
  return quantize4f(make_float4(__uint_as_float(lo << 16), __uint_as_float(lo & 0xFFFF0000u),
                                __uint_as_float(hi << 16), __uint_as_float(hi & 0xFFFF0000u)),
                    inv);
}

__device__ __forceinline__ uint2 quantize8(uint4 v, float inv) {
  return make_uint2(quantize4(v.x, v.y, inv), quantize4(v.z, v.w, inv));
}

// TMA load in im2col mode: 128 consecutive output pixels from the one at
// tensor coordinates (w, h, n) (its filter window's top-left input pixel),
// walking the map's bounding box with its element strides, each pixel's
// 128 channels from c, at filter offset (dw, dh); padding reads as zero.
__device__ __forceinline__ void tma_load_im2col(uint32_t dst, const CUtensorMap* map, int c,
                                                int w, int h, int n, int dw, int dh,
                                                uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6], {%7, %8};\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(h), "r"(n), "r"(bar),
      "h"((unsigned short)dw), "h"((unsigned short)dh)
      : "memory");
}

// A producer warpgroup: for every tile of the block and every K step it
// owns, waits for the stage to be free, asks for B by TMA and fills A.
// An int8 input's A is one TMA load (A_TMA: a box of the (M, C_in)
// matrix; A_IM2COL: the tile's 128 patch rows of one 128-byte K step), so
// one thread of warpgroup 0 does all. For a bf16 or f32 input, thread t
// owns chunk column t % 8 (16 bytes of K: 16 channels) of rows t / 8 + 16
// j, j < BM / 16, loads them, quantizes and stores them (f32: four rows at
// a time, 256 bytes of loads in flight per thread); two warpgroups (pwg 0,
// 1) take alternate steps, so one quantizes while the other's loads are in
// flight.
template <int AL>
__device__ __forceinline__ void produce(const Geom& g, const void* __restrict__ x,
                                        const CUtensorMap* w_map, const CUtensorMap* x_map,
                                        uint32_t a_s, uint32_t b_s, uint32_t full,
                                        uint32_t empty, int pwg, int ptid) {
  using T = Tile<AL>;
  if (!T::QUANT && (pwg != 0 || ptid != 0)) return;
  const int cc = ptid & 7, r0 = ptid >> 3;
  uint32_t it = 0;  // K steps issued by the block so far (ring position)
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    const int m0 = (tile / g.n_tiles) * T::BM, n0 = (tile % g.n_tiles) * T::BN;
    // A_BF16: each owned row's first input pixel (padding included) and
    // frame base; A_IM2COL: those of the tile's first row
    int base[T::BM / 16], ih0[T::BM / 16], iw0[T::BM / 16];
#pragma unroll
    for (int j = 0; j < T::BM / 16; ++j) {
      const int m = m0 + r0 + 16 * j;
      const int ow = m % g.Wo, t = m / g.Wo;
      const int oh = t % g.Ho, n = t / g.Ho;
      base[j] = m < g.M ? n * g.H * g.W : -1;
      ih0[j] = oh * g.stride - g.pad;
      iw0[j] = ow * g.stride - g.pad;
      if (AL == A_IM2COL) base[j] = n;
    }
    for (int kc = 0; kc < g.nk; ++kc, ++it) {
      if (T::QUANT && (int)(it & 1) != pwg) continue;
      const uint32_t s = it % T::STAGES;
      mbar_wait(empty + 8 * s, ((it / T::STAGES) & 1) ^ 1);
      const uint32_t a_st = a_s + s * T::A_BYTES;
      const int k = kc * BK + cc * 16;
      const int tap = k / g.C_in, ci = k - tap * g.C_in;
      const int ky = tap / g.ksize, kx = tap - ky * g.ksize;
      if (ptid == 0) {
        mbar_expect_tx(full + 8 * s, T::QUANT ? T::B_BYTES : T::A_BYTES + T::B_BYTES);
        tma_load_2d(b_s + s * T::B_BYTES, w_map, kc * BK, n0, full + 8 * s);
        if (AL == A_TMA) tma_load_2d(a_st, x_map, kc * BK, m0, full + 8 * s);
        if (AL == A_IM2COL)
          tma_load_im2col(a_st, x_map, ci, iw0[0], ih0[0], base[0], kx, ky, full + 8 * s);
      }
      if (!T::QUANT) continue;
      const bool k_ok = k < g.K;
      if constexpr (T::F32) {
        const float* xp = static_cast<const float*>(x);
#pragma unroll
        for (int j0 = 0; j0 < T::BM / 16; j0 += 4) {
          float4 v[4][4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = j0 + jj;
            const int ih = ih0[j] + ky, iw = iw0[j] + kx;
            const bool ok = k_ok && base[j] >= 0 && (unsigned)ih < (unsigned)g.H &&
                            (unsigned)iw < (unsigned)g.W;
            if (ok) {
              const float4* src = reinterpret_cast<const float4*>(
                  xp + ((size_t)(base[j] + ih * g.W + iw) * g.C_in + ci));
#pragma unroll
              for (int e = 0; e < 4; ++e) v[jj][e] = __ldg(src + e);
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) v[jj][e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            }
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int r = r0 + 16 * (j0 + jj);
            asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                             a_st + r * 128 + ((cc ^ (r & 7)) << 4)),
                         "r"(quantize4f(v[jj][0], g.inv_s_x)), "r"(quantize4f(v[jj][1], g.inv_s_x)),
                         "r"(quantize4f(v[jj][2], g.inv_s_x)), "r"(quantize4f(v[jj][3], g.inv_s_x))
                         : "memory");
          }
        }
        fence_proxy_async();
        mbar_arrive(full + 8 * s);
        continue;
      }
      const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
      uint4 v[T::BM / 16][2];
#pragma unroll
      for (int j = 0; j < T::BM / 16; ++j) {
        const int ih = ih0[j] + ky, iw = iw0[j] + kx;
        const bool ok = k_ok && base[j] >= 0 && (unsigned)ih < (unsigned)g.H &&
                        (unsigned)iw < (unsigned)g.W;
        if (ok) {
          const uint4* src = reinterpret_cast<const uint4*>(
              xp + ((size_t)(base[j] + ih * g.W + iw) * g.C_in + ci));
          v[j][0] = __ldg(src);
          v[j][1] = __ldg(src + 1);
        } else {
          v[j][0] = v[j][1] = make_uint4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int j = 0; j < T::BM / 16; ++j) {
        const int r = r0 + 16 * j;
        const uint2 lo = quantize8(v[j][0], g.inv_s_x), hi = quantize8(v[j][1], g.inv_s_x);
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                         a_st + r * 128 + ((cc ^ (r & 7)) << 4)),
                     "r"(lo.x), "r"(lo.y), "r"(hi.x), "r"(hi.y)
                     : "memory");
      }
      fence_proxy_async();
      mbar_arrive(full + 8 * s);
    }
  }
}

// The epilogue of a consumer warpgroup's 64 x 128 tile into its output
// tile in shared memory, with the activation and output mode fixed at
// compile time: a run-time switch per value put a branch around each
// value's chain of dependent operations and left them unoverlapped. An f32
// output is written 64 channels (`part`) at a time.
template <int ACT, int MODE>
__device__ __forceinline__ void epilogue_tile(const int (&acc)[64], const Geom& g, uint32_t stg,
                                              const float* sc_p, const float* bi_p, int q,
                                              int r_lo, int part) {
#pragma unroll
  for (int j = 0; j < WG_COLS / 8; ++j) {
    if (MODE == OUT_F32 && (j >> 3) != part) continue;
    const int nl = 8 * j + 2 * q;
    const float2 sc = *reinterpret_cast<const float2*>(sc_p + nl);
    const float2 bi = *reinterpret_cast<const float2*>(bi_p + nl);
    const float sc0 = __fmul_rn(g.s_x, sc.x), sc1 = __fmul_rn(g.s_x, sc.y);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_lo + 8 * h;
      const float h0 = act_f32<ACT>(__fadd_rn(__fmul_rn((float)acc[4 * j + 2 * h], sc0), bi.x));
      const float h1 = act_f32<ACT>(__fadd_rn(__fmul_rn((float)acc[4 * j + 2 * h + 1], sc1), bi.y));
      if (MODE == OUT_INT8) {  // one box: 64 rows x 128 channels
        const int q0 = __float2int_rn(fminf(fmaxf(__fmul_rn(h0, g.inv_s_next), -127.0f), 127.0f));
        const int q1 = __float2int_rn(fminf(fmaxf(__fmul_rn(h1, g.inv_s_next), -127.0f), 127.0f));
        const uint32_t at = stg + r * 128 + ((((nl >> 4) ^ (r & 7))) << 4) + (nl & 15);
        asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(at),
                     "h"((unsigned short)((q0 & 0xFF) | ((q1 & 0xFF) << 8))));
      } else if (MODE == OUT_F32) {  // two boxes of 64 rows x 32 channels: the part's 64
        const int c = nl & 63;
        const uint32_t at = stg + (c >> 5) * (STAGE_OUT / 2) + r * 128 +
                            ((((c & 31) >> 2) ^ (r & 7)) << 4) + (c & 3) * 4;
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(at), "f"(h0), "f"(h1));
      } else {  // two boxes of 64 rows x 64 channels
        const __nv_bfloat162 v = __floats2bfloat162_rn(h0, h1);
        const uint32_t at = stg + (nl >> 6) * (STAGE_OUT / 2) + r * 128 +
                            ((((nl & 63) >> 3) ^ (r & 7)) << 4) + (nl & 7) * 2;
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                     "r"(*reinterpret_cast<const uint32_t*>(&v)));
      }
    }
  }
}

template <int ACT>
__device__ __forceinline__ void epilogue_act(const int (&acc)[64], const Geom& g, uint32_t stg,
                                             const float* sc_p, const float* bi_p, int q,
                                             int r_lo, int part) {
  if (g.mode == OUT_INT8)
    epilogue_tile<ACT, OUT_INT8>(acc, g, stg, sc_p, bi_p, q, r_lo, part);
  else if (g.mode == OUT_F32)
    epilogue_tile<ACT, OUT_F32>(acc, g, stg, sc_p, bi_p, q, r_lo, part);
  else
    epilogue_tile<ACT, OUT_BF16>(acc, g, stg, sc_p, bi_p, q, r_lo, part);
}

__device__ __forceinline__ void epilogue(const int (&acc)[64], const Geom& g, uint32_t stg,
                                         const float* sc_p, const float* bi_p, int q, int r_lo,
                                         int part = 0) {
  switch (g.act) {
    case ACT_MISH: epilogue_act<ACT_MISH>(acc, g, stg, sc_p, bi_p, q, r_lo, part); break;
    case ACT_LEAKY: epilogue_act<ACT_LEAKY>(acc, g, stg, sc_p, bi_p, q, r_lo, part); break;
    case ACT_RELU: epilogue_act<ACT_RELU>(acc, g, stg, sc_p, bi_p, q, r_lo, part); break;
    default: epilogue_act<ACT_LINEAR>(acc, g, stg, sc_p, bi_p, q, r_lo, part); break;
  }
}

template <int AL>
__global__ void __launch_bounds__(THREADS, 1)
int8_conv_kernel(const void* __restrict__ x, const float* __restrict__ w_scale,
                 const float* __restrict__ bias, void* __restrict__ out, Geom g,
                 const __grid_constant__ CUtensorMap w_map,
                 const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap o_map) {
  using T = Tile<AL>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw_s = smem_addr(smem_raw);
  const uint32_t a_s = (raw_s + 1023) & ~1023u;
  const uint32_t b_s = a_s + T::STAGES * T::A_BYTES;
  const uint32_t o_s = b_s + T::STAGES * T::B_BYTES;  // the consumers' output tiles
  const uint32_t e_s = o_s + 2 * STAGE_OUT;            // their w_scale and bias
  const uint32_t full = e_s + 2 * EPI_BYTES, empty = full + 8 * T::STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    // full: the TMA bytes plus, where the producer's threads write A, one
    // arrival from each of them; empty: one arrival per consumer warpgroup
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full + 8 * s, T::QUANT ? 129 : 1);
      mbar_init(empty + 8 * s, 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 256) {
    produce<AL>(g, x, &w_map, &x_map, a_s, b_s, full, empty, tid / 128, tid % 128);
    return;
  }

  const int wg = tid / 128 - 2, wt = tid % 128;
  const int warp = wt / 32, lane = wt % 32;
  // the warpgroup's rows and columns of the tile
  const int row_off = T::WIDE ? 0 : wg * WG_ROWS, col_off = T::WIDE ? wg * WG_COLS : 0;
  // the warpgroup's copy of its columns' w_scale and bias, read by the
  // epilogue; thread wt fetches channel nw + wt before the K loop and
  // stores it after, so the loads' latency hides behind the products
  const uint32_t sc_s = e_s + wg * EPI_BYTES, bi_s = sc_s + WG_COLS * 4;
  const float* sc_p = reinterpret_cast<const float*>(smem_raw + (sc_s - raw_s));
  const float* bi_p = reinterpret_cast<const float*>(smem_raw + (bi_s - raw_s));
  uint32_t it = 0;
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    const int mw = (tile / g.n_tiles) * T::BM + row_off;
    const int nw = (tile % g.n_tiles) * T::BN + col_off;
    // a wide tile's second half may lie past C_out: its warpgroup then only
    // frees the stages
    const bool live = nw < g.C_out;
    const bool n_ok = nw + wt < g.C_out;
    const float my_sc = n_ok ? w_scale[nw + wt] : 0.0f;
    const float my_b = n_ok ? bias[nw + wt] : 0.0f;
    int acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    for (int kc = 0; kc < g.nk; ++kc, ++it) {
      const uint32_t s = it % T::STAGES;
      mbar_wait(full + 8 * s, (it / T::STAGES) & 1);
      const uint32_t a_st = a_s + s * T::A_BYTES + row_off * BK;
      const uint32_t b_st = b_s + s * T::B_BYTES + col_off * BK;
      fence_acc(acc);
      wgmma_fence();
      if (live) {
#pragma unroll
        for (int j = 0; j < BK / 32; ++j)
          wgmma_s8(acc, kmajor_desc(a_st + 32 * j), kmajor_desc(b_st + 32 * j));
      }
      wgmma_commit();
      fence_acc(acc);
      if (kc > 0) {  // the previous step's products are done: free its stage
        wgmma_wait<1>();
        if (wt == 0) mbar_arrive(empty + 8 * ((it - 1) % T::STAGES));
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (wt == 0) mbar_arrive(empty + 8 * ((it - 1) % T::STAGES));
    if (!live) continue;

    // epilogue on the accumulators: lane (warp, l) holds rows 16 warp + l/4
    // (+ 8) of the warpgroup's 64 and channel pairs 8j + 2 (l % 4) of the
    // tile. bf16, int8 and f32 outputs go through the warpgroup's output
    // tile in shared memory (128-byte swizzle) and leave by TMA stores,
    // which clip the tile at M and C_out; int32 sums, and outputs whose row
    // is not a multiple of 16 bytes, are stored from the registers.
    // The previous tile's epilogue has read the scales (its last wg_sync),
    // so they are overwritten here and read after the next barrier.
    const int q = lane & 3, r_lo = warp * 16 + (lane >> 2);
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(sc_s + 4 * wt), "f"(my_sc) : "memory");
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(bi_s + 4 * wt), "f"(my_b) : "memory");
    if (!g.tma_out) {
      wg_sync(1 + wg);
#pragma unroll
      for (int j = 0; j < WG_COLS / 8; ++j) {
        const int n = nw + 8 * j + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mw + r_lo + 8 * h;
          if (m < g.M && n < g.C_out) {
            const size_t o = (size_t)m * g.C_out + n;
            const int y0 = acc[4 * j + 2 * h], y1 = acc[4 * j + 2 * h + 1];
            if (g.mode == OUT_INT32) {
              *reinterpret_cast<int2*>(static_cast<int*>(out) + o) = make_int2(y0, y1);
            } else {
              const int nl = n - nw;
              const float sc0 = __fmul_rn(g.s_x, sc_p[nl]), sc1 = __fmul_rn(g.s_x, sc_p[nl + 1]);
              const float h0 = act_f32(__fadd_rn(__fmul_rn((float)y0, sc0), bi_p[nl]), g.act);
              const float h1 = act_f32(__fadd_rn(__fmul_rn((float)y1, sc1), bi_p[nl + 1]), g.act);
              if (g.mode == OUT_INT8) {
                const int q0 = (int)fminf(fmaxf(rintf(__fmul_rn(h0, g.inv_s_next)), -127.0f), 127.0f);
                const int q1 = (int)fminf(fmaxf(rintf(__fmul_rn(h1, g.inv_s_next)), -127.0f), 127.0f);
                *reinterpret_cast<uint16_t*>(static_cast<int8_t*>(out) + o) =
                    (uint16_t)((q0 & 0xFF) | ((q1 & 0xFF) << 8));
              } else {
                *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) =
                    __floats2bfloat162_rn(h0, h1);
              }
            }
          }
        }
      }
      wg_sync(1 + wg);  // the scales are read before the next tile writes them
      continue;
    }
    const uint32_t stg = o_s + wg * STAGE_OUT;
    if (g.mode == OUT_F32) {
      // 32 KB of f32 against the 16 KB output tile: two parts of 64
      // channels, each two boxes of 32; the second part is written once the
      // first part's stores have read the tile
#pragma unroll 1
      for (int part = 0; part < 2 && nw + 64 * part < g.C_out; ++part) {
        if (wt == 0) bulk_wait_read();  // the previous stores have read stg
        wg_sync(1 + wg);
        epilogue(acc, g, stg, sc_p, bi_p, q, r_lo, part);
        fence_proxy_async();
        wg_sync(1 + wg);
        if (wt == 0 && mw < g.M) {
          const int c = nw + 64 * part;
          tma_store_2d(&o_map, stg, c, mw);
          if (c + 32 < g.C_out) tma_store_2d(&o_map, stg + STAGE_OUT / 2, c + 32, mw);
          bulk_commit();
        }
      }
      continue;
    }
    if (wt == 0) bulk_wait_read();  // the previous tile's stores have read stg
    wg_sync(1 + wg);
    epilogue(acc, g, stg, sc_p, bi_p, q, r_lo);
    fence_proxy_async();
    wg_sync(1 + wg);
    if (wt == 0 && mw < g.M) {
      tma_store_2d(&o_map, stg, nw, mw);
      if (g.mode == OUT_BF16 && nw + 64 < g.C_out)
        tma_store_2d(&o_map, stg + STAGE_OUT / 2, nw + 64, mw);
      bulk_commit();
    }
  }
  if (wt == 0) bulk_wait();  // the output tiles leave before the block does
}

// A 2-D int8 tensor map of a (rows, cols) row-major matrix read in boxes of
// 128 columns (bytes) x box_rows rows in the 128-byte swizzle;
// out-of-bounds elements read as zero.
bool kmajor_map(CUtensorMap* map, const void* p, long long rows, int cols, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(p), dims, strides, box,
                estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of the (M, C_out) output for the epilogue's TMA stores:
// boxes of 64 rows x 128 bytes (32 f32, 64 bf16 or 128 int8 channels) in
// the 128-byte swizzle. False for int32 sums, and where the row is not a
// multiple of 16 bytes, which then leave by the threads' own stores.
bool out_map(CUtensorMap* map, void* p, int mode, long long rows, int cols) {
  const EncodeTiledFn encode = encode_tiled();
  const int elem = mode == OUT_F32 ? 4 : mode == OUT_BF16 ? 2 : 1;
  if (encode == nullptr || mode == OUT_INT32 || (cols * elem) % 16) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem), 64};
  const cuuint32_t estr[2] = {1, 1};
  const CUtensorMapDataType type = mode == OUT_F32    ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : mode == OUT_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                      : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  return encode(map, type, 2, p, dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

typedef CUresult (*EncodeIm2colFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                   cuuint32_t, cuuint32_t, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The im2col tensor map of an int8 (B, H, W, C) NHWC input for a k x k conv
// at `stride` with padding (k-1)/2: the bounding box of the filter windows'
// top-left pixels runs from -pad to W - 1 + pad - (k-1) (and so on H), a
// load walks 128 of them at the conv's stride and reads 128 channels
// (bytes) of each, in the 128-byte swizzle; padding reads as zero.
bool im2col_map(CUtensorMap* map, const void* p, int B, int H, int W, int C, int ksize,
                int stride) {
  static EncodeIm2colFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeIm2col", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return false;
    encode = reinterpret_cast<EncodeIm2colFn>(fn);
  }
  const int pad = (ksize - 1) / 2;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C, (cuuint64_t)C * W, (cuuint64_t)C * W * H};
  const int lower[2] = {-pad, -pad}, upper[2] = {pad - (ksize - 1), pad - (ksize - 1)};
  const cuuint32_t estr[4] = {1, (cuuint32_t)stride, (cuuint32_t)stride, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(p), dims, strides, lower,
                upper, BK, Tile<A_IM2COL>::BM, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

enum MapKind { MAP_KMAJOR = -1, MAP_IM2COL = -2 };  // >= 0: the output map of that mode

// Encoded tensor maps by (kind, address, shape): a map holds only the
// address, shape and box, so a hit is the same map whatever the memory now
// holds; weights keep their address and the allocator hands activations
// the same addresses request after request, so most calls skip encoding.
// A k-major map has shape (rows, cols, box rows, 0), an output map (rows,
// cols, 0, 0); an im2col map (B, H, W, C) and its ksize and stride in `geo`.
// Addresses are unique across devices, so the key needs no device. Not
// thread-safe: cyv4_int8_conv holds host_mu around every use.
struct MapKey {
  int kind;
  const void* p;
  long long d0;
  int d1, d2, d3, geo;
};

bool cached_map(CUtensorMap* map, int kind, const void* p, long long d0, int d1, int d2 = 0,
                int d3 = 0, int geo = 0) {
  constexpr int N = 1024;  // direct-mapped: a clash only costs an encode
  static MapKey keys[N];
  static CUtensorMap maps[N];
  const uint64_t h = (reinterpret_cast<uintptr_t>(p) >> 8) ^ (uint64_t)(kind + 3) * 0x9E3779B9u ^
                     (uint64_t)d0 * 31 ^ (uint64_t)d1 ^ (uint64_t)d2 * 131 ^ (uint64_t)geo * 7;
  const int i = (int)((h ^ (h >> 17)) & (N - 1));
  const MapKey& k = keys[i];
  if (k.p == p && k.kind == kind && k.d0 == d0 && k.d1 == d1 && k.d2 == d2 && k.d3 == d3 &&
      k.geo == geo) {
    *map = maps[i];
    return true;
  }
  bool ok;
  if (kind == MAP_KMAJOR)
    ok = kmajor_map(map, p, d0, d1, d2);
  else if (kind == MAP_IM2COL)
    ok = im2col_map(map, p, (int)d0, d1, d2, d3, geo / 4, geo % 4);
  else
    ok = out_map(map, const_cast<void*>(p), kind, d0, d1);
  if (ok) {
    keys[i] = MapKey{kind, p, d0, d1, d2, d3, geo};
    maps[i] = *map;
  }
  return ok;
}

// Tile the GEMM for route AL, encode (or find) the weight map with the
// route's box and launch a persistent grid of at most one block per SM.
template <int AL>
cudaError_t launch(const void* x, const void* w, Geom g, const float* w_scale, const float* bias,
                   void* out, const CUtensorMap& x_map, const CUtensorMap& o_map,
                   cudaStream_t stream, int dev) {
  using T = Tile<AL>;
  // once per instance and device: the host's cost counts on every layer
  static bool attr_set[MAX_DEVICES] = {};
  if (!attr_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_conv_kernel<AL>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return e;
    attr_set[dev] = true;
  }
  CUtensorMap w_map{};
  if (!cached_map(&w_map, MAP_KMAJOR, w, g.C_out, g.K, T::BN)) return cudaErrorInvalidValue;
  g.n_tiles = (g.C_out + T::BN - 1) / T::BN;
  g.tiles = (g.M + T::BM - 1) / T::BM * g.n_tiles;
  const int sms = sm_count(dev);
  if (sms < 1) return cudaErrorInvalidConfiguration;
  const int grid = g.tiles < sms ? g.tiles : sms;
  int8_conv_kernel<AL><<<grid, THREADS, T::SMEM, stream>>>(x, w_scale, bias, out, g, w_map,
                                                          x_map, o_map);
  return cudaGetLastError();
}

}  // namespace

// The f32 input routes for cyv4_int8_conv (part 2): `geom` is the Geom it
// filled in, `o_map` its output map; the caller holds host_mu.
extern "C" int cyv4_int8_launch_f32(const void* x, const void* w, const void* geom,
                                    const float* w_scale, const float* bias, void* out,
                                    const CUtensorMap* o_map, void* stream, int dev)
#if CYV4_HAS_PART(2)
{
  const Geom& g = *static_cast<const Geom*>(geom);
  const CUtensorMap x_map{};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g.C_out > WG_COLS)
    return (int)launch<A_F32_WIDE>(x, w, g, w_scale, bias, out, x_map, *o_map, s, dev);
  return (int)launch<A_F32>(x, w, g, w_scale, bias, out, x_map, *o_map, s, dev);
}
#else
    ;
#endif

#if CYV4_HAS_PART(1)
// The arguments of one call, in one struct: ctypes converts a struct
// pointer in a fraction of the time it takes over 19 scalar arguments, and
// the host's cost counts on each of path 2's 68 layers.
// x (B, H, W, C_in) NHWC, int8 (x_dtype 0), bf16 (1) or f32 (2; bf16 and
// f32 are quantized with inv_s_x); w (C_out, k*k*C_in) int8; w_scale, bias (C_out,)
// f32; out (B, Ho, Wo, C_out) bf16 (mode 0), int8 (mode 1), int32 (mode
// 2) or f32 (mode 3). C_in % 16 == 0 (% 128 for an int8 x of a 3x3 or strided conv),
// C_out % 8 == 0; x and w 16-byte aligned. The kernel runs on `device`
// (x's), whichever device is current; the current one is restored.
struct Int8ConvArgs {
  const void* x;
  int x_dtype;
  const void *w, *w_scale, *bias;
  void* out;
  int B, H, W, C_in, C_out, ksize, stride;
  float s_x, inv_s_x;
  int act, mode;
  float inv_s_next;
  void* stream;
  int device;
};

namespace {

std::mutex host_mu;  // the maps' cache and the per-device state, shared by every caller

int run(const Int8ConvArgs* a) {
  const void* x = a->x;
  const void* w = a->w;
  void* out = a->out;
  const int B = a->B, H = a->H, W = a->W, C_in = a->C_in, C_out = a->C_out;
  const int ksize = a->ksize, stride = a->stride, mode = a->mode, dev = a->device;
  if (C_in % 16 || C_out % 8 || (ksize != 1 && ksize != 3) || (stride != 1 && stride != 2) ||
      mode < 0 || mode > 3)
    return (int)cudaErrorInvalidValue;
  Geom g;
  g.H = H, g.W = W, g.C_in = C_in, g.C_out = C_out, g.ksize = ksize, g.stride = stride;
  g.pad = (ksize - 1) / 2;
  g.Ho = (H + 2 * g.pad - ksize) / stride + 1;
  g.Wo = (W + 2 * g.pad - ksize) / stride + 1;
  const long long M = (long long)B * g.Ho * g.Wo;
  if ((long long)B * H * W * C_in >= (1LL << 31) || M * C_out >= (1LL << 31))
    return (int)cudaErrorInvalidValue;  // int offsets
  g.M = (int)M;
  g.K = ksize * ksize * C_in;
  g.nk = (g.K + BK - 1) / BK;
  g.s_x = a->s_x, g.inv_s_x = a->inv_s_x, g.inv_s_next = a->inv_s_next;
  g.act = a->act, g.mode = mode;
  if (g.M < 1) return (int)cudaSuccess;
  CUtensorMap x_map{}, o_map{};
  g.tma_out = cached_map(&o_map, mode, out, g.M, C_out) ? 1 : 0;
  // an f32 row (C_out % 8 == 0) is always a multiple of 16 bytes: the
  // direct-store epilogue has no f32 mode
  if (mode == OUT_F32 && !g.tma_out) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  const float* ws = static_cast<const float*>(a->w_scale);
  const float* bs = static_cast<const float*>(a->bias);
  if (a->x_dtype == X_BF16) {
    if (C_out > WG_COLS)
      return (int)launch<A_BF16_WIDE>(x, w, g, ws, bs, out, x_map, o_map, s, dev);
    return (int)launch<A_BF16>(x, w, g, ws, bs, out, x_map, o_map, s, dev);
  }
  if (a->x_dtype == X_F32)
    return cyv4_int8_launch_f32(x, w, &g, ws, bs, out, &o_map, a->stream, dev);
  if (a->x_dtype != X_INT8) return (int)cudaErrorInvalidValue;
  if (ksize == 1 && stride == 1) {
    if (!cached_map(&x_map, MAP_KMAJOR, x, g.M, C_in, Tile<A_TMA>::BM))
      return (int)cudaErrorInvalidValue;
    return (int)launch<A_TMA>(x, w, g, ws, bs, out, x_map, o_map, s, dev);
  }
  // an im2col K step is 128 channels of one tap
  if (C_in % BK || !cached_map(&x_map, MAP_IM2COL, x, B, H, W, C_in, ksize * 4 + stride))
    return (int)cudaErrorInvalidValue;
  return (int)launch<A_IM2COL>(x, w, g, ws, bs, out, x_map, o_map, s, dev);
}

}  // namespace

extern "C" int cyv4_int8_conv(const Int8ConvArgs* a) {
  if (a->device < 0 || a->device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const std::lock_guard<std::mutex> lock(host_mu);
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != a->device) e = cudaSetDevice(a->device);
  if (e != cudaSuccess) return (int)e;
  const int code = run(a);
  if (prev != a->device) cudaSetDevice(prev);
  return code;
}
#endif
