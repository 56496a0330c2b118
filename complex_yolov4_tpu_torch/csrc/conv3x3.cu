// Direct 3x3 convolutions for Hopper (sm_90a): the stem conv and the fused
// small-channel 3x3 conv of the complex_yolov4 early backbone.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// through ctypes (complex_yolov4_tpu_torch/ops/_build.py). Every entry point
// launches on the stream it is given, allocates nothing and returns
// cudaGetLastError() of its launch.
//
// Layouts are the JAX package's: activations NHWC, the weight packed once at
// load to (9*C_in, C_out) bf16 rows in (ky, kx, ci) order, bias f32. Both
// kernels compute y = act(conv3x3_pad1(x, w) + b) with symmetric 1-px zero
// padding (stride 2 reads input rows 2i-1..2i+1, as F.conv2d(padding=1)),
// bf16 products, f32 accumulation, f32 bias and activation, bf16 output
// (f32 in and out for cyv4_conv3x3_f32).
//
// Both kernels share one design: a persistent grid (SMs x resident blocks)
// in which each warp (stem) or warpgroup (3x3) walks its own output tiles
// with its own ring of input windows and its own barrier, so that one's
// epilogue runs under another's loads and products; each tile's window,
// halo included, reaches shared memory once, while earlier tiles compute,
// as a TMA box asked for by one thread (cuTensorMapEncodeTiled, found
// through cudaGetDriverEntryPoint so the library links no libcuda) whose
// out-of-bounds zeros are the 1-px padding, or, where a tensor map cannot
// describe the window, as cp.async copies that zero-fill past the image
// edge; the products run on the tensor cores; the accumulators start at
// the bias, the activation runs on them in registers, and each lane stores
// its bf16 pairs straight from the fragment (4-byte words; a quad fills 16
// bytes of a pixel).
//
// cyv4_stem_conv3x3 replaces complex_yolov4_tpu/ops/stem_conv.py
// conv3x3_stem (pallas_call at :204).
//   What bounds it: layer 0 of complex_yolov4 at 608 (3 -> 32, batch 8)
//   reads a 35.5 MB f32 raster and writes a 189 MB bf16 output for 5.1
//   GFLOP: 0.067 ms of bytes against 0.005 ms of bf16 tensor-core work. It
//   is bounded by bytes, almost all of them the output's. On the card the
//   epilogue's instructions hold it back instead: mish costs two MUFU
//   operations and about ten ALU operations per output value, 94.6 M values.
//   What the design does: K = 9*C_in is padded to a multiple of 16 (27 ->
//   32: 84% of the mma work is useful) with zero weight rows, and the whole
//   (K, 32-channel slice) weight lives in registers as mma.sync B fragments
//   for the life of the block. Each warp walks its own 2 x 32-pixel tiles
//   with its own ring of 4 x 34 x C_in f32 windows, synchronized within the
//   warp only, so the warps of an SM drift apart. A window is one TMA box
//   of the raster viewed as (B, H, W * C_in) floats, started at the 16-byte
//   boundary just before the row (TMA reads whole 16-byte units); where
//   W * C_in is not a multiple of 4 or the row is longer than a box, the
//   lanes copy it with 4-byte cp.async instead. Each lane rounds its A
//   fragment values to bf16 as it builds them from the window (the plain
//   version's cast). Two m16n8k16 steps per 16 pixels per 8 channels
//   replace 864 FMAs per pixel. Two instances are built: C_in 3 (the main
//   path) and C_in 14, which takes every other C_in zero-padded by the
//   wrapper (off the main path).
//
// cyv4_conv3x3 replaces complex_yolov4_tpu/ops/pallas_conv.py conv3x3_fused
// (pallas_call at :147).
//   What bounds it: on the five main-path layers (batch 8: 608 32->64 s2,
//   304 32->64 s1, 304 64->128 s2, and twice 152 64->64 s1) reading each
//   input once and writing each output once moves 662.5 MB, 0.198 ms at
//   3.35 TB/s, against 109 GFLOP, 0.110 ms at the bf16 peak: bounded by
//   bytes, with the tensor cores needing about half their peak to keep up.
//   What the design does: a tile is 4 output rows x 16 pixels x 64 output
//   channels. Its (3*s+3) x (15*s+3) x C_in input window is loaded once
//   (stride-2 windows as two blocks, even columns then odd ones, so a tap's
//   16 pixels stay adjacent), so every input byte crosses L2 about once per
//   tile instead of up to 9 times, and no index division is left in the
//   inner loop. C_in is 32, 64 or 128: the wrapper zero-pads any other C_in
//   (off the main path) to the next of them. For C_in 32 and 64 each block
//   is one TMA box (every S-th column) written in the 64- or 128-byte
//   swizzle that the ldmatrix addresses undo; the threads copy C_in 128
//   with 16-byte cp.async. A block holds the (9*C_in, 64) weight slice in
//   shared memory, in wgmma's 128-byte-swizzle layout, and its two
//   warpgroups each walk their own tiles with their own window ring and
//   barrier, so one warpgroup's epilogue runs under the other's products.
//   Per tap, a warpgroup runs wgmma m64n64k16: A, the 64 pixels' k16 chunk,
//   comes from registers that each warp fills with ldmatrix straight from
//   the window (the tap is an address offset, which shared-memory
//   descriptors could not express); B is read by the tensor cores from the
//   resident weights. One commit group per tap; the next tap's A loads
//   while it runs. Where two rings do not fit beside a large weight slice
//   (C_in 128 at stride 2), the block's 8 warps share one ring on mma.sync
//   instead. Six instances are built: the four TMA ones of the main path
//   (C_in 32 and 64 at stride 1 and 2) and the two cp.async ones of C_in
//   128, which take the stride at run time.
//   The f32 contract (cyv4_conv3x3_f32, pallas_conv.py with an f32 x): x
//   is f32, rounded to bf16 on its way into the window (pallas_conv.py:140),
//   and the output is f32. An f32 window would be twice the bytes, which
//   neither the TMA boxes (their swizzle spans a bf16 pixel) nor two rings
//   beside the weights leave room for, so the group's threads read the f32
//   pixels with 16-byte loads, round them in registers and store the bf16
//   chunks where the TMA or cp.async copy would have put them: the window,
//   the ring, the weights and the products are those of the bf16 kernel,
//   and only the loads (synchronous, hidden by the other warpgroup and
//   block) and the 8-byte f32 stores differ. Three instances, the stride
//   at run time: wgmma for C_in 32 and 64, mma.sync for C_in 128.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The library build compiles this file once per part, in parallel, so that
// nvcc's work on the eleven kernel instances splits three ways
// (ops/_build.py PARTS): CYV4_PART 1 the stem (and cyv4_error_string), 2
// the bf16 3x3 kernel, 3 its f32 instances. Without CYV4_PART every entry
// point is compiled.
#ifndef CYV4_PART
#define CYV4_PART 0
#endif
#define CYV4_HAS_PART(p) (CYV4_PART == 0 || CYV4_PART == (p))

namespace {

enum Act { ACT_LINEAR = 0, ACT_MISH = 1, ACT_LEAKY = 2, ACT_RELU = 3 };

__device__ __forceinline__ float apply_act(float x, int act) {
  if (act == ACT_MISH) {
    // Single-exp mish of the JAX executor (models/network.py _act):
    // s = exp(min(x, 20)); q = s*s + 2s; x * q / (q + 2). The fast exp and
    // divide are a few f32 ulps off, far inside the bf16 rounding that
    // follows; q + 2 stays below 2^126, where __fdividef is exact enough.
    float s = __expf(fminf(x, 20.0f));
    float q = s * s + 2.0f * s;
    return x > 20.0f ? x : __fdividef(x * q, q + 2.0f);
  }
  if (act == ACT_LEAKY) return x >= 0.0f ? x : 0.1f * x;
  if (act == ACT_RELU) return fmaxf(x, 0.0f);
  return x;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (or 4) bytes; with ok == false nothing is read and the
// destination is zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Wait until at most n (0..3, block-uniform) commit groups are pending.
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  if (n <= 0) cp_async_wait<0>();
  else if (n == 1) cp_async_wait<1>();
  else if (n == 2) cp_async_wait<2>();
  else cp_async_wait<3>();
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mbarrier and TMA (cp.async.bulk.tensor): one thread asks for a whole box
// of a tensor to be copied into shared memory; the copy's bytes complete a
// transaction count on an mbarrier that the consumers wait on by phase.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(phase)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma: a warpgroup (4 warps) multiplies a 64-row A, each warp's 16 rows
// in registers laid out as mma.sync's A fragment, by a B read by the tensor
// cores straight from shared memory through a descriptor.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Make this thread's shared-memory writes (cp.async included) visible to
// the tensor cores' operand reads, which go through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator registers across the
// asynchronous products.
__device__ __forceinline__ void wgmma_fence_operands(float (&d)[2][4][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[h][j][e])::"memory");
}

// Descriptor of a (16, 64) bf16 B tile at shared address `addr` (1024-byte
// aligned): rows of 64 channels (128 bytes, N-major), 16-byte chunks
// XOR-swizzled by row & 7 (the 128-byte swizzle), 8-row atoms 1024 bytes
// apart. N is one atom wide, so both byte offsets name the 8-row stride.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 64 f32: this warp's 16 rows, channels 32h + 8j + 2q + {0, 1} in
// d[h][j][0..1] and rows + 8 in d[h][j][2..3]) += a (16 x 16) * B (16 x 64).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[2][4][4], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0][0]), "+f"(d[0][0][1]), "+f"(d[0][0][2]), "+f"(d[0][0][3]),
        "+f"(d[0][1][0]), "+f"(d[0][1][1]), "+f"(d[0][1][2]), "+f"(d[0][1][3]),
        "+f"(d[0][2][0]), "+f"(d[0][2][1]), "+f"(d[0][2][2]), "+f"(d[0][2][3]),
        "+f"(d[0][3][0]), "+f"(d[0][3][1]), "+f"(d[0][3][2]), "+f"(d[0][3][3]),
        "+f"(d[1][0][0]), "+f"(d[1][0][1]), "+f"(d[1][0][2]), "+f"(d[1][0][3]),
        "+f"(d[1][1][0]), "+f"(d[1][1][1]), "+f"(d[1][1][2]), "+f"(d[1][1][3]),
        "+f"(d[1][2][0]), "+f"(d[1][2][1]), "+f"(d[1][2][2]), "+f"(d[1][2][3]),
        "+f"(d[1][3][0]), "+f"(d[1][3][1]), "+f"(d[1][3][2]), "+f"(d[1][3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Store one pixel's 32-channel accumulator slice (rows `half` of an m16n8
// fragment set, the bias already in it) after the activation. `px` points
// at the slice's first channel; lane q writes channels 8nj + 2q, 2q + 1 of
// each 8-channel group nj as one 4-byte word straight from the fragment,
// so a quad fills each group's 16 bytes. `c_left`: channels from the
// slice's start to C_out.
__device__ __forceinline__ void store_slice(const float (&acc)[4][4], int half, int act,
                                            __nv_bfloat16* px, int q, int c_left, bool ok) {
  uint32_t v[4];
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
    v[nj] = pack_bf16x2(apply_act(acc[nj][2 * half], act), apply_act(acc[nj][2 * half + 1], act));
  uint32_t* dst = reinterpret_cast<uint32_t*>(px) + q;
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
    if (ok && 8 * nj < c_left) dst[4 * nj] = v[nj];
}

// The same slice stored as f32 (the f32 instances): lane q writes channels
// 8nj + 2q, 2q + 1 as one 8-byte word.
__device__ __forceinline__ void store_slice(const float (&acc)[4][4], int half, int act,
                                            float* px, int q, int c_left, bool ok) {
  float2* dst = reinterpret_cast<float2*>(px) + q;
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
    if (ok && 8 * nj < c_left)
      dst[4 * nj] = make_float2(apply_act(acc[nj][2 * half], act),
                                apply_act(acc[nj][2 * half + 1], act));
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return n;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the driver, found through the runtime so that
// the library links no libcuda; null if the driver has none.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  return encode;
}

// A persistent grid: every SM filled with as many blocks as fit, never more
// blocks than work items; a multiple of `multiple`.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem, long long items,
                            int multiple, unsigned* grid) {
  int per_sm = 0;
  cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  const int sms = sm_count();
  if (per_sm < 1 || sms < 1) return cudaErrorInvalidConfiguration;
  long long g = (long long)sms * per_sm;
  g -= g % multiple;
  if (g < multiple) g = multiple;
  if (g > items) g = items;
  *grid = (unsigned)g;
  return cudaSuccess;
}

// ---------------------------------------------------------------- stem ----

constexpr int SMEM_ALIGN = 1024;  // TMA boxes and the swizzles (address bits 4..9)

constexpr int STEM_THREADS = 256;  // 8 warps, each walking its own tiles
constexpr int STEM_TH = 2;         // output rows per warp tile
constexpr int STEM_TW = 32;        // output columns per tile: two m16 runs
constexpr int STEM_WH = STEM_TH + 2;
constexpr int STEM_WW = STEM_TW + 2;
constexpr int STEM_MTILES = STEM_TH * STEM_TW / 16;

template <int CIN>
struct StemShape {
  // A window row starts LEAD floats into its slot row, so that the row's
  // first float, pixel ix0 = 32 tx - 1's first channel, sits LEAD floats
  // past a 16-byte boundary in x as in shared memory: (32 tx - 1) * CIN is
  // -CIN modulo 4.
  static constexpr int LEAD = (4 - CIN % 4) % 4;
  // floats per window row: LEAD + 34 pixels, rounded up to 16 bytes
  static constexpr int ROWF = (LEAD + STEM_WW * CIN + 3) / 4 * 4;
  // floats per window, rounded up to 128 bytes (a TMA destination)
  static constexpr int WIN = (STEM_WH * ROWF + 31) / 32 * 32;
  // windows per warp ring: 2..4, as many as keep the 8 rings within 96 KB
  static constexpr int FIT = 96 * 1024 / (8 * WIN * 4);
  static constexpr int STAGES = FIT >= 4 ? 4 : (FIT < 2 ? 2 : FIT);
  // alignment slack, the rings, then one 8-byte mbarrier per window slot
  static constexpr int SMEM = SMEM_ALIGN + 8 * STAGES * (WIN * 4 + 8);
  // a TMA box row is at most 256 elements
  static constexpr bool TMA_OK = ROWF <= 256;
};

// Each warp walks its own 2 x 32-pixel tiles with its own ring of windows,
// synchronized only within the warp, so the warps of an SM drift apart and
// one's epilogue runs under another's loads and products. A window is 4
// rows of ROWF floats: input pixels ix0 .. ix0 + 33 of rows iy0 .. iy0 + 3
// from float LEAD of each row, zeros outside the image. With use_tma, lane
// 0 asks for it as one TMA box of x viewed as (B, H, W * C_in) floats, from
// the 16-byte boundary LEAD floats before the row, whose out-of-bounds
// zeros are the padding; otherwise the lanes copy it element by element.
template <int CIN>
__global__ void __launch_bounds__(STEM_THREADS, CIN <= 6 ? 2 : 1)
stem_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ w,
            const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int B, int H,
            int W, int C_out, int act, const __grid_constant__ CUtensorMap x_map, int use_tma) {
  using Shape = StemShape<CIN>;
  constexpr int K = 9 * CIN;
  constexpr int KS = (K + 15) / 16;  // k16 steps; rows K.. are zero weights
  constexpr int LEAD = Shape::LEAD, ROWF = Shape::ROWF, WIN = Shape::WIN;
  constexpr int STAGES = Shape::STAGES;
  extern __shared__ __align__(1024) unsigned char stem_raw[];
  const uint32_t raw_s = smem_addr(stem_raw);
  float* stem_smem = reinterpret_cast<float*>(
      stem_raw + (((raw_s + SMEM_ALIGN - 1) & ~(uint32_t)(SMEM_ALIGN - 1)) - raw_s));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = lane & 3, gq = lane >> 2;
  // Warps split into groups of 32 output channels (4 groups for 65..96
  // channels, the last one idle); each group's warps split the tiles.
  const int ng = (C_out + 31) / 32;
  const int ngp = ng == 3 ? 4 : ng;
  const int grp = warp % ngp, wi = warp / ngp, wpg = (STEM_THREADS / 32) / ngp;
  if (grp >= ng) return;
  const int c0 = grp * 32;
  float* ring = stem_smem + warp * STAGES * WIN;
  const uint32_t bars = smem_addr(stem_smem + 8 * STAGES * WIN) + warp * STAGES * 8;
  if (use_tma && lane == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // B fragments of the group's (K, 32) weight slice, for the whole kernel:
  // reg r of (ks, nj) holds rows 16ks + 2q + 8r + {0, 1} of channel
  // c0 + 8nj + gq.
  uint32_t bw[KS][4][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = c0 + nj * 8 + gq, k = 16 * ks + 2 * q + 8 * r;
        const bool okn = n < C_out;
        const float lo = okn && k < K ? __bfloat162float(w[k * C_out + n]) : 0.0f;
        const float hi = okn && k + 1 < K ? __bfloat162float(w[(k + 1) * C_out + n]) : 0.0f;
        bw[ks][nj][r] = pack_bf16x2(lo, hi);
      }
  // Window offsets (floats from a pixel's window origin) of the lane's A
  // columns k = 16ks + 2q + 8(j>>1) + (j&1); -1 past K.
  int aoff[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 16 * ks + 2 * q + 8 * (j >> 1) + (j & 1);
      const int tap = k / CIN, ci = k - tap * CIN;
      aoff[ks][j] = k < K ? (tap / 3) * ROWF + (tap % 3) * CIN + ci : -1;
    }
  float bv[4][2];
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = c0 + nj * 8 + 2 * q + e;
      bv[nj][e] = n < C_out ? bias[n] : 0.0f;
    }

  const int tiles_x = (W + STEM_TW - 1) / STEM_TW, tiles_y = (H + STEM_TH - 1) / STEM_TH;
  const int n_tiles = B * tiles_y * tiles_x;

  // Fill window slot `slot` with tile t's rows oy0-1 .. oy0+2, columns
  // ox0-1 .. ox0+32, each a contiguous run of 34*CIN floats.
  auto fill = [&](int t, int slot) {
    if (t >= n_tiles) {
      if (!use_tma) cp_async_commit();
      return;
    }
    const int tx = t % tiles_x, rest = t / tiles_x;
    const int ty = rest % tiles_y, n = rest / tiles_y;
    const int iy0 = ty * STEM_TH - 1, ix0 = tx * STEM_TW - 1;
    if (use_tma) {
      if (lane == 0) {
        mbar_expect_tx(bars + 8 * slot, STEM_WH * ROWF * 4);
        tma_load_3d(smem_addr(ring + slot * WIN), &x_map, ix0 * CIN - LEAD, iy0, n,
                    bars + 8 * slot);
      }
      return;
    }
    for (int e = lane; e < STEM_WH * STEM_WW * CIN; e += 32) {
      const int r = e / (STEM_WW * CIN), rem = e - r * (STEM_WW * CIN);
      const int c = rem / CIN, ci = rem - c * CIN;
      const int gy = iy0 + r, gx = ix0 + c;
      const bool ok = (unsigned)gy < (unsigned)H && (unsigned)gx < (unsigned)W;
      const float* src = ok ? x + (((size_t)n * H + gy) * W + gx) * CIN + ci : x;
      cp_async4(smem_addr(ring + slot * WIN + r * ROWF + LEAD + rem), src, ok);
    }
    cp_async_commit();
  };

  // The warp's ring: STAGES - 1 windows load while a tile computes. The
  // wait (cp.async groups, or the slot's mbarrier) and the __syncwarp after
  // it publish the window to the warp's lanes and tell them all lanes are
  // done with the previous slot, which then takes the window STAGES - 1
  // tiles ahead.
  const int step = gridDim.x * wpg;
  int t = blockIdx.x * wpg + wi, cur = 0;
  uint32_t phases = 0;  // bit s: the parity of slot s's next TMA completion
  __syncwarp();         // the mbarriers are initialized
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fill(t + s * step, s);
  for (; t < n_tiles; t += step) {
    if (use_tma) {
      mbar_wait(bars + 8 * cur, (phases >> cur) & 1);
      phases ^= 1u << cur;
    } else {
      cp_async_wait<STAGES - 2>();
    }
    __syncwarp();
    fill(t + (STAGES - 1) * step, cur == 0 ? STAGES - 1 : cur - 1);

    const int tx = t % tiles_x, rest = t / tiles_x;
    const int ty = rest % tiles_y, n = rest / tiles_y;
    const float* win = ring + cur * WIN + LEAD;
#pragma unroll 1  // fewer live registers; unrolling measured slower
    for (int mt = 0; mt < STEM_MTILES; ++mt) {
      const int ry = mt >> 1, cx0 = (mt & 1) * 16;
      const float* p0 = win + ry * ROWF + (cx0 + gq) * CIN;  // pixel gq
      const float* p1 = p0 + 8 * CIN;                        // pixel gq + 8
      float acc[4][4];  // starts at the bias: element e is channel 2q + (e & 1)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nj][e] = bv[nj][e & 1];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        float v0[4], v1[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v0[j] = aoff[ks][j] >= 0 ? p0[aoff[ks][j]] : 0.0f;
          v1[j] = aoff[ks][j] >= 0 ? p1[aoff[ks][j]] : 0.0f;
        }
        const uint32_t a[4] = {pack_bf16x2(v0[0], v0[1]), pack_bf16x2(v1[0], v1[1]),
                               pack_bf16x2(v0[2], v0[3]), pack_bf16x2(v1[2], v1[3])};
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) mma_bf16(acc[nj], a, bw[ks][nj][0], bw[ks][nj][1]);
      }
      const int oy = ty * STEM_TH + ry;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ox = tx * STEM_TW + cx0 + gq + 8 * half;
        __nv_bfloat16* px = out + (((size_t)n * H + oy) * W + ox) * C_out + c0;
        store_slice(acc, half, act, px, q, C_out - c0, oy < H && ox < W);
      }
    }
    cur = cur + 1 == STAGES ? 0 : cur + 1;
  }
  cp_async_wait<0>();
}

// The tensor map of x (B, H, W, CIN) f32 viewed as (B, H, W * CIN) for the
// stem's TMA windows: a box of 4 rows x ROWF floats, out-of-bounds floats
// read as zero. False where the view's row is not a 16-byte multiple.
template <int CIN>
bool stem_tensor_map(CUtensorMap* map, const float* x, int B, int H, int W) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr || !StemShape<CIN>::TMA_OK || (W * CIN) % 4 != 0) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)W * CIN, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * CIN * 4, (cuuint64_t)H * W * CIN * 4};
  const cuuint32_t box[3] = {(cuuint32_t)StemShape<CIN>::ROWF, (cuuint32_t)STEM_WH, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(x), dims, strides,
                box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int CIN>
cudaError_t launch_stem(const float* x, const __nv_bfloat16* w, const float* bias,
                        __nv_bfloat16* out, int B, int H, int W, int C_out, int act,
                        cudaStream_t stream) {
  const long long tiles = (long long)B * ((H + STEM_TH - 1) / STEM_TH) *
                          ((W + STEM_TW - 1) / STEM_TW);
  if (tiles < 1) return cudaSuccess;
  CUtensorMap map{};
  const int use_tma = stem_tensor_map<CIN>(&map, x, B, H, W) ? 1 : 0;
  const int smem = StemShape<CIN>::SMEM;
  cudaError_t e =
      cudaFuncSetAttribute(stem_kernel<CIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  // warps per block that share one channel group's tiles
  const int ng = (C_out + 31) / 32, wpg = (STEM_THREADS / 32) / (ng == 3 ? 4 : ng);
  unsigned grid = 0;
  e = persistent_grid(stem_kernel<CIN>, STEM_THREADS, smem, (tiles + wpg - 1) / wpg, 1, &grid);
  if (e != cudaSuccess) return e;
  stem_kernel<CIN><<<grid, STEM_THREADS, smem, stream>>>(x, w, bias, out, B, H, W, C_out, act,
                                                         map, use_tma);
  return cudaGetLastError();
}

// ------------------------------------------------------------- conv3x3 ----

constexpr int CONV_THREADS = 256;  // 8 warps: two warpgroups
constexpr int CONV_TH = 4;         // output rows per tile: one per warp of a group
constexpr int CONV_TW = 16;        // output columns per tile: one m16 run
constexpr int CONV_BN = 64;        // output channels per tile
constexpr int SM_SMEM = 233472;    // shared memory of one sm_90 SM
constexpr int BLOCK_SMEM_RESERVED = 1024;  // the runtime's share of it per block
constexpr int MBAR_BYTES = 64;     // one 8-byte mbarrier per window slot, at most 8

// How a tile's window reaches shared memory.
enum Load {
  LOAD_CP16 = 1,  // 16-byte cp.async copies by the group's threads
  LOAD_TMA = 2,   // C_in 32 or 64: one TMA box per stride phase
  LOAD_F32 = 3,   // an f32 x: the group's threads read it, round it to bf16
                  // and store it in the bf16 window's layout
};

// A block's warps form groups that each walk their own tiles with their own
// window ring and barrier, so one group's epilogue runs under another's
// products. wgmma: two groups, each a warpgroup multiplying 4 rows x 16
// pixels by 64 channels. mma.sync: one group of 8 warps, 4 rows x 2
// channel halves, for a weight slice too large to leave room for two rings.
//
// Choices in order of preference, the first that fits wins: wgmma or not,
// windows in each ring, and the blocks per SM whose weights and rings the
// SM's shared memory must hold at once.
struct TileChoice {
  bool wgmma;
  int stages, per_sm;
};
constexpr TileChoice kTileChoices[] = {{true, 4, 2},  {true, 3, 2},  {true, 2, 2},
                                       {true, 1, 2},  {true, 2, 1},  {true, 1, 1},
                                       {false, 2, 1}, {false, 1, 1}};

// Geometry of one launch, computed on the host. A window is S blocks (the
// even then the odd input columns at stride 2), each win_h rows x cols
// pixels x cp channels, padded to a 1024-byte multiple.
struct ConvGeom {
  int B, H, W, C_in, C_out, Ho, Wo;
  int S;         // the stride, for the instances that take it at run time
  int cp;        // C_in (32, 64 or 128): the window's channels
  int nch;       // cp / 8: 16-byte chunks per window pixel
  int nch_log2;  // log2(nch)
  int swz_shift, swz_mask;  // chunk c of block pixel p sits at c ^ ((p >> shift) & mask)
  int win_h, win_w;         // input rows and columns a tile reads
  int cols;                 // pixels per block row: 18 at stride 1, 17 at stride 2
  float inv_win_w;
  int blk_bytes, win_bytes;
  int tiles_x, tiles_y, n_spatial, n_ctiles;
  int stages;  // windows in each ring: stages - 1 load while a tile computes
};

// Copy tile t's window into shared memory at shared address `dst_s` with
// 16-byte cp.async by the NT threads of a group (gtid: the thread's index
// in it): input pixel (iy0 + r, ix0 + c) goes to block c % s, pixel
// r * cols + c / s; zero outside the image. s (1 or 2) is S, or g.S where
// S is 0.
template <int S, int NT>
__device__ __forceinline__ void conv_load_window(const __nv_bfloat16* __restrict__ x,
                                                 const ConvGeom& g, int t, uint32_t dst_s,
                                                 int gtid) {
  const int s = S > 0 ? S : g.S;
  const int tx = t % g.tiles_x, rest = t / g.tiles_x;
  const int ty = rest % g.tiles_y, n = rest / g.tiles_y;
  const int iy0 = ty * CONV_TH * s - 1, ix0 = tx * CONV_TW * s - 1;
  const __nv_bfloat16* xn = x + (size_t)n * g.H * g.W * g.C_in;
  const int total = (g.win_h * g.win_w) << g.nch_log2;
  for (int e = gtid; e < total; e += NT) {
    const int pix = e >> g.nch_log2, ch = e & (g.nch - 1);
    const int r = __float2int_rz(((float)pix + 0.5f) * g.inv_win_w);
    const int c = pix - r * g.win_w;
    const int gy = iy0 + r, gx = ix0 + c;
    const bool ok = (unsigned)gy < (unsigned)g.H && (unsigned)gx < (unsigned)g.W;
    const int p = r * g.cols + (c >> (s - 1));
    const __nv_bfloat16* src = ok ? xn + ((size_t)gy * g.W + gx) * g.C_in + ch * 8 : x;
    cp_async16(dst_s + (c & (s - 1)) * g.blk_bytes +
                   ((p * g.nch + (ch ^ ((p >> g.swz_shift) & g.swz_mask))) << 4),
               src, ok);
  }
}

// The same window from an f32 x (the f32 instances): each thread reads the
// 8 floats of a 16-byte bf16 chunk with two 16-byte loads, rounds them to
// bf16 (round to nearest even, as the plain version's cast) and stores the
// chunk where conv_load_window would put it, so the window in shared memory
// is bf16 before any A fragment is read from it and the products, the ring
// and shared memory are those of the bf16 instances. The stride is g.S.
template <int NT>
__device__ __forceinline__ void conv_load_window_f32(const float* __restrict__ x,
                                                     const ConvGeom& g, int t, uint32_t dst_s,
                                                     int gtid) {
  const int s = g.S;
  const int tx = t % g.tiles_x, rest = t / g.tiles_x;
  const int ty = rest % g.tiles_y, n = rest / g.tiles_y;
  const int iy0 = ty * CONV_TH * s - 1, ix0 = tx * CONV_TW * s - 1;
  const float* xn = x + (size_t)n * g.H * g.W * g.C_in;
  const int total = (g.win_h * g.win_w) << g.nch_log2;
  for (int e = gtid; e < total; e += NT) {
    const int pix = e >> g.nch_log2, ch = e & (g.nch - 1);
    const int r = __float2int_rz(((float)pix + 0.5f) * g.inv_win_w);
    const int c = pix - r * g.win_w;
    const int gy = iy0 + r, gx = ix0 + c;
    const bool ok = (unsigned)gy < (unsigned)g.H && (unsigned)gx < (unsigned)g.W;
    const int p = r * g.cols + (c >> (s - 1));
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (ok) {
      const float4* src =
          reinterpret_cast<const float4*>(xn + ((size_t)gy * g.W + gx) * g.C_in + ch * 8);
      const float4 a = __ldg(src), b = __ldg(src + 1);
      v = make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w), pack_bf16x2(b.x, b.y),
                     pack_bf16x2(b.z, b.w));
    }
    st_shared_v4(dst_s + (c & (s - 1)) * g.blk_bytes +
                     ((p * g.nch + (ch ^ ((p >> g.swz_shift) & g.swz_mask))) << 4),
                 v);
  }
}

// Ask for tile t's window by TMA (one thread): one box per stride phase,
// the tensor map's out-of-bounds zeros being the 1-px padding and its
// swizzle the one the ldmatrix addresses undo.
template <int S>
__device__ __forceinline__ void conv_tma_window(const CUtensorMap* map, const ConvGeom& g, int t,
                                                uint32_t dst_s, uint32_t bar) {
  const int tx = t % g.tiles_x, rest = t / g.tiles_x;
  const int ty = rest % g.tiles_y, n = rest / g.tiles_y;
  const int iy0 = ty * CONV_TH * S - 1, ix0 = tx * CONV_TW * S - 1;
  mbar_expect_tx(bar, S * g.win_h * g.cols * g.cp * 2);
#pragma unroll
  for (int ph = 0; ph < S; ++ph)
    tma_load_4d(dst_s + ph * g.blk_bytes, map, 0, ix0 + ph, iy0, n, bar);
}

// Barrier of one group's threads (named barrier 1 + group).
template <int NT>
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "n"(NT) : "memory");
}

// Blocks per SM that the register budget is cut for: two, unless the
// weights and rings of that C_in and stride never leave room for a second
// block (then a 255-register cap avoids spills).
constexpr int conv_min_blocks(int S, int KC) { return KC == 8 || (KC == 4 && S == 2) ? 1 : 2; }

// KC > 0: wgmma, cp == 16 * KC; each warpgroup multiplies its tile's 64
// pixels (A: each warp's row, ldmatrix from the window) by the 64-channel
// weight slice (B: read from shared memory by the tensor cores). KC == 0:
// mma.sync; each warp takes one row and 32 channels. S: the stride, or 0
// to take it from g.S (cp.async and f32 windows only). T: the type of x
// and out, bf16 or (LOAD_F32) float.
template <int S, int LOAD, int KC, typename T>
__global__ void __launch_bounds__(CONV_THREADS, conv_min_blocks(S, KC))
conv3x3_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ out, ConvGeom g,
               int act, const __grid_constant__ CUtensorMap x_map) {
  static_assert(S > 0 || LOAD != LOAD_TMA, "TMA boxes need the stride at compile time");
  static_assert((LOAD == LOAD_F32) == (sizeof(T) == 4), "f32 x and out go with LOAD_F32");
  constexpr bool WG = KC > 0;
  constexpr int GROUPS = WG ? 2 : 1;
  constexpr int NT = CONV_THREADS / GROUPS;  // threads per group
  constexpr int NH = WG ? 2 : 1;             // 32-channel halves per warp
  const int st = S > 0 ? S : g.S;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw_s = smem_addr(smem_raw);
  const uint32_t w_s = (raw_s + SMEM_ALIGN - 1) & ~(uint32_t)(SMEM_ALIGN - 1);
  const int w_bytes = 9 * g.cp * CONV_BN * 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid / NT, gtid = tid % NT;
  const int row = WG ? warp & 3 : warp >> 1;  // the warp's output row in its tile
  const int h0 = WG ? 0 : warp & 1;           // its first 32-channel half
  const int q = lane & 3, gq = lane >> 2;
  const int n0 = (blockIdx.x % g.n_ctiles) * CONV_BN;
  const int ring = w_bytes + grp * g.stages * g.win_bytes;
  // the group's mbarriers, one per window slot (TMA only)
  const uint32_t bars = w_s + w_bytes + GROUPS * g.stages * g.win_bytes + grp * g.stages * 8;
  if (LOAD == LOAD_TMA && gtid == 0) {
    for (int s = 0; s < g.stages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // The block's (9*cp, 64) weight slice: row k = tap*cp + ci, its 16-byte
  // chunk c (channels 8c..8c+7) stored at c ^ (k & 7), the 128-byte swizzle;
  // zero columns past C_out.
  for (int e = tid; e < 9 * g.cp * 8; e += CONV_THREADS) {
    const int k = e >> 3, c = e & 7;
    const int n = n0 + c * 8;
    const bool ok = n < g.C_out;
    const __nv_bfloat16* src = ok ? w + ((size_t)k * g.C_out + n) : w;
    cp_async16(w_s + k * 128 + ((c ^ (k & 7)) << 4), src, ok);
  }
  cp_async_commit();
  float bv[NH][4][2];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + (h0 + h) * 32 + nj * 8 + 2 * q + e;
        bv[h][nj][e] = n < g.C_out ? bias[n] : 0.0f;
      }

  // A (ldmatrix x4): lane l gives the row address of pixel l & 15 of the
  // warp's m16 run, channels 8*(l >> 4) of the k16 chunk.
  const int ai = lane & 15, akh = lane >> 4;

  // The group's ring of g.stages windows. With two or more, one barrier per
  // tile: it tells the group's threads that all its warps are done with the
  // previous slot, which then takes the window stages - 1 tiles ahead while
  // this tile computes. With one, the window is refilled after a second
  // barrier, under the epilogue. cp.async windows are published by each
  // thread's wait and that barrier, TMA windows by their slot's mbarrier.
  const int step = gridDim.x / g.n_ctiles * GROUPS;
  const int ahead = g.stages > 1 ? g.stages - 1 : 1;
  int t = blockIdx.x / g.n_ctiles * GROUPS + grp, cur = 0;
  uint32_t phases = 0;  // bit s: the parity of slot s's next TMA completion
  auto fill = [&](int tile, int slot) {
    const int off = ring + slot * g.win_bytes;
    if (LOAD == LOAD_TMA) {
      if (gtid == 0 && tile < g.n_spatial)
        conv_tma_window<S>(&x_map, g, tile, w_s + off, bars + 8 * slot);
    } else {
      if (tile < g.n_spatial) {
        if constexpr (LOAD == LOAD_F32)
          conv_load_window_f32<NT>(x, g, tile, w_s + off, gtid);
        else
          conv_load_window<S, NT>(x, g, tile, w_s + off, gtid);
      }
      cp_async_commit();
    }
  };
  if (LOAD == LOAD_TMA) __syncthreads();  // the mbarriers are initialized
  for (int s = 0; s < ahead; ++s) fill(t + s * step, s);
  // the weights (the oldest group) have landed and, for wgmma, are visible
  // to the tensor cores' reads, in every thread
  cp_async_wait_pending(LOAD == LOAD_TMA ? 0 : ahead);
  if constexpr (WG) fence_proxy_async();
  __syncthreads();
  for (; t < g.n_spatial; t += step) {
    if (LOAD == LOAD_TMA) {
      mbar_wait(bars + 8 * cur, (phases >> cur) & 1);
      phases ^= 1u << cur;
    } else {
      cp_async_wait_pending(g.stages - 2);
    }
    group_sync<NT>(grp);
    if (g.stages > 1) fill(t + (g.stages - 1) * step, cur == 0 ? g.stages - 1 : cur - 1);

    const uint32_t win_s = w_s + ring + cur * g.win_bytes;
    // shared address of the 16-byte chunk `chunk` of the window pixel that
    // output column ai of the warp's row reads at tap (ky, kx)
    auto a_addr = [&](int ky, int kx, int chunk) -> uint32_t {
      const int blk = st == 1 ? 0 : (kx & 1);
      const int p = (row * st + ky) * g.cols + (st == 1 ? ai + kx : ai + (kx >> 1));
      return win_s + blk * g.blk_bytes +
             ((p * g.nch + (chunk ^ ((p >> g.swz_shift) & g.swz_mask))) << 4);
    };
    float acc[NH][4][4];  // starts at the bias: element e is channel 2q + (e & 1)
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][nj][e] = bv[h][nj][e & 1];
    if constexpr (WG) {
      // One commit group per tap (KC products); the next tap's A loads into
      // the other register set while this tap's products run.
      uint32_t a[2][KC][4];
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) ldmatrix_x4(a[0][kc], a_addr(0, 0, 2 * kc + akh));
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        wgmma_fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < KC; ++kc)
          wgmma_m64n64k16(acc, a[tap & 1][kc], b_desc(w_s + (tap * KC + kc) * 16 * 128));
        wgmma_commit();
        if (tap < 8) {
          wgmma_wait<1>();
#pragma unroll
          for (int kc = 0; kc < KC; ++kc)
            ldmatrix_x4(a[(tap + 1) & 1][kc],
                        a_addr((tap + 1) / 3, (tap + 1) % 3, 2 * kc + akh));
        }
      }
      wgmma_wait<0>();
      wgmma_fence_operands(acc);
    } else {
      // B (ldmatrix x4 trans): weight row kb of the k16 chunk, chunk cb
      // (and cb + 2) of the warp's 32 channels.
      const int kb = (lane & 7) + ((lane >> 3) & 1) * 8;
      const int cb = h0 * 4 + (lane >> 4);
      const uint32_t b_lane = w_s + kb * 128;
      const uint32_t b_off0 = (cb ^ (lane & 7)) << 4, b_off1 = ((cb + 2) ^ (lane & 7)) << 4;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const uint32_t b_tap = b_lane + (ky * 3 + kx) * g.cp * 128;
#pragma unroll 2
          for (int kc = 0; kc < g.cp / 16; ++kc) {
            uint32_t a[4], b[2][4];
            ldmatrix_x4(a, a_addr(ky, kx, 2 * kc + akh));
            const uint32_t bk = b_tap + kc * 16 * 128;
            ldmatrix_x4_trans(b[0], bk + b_off0);
            ldmatrix_x4_trans(b[1], bk + b_off1);
#pragma unroll
            for (int nj = 0; nj < 4; ++nj)
              mma_bf16(acc[0][nj], a, b[nj >> 1][(nj & 1) * 2], b[nj >> 1][(nj & 1) * 2 + 1]);
          }
        }
      }
    }
    if (g.stages == 1) {  // one window: refill it once the group is done with it
      group_sync<NT>(grp);
      fill(t + step, 0);
    }

    const int tx = t % g.tiles_x, rest = t / g.tiles_x;
    const int ty = rest % g.tiles_y, n = rest / g.tiles_y;
    const int oy = ty * CONV_TH + row;
    if (oy < g.Ho) {  // warp-uniform
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const int c0 = n0 + (h0 + h) * 32;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ox = tx * CONV_TW + gq + 8 * half;
          T* px = out + (((size_t)n * g.Ho + oy) * g.Wo + ox) * g.C_out + c0;
          store_slice(acc[h], half, act, px, q, g.C_out - c0, ox < g.Wo);
        }
      }
    }
    cur = cur + 1 == g.stages ? 0 : cur + 1;
  }
  cp_async_wait<0>();
}

size_t conv_smem_bytes(const ConvGeom& g, int groups, int stages) {
  return SMEM_ALIGN + (size_t)9 * g.cp * CONV_BN * 2 + (size_t)groups * stages * g.win_bytes +
         MBAR_BYTES;
}

// Fill in the launch geometry and whether it runs on wgmma; false if no
// ring fits shared memory.
bool conv_geometry(ConvGeom& g, bool& wgmma, int B, int H, int W, int C_in, int C_out, int S) {
  g.B = B, g.H = H, g.W = W, g.C_in = C_in, g.C_out = C_out, g.S = S;
  g.Ho = H / S, g.Wo = W / S;
  g.cp = C_in;
  g.nch = g.cp / 8;
  g.nch_log2 = 0;
  while ((1 << g.nch_log2) < g.nch) ++g.nch_log2;
  // XOR-ing a chunk index by at most 3 bits, and fewer than nch has, keeps
  // it inside its pixel; with a pixel of 64 or 128 bytes this is TMA's 64-
  // or 128-byte swizzle
  const int lg = g.nch_log2 < 3 ? g.nch_log2 : 3;
  g.swz_mask = (1 << lg) - 1;
  g.swz_shift = 3 - lg;
  g.win_h = (CONV_TH - 1) * S + 3;
  g.win_w = (CONV_TW - 1) * S + 3;
  g.cols = S == 1 ? g.win_w : (g.win_w + 1) / 2;
  g.inv_win_w = 1.0f / (float)g.win_w;
  g.blk_bytes = (g.win_h * g.cols * g.cp * 2 + SMEM_ALIGN - 1) / SMEM_ALIGN * SMEM_ALIGN;
  g.win_bytes = S * g.blk_bytes;
  g.tiles_x = (g.Wo + CONV_TW - 1) / CONV_TW;
  g.tiles_y = (g.Ho + CONV_TH - 1) / CONV_TH;
  g.n_spatial = B * g.tiles_y * g.tiles_x;
  g.n_ctiles = (C_out + CONV_BN - 1) / CONV_BN;
  for (const TileChoice& c : kTileChoices) {
    const size_t budget = SM_SMEM / c.per_sm - BLOCK_SMEM_RESERVED;
    if (conv_smem_bytes(g, c.wgmma ? 2 : 1, c.stages) > budget) continue;
    wgmma = c.wgmma, g.stages = c.stages;
    return true;
  }
  return false;
}

// The tensor map of x (B, H, W, C_in) bf16 for TMA windows: a box of C_in
// channels x one stride phase of the window's columns x its rows, every
// S-th column, out-of-bounds elements read as zero.
cudaError_t conv_tensor_map(CUtensorMap* map, const __nv_bfloat16* x, const ConvGeom& g) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)g.C_in, (cuuint64_t)g.W, (cuuint64_t)g.H,
                              (cuuint64_t)g.B};
  const cuuint64_t strides[3] = {(cuuint64_t)g.C_in * 2, (cuuint64_t)g.W * g.C_in * 2,
                                 (cuuint64_t)g.H * g.W * g.C_in * 2};
  // boxDim counts the elements traversed: S * cols columns give cols of them
  const cuuint32_t box[4] = {(cuuint32_t)g.C_in, (cuuint32_t)(g.S * g.cols), (cuuint32_t)g.win_h,
                             1};
  const cuuint32_t estr[4] = {1, (cuuint32_t)g.S, 1, 1};
  const CUtensorMapSwizzle swz =
      g.C_in == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<__nv_bfloat16*>(x),
                            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int S, int LOAD, int KC, typename T = __nv_bfloat16>
cudaError_t launch_conv(const T* x, const __nv_bfloat16* w, const float* bias, T* out,
                        const ConvGeom& g, int act, cudaStream_t stream) {
  constexpr int groups = KC > 0 ? 2 : 1;
  const size_t smem = conv_smem_bytes(g, groups, g.stages);
  CUtensorMap map{};
  cudaError_t e = cudaSuccess;
  if constexpr (LOAD == LOAD_TMA) e = conv_tensor_map(&map, x, g);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(conv3x3_kernel<S, LOAD, KC, T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  unsigned grid = 0;
  e = persistent_grid(conv3x3_kernel<S, LOAD, KC, T>, CONV_THREADS, smem,
                      (long long)(g.n_spatial + groups - 1) / groups * g.n_ctiles, g.n_ctiles,
                      &grid);
  if (e != cudaSuccess) return e;
  conv3x3_kernel<S, LOAD, KC, T><<<grid, CONV_THREADS, smem, stream>>>(x, w, bias, out, g, act,
                                                                       map);
  return cudaGetLastError();
}

// The kernel for this geometry: TMA windows on wgmma where C_in is 32 or
// 64 (the main path); 16-byte cp.async where C_in is 128, with the stride
// taken at run time: on wgmma, or on mma.sync where two rings do not fit
// (stride 2).
#if CYV4_HAS_PART(2)
cudaError_t launch_conv_for(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* bias,
                            __nv_bfloat16* out, const ConvGeom& g, bool wgmma, int act,
                            cudaStream_t stream) {
  if (!wgmma) return launch_conv<0, LOAD_CP16, 0>(x, w, bias, out, g, act, stream);
  if (g.cp == 128) return launch_conv<0, LOAD_CP16, 8>(x, w, bias, out, g, act, stream);
  if (g.S == 1)
    return g.cp == 32 ? launch_conv<1, LOAD_TMA, 2>(x, w, bias, out, g, act, stream)
                      : launch_conv<1, LOAD_TMA, 4>(x, w, bias, out, g, act, stream);
  return g.cp == 32 ? launch_conv<2, LOAD_TMA, 2>(x, w, bias, out, g, act, stream)
                    : launch_conv<2, LOAD_TMA, 4>(x, w, bias, out, g, act, stream);
}
#endif

// The f32 instances, with the stride taken at run time: wgmma for C_in 32
// and 64 (the main path), mma.sync for C_in 128 (off it), so that three
// instances cover every shape.
#if CYV4_HAS_PART(3)
cudaError_t launch_conv_f32(const float* x, const __nv_bfloat16* w, const float* bias,
                            float* out, const ConvGeom& g, bool wgmma, int act,
                            cudaStream_t stream) {
  if (!wgmma || g.cp == 128) return launch_conv<0, LOAD_F32, 0>(x, w, bias, out, g, act, stream);
  return g.cp == 32 ? launch_conv<0, LOAD_F32, 2>(x, w, bias, out, g, act, stream)
                    : launch_conv<0, LOAD_F32, 4>(x, w, bias, out, g, act, stream);
}
#endif

}  // namespace

extern "C" {

#if CYV4_HAS_PART(1)
const char* cyv4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, H, W, C_in) f32 NHWC; w (9*C_in, C_out) bf16; bias (C_out,) f32;
// out (B, H, W, C_out) bf16. C_in 3 or 14, C_out % 8 == 0, C_out <= 128.
int cyv4_stem_conv3x3(const void* x, const void* w, const void* bias, void* out,
                      int B, int H, int W, int C_in, int C_out, int act, void* stream) {
  const float* xp = static_cast<const float*>(x);
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(w);
  const float* bp = static_cast<const float*>(bias);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C_out % 8 != 0 || C_out > 128) return (int)cudaErrorInvalidValue;
  if (C_in == 3) return (int)launch_stem<3>(xp, wp, bp, op, B, H, W, C_out, act, s);
  if (C_in == 14) return (int)launch_stem<14>(xp, wp, bp, op, B, H, W, C_out, act, s);
  return (int)cudaErrorInvalidValue;
}
#endif

// x (B, H, W, C_in) bf16 NHWC; w (9*C_in, C_out) bf16; bias (C_out,) f32;
// out (B, H/stride, W/stride, C_out) bf16. stride 1 or 2, C_in 32, 64 or
// 128, C_out % 8 == 0.
#if CYV4_HAS_PART(2)
int cyv4_conv3x3(const void* x, const void* w, const void* bias, void* out, int B,
                 int H, int W, int C_in, int C_out, int stride, int act, void* stream) {
  if ((stride != 1 && stride != 2) || (C_in != 32 && C_in != 64 && C_in != 128) ||
      C_out % 8 != 0 || C_out < 8)
    return (int)cudaErrorInvalidValue;
  ConvGeom g;
  bool wg = false;
  if (!conv_geometry(g, wg, B, H, W, C_in, C_out, stride)) return (int)cudaErrorInvalidValue;
  if (g.n_spatial < 1) return (int)cudaSuccess;
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(w);
  const float* bp = static_cast<const float*>(bias);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)launch_conv_for(xp, wp, bp, op, g, wg, act, s);
}
#endif

// The f32 contract of the same conv: x (B, H, W, C_in) f32 NHWC, rounded
// to bf16 as it is loaded; w and bias as above; out (B, H/stride,
// W/stride, C_out) f32 (the bias and activation in f32, not rounded).
#if CYV4_HAS_PART(3)
int cyv4_conv3x3_f32(const void* x, const void* w, const void* bias, void* out, int B,
                     int H, int W, int C_in, int C_out, int stride, int act, void* stream) {
  if ((stride != 1 && stride != 2) || (C_in != 32 && C_in != 64 && C_in != 128) ||
      C_out % 8 != 0 || C_out < 8)
    return (int)cudaErrorInvalidValue;
  ConvGeom g;
  bool wg = false;
  if (!conv_geometry(g, wg, B, H, W, C_in, C_out, stride)) return (int)cudaErrorInvalidValue;
  if (g.n_spatial < 1) return (int)cudaSuccess;
  return (int)launch_conv_f32(static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(w),
                              static_cast<const float*>(bias), static_cast<float*>(out), g, wg,
                              act, static_cast<cudaStream_t>(stream));
}
#endif

}  // extern "C"
