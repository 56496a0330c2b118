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
// (f32 in and out for cyv4_conv3x3_f32, whose design is its own: below).
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
//
// cyv4_conv3x3_f32 is the f32 contract of the same Pallas kernel
// (pallas_conv.py with an f32 x): x is f32, rounded to bf16 for the
// products (pallas_conv.py:140), and the output is f32 (:161).
//   What bounds it: the five layers at batch 8 move 1,325 MB (f32 in and
//   out; 567 MB of it is output), 0.396 ms at 3.35 TB/s, against the same
//   109 GFLOP at the bf16 peak (x and w are rounded to bf16): bounded by
//   bytes, by twice as much as the bf16 kernel.
//   What the design does: a block is two consumer warpgroups and one
//   producer warp. The producer's one thread keeps a ring of f32 window
//   units in flight by TMA: a unit is one 32-channel slice of a tile's
//   (3*s+3) x (15*s+3) input window, one box of x viewed as (B, H, W,
//   C_in) floats, 128 bytes a pixel in the 128-byte swizzle, its
//   out-of-bounds zeros the padding; no thread waits for a load it did not
//   need yet, and no index arithmetic is left to the consumers beyond a
//   tap's pixel offset. The consumers take the units in turn, tile by tile
//   (C_in / 32 units a tile), and build each wgmma A fragment straight
//   from the f32 slot: a 16-byte ld.shared per fragment row and k16 chunk,
//   rounded to bf16 in registers (the plain version's cast), so the f32
//   window needs no bf16 copy. Each quad's lane q takes channels 4q..4q+3
//   of a k16 chunk (the weight rows are stored in that order), and the two
//   fragment rows of a quarter-warp are output columns 4 window pixels
//   apart, so the eight 16-byte loads of a quarter-warp hit the eight
//   chunks of a 128-byte row. The weight slice stays resident as in the
//   bf16 kernel. The epilogue writes the activated f32 tile into the
//   warpgroup's own 16 KB output tile in shared memory (128-byte swizzle)
//   and one thread sends it out as two TMA stores (32 channels each, which
//   clip the ragged edges), then the warpgroup goes on to its next tile's
//   products while the stores drain. The stride is a template parameter
//   (two instances); C_in (32, 64 or 128) sets the units a tile. Shared
//   memory per block: the weights (36.9, 73.7 or 147.5 KB), two 16 KB
//   output tiles and the ring, as many units as fit up to 8: a unit is
//   14 KB at stride 1 and 38 KB at stride 2, so C_in 32 holds 8 and 4
//   (L6; L1), C_in 64 8 and 3 (L16, L19; L11), C_in 128 (off the main
//   path) 3 and 1.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The library build compiles this file once per part, in parallel, so that
// nvcc's work on the ten kernel instances splits three ways (ops/_build.py
// PARTS): CYV4_PART 1 the stem (and cyv4_error_string), 2 the bf16 3x3
// kernel, 3 its f32 contract. Without CYV4_PART every entry
// point is compiled.
#ifndef CYV4_PART
#define CYV4_PART 0
#endif
#define CYV4_HAS_PART(p) (CYV4_PART == 0 || CYV4_PART == (p))

namespace {

enum Act { ACT_LINEAR = 0, ACT_MISH = 1, ACT_LEAKY = 2, ACT_RELU = 3 };

template <int ACT>
__device__ __forceinline__ float act_of(float x) {
  if (ACT == ACT_MISH) {
    // Single-exp mish of the JAX executor (models/network.py _act):
    // s = exp(min(x, 20)); q = s*s + 2s; x * q / (q + 2). The fast exp and
    // divide are a few f32 ulps off, far inside the bf16 rounding that
    // follows; q + 2 stays below 2^126, where __fdividef is exact enough.
    float s = __expf(fminf(x, 20.0f));
    float q = s * s + 2.0f * s;
    return x > 20.0f ? x : __fdividef(x * q, q + 2.0f);
  }
  if (ACT == ACT_LEAKY) return x >= 0.0f ? x : 0.1f * x;
  if (ACT == ACT_RELU) return fmaxf(x, 0.0f);
  return x;
}

__device__ __forceinline__ float apply_act(float x, int act) {
  if (act == ACT_MISH) return act_of<ACT_MISH>(x);
  if (act == ACT_LEAKY) return act_of<ACT_LEAKY>(x);
  if (act == ACT_RELU) return act_of<ACT_RELU>(x);
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

__device__ __forceinline__ float4 ld_shared_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_f2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// TMA store of a box from shared memory, tracked by the thread's bulk
// groups; the tensor map clips what lies past the tensor's edge.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
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
// to take it from g.S (cp.async windows only).
template <int S, int LOAD, int KC>
__global__ void __launch_bounds__(CONV_THREADS, conv_min_blocks(S, KC))
conv3x3_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, ConvGeom g,
               int act, const __grid_constant__ CUtensorMap x_map) {
  static_assert(S > 0 || LOAD != LOAD_TMA, "TMA boxes need the stride at compile time");
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
      if (tile < g.n_spatial) conv_load_window<S, NT>(x, g, tile, w_s + off, gtid);
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
          __nv_bfloat16* px = out + (((size_t)n * g.Ho + oy) * g.Wo + ox) * g.C_out + c0;
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

template <int S, int LOAD, int KC>
cudaError_t launch_conv(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* bias,
                        __nv_bfloat16* out, const ConvGeom& g, int act, cudaStream_t stream) {
  constexpr int groups = KC > 0 ? 2 : 1;
  const size_t smem = conv_smem_bytes(g, groups, g.stages);
  CUtensorMap map{};
  cudaError_t e = cudaSuccess;
  if constexpr (LOAD == LOAD_TMA) e = conv_tensor_map(&map, x, g);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(conv3x3_kernel<S, LOAD, KC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  unsigned grid = 0;
  e = persistent_grid(conv3x3_kernel<S, LOAD, KC>, CONV_THREADS, smem,
                      (long long)(g.n_spatial + groups - 1) / groups * g.n_ctiles, g.n_ctiles,
                      &grid);
  if (e != cudaSuccess) return e;
  conv3x3_kernel<S, LOAD, KC><<<grid, CONV_THREADS, smem, stream>>>(x, w, bias, out, g, act,
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

// ------------------------------------------------------- conv3x3, f32 ----

constexpr int F32_THREADS = 288;  // two consumer warpgroups and one producer warp
constexpr int F32_SLICE = 32;     // input channels a ring unit holds: a 128-byte pixel row
constexpr int F32_OUT_BOX = CONV_TH * CONV_TW * F32_SLICE * 4;  // 32 channels of a tile, f32
constexpr int F32_OUT = 2 * F32_OUT_BOX;  // a warpgroup's 64-channel output tile (16 KB)
constexpr int F32_MAX_SLOTS = 8;          // ring units at most

// Geometry of one f32 launch, computed on the host. A ring unit is one
// 32-channel slice of a tile's input window: win_h rows x win_w pixels x 128
// bytes, as one TMA box writes it in the 128-byte swizzle.
struct F32Geom {
  int C_in, C_out, Ho, Wo;
  int win_h, win_w;
  int slot_bytes;  // a unit's bytes, padded to a 1024-byte multiple (the swizzle's period)
  int ns;          // units per tile: C_in / 32
  int slots;       // units the ring holds
  int tiles_x, tiles_y, n_spatial, n_ctiles;
};

// Output column (0..7; + 8 for fragment rows 8..15) of fragment row g of a
// warp's 16-pixel run. The two rows a quarter-warp reads (g = 2j, 2j + 1)
// lie 4 window pixels apart, so their 16-byte chunks fall in opposite
// halves of the 128-byte swizzle and the quarter-warp's eight 16-byte loads
// hit eight distinct chunks of a 128-byte row (no bank conflict).
template <int S>
__device__ __forceinline__ int f32_col(int g) {
  return S == 1 ? ((g & 1) << 2) | (g >> 1) : (g & 4) | ((g & 1) << 1) | ((g >> 1) & 1);
}

// The A fragments (the two k16 chunks of a 32-channel unit) of the warp's
// output row at tap (ky, kx), read from the unit's f32 window and rounded
// to bf16 (round to nearest even, the plain version's cast). Fragment row
// g is output column `col` = f32_col(g) (and col + 8); lane q of a quad
// holds channels 4q..4q+3 of each k16 chunk as the fragment's columns 2q,
// 2q + 1 (registers 0, 1) and 2q + 8, 2q + 9 (registers 2, 3), the order
// the kernel stores the weight rows in, so each pair of registers comes
// from one 16-byte load.
template <int S>
__device__ __forceinline__ void f32_a_load(uint32_t (&a)[2][4], uint32_t win, int win_w, int row,
                                           int col, int q, int ky, int kx) {
  const int p0 = (row * S + ky) * win_w + S * col + kx;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int p = p0 + 8 * S * hr;
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      const float4 v = ld_shared_f4(win + p * 128 + (((4 * kc + q) ^ (p & 7)) << 4));
      a[kc][hr] = pack_bf16x2(v.x, v.y);
      a[kc][2 + hr] = pack_bf16x2(v.z, v.w);
    }
  }
}

// The activated accumulators into the warpgroup's output tile: two boxes of
// 4 rows x 16 pixels x 32 channels (channel halves h), each pixel's 128
// bytes in the 128-byte swizzle that the TMA store undoes. Lane q writes
// channels 8j + 2q, 2q + 1 of each half as one 8-byte word.
template <int ACT>
__device__ __forceinline__ void f32_epilogue(const float (&acc)[2][4][4], uint32_t stg, int row,
                                             int col, int q) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int px = row * CONV_TW + col + 8 * hr;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        st_shared_f2(stg + h * F32_OUT_BOX + px * 128 + (((2 * j + (q >> 1)) ^ (px & 7)) << 4) +
                         (q & 1) * 8,
                     act_of<ACT>(acc[h][j][2 * hr]), act_of<ACT>(acc[h][j][2 * hr + 1]));
    }
}

// The f32 contract. Threads 0-255 are two consumer warpgroups, each walking
// every other tile of the block (4 rows x 16 pixels x the block's 64
// channels); thread 256 keeps the ring of window units full for both, in
// the order the tiles are taken, one unit per slice of C_in, unit u in slot
// u % slots. Each slot has an empty barrier, which one arrival from each
// warp of the unit's warpgroup completes, and a full barrier per
// warpgroup, which the unit's TMA bytes complete: a warpgroup waits only on
// its own units' barriers, each phase in turn, so its parity can never
// name a phase of the other warpgroup's units (a slot's units alternate
// between the two in no fixed pattern).
template <int S>
__global__ void __launch_bounds__(F32_THREADS, 1)
conv3x3_f32_kernel(const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
                   F32Geom g, int act, const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap o_map) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw_s = smem_addr(smem_raw);
  const uint32_t w_s = (raw_s + SMEM_ALIGN - 1) & ~(uint32_t)(SMEM_ALIGN - 1);
  const uint32_t o_s = w_s + 9 * g.C_in * CONV_BN * 2;  // the warpgroups' output tiles
  const uint32_t ring = o_s + 2 * F32_OUT;
  // full barriers [warpgroup][slot], then empty barriers [slot]
  const uint32_t full = ring + g.slots * g.slot_bytes, empty = full + 16 * F32_MAX_SLOTS;
  const int tid = threadIdx.x;
  const int n0 = (blockIdx.x % g.n_ctiles) * CONV_BN;
  const int t0 = blockIdx.x / g.n_ctiles, step = gridDim.x / g.n_ctiles;
  if (tid == 0) {
    for (int s = 0; s < g.slots; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(full + 8 * (F32_MAX_SLOTS + s), 1);
      mbar_init(empty + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {  // the producer warp
    if (tid == 256) {
      uint32_t u = 0;  // units issued (ring position)
      for (int t = t0; t < g.n_spatial; t += step) {
        const int tx = t % g.tiles_x, rest = t / g.tiles_x;
        const int ty = rest % g.tiles_y, n = rest / g.tiles_y;
        // the block's i-th tile goes to warpgroup i & 1
        const uint32_t bars = full + 8 * F32_MAX_SLOTS * (((t - t0) / step) & 1);
        for (int sl = 0; sl < g.ns; ++sl, ++u) {
          const uint32_t slot = u % g.slots;
          mbar_wait(empty + 8 * slot, ((u / g.slots) & 1) ^ 1);
          mbar_expect_tx(bars + 8 * slot, g.win_h * g.win_w * F32_SLICE * 4);
          tma_load_4d(ring + slot * g.slot_bytes, &x_map, sl * F32_SLICE,
                      tx * CONV_TW * S - 1, ty * CONV_TH * S - 1, n, bars + 8 * slot);
        }
      }
    }
    return;
  }

  const int grp = tid >> 7, wt = tid & 127, row = wt >> 5, lane = tid & 31;
  const int q = lane & 3, col = f32_col<S>(lane >> 2);
  // The block's (9*C_in, 64) weight slice as the bf16 kernel stores it, but
  // with each k16 chunk's rows in the order the A fragments take their
  // channels: row 16c + k holds channel 16c + 4((k & 7) >> 1) + 2(k >> 3)
  // + (k & 1).
  for (int e = tid; e < 9 * g.C_in * 8; e += 256) {
    const int k = e >> 3, c = e & 7, kl = k & 15;
    const int src = (k & ~15) | (((kl & 7) >> 1) << 2) | ((kl >> 3) << 1) | (kl & 1);
    const int n = n0 + c * 8;
    const bool ok = n < g.C_out;
    cp_async16(w_s + k * 128 + ((c ^ (k & 7)) << 4), ok ? w + ((size_t)src * g.C_out + n) : w,
               ok);
  }
  cp_async_commit();
  float bv[2][4][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + h * 32 + nj * 8 + 2 * q + e;
        bv[h][nj][e] = n < g.C_out ? bias[n] : 0.0f;
      }
  // every consumer's weights have landed and are visible to the tensor
  // cores' reads (named barrier 3: the two warpgroups, not the producer)
  cp_async_wait<0>();
  fence_proxy_async();
  asm volatile("bar.sync 3, 256;\n" ::: "memory");

  const uint32_t stg = o_s + grp * F32_OUT;
  const uint32_t bars = full + 8 * F32_MAX_SLOTS * grp;  // this warpgroup's full barriers
  uint32_t phases = 0;  // bit s: the parity of slot s's next completion for this warpgroup
  // the warpgroup takes the block's tiles grp, grp + 2, ...: tile i's units
  // are i * ns .. i * ns + ns - 1 of the producer's sequence
  uint32_t u0 = grp * g.ns;
  for (int t = t0 + grp * step; t < g.n_spatial; t += 2 * step, u0 += 2 * g.ns) {
    float acc[2][4][4];  // starts at the bias: element e is channel 2q + (e & 1)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][nj][e] = bv[h][nj][e & 1];
    for (int sl = 0; sl < g.ns; ++sl) {
      const uint32_t slot = (u0 + sl) % g.slots;
      mbar_wait(bars + 8 * slot, (phases >> slot) & 1);
      phases ^= 1u << slot;
      const uint32_t win = ring + slot * g.slot_bytes;
      // one commit group per tap; the next tap's A loads into the other
      // register set while this tap's products run
      uint32_t a[2][2][4];
      f32_a_load<S>(a[0], win, g.win_w, row, col, q, 0, 0);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        wgmma_fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 2; ++kc)
          wgmma_m64n64k16(acc, a[tap & 1][kc],
                          b_desc(w_s + (tap * g.C_in + sl * F32_SLICE + kc * 16) * 128));
        wgmma_commit();
        if (tap < 8) {
          wgmma_wait<1>();
          f32_a_load<S>(a[(tap + 1) & 1], win, g.win_w, row, col, q, (tap + 1) / 3,
                        (tap + 1) % 3);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * slot);  // the warp is done reading the unit
      wgmma_wait<0>();  // the next unit's first A loads into set 0
      wgmma_fence_operands(acc);
    }

    const int tx = t % g.tiles_x, rest = t / g.tiles_x;
    const int ty = rest % g.tiles_y, n = rest / g.tiles_y;
    if (wt == 0) bulk_wait_read();  // the previous tile's stores have read stg
    group_sync<128>(grp);
    switch (act) {
      case ACT_MISH: f32_epilogue<ACT_MISH>(acc, stg, row, col, q); break;
      case ACT_LEAKY: f32_epilogue<ACT_LEAKY>(acc, stg, row, col, q); break;
      case ACT_RELU: f32_epilogue<ACT_RELU>(acc, stg, row, col, q); break;
      default: f32_epilogue<ACT_LINEAR>(acc, stg, row, col, q); break;
    }
    fence_proxy_async();
    group_sync<128>(grp);
    if (wt == 0) {
      tma_store_4d(&o_map, stg, n0, tx * CONV_TW, ty * CONV_TH, n);
      if (n0 + F32_SLICE < g.C_out)
        tma_store_4d(&o_map, stg + F32_OUT_BOX, n0 + F32_SLICE, tx * CONV_TW, ty * CONV_TH, n);
      bulk_commit();
    }
  }
  if (wt == 0) bulk_wait();  // the output tiles leave before the block does
}

size_t f32_smem_bytes(const F32Geom& g, int slots) {
  return SMEM_ALIGN + (size_t)9 * g.C_in * CONV_BN * 2 + 2 * F32_OUT +
         (size_t)slots * g.slot_bytes + 24 * F32_MAX_SLOTS;
}

// Fill in the f32 launch geometry: one block per SM, the ring as many
// units as fit beside the weights and output tiles, up to F32_MAX_SLOTS;
// false if not one fits.
bool f32_geometry(F32Geom& g, int B, int H, int W, int C_in, int C_out, int S) {
  g.C_in = C_in, g.C_out = C_out, g.Ho = H / S, g.Wo = W / S;
  g.win_h = (CONV_TH - 1) * S + 3;
  g.win_w = (CONV_TW - 1) * S + 3;
  g.slot_bytes = (g.win_h * g.win_w * F32_SLICE * 4 + SMEM_ALIGN - 1) / SMEM_ALIGN * SMEM_ALIGN;
  g.ns = C_in / F32_SLICE;
  g.tiles_x = (g.Wo + CONV_TW - 1) / CONV_TW;
  g.tiles_y = (g.Ho + CONV_TH - 1) / CONV_TH;
  g.n_spatial = B * g.tiles_y * g.tiles_x;
  g.n_ctiles = (C_out + CONV_BN - 1) / CONV_BN;
  const long long room =
      (long long)(SM_SMEM - BLOCK_SMEM_RESERVED) - (long long)f32_smem_bytes(g, 0);
  const long long fit = room / g.slot_bytes;
  g.slots = fit < F32_MAX_SLOTS ? (int)fit : F32_MAX_SLOTS;
  return g.slots >= 1;
}

// The f32 tensor maps: x (B, H, W, C_in) read in boxes of 32 channels x a
// window's pixels x its rows, out-of-bounds elements read as zero; out (B,
// Ho, Wo, C_out) written in boxes of 32 channels x 16 pixels x 4 rows; both
// in the 128-byte swizzle (a box row is one pixel's 128 bytes).
bool f32_tensor_maps(CUtensorMap* x_map, CUtensorMap* o_map, const float* x, float* out,
                     const F32Geom& g, int B, int H, int W) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const cuuint64_t x_dims[4] = {(cuuint64_t)g.C_in, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t x_strides[3] = {(cuuint64_t)g.C_in * 4, (cuuint64_t)W * g.C_in * 4,
                                   (cuuint64_t)H * W * g.C_in * 4};
  const cuuint32_t x_box[4] = {F32_SLICE, (cuuint32_t)g.win_w, (cuuint32_t)g.win_h, 1};
  const cuuint64_t o_dims[4] = {(cuuint64_t)g.C_out, (cuuint64_t)g.Wo, (cuuint64_t)g.Ho,
                                (cuuint64_t)B};
  const cuuint64_t o_strides[3] = {(cuuint64_t)g.C_out * 4, (cuuint64_t)g.Wo * g.C_out * 4,
                                   (cuuint64_t)g.Ho * g.Wo * g.C_out * 4};
  const cuuint32_t o_box[4] = {F32_SLICE, CONV_TW, CONV_TH, 1};
  return encode(x_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(x), x_dims,
                x_strides, x_box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         encode(o_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, o_dims, o_strides, o_box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

#if CYV4_HAS_PART(3)
template <int S>
cudaError_t launch_conv_f32(const float* x, const __nv_bfloat16* w, const float* bias, float* out,
                            const F32Geom& g, int B, int H, int W, int act,
                            cudaStream_t stream) {
  CUtensorMap x_map{}, o_map{};
  if (!f32_tensor_maps(&x_map, &o_map, x, out, g, B, H, W)) return cudaErrorInvalidValue;
  const size_t smem = f32_smem_bytes(g, g.slots);
  cudaError_t e = cudaFuncSetAttribute(conv3x3_f32_kernel<S>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  unsigned grid = 0;
  e = persistent_grid(conv3x3_f32_kernel<S>, F32_THREADS, smem,
                      (long long)(g.n_spatial + 1) / 2 * g.n_ctiles, g.n_ctiles, &grid);
  if (e != cudaSuccess) return e;
  conv3x3_f32_kernel<S><<<grid, F32_THREADS, smem, stream>>>(w, bias, g, act, x_map, o_map);
  return cudaGetLastError();
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
// to bf16 for the products; w and bias as above; out (B, H/stride,
// W/stride, C_out) f32 (the bias and activation in f32, not rounded).
#if CYV4_HAS_PART(3)
int cyv4_conv3x3_f32(const void* x, const void* w, const void* bias, void* out, int B,
                     int H, int W, int C_in, int C_out, int stride, int act, void* stream) {
  if ((stride != 1 && stride != 2) || (C_in != 32 && C_in != 64 && C_in != 128) ||
      C_out % 8 != 0 || C_out < 8)
    return (int)cudaErrorInvalidValue;
  F32Geom g;
  if (!f32_geometry(g, B, H, W, C_in, C_out, stride)) return (int)cudaErrorInvalidValue;
  if (g.n_spatial < 1) return (int)cudaSuccess;
  const float* xp = static_cast<const float*>(x);
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(w);
  const float* bp = static_cast<const float*>(bias);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(stride == 1 ? launch_conv_f32<1>(xp, wp, bp, op, g, B, H, W, act, s)
                           : launch_conv_f32<2>(xp, wp, bp, op, g, B, H, W, act, s));
}
#endif

}  // extern "C"
