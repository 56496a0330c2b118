// Rotated NMS with confidence-weighted merging for Hopper (sm_90a): the
// whole of `ops/nms.py` nms_batch_plain for a batch, in two launches, with
// no host read.
//
// Replaces no TPU kernel: the JAX package's NMS (complex_yolov4_tpu/ops/
// nms.py nms_batch) is XLA, not Pallas. It was added because the eager
// version dispatches about 250 small ops a call and reads the host once a
// fixpoint round, so the card idles through the NMS of every request while
// the host launches kernels of a few microseconds each. Built with the
// other kernels by ops/_build.py (nvcc, plain C interface, ctypes);
// launches on the stream it is given, allocates nothing, returns
// cudaGetLastError() of each launch.
//
// Function (the plain version's contract, row for row):
//   1. score = conf * max(cls) where conf >= conf_thresh, else no
//      candidate; cls_id the argmax, the first class winning ties; the k =
//      min(max_boxes, N) best scores in descending order (a tie goes to the
//      lower row). Candidate rows [x, y, w, l, im, re, conf, cls_conf, cls_id].
//   2. suppress[i][j]: rotated IoU > nms_thresh and the same class; the IoU
//      once per pair i < j with i's box first, the diagonal 1.0. The IoU
//      repeats rotated_boxes.rotated_iou's f32 arithmetic op for op (yaw =
//      atan2(im, re), corners, the inside tests with their EPS * scale
//      tolerance, the 16 edge crossings with the EPS-clamped denominator,
//      the centroid, the angle ranks with the index tie-break, the masked
//      shoelace): every product that feeds a sum is `mul`, which nvcc never
//      fuses into an FMA, so each op rounds as PyTorch's separate ops do.
//      Sums (centroid,
//      shoelace, merge) run in index order, which PyTorch's reductions need
//      not: they may differ by an ulp, and a pair whose IoU lies within
//      about 1e-6 of nms_thresh may decide the other way.
//   3. keep i iff no kept j < i suppresses it: the set the plain version's
//      fixpoint rounds reach, here one sequential greedy pass.
//   4. each valid j is absorbed by the lowest-ranked keeper suppressing it;
//      a keeper's columns 0-5 become sum(conf_j * box_j) / max(sum(conf_j),
//      1e-16) over its group, in f32; columns 6-8 stay its own.
//   Rows keep their rank; dead rows and rows k..max_boxes-1 are zero; the
//   mask is 1.0 for kept rows.
//
// What bounds it: latency. The bytes are one read of the decoded heads
// (16 x 22,743 x 10 f32 on the serving path, 14.6 MB: 4.3 us at 3.35 TB/s);
// the IoU of k = 64 candidates is at most 2,016 pairs a frame, and the
// greedy pass is sequential in rank order.
//
// What the design does:
//   launch 1 (grid chunks x B, 512 threads): a block scores 2,048 rows of
//     one frame (coalesced row reads), keys each candidate as (ordered score
//     bits << 32 | ~row) in shared memory, sorts the 2,048 keys by a bitonic
//     network (skipped when no row of the chunk is a candidate) and writes
//     its k best, descending, to the scratch list (B, chunks, k);
//   launch 2 (grid B, 256 threads): a block takes one frame. A key's rank in
//     the frame is its place in its own list plus, by binary search, the
//     keys above it in each other list, so the k best land in rank order
//     with no sort. The block gathers those rows and builds corners once
//     per candidate. A pair of other classes cannot suppress, nor (with
//     nms_thresh >= 0) a pair whose polygon has no live vertex (its IoU is
//     exactly 0): a first pass over the pairs runs only the inside and
//     crossing tests and lists the others in shared memory, so that the
//     angles, ranks and shoelace run on those alone, spread over the block's
//     threads; each IoU over the threshold sets two bits of a k x k bitmask.
//     One warp walks the bitmask in rank order (lane w holds the kept bits
//     of candidates 32w..32w+31, one vote a candidate); then a thread per
//     candidate finds its absorber, and a thread per keeper sums its group
//     and writes its row.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

// the capacity, stated here alone (cyv4_nms_limits hands it to ops/nms.py)
constexpr int MAX_K = 256;          // candidates a frame
constexpr int MAX_W = MAX_K / 32;   // 32-bit words of a bitmask row
constexpr int CHUNK = 2048;         // rows a launch-1 block ranks
constexpr int MAX_LIST = 16384;     // chunks x k keys launch 2 holds
constexpr int TOPK_THREADS = 512;
constexpr int FRAME_THREADS = 256;
constexpr int PAIR_CAP = 4096;      // pairs one filter round can keep
constexpr int MAX_DEVICES = 64;
constexpr float EPS = 1e-6f;        // rotated_boxes._EPS
constexpr float BIG = 1e9f;         // rotated_boxes._BIG

typedef unsigned long long Key;

// a * b rounded on its own: never fused into a following add (PyTorch's
// separate f32 ops round each product)
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// f32 -> u32 with the same order (negative numbers reversed)
__device__ __forceinline__ uint32_t ordered(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// descending keys order by score, then by the lower row; 0 is no candidate
__device__ __forceinline__ Key make_key(float score, int row) {
  return ((Key)ordered(score) << 32) | (Key)(0xFFFFFFFFu - (uint32_t)row);
}

__device__ __forceinline__ int key_row(Key key) {
  return (int)(0xFFFFFFFFu - (uint32_t)(key & 0xFFFFFFFFull));
}

// max and argmax of the class columns, the first class winning ties
__device__ __forceinline__ void best_class(const float* row, int n_cls, float* conf, int* id) {
  float best = row[7];
  int at = 0;
  for (int c = 1; c < n_cls; ++c) {
    const float v = row[7 + c];
    if (v > best) {
      best = v;
      at = c;
    }
  }
  *conf = best;
  *id = at;
}

__global__ void __launch_bounds__(TOPK_THREADS)
nms_topk_kernel(const float* __restrict__ dec, int N, int D, float conf_thresh, int k,
                Key* __restrict__ lists) {
  __shared__ Key keys[CHUNK];
  const int s = blockIdx.x, b = blockIdx.y, chunks = gridDim.x;
  const float* frame = dec + (size_t)b * N * D;
  int live = 0;
  for (int t = threadIdx.x; t < CHUNK; t += TOPK_THREADS) {
    const int r = s * CHUNK + t;
    Key key = 0;
    if (r < N) {
      const float* row = frame + (size_t)r * D;
      const float conf = row[6];
      if (conf >= conf_thresh) {
        float cls_conf;
        int cls_id;
        best_class(row, D - 7, &cls_conf, &cls_id);
        key = make_key(conf * cls_conf, r);
      }
    }
    keys[t] = key;
    live |= key != 0;
  }
  Key* out = lists + ((size_t)b * chunks + s) * k;
  if (!__syncthreads_or(live)) {
    for (int t = threadIdx.x; t < k; t += TOPK_THREADS) out[t] = 0;
    return;
  }
  for (int size = 2; size <= CHUNK; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < CHUNK / 2; t += TOPK_THREADS) {
        const int i = 2 * t - (t & (stride - 1)), j = i + stride;
        const Key a = keys[i], c = keys[j];
        if ((i & size) == 0 ? a < c : a > c) {
          keys[i] = c;
          keys[j] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < k; t += TOPK_THREADS) out[t] = keys[t];
}

// Byte offsets into launch 2's dynamic shared memory.
struct FrameSmem {
  int keys, sel, cand, cx, cy, geo, mask, absorber, bytes;
  __host__ __device__ FrameSmem(int chunks, int k) {
    const int w = (k + 31) / 32;
    const int list = chunks * k * (int)sizeof(Key);
    const int pairs = PAIR_CAP * (int)sizeof(uint32_t);
    keys = 0;  // the pair list reuses it once the candidates are chosen
    sel = keys + (list > pairs ? list : pairs);
    cand = sel + k * 4;      // k x 9 candidate rows
    cx = cand + k * 9 * 4;   // k x 4 corners
    cy = cx + k * 4 * 4;
    geo = cy + k * 4 * 4;    // k x [max |cx|, max |cy|]
    mask = geo + k * 2 * 4;  // k x w suppression bits
    absorber = mask + k * w * 4;
    bytes = absorber + k * 4;
  }
};

// rotated_boxes._inside_convex for one point: inside-or-on the CCW quad q
__device__ __forceinline__ bool inside(float x, float y, const float* qx, const float* qy,
                                       float tol) {
  bool in = true;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int f = (e + 1) & 3;
    const float ex = qx[f] - qx[e], ey = qy[f] - qy[e];
    const float rx = x - qx[e], ry = y - qy[e];
    in &= mul(ex, ry) - mul(ey, rx) >= tol;
  }
  return in;
}

// The 24 candidate vertices of the intersection polygon of CCW quads A and
// B (rotated_boxes._intersection_area_xy: A's corners, B's corners, the 16
// edge crossings, A edge major) and the mask of the live ones.
__device__ __forceinline__ uint32_t polygon_points(const float* ax, const float* ay,
                                                   const float* bx, const float* by, float scale,
                                                   float* px, float* py) {
  uint32_t valid = 0;
  const float tol = -EPS * scale;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    px[v] = ax[v];
    py[v] = ay[v];
    px[4 + v] = bx[v];
    py[4 + v] = by[v];
    valid |= (uint32_t)inside(ax[v], ay[v], bx, by, tol) << v;
    valid |= (uint32_t)inside(bx[v], by[v], ax, ay, tol) << (4 + v);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i1 = (i + 1) & 3, j1 = (j + 1) & 3;
      const float d1x = ax[i1] - ax[i], d1y = ay[i1] - ay[i];
      const float d2x = bx[j1] - bx[j], d2y = by[j1] - by[j];
      const float p13x = bx[j] - ax[i], p13y = by[j] - ay[i];
      const float denom = mul(d1x, d2y) - mul(d1y, d2x);
      const float safe = fabsf(denom) < EPS ? EPS : denom;
      const float t = (mul(p13x, d2y) - mul(p13y, d2x)) / safe;
      const float u = (mul(p13x, d1y) - mul(p13y, d1x)) / safe;
      const bool ok = fabsf(denom) >= EPS && t >= 0.f && t <= 1.f && u >= 0.f && u <= 1.f;
      px[8 + i * 4 + j] = ax[i] + mul(t, d1x);
      py[8 + i * 4 + j] = ay[i] + mul(t, d1y);
      valid |= (uint32_t)ok << (8 + i * 4 + j);
    }
  }
  return valid;
}

// rotated_boxes.rotated_iou of box A (corners ax, ay; area w * l area_a)
// and box B, in its f32 order of operations.
__device__ float rotated_iou(const float* ax, const float* ay, const float* bx, const float* by,
                             float scale, float area_a, float area_b) {
  float px[24], py[24];
  const uint32_t valid = polygon_points(ax, ay, bx, by, scale, px, py);
  const int cnt = __popc(valid);
  float sx = 0.f, sy = 0.f;
#pragma unroll
  for (int v = 0; v < 24; ++v) {
    if (valid >> v & 1u) {
      sx = sx + px[v];
      sy = sy + py[v];
    }
  }
  const float denom_c = cnt > 1 ? (float)cnt : 1.f;
  const float cx0 = sx / denom_c, cy0 = sy / denom_c;
  float key[24];
#pragma unroll
  for (int v = 0; v < 24; ++v)
    key[v] = (valid >> v & 1u) ? atan2f(py[v] - cy0, px[v] - cx0) : BIG;
  int rank[24];
#pragma unroll
  for (int v = 0; v < 24; ++v) {
    int r = 0;
#pragma unroll
    for (int w = 0; w < 24; ++w) r += key[w] < key[v] || (key[w] == key[v] && w < v);
    rank[v] = r;
  }
  // the shoelace over the live points in rank order, the last closing on
  // the first
  float area2 = 0.f;
  if (cnt > 0) {
    float fx = 0.f, fy = 0.f;
#pragma unroll
    for (int v = 0; v < 24; ++v) {
      if (rank[v] == 0) {
        fx = px[v];
        fy = py[v];
      }
    }
    float cx = fx, cy = fy;
    for (int r = 0; r < cnt; ++r) {
      float nx = fx, ny = fy;
      if (r + 1 < cnt) {
#pragma unroll
        for (int v = 0; v < 24; ++v) {
          if (rank[v] == r + 1) {
            nx = px[v];
            ny = py[v];
          }
        }
      }
      area2 = area2 + (mul(cx, ny) - mul(nx, cy));
      cx = nx;
      cy = ny;
    }
  }
  const float inter = mul(0.5f, fabsf(area2));
  const float union_ = (area_a + area_b) - inter;
  return inter / (union_ > EPS ? union_ : EPS);
}

// _intersection_area_xy's scale: the sum of the four corner extents, plus 1
__device__ __forceinline__ float pair_scale(const float* geo, int i, int j) {
  return (((geo[i * 2] + geo[i * 2 + 1]) + geo[j * 2]) + geo[j * 2 + 1]) + 1.f;
}

__global__ void __launch_bounds__(FRAME_THREADS)
nms_frame_kernel(const float* __restrict__ dec, const Key* __restrict__ lists, int N, int D,
                 int chunks, int k, int max_boxes, float nms_thresh, float* __restrict__ out,
                 float* __restrict__ out_mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FrameSmem L(chunks, k);
  Key* keys = reinterpret_cast<Key*>(smem + L.keys);
  uint32_t* pairs = reinterpret_cast<uint32_t*>(smem + L.keys);
  int* sel = reinterpret_cast<int*>(smem + L.sel);
  float* cand = reinterpret_cast<float*>(smem + L.cand);
  float* cxs = reinterpret_cast<float*>(smem + L.cx);
  float* cys = reinterpret_cast<float*>(smem + L.cy);
  float* geo = reinterpret_cast<float*>(smem + L.geo);
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + L.mask);
  int* absorber = reinterpret_cast<int*>(smem + L.absorber);
  __shared__ int n_live, n_pairs;
  __shared__ uint32_t kept[MAX_W];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int W = (k + 31) / 32, n_keys = chunks * k;

  // 1. the frame's k best keys, each at its rank
  if (tid == 0) n_live = n_pairs = 0;
  __syncthreads();
  const Key* src = lists + (size_t)b * n_keys;
  int live = 0;
  for (int e = tid; e < n_keys; e += FRAME_THREADS) {
    const Key key = src[e];
    keys[e] = key;
    live += key != 0;
  }
  for (int e = tid; e < k * W; e += FRAME_THREADS) mask[e] = 0u;
  if (live) atomicAdd(&n_live, live);
  __syncthreads();
  for (int e = tid; e < n_keys; e += FRAME_THREADS) {
    const Key key = keys[e];
    if (!key) continue;
    const int s = e / k;
    int rank = e - s * k;
    for (int o = 0; o < chunks && rank < k; ++o) {
      if (o == s) continue;
      const Key* list = keys + o * k;
      int lo = 0, hi = k;  // the keys of list o above this one: a prefix
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (list[mid] > key)
          lo = mid + 1;
        else
          hi = mid;
      }
      rank += lo;
    }
    if (rank < k) sel[rank] = key_row(key);
  }
  __syncthreads();
  const int nv = n_live < k ? n_live : k;

  // 2. the candidates' rows, corners (rotated_boxes.box_corners) and extents
  for (int r = tid; r < nv; r += FRAME_THREADS) {
    const float* row = dec + ((size_t)b * N + sel[r]) * D;
    float* c = cand + r * 9;
#pragma unroll
    for (int q = 0; q < 7; ++q) c[q] = row[q];
    float cls_conf;
    int cls_id;
    best_class(row, D - 7, &cls_conf, &cls_id);
    c[7] = cls_conf;
    c[8] = (float)cls_id;
    const float yaw = atan2f(c[4], c[5]);
    const float co = cosf(yaw), si = sinf(yaw);
    const float hw = c[2] * 0.5f, hl = c[3] * 0.5f;
    float mx = 0.f, my = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float sw = q < 2 ? -1.f : 1.f, sl = (q == 0 || q == 3) ? 1.f : -1.f;
      const float x = (c[0] + mul(sw * hw, co)) - mul(sl * hl, si);
      const float y = (c[1] + mul(sw * hw, si)) + mul(sl * hl, co);
      cxs[r * 4 + q] = x;
      cys[r * 4 + q] = y;
      mx = fmaxf(mx, fabsf(x));
      my = fmaxf(my, fabsf(y));
    }
    geo[r * 2] = mx;
    geo[r * 2 + 1] = my;
  }
  __syncthreads();

  // 3. the suppression bitmask, a round of PAIR_CAP squares (i, j) at a
  // time: the pairs (i < j) of one class whose polygon has a live vertex go
  // to the list (a pair with none has an IoU of exactly 0, which suppresses
  // nothing when nms_thresh >= 0), then the block computes their IoU
  const int square = nv * nv;
  const bool zero_is_out = nms_thresh >= 0.f;
  for (int q0 = 0; q0 < square; q0 += PAIR_CAP) {
    const int q1 = square - q0 < PAIR_CAP ? square : q0 + PAIR_CAP;
    for (int q = q0 + tid; q < q1; q += FRAME_THREADS) {
      const int i = q / nv, j = q - i * nv;
      if (j <= i || cand[i * 9 + 8] != cand[j * 9 + 8]) continue;
      if (zero_is_out) {
        float px[24], py[24];
        if (!polygon_points(cxs + i * 4, cys + i * 4, cxs + j * 4, cys + j * 4,
                            pair_scale(geo, i, j), px, py))
          continue;
      }
      pairs[atomicAdd(&n_pairs, 1)] = (uint32_t)i << 16 | (uint32_t)j;
    }
    __syncthreads();
    const int np = n_pairs;
    for (int e = tid; e < np; e += FRAME_THREADS) {
      const int i = (int)(pairs[e] >> 16), j = (int)(pairs[e] & 0xFFFFu);
      const float iou = rotated_iou(cxs + i * 4, cys + i * 4, cxs + j * 4, cys + j * 4,
                                    pair_scale(geo, i, j), mul(cand[i * 9 + 2], cand[i * 9 + 3]),
                                    mul(cand[j * 9 + 2], cand[j * 9 + 3]));
      if (iou > nms_thresh) {
        atomicOr(&mask[i * W + (j >> 5)], 1u << (j & 31));
        atomicOr(&mask[j * W + (i >> 5)], 1u << (i & 31));
      }
    }
    __syncthreads();
    if (tid == 0) n_pairs = 0;
    __syncthreads();
  }

  // 4. the greedy pass in rank order: keep i iff no kept j < i suppresses it
  if (tid < 32) {
    uint32_t mine = 0;  // lane w: the kept bits of candidates 32w..32w+31
    for (int i = 0; i < nv; ++i) {
      const uint32_t hit = tid < W ? mask[i * W + tid] & mine : 0u;
      if (!__any_sync(0xFFFFFFFFu, hit != 0u) && tid == (i >> 5)) mine |= 1u << (i & 31);
    }
    if (tid < MAX_W) kept[tid] = tid < W ? mine : 0u;
  }
  __syncthreads();

  // 5. each candidate's absorber: the lowest-ranked keeper suppressing it
  const bool diag = 1.0f > nms_thresh;  // the diagonal's IoU is 1.0
  for (int j = tid; j < nv; j += FRAME_THREADS) {
    int at = -1;
    for (int w = 0; w < W && at < 0; ++w) {
      uint32_t m = mask[j * W + w];
      if (diag && (j >> 5) == w) m |= 1u << (j & 31);
      m &= kept[w];
      if (m) at = w * 32 + __ffs(m) - 1;
    }
    absorber[j] = at;
  }
  __syncthreads();

  // 6. the rows: a keeper's box is its group's conf-weighted mean
  for (int r = tid; r < max_boxes; r += FRAME_THREADS) {
    float* o = out + ((size_t)b * max_boxes + r) * 9;
    const bool keep = r < nv && (kept[r >> 5] >> (r & 31) & 1u);
    if (!keep) {
#pragma unroll
      for (int q = 0; q < 9; ++q) o[q] = 0.f;
      out_mask[(size_t)b * max_boxes + r] = 0.f;
      continue;
    }
    float wsum = 0.f, acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int w = 0; w < W; ++w) {
      uint32_t m = mask[r * W + w];
      if ((r >> 5) == w) m |= 1u << (r & 31);
      while (m) {
        const int j = w * 32 + __ffs(m) - 1;
        m &= m - 1;
        if (absorber[j] != r) continue;
        const float cj = cand[j * 9 + 6];
        wsum = wsum + cj;
#pragma unroll
        for (int q = 0; q < 6; ++q) acc[q] = acc[q] + mul(cj, cand[j * 9 + q]);
      }
    }
    const float den = wsum > 1e-16f ? wsum : 1e-16f;
#pragma unroll
    for (int q = 0; q < 6; ++q) o[q] = acc[q] / den;
    o[6] = cand[r * 9 + 6];
    o[7] = cand[r * 9 + 7];
    o[8] = cand[r * 9 + 8];
    out_mask[(size_t)b * max_boxes + r] = 1.f;
  }
}

std::mutex host_mu;  // the per-device attribute state, shared by every caller

int run(const float* dec, Key* lists, float* out, float* out_mask, int B, int N, int D, int k,
        int max_boxes, float conf_thresh, float nms_thresh, cudaStream_t stream, int dev) {
  const int chunks = (N + CHUNK - 1) / CHUNK;
  if (B < 1 || N < 1 || D < 8 || k < 1 || k > MAX_K || k > N || max_boxes < k ||
      chunks * k > MAX_LIST)
    return (int)cudaErrorInvalidValue;
  const int smem = FrameSmem(chunks, k).bytes;
  static int attr_bytes[MAX_DEVICES] = {};  // the largest opt-in set on each device
  if (smem > attr_bytes[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_frame_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_bytes[dev] = smem;
  }
  nms_topk_kernel<<<dim3((unsigned)chunks, (unsigned)B), TOPK_THREADS, 0, stream>>>(
      dec, N, D, conf_thresh, k, lists);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  nms_frame_kernel<<<(unsigned)B, FRAME_THREADS, smem, stream>>>(
      dec, lists, N, D, chunks, k, max_boxes, nms_thresh, out, out_mask);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// limits[0..2] = the most candidates a frame (k), the rows of a chunk and
// the most keys (chunks x k) a frame
void cyv4_nms_limits(int* limits) {
  limits[0] = MAX_K;
  limits[1] = CHUNK;
  limits[2] = MAX_LIST;
}

// decoded (B, N, D) f32, D = 7 + classes; lists: (B, ceil(N / 2048), k)
// 8-byte scratch; out (B, max_boxes, 9) and out_mask (B, max_boxes) f32,
// every element written. k = min(max_boxes, N) <= 256.
int cyv4_nms(const void* decoded, void* lists, void* out, void* out_mask, int B, int N, int D,
             int k, int max_boxes, float conf_thresh, float nms_thresh, void* stream,
             int device) {
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const std::lock_guard<std::mutex> lock(host_mu);
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int code = run(static_cast<const float*>(decoded), static_cast<Key*>(lists),
                       static_cast<float*>(out), static_cast<float*>(out_mask), B, N, D, k,
                       max_boxes, conf_thresh, nms_thresh, static_cast<cudaStream_t>(stream),
                       device);
  if (prev != device) cudaSetDevice(prev);
  return code;
}

}  // extern "C"
