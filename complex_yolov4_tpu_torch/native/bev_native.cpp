// Native host-side BEV rasterizer + velodyne loader.
//
// The per-frame host hot path of the input pipeline (SURVEY.md §3.4:
// reference src/data_process/kitti_bev_utils.py:18-76 — boundary crop,
// z-shift, 609x609 grid scatter of max-height / top-intensity / log-density,
// crop to 608) fused into a single pass over the points, with a thread pool
// for batch assembly. Exposed through a tiny C ABI consumed via ctypes
// (complex_yolov4_tpu/native/__init__.py); results are bit-identical to the
// numpy implementation in data/bev.py (same float32 math, same max-z /
// max-intensity-on-tie semantics).
//
// Build: make (g++ -O3 -shared; see Makefile in this directory).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kBev = 608;
constexpr int kGrid = kBev + 1;        // raster grid before the final crop
constexpr float kMinX = 0.0f, kMaxX = 50.0f;
constexpr float kMinY = -25.0f, kMaxY = 25.0f;
constexpr float kMinZ = -2.73f, kMaxZ = 1.27f;
constexpr float kDisc = (kMaxX - kMinX) / kBev;
constexpr float kMaxHeight = kMaxZ - kMinZ;  // 4.0 m

// Stamped cell: `stamp` says which rasterization pass last touched the cell,
// so the 4.5 MB grid never needs clearing between frames (a cell whose stamp
// is stale reads as empty). One persistent grid per worker thread.
struct Cell {
  float height;    // max z (post-shift z >= 0)
  float intensity; // intensity of the top point (max on z ties)
  int32_t count;
  uint32_t stamp;
};

struct Grid {
  std::vector<Cell> cells;
  uint32_t stamp = 0;

  Cell* begin_pass() {
    if (cells.empty()) {
      cells.assign(static_cast<size_t>(kGrid) * kGrid, Cell{0.f, 0.f, 0, 0});
      stamp = 0;
    }
    ++stamp;
    if (stamp == 0) {  // wrapped: force-clear once every 2^32 passes
      std::fill(cells.begin(), cells.end(), Cell{0.f, 0.f, 0, 0});
      stamp = 1;
    }
    return cells.data();
  }
};

thread_local Grid tls_grid;
thread_local Grid tls_mosaic_grids[4];

// log64-density lookup: density saturates at count >= 63
// (min(1, log(c+1)/log 64)); double math for bit parity with numpy float64.
struct DensityTable {
  float v[64];
  DensityTable() {
    const double log64 = std::log(64.0);
    for (int c = 0; c < 64; ++c) {
      v[c] = static_cast<float>(std::min(1.0, std::log(c + 1.0) / log64));
    }
  }
};
const DensityTable kDensity;

// Crop + z-shift + scatter one frame's points into a stamped grid.
void scatter_points(const float* points, int64_t n, Cell* cells,
                    uint32_t stamp) {
  for (int64_t p = 0; p < n; ++p) {
    const float x = points[p * 4 + 0];
    const float y = points[p * 4 + 1];
    const float z0 = points[p * 4 + 2];
    const float r = points[p * 4 + 3];
    if (x < kMinX || x > kMaxX || y < kMinY || y > kMaxY || z0 < kMinZ ||
        z0 > kMaxZ) {
      continue;
    }
    const float z = z0 - kMinZ;
    // int(floor(y/d) + 609/2) truncates the .5 -> floor + 304 (python parity,
    // reference kitti_bev_utils.py:44).
    const int ix = static_cast<int>(std::floor(x / kDisc));
    const int iy = static_cast<int>(std::floor(y / kDisc) + kGrid / 2.0f);
    if (ix < 0 || ix >= kGrid || iy < 0 || iy >= kGrid) continue;
    Cell& c = cells[static_cast<size_t>(ix) * kGrid + iy];
    if (c.stamp != stamp) {
      c = Cell{-1.0f, 0.0f, 0, stamp};  // height -1 = "no point yet"
    }
    c.count += 1;
    if (z > c.height) {
      c.height = z;
      c.intensity = r;
    } else if (z == c.height) {
      c.intensity = std::max(c.intensity, r);
    }
  }
}

inline void cell_value(const Cell& c, uint32_t stamp, float* px) {
  if (c.stamp == stamp && c.count > 0) {
    px[0] = c.intensity;
    px[1] = c.height / kMaxHeight;
    px[2] = kDensity.v[std::min(c.count, 63)];
  } else {
    px[0] = px[1] = px[2] = 0.0f;
  }
}

// COO aggregation for the device scatter-set raster (data/bev.py
// aggregate_bev_cells): crop + z-shift + per-cell reduce, then emit one
// int32 packed key per OCCUPIED cell —
//   bits [31:14] round(height / 4 m * (2^18 - 1))
//   bits [13: 8] min(count, 63)
//   bits [ 7: 0] round(intensity * 255)
// Cells come out sorted (numpy flatnonzero order) for test bit-parity.
// Like scatter_points but records each first-touched cell id.
int64_t aggregate_cells(const float* points, int64_t n, int32_t* out_cells,
                        int32_t* out_keys) {
  Cell* cells = tls_grid.begin_pass();
  const uint32_t stamp = tls_grid.stamp;
  std::vector<int32_t>& touched = [] () -> std::vector<int32_t>& {
    thread_local std::vector<int32_t> v;
    return v;
  }();
  touched.clear();
  for (int64_t p = 0; p < n; ++p) {
    const float x = points[p * 4 + 0];
    const float y = points[p * 4 + 1];
    const float z0 = points[p * 4 + 2];
    const float r = points[p * 4 + 3];
    if (x < kMinX || x > kMaxX || y < kMinY || y > kMaxY || z0 < kMinZ ||
        z0 > kMaxZ) {
      continue;
    }
    const float z = z0 - kMinZ;
    const int ix = static_cast<int>(std::floor(x / kDisc));
    const int iy = static_cast<int>(std::floor(y / kDisc) + kGrid / 2.0f);
    if (ix < 0 || ix >= kGrid || iy < 0 || iy >= kGrid) continue;
    const int32_t id = static_cast<int32_t>(ix) * kGrid + iy;
    Cell& c = cells[id];
    if (c.stamp != stamp) {
      c = Cell{-1.0f, 0.0f, 0, stamp};
      touched.push_back(id);
    }
    c.count += 1;
    if (z > c.height) {
      c.height = z;
      c.intensity = r;
    } else if (z == c.height) {
      c.intensity = std::max(c.intensity, r);
    }
  }
  std::sort(touched.begin(), touched.end());
  constexpr double kHqMax = static_cast<double>((1 << 18) - 1);
  for (size_t i = 0; i < touched.size(); ++i) {
    const Cell& c = cells[touched[i]];
    // double math mirrors the numpy (float64) quantizers bit-for-bit.
    const double h = std::min(
        1.0, std::max(0.0, static_cast<double>(c.height) /
                               static_cast<double>(kMaxHeight)));
    const double r = std::min(
        1.0, std::max(0.0, static_cast<double>(c.intensity)));
    const uint32_t hq = static_cast<uint32_t>(std::nearbyint(h * kHqMax));
    const uint32_t cq = static_cast<uint32_t>(std::min(c.count, 63));
    const uint32_t rq = static_cast<uint32_t>(std::nearbyint(r * 255.0));
    out_cells[i] = touched[i];
    out_keys[i] = static_cast<int32_t>((hq << 14) | (cq << 8) | rq);
  }
  return static_cast<int64_t>(touched.size());
}

// One fused pass: crop + z-shift + scatter. out is HWC (608, 608, 3) with
// channels [top intensity, max height / 4 m, log64 density].
void rasterize(const float* points, int64_t n, float* out) {
  Cell* cells = tls_grid.begin_pass();
  const uint32_t stamp = tls_grid.stamp;
  scatter_points(points, n, cells, stamp);
  for (int ix = 0; ix < kBev; ++ix) {
    for (int iy = 0; iy < kBev; ++iy) {
      cell_value(cells[static_cast<size_t>(ix) * kGrid + iy], stamp,
                 out + (static_cast<size_t>(ix) * kBev + iy) * 3);
    }
  }
}

// ---- fused 4-frame mosaic -------------------------------------------------
//
// Replicates dataset.load_mosaic + the loader's cv2 2:1 INTER_LINEAR resize
// (reference: kitti_dataset.py:123-175) without materializing any
// intermediate image: the 4 sub-frames stay as stamped cell grids, and one
// output pass produces the final (608, 608, 3) canvas directly. A virtual
// 1216x1216 canvas pixel is evaluated on the fly — quadrant window lookup,
// horizontal flip as an index mirror, cutout holes as a coordinate test —
// and 2x2 blocks are averaged with cv2's exact float expression
// (rows interpolated horizontally first, then combined vertically).

struct Window {  // one sub-frame's placement on the 2S x 2S canvas
  int y1a, y2a, x1a, x2a;  // canvas window
  int y1b, x1b;            // top-left of the crop in sub-image coords
};

struct Hole {
  int y1, y2, x1, x2;
  float fill;
};

inline void fill_row(float* row, int cx0, int cx1, float v) {
  for (int cx = cx0; cx < cx1; ++cx) {
    row[cx * 3 + 0] = v;
    row[cx * 3 + 1] = v;
    row[cx * 3 + 2] = v;
  }
}

// Evaluate one virtual canvas row `cy` into row[(2*kBev)*3]. Equivalent to
// the per-pixel evaluation (quadrant lookup, window test, first-matching
// hole, flip mirror, cell read) but run-based: padding and holes become
// constant fills, and the visible window becomes one contiguous (or
// reversed, when flipped) walk over a sub-frame grid row — the per-pixel
// branching was ~60% of the whole mosaic cost.
void canvas_row(int cy, int yc, int xc, const Window* win, Cell* const* grids,
                const uint32_t* stamps, const uint8_t* flips,
                const Hole* holes, const int32_t* hole_off, float* row) {
  const int s2 = 2 * kBev;
  const int qbase = (cy < yc) ? 0 : 2;
  for (int side = 0; side < 2; ++side) {
    const int q = qbase + side;
    const Window& w = win[q];
    const int cx0 = side ? xc : 0;
    const int cx1 = side ? s2 : xc;
    if (cy < w.y1a || cy >= w.y2a) {  // whole quadrant row is padding
      fill_row(row, cx0, cx1, 0.5f);
      continue;
    }
    const int py = cy - w.y1a + w.y1b;  // sub-image row (= grid ix)
    fill_row(row, cx0, w.x1a, 0.5f);
    fill_row(row, w.x2a, cx1, 0.5f);
    // canvas cx -> sub-image px = cx - w.x1a + w.x1b (affine, pre-mirror;
    // hole rectangles live in px space, the flip only mirrors the grid read)
    const int px_off = w.x1b - w.x1a;
    const Cell* grow = grids[q] + static_cast<size_t>(py) * kGrid;
    const uint32_t stamp = stamps[q];
    const bool flip = flips[q] != 0;
    int cx = w.x1a;
    while (cx < w.x2a) {
      // Segment end: the next hole x-boundary (for holes covering this py)
      // after cx. Within a segment the first-matching hole is constant.
      int seg_end = w.x2a;
      const Hole* active = nullptr;
      const int px = cx + px_off;
      for (int h = hole_off[q]; h < hole_off[q + 1]; ++h) {
        const Hole& hole = holes[h];
        if (py < hole.y1 || py >= hole.y2) continue;
        if (active == nullptr && px >= hole.x1 && px < hole.x2) {
          active = &hole;  // first matching hole wins (list order)
        }
        if (hole.x1 - px_off > cx) seg_end = std::min(seg_end, hole.x1 - px_off);
        if (hole.x2 - px_off > cx) seg_end = std::min(seg_end, hole.x2 - px_off);
      }
      if (active != nullptr) {
        fill_row(row, cx, seg_end, active->fill);
      } else if (!flip) {
        const Cell* c = grow + px;
        for (int x = cx; x < seg_end; ++x, ++c) cell_value(*c, stamp, row + x * 3);
      } else {
        const Cell* c = grow + (kBev - 1 - px);
        for (int x = cx; x < seg_end; ++x, --c) cell_value(*c, stamp, row + x * 3);
      }
      cx = seg_end;
    }
  }
}

void mosaic(const float* points, const int64_t* npts, const uint8_t* flips,
            const float* holes_raw, const int32_t* hole_counts, int32_t yc,
            int32_t xc, float* out) {
  Cell* grids[4];
  uint32_t stamps[4];
  const float* p = points;
  for (int q = 0; q < 4; ++q) {
    grids[q] = tls_mosaic_grids[q].begin_pass();
    stamps[q] = tls_mosaic_grids[q].stamp;
    scatter_points(p, npts[q], grids[q], stamps[q]);
    p += npts[q] * 4;
  }

  // Placement windows (dataset.load_mosaic with w = h = s = kBev).
  const int s2 = 2 * kBev;
  Window win[4];
  // top left
  win[0] = {std::max(yc - kBev, 0), yc, std::max(xc - kBev, 0), xc, 0, 0};
  win[0].y1b = kBev - (win[0].y2a - win[0].y1a);
  win[0].x1b = kBev - (win[0].x2a - win[0].x1a);
  // top right
  win[1] = {std::max(yc - kBev, 0), yc, xc, std::min(xc + kBev, s2), 0, 0};
  win[1].y1b = kBev - (win[1].y2a - win[1].y1a);
  win[1].x1b = 0;
  // bottom left
  win[2] = {yc, std::min(s2, yc + kBev), std::max(xc - kBev, 0), xc, 0, 0};
  win[2].y1b = 0;
  win[2].x1b = kBev - (win[2].x2a - win[2].x1a);
  // bottom right
  win[3] = {yc, std::min(s2, yc + kBev), xc, std::min(xc + kBev, s2), 0, 0};
  win[3].y1b = 0;
  win[3].x1b = 0;

  int32_t hole_off[5] = {0, 0, 0, 0, 0};
  for (int q = 0; q < 4; ++q) hole_off[q + 1] = hole_off[q] + hole_counts[q];
  std::vector<Hole> holes(static_cast<size_t>(hole_off[4]));
  for (int h = 0; h < hole_off[4]; ++h) {
    const float* r = holes_raw + h * 5;
    holes[h] = {static_cast<int>(r[0]), static_cast<int>(r[1]),
                static_cast<int>(r[2]), static_cast<int>(r[3]), r[4]};
  }

  // Two virtual canvas rows per output row, then cv2 INTER_LINEAR at exact
  // 2:1: horizontal lerp (0.5/0.5) per row, then vertical lerp of the rows —
  // the float expression (and so the bits) matches numpy+cv2.
  std::vector<float> row_a(static_cast<size_t>(2 * kBev) * 3);
  std::vector<float> row_b(static_cast<size_t>(2 * kBev) * 3);
  for (int oy = 0; oy < kBev; ++oy) {
    canvas_row(2 * oy, yc, xc, win, grids, stamps, flips, holes.data(),
               hole_off, row_a.data());
    canvas_row(2 * oy + 1, yc, xc, win, grids, stamps, flips, holes.data(),
               hole_off, row_b.data());
    float* row_out = out + static_cast<size_t>(oy) * kBev * 3;
    for (int ox = 0; ox < kBev; ++ox) {
      const float* a0 = row_a.data() + (2 * ox) * 3;
      const float* a1 = a0 + 3;
      const float* b0 = row_b.data() + (2 * ox) * 3;
      const float* b1 = b0 + 3;
      float* px = row_out + ox * 3;
      for (int c = 0; c < 3; ++c) {
        px[c] = (a0[c] * 0.5f + a1[c] * 0.5f) * 0.5f +
                (b0[c] * 0.5f + b1[c] * 0.5f) * 0.5f;
      }
    }
  }
}

}  // namespace

extern "C" {

// Rasterize an in-memory (n, 4) float32 point array into out (608*608*3).
void cyv4_rasterize_points(const float* points, int64_t n, float* out) {
  rasterize(points, n, out);
}

// Read a KITTI velodyne .bin and rasterize. Returns the number of points
// read, or -1 when the file cannot be read.
int64_t cyv4_rasterize_file(const char* path, float* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  const long bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  const int64_t n = bytes / (4 * sizeof(float));
  std::vector<float> buf(static_cast<size_t>(n) * 4);
  const size_t got = std::fread(buf.data(), sizeof(float), buf.size(), f);
  std::fclose(f);
  if (got != buf.size()) return -1;
  rasterize(buf.data(), n, out);
  return n;
}

// Batch rasterization with a thread pool: `paths` is an array of `b` file
// paths; out is (b, 608, 608, 3). Returns the number of failed frames.
int32_t cyv4_rasterize_batch(const char** paths, int32_t b, float* out,
                             int32_t num_threads) {
  if (num_threads <= 0) {
    num_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
    if (num_threads <= 0) num_threads = 4;
  }
  num_threads = std::min(num_threads, b);
  std::atomic<int32_t> next{0};
  std::atomic<int32_t> failures{0};
  const size_t frame = static_cast<size_t>(kBev) * kBev * 3;

  auto worker = [&]() {
    for (;;) {
      const int32_t i = next.fetch_add(1);
      if (i >= b) return;
      if (cyv4_rasterize_file(paths[i], out + frame * i) < 0) {
        failures.fetch_add(1);
      }
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(num_threads);
  for (int32_t t = 0; t < num_threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return failures.load();
}

// Fused 4-frame mosaic: `points` is the concatenation of the 4 frames'
// (n_q, 4) float32 point arrays (post lidar-augmentation, uncropped);
// `flips[q]` marks horizontally-flipped sub-frames; `holes` is
// (sum hole_counts, 5) rows [y1, y2, x1, x2, fill] in sub-image coords.
// out is the FINAL resized (608, 608, 3) canvas.
void cyv4_mosaic(const float* points, const int64_t* npts,
                 const uint8_t* flips, const float* holes,
                 const int32_t* hole_counts, int32_t yc, int32_t xc,
                 float* out) {
  mosaic(points, npts, flips, holes, hole_counts, yc, xc, out);
}

// COO aggregation of one frame's raw points (crop inside): writes up to
// min(n, 609*609) (cell id, packed key) pairs, returns the count M.
// Device-side consumer: data/bev.py::make_bev_map_from_cells.
int64_t cyv4_aggregate_cells(const float* points, int64_t n, int32_t* cells,
                             int32_t* keys) {
  return aggregate_cells(points, n, cells, keys);
}

int32_t cyv4_bev_size() { return kBev; }

}  // extern "C"
