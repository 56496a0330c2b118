"""Bird's-eye-view raster: host numpy rasters and COO aggregation, device
rasters in torch.

Counterpart of `complex_yolov4_tpu/data/bev.py` (reference:
src/data_process/kitti_bev_utils.py:18-76). Crop to the front boundary,
shift z by -minZ, discretize to a 609x609 grid (cell = 50/608 m, y offset
+304), then per cell: channel 0 the intensity of the highest point,
channel 1 the max height / 4 m, channel 2 min(1, log(count+1)/log 64),
cropped to 608x608. Output layout is (B, S, S, 3) float32 HWC — rows = x
cells, cols = y cells, channels (intensity, height, density) — the same as
the JAX package.

Host (numpy; copies of the originals, held bit-equal to them by
`tests/test_torch_port_copies.py`):
- `make_bev_map`, `pad_points`, `pack_points_flat`: the host raster and the
  padded / flat point layouts of the device points raster;
- `aggregate_bev_cells`, `pack_cells_flat` (frame-global ids, one flat
  buffer) and `pack_cells_batched` (frame-local ids, (B, C) lanes that
  split over devices): the COO layouts. The host walks
  the cropped cloud once and resolves, per occupied cell, the max height,
  the intensity of the top point and the saturating point count, packed
  into one int32 key:

    bits [31:14] height    = round(z_max / 4m * (2^18-1))
    bits [13: 8] count     = min(count, 63)
    bits [ 7: 0] intensity = round(r_top * 255)

Device (torch, on the device the inputs lie on):
- `make_bev_map_from_cells` and `make_bev_map_from_cells_batched`: two
  conflict-free scatters over the occupied cells and an elementwise unpack
  (`tests/test_torch_port_raster.py`, `tests/test_torch_port_shard.py`:
  bit-exact against JAX);
- `make_bev_map_points` / `make_bev_map_points_flat`: the points raster
  (`make_bev_map_jax` / `make_bev_map_jax_flat`): a float count scatter-add
  and, packed (the default), one int32 scatter-max of (z bits | 8-bit
  intensity), or, exact, a float height scatter-max and a top-point
  intensity scatter-max; `images_from_deferred_batch` adds flip, cutout
  holes and the resize. `floor(x / disc)` may put a point that sits on a
  cell edge one cell over, where the device divides by another rounding
  than numpy (CUDA multiplies by the reciprocal of a scalar divisor): the
  port is held to the JAX package's mismatched-cell budget
  (`tests/test_torch_port_points_raster.py`), not to bit equality.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import kitti as cnf

_LOG64 = np.log(64.0)
_HQ_MAX = (1 << 18) - 1  # 18-bit height quantizer
_DENSITY_TABLE = np.minimum(
    1.0, np.log(np.arange(64, dtype=np.float64) + 1.0) / _LOG64
).astype(np.float32)  # f64 curve cast to f32: bit-identical to the host raster


def remove_points_outside(points: np.ndarray, boundary: Optional[Dict[str, float]] = None) -> np.ndarray:
    """Crop (N, 4) points to the boundary (inclusive) and shift z by -minZ
    (reference: kitti_bev_utils.py:18-34)."""
    bc = boundary or cnf.BOUNDARY
    m = (
        (points[:, 0] >= bc["minX"]) & (points[:, 0] <= bc["maxX"])
        & (points[:, 1] >= bc["minY"]) & (points[:, 1] <= bc["maxY"])
        & (points[:, 2] >= bc["minZ"]) & (points[:, 2] <= bc["maxZ"])
    )
    out = points[m].copy()
    out[:, 2] -= bc["minZ"]
    return out


_GRID = cnf.BEV_HEIGHT + 1  # 609: raster grid before the final crop


def _cell_indices_np(points: np.ndarray, discretization: float) -> Tuple[np.ndarray, np.ndarray]:
    ix = np.floor(points[:, 0] / discretization).astype(np.int64)
    # int(floor(y/d) + 609/2) truncates the .5 -> floor(y/d) + 304.
    iy = (np.floor(points[:, 1] / discretization) + _GRID / 2).astype(np.int64)
    return ix, iy


def make_bev_map(points: np.ndarray, discretization: float = cnf.DISCRETIZATION,
                 boundary: Optional[Dict[str, float]] = None) -> np.ndarray:
    """Cropped/shifted (N, 4) points -> (608, 608, 3) float32 HWC BEV map."""
    bc = boundary or cnf.BOUNDARY
    max_height = float(abs(bc["maxZ"] - bc["minZ"]))
    ix, iy = _cell_indices_np(points, discretization)
    cells = ix * _GRID + iy

    n_cells = _GRID * _GRID
    height = np.zeros(n_cells, np.float64)
    np.maximum.at(height, cells, points[:, 2])
    counts = np.bincount(cells, minlength=n_cells)

    # Intensity of the top point: max intensity among points at the cell max z.
    intensity = np.zeros(n_cells, np.float64)
    is_top = points[:, 2] >= height[cells]
    np.maximum.at(intensity, cells[is_top], points[is_top, 3])

    density = np.minimum(1.0, np.log(counts + 1.0) / _LOG64)
    occupied = counts > 0
    out = np.zeros((n_cells, 3), np.float32)
    out[occupied, 0] = intensity[occupied]
    out[occupied, 1] = height[occupied] / max_height
    out[occupied, 2] = density[occupied]
    out = out.reshape(_GRID, _GRID, 3)
    return np.ascontiguousarray(out[: cnf.BEV_HEIGHT, : cnf.BEV_WIDTH, :])


def pad_points(points: np.ndarray, max_points: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad/truncate cropped points to a static (max_points, 4) + mask for the
    device rasterizer. Truncation keeps the first points (arbitrary subset,
    ~120k crop covers every KITTI frame, SURVEY.md §7)."""
    n = min(points.shape[0], max_points)
    out = np.zeros((max_points, 4), np.float32)
    out[:n] = points[:n]
    mask = np.zeros((max_points,), np.float32)
    mask[:n] = 1.0
    return out, mask


def pack_points_flat(point_arrays, capacity: int):
    """Host packer for `make_bev_map_points_flat`: per-frame cropped/z-shifted
    clouds -> (points (capacity, 4), frame_id (capacity,), mask (capacity,)).

    Frames are laid out contiguously; if the batch's total live points exceed
    `capacity` the tail frames truncate (same policy as `pad_points`, applied
    globally — size capacity generously for the workload's batch total)."""
    points = np.zeros((capacity, 4), np.float32)
    frame_id = np.zeros((capacity,), np.int32)
    mask = np.zeros((capacity,), np.float32)
    at = 0
    for fid, pts in enumerate(point_arrays):
        n = min(pts.shape[0], capacity - at)
        points[at:at + n] = pts[:n]
        frame_id[at:at + n] = fid
        mask[at:at + n] = 1.0
        at += n
        if at >= capacity:
            break
    return points, frame_id, mask


def aggregate_bev_cells(points: np.ndarray,
                        boundary: Optional[Dict[str, float]] = None,
                        bev_size: int = cnf.BEV_HEIGHT
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Cropped/z-shifted (N, 4) points -> (cells (M,) int32, keys (M,) int32)
    per occupied cell (max z; max intensity among points at the cell max;
    saturating count). `bev_size` must match the downstream `pack_cells_flat`
    / `make_bev_map_from_cells` calls (they share the bev_size+1 grid)."""
    bc = boundary or cnf.BOUNDARY
    grid = bev_size + 1
    discretization = (bc["maxX"] - bc["minX"]) / bev_size
    max_height = float(abs(bc["maxZ"] - bc["minZ"]))
    ix = np.floor(points[:, 0] / np.float32(discretization)).astype(np.int64)
    iy = (np.floor(points[:, 1] / np.float32(discretization))
          + grid / 2).astype(np.int64)
    cells = ix * grid + iy

    n_cells = grid * grid
    height = np.zeros(n_cells, np.float64)
    np.maximum.at(height, cells, points[:, 2])
    counts = np.bincount(cells, minlength=n_cells)
    intensity = np.zeros(n_cells, np.float64)
    is_top = points[:, 2] >= height[cells]
    np.maximum.at(intensity, cells[is_top], points[is_top, 3])

    occ = np.flatnonzero(counts)
    hq = np.rint(np.clip(height[occ] / max_height, 0.0, 1.0) * _HQ_MAX
                 ).astype(np.int64)
    cq = np.minimum(counts[occ], 63).astype(np.int64)
    rq = np.rint(np.clip(intensity[occ], 0.0, 1.0) * 255.0).astype(np.int64)
    keys = ((hq << 14) | (cq << 8) | rq).astype(np.uint32).view(np.int32)
    return occ.astype(np.int32), keys


def density_from_keys(keys: np.ndarray) -> np.ndarray:
    """Packed cell keys -> exact f32 density channel values: a 64-entry
    lookup of the saturating count over the occupied cells only, so the
    device needs no per-grid-cell gather or log."""
    cq = (keys.view(np.uint32) >> 8) & 0x3F
    return _DENSITY_TABLE[cq]


def pack_cells_flat(cell_arrays, key_arrays, capacity: int,
                    bev_size: int = cnf.BEV_HEIGHT,
                    total_frames: Optional[int] = None,
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-frame (cells, keys) from `aggregate_bev_cells` -> flat (capacity,)
    (cells int32, keys int32, density f32) for `make_bev_map_from_cells`.
    Cell ids become frame-global (fid * grid^2 + cell); unused lanes point at
    the dump slot so the device needs no mask. Tail frames truncate past
    `capacity`. total_frames: frame count the raster will run at
    (>= len(cell_arrays)); the dump slot sits past THAT grid."""
    grid = bev_size + 1
    if total_frames is None:
        total_frames = len(cell_arrays)
    if total_frames < len(cell_arrays):
        raise ValueError(f"total_frames {total_frames} < {len(cell_arrays)} frames")
    n_cells_total = total_frames * grid * grid
    cells = np.full((capacity,), n_cells_total, np.int32)
    keys = np.zeros((capacity,), np.int32)
    at = 0
    for fid, (c, k) in enumerate(zip(cell_arrays, key_arrays)):
        n = min(c.shape[0], capacity - at)
        cells[at:at + n] = c[:n] + fid * grid * grid
        keys[at:at + n] = k[:n]
        at += n
        if at >= capacity:
            break
    return cells, keys, density_from_keys(keys)


def make_bev_map_from_cells(cells: torch.Tensor, keys: torch.Tensor,
                            dens: torch.Tensor, batch: int,
                            bev_size: int = cnf.BEV_HEIGHT) -> torch.Tensor:
    """Device tail of the COO raster: flat (M,) frame-global cell ids +
    (M,) packed int32 keys + (M,) host density -> (batch, S, S, 3) float32,
    on the device the inputs lie on.

    Two scatters into (n_cells + 1,) buffers whose last slot is the dump:
    live cell ids are unique (host guarantee), dead lanes all write the dump
    slot — their duplicate writes race, harmlessly, since the slot is
    sliced off — so plain `index_put_` with no reduction is exact."""
    grid = bev_size + 1
    n_cells = batch * grid * grid
    dev = cells.device
    idx = cells.long()
    buf = torch.zeros(n_cells + 1, dtype=torch.int32, device=dev)
    buf.index_put_((idx,), keys.to(torch.int32))
    dbuf = torch.zeros(n_cells + 1, dtype=torch.float32, device=dev)
    dbuf.index_put_((idx,), dens.to(torch.float32))
    # The 18-bit height sits in bits 14-31, so keys with hq >= 2^17 are
    # negative as int32 and `>>` on int32 is arithmetic: unpack the unsigned
    # bit pattern through int64.
    u = (buf[:n_cells].long() & 0xFFFFFFFF).reshape(batch, grid, grid)
    intensity = (u & 0xFF).float() * torch.tensor(1.0 / 255.0, dtype=torch.float32)
    height = (u >> 14).float() * torch.tensor(1.0 / _HQ_MAX, dtype=torch.float32)
    density = dbuf[:n_cells].reshape(batch, grid, grid)
    full = torch.stack([intensity, height, density], dim=-1)
    return full[:, :bev_size, :bev_size, :]


def pack_cells_batched(cell_arrays, key_arrays, per_frame_capacity: int,
                       total_frames: Optional[int] = None,
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched COO layout for `make_bev_map_from_cells_batched`: per-frame
    (cells, keys) -> ((B, C) cells int32, (B, C) keys int32, (B, C) dens
    f32) with frame-local cell ids. Unlike the flat layout it has a batch
    axis, so a batch splits over devices; the cost is B x per-frame
    capacity lanes instead of the batch total. Dead lanes carry key 0
    (impossible for an occupied cell: count >= 1 sets bit 8), which the
    device routes to the dump slot, so zero rows are valid pad frames.
    Frames with more than `per_frame_capacity` cells truncate.
    total_frames: rows (>= len(cell_arrays)); the rest are pad frames."""
    if total_frames is None:
        total_frames = len(cell_arrays)
    if total_frames < len(cell_arrays):
        raise ValueError(f"total_frames {total_frames} < {len(cell_arrays)} frames")
    cells = np.zeros((total_frames, per_frame_capacity), np.int32)
    keys = np.zeros((total_frames, per_frame_capacity), np.int32)
    for fid, (c, k) in enumerate(zip(cell_arrays, key_arrays)):
        n = min(c.shape[0], per_frame_capacity)
        cells[fid, :n] = c[:n]
        keys[fid, :n] = k[:n]
    return cells, keys, density_from_keys(keys)


def make_bev_map_from_cells_batched(cells: torch.Tensor, keys: torch.Tensor,
                                    dens: torch.Tensor,
                                    bev_size: int = cnf.BEV_HEIGHT) -> torch.Tensor:
    """Batched COO raster: (B, C) frame-local cell ids + packed keys + host
    density (`pack_cells_batched`) -> (B, S, S, 3) float32, on the device the
    inputs lie on. The math of `make_bev_map_from_cells`, frame by frame:
    frame b scatters into its own (grid^2 + 1) slots, the last its dump,
    which every dead lane (key 0) writes."""
    grid = bev_size + 1
    n_cells = grid * grid
    batch = cells.shape[0]
    dev = cells.device
    keys = keys.to(torch.int32)
    idx = torch.where(keys != 0, cells.long(), torch.full_like(cells, n_cells, dtype=torch.long))
    idx = (idx + torch.arange(batch, device=dev)[:, None] * (n_cells + 1)).reshape(-1)
    buf = torch.zeros(batch * (n_cells + 1), dtype=torch.int32, device=dev)
    buf.index_put_((idx,), keys.reshape(-1))
    dbuf = torch.zeros(batch * (n_cells + 1), dtype=torch.float32, device=dev)
    dbuf.index_put_((idx,), dens.to(torch.float32).reshape(-1))
    # unsigned unpack through int64, as in `make_bev_map_from_cells`
    u = (buf.reshape(batch, n_cells + 1)[:, :n_cells].long() & 0xFFFFFFFF).reshape(
        batch, grid, grid)
    intensity = (u & 0xFF).float() * torch.tensor(1.0 / 255.0, dtype=torch.float32)
    height = (u >> 14).float() * torch.tensor(1.0 / _HQ_MAX, dtype=torch.float32)
    density = dbuf.reshape(batch, n_cells + 1)[:, :n_cells].reshape(batch, grid, grid)
    full = torch.stack([intensity, height, density], dim=-1)
    return full[:, :bev_size, :bev_size, :]


def make_bev_map_points(points: torch.Tensor, mask: torch.Tensor,
                        bev_size: int = cnf.BEV_HEIGHT, *,
                        packed: bool = True) -> torch.Tensor:
    """Device points raster (`make_bev_map_jax`): (..., N, 4) padded
    cropped/z-shifted points + (..., N) mask -> (..., S, S, 3) float32, on
    the device the inputs lie on. The batch is flattened into one global
    scatter per channel (cell id = frame * grid^2 + cell).

    packed=True (the default): one int32 scatter-max of a key that holds the
    top 24 bits of z's f32 bit pattern (monotone in z >= 0) and 8 bits of
    intensity quantized to 1/255, so intensity is exact on KITTI's 8-bit
    reflectances (<= 1/510 off otherwise) and height is truncated to 15
    mantissa bits (<= 3.1e-5 on the normalized channel). packed=False: a
    float height scatter-max, then the max intensity among the points at
    the cell's max height."""
    single = points.dim() == 2
    if single:
        points, mask = points[None], mask[None]
    lead = points.shape[:-2]
    flat_pts = points.reshape(-1, *points.shape[-2:])
    flat_msk = mask.reshape(-1, mask.shape[-1])
    b, n = flat_msk.shape
    frame_id = torch.arange(b, device=points.device).repeat_interleave(n)
    out = _bev_scatter(flat_pts.reshape(-1, flat_pts.shape[-1]), frame_id,
                       flat_msk.reshape(-1) > 0.5, b, bev_size, packed)
    if single:
        return out[0]
    return out.reshape(*lead, *out.shape[-3:])


def make_bev_map_points_flat(points: torch.Tensor, frame_id: torch.Tensor,
                             mask: torch.Tensor, batch: int,
                             bev_size: int = cnf.BEV_HEIGHT, *,
                             packed: bool = True) -> torch.Tensor:
    """Flat-packed device points raster (`make_bev_map_jax_flat`): (P, 4)
    points + (P,) frame ids + (P,) mask from `pack_points_flat` -> (batch,
    S, S, 3); the same output as `make_bev_map_points` on the padded layout,
    with lanes for the batch's total live points only."""
    return _bev_scatter(points, frame_id.long(), mask > 0.5, batch, bev_size, packed)


def _bev_scatter(points: torch.Tensor, frame_id: torch.Tensor, live: torch.Tensor,
                 b: int, bev_size: int, packed: bool) -> torch.Tensor:
    """Scatter core (`_bev_from_cells` of the JAX package): flat (P, 4)
    points + (P,) frame ids + (P,) liveness -> (b, S, S, 3). Dead points go
    to a dump slot past every frame's grid, sliced off at the end."""
    grid = bev_size + 1
    disc = (cnf.BOUNDARY["maxX"] - cnf.BOUNDARY["minX"]) / bev_size
    n_cells = b * grid * grid
    dev = points.device
    points = points.float()

    ix = torch.floor(points[:, 0] / disc).to(torch.int64).clamp(0, grid - 1)
    iy = (torch.floor(points[:, 1] / disc) + grid / 2).to(torch.int64).clamp(0, grid - 1)
    cells = torch.where(live, (frame_id * grid + ix) * grid + iy,
                        torch.full_like(ix, n_cells))
    z = torch.where(live, points[:, 2], torch.full_like(points[:, 2], -1.0))
    r = torch.where(live, points[:, 3], torch.zeros_like(points[:, 3]))

    counts = torch.zeros(n_cells + 1, dtype=torch.float32, device=dev)
    counts.index_add_(0, cells, live.float())
    if packed:
        # z >= 0 after the clamp, so its bit pattern is a non-negative int32
        # and `>>` / `<<` on it are the unsigned shifts
        z_bits = torch.clamp(z, min=0.0).view(torch.int32)
        r8 = torch.round(torch.clamp(r, 0.0, 1.0) * 255.0).to(torch.int32)
        key = ((z_bits >> 8) << 8) | r8
        pk = torch.zeros(n_cells + 1, dtype=torch.int32, device=dev)
        pk.scatter_reduce_(0, cells, key, "amax")
        height = ((pk >> 8) << 8).view(torch.float32)
        intensity = (pk & 0xFF).float() * torch.tensor(1.0 / 255.0, dtype=torch.float32)
    else:
        height = torch.zeros(n_cells + 1, dtype=torch.float32, device=dev)
        height.scatter_reduce_(0, cells, z, "amax")
        is_top = live & (z >= height[cells])
        intensity = torch.zeros(n_cells + 1, dtype=torch.float32, device=dev)
        intensity.scatter_reduce_(
            0, torch.where(is_top, cells, torch.full_like(cells, n_cells)),
            torch.where(is_top, r, torch.zeros_like(r)), "amax")
    height = height[:n_cells].reshape(b, grid, grid)
    intensity = intensity[:n_cells].reshape(b, grid, grid)
    counts = counts[:n_cells].reshape(b, grid, grid)

    # density from the f64 curve's f32 table (`density_from_keys`): the same
    # values as the host raster's, where an f32 log could be one ulp off
    table = torch.from_numpy(_DENSITY_TABLE).to(dev)
    density = table[counts.clamp(max=63).long()]
    occupied = counts > 0
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    height = torch.where(occupied, torch.clamp(height, min=0.0)
                         / torch.tensor(cnf.MAX_HEIGHT, dtype=torch.float32), zero)
    intensity = torch.where(occupied, intensity, zero)
    density = torch.where(occupied, density, zero)
    full = torch.stack([intensity, height, density], dim=-1)
    return full[:, :bev_size, :bev_size, :]


def resize_images(img: torch.Tensor, out_size: int) -> torch.Tensor:
    """(B, S, S, C) f32 -> (B, out_size, out_size, C): half-pixel bilinear
    without antialiasing (`jax.image.resize(..., "linear", antialias=False)`,
    cv2 INTER_LINEAR semantics). At the border JAX renormalizes the weights
    of the taps that remain and PyTorch clamps the source index; both give
    the edge pixel's value there."""
    if img.shape[1] == out_size and img.shape[2] == out_size:
        return img
    x = torch.nn.functional.interpolate(img.permute(0, 3, 1, 2), size=(out_size, out_size),
                                        mode="bilinear", align_corners=False,
                                        antialias=False)
    return x.permute(0, 2, 3, 1).contiguous()


def images_from_deferred_batch(batch, out_size: int,
                               bev_size: int = cnf.BEV_HEIGHT) -> torch.Tensor:
    """Device tail of the deferred-raster pipeline (`images_from_deferred_batch`
    of the JAX package): padded points + recorded augmentation decisions
    (tensors on one device: points (B, N, 4), point_mask (B, N), flip (B,),
    holes (B, H, 5) as (y1, y2, x1, x2, fill), hole_mask (B, H)) ->
    (B, out_size, out_size, 3) f32: raster at the native 608, flip the
    width, punch the cutout holes, then resize."""
    img = make_bev_map_points(batch["points"], batch["point_mask"], bev_size)
    flip = batch["flip"] > 0.5
    img = torch.where(flip[:, None, None, None], img.flip(2), img)
    holes = batch["holes"].float()
    hole_mask = batch["hole_mask"]
    if holes.shape[1]:
        rows = torch.arange(bev_size, dtype=torch.float32, device=img.device)[None, :, None]
        cols = torch.arange(bev_size, dtype=torch.float32, device=img.device)[None, None, :]
        for h in range(holes.shape[1]):
            y1, y2 = holes[:, h, 0, None, None], holes[:, h, 1, None, None]
            x1, x2 = holes[:, h, 2, None, None], holes[:, h, 3, None, None]
            fill = holes[:, h, 4, None, None]
            inside = ((rows >= y1) & (rows < y2) & (cols >= x1) & (cols < x2)
                      & (hole_mask[:, h, None, None] > 0.5))
            img = torch.where(inside[..., None], fill[..., None], img)
    return resize_images(img, out_size)
