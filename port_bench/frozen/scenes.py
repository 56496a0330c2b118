"""Synthetic LiDAR scenes and their host COO cells (numpy only).

Frozen copies of the port's `data/synthetic.py` (`_lidar_ground`,
`sample_scene`) and `data/bev.py` (`remove_points_outside`,
`aggregate_bev_cells`, `density_from_keys`, `pack_cells_flat`), giving the
same arrays from the same generator:
- `sample_scene` shuffles by indexing with `rng.permutation`, which draws
  the same swaps as `rng.shuffle(points, axis=0)` and is 10x faster;
- `aggregate_cells` finds each cell's top point by one `np.lexsort` instead
  of `np.maximum.at` (the same max height, top-point intensity and count).
`tests/test_port_bench_copies.py` holds both equal to the port's.

The COO key of an occupied cell packs (the port's served format):
bits [31:14] height = round(z_max / 4 m * (2^18 - 1)), bits [13:8] count =
min(count, 63), bits [7:0] intensity = round(r_top * 255).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

BOUNDARY = {"minX": 0.0, "maxX": 50.0, "minY": -25.0, "maxY": 25.0,
            "minZ": -2.73, "maxZ": 1.27}
BEV_SIZE = 608
GRID = BEV_SIZE + 1  # the raster grid before the final crop
HQ_MAX = (1 << 18) - 1
DENSITY_TABLE = np.minimum(1.0, np.log(np.arange(64, dtype=np.float64) + 1.0)
                           / np.log(64.0)).astype(np.float32)

_CLASS_DIMS = {0: (1.53, 1.63, 3.88), 1: (1.76, 0.66, 0.84), 2: (1.74, 0.60, 1.76)}
_GROUND_Z = -1.73


def _lidar_ground(rng: np.random.Generator) -> np.ndarray:
    elev = np.deg2rad(np.linspace(-24.8, -1.0, 56))
    az = np.deg2rad(np.arange(-60.0, 60.0, 0.42))
    e, a = np.meshgrid(elev, az, indexing="ij")
    e = e + rng.normal(0.0, 2e-4, e.shape)
    a = a + rng.normal(0.0, 2e-4, a.shape)
    r = (-_GROUND_Z) / np.tan(-e)
    keep = (r > 2.0) & (r < 70.0)
    r, a = r[keep], a[keep]
    x = r * np.cos(a)
    y = r * np.sin(a)
    z = _GROUND_Z + rng.normal(0.0, 0.02, r.shape)
    i = rng.uniform(0.05, 0.3, r.shape)
    return np.stack([x, y, z, i], axis=-1)


def sample_scene(rng: np.random.Generator, max_objects: int = 10, n_ground: int = 12000,
                 n_clutter: int = 1500, clustered: bool = False):
    """One scene -> (points (N, 4) f32, lidar boxes (M, 7) [x, y, z_center,
    h, w, l, rz], classes (M,) int32); clustered: the spinning-lidar beam
    model with vertical surfaces, objects thinning out with range."""
    pts: List[np.ndarray] = []
    if clustered:
        pts.append(_lidar_ground(rng))
        for _ in range(int(rng.integers(2, 6))):
            px = rng.uniform(8.0, 48.0)
            py = rng.uniform(-22.0, 22.0)
            width = rng.uniform(2.0, 10.0)
            height = rng.uniform(1.0, 3.0)
            yaw = rng.uniform(-np.pi, np.pi)
            n = int(np.clip(2000.0 * width * height / max(px, 4.0), 100, 1200))
            u = rng.uniform(-0.5, 0.5, n) * width
            v = rng.uniform(0.0, 1.0, n) * height
            wx = px + u * np.cos(yaw)
            wy = py + u * np.sin(yaw)
            wz = _GROUND_Z + v + rng.normal(0.0, 0.01, n)
            wi = rng.uniform(0.1, 0.6, n)
            pts.append(np.stack([wx, wy, wz, wi], axis=-1))
    else:
        gx = rng.uniform(0.0, 52.0, n_ground)
        gy = rng.uniform(-26.0, 26.0, n_ground)
        gz = _GROUND_Z + rng.normal(0.0, 0.03, n_ground)
        gi = rng.uniform(0.05, 0.3, n_ground)
        pts.append(np.stack([gx, gy, gz, gi], axis=-1))
        cx = rng.uniform(0.0, 52.0, n_clutter)
        cy = rng.uniform(-26.0, 26.0, n_clutter)
        cz = rng.uniform(_GROUND_Z, 1.2, n_clutter)
        ci = rng.uniform(0.0, 1.0, n_clutter)
        pts.append(np.stack([cx, cy, cz, ci], axis=-1))

    n_obj = int(rng.integers(1, max_objects + 1))
    boxes, classes = [], []
    for _ in range(n_obj):
        cls = int(rng.integers(0, 3))
        h0, w0, l0 = _CLASS_DIMS[cls]
        h = h0 * rng.uniform(0.9, 1.1)
        w = w0 * rng.uniform(0.9, 1.1)
        l = l0 * rng.uniform(0.9, 1.1)
        x = rng.uniform(6.0, 44.0)
        y = rng.uniform(-20.0, 20.0)
        z = _GROUND_Z + h / 2
        yaw = rng.uniform(-np.pi, np.pi)
        if clustered:
            n_pts = int(np.clip(2500 * w * l * h / max(x, 4.0), 80, 1500))
        else:
            n_pts = int(np.clip(40 * w * l * h, 60, 500))
        face = rng.integers(0, 5, n_pts)
        u = rng.uniform(-0.5, 0.5, n_pts)
        v = rng.uniform(-0.5, 0.5, n_pts)
        bx = np.where(face == 0, 0.5, np.where(face == 1, -0.5, u))
        by = np.where(face == 2, 0.5, np.where(face == 3, -0.5, np.where(face < 2, u, v)))
        bz = np.where(face == 4, 0.5, np.where(face < 4, v, 0.5))
        local = np.stack([bx * l, by * w, bz * h], axis=-1)
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        world = local @ rot.T + np.array([x, y, z])
        world += rng.normal(0.0, 0.01, world.shape)
        inten = rng.uniform(0.3, 0.9, (n_pts, 1))
        pts.append(np.concatenate([world, inten], axis=-1))
        boxes.append([x, y, z, h, w, l, yaw])
        classes.append(cls)

    points = np.concatenate(pts, axis=0).astype(np.float32)
    points = points[rng.permutation(points.shape[0])]
    return points, np.array(boxes, np.float64).reshape(-1, 7), np.array(classes, np.int32)


def remove_points_outside(points: np.ndarray) -> np.ndarray:
    """Crop (N, 4) points to the front boundary (inclusive), z shifted by -minZ."""
    bc = BOUNDARY
    m = ((points[:, 0] >= bc["minX"]) & (points[:, 0] <= bc["maxX"])
         & (points[:, 1] >= bc["minY"]) & (points[:, 1] <= bc["maxY"])
         & (points[:, 2] >= bc["minZ"]) & (points[:, 2] <= bc["maxZ"]))
    out = points[m].copy()
    out[:, 2] -= bc["minZ"]
    return out


def aggregate_cells(points: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Cropped (N, 4) points -> (cells (M,) int32 ascending, keys (M,) int32)
    per occupied cell: max height, the largest intensity among the points
    at that height, the saturating count."""
    disc = np.float32((BOUNDARY["maxX"] - BOUNDARY["minX"]) / BEV_SIZE)
    max_height = float(abs(BOUNDARY["maxZ"] - BOUNDARY["minZ"]))
    ix = np.floor(points[:, 0] / disc).astype(np.int64)
    iy = (np.floor(points[:, 1] / disc) + GRID / 2).astype(np.int64)
    cells = ix * GRID + iy
    # ascending by cell, then height, then intensity: each cell's last
    # point is its top point with the largest intensity at that height
    order = np.lexsort((points[:, 3], points[:, 2], cells))
    cs = cells[order]
    last = np.flatnonzero(np.append(cs[1:] != cs[:-1], True))
    first = np.concatenate([[0], last[:-1] + 1])
    occ = cs[last]
    top = order[last]
    height = points[top, 2].astype(np.float64)
    intensity = points[top, 3].astype(np.float64)
    hq = np.rint(np.clip(height / max_height, 0.0, 1.0) * HQ_MAX).astype(np.int64)
    cq = np.minimum(last - first + 1, 63).astype(np.int64)
    rq = np.rint(np.clip(intensity, 0.0, 1.0) * 255.0).astype(np.int64)
    keys = ((hq << 14) | (cq << 8) | rq).astype(np.uint32).view(np.int32)
    return occ.astype(np.int32), keys


def density_from_keys(keys: np.ndarray) -> np.ndarray:
    return DENSITY_TABLE[(keys.view(np.uint32) >> 8) & 0x3F]


def pack_cells_flat(cell_arrays: Sequence[np.ndarray], key_arrays: Sequence[np.ndarray],
                    capacity: int):
    """Per-frame (cells, keys) -> flat (capacity,) (cells int32 frame-global,
    keys int32, density f32); unused lanes point at the dump slot past the
    last frame's grid. Raises if the frames hold more cells than capacity:
    the benchmark never truncates a frame."""
    total = sum(int(c.shape[0]) for c in cell_arrays)
    if total > capacity:
        raise ValueError(f"{total} cells exceed the COO capacity {capacity}")
    cells = np.full((capacity,), len(cell_arrays) * GRID * GRID, np.int32)
    keys = np.zeros((capacity,), np.int32)
    at = 0
    for fid, (c, k) in enumerate(zip(cell_arrays, key_arrays)):
        cells[at:at + len(c)] = c + fid * GRID * GRID
        keys[at:at + len(c)] = k
        at += len(c)
    return cells, keys, density_from_keys(keys)


def scene_job(job: tuple):
    """(seed, stream, index, clustered, max_objects, aggregate) -> (cropped
    cloud, (cells, keys) or None): one scene, in a worker process."""
    seed, stream, index, clustered, max_objects, aggregate = job
    pts = sample_scene(scene_rng(seed, stream, index), max_objects=max_objects,
                       clustered=clustered)[0]
    cloud = remove_points_outside(pts)
    return cloud, aggregate_cells(cloud) if aggregate else None


def make_scenes(jobs: Sequence[tuple], workers: int) -> list:
    """`scene_job` of each job on `workers` spawned processes, which have all
    ended when this returns."""
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        return list(pool.map(scene_job, jobs, chunksize=max(1, len(jobs) // (4 * workers))))


def scene_rng(seed: int, stream: str, index: int) -> np.random.Generator:
    """The generator of scene `index` of a named stream ("pool", "calib")
    under the run's seed: any seed up to 2^63 and beyond."""
    tag = {"pool": 1, "calib": 2}[stream]
    return np.random.default_rng((int(seed), tag, int(index)))
