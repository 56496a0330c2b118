"""ctypes bindings for the port's native BEV rasterizer (`bev_native.cpp`).

`bev_native.cpp` is a byte-for-byte copy of
`complex_yolov4_tpu/native/bev_native.cpp`, and the bindings below are the
JAX package's (`native/__init__.py`): `rasterize_points`,
`aggregate_cells`, `mosaic_rasterize` and `rasterize_files`, each equal bit
for bit to the numpy functions of `data/bev.py` (and the fused mosaic to
the numpy canvas after the loader's 2:1 `resize_linear`).

The library is built at first use with g++ into
`complex_yolov4_tpu_torch/build/` (git-ignored), named by a hash of the
source, the flags and the host's CPU (``-march=native`` code built for one
CPU may not run on another that shares the checkout), so an edited source
is rebuilt and an unchanged one reused; nothing is built next to the
source, and nothing is built at import. `build()` raises on any failure.
`is_available()` swallows a failed build, as the JAX package's does, and
the callers in `data/` then take the numpy path, which computes the same
function.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "bev_native.cpp"
BUILD_DIR = _DIR.parent / "build"
# The JAX Makefile's flags, plus -ffp-contract=off: -march=native builds for
# whatever CPU the build runs on, and a contracted multiply-add (FMA) rounds
# once where numpy rounds twice, which would break the bit-equality with
# the numpy functions on a host that has FMA. (g++ already leaves
# contraction off under a strict -std=c++17; the flag keeps it off under
# any compiler default.)
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-march=native",
            "-ffp-contract=off")
LDFLAGS = ("-shared", "-lpthread")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _host_cpu() -> bytes:
    """The CPU's model name and feature flags (what -march=native reads)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f if ln.startswith((b"model name", b"flags"))]
        return b"".join(sorted(set(lines)))
    except OSError:
        return platform.machine().encode()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS + LDFLAGS).encode())
    h.update(_host_cpu())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libbev_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if the one for the current source and flags is
    missing; returns its path. Raises if there is no C++ compiler or it
    fails."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH: the native rasterizer needs one")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    out = subprocess.run([cxx, *CXXFLAGS, str(SOURCE), "-o", str(tmp), *LDFLAGS],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed ({out.returncode}) on {SOURCE.name}:\n"
                           f"{out.stdout}{out.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    return so


def load() -> ctypes.CDLL:
    """The loaded library (built first if needed), with argtypes set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.cyv4_rasterize_points.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float)]
        lib.cyv4_rasterize_points.restype = None
        lib.cyv4_rasterize_file.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float)]
        lib.cyv4_rasterize_file.restype = ctypes.c_int64
        lib.cyv4_rasterize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32]
        lib.cyv4_rasterize_batch.restype = ctypes.c_int32
        lib.cyv4_aggregate_cells.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        lib.cyv4_aggregate_cells.restype = ctypes.c_int64
        lib.cyv4_mosaic.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float)]
        lib.cyv4_mosaic.restype = None
        _lib = lib
    return _lib


def is_available() -> bool:
    """True once the library loads; False (once, for the process) where it
    cannot be built, and the callers take the numpy path."""
    global _tried
    if _lib is None and not _tried:
        _tried = True
        try:
            load()
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return False
    return _lib is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _points(points: np.ndarray) -> np.ndarray:
    pts = np.ascontiguousarray(points, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 4:
        raise ValueError(f"points must be (N, 4), got {pts.shape}")
    return pts


def rasterize_points(points: np.ndarray) -> np.ndarray:
    """(N, 4) float32 raw (uncropped) points -> (608, 608, 3) float32 BEV.

    Crop + z-shift happen inside; equal to
    `bev.make_bev_map(bev.remove_points_outside(points))`.
    """
    lib = load()
    pts = _points(points)
    out = np.empty((608, 608, 3), np.float32)
    lib.cyv4_rasterize_points(_f32p(pts), ctypes.c_int64(pts.shape[0]), _f32p(out))
    return out


def aggregate_cells(points: np.ndarray):
    """(N, 4) float32 raw (uncropped) points -> (cells (M,) int32,
    keys (M,) int32) COO for `bev.make_bev_map_from_cells`. Equal to
    `bev.aggregate_bev_cells(bev.remove_points_outside(points))`."""
    lib = load()
    pts = _points(points)
    cap = min(pts.shape[0], 609 * 609)
    cells = np.empty((cap,), np.int32)
    keys = np.empty((cap,), np.int32)
    m = lib.cyv4_aggregate_cells(
        _f32p(pts), ctypes.c_int64(pts.shape[0]),
        cells.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return cells[:m].copy(), keys[:m].copy()


def mosaic_rasterize(points_list: List[np.ndarray], flips: List[bool],
                     holes_list: List[List[tuple]], yc: int,
                     xc: int) -> np.ndarray:
    """Fused 4-frame mosaic: rasterize + flip/cutout + placement + 2:1 resize
    in one C++ pass (equal to dataset's numpy mosaic canvas followed by the
    loader's 2:1 `resize_linear`; see bev_native.cpp::mosaic).

    points_list: 4 (n_q, 4) float32 post-augmentation point arrays.
    holes_list: per-frame cutout rows (y1, y2, x1, x2, fill) in sub-image
    coords (after flip). Returns the final (608, 608, 3) float32 canvas.
    """
    lib = load()
    if not (len(points_list) == 4 and len(flips) == 4 and len(holes_list) == 4):
        raise ValueError("a mosaic takes 4 frames, 4 flips and 4 hole lists")
    pts = np.concatenate([_points(np.reshape(p, (-1, 4))) for p in points_list], axis=0)
    npts = np.array([np.reshape(p, (-1, 4)).shape[0] for p in points_list], np.int64)
    flips_arr = np.array([1 if f else 0 for f in flips], np.uint8)
    hole_counts = np.array([len(h) for h in holes_list], np.int32)
    all_holes = [row for h in holes_list for row in h]
    holes = (np.array(all_holes, np.float32).reshape(-1, 5)
             if all_holes else np.zeros((0, 5), np.float32))
    out = np.empty((608, 608, 3), np.float32)
    lib.cyv4_mosaic(
        _f32p(pts), npts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        flips_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _f32p(holes), hole_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(int(yc)), ctypes.c_int32(int(xc)), _f32p(out))
    return out


def rasterize_files(paths: List[str], num_threads: int = 0) -> np.ndarray:
    """Batch of velodyne .bin paths -> (B, 608, 608, 3), threaded in C++
    (`num_threads` 0: one per core). Raises IOError if a file fails to
    load."""
    lib = load()
    b = len(paths)
    out = np.empty((b, 608, 608, 3), np.float32)
    arr = (ctypes.c_char_p * b)(*[os.fsencode(p) for p in paths])
    failures = lib.cyv4_rasterize_batch(arr, ctypes.c_int32(b), _f32p(out),
                                        ctypes.c_int32(num_threads))
    if failures:
        raise IOError(f"{failures} of {b} velodyne files failed to load")
    return out
