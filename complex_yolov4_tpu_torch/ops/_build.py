"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

The sources under `complex_yolov4_tpu_torch/csrc/` are compiled at first use
into `complex_yolov4_tpu_torch/build/` (git-ignored) with a plain C
interface, then loaded with ctypes. The library name carries a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
reused. Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
# sources compiled once per part (-DCYV4_PART=k), each part by its own nvcc,
# so that the instances of one large source build in parallel
PARTS = {"conv3x3.cu": (1, 2, 3), "int8_conv.cu": (1, 2)}

_lib: Optional[ctypes.CDLL] = None


class Int8ConvArgs(ctypes.Structure):
    """`cyv4_int8_conv`'s one argument (csrc/int8_conv.cu Int8ConvArgs)."""

    _fields_ = ([("x", ctypes.c_void_p), ("x_dtype", ctypes.c_int)]
                + [(n, ctypes.c_void_p) for n in ("w", "w_scale", "bias", "out")]
                + [(n, ctypes.c_int) for n in ("B", "H", "W", "C_in", "C_out", "ksize",
                                               "stride")]
                + [("s_x", ctypes.c_float), ("inv_s_x", ctypes.c_float), ("act", ctypes.c_int),
                   ("mode", ctypes.c_int), ("inv_s_next", ctypes.c_float),
                   ("stream", ctypes.c_void_p), ("device", ctypes.c_int)])


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def _units():
    """(source, extra nvcc flags, object tag) of each nvcc process."""
    return [(src, (f"-DCYV4_PART={k}",) if k else (), f"{src.stem}.part{k}" if k else src.stem)
            for src in _sources() for k in PARTS.get(src.name, (0,))]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    h.update(repr(sorted(PARTS.items())).encode())
    for src in _sources() + sorted(SRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcyv4_kernels_{h.hexdigest()[:16]}.so"


def build() -> str:
    """Compile the kernels if the library for the current sources is
    missing: one nvcc per source (per part, `PARTS`), all started together,
    then one link.
    Returns nvcc's log (each unit's seconds and its -Xptxas -v register and
    shared-memory lines), kept beside the library for later processes."""
    so = library_path()
    log = so.with_suffix(".log")
    if so.exists() and log.exists():
        return log.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    units = _units()
    objs, logs, procs = [], [], []
    t0 = time.perf_counter()
    for src, defines, name in units:
        obj = BUILD_DIR / f"{tag}.{name}.o"
        objs.append(obj)
        logs.append(obj.with_suffix(".nvcc.log"))
        with open(logs[-1], "w") as sink:
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *defines, "-c", "-o", str(obj), str(src)],
                stdout=sink, stderr=subprocess.STDOUT))
    seconds = {}
    while len(seconds) < len(procs):  # each unit's own wall time
        for i, proc in enumerate(procs):
            if i not in seconds and proc.poll() is not None:
                seconds[i] = time.perf_counter() - t0
        time.sleep(0.05)
    texts, failed = [], []
    for i, ((src, defines, name), proc) in enumerate(zip(units, procs)):
        out = logs[i].read_text()
        logs[i].unlink()
        texts.append(f"== {src.name} {' '.join(defines)} ({seconds[i]:.1f} s)\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    text = "".join(texts)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{text}")
    tmp = so.with_name(f"{tag}.tmp.so")
    link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}{link.stderr}")
    tmp_log = log.with_name(f"{tag}.tmp.log")
    tmp_log.write_text(text)
    os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    os.replace(tmp_log, log)
    return text


def load() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with argtypes set:
    every pointer and the stream as c_void_p, every size as c_int, every
    scale as c_float."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(library_path()))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.cyv4_stem_conv3x3.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, vp]
        lib.cyv4_stem_conv3x3.restype = i
        lib.cyv4_conv3x3.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, vp]
        lib.cyv4_conv3x3.restype = i
        lib.cyv4_conv3x3_f32.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, vp]
        lib.cyv4_conv3x3_f32.restype = i
        lib.cyv4_fused_stage.argtypes = [vp, vp, vp, vp, vp] + [i] * 9 + [vp]
        lib.cyv4_fused_stage.restype = i
        lib.cyv4_int8_conv.argtypes = [ctypes.POINTER(Int8ConvArgs)]
        lib.cyv4_int8_conv.restype = i
        lib.cyv4_nms.argtypes = [vp, vp, vp, vp] + [i] * 5 + [ctypes.c_float] * 2 + [vp, i]
        lib.cyv4_nms.restype = i
        lib.cyv4_nms_limits.argtypes = [ctypes.POINTER(i)]
        lib.cyv4_nms_limits.restype = None
        limits = (i * 3)()
        lib.cyv4_nms_limits(limits)
        lib.nms_limits = tuple(limits)  # (most candidates, rows a chunk, most keys)
        lib.cyv4_error_string.argtypes = [i]
        lib.cyv4_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if code != 0:
        msg = load().cyv4_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
