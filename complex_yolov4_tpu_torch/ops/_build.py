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
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources() + sorted(SRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcyv4_kernels_{h.hexdigest()[:16]}.so"


def build() -> str:
    """Compile the kernels if the library for the current sources is
    missing: one nvcc per source, all started together, then one link.
    Returns nvcc's log (its -Xptxas -v register and shared-memory lines),
    kept beside the library for later processes."""
    so = library_path()
    log = so.with_suffix(".log")
    if so.exists() and log.exists():
        return log.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    texts, failed = [], []
    for src, proc in zip(_sources(), procs):
        out, _ = proc.communicate()
        texts.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
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
        lib.cyv4_fused_stage.argtypes = [vp, vp, vp, vp, vp] + [i] * 9 + [vp]
        lib.cyv4_fused_stage.restype = i
        f = ctypes.c_float
        lib.cyv4_int8_conv.argtypes = [vp] * 5 + [i] * 7 + [f, i, i, f, vp]
        lib.cyv4_int8_conv.restype = i
        lib.cyv4_error_string.argtypes = [i]
        lib.cyv4_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if code != 0:
        msg = load().cyv4_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
