"""Where the stem and 3x3 conv kernels' time goes, on the card.

    python3 conv3x3_variants.py                      # run time of variants
    python3 conv3x3_variants.py --build-times [SRC]  # nvcc time per kernel

Run from the repo root on a machine with one CUDA card and nvcc.

With no arguments it builds `complex_yolov4_tpu_torch/csrc/conv3x3.cu` as
it is and in variants made by text substitution (one nvcc each, all
started together, into the git-ignored `complex_yolov4_tpu_torch/build/
variants/`), checks each against the plain version, and times it with CUDA
events at the main-path shapes of complex_yolov4 at 608, batch 8, every
variant in turn, twice (forward, then backward). Variants:

- kernel: the source as it is;
- no_epilogue: the activation and the stores skipped (window loads and
  products only);
- mma_sync: every 3x3 layer on mma.sync with one window ring per block
  (the kernel's path where two rings do not fit) instead of wgmma;
- cp_async: the windows copied by the threads with cp.async (16-byte
  copies for the 3x3, 4-byte for the stem) instead of TMA boxes;
- butterfly_16B: the quad's four lanes trade words by two shuffle
  exchanges with selects, then each lane stores 16 contiguous bytes;
- branchy_16B: the same trade written with the word picked by a lane-
  dependent index, which compiles to branches that serialize the quad.

Also the kernel with a linear activation instead of mish (a launch
argument). Prints one line per layer, variant and activation: ms per call
and the error in bf16 ulps of the plain version. A substitution whose
anchor is no longer in the source stops the run.

--build-times compiles SRC (default: conv3x3.cu) to compute_90a PTX, then
assembles it for sm_90a with ptxas once whole and once per kernel entry
(`--entry`, one process each, as many at a time as there are cores), and
prints each time: how the build splits over the template instances.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from complex_yolov4_tpu_torch.ops import _build
from complex_yolov4_tpu_torch.ops import conv3x3 as conv_mod
from complex_yolov4_tpu_torch.ops.activations import ACT_CODES

# (name, H=W, C_in, C_out, stride); L0 is the stem (f32 raster in)
LAYERS = (("L0", 608, 3, 32, 1), ("L1", 608, 32, 64, 2), ("L6", 304, 32, 64, 1),
          ("L11", 304, 64, 128, 2), ("L16", 152, 64, 64, 1))
BATCH, REPS = 8, 20
OUT_DIR = _build.BUILD_DIR / "variants"

STORE_4B = """  uint32_t* dst = reinterpret_cast<uint32_t*>(px) + q;
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
    if (ok && 8 * nj < c_left) dst[4 * nj] = v[nj];
}"""
STORE_16B = """  const uint4 o = TRADE(v, q);
  if (ok && 8 * q < c_left) *reinterpret_cast<uint4*>(px + 8 * q) = o;
}"""
# lane q holds word q of groups 0..3; afterwards the 4 words of group q
BUTTERFLY = """__device__ __forceinline__ uint4 trade_butterfly(const uint32_t (&v)[4], int q) {
  const bool b1 = q & 2, b0 = q & 1;
  uint32_t w0 = v[0], w1 = v[1], w2 = v[2], w3 = v[3];
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, b1 ? w0 : w2, 2);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, b1 ? w1 : w3, 2);
  w0 = b1 ? r0 : w0; w1 = b1 ? r1 : w1; w2 = b1 ? w2 : r0; w3 = b1 ? w3 : r1;
  r0 = __shfl_xor_sync(0xffffffffu, b0 ? w0 : w1, 1);
  r1 = __shfl_xor_sync(0xffffffffu, b0 ? w2 : w3, 1);
  w0 = b0 ? r0 : w0; w1 = b0 ? w1 : r0; w2 = b0 ? r1 : w2; w3 = b0 ? w3 : r1;
  return make_uint4(w0, w1, w2, w3);
}

"""
BRANCHY = """__device__ __forceinline__ uint4 trade_branchy(const uint32_t (&v)[4], int q) {
  uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int sj = (q - r) & 3, src = (q + r) & 3;
    const uint32_t send = sj == 0 ? v[0] : sj == 1 ? v[1] : sj == 2 ? v[2] : v[3];
    const uint32_t got = r == 0 ? send : __shfl_sync(0xffffffffu, send, src, 4);
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = j == src ? got : o[j];
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

"""
SLICE_DOC = "// Store one pixel's 32-channel accumulator slice"
TABLE_START = "constexpr TileChoice kTileChoices[] = {"


def bf16_ulps(got: torch.Tensor, ref: torch.Tensor, floor_frac: float = 2.0 ** -10) -> float:
    """Max error in bf16 ulps of the reference; values below floor_frac *
    max|ref| are measured in the ulp of that floor (chip_smoke.py's rule)."""
    g, r = got.float(), ref.float()
    floor = r.abs().max().clamp(min=1e-30) * floor_frac
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(r.abs(), floor))) - 7.0)
    return float(((g - r).abs() / ulp).max())


def time_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls, CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _sub(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise RuntimeError(f"variant anchor not found {count} time(s): {old[:60]!r}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    _sub(src, TABLE_START, TABLE_START)
    table_end = src.index("};", src.index(TABLE_START)) + 2
    mma_sync = (src[:src.index(TABLE_START)] + TABLE_START
                + "{false, 2, 2}, {false, 1, 2}, {false, 2, 1}, {false, 1, 1}};"
                + src[table_end:])
    stem_store = "store_slice(acc, half, act, px, q, C_out - c0, oy < H && ox < W);"
    no_epi = _sub(src, "if (oy < g.Ho) {  // warp-uniform", "if (oy < g.Ho && act < 0) {")
    no_epi = _sub(no_epi, stem_store, "if (act < 0) " + stem_store)

    def trade(fn_src, name):
        out = _sub(src, SLICE_DOC, fn_src + SLICE_DOC)
        return _sub(out, STORE_4B, STORE_16B.replace("TRADE", name))

    # the four TMA instances of the dispatch (C_in 32 and 64 at stride 1 and 2)
    cp_async, n = re.subn(r"launch_conv<([12]), LOAD_TMA, ", r"launch_conv<\1, LOAD_CP16, ", src)
    if n != 4:
        raise RuntimeError(f"variant anchor: {n} TMA launches in the dispatch, expected 4")
    cp_async = _sub(cp_async, "const int use_tma = stem_tensor_map<CIN>(&map, x, B, H, W) ? 1 : 0;",
                    "const int use_tma = 0;")
    return {"kernel": src, "no_epilogue": no_epi, "mma_sync": mma_sync, "cp_async": cp_async,
            "butterfly_16B": trade(BUTTERFLY, "trade_butterfly"),
            "branchy_16B": trade(BRANCHY, "trade_branchy")}


def build(srcs: dict) -> dict:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(OUT_DIR / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.cyv4_stem_conv3x3.argtypes = [vp, vp, vp, vp] + [i] * 6 + [vp]
        lib.cyv4_conv3x3.argtypes = [vp, vp, vp, vp] + [i] * 7 + [vp]
        libs[name] = lib
    return libs


def run_variants() -> None:
    dev = torch.device("cuda", 0)
    libs = build(variants((_build.SRC_DIR / "conv3x3.cu").read_text()))
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, hw, c_in, c_out, s in LAYERS:
        stem = name == "L0"
        x = torch.from_numpy(rng.normal(0, 1, (BATCH, hw, hw, c_in)).astype(np.float32)).to(
            dev, torch.float32 if stem else torch.bfloat16)
        bound = float(np.sqrt(1.0 / (9 * c_in)))
        w = conv_mod.pack_weight(torch.from_numpy(
            rng.uniform(-bound, bound, (c_out, c_in, 3, 3)).astype(np.float32))).to(dev)
        b = torch.from_numpy(rng.normal(0, 0.1, c_out).astype(np.float32)).to(dev)
        out = torch.empty((BATCH, hw // s, hw // s, c_out), dtype=torch.bfloat16, device=dev)
        ref = conv_mod.conv3x3_plain(x, w, b, stride=s, activation="mish")

        def run(lib, act):
            args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), BATCH, hw, hw, c_in,
                    c_out)
            code = (lib.cyv4_stem_conv3x3(*args, act, stream) if stem
                    else lib.cyv4_conv3x3(*args, s, act, stream))
            if code != 0:
                raise RuntimeError(f"{name}: CUDA error {code}")

        names = [k for k in libs if not (stem and k == "mma_sync")]
        err = {}
        for k in names:
            run(libs[k], ACT_CODES["mish"])
            torch.cuda.synchronize()
            err[k] = "-" if k == "no_epilogue" else f"{bf16_ulps(out, ref):.3f}"
        ms = {k: [] for k in names}
        lin = []
        for order in (names, names[::-1]):
            for k in order:
                ms[k].append(time_ms(lambda: run(libs[k], ACT_CODES["mish"]), REPS))
            lin.append(time_ms(lambda: run(libs["kernel"], ACT_CODES["linear"]), REPS))
        for k in names:
            print(f"[variants] {name} {k} mish ms={ms[k][0]:.4f} {ms[k][1]:.4f} ulps={err[k]}")
        print(f"[variants] {name} kernel linear ms={lin[0]:.4f} {lin[1]:.4f}")
        del x, w, b, out, ref


def _short(entry: str) -> str:
    """`conv3x3_kernel<1, 2, 2>` for the mangled name of a template kernel."""
    m = re.search(r"\d+([A-Za-z]\w*?_kernel)I((?:Li-?\d+E)+)E", entry)
    if not m:
        return entry[:60]
    return f"{m.group(1)}<{', '.join(re.findall(r'Li(-?\d+)E', m.group(2)))}>"


def run_build_times(src: Path) -> None:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    ptxas = str(Path(nvcc).parent / "ptxas")
    ptx = OUT_DIR / f"{src.stem}.ptx"
    t0 = time.perf_counter()  # the PTX that the port's -gencode compute_90a step makes
    subprocess.run([nvcc, "-arch=compute_90a", "-std=c++17", "-O3", "-ptx", "-o", str(ptx),
                    str(src)], check=True)
    t_ptx = time.perf_counter() - t0
    entries = re.findall(r"^\s*(?:\.visible\s+|\.weak\s+)?\.entry\s+([\w$]+)",
                         ptx.read_text(), re.M)
    base = [ptxas, "-arch=sm_90a", "-O3"]
    t0 = time.perf_counter()
    subprocess.run([*base, "-o", str(ptx.with_suffix(".cubin")), str(ptx)], check=True)
    t_all = time.perf_counter() - t0

    def one(i_entry):
        i, entry = i_entry
        t = time.perf_counter()
        subprocess.run([*base, "--entry", entry, "-o", str(OUT_DIR / f"e{i}.cubin"), str(ptx)],
                       check=True)
        return entry, time.perf_counter() - t

    cores = os.cpu_count() or 1
    with concurrent.futures.ThreadPoolExecutor(cores) as pool:
        times = list(pool.map(one, enumerate(entries)))
    print(f"[build-times] {src}: nvcc -ptx {t_ptx:.1f} s; ptxas over all {len(entries)} "
          f"entries {t_all:.1f} s (one process); per entry, one process each, {cores} at a "
          f"time:")
    for entry, t in sorted(times, key=lambda e: -e[1]):
        print(f"[build-times]   {t:6.1f} s  {_short(entry)}")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("conv3x3_variants: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[variants] {smi}")
    args = sys.argv[1:]
    if args[:1] == ["--build-times"]:
        run_build_times(Path(args[1]) if len(args) > 1 else _build.SRC_DIR / "conv3x3.cu")
    else:
        run_variants()


if __name__ == "__main__":
    main()
