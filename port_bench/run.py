"""Run one cell of the port's benchmark once on a CUDA card.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Prints one JSON line as the last line of
stdout: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics with --trace 0, its per-layer metrics with --trace 1), `device`,
with --trace 1 `breakdown`, and last `checks`, each compared number with
its limit (also the last lines of stderr). Exits non-zero, printing no
result, without a CUDA card, when the cell cannot be resolved, or when
JAX or the JAX package was loaded. `setup_s` counts from the start of this
script to the first timed request.
"""

from __future__ import annotations

import time

T_BEGIN = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout (the port builds its
    own kernels into `complex_yolov4_tpu_torch/build/` there)."""
    base = ROOT / "port_bench" / ".cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench import harness

    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
        print(f"port_bench: needs {cell.entry['chips']} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    # one process, few threads: the host's share of a request is Python
    # dispatch, and idle intra-op threads only add noise beside it
    torch.set_num_threads(2)
    result, numbers, checked = cell.generator().run(
        torch, cell, args.seed, args.seconds, bool(args.trace), T_BEGIN)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"port_bench: the run loaded {loaded}: the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    checks = harness.judge(numbers, cell.workload["limits"])
    ok = all(c["ok"] for c in checks.values())
    result = {"correct": ok, "attempted": result.pop("attempted"),
              "failed": 0 if ok else checked, **result}
    harness.print_result(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
