"""Nothing the benchmark runs imports JAX or the JAX package, and the
yardstick (reference/, frozen/) imports nothing of the port. Top-level
module names are compared whole: the port's name begins with the JAX
package's."""

import ast
import subprocess
import sys

import pytest

from port_bench import harness

SOURCES = sorted(p for p in harness.HERE.rglob("*.py") if "tests" not in p.parts)
YARDSTICK = [p for p in SOURCES if {"reference", "frozen"} & set(p.parts)]


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_jax(path):
    assert not imported_tops(path) & set(harness.FORBIDDEN_MODULES)


@pytest.mark.parametrize("path", YARDSTICK, ids=lambda p: str(p.relative_to(harness.HERE)))
def test_yardstick_imports_nothing_of_the_port(path):
    assert "complex_yolov4_tpu_torch" not in imported_tops(path)
    assert not imported_tops(path) & set(harness.FORBIDDEN_MODULES)


def test_a_run_loads_no_jax():
    """Every module of the benchmark and every port module its generators
    import, loaded in a fresh process: nothing of JAX comes with them."""
    mods = ["port_bench." + ".".join(p.relative_to(harness.HERE).with_suffix("").parts)
            for p in SOURCES if p.name != "__init__.py" and "metrics" not in p.parts]
    mods += ["complex_yolov4_tpu_torch.evaluation.evaluator",
             "complex_yolov4_tpu_torch.models.quantize", "complex_yolov4_tpu_torch.models.zoo",
             "complex_yolov4_tpu_torch.models.weights", "complex_yolov4_tpu_torch.data.bev",
             "complex_yolov4_tpu_torch.ops.nms"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from port_bench import harness\n"
            "print(harness.forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
