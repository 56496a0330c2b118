"""Two things the whole test run needs, set up once a session:

- every test phase under `tests/` runs under `tests/_time_limit.py`'s limit:
  a stuck test fails with every thread's stack, and the run goes on;
- the JAX package's native rasterizer is built before pytest-xdist starts
  its workers. Each worker collecting `tests/test_native.py` would otherwise
  run that package's `make` at the same time, and one can load the library
  while another is still writing it ("file too short"): a collection error
  that ends the whole run.
"""

import os
import subprocess

from tests._time_limit import TimeLimit

_REPO = os.path.dirname(os.path.abspath(__file__))
_TESTS = os.path.join(_REPO, "tests")
_NATIVE = os.path.join(_REPO, "complex_yolov4_tpu", "native")


def build_native(directory):
    """Run `make` in `directory` unless its `libbev_native.so` is there. A
    failed build is left to the package, which falls back to numpy."""
    if os.path.exists(os.path.join(directory, "libbev_native.so")):
        return
    try:
        subprocess.run(["make", "-C", directory], capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        pass


def pytest_configure(config):
    if not hasattr(config, "workerinput"):  # the controller, before any worker
        build_native(_NATIVE)
    config.pluginmanager.register(TimeLimit(_TESTS), "time_limit")
