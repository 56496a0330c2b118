"""The port tests' thread cap (`tests/_torch_port_util.py`).

Under pytest-xdist every worker's torch would run an intra-op pool as wide
as the machine; `capped_threads` gives each port test module its share of
the cores, children of the port's tests get theirs through
OMP_NUM_THREADS, and a module of the JAX package's tests that sets its own
count on the same worker does not carry it into the next port module.
"""

import os
import subprocess
import sys
from pathlib import Path

import torch

from tests._torch_port_util import _REPO, capped_threads, child_env, thread_cap  # noqa: F401

_RESETS = '''
import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def every_core():
    torch.set_num_threads(os.cpu_count())  # as test_reference_ab.py's `ref` fixture


def test_reset():
    assert torch.get_num_threads() == os.cpu_count()
'''

_PORT = '''
import os

import torch

from tests._torch_port_util import capped_threads, thread_cap  # noqa: F401


def test_capped():
    assert thread_cap() == max(1, os.cpu_count() // 4)
    assert torch.get_num_threads() == thread_cap()
'''


def test_cap_in_a_port_module():
    assert torch.get_num_threads() == thread_cap()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    assert thread_cap() == max(1, (os.cpu_count() or 1) // workers)


def test_cap_holds_after_a_module_reset(tmp_path):
    """A pytest session as one of four xdist workers would run it: a module
    that sets every core (as `test_reference_ab.py` does), then a port
    module, which must see the cap again."""
    (tmp_path / "test_a_resets.py").write_text(_RESETS)
    (tmp_path / "test_b_port.py").write_text(_PORT)
    env = dict(child_env(), PYTEST_XDIST_WORKER_COUNT="4")
    out = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                          "-p", "no:randomly", "-p", "no:xdist", "--rootdir", str(tmp_path),
                          "test_a_resets.py", "test_b_port.py"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "2 passed" in out.stdout, out.stdout[-3000:]


def test_children_get_the_cap():
    code = "import torch; print(torch.get_num_threads())"
    for children in (1, 2):
        out = subprocess.run([sys.executable, "-c", code], env=child_env(children),
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert int(out.stdout) == max(1, thread_cap() // children)


def test_every_port_test_module_caps_threads():
    files = sorted(Path(_REPO, "tests").glob("test_torch_port_*.py"))
    assert len(files) >= 30
    missing = [f.name for f in files if "capped_threads" not in f.read_text()]
    assert not missing, missing
