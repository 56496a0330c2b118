"""The per-phase time limit of `tests/_time_limit.py`.

The first test checks that the repo's own tests run under it. Each of the
others runs a pytest session under pytest-xdist with one worker and the
limits lowered to 2 s and 4 s. One runs a test stuck in a Python wait (the
alarm fails it), a test stuck with SIGALRM blocked (the backstop ends its
worker) and a test that passes on the worker started after the crash. The
other holds `tests/_torch_port_util.py`'s `wait_workers` to killing the
processes it waits for when the limit stops the wait.
"""

import os
import signal
import subprocess
import sys
import time

from tests import _time_limit

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CONFTEST = '''
import os

from tests import _time_limit

_time_limit.ALARM_S, _time_limit.BACKSTOP_S = 2, 4


def pytest_configure(config):
    config.pluginmanager.register(
        _time_limit.TimeLimit(os.path.dirname(__file__)), "time_limit")
'''

_STUCK = '''
import queue
import signal
import time


def test_python_wait():
    queue.Queue(maxsize=1).get()  # the wait


def test_native_wait():
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
    time.sleep(60)  # the wait


def test_passes():
    pass
'''

_WORKERS = '''
from tests._torch_port_util import start_workers, wait_workers


def test_workers_wait():
    procs = start_workers(["-c", "import time; time.sleep(60)"], lambda r: [])
    with open("pids.txt", "w") as f:
        f.write(" ".join(str(p.pid) for p, _ in procs))
    wait_workers(procs)
'''


def _session(tmp_path, cases):
    """Run `cases` as `test_cases.py` in a session under the lowered limits:
    (the completed process, its seconds)."""
    (tmp_path / "conftest.py").write_text(_CONFTEST)
    (tmp_path / "test_cases.py").write_text(cases)
    env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    start = time.monotonic()
    out = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                          "-p", "no:randomly", "-p", "xdist", "-n", "1",
                          "--rootdir", str(tmp_path), "test_cases.py"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    return out, time.monotonic() - start


def test_the_suite_runs_under_the_limit(request):
    assert request.config.pluginmanager.get_plugin("time_limit") is not None
    left, _ = signal.getitimer(signal.ITIMER_REAL)
    assert _time_limit.ALARM_S - 60 < left <= _time_limit.ALARM_S
    assert signal.getsignal(signal.SIGALRM).__name__ == "expire"


def test_stuck_tests_fail_and_the_run_ends(tmp_path):
    out, seconds = _session(tmp_path, _STUCK)
    log = out.stdout + out.stderr
    assert out.returncode == 1, log[-4000:]
    assert "2 failed, 1 passed" in out.stdout, log[-4000:]
    # the alarm: the limit's error, and the stack naming the wait's line
    assert ("TimeLimitExceeded: test_cases.py::test_python_wait (call) ran past "
            "its time limit of 2 s") in out.stdout, log[-4000:]
    assert 'test_cases.py", line 8 in test_python_wait' in out.stdout, log[-4000:]
    # the backstop: the dump on the session's stderr, the worker crashed
    assert 'test_cases.py", line 13 in test_native_wait' in out.stderr, log[-4000:]
    assert "worker 'gw0' crashed while running 'test_cases.py::test_native_wait'" in log, \
        log[-4000:]
    assert seconds < 60, seconds


def test_the_limit_leaves_no_worker_process(tmp_path):
    out, seconds = _session(tmp_path, _WORKERS)
    log = out.stdout + out.stderr
    assert "1 failed" in out.stdout and "TimeLimitExceeded" in out.stdout, log[-4000:]
    pids = [int(p) for p in (tmp_path / "pids.txt").read_text().split()]
    assert len(pids) == 2
    alive = []
    for pid in pids:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except ProcessLookupError:
            pass
    for pid in alive:  # leave nothing running when the check fails
        os.kill(pid, signal.SIGKILL)
    assert not alive, f"still running after the session: {alive}"
    assert seconds < 60, seconds
