"""A time limit on every test phase (setup, call, teardown) of the tests under
one directory, so that a test stuck in a wait fails and the run goes on to
its end. The repo's root `conftest.py` registers it for `tests/`.

Two clocks are armed when a phase starts and disarmed when it ends:

- at `ALARM_S`, SIGALRM's handler writes every thread's stack to stderr and
  raises `TimeLimitExceeded` in the main thread, where pytest and
  pytest-xdist's workers run tests. That breaks any wait in Python (a
  `queue.Queue.get`, a `join`, a lock) and fails the test in that phase;
- at `BACKSTOP_S`, faulthandler's watchdog thread writes every thread's stack
  to the stderr the session started with and ends the process. It covers a
  wait in native code that never returns to the interpreter, so the handler
  never runs. Under pytest-xdist the controller reports the test as failed
  by a crashed worker and starts a new worker for the tests after it.

Both values are constants, not options. `ALARM_S` is about 3.5 times the
slowest test of a whole run with six workers on eight cores (78 s), and
above the longest wait a test bounds itself (`tests/test_multiprocess.py`
gives its workers 240 s), so that such a test's own clean-up, which kills
its workers, runs first. `BACKSTOP_S` leaves the alarm's exception a minute
to unwind.

faulthandler keeps one timer a process, and the backstop re-arms it each
phase: pytest's `-o faulthandler_timeout=N` has no effect on the tests this
plugin bounds; the backstop's dump takes its place.
"""

import faulthandler
import os
import signal
import sys
from pathlib import Path

import pytest

ALARM_S = 270
BACKSTOP_S = 330


class TimeLimitExceeded(Exception):
    """A test phase ran past `ALARM_S`."""


class TimeLimit:
    """The pytest plugin that bounds each phase of the tests under `root`."""

    def __init__(self, root):
        self._root = Path(root).resolve()
        # The backstop writes to a copy of the session's first stderr: under
        # pytest's fd capture a dump into the captured stderr dies with the
        # process.
        self._stderr_fd = os.dup(sys.stderr.fileno())

    def pytest_unconfigure(self):
        os.close(self._stderr_fd)

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_setup(self, item):
        return (yield from self._bounded(item, "setup"))

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_call(self, item):
        return (yield from self._bounded(item, "call"))

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_teardown(self, item):
        return (yield from self._bounded(item, "teardown"))

    def _bounded(self, item, phase):
        if not item.path.resolve().is_relative_to(self._root):
            return (yield)

        def expire(signum, frame):
            faulthandler.dump_traceback(sys.stderr, all_threads=True)
            raise TimeLimitExceeded(
                f"{item.nodeid} ({phase}) ran past its time limit of {ALARM_S} s")

        previous = signal.signal(signal.SIGALRM, expire)  # raises off the main thread
        signal.setitimer(signal.ITIMER_REAL, ALARM_S)
        faulthandler.dump_traceback_later(BACKSTOP_S, exit=True, file=self._stderr_fd)
        try:
            return (yield)
        finally:
            faulthandler.cancel_dump_traceback_later()
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, previous)
