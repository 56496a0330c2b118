"""The root `conftest.py` builds the JAX package's native rasterizer in the
session's first process, so that pytest-xdist's workers, which start after
it, find the library whole when they collect `tests/test_native.py`."""

import ctypes
import importlib.util
import os
import shutil
import types

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE = os.path.join(_REPO, "complex_yolov4_tpu", "native")


def _root_conftest():
    spec = importlib.util.spec_from_file_location(
        "_root_conftest", os.path.join(_REPO, "conftest.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _sources(directory):
    for name in ("Makefile", "bev_native.cpp"):
        shutil.copy(os.path.join(_NATIVE, name), directory)
    return directory / "libbev_native.so"


def _config(**attrs):
    manager = types.SimpleNamespace(register=lambda plugin, name: plugin.pytest_unconfigure())
    return types.SimpleNamespace(pluginmanager=manager, **attrs)


def test_the_controller_builds_the_library(tmp_path, monkeypatch):
    root = _root_conftest()
    so = _sources(tmp_path)
    monkeypatch.setattr(root, "_NATIVE", str(tmp_path))
    root.pytest_configure(_config())
    assert so.exists()
    ctypes.CDLL(str(so)).cyv4_rasterize_points  # whole: it loads, and has its symbols
    built = so.stat().st_mtime_ns
    root.pytest_configure(_config())  # built once
    assert so.stat().st_mtime_ns == built


def test_a_worker_builds_nothing(tmp_path, monkeypatch):
    root = _root_conftest()
    so = _sources(tmp_path)
    monkeypatch.setattr(root, "_NATIVE", str(tmp_path))
    root.pytest_configure(_config(workerinput={"workerid": "gw0"}))
    assert not so.exists()


def test_a_failed_build_is_left_to_the_package(tmp_path):
    _root_conftest().build_native(str(tmp_path))  # no Makefile: make fails
    assert not (tmp_path / "libbev_native.so").exists()
