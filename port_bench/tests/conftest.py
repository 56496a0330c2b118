"""The benchmark's own tests (`python -m pytest port_bench/tests`, from the
root of the repository). Tests marked `gpu` need a CUDA card and skip
without one; whether there is one is decided inside the fixture."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
