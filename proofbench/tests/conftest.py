"""proofbench's own tests: CPU tests at tiny sizes, and tests marked
``cuda`` that need the card (they skip here; on the card run
``python -m pytest proofbench/tests -q -m cuda``)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())
