"""pytest settings of the benchmark's own tests (``benchmark/tests``).

Tests that need the card carry the ``cuda`` marker and take the ``card``
fixture, which decides at run time, never at collection, whether there is
a CUDA device, and skips with the reason where there is none.  Run them
on the GPU with ``python3 -m pytest benchmark/tests -m cuda -q``.
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips with a reason where "
                   "there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark's cells run only "
                    "on the GPU")
    return torch.device("cuda")
