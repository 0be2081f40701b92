"""The benchmark's own tests: on the CPU, and with the `gpu` marker on the
card (skipped where there is none, decided in the `card` fixture).

    python3 -m pytest benchmark/tests -q -p no:cacheprovider
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped where there is none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")
