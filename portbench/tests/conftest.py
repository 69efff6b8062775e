"""The benchmark's own tests: on the CPU at small sizes, except those
marked `cuda`, which skip where there is no card (decided in the fixture,
never while a module is imported)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips elsewhere")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda")
