"""The benchmark's own tests, run on the CPU (`python -m pytest perfbench/tests`).
Tests marked `card` need an NVIDIA card; they decide inside the `card`
fixture, never at import, and skip with a reason where there is none
(`python -m pytest perfbench/tests -m card` on the card)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)
