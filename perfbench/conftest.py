"""pytest settings of the benchmark's own tests (``perfbench/tests``).

Tests that need a CUDA card carry the ``card`` marker and skip without
one; whether there is a card is decided inside the ``cuda`` fixture,
never while a module is imported.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; run on the chip with "
        "`python -m pytest perfbench/tests -m card -s`")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (marker: card)")
    return "cuda"
