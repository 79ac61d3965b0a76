"""The benchmark's own tests: on the CPU at tiny widths (the cells' CPU
forms), and, marked ``cuda``, at the cells' sizes on the card."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """Skip unless a CUDA card is there (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
