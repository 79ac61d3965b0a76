"""Device selection for the port's entry points.

The port serves on the CUDA device. The CPU is a deliberate choice of the
caller (the parity tests make it), never a silent fallback: without a
card, asking for the default device raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda`` by default; ``device="cpu"`` (or any explicit device) as
    given. Raises RuntimeError when CUDA is asked for (explicitly or by
    default) and ``torch.cuda.is_available()`` is false."""
    dev = torch.device(device if device else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
