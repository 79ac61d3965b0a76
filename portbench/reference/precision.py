"""The control's precision: the reference's dense products with their
inputs rounded to 8-bit floats, the step below the bfloat16 compute that
the configurations state.

Each input is scaled per tensor so that its largest magnitude lands on the
format's largest finite value, rounded to float8 e4m3 and scaled back; in
the backward the incoming gradient is rounded alike to e5m2 (the usual
split of 8-bit training) and passed straight through the rounding.
"""

from __future__ import annotations

import torch

E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2


def _round(x: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    top = torch.finfo(fmt).max
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return ((x.float() * scale).to(fmt).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, E4M3)

    @staticmethod
    def backward(ctx, g):
        return _round(g, E5M2)


def fp8(x: torch.Tensor, _is_weight: bool = False) -> torch.Tensor:
    """``x`` as an 8-bit float product would read it."""
    return _Fp8.apply(x)
