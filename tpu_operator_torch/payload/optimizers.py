"""The payload optimizers (counterpart of
``tpu_operator/payload/optimizers.py`` and the ``optax.adam`` the LM
payloads build through it).

:func:`adam` reproduces ``optax.adam`` step for step, a bf16 first moment
(``mu_dtype``) included, as plain tensor code over a parameter list,
updated in place. ``torch.optim.Adam`` is not used: it cannot keep mu in
bf16 beside f32 params. Per step, with count the step number from 1:

- ``mu = (1 - b1) * g + b1 * mu`` in f32 (optax forms it from the stored
  mu: a bf16 mu is scaled by ``b1`` in bf16, then added in f32);
- ``nu = (1 - b2) * g * g + b2 * nu`` in f32;
- ``mu_hat = mu / (1 - b1**count)``, ``nu_hat = nu / (1 - b2**count)``,
  the corrections in f32;
- ``p += -lr * mu_hat / (sqrt(nu_hat) + eps)``;
- then mu is stored cast to ``mu_dtype``.

``adam8`` (the int8 block-quantized moments) is still to port (ROADMAP
Queue A 1): ``--optimizer adam8`` raises.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

LM_OPTIMIZERS = ("adam", "adam8")


@dataclasses.dataclass
class AdamState:
    """Step count and the two moments, one tensor per parameter."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class Adam:
    """``optax.adam(lr, b1, b2, eps, mu_dtype=mu_dtype)`` over a list of
    parameters whose ``.grad`` holds the step's gradient."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, mu_dtype: Optional[torch.dtype] = None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu_dtype = mu_dtype

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        return AdamState(
            count=0,
            mu=[torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                for p in params],
            nu=[torch.zeros_like(p) for p in params])

    def _correction(self, decay: float, count: int) -> float:
        """``1 - decay**count`` in f32, as optax takes it."""
        return float(np.float32(1) - np.float32(decay) ** np.float32(count))

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], state: AdamState) -> None:
        """One update of ``params`` (in place) from their ``.grad``."""
        state.count += 1
        bc1 = self._correction(self.b1, state.count)
        bc2 = self._correction(self.b2, state.count)
        for p, mu, nu in zip(params, state.mu, state.nu):
            g = p.grad
            if g is None:
                raise ValueError("adam: a parameter has no gradient")
            b1 = torch.tensor(self.b1, dtype=mu.dtype, device=mu.device)
            m = g.mul(1 - self.b1).add_(mu.mul(b1))
            nu.mul_(self.b2).add_(g.mul(g).mul_(1 - self.b2))
            update = m.div(bc1).div_(nu.div(bc2).sqrt_().add_(self.eps))
            p.add_(update.mul_(-self.lr))
            mu.copy_(m)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         mu_dtype: Optional[torch.dtype] = None) -> Adam:
    return Adam(lr, b1=b1, b2=b2, eps=eps, mu_dtype=mu_dtype)


def from_args(args) -> Adam:
    """The payload optimizer from parsed CLI args (``--optimizer``,
    ``--adam-mu-dtype``, ``--lr``)."""
    choice = getattr(args, "optimizer", "adam")
    if choice != "adam":
        raise NotImplementedError(
            f"--optimizer {choice} is not ported to the PyTorch payload yet "
            f"(ROADMAP Queue A 1); use adam")
    mu_dtype = (torch.bfloat16
                if getattr(args, "adam_mu_dtype", "f32") == "bf16" else None)
    return adam(args.lr, mu_dtype=mu_dtype)


def add_optimizer_flag(parser) -> None:
    """``--optimizer``, with the LM payloads' choices in the reference
    (adam8 parses, and :func:`from_args` refuses it)."""
    parser.add_argument(
        "--optimizer", choices=LM_OPTIMIZERS, default="adam",
        help="adam (adam8, the int8-moment optimizer, is not ported yet)")
