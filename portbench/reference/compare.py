"""The numbers that decide ``correct``, each worked out from the
program's readings and the reference's.

Training: the worst step's relative loss gap; per leaf the gap between
the two sides' norms of the first gradient and of the change after the
checked steps, measured against the reference's norm of that leaf or of
the median leaf, whichever is larger. Leaves whose reference gradient is
under a thousandth of the median leaf's are left out: Adam moves them by
round-off alone. Serving: the widest gap by which a served token's logit
lies below the reference's best at its position.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

import torch

LEAF_FLOOR = 1e-3  # of the median leaf's reference gradient norm


def counted_leaves(ref_grad: Dict[str, float]) -> List[str]:
    floor = LEAF_FLOOR * statistics.median(ref_grad.values())
    return [n for n, g in ref_grad.items() if g >= floor]


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   names: Sequence[str]) -> float:
    """The gap of the leaf whose norms differ most, each gap over the
    larger of that leaf's reference norm and the median leaf's."""
    median = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30)
               for n in names)


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` / ``ref``: {"losses": [...], "grad": {leaf: norm},
    "delta": {leaf: norm}} -> the compared numbers."""
    names = counted_leaves(ref["grad"])
    grad = worst_leaf_gap(prog["grad"], ref["grad"], names)
    delta = worst_leaf_gap(prog["delta"], ref["delta"], names)
    return {"loss_gap": loss_gap(prog["losses"], ref["losses"]),
            "grad_gap": grad, "delta_gap": delta}


def served_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """Widest gap of ``tokens`` [N] below the best of ``ref_logits``
    [N, vocab] at their positions."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, tokens[:, None].long())[:, 0]
    return float((best - got).max())
