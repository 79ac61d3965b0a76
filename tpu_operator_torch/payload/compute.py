"""The LM payloads' shared compute-path flags (counterpart of
``tpu_operator/payload/compute.py``): ``--remat``, ``--remat-policy`` and
``--optimizer``, with the reference's names and choices.

Remat (activation recomputation in the backward) is not ported yet
(ROADMAP Queue A 1): :func:`lm_block` returns the plain block and raises
on ``--remat``. The flagship fits one H100 without it.
"""

from __future__ import annotations

from typing import Any


def add_lm_compute_flags(parser) -> None:
    """``--remat`` (gate), ``--remat-policy`` and ``--optimizer``."""
    from tpu_operator_torch.payload import models, optimizers

    parser.add_argument(
        "--remat", action="store_true",
        help="rematerialize each block on backward (not ported yet: raises)")
    models.add_remat_policy_flag(parser)
    optimizers.add_optimizer_flag(parser)


def lm_block(args) -> Any:
    """The LM block class, ``models.DecoderBlock``. Raises
    NotImplementedError under ``--remat``."""
    from tpu_operator_torch.payload import models

    if getattr(args, "remat", False):
        raise NotImplementedError(
            "--remat is not ported to the PyTorch payload yet (ROADMAP "
            "Queue A 1: remat policies); run without it")
    return models.DecoderBlock
