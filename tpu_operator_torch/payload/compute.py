"""The payloads' shared compute-path flags (counterpart of
``tpu_operator/payload/compute.py``), with the reference's names, choices
and defaults:

- the LM payloads: ``--remat`` (gate), ``--remat-policy`` and
  ``--optimizer adam|adam8``; :func:`lm_block` is the block class
  (``models.remat_block`` under ``--remat``);
- the classifier payloads: ``--remat-policy`` (``full``, the default, is
  the off position: anything else checkpoints the step's forward),
  ``--optimizer sgd|adam|adam8`` (sgd by default), ``--fused-loss``,
  ``--scan-blocks`` and ``--aot``.

Every default reproduces the plain path.
"""

from __future__ import annotations

from typing import Any

from tpu_operator_torch.payload import models, optimizers


def add_lm_compute_flags(parser) -> None:
    """``--remat`` (gate), ``--remat-policy`` and ``--optimizer``."""
    parser.add_argument(
        "--remat", action="store_true",
        help="rematerialize each block on backward (torch.utils.checkpoint "
             "with the --remat-policy policy): activation memory O(layers) "
             "-> O(1) blocks")
    models.add_remat_policy_flag(parser)
    optimizers.add_optimizer_flag(parser)


def lm_block(args) -> Any:
    """The LM block class: :class:`models.DecoderBlock`, or under
    ``--remat`` :func:`models.remat_block` of ``--remat-policy`` (the same
    params and results; the backward recomputes what the policy does not
    save)."""
    if getattr(args, "remat", False):
        return models.remat_block(getattr(args, "remat_policy", "full"))
    return models.DecoderBlock


def add_classifier_compute_flags(parser) -> None:
    """The classifier payloads' compute flags. No ``--remat`` gate:
    ``--remat-policy full`` (the default) is the off position."""
    models.add_remat_policy_flag(parser)
    optimizers.add_optimizer_flag(
        parser, choices=optimizers.CLASSIFIER_OPTIMIZERS, default="sgd")
    parser.add_argument(
        "--fused-loss", action="store_true",
        help="cross-entropy as logsumexp minus the target logit (no f32 "
             "[B, classes] log-prob tensor); equal to summation order")
    parser.add_argument(
        "--scan-blocks", action="store_true",
        help="the reference's scanned param tree (each stage's stride-1 "
             "blocks stacked); the port keeps one module per block and "
             "maps the tree. Checkpoints do not resume across this flip")
    parser.add_argument(
        "--aot", action="store_true",
        help="run the overlapped prologue with the kernel library as its "
             "COMPILE work (built or loaded through the compilation cache "
             "on the card; the classifier launches none of its kernels)")


def classifier_step_options(args) -> dict:
    """kwargs of ``train.make_classifier_train_step`` from parsed flags."""
    return {"remat_policy": getattr(args, "remat_policy", "full"),
            "fused_loss": bool(getattr(args, "fused_loss", False))}


def make_optimizer(args, default: str = "sgd"):
    """The classifier payloads' optimizer: :func:`optimizers.from_args`
    with sgd as the default."""
    return optimizers.from_args(args, default=default)
