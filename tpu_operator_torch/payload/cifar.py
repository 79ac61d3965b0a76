"""Data-parallel CIFAR-10 ResNet training payload (counterpart of
``tpu_operator/payload/cifar.py``), one process per CUDA card::

    python -m tpu_operator_torch.payload.cifar --steps 500 --batch 1024

ResNet-20 (``models.CifarResNet``: bf16 convolutions, f32 BatchNorm over
the global batch, f32 head) on the synthetic prototype images, or on a
mounted ``.npz`` (``--data``), with sgd + momentum by default and the
shared classifier compute flags (``compute.py``). With P processes each
takes its 1/P of every global batch; the gradients and the BatchNorm sums
are all-reduced, so P processes train the model one process would.
``--checkpoint-dir`` (or ``$TPU_CHECKPOINT_DIR``) checkpoints params,
optimizer state and BatchNorm statistics, and a restarted attempt
resumes (``checkpoint.py``). ``--device cpu`` runs the plain PyTorch path.

``--model-parallel`` > 1 (ROADMAP Queue A 7), ``--profile-dir`` (A9) and
``--aot`` (A3) raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Any, Callable, Iterator, NamedTuple, Tuple

import torch

from tpu_operator_torch.device import resolve_device
from tpu_operator_torch.payload import bootstrap
from tpu_operator_torch.payload import checkpoint
from tpu_operator_torch.payload import compute
from tpu_operator_torch.payload import data as data_mod
from tpu_operator_torch.payload import train
from tpu_operator_torch.payload.models import CifarResNet

log = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--batch", type=int, default=1024,
                   help="global batch size")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--blocks", type=int, default=3,
                   help="blocks per stage (3 -> ResNet-20)")
    p.add_argument("--widths", type=int, nargs=3, default=(16, 32, 64))
    p.add_argument("--model-parallel", type=int, default=1,
                   help="tensor-parallel shards (not ported: must be 1)")
    p.add_argument("--data", default=os.environ.get("TPU_DATA_PATH", ""),
                   help=".npz dataset (images [N,32,32,3], labels [N]) on a "
                        "mounted volume; default synthetic (or "
                        "$TPU_DATA_PATH)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--checkpoint-dir",
                   default=os.environ.get("TPU_CHECKPOINT_DIR", ""),
                   help="checkpoint/resume dir (default "
                        "$TPU_CHECKPOINT_DIR; empty = no checkpoints)")
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.add_argument("--profile-dir",
                   default=os.environ.get("TPU_PROFILE_DIR", ""),
                   help="profiler trace dir (not ported: a non-empty value "
                        "raises)")
    data_mod.add_prefetch_argument(p)
    compute.add_classifier_compute_flags(p)
    p.add_argument("--device", default="",
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    return p.parse_args(argv)


def check_ported(args) -> None:
    if getattr(args, "model_parallel", 1) != 1:
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel} is not ported to the "
            f"PyTorch payload yet (ROADMAP Queue A 7); leave it at 1")
    if getattr(args, "profile_dir", ""):
        raise NotImplementedError(
            "--profile-dir is not ported to the PyTorch payload yet (ROADMAP "
            "Queue A 9); leave it empty")


class Built(NamedTuple):
    model: CifarResNet
    optimizer: Any
    opt_state: Any
    step: Callable[[torch.Tensor, torch.Tensor], train.Metrics]
    batches: Iterator[Tuple]
    device: torch.device

    @property
    def state(self) -> checkpoint.TrainState:
        """Params, optimizer state and BatchNorm statistics, updated in
        place by the step: what a checkpoint saves and restores."""
        return checkpoint.TrainState(dict(self.model.named_parameters()),
                                     self.opt_state,
                                     dict(self.model.named_buffers()))


def build(args, device=None) -> Built:
    """Model (seeded init), optimizer, step and this process's host
    batches for the flags. ``device`` defaults to ``--device`` (CUDA
    unless it says ``cpu``). Every process of the job's group is a data
    rank."""
    check_ported(args)
    options = compute.classifier_step_options(args)
    world, rank = bootstrap.world_size(), bootstrap.rank()
    if args.batch % world:
        raise ValueError(f"--batch {args.batch} must split over {world} "
                         f"processes")
    dev = resolve_device(device if device is not None
                         else (args.device or None))
    if dev.type == "cuda":
        # A resumed run is bit-equal to an unbroken one only if every
        # convolution's algorithm is deterministic.
        torch.backends.cudnn.deterministic = True
    model = CifarResNet(blocks_per_stage=args.blocks,
                        widths=tuple(args.widths),
                        scan_blocks=getattr(args, "scan_blocks", False),
                        device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(args.seed))
    model.init_weights(gen)
    optimizer = compute.make_optimizer(args, default="sgd")
    opt_state = optimizer.init(list(model.parameters()))
    reduce = None
    if world > 1:
        def reduce(ps, metrics):
            return train.all_reduce_grads(ps, metrics, world)

    step = train.make_classifier_train_step(model, optimizer, opt_state,
                                            reduce=reduce, **options)
    if getattr(args, "data", ""):
        stream = data_mod.npz_classification(
            args.data, args.seed, args.batch, num_classes=model.num_classes,
            image_shape=data_mod.CIFAR_SHAPE)
    else:
        stream = data_mod.synthetic_cifar(args.seed, args.batch)
    return Built(model, optimizer, opt_state, step,
                 data_mod.data_rank_rows(stream, rank, world), dev)


def run(info: bootstrap.ProcessInfo, args=None) -> dict:
    args = args or parse_args([])
    built = build(args)
    log.info("training CIFAR ResNet (%d params) on %s over %d process(es); "
             "global batch %d", sum(p.numel() for p in
                                    built.model.parameters()),
             built.device, bootstrap.world_size(), args.batch)
    ckpt = checkpoint.from_env_or_args(args.checkpoint_dir,
                                       save_every=args.checkpoint_every)
    if ckpt is not None and ckpt.latest_step() is not None:
        log.info("attempt %d: resuming from %s (latest step: %d)",
                 info.attempt, ckpt.directory, ckpt.latest_step())
    try:
        metrics = train.train_loop(
            built.step, built.batches, args.steps, device=built.device,
            log_every=args.log_every,
            log_fn=lambda i, m: log.info("step %d loss %.4f acc %.3f", i,
                                         m["loss"], m["accuracy"]),
            prefetch=data_mod.prefetch_depth(args), checkpointer=ckpt,
            state=built.state)
    finally:
        if ckpt is not None:
            ckpt.close()
    log.info("final: loss %.4f accuracy %.3f",
             metrics.get("loss", float("nan")),
             metrics.get("accuracy", float("nan")))
    return metrics


def main() -> None:
    args = parse_args()
    bootstrap.main_wrapper(lambda info: run(info, args),
                           device=args.device or None)


if __name__ == "__main__":
    main()
