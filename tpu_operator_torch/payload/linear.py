"""Distributed linear regression payload (counterpart of
``tpu_operator/payload/linear.py``), the smallest end-to-end payload::

    python -m tpu_operator_torch.payload.linear --steps 200

The exit code follows the operator's contract (``bootstrap.run_payload``):
0 on convergence (final MSE at or below ``--target-loss``), 1 otherwise or
on any error, 143 on SIGTERM. ``--device cpu`` runs on the CPU;
``--profile-dir`` (or ``$TPU_PROFILE_DIR``) writes a ``torch.profiler``
trace of steps 11-20 of the run.
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from tpu_operator_torch.device import resolve_device
from tpu_operator_torch.payload import autotune
from tpu_operator_torch.payload import bootstrap
from tpu_operator_torch.payload import compute
from tpu_operator_torch.payload import data as data_mod
from tpu_operator_torch.payload import optimizers
from tpu_operator_torch.payload import train
from tpu_operator_torch.payload.models import LinearRegressor

log = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--dim", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--target-loss", type=float, default=1e-3,
                   help="exit nonzero unless the final MSE is at or below "
                        "this")
    autotune.add_prefetch_argument(p)
    optimizers.add_optimizer_flag(
        p, choices=optimizers.CLASSIFIER_OPTIMIZERS, default="sgd")
    p.add_argument("--profile-dir",
                   default=os.environ.get("TPU_PROFILE_DIR", ""),
                   help="torch.profiler trace dir (default "
                        "$TPU_PROFILE_DIR): a trace of steps 11-20 of the "
                        "run")
    p.add_argument("--device", default="",
                   help="torch device (default: cuda; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


def run(info: bootstrap.ProcessInfo, args=None) -> float:
    args = args or parse_args([])
    dev = resolve_device(args.device or None)
    world, rank = bootstrap.world_size(), bootstrap.rank()
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(args.seed))
    model = LinearRegressor(args.dim, device=dev).init_weights(gen)
    optimizer = compute.make_optimizer(args, default="sgd")
    opt_state = optimizer.init(list(model.parameters()))
    reduce = None
    if world > 1:
        def reduce(ps, metrics):
            return train.all_reduce_grads(ps, metrics, world)

    step = train.make_regression_train_step(model, optimizer, opt_state,
                                            reduce=reduce)
    batches = data_mod.data_rank_rows(
        data_mod.synthetic_linear(args.seed, args.batch, args.dim), rank,
        world)
    metrics = train.train_loop(
        step, batches, args.steps, device=dev,
        log_every=max(1, args.steps // 10),
        log_fn=lambda i, m: log.info("step %d loss %.6f", i, m["loss"]),
        prefetch=autotune.resolve_prefetch_depth(args.prefetch_depth),
        profile_dir=args.profile_dir)
    loss = float(metrics["loss"])
    log.info("final loss %.6f over %d process(es) on %s", loss, world, dev)
    if loss > args.target_loss:
        raise RuntimeError(f"did not converge: loss {loss} > "
                           f"{args.target_loss}")
    return loss


def main() -> None:
    args = parse_args()
    bootstrap.main_wrapper(lambda info: run(info, args),
                           device=args.device or None)


if __name__ == "__main__":
    main()
