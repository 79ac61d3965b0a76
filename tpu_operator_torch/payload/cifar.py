"""Data-parallel CIFAR-10 ResNet training payload (counterpart of
``tpu_operator/payload/cifar.py``), one process per CUDA card::

    python -m tpu_operator_torch.payload.cifar --steps 500 --batch 1024

ResNet-20 (``models.CifarResNet``: bf16 convolutions, f32 BatchNorm over
the global batch, f32 head) on the synthetic prototype images, or on a
mounted ``.npz`` (``--data``), with sgd + momentum by default and the
shared classifier compute flags (``compute.py``). With P processes each
data rank takes its 1/P of every global batch; the gradients and the
BatchNorm sums are all-reduced, so P processes train the model one
process would.
``--checkpoint-dir`` (or ``$TPU_CHECKPOINT_DIR``) checkpoints params,
optimizer state and BatchNorm statistics, and a restarted attempt
resumes (``checkpoint.py``). ``--device cpu`` runs the plain PyTorch path.
``--profile-dir`` (or ``$TPU_PROFILE_DIR``) writes a ``torch.profiler``
trace of steps 11-20 of the run. ``--aot`` routes the run through the
overlapped prologue with the kernel library as its COMPILE work (built or
loaded through the compilation cache on the card): the classifier
launches none of the port's kernels, so it only warms or checks the cache
for the job's other payloads; without it the classifier has no COMPILE
stage.

``--model-parallel N`` adds tensor parallelism over N model shards, the
reference's ``param_partition_spec``: the stage-2 convs split by output
channel and the head by class (``models.CifarResNet``), everything else
whole on every process. The shards spread over the processes of a model
group (:func:`make_cifar_mesh`: P = min(world, N) adjacent ranks, N / P
shards a process run as units one after another); the model group shares
its data rank's rows, and the gradients and the BatchNorm sums reduce over
the processes that hold the same model rank. N must divide the classes
and the stage-2 width. Checkpoints hold whole arrays, so a step saved at
one N restores at another.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Any, Callable, Iterator, NamedTuple, Optional, Tuple

import torch

from tpu_operator_torch.device import resolve_device
from tpu_operator_torch.payload import autotune
from tpu_operator_torch.payload import bootstrap
from tpu_operator_torch.payload import checkpoint
from tpu_operator_torch.payload import collectives
from tpu_operator_torch.payload import compute
from tpu_operator_torch.payload import data as data_mod
from tpu_operator_torch.payload import train
from tpu_operator_torch.payload import transformer
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
                   help="tensor-parallel shards (N; they spread over the "
                        "job's processes, N / P per process): the stage-2 "
                        "convs and the head split; N divides the classes "
                        "and the stage-2 width")
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
                   help="torch.profiler trace dir (default "
                        "$TPU_PROFILE_DIR): a trace of steps 11-20 of the "
                        "run")
    autotune.add_prefetch_argument(p)
    compute.add_classifier_compute_flags(p)
    p.add_argument("--device", default="",
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    return p.parse_args(argv)


class CifarMesh(NamedTuple):
    """The (data, model) layout of the job's processes, the reference's
    ``train.make_mesh`` with the model axis innermost: ``world``
    processes, ``model_procs`` (P) per model group sharing
    ``model_shards`` (N) shards, ``data`` = world / P data ranks; rank =
    data_rank·P + model_rank. The groups are this process's (None without
    a process group or with one process in them): ``model_group`` (its
    model group) and ``replica_group`` (every process with its model
    rank: the gradient reduce and the BatchNorm sums)."""

    world: int
    rank: int
    model_procs: int = 1
    model_shards: int = 1
    model_group: Any = None
    replica_group: Any = None

    @property
    def data(self) -> int:
        return self.world // self.model_procs

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_procs

    def tp(self) -> collectives.TPShards:
        return collectives.TPShards(self.model_shards, self.model_procs,
                                    self.rank % self.model_procs,
                                    self.model_group)

    def data_group(self) -> Any:
        """The process group of this process's data ranks (BatchNorm's
        sums): None with one data rank, the replica group under tensor
        parallelism, else the whole process group."""
        import torch.distributed as dist

        if self.data == 1:
            return None
        return self.replica_group if self.model_procs > 1 \
            else dist.group.WORLD


def make_cifar_mesh(world: Optional[int] = None, rank: Optional[int] = None,
                    model_parallel: int = 1,
                    num_slices: int = 1) -> CifarMesh:
    """The (data, model) mesh over the job's processes (default: the
    process group, or one process without one): P = min(world, N)
    processes per model group, N split over P and the world over P; with
    ``num_slices`` > 1 each model group must fit inside one slice
    (:func:`collectives.check_slices`). With a process group, every
    process creates every model and replica group (``dist.new_group`` is
    collective) and keeps its own."""
    import torch.distributed as dist

    grouped = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if grouped else 1
    if rank is None:
        rank = dist.get_rank() if grouped else 0
    if model_parallel < 1:
        raise ValueError(f"--model-parallel must be >= 1, got "
                         f"{model_parallel}")
    procs = min(world, model_parallel)
    if model_parallel % procs or world % procs:
        raise ValueError(f"--model-parallel {model_parallel} does not lay "
                         f"out over {world} processes")
    collectives.check_slices(world, procs, "model", num_slices)
    mesh = CifarMesh(world, rank, procs, model_parallel)
    if not grouped or procs == 1:
        return mesh
    return mesh._replace(
        model_group=collectives.own_group(rank, (
            list(range(first, first + procs))
            for first in range(0, world, procs))),
        replica_group=collectives.own_group(rank, (
            list(range(m, world, procs)) for m in range(procs))))


class Built(NamedTuple):
    model: CifarResNet
    optimizer: Any
    opt_state: Any
    step: Callable[[torch.Tensor, torch.Tensor], train.Metrics]
    batches: Iterator[Tuple]
    device: torch.device
    mesh: CifarMesh = CifarMesh(1, 0)

    @property
    def state(self) -> checkpoint.TrainState:
        """Params, optimizer state and BatchNorm statistics, updated in
        place by the step: what a checkpoint saves and restores. With the
        model group over several processes, the split params, their
        momentum traces or moments and the split statistics are named as
        such (:func:`tp_shards`): a checkpoint holds whole arrays."""
        return checkpoint.TrainState(dict(self.model.named_parameters()),
                                     self.opt_state,
                                     dict(self.model.named_buffers()),
                                     shards=tp_shards(self.model,
                                                      self.opt_state))


def tp_shards(model: CifarResNet, opt_state
              ) -> Optional[checkpoint.Shards]:
    """``transformer.tp_shards`` (the split params and their optimizer
    state; adam8's block moments refused) plus the split BatchNorm
    statistics; None unless the model group holds more than one
    process."""
    shards = transformer.tp_shards(model, opt_state)
    if shards is None:
        return None
    return shards._replace(names={**shards.names,
                                  checkpoint.STATS_FILE: model.tp_dims()})


def build(args, device=None, mesh: Optional[CifarMesh] = None,
          num_slices: int = 1) -> Built:
    """Model (seeded init), optimizer, step and this process's host
    batches for the flags. ``device`` defaults to ``--device`` (CUDA
    unless it says ``cpu``); ``mesh`` to the (data, model) mesh of the
    job's process group at ``--model-parallel`` over ``num_slices``
    slices."""
    options = compute.classifier_step_options(args)
    mesh = mesh or make_cifar_mesh(model_parallel=args.model_parallel,
                                   num_slices=num_slices)
    if mesh.model_shards != args.model_parallel:
        raise ValueError(f"mesh has {mesh.model_shards} model shards, "
                         f"--model-parallel is {args.model_parallel}")
    if args.batch % mesh.data:
        raise ValueError(f"--batch {args.batch} must split over "
                         f"{mesh.data} data ranks")
    dev = resolve_device(device if device is not None
                         else (args.device or None))
    if dev.type == "cuda":
        # A resumed run is bit-equal to an unbroken one only if every
        # convolution's algorithm is deterministic.
        torch.backends.cudnn.deterministic = True
    model = CifarResNet(blocks_per_stage=args.blocks,
                        widths=tuple(args.widths),
                        scan_blocks=getattr(args, "scan_blocks", False),
                        device=dev, tp=mesh.tp(),
                        data_group=mesh.data_group())
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(args.seed))
    model.init_weights(gen)
    optimizer = compute.make_optimizer(args, default="sgd")
    opt_state = optimizer.init(list(model.parameters()))
    reduce = None
    if mesh.world > 1:
        def reduce(ps, metrics):
            return train.all_reduce_grads(ps, metrics, mesh.data,
                                          group=mesh.replica_group)

    step = train.make_classifier_train_step(model, optimizer, opt_state,
                                            reduce=reduce, **options)
    if getattr(args, "data", ""):
        stream = data_mod.npz_classification(
            args.data, args.seed, args.batch, num_classes=model.num_classes,
            image_shape=data_mod.CIFAR_SHAPE)
    else:
        stream = data_mod.synthetic_cifar(args.seed, args.batch)
    return Built(model, optimizer, opt_state, step,
                 data_mod.data_rank_rows(stream, mesh.data_rank, mesh.data),
                 dev, mesh)


def run(info: bootstrap.ProcessInfo, args=None) -> dict:
    args = args or parse_args([])
    built = build(args, num_slices=info.num_slices)
    mesh = built.mesh
    log.info("mesh: {'data': %d, 'model': %d} over %d processes (%d "
             "tensor-parallel shards a process); training CIFAR ResNet (%d "
             "params on this process) on %s; global batch %d", mesh.data,
             mesh.model_procs, mesh.world,
             mesh.model_shards // mesh.model_procs,
             sum(p.numel() for p in built.model.parameters()), built.device,
             args.batch)
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
            prefetch=autotune.resolve_prefetch_depth(args.prefetch_depth),
            checkpointer=ckpt, state=built.state,
            profile_dir=args.profile_dir,
            compile_fn=(train.kernel_loader(built.device) if args.aot
                        else None))
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
