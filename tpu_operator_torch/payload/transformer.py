"""Transformer LM training payload, one process per CUDA card
(counterpart of ``tpu_operator/payload/transformer.py``).

    python -m tpu_operator_torch.payload.transformer --steps 6 --batch 32 \\
        --seq-len 2048 --grad-accum 4 --adam-mu-dtype bf16 --vocab 32768 \\
        --dim 2048 --heads 16 --kv-heads 4 --layers 8

trains the flagship GQA LM (``bench.py:636`` ``lm_flagship_gqa_kv4``) on
the synthetic recurrence; ``--device cpu`` with small widths runs the
plain PyTorch path. The numerics follow the reference: f32 master params,
bf16 compute (``models.py``), the differentiable flash attention (the
forward and backward kernels on the card), the f32 next-token loss, and
adam with an optional bf16 first moment or adam8 (``optimizers.py``).

``--remat [--remat-policy P]`` recomputes each block in the backward under
the policy's selective checkpoint (``models.remat_block``);
``--loss-chunk C`` runs the ``lm_head`` product and the loss in chunks of
C tokens (``train.chunked_next_token_nll``). The long-context row
(``bench.py:675`` ``lm_longctx_T32768_gqa``) takes both, with adam8.

``--seq-parallel N [--sp-layout striped]`` shards the sequence into N
ring shards (``ring_attention.py``: the merge kernel forward, the backward
kernels in a backward ring) over the processes of the job's group
(:func:`make_lm_mesh`): with P processes per seq group each holds N / P
consecutive shards, so one process runs the whole ring and four processes
one shard each. The step takes the reference's striped step for both
layouts (the identity permutation for contiguous).

``--checkpoint-dir`` (or ``$TPU_CHECKPOINT_DIR``) checkpoints every
``--checkpoint-every`` steps, at a drain and at the end, and a restarted
attempt resumes from the newest verified step (``checkpoint.py``).

The flags of the reference that are not ported yet (tensor parallelism,
Ulysses, FSDP, profiling) parse with the reference's defaults and raise
NotImplementedError when set away from them; ROADMAP Queue A lists them.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Any, Callable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpu_operator_torch.device import resolve_device
from tpu_operator_torch.payload import bootstrap
from tpu_operator_torch.payload import checkpoint
from tpu_operator_torch.payload import compute
from tpu_operator_torch.payload import data as data_mod
from tpu_operator_torch.payload import flash_attention as fa
from tpu_operator_torch.payload import optimizers
from tpu_operator_torch.payload import ring_attention as ring_mod
from tpu_operator_torch.payload import train
from tpu_operator_torch.payload.models import TransformerLM

log = logging.getLogger(__name__)

prefetch_depth = data_mod.prefetch_depth


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=8, help="global batch size")
    p.add_argument("--seq-len", type=int, default=2048,
                   help="global sequence length")
    p.add_argument("--seq-parallel", type=int, default=1,
                   help="sequence-parallel ring shards (N); they spread over "
                        "the job's processes, N / P per process")
    p.add_argument("--tensor-parallel", type=int, default=1,
                   help="tensor-parallel shards (not ported: must be 1)")
    p.add_argument("--split-qkv", choices=("auto", "on", "off"),
                   default="auto",
                   help="q/k/v projection layout (not ported: auto, which "
                        "splits under GQA and fuses otherwise)")
    p.add_argument("--sp-mode", choices=("ring", "ulysses"), default="ring",
                   help="sequence-parallel strategy (ulysses not ported)")
    p.add_argument("--sp-layout", choices=("contiguous", "striped"),
                   default="contiguous",
                   help="how the ring shards the sequence: contiguous = "
                        "shard r holds positions [rC, (r+1)C); striped = "
                        "shard r holds positions r, r+N, r+2N, ... (balances "
                        "the causal work)")
    compute.add_lm_compute_flags(p)
    p.add_argument("--grad-accum", type=int, default=1,
                   help="accumulate gradients over K sequential "
                        "microbatches (activation-memory knob; the "
                        "optimizer sees the full-batch gradient)")
    p.add_argument("--loss-chunk", type=int, default=0,
                   help="compute the lm_head product + loss in sequence "
                        "chunks of this many tokens, each recomputed in the "
                        "backward: the [B, T, vocab] logits never exist "
                        "whole. 0 = off. Must divide --seq-len; "
                        "--seq-parallel 1 only")
    p.add_argument("--fsdp", action="store_true",
                   help="param and optimizer sharding (not ported)")
    p.add_argument("--adam-mu-dtype", choices=("f32", "bf16"), default="f32",
                   help="dtype of adam's first moment")
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--kv-heads", type=int, default=0,
                   help="grouped-query attention K/V heads (0 = MHA)")
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--data", default=os.environ.get("TPU_DATA_PATH", ""),
                   help="mounted .npy token file (1-D int array); empty = "
                        "synthetic recurrence")
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
    p.add_argument("--device", default="",
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    return p.parse_args(argv)


# flag -> (its default, the ROADMAP Queue A item that ports it)
_NOT_PORTED = {
    "tensor_parallel": (1, "7"),
    "sp_mode": ("ring", "7"),
    "split_qkv": ("auto", "7"),
    "fsdp": (False, "7"),
    "profile_dir": ("", "9"),
}


def check_ported(args) -> None:
    """Raise ValueError for the sequence-parallel combinations the
    reference refuses, then NotImplementedError for a flag set away from
    the reference's default that the port cannot honour yet."""
    shards = getattr(args, "seq_parallel", 1)
    if shards < 1 or args.seq_len % shards:
        raise ValueError(f"--seq-len {args.seq_len} must split into "
                         f"--seq-parallel {shards} >= 1 shards")
    if getattr(args, "sp_layout", "contiguous") == "striped":
        if getattr(args, "sp_mode", "ring") != "ring":
            raise ValueError("--sp-layout striped requires --sp-mode ring")
        if shards <= 1:
            raise ValueError(
                "--sp-layout striped requires --seq-parallel > 1 (the "
                "layout exists to balance the ring)")
    chunk = getattr(args, "loss_chunk", 0)
    if chunk and shards > 1:
        raise ValueError("--loss-chunk requires --seq-parallel 1: sequence "
                         "parallelism already shards the logits over T")
    if chunk and (chunk < 0 or args.seq_len % chunk):
        raise ValueError(f"--loss-chunk {chunk} must divide --seq-len "
                         f"{args.seq_len}")
    for name, (default, item) in _NOT_PORTED.items():
        if getattr(args, name, default) != default:
            raise NotImplementedError(
                f"--{name.replace('_', '-')} {getattr(args, name)!r} is not "
                f"ported to the PyTorch payload yet (ROADMAP Queue A "
                f"{item}); leave it at {default!r}")


def _causal_attend(_i):
    return lambda q, k, v: fa.flash_attention(q, k, v, causal=True)


class LMMesh(NamedTuple):
    """The (data, seq) layout of the job's processes: ``world`` processes,
    ``seq_procs`` (P) per seq group sharing ``seq_shards`` (N) ring shards,
    ``data`` = world / P data ranks. Ranks are data-major: rank = data_rank
    · P + seq_rank, so a seq group is P neighbouring ranks."""

    world: int
    rank: int
    seq_procs: int
    seq_shards: int

    @property
    def data(self) -> int:
        return self.world // self.seq_procs

    @property
    def data_rank(self) -> int:
        return self.rank // self.seq_procs

    @property
    def seq_rank(self) -> int:
        return self.rank % self.seq_procs

    def ring(self) -> ring_mod.SeqRing:
        first = self.data_rank * self.seq_procs
        return ring_mod.SeqRing(self.seq_shards,
                                range(first, first + self.seq_procs),
                                self.seq_rank)


def make_lm_mesh(world: Optional[int] = None, rank: Optional[int] = None,
                 seq_parallel: int = 1) -> LMMesh:
    """The (data, seq) mesh over the job's processes (default: the process
    group, or one process without one): P = min(world, N) processes per seq
    group, data = world / P. N must split over P, and P over the world."""
    import torch.distributed as dist

    grouped = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if grouped else 1
    if rank is None:
        rank = dist.get_rank() if grouped else 0
    procs = min(world, seq_parallel)
    if seq_parallel < 1 or seq_parallel % procs or world % procs:
        raise ValueError(f"--seq-parallel {seq_parallel} does not lay out "
                         f"over {world} processes")
    return LMMesh(world, rank, procs, seq_parallel)


class Built(NamedTuple):
    model: TransformerLM
    optimizer: Any
    opt_state: Any
    step: Callable[[torch.Tensor], train.Metrics]
    batches: Iterator[Tuple]
    device: torch.device

    @property
    def state(self) -> checkpoint.TrainState:
        """The params and optimizer state the step updates in place: what
        a checkpoint saves and a restore copies back."""
        return checkpoint.TrainState(dict(self.model.named_parameters()),
                                     self.opt_state)


def build_model(args, device) -> TransformerLM:
    """The LM at the flags' widths with f32 master params and the block of
    ``compute.lm_block`` (rematerialized under ``--remat``), from a seeded
    init on ``device``."""
    model = TransformerLM(args.vocab, args.dim, args.heads, args.layers,
                          args.seq_len, kv_heads=args.kv_heads,
                          param_dtype=torch.float32, device=device,
                          block=compute.lm_block(args))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(args.seed))
    return model.init_weights(gen)


def make_lm_loss(model: TransformerLM, mesh: Optional[LMMesh] = None,
                 sp_layout: str = "contiguous", loss_chunk: int = 0):
    """``loss_fn(tokens) -> (loss, metrics)`` of one microbatch on ``mesh``
    (default: one process, one shard).

    One shard: flash attention over the whole sequence; with
    ``loss_chunk`` the model returns its final hidden state and the head
    and loss run chunk by chunk (``train.chunked_next_token_nll``, the
    reference's ``transformer.py:287-300``). More: the
    reference's striped step (``transformer.py:337-359``) for either layout.
    Every process holds its data rank's ``[b, T]`` tokens and takes its
    slots' tokens, positions (``perm``), targets (``(perm + 1) % T``) and
    mask (``perm < T - 1``); attention is the ring. The loss is divided by
    the whole sequence's count of valid targets, b·(T - 1), so the sum over
    a seq group is the reference's loss, and so is its gradient."""
    mesh = mesh or make_lm_mesh(1, 0, 1)
    if loss_chunk:
        if mesh.seq_shards > 1:
            raise ValueError(
                "--loss-chunk requires --seq-parallel 1: sequence "
                "parallelism already shards the logits over T")

        def loss_fn(tokens):
            hidden = model(tokens, None, _causal_attend, return_hidden=True)
            loss = train.chunked_next_token_nll(
                hidden, model.lm_head.weight, tokens, loss_chunk)
            return loss, {"loss": loss.detach()}

        return loss_fn
    if mesh.seq_shards == 1:
        def loss_fn(tokens):
            loss = train.next_token_nll(model(tokens, None, _causal_attend),
                                        tokens)
            return loss, {"loss": loss.detach()}

        return loss_fn

    seq_len = model.max_seq
    striped = sp_layout == "striped"
    perm = ring_mod.stripe_permutation(seq_len, mesh.seq_shards)[0] \
        if striped else np.arange(seq_len)
    local = seq_len // mesh.seq_procs
    # This process's slots, in slab order: the global positions it holds.
    pos = torch.from_numpy(
        perm[mesh.seq_rank * local:(mesh.seq_rank + 1) * local]).to(
            next(model.parameters()).device)
    tgt = (pos + 1) % seq_len
    mask = pos < seq_len - 1
    ring = mesh.ring()

    def attend_for_layer(_i):
        return lambda q, k, v: ring_mod.ring_attention(
            q, k, v, ring, causal=True, stripe=striped)

    def loss_fn(tokens):
        if tokens.shape[1] != seq_len:
            raise ValueError(f"the sequence layout was built for seq_len "
                             f"{seq_len}, got a batch with T="
                             f"{tokens.shape[1]}")
        logits = model(tokens[:, pos], pos[None], attend_for_layer)
        loss = train.next_token_nll_masked(
            logits, tokens[:, tgt], mask,
            count=tokens.shape[0] * (seq_len - 1))
        return loss, {"loss": loss.detach()}

    return loss_fn


def make_lm_train_step(model: TransformerLM, optimizer, opt_state,
                       grad_accum: int = 1, mesh: Optional[LMMesh] = None,
                       sp_layout: str = "contiguous", loss_chunk: int = 0):
    """Next-token cross-entropy step (:func:`make_lm_loss`) over
    ``model``'s trainable params (the ones ``opt_state`` was initialised
    on). With more than one process it all-reduces the gradients after the
    last microbatch: summed over the world, divided by the data ranks."""
    mesh = mesh or make_lm_mesh(1, 0, 1)
    params = [p for p in model.parameters() if p.requires_grad]
    reduce = None
    if mesh.world > 1:
        def reduce(ps, metrics):
            return train.all_reduce_grads(ps, metrics, mesh.data)

    return train.make_loss_train_step(make_lm_loss(model, mesh, sp_layout,
                                                   loss_chunk),
                                      params, optimizer, opt_state,
                                      grad_accum=grad_accum, reduce=reduce)


def build(args, device=None, mesh: Optional[LMMesh] = None) -> Built:
    """Model (seeded init, gradients on), optimizer and its state, step
    and host batches for the flags. ``device`` defaults to ``--device``
    (CUDA unless it says ``cpu``); ``mesh`` to the (data, seq) mesh of the
    job's process group at ``--seq-parallel``."""
    check_ported(args)
    mesh = mesh or make_lm_mesh(seq_parallel=args.seq_parallel)
    if mesh.seq_shards != args.seq_parallel:
        raise ValueError(f"mesh has {mesh.seq_shards} seq shards, "
                         f"--seq-parallel is {args.seq_parallel}")
    if args.batch % mesh.data:
        raise ValueError(f"--batch {args.batch} must split over "
                         f"{mesh.data} data ranks")
    rows = args.batch // mesh.data
    if args.grad_accum < 1 or rows % args.grad_accum:
        raise ValueError(f"{rows} rows per data rank must divide by "
                         f"--grad-accum {args.grad_accum} >= 1")
    dev = resolve_device(device if device is not None
                         else (args.device or None))
    optimizer = optimizers.from_args(args)
    model = build_model(args, dev).requires_grad_(True)
    opt_state = optimizer.init(list(model.parameters()))
    step = make_lm_train_step(model, optimizer, opt_state,
                              grad_accum=args.grad_accum, mesh=mesh,
                              sp_layout=args.sp_layout,
                              loss_chunk=args.loss_chunk)
    return Built(model, optimizer, opt_state, step,
                 data_mod.lm_batches(args, mesh), dev)


def run(info: bootstrap.ProcessInfo, args=None) -> dict:
    args = args or parse_args([])
    built = build(args)
    n_params = sum(p.numel() for p in built.model.parameters())
    log.info("training %d params on %s; batch %d seq %d grad-accum %d "
             "seq-parallel %d (%s); remat %s; optimizer %s; loss chunk %d",
             n_params, built.device, args.batch, args.seq_len,
             args.grad_accum, args.seq_parallel, args.sp_layout,
             args.remat_policy if args.remat else "off", args.optimizer,
             args.loss_chunk)
    ckpt = checkpoint.from_env_or_args(args.checkpoint_dir,
                                       save_every=args.checkpoint_every)
    if ckpt is not None and ckpt.latest_step() is not None:
        log.info("attempt %d: resuming from %s (latest step: %d)",
                 info.attempt, ckpt.directory, ckpt.latest_step())
    try:
        metrics = train.train_loop(
            built.step, built.batches, args.steps, device=built.device,
            log_every=args.log_every,
            log_fn=lambda i, m: log.info("step %d loss %.4f", i, m["loss"]),
            prefetch=prefetch_depth(args), checkpointer=ckpt,
            state=built.state)
    finally:
        if ckpt is not None:
            ckpt.close()
    log.info("final: loss %.4f", metrics.get("loss", float("nan")))
    return metrics


def main() -> None:
    args = parse_args()
    bootstrap.main_wrapper(lambda info: run(info, args),
                           device=args.device or None)


if __name__ == "__main__":
    main()
