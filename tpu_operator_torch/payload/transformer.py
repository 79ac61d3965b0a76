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
attempt resumes from the newest verified step (``checkpoint.py``); with
the operator's warm-start store (``TPUJOB_STORE_*``) the verified steps
and the kernel library also go to the store, and a fresh node prefetches
both during the rendezvous. The kernel library is built or loaded
(COMPILE) on a worker thread while the checkpoint restores.
``--profile-dir`` (or ``$TPU_PROFILE_DIR``) writes a ``torch.profiler``
trace of steps 11-20 of the run; ``--prefetch-depth`` and the
``TPUJOB_DATAPLANE_*`` env drive the data plane (``autotune.py``).

``--sp-mode ulysses`` swaps the ring for the head-scatter all-to-all
(``ulysses.py``) on the same layout: the flash kernels over the whole
sequence on H/N heads a shard.

``--tensor-parallel N`` splits every block Megatron-style over N model
shards (``models.DecoderBlock._forward_tp``): q/k/v, ``mlp_up`` and
``lm_head`` column-parallel, ``attn_out`` and ``mlp_down`` row-parallel;
attention is head-local (the kernels on H/N heads a shard, or a ring of
its own a shard under ``--seq-parallel``: the 3-axis data x seq x model
mesh). The shards spread over the processes of a model group, N / P a
process; one process holding all N runs them as units one after another.
``--split-qkv auto`` splits the q/k/v projections under TP (``off`` warns
and each shard takes its heads' rows of each third of the fused
``qkv``). Checkpoints hold whole arrays, so a step saved at one TP degree
restores at another.

``--fsdp`` shards the params over the data group (:func:`shard_fsdp`,
the reference's ``train.fsdp_shardings`` rule, ``train.fsdp_dims``):
each process keeps 1/N of every leaf of at least 1024 elements whose
reference dim 0 divides by N = ``LMMesh.data``, of its f32 gradient and
of its adam / adam8 moments. A layer gathers its whole weights where it
uses them (``models.gathered``) and drops them after; the backward
gathers them again (``collectives.regather_saved``, or the recompute
under ``--remat``) and reduce-scatters each weight's gradient as soon as
it is formed. It excludes ``--tensor-parallel``, as the reference does.
Checkpoints hold whole arrays, so a step saved under ``--fsdp`` restores
at another data size or without it.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import (Any, Callable, Dict, Iterator, NamedTuple, Optional,
                    Tuple)

import numpy as np
import torch

from tpu_operator_torch.device import resolve_device
from tpu_operator_torch.payload import autotune
from tpu_operator_torch.payload import bootstrap
from tpu_operator_torch.payload import checkpoint
from tpu_operator_torch.payload import collectives
from tpu_operator_torch.payload import compute
from tpu_operator_torch.payload import data as data_mod
from tpu_operator_torch.payload import flash_attention as fa
from tpu_operator_torch.payload import optimizers
from tpu_operator_torch.payload import ring_attention as ring_mod
from tpu_operator_torch.payload import train
from tpu_operator_torch.payload import ulysses
from tpu_operator_torch.payload.models import TransformerLM
from tpu_operator_torch.payload.models import resolve_split_qkv
from tpu_operator_torch.payload.models import validate_heads_dims

log = logging.getLogger(__name__)


def prefetch_depth(args) -> int:
    """``--prefetch-depth`` through the 0 = auto convention."""
    return autotune.resolve_prefetch_depth(args.prefetch_depth)


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
                   help="Megatron-style TP shards (N; they spread over the "
                        "job's processes, N / P per process): q/k/v/mlp_up/"
                        "lm_head column-parallel, attn_out/mlp_down row-"
                        "parallel; composes with --seq-parallel (3-axis "
                        "data x seq x model mesh, ring attention only)")
    p.add_argument("--split-qkv", choices=("auto", "on", "off"),
                   default="auto",
                   help="separate q/k/v projections (auto: on under "
                        "--tensor-parallel, so TP shards whole heads, and "
                        "under GQA; off fuses one [3d, d] product, the "
                        "layout of checkpoints saved with a fused kernel)")
    p.add_argument("--sp-mode", choices=("ring", "ulysses"), default="ring",
                   help="sequence-parallel strategy: ring = K/V blocks "
                        "rotate, O(T/N) memory; ulysses = head-scatter "
                        "all-to-all, needs heads %% seq shards == 0")
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
                   help="ZeRO/FSDP param+optimizer sharding over the data "
                        "group (train.fsdp_dims): per-process params, "
                        "gradients and moments O(1/N), each layer's "
                        "weights gathered where used")
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
                   help="torch.profiler trace dir (default "
                        "$TPU_PROFILE_DIR): a trace of steps 11-20 of the "
                        "run")
    autotune.add_prefetch_argument(p)
    p.add_argument("--device", default="",
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    return p.parse_args(argv)


def check_ported(args) -> None:
    """Raise ValueError for the flag combinations the reference refuses
    (and ``--loss-chunk`` with tensor parallelism, which it accepts
    silently)."""
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
    tp = getattr(args, "tensor_parallel", 1)
    if tp < 1:
        raise ValueError(f"--tensor-parallel {tp} must be >= 1")
    if tp > 1 and shards > 1 and getattr(args, "sp_mode", "ring") \
            == "ulysses":
        raise ValueError(
            "--sp-mode ulysses does not compose with --tensor-parallel "
            "(both shard the head dimension); use --sp-mode ring")
    if tp > 1 and getattr(args, "fsdp", False):
        raise ValueError(
            "--fsdp and --tensor-parallel are exclusive in this payload: "
            "TP replicates over data, FSDP shards over it")
    validate_heads_dims(args.heads, getattr(args, "kv_heads", 0), args.dim,
                        tp)
    if shards > 1 and getattr(args, "sp_mode", "ring") == "ulysses":
        ulysses.check_heads(args.heads, getattr(args, "kv_heads", 0)
                            or args.heads, shards)
    chunk = getattr(args, "loss_chunk", 0)
    if chunk and tp > 1:
        raise ValueError("--loss-chunk requires --tensor-parallel 1: the "
                         "chunked head runs on the whole lm_head, which "
                         "tensor parallelism splits over vocab")
    if chunk and shards > 1:
        raise ValueError("--loss-chunk requires --seq-parallel 1: sequence "
                         "parallelism already shards the logits over T")
    if chunk and (chunk < 0 or args.seq_len % chunk):
        raise ValueError(f"--loss-chunk {chunk} must divide --seq-len "
                         f"{args.seq_len}")


def _causal_attend(_i):
    return lambda q, k, v: fa.flash_attention(q, k, v, causal=True)


class LMMesh(NamedTuple):
    """The (data, seq, model) layout of the job's processes: ``world``
    processes, ``seq_procs`` (P_s) per seq group sharing ``seq_shards``
    (N_s) sequence shards, ``model_procs`` (P_m) per model group sharing
    ``model_shards`` (N_m) tensor-parallel shards, ``data`` = world /
    (P_s·P_m) data ranks. The model axis is innermost, as in the
    reference's ``train.make_mesh3``: rank = (data_rank·P_s +
    seq_rank)·P_m + model_rank. The groups are this process's (None
    without a process group or with one process in them):
    ``seq_group`` (its seq group: the Ulysses exchange), ``model_group``
    (its model group), ``replica_group`` (every process with its
    model rank: the gradient reduce under tensor parallelism) and
    ``data_group`` (every process with its seq and model rank: the
    ``--fsdp`` gathers and reduce-scatters)."""

    world: int
    rank: int
    seq_procs: int
    seq_shards: int
    model_procs: int = 1
    model_shards: int = 1
    seq_group: Any = None
    model_group: Any = None
    replica_group: Any = None
    data_group: Any = None

    @property
    def data(self) -> int:
        return self.world // (self.seq_procs * self.model_procs)

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_procs

    @property
    def seq_rank(self) -> int:
        return (self.rank // self.model_procs) % self.seq_procs

    @property
    def data_rank(self) -> int:
        return self.rank // (self.model_procs * self.seq_procs)

    # The batch shard this process holds (data.lm_batches): its data
    # rank's, which its seq and model groups share.
    @property
    def batch_rank(self) -> int:
        return self.data_rank

    @property
    def batch_ranks(self) -> int:
        return self.data

    def seq_ranks(self) -> range:
        """The global ranks of this process's seq group, in ring order."""
        first = self.data_rank * self.seq_procs * self.model_procs \
            + self.model_rank
        return range(first, first + self.seq_procs * self.model_procs,
                     self.model_procs)

    def ring(self) -> ring_mod.SeqRing:
        return ring_mod.SeqRing(self.seq_shards, self.seq_ranks(),
                                self.seq_rank)

    def tp(self) -> collectives.TPShards:
        return collectives.TPShards(self.model_shards, self.model_procs,
                                    self.model_rank, self.model_group)


def make_lm_mesh(world: Optional[int] = None, rank: Optional[int] = None,
                 seq_parallel: int = 1, tensor_parallel: int = 1,
                 num_slices: int = 1) -> LMMesh:
    """The (data, seq, model) mesh over the job's processes (default: the
    process group, or one process without one): P_m = min(world, N_m)
    processes per model group, P_s = min(world / P_m, N_s) per seq group,
    data = world / (P_s·P_m). Each N must split over its P, and the world
    over P_s·P_m; with ``num_slices`` > 1 each seq x model group must fit
    inside one slice (:func:`collectives.check_slices`). With a process
    group, every process creates every seq, model, replica and data group
    it may need (``dist.new_group`` is collective) and keeps its own."""
    import torch.distributed as dist

    grouped = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if grouped else 1
    if rank is None:
        rank = dist.get_rank() if grouped else 0
    if tensor_parallel < 1 or seq_parallel < 1:
        raise ValueError(f"--seq-parallel {seq_parallel} and "
                         f"--tensor-parallel {tensor_parallel} must be >= 1")
    mprocs = min(world, tensor_parallel)
    if tensor_parallel % mprocs or world % mprocs:
        raise ValueError(f"--tensor-parallel {tensor_parallel} does not lay "
                         f"out over {world} processes")
    procs = min(world // mprocs, seq_parallel)
    if seq_parallel % procs or world % (procs * mprocs):
        raise ValueError(f"--seq-parallel {seq_parallel} does not lay out "
                         f"over {world // mprocs} processes")
    collectives.check_slices(world, procs * mprocs, "seq x model", num_slices)
    mesh = LMMesh(world, rank, procs, seq_parallel, mprocs, tensor_parallel)
    if not grouped or world == 1:
        return mesh
    groups = {}
    inner = procs * mprocs
    if procs > 1:
        for first in range(0, world, inner):
            for m in range(mprocs):
                ranks = list(range(first + m, first + inner, mprocs))
                group = dist.new_group(ranks)
                if rank in ranks:
                    groups["seq_group"] = group
    if mprocs > 1:
        for first in range(0, world, mprocs):
            ranks = list(range(first, first + mprocs))
            group = dist.new_group(ranks)
            if rank in ranks:
                groups["model_group"] = group
        for m in range(mprocs):
            ranks = list(range(m, world, mprocs))
            group = dist.new_group(ranks)
            if rank in ranks:
                groups["replica_group"] = group
    if world > inner:
        groups["data_group"] = collectives.own_group(
            rank, (list(range(r, world, inner)) for r in range(inner)))
    return mesh._replace(**groups)


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
        a checkpoint saves and a restore copies back. Under tensor
        parallelism over several processes, or ``--fsdp`` over several
        data ranks, the split params and their moments are named as such
        (:func:`tp_shards`, :func:`fsdp_shards`): a checkpoint holds
        whole arrays."""
        return checkpoint.TrainState(
            dict(self.model.named_parameters()), self.opt_state,
            shards=(tp_shards(self.model, self.opt_state)
                    or fsdp_shards(self.model, self.opt_state)))


def tp_shards(model: TransformerLM, opt_state
              ) -> Optional[checkpoint.Shards]:
    """The params split over the model group's processes, and the moments
    of each (``mu.<i>`` / ``nu.<i>``, shaped as their param), with each
    one's split (:meth:`TransformerLM.tp_dims`); None unless the model
    group holds more than one process. adam8's block-quantized moments do
    not split along a param's dims: refused."""
    tp = model.tp
    if tp.procs == 1:
        return None
    dims = model.tp_dims()
    params = list(model.named_parameters())
    opt = {}
    for key, t in opt_state.state_dict().items():
        index = key.rsplit(".", 1)[-1]
        if not t.dim() or not index.isdigit():
            continue
        name, param = params[int(index)]
        if name not in dims:
            continue
        if t.shape != param.shape:
            raise ValueError(
                f"optimizer state {key} {tuple(t.shape)} is not shaped as "
                f"its param {name} {tuple(param.shape)}: it does not split "
                f"over --tensor-parallel processes for a checkpoint (use "
                f"--optimizer adam)")
        opt[key] = dims[name]
    return checkpoint.Shards({checkpoint.PARAMS_FILE: dims,
                              checkpoint.OPT_FILE: opt},
                             tp.group, tp.procs, tp.index)


def shard_fsdp(model: TransformerLM, mesh: LMMesh,
               optimizer: str = "adam") -> Dict[str, int]:
    """``--fsdp``: every param that the reference's rule shards at
    ``mesh.data`` data ranks (``train.fsdp_dims``, which also says the
    cut) becomes a param holding this data rank's part, with its
    :class:`~collectives.FSDPShard` as ``fsdp``; the model then gathers it
    where it is used. Call before the optimizer's ``init``, so that the
    moments take the parts' shapes. Returns the dims."""
    dims = train.fsdp_dims(model, mesh.data, optimizer)
    with torch.no_grad():
        for name, dim in dims.items():
            owner, attr = name.rsplit(".", 1)
            module = model.get_submodule(owner)
            whole = getattr(module, attr)
            shard = torch.nn.Parameter(
                collectives.part_of(whole, dim, 1, mesh.data,
                                    mesh.data_rank).clone(),
                requires_grad=whole.requires_grad)
            shard.fsdp = collectives.FSDPShard(dim, mesh.data,
                                               mesh.data_rank,
                                               mesh.data_group)
            setattr(module, attr, shard)
    model.fsdp = True
    return dims


def fsdp_shards(model: TransformerLM, opt_state
                ) -> Optional[checkpoint.Shards]:
    """The params split over the data group by :func:`shard_fsdp` and
    their moments (adam's ``mu.<i>`` / ``nu.<i>`` shaped as the part,
    adam8's ``m.q.<i>`` / ``m.scale.<i>`` / ... whose block dims keep the
    param's dim index: the cut never splits a block), each along its cut;
    None unless the data group holds more than one process."""
    params = list(model.named_parameters())
    specs = {n: p.fsdp for n, p in params
             if getattr(p, "fsdp", None) is not None and p.fsdp.size > 1}
    if not specs:
        return None
    opt = {}
    for key, t in opt_state.state_dict().items():
        index = key.rsplit(".", 1)[-1]
        if t.dim() and index.isdigit() and params[int(index)][0] in specs:
            opt[key] = specs[params[int(index)][0]].dim
    spec = next(iter(specs.values()))
    return checkpoint.Shards(
        {checkpoint.PARAMS_FILE: {n: s.dim for n, s in specs.items()},
         checkpoint.OPT_FILE: opt}, spec.group, spec.size, spec.rank)


def build_model(args, device, tp: Optional[collectives.TPShards] = None
                ) -> TransformerLM:
    """The LM at the flags' widths with f32 master params and the block of
    ``compute.lm_block`` (rematerialized under ``--remat``), from a seeded
    init on ``device``; ``tp`` (default: N = ``--tensor-parallel`` shards
    in this process) splits it, and ``--split-qkv`` resolves as the
    reference's does."""
    tp = tp or collectives.TPShards(getattr(args, "tensor_parallel", 1), 1)
    split = resolve_split_qkv(getattr(args, "split_qkv", "auto"), tp.shards,
                              log)
    model = TransformerLM(args.vocab, args.dim, args.heads, args.layers,
                          args.seq_len, kv_heads=args.kv_heads,
                          split_qkv=split or None,
                          param_dtype=torch.float32, device=device,
                          block=compute.lm_block(args), tp=tp)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(args.seed))
    return model.init_weights(gen)


def make_lm_loss(model: TransformerLM, mesh: Optional[LMMesh] = None,
                 sp_layout: str = "contiguous", loss_chunk: int = 0,
                 sp_mode: str = "ring"):
    """``loss_fn(tokens) -> (loss, metrics)`` of one microbatch on ``mesh``
    (default: one process, one shard).

    One shard: flash attention over the whole sequence; with
    ``loss_chunk`` the model returns its final hidden state and the head
    and loss run chunk by chunk (``train.chunked_next_token_nll``, the
    reference's ``transformer.py:287-300``). More: the
    reference's striped step (``transformer.py:337-359``) for either layout.
    Every process holds its data rank's ``[b, T]`` tokens and takes its
    slots' tokens, positions (``perm``), targets (``(perm + 1) % T``) and
    mask (``perm < T - 1``); attention is the ring, or with ``sp_mode``
    ``ulysses`` the head-scatter exchange. Tensor parallelism lives in the
    model (``model.tp``): each shard attends on its heads. The loss is divided by
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

    if sp_mode == "ulysses":
        if striped:
            raise ValueError("--sp-layout striped requires --sp-mode ring")

        def attend_for_layer(_i):
            return lambda q, k, v: ulysses.ulysses_attention(
                q, k, v, ring, mesh.seq_group, causal=True)
    else:
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
                       sp_layout: str = "contiguous", loss_chunk: int = 0,
                       sp_mode: str = "ring"):
    """Next-token cross-entropy step (:func:`make_lm_loss`) over
    ``model``'s trainable params (the ones ``opt_state`` was initialised
    on). With more than one process it all-reduces the gradients after the
    last microbatch: summed over the processes with this one's model rank
    (the world without tensor parallelism), divided by the data ranks.
    An ``--fsdp`` shard's gradient comes out of each microbatch's
    backward already summed over the data group (``collectives.
    fsdp_gather``), so after the last it sums over the seq group only,
    then takes the same division."""
    mesh = mesh or make_lm_mesh(1, 0, 1)
    params = [p for p in model.parameters() if p.requires_grad]
    sharded = [i for i, p in enumerate(params)
               if getattr(p, "fsdp", None) is not None]
    reduce = None
    if mesh.world > 1:
        def reduce(ps, metrics):
            return train.all_reduce_grads(ps, metrics, mesh.data,
                                          sharded=sharded,
                                          shard_group=mesh.seq_group,
                                          group=mesh.replica_group)

    return train.make_loss_train_step(make_lm_loss(model, mesh, sp_layout,
                                                   loss_chunk, sp_mode),
                                      params, optimizer, opt_state,
                                      grad_accum=grad_accum, reduce=reduce)


def build(args, device=None, mesh: Optional[LMMesh] = None,
          num_slices: int = 1) -> Built:
    """Model (seeded init, gradients on), optimizer and its state, step
    and host batches for the flags. ``device`` defaults to ``--device``
    (CUDA unless it says ``cpu``); ``mesh`` to the (data, seq, model) mesh
    of the job's process group at ``--seq-parallel`` and
    ``--tensor-parallel`` over ``num_slices`` slices."""
    check_ported(args)
    mesh = mesh or make_lm_mesh(seq_parallel=args.seq_parallel,
                                tensor_parallel=args.tensor_parallel,
                                num_slices=num_slices)
    if mesh.seq_shards != args.seq_parallel \
            or mesh.model_shards != args.tensor_parallel:
        raise ValueError(f"mesh has {mesh.seq_shards} seq and "
                         f"{mesh.model_shards} model shards, --seq-parallel "
                         f"is {args.seq_parallel} and --tensor-parallel "
                         f"{args.tensor_parallel}")
    if args.batch % mesh.data:
        raise ValueError(f"--batch {args.batch} must split over "
                         f"{mesh.data} data ranks")
    if mesh.world > 1:
        first = mesh.rank - mesh.model_rank
        log.info("mesh: process %d of %d, data rank %d of %d, seq group "
                 "%s, model group %s", mesh.rank, mesh.world, mesh.data_rank,
                 mesh.data, list(mesh.seq_ranks()),
                 list(range(first, first + mesh.model_procs)))
    rows = args.batch // mesh.data
    if args.grad_accum < 1 or rows % args.grad_accum:
        raise ValueError(f"{rows} rows per data rank must divide by "
                         f"--grad-accum {args.grad_accum} >= 1")
    dev = resolve_device(device if device is not None
                         else (args.device or None))
    optimizer = optimizers.from_args(args)
    model = build_model(args, dev, mesh.tp()).requires_grad_(True)
    if getattr(args, "fsdp", False):
        shard_fsdp(model, mesh, getattr(args, "optimizer", "adam"))
        if isinstance(optimizer, optimizers.Adam8):
            optimizer.uniform = optimizers.part_uniform(optimizer.uniform, {
                i: (p.fsdp.dim, p.fsdp.size, p.fsdp.rank)
                for i, p in enumerate(model.parameters())
                if getattr(p, "fsdp", None) is not None})
    opt_state = optimizer.init(list(model.parameters()))
    step = make_lm_train_step(model, optimizer, opt_state,
                              grad_accum=args.grad_accum, mesh=mesh,
                              sp_layout=args.sp_layout,
                              loss_chunk=args.loss_chunk,
                              sp_mode=args.sp_mode)
    return Built(model, optimizer, opt_state, step,
                 data_mod.lm_batches(args, mesh), dev)


def run(info: bootstrap.ProcessInfo, args=None) -> dict:
    args = args or parse_args([])
    built = build(args, num_slices=info.num_slices)
    here = sum(p.numel() for p in built.model.parameters())
    n_params = sum(p.numel() * (p.fsdp.size if hasattr(p, "fsdp") else 1)
                   for p in built.model.parameters())
    log.info("training %d params (%d on this process) on %s; batch %d "
             "seq %d grad-accum %d seq-parallel %d (%s, %s); "
             "tensor-parallel %d; fsdp %s; remat %s; optimizer %s; loss "
             "chunk %d",
             n_params, here, built.device, args.batch, args.seq_len,
             args.grad_accum, args.seq_parallel, args.sp_mode,
             args.sp_layout, args.tensor_parallel, args.fsdp,
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
            # The loss in full (repr): the launcher's tests and chip_smoke
            # compare these lines bit for bit across processes.
            log_fn=lambda i, m: log.info("step %d loss %r", i, m["loss"]),
            prefetch=prefetch_depth(args), checkpointer=ckpt,
            state=built.state, profile_dir=args.profile_dir,
            compile_fn=train.kernel_loader(built.device))
    finally:
        if ckpt is not None:
            ckpt.close()
        if built.device.type == "cuda":
            # On every exit, a drained one (143, 160) included.
            log.info("kernel launches: %s", json.dumps(fa.launch_counts()))
            log.info("peak memory: %.3f GB on %s",
                     torch.cuda.max_memory_allocated(built.device) / 1e9,
                     built.device)
    log.info("final: loss %r", metrics.get("loss", float("nan")))
    return metrics


def main() -> None:
    args = parse_args()
    bootstrap.main_wrapper(lambda info: run(info, args),
                           device=args.device or None)


if __name__ == "__main__":
    main()
