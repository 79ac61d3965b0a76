"""Pipeline-parallel transformer LM training payload, one process per CUDA
card (counterpart of ``tpu_operator/payload/pipeline.py``).

    python -m tpu_operator_torch.payload.pipeline --dim 1024 --layers 8 \\
        --heads 16 --batch 16 --seq-len 2048 --vocab 32768 \\
        --microbatches 4 --schedule 1f1b

trains the reference's bench row (``bench.py:840-905``
``bench_pipeline_overhead``) on the synthetic recurrence; ``--device
cpu`` with small widths runs the plain PyTorch path. The model is the
reference's: a replicated embedding (token plus position, added in the
compute dtype), the block stack split into ``S = --pipeline`` stages of
``layers / S`` pre-LN decoder blocks (``models.DecoderBlock``, under
``--remat`` the block of ``compute.lm_block``), and a replicated head (an
f32 LayerNorm with epsilon 1e-6, then a bias-free ``[dim, vocab]``
product in the compute dtype). f32 master params, bf16 compute, the f32
next-token loss.

Schedules (``--schedule``), each a table of units per tick and stage
that one executor runs (:class:`Pipeline`):

- ``1f1b`` (:func:`onef1b_schedule`): stage s runs F(m) at tick 2m + s and
  B(m) at tick 2m + 2S - 1 - s. F runs the stage forward and stashes its
  input (``--stash input``; B recomputes the forward under autograd, so a
  stage holds at most S - s inputs whatever M is) or keeps its autograd
  graph (``--stash residuals``; no recompute). B on the last stage seeds
  the head-plus-loss backward at 1/M; elsewhere it takes the cotangent
  that came down. Gradients add into f32 accumulators; dx goes down and
  stage 0 folds it into the embedding's gradient.
- ``1f1b-interleaved`` (:func:`onef1b_interleaved_schedule`): the layer
  stack in S·V chunks, chunk ``j·S + d`` on stage d, the activations on
  a wrapping ring; the table is the reference's simulation, entry for
  entry.
- ``gpipe`` (:func:`gpipe_schedule`): every F, then every B, with the
  graphs kept (memory O(M), as under ``jax.grad`` of the reference's
  scan) and one loss over the whole batch between the two phases;
  ``--grad-accum K`` runs it K times on K slices.

Placement (:func:`make_pipe_mesh`): the processes form the reference's
(data, pipe, model) mesh, model innermost: ``P_m = min(world, N)``
neighbouring processes form a model group holding the ``N =
--tensor-parallel`` shards (N / P_m each), ``P = min(world / P_m, S)``
model groups a pipe group, each holding ``S / P`` consecutive stages (one
process with ``--pipeline 4`` holds all four and hands activations on in
memory); rank = (data_rank·P + pipe_rank)·P_m + model_rank. Across
processes each tick's sends and receives are posted together through
``batch_isend_irecv``, each to the same model rank of the next pipe rank.
The processes of a pipe group share a batch shard. Stage gradients take
the mean over their data group (the same pipe and model rank); the
embedding's and the head's (held only by the boundary stages) the sum
over the data x pipe processes of one model rank divided by the data
ranks, as does the loss. ``--zero1`` keeps on each data rank 1/N of every
optimizer leaf of at least 1024 elements, split on its first divisible
dim that neither the pipe nor the model axis splits; the rank updates
that part and the parameters are all-gathered.

Tensor parallelism inside the stages (``--tensor-parallel N``, the
reference's ``stage_param_spec``): every block is the Megatron pair of
``models.DecoderBlock._forward_tp`` on ``PipeMesh.tp()`` (q / k / v and
``mlp_up`` with its bias split by column, ``attn_out`` and ``mlp_down``
by row, the LayerNorms and ``mlp_down``'s bias whole), the shards run as
units; the embedding and the head stay whole (the head is not
vocab-split). ``--split-qkv`` resolves as the reference's
``_stage_module`` does (``models.resolve_split_qkv``: auto splits under
TP; off under TP warns and splits the fused ``qkv`` by head). The init
draws every weight whole and keeps this process's part, so it depends on
neither S, V nor N.

On the card attention is the differentiable flash attention in bf16 (K1
through the ``flash_fwd`` op, K2 through ``flash_bwd``); under ``--dtype
f32`` it is the plain attention, as the reference's ``attend`` chooses.

Checkpoints go through ``checkpoint.py``: process 0 gathers the stage
stacks (and their model parts, and the ZeRO-1 parts) at a save, so a
checkpoint holds whole arrays, and a restore takes each process's part
(``checkpoint.Shards``); ``meta.json`` names the layout (S, V, zero1) and
a restore across another is refused. N is not part of it: a save under
one ``--tensor-parallel`` restores under another.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
from typing import (Any, Callable, Dict, Iterator, List, NamedTuple,
                    Optional, Sequence, Tuple)

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tpu_operator_torch.device import resolve_device
from tpu_operator_torch.payload import autotune
from tpu_operator_torch.payload import bootstrap
from tpu_operator_torch.payload import checkpoint
from tpu_operator_torch.payload import collectives
from tpu_operator_torch.payload import compute
from tpu_operator_torch.payload import data as data_mod
from tpu_operator_torch.payload import flash_attention as fa
from tpu_operator_torch.payload import models
from tpu_operator_torch.payload import moe
from tpu_operator_torch.payload import optimizers
from tpu_operator_torch.payload import train

log = logging.getLogger(__name__)

# Optimizer leaves below this many elements stay whole under --zero1
# (the reference's state_shardings).
ZERO1_MIN_ELEMENTS = 1024


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=32, help="global batch size")
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--kv-heads", type=int, default=0,
                   help="grouped-query attention K/V heads (0 = MHA, "
                        "1 = MQA); must divide --heads")
    p.add_argument("--layers", type=int, default=8,
                   help="total decoder blocks (divisible by --pipeline)")
    p.add_argument("--pipeline", type=int, default=1,
                   help="pipeline stages; they spread over the processes "
                        "of a pipe group, S / P a process")
    p.add_argument("--tensor-parallel", type=int, default=1,
                   help="tensor-parallel shards inside every stage: model "
                        "groups of min(world, N) neighbouring processes, "
                        "N / that many shards a process")
    p.add_argument("--split-qkv", choices=("auto", "on", "off"),
                   default="auto",
                   help="separate q/k/v stage projections: auto splits "
                        "under --tensor-parallel (each shard owns whole "
                        "heads) and under GQA; off under TP is allowed but "
                        "warned")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: each data rank keeps 1/N of the optimizer "
                        "state, updates that part and all-gathers the "
                        "parameters")
    p.add_argument("--microbatches", type=int, default=4,
                   help="microbatches streamed through the pipeline per step")
    p.add_argument("--schedule",
                   choices=("gpipe", "1f1b", "1f1b-interleaved"),
                   default="gpipe",
                   help="gpipe = every forward, then every backward, graphs "
                        "kept (activation memory O(microbatches)); 1f1b = "
                        "one forward one backward from a stash (activation "
                        "memory O(stages)); 1f1b-interleaved = "
                        "--virtual-stages V chunks per stage, round-robin, "
                        "the warmup/drain bubble paid in chunk units")
    p.add_argument("--stash", choices=("input", "residuals"),
                   default="input",
                   help="what plain 1f1b keeps per microbatch in flight: "
                        "input = the stage input, the backward recomputes "
                        "the stage forward; residuals = the forward's "
                        "autograd graph, no recompute")
    p.add_argument("--virtual-stages", type=int, default=1,
                   help="model chunks per stage under --schedule "
                        "1f1b-interleaved (layers must divide by pipeline x "
                        "virtual-stages; microbatches by pipeline)")
    p.add_argument("--dtype", choices=("bf16", "f32"), default="bf16",
                   help="stage compute dtype (f32 for parity tests)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="gpipe: accumulate gradients over K sequential "
                        "slices of the batch")
    compute.add_lm_compute_flags(p)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--data", default=os.environ.get("TPU_DATA_PATH", ""),
                   help="mounted .npy token file (1-D int array); empty = "
                        "synthetic recurrence")
    p.add_argument("--checkpoint-dir", default="",
                   help="checkpoint/resume dir (default: $TPU_CHECKPOINT_DIR)")
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


def virtual_stages(args) -> int:
    """V (>= 1) under the interleaved schedule, whose ``[V, S, ...]``
    stacks it keeps even at V = 1, and 0 for the plain schedules (``[S,
    ...]`` stacks)."""
    if getattr(args, "schedule", "gpipe") != "1f1b-interleaved":
        return 0
    v = getattr(args, "virtual_stages", 1)
    if v < 1:
        raise ValueError(f"--virtual-stages must be >= 1, got {v}")
    return v


# --- the schedule tables --------------------------------------------------------


def onef1b_schedule(num_stages: int, microbatches: int):
    """The 1F1B tick table: per tick, per stage, ("F", m) / ("B", m) /
    None. Stage s: F(m) at tick 2m + s, B(m) at tick 2m + 2S - 1 - s;
    opposite parities, so no tick needs both."""
    s_, m_ = num_stages, microbatches
    total = 2 * (m_ + s_ - 1)
    table = []
    for t in range(total):
        row = []
        for s in range(s_):
            if (t - s) % 2 == 0 and 0 <= (t - s) // 2 < m_:
                row.append(("F", (t - s) // 2))
            elif (t - (2 * s_ - 1 - s)) % 2 == 0 \
                    and 0 <= (t - (2 * s_ - 1 - s)) // 2 < m_:
                row.append(("B", (t - (2 * s_ - 1 - s)) // 2))
            else:
                row.append(None)
        table.append(row)
    return table


def onef1b_interleaved_schedule(num_stages: int, virtual: int,
                                microbatches: int):
    """The interleaved-1F1B schedule (virtual pipeline stages), built by
    simulation as the reference builds it: chunk c = j·S + d of the S·V
    chunks lives on stage d; each stage runs Megatron's static unit order
    (a warmup of ``2(S-d-1) + (V-1)·S`` forwards, then F/B alternation,
    then the drain), stalling while a unit's input has not arrived (a hop
    takes one tick). Every dependency is audited, and stash and pending
    slots come from an exact liveness allocator.

    Returns int32 numpy arrays [T, S] (``act`` 0 idle / 1 F / 2 B, ``jv``
    the chunk on the stage, ``mb``, ``slot``, ``fin_slot``, ``bin_slot``,
    ``recv_f`` / ``recv_f_j`` / ``recv_f_slot``, ``recv_b`` /
    ``recv_b_j`` / ``recv_b_slot``) and the buffer depths ``n_stash``,
    ``n_pf``, ``n_pb``."""
    s_, v_, m_ = num_stages, virtual, microbatches
    if m_ % s_ != 0:
        raise ValueError(
            f"interleaved 1F1B needs --microbatches ({m_}) divisible by "
            f"--pipeline ({s_}) (Megatron schedule contract)")
    total = v_ * m_
    chunks = v_ * s_

    def f_unit(k):
        return ((k // s_) % v_, (k // (s_ * v_)) * s_ + (k % s_))

    def b_unit(k):
        return (v_ - 1 - ((k // s_) % v_), (k // (s_ * v_)) * s_ + (k % s_))

    units = []
    for d in range(s_):
        warm = min(2 * (s_ - d - 1) + (v_ - 1) * s_, total)
        seq = [("F", *f_unit(k)) for k in range(warm)]
        fi, bi = warm, 0
        # Steady state: F, then B (B first deadlocks the last stage, whose
        # first drained backward is the chunk its next forward produces).
        while fi < total or bi < total:
            if fi < total:
                seq.append(("F", *f_unit(fi)))
                fi += 1
            if bi < total:
                seq.append(("B", *b_unit(bi)))
                bi += 1
        units.append(seq)

    f_done: Dict[Tuple[int, int], int] = {}
    b_done: Dict[Tuple[int, int], int] = {}
    ptr = [0] * s_
    rows = []
    t = 0
    bound = 8 * (total + chunks) + 64
    while any(ptr[d] < len(units[d]) for d in range(s_)) and t < bound:
        row = []
        fired = []
        for d in range(s_):
            if ptr[d] >= len(units[d]):
                row.append(None)
                continue
            kind, j, m = units[d][ptr[d]]
            c = j * s_ + d
            if kind == "F":
                ready = c == 0 or f_done.get((c - 1, m), t) < t
            else:
                ready = (f_done.get((c, m), t) < t
                         and (c == chunks - 1
                              or b_done.get((c + 1, m), t) < t))
            if ready:
                row.append((kind, j, m))
                fired.append((d, kind, c, m))
                ptr[d] += 1
            else:
                row.append(None)
        # Recorded after the whole tick, so no unit sees a same-tick one.
        for d, kind, c, m in fired:
            (f_done if kind == "F" else b_done)[(c, m)] = t
        rows.append(row)
        t += 1
    if any(ptr[d] < len(units[d]) for d in range(s_)):
        raise AssertionError("interleaved schedule deadlocked "
                             f"(S={s_} V={v_} M={m_})")

    assert len(f_done) == len(b_done) == chunks * m_
    for (c, m), tf in f_done.items():
        assert b_done[(c, m)] > tf
        if c > 0:
            assert f_done[(c - 1, m)] < tf
        if c < chunks - 1:
            assert b_done[(c + 1, m)] < b_done[(c, m)]

    def alloc(intervals):
        """({(c, m): slot}, depth) for [start, end]-live values of one
        buffer kind, slots per chunk: a slot is reused only strictly after
        its previous occupant's last read."""
        by_chunk: Dict[int, list] = {}
        for start, end, key in intervals:
            by_chunk.setdefault(key[0], []).append((start, end, key))
        slots = {}
        depth = 1
        for ivs in by_chunk.values():
            nslots = 0
            free: List[int] = []
            active: List[Tuple[int, int]] = []  # (end, slot)
            for start, end, key in sorted(ivs):
                active.sort()
                while active and active[0][0] < start:
                    free.append(active.pop(0)[1])
                if free:
                    s = free.pop(0)
                else:
                    s = nslots
                    nslots += 1
                slots[key] = s
                active.append((end, s))
            depth = max(depth, nslots)
        return slots, depth

    stash_iv, pf_iv, pb_iv = [], [], []
    for (c, m), tf in f_done.items():
        stash_iv.append((tf, b_done[(c, m)], (c, m)))
        if c > 0:
            pf_iv.append((f_done[(c - 1, m)], f_done[(c, m)] - 1, (c, m)))
        if c < chunks - 1:
            pb_iv.append((b_done[(c + 1, m)], b_done[(c, m)] - 1, (c, m)))
    stash_slot, n_stash = alloc(stash_iv)
    pf_slot, n_pf = alloc(pf_iv)
    pb_slot, n_pb = alloc(pb_iv)

    n_ticks = len(rows)
    tbl: Dict[str, Any] = {
        k: np.zeros((n_ticks, s_), np.int32)
        for k in ("act", "jv", "mb", "slot", "fin_slot", "bin_slot",
                  "recv_f", "recv_f_j", "recv_f_slot",
                  "recv_b", "recv_b_j", "recv_b_slot")}
    tbl["n_stash"], tbl["n_pf"], tbl["n_pb"] = n_stash, n_pf, n_pb
    for t, row in enumerate(rows):
        for d, cell in enumerate(row):
            if cell is None:
                continue
            kind, j, m = cell
            c = j * s_ + d
            tbl["act"][t, d] = 1 if kind == "F" else 2
            tbl["jv"][t, d] = j
            tbl["mb"][t, d] = m
            tbl["slot"][t, d] = stash_slot[(c, m)]
            if kind == "F":
                if c > 0:
                    tbl["fin_slot"][t, d] = pf_slot[(c, m)]
                if c < chunks - 1:
                    e = (d + 1) % s_
                    tbl["recv_f"][t, e] = 1
                    tbl["recv_f_j"][t, e] = (c + 1) // s_
                    tbl["recv_f_slot"][t, e] = pf_slot[(c + 1, m)]
            else:
                if c < chunks - 1:
                    tbl["bin_slot"][t, d] = pb_slot[(c, m)]
                if c > 0:
                    e = (d - 1) % s_
                    tbl["recv_b"][t, e] = 1
                    tbl["recv_b_j"][t, e] = (c - 1) // s_
                    tbl["recv_b_slot"][t, e] = pb_slot[(c - 1, m)]
    return tbl


def gpipe_schedule(num_stages: int, microbatches: int):
    """GPipe as a tick table in the form of :func:`onef1b_schedule`:
    stage s runs F(m) at tick m + s, then, after the last forward, B(m) at
    tick (M + S - 1) + m + (S - 1 - s)."""
    s_, m_ = num_stages, microbatches
    f_ticks = m_ + s_ - 1
    table = [[None] * s_ for _ in range(2 * f_ticks)]
    for m in range(m_):
        for s in range(s_):
            table[m + s][s] = ("F", m)
            table[f_ticks + m + s_ - 1 - s][s] = ("B", m)
    return table


Unit = Tuple[str, int, int]  # (kind, chunk on the stage j, microbatch m)


def unit_table(schedule: str, num_stages: int, virtual: int,
               microbatches: int) -> List[List[Optional[Unit]]]:
    """The schedule's units per tick and stage, as (kind, j, m)."""
    if schedule == "1f1b-interleaved":
        tbl = onef1b_interleaved_schedule(num_stages, virtual, microbatches)
        kinds = {1: "F", 2: "B"}
        return [[(kinds[int(a)], int(j), int(m)) if a else None
                 for a, j, m in zip(act, jv, mb)]
                for act, jv, mb in zip(tbl["act"], tbl["jv"], tbl["mb"])]
    plain = gpipe_schedule if schedule == "gpipe" else onef1b_schedule
    return [[(op[0], 0, op[1]) if op else None for op in row]
            for row in plain(num_stages, microbatches)]


# --- the mesh ---------------------------------------------------------------------


class PipeMesh(NamedTuple):
    """The (data, pipe, model) layout of the job's processes: ``world``
    processes, ``model_procs`` (P_m) neighbouring ranks per model group
    holding the ``tp_shards`` (N) tensor-parallel shards, N / P_m each,
    ``procs`` (P) model groups per pipe group sharing the ``stages`` (S)
    stages, S / P each, ``data`` = world / (P·P_m). Ranks are data-major,
    model innermost: rank = (data_rank·P + pipe_rank)·P_m + model_rank.
    ``pipe_group`` is this process's pipe group (the same data and model
    rank), ``data_group`` the processes holding the same stages and model
    part, ``model_group`` its model group and ``replica_group`` the
    processes of its model rank (each None when it would hold one
    process, or when it is the world)."""

    world: int
    rank: int
    stages: int
    procs: int
    pipe_group: Any = None
    data_group: Any = None
    tp_shards: int = 1
    model_procs: int = 1
    model_group: Any = None
    replica_group: Any = None

    @property
    def data(self) -> int:
        return self.world // (self.procs * self.model_procs)

    @property
    def data_rank(self) -> int:
        return self.rank // (self.procs * self.model_procs)

    @property
    def pipe_rank(self) -> int:
        return (self.rank // self.model_procs) % self.procs

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_procs

    # The batch shard this process holds (data.lm_batches): its data
    # rank's, which its pipe and model groups share.
    @property
    def batch_rank(self) -> int:
        return self.data_rank

    @property
    def batch_ranks(self) -> int:
        return self.data

    @property
    def per_proc(self) -> int:
        return self.stages // self.procs

    def local_stages(self) -> range:
        first = self.pipe_rank * self.per_proc
        return range(first, first + self.per_proc)

    def owner(self, stage: int) -> int:
        """The rank of the process of this data and model rank that holds
        ``stage``."""
        return (self.data_rank * self.procs + stage // self.per_proc) \
            * self.model_procs + self.model_rank

    def tp(self) -> collectives.TPShards:
        return collectives.TPShards(self.tp_shards, self.model_procs,
                                    self.model_rank, self.model_group)


def make_pipe_mesh(world: Optional[int] = None, rank: Optional[int] = None,
                   pipeline: int = 1, tensor_parallel: int = 1,
                   num_slices: int = 1) -> PipeMesh:
    """The (data, pipe, model) mesh over the job's processes (default: the
    process group, or one process without one): P_m = min(world, N)
    processes per model group, P = min(world / P_m, S) model groups per
    pipe group, data = world / (P·P_m); S must split over P, N over P_m
    and the world over P·P_m; with ``num_slices`` > 1 each pipe x model
    group must fit inside one slice (:func:`collectives.check_slices`).
    With a process group, every process creates every group it may need
    (``dist.new_group`` is collective) and keeps its own."""
    grouped = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if grouped else 1
    if rank is None:
        rank = dist.get_rank() if grouped else 0
    if tensor_parallel < 1:
        raise ValueError(f"--tensor-parallel must be >= 1, got "
                         f"{tensor_parallel}")
    mprocs = min(world, tensor_parallel)
    if tensor_parallel % mprocs or world % mprocs:
        raise ValueError(f"--tensor-parallel {tensor_parallel} does not lay "
                         f"out over {world} processes")
    procs = min(world // mprocs, pipeline)
    if pipeline < 1 or pipeline % procs or world % (procs * mprocs):
        raise ValueError(f"--pipeline {pipeline} does not lay out over "
                         f"{world} processes")
    collectives.check_slices(world, procs * mprocs, "pipe x model",
                             num_slices)
    mesh = PipeMesh(world, rank, pipeline, procs, tp_shards=tensor_parallel,
                    model_procs=mprocs)
    if not grouped or world == 1:
        return mesh

    inner = procs * mprocs
    groups = {}
    if procs > 1:
        groups["pipe_group"] = collectives.own_group(rank, (
            list(range(first + m, first + inner, mprocs))
            for first in range(0, world, inner) for m in range(mprocs)))
    if world > inner:
        groups["data_group"] = collectives.own_group(
            rank, (list(range(r, world, inner)) for r in range(inner)))
    if mprocs > 1:
        groups["model_group"] = collectives.own_group(rank, (
            list(range(first, first + mprocs))
            for first in range(0, world, mprocs)))
        if world > mprocs:
            groups["replica_group"] = collectives.own_group(
                rank, (list(range(m, world, mprocs)) for m in range(mprocs)))
    return mesh._replace(**groups)


# --- the model ----------------------------------------------------------------------


class Stage(nn.Module):
    """One chunk of the block stack: ``blocks`` decoder blocks named
    ``block0``, ``block1``, ... (the reference's ``Stage``), each on the
    tensor-parallel shards ``tp`` with the q/k/v layout ``split_qkv``
    (None: split under GQA only)."""

    def __init__(self, args, blocks: int, device=None,
                 tp: collectives.TPShards = collectives.TPShards(),
                 split_qkv: Optional[bool] = None):
        super().__init__()
        block = compute.lm_block(args)
        dtype = moe.compute_dtype(args)
        self.blocks = blocks
        for i in range(blocks):
            self.add_module(f"block{i}", block(
                args.dim, args.heads, args.kv_heads, split_qkv,
                torch.float32, device, compute_dtype=dtype, tp=tp))

    def forward(self, x: torch.Tensor, attend: models.Attend) -> torch.Tensor:
        for i in range(self.blocks):
            x = getattr(self, f"block{i}")(x, attend)
        return x


def _layer_generator(device, seed: int, index: int) -> torch.Generator:
    """The generator of one seeded draw (a layer, or -1 for the embedding
    and head): the init of a layer does not depend on where it lives."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + index + 1) % (2 ** 63))
    return gen


@torch.no_grad()
def _init_block(block: models.DecoderBlock, gen: torch.Generator) -> None:
    """Dense weights normal with std 1/sqrt(fan_in), zero biases, unit
    LayerNorm scales (``TransformerLM.init_weights``'s scales). A weight
    split over tensor-parallel processes is drawn whole and this process's
    part kept, so the draw does not depend on the split."""
    split, tp = block.tp_dims(), block.tp
    for name, module in block.named_modules():
        if isinstance(module, nn.Linear):
            shape, fan_in = list(module.weight.shape), module.in_features
            dims = split.get(f"{name}.weight") if tp.procs > 1 else None
            if dims is not None:
                shape[dims[0]] *= tp.procs
                if dims[0] == 1:
                    fan_in *= tp.procs  # row-parallel: a part of the input
            draw = torch.randn(shape, generator=gen, device=gen.device)
            if dims is not None:
                draw = collectives.part_of(draw, *dims, tp.procs, tp.index)
            module.weight.copy_(draw / math.sqrt(fan_in))
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()


class PipelineLM:
    """This process's part of the pipelined LM: the embedding and the head
    whole, and the stage stacks of the chunks it holds (under tensor
    parallelism over processes, its model part of each split weight).

    ``params`` are the state's tensors by name: ``tok_embed`` [vocab,
    dim], ``pos_embed`` [seq, dim], ``stages.block{i}.<param>`` (a block
    param stacked ``[S / P, ...]``, or ``[V, S / P, ...]`` under the
    interleaved schedule), ``ln_f.scale``, ``ln_f.bias`` and ``head``
    [dim, vocab], all f32. ``chunks[(j, d)]`` is the :class:`Stage` of
    chunk ``j·S + d`` (d global); its parameters are views into the
    stacks, so the optimizer's in-place update of a stack is the chunk's
    update."""

    def __init__(self, args, mesh: PipeMesh, device):
        self.args, self.mesh, self.device = args, mesh, device
        self.dtype = moe.compute_dtype(args)
        self.S = mesh.stages
        self.V = virtual_stages(args)
        self.n_chunks = self.S * max(self.V, 1)
        if args.layers % self.n_chunks != 0:
            raise ValueError(
                f"--layers {args.layers} not divisible by --pipeline "
                f"{self.S}" + (f" x --virtual-stages {self.V}"
                               if self.V > 1 else ""))
        self.blocks = args.layers // self.n_chunks
        self.local = list(mesh.local_stages())
        self.tp = mesh.tp()
        if self.tp.shards > 1:
            models.validate_heads_dims(args.heads, args.kv_heads, args.dim,
                                       self.tp.shards)
        split = models.resolve_split_qkv(args.split_qkv, self.tp.shards, log)
        self.chunks: Dict[Tuple[int, int], Stage] = {}
        for j in range(max(self.V, 1)):
            for d in self.local:
                stage = Stage(args, self.blocks, device, self.tp,
                              split or None)
                c = j * self.S + d
                for i in range(self.blocks):
                    _init_block(getattr(stage, f"block{i}"), _layer_generator(
                        device, args.seed, c * self.blocks + i))
                self.chunks[(j, d)] = stage.requires_grad_(True)
        # Stack every chunk's params and make each a view of its stack.
        first = self.chunks[(0, self.local[0])]
        self.stage_names = [n for n, _p in first.named_parameters()]
        self.stacks: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for name in self.stage_names:
                leaves = [[dict(self.chunks[(j, d)].named_parameters())[name]
                           for d in self.local]
                          for j in range(max(self.V, 1))]
                stack = torch.stack([torch.stack(r) for r in leaves])
                self.stacks[name] = stack if self.V else stack[0]
            for (j, d), stage in self.chunks.items():
                for name, p in stage.named_parameters():
                    p.data = self.stack_slot(self.stacks[name], j, d)
        gen = _layer_generator(device, args.seed, -1)

        def normal(*shape):
            return torch.randn(shape, generator=gen, device=device) * 0.02

        # The embedding's gradient is taken by hand (Pipeline._run); the
        # head's goes through autograd.
        self.tok_embed = normal(args.vocab, args.dim)
        self.pos_embed = normal(args.seq_len, args.dim)
        self.head = normal(args.dim, args.vocab).requires_grad_(True)
        self.ln_f_scale = torch.ones(args.dim, device=device,
                                     requires_grad=True)
        self.ln_f_bias = torch.zeros(args.dim, device=device,
                                     requires_grad=True)
        self.params: Dict[str, torch.Tensor] = {
            "tok_embed": self.tok_embed, "pos_embed": self.pos_embed,
            **{f"stages.{n}": self.stacks[n] for n in self.stage_names},
            "ln_f.scale": self.ln_f_scale, "ln_f.bias": self.ln_f_bias,
            "head": self.head}

    def stack_slot(self, stack: torch.Tensor, j: int, d: int) -> torch.Tensor:
        """Chunk (j, d)'s entry of a local stack."""
        i = d - self.local[0]
        return stack[j, i] if self.V else stack[i]

    @property
    def stack_dim(self) -> int:
        """The stacks' pipe dim (the one split over a pipe group)."""
        return 1 if self.V else 0

    def tp_dims(self) -> Dict[str, Tuple[int, int]]:
        """{param name: (split dim, sections)} of the stage stacks split
        over the model group (``DecoderBlock.tp_dims`` one past the stack
        dims); empty without tensor parallelism."""
        stage = next(iter(self.chunks.values()))
        dims = {}
        for i in range(self.blocks):
            block = getattr(stage, f"block{i}")
            dims.update({f"stages.block{i}.{n}": (self.stack_dim + 1 + d, k)
                         for n, (d, k) in block.tp_dims().items()})
        return dims

    def head_params(self) -> List[torch.Tensor]:
        return [self.ln_f_scale, self.ln_f_bias, self.head]

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """``_embed`` (``pipeline.py:412``): tokens [B, T] -> [B, T, dim],
        the token and position rows added in the compute dtype."""
        t = tokens.shape[1]
        return self.tok_embed[tokens].to(self.dtype) \
            + self.pos_embed[:t].to(self.dtype)[None]

    def head_logits(self, x: torch.Tensor) -> torch.Tensor:
        """``_head_logits`` (``pipeline.py:418``): an f32 LayerNorm (eps
        1e-6), then the bias-free head in the compute dtype."""
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        xf = (xf - mean) * (var + models.LN_EPS) ** -0.5
        xf = xf * self.ln_f_scale + self.ln_f_bias
        return xf.to(self.dtype) @ self.head.to(self.dtype)


# --- the step -------------------------------------------------------------------------


class Pipeline:
    """The executor of one schedule's table over :class:`PipelineLM`.

    :meth:`loss_and_grads` runs a step's units tick by tick and returns
    the loss and the reduced f32 gradients by parameter name. The stash
    and the pending activations and cotangents are keyed by (chunk,
    microbatch) and freed when read, so they hold exactly the live values
    (the interleaved table's slot columns, which a static-shape scan
    needs, go unused); ``stash_peak`` records, per stage this process
    holds, the most microbatches stashed at once in the last run."""

    def __init__(self, args, model: PipelineLM):
        self.args, self.model = args, model
        self.mesh = model.mesh
        self.schedule = args.schedule
        self.M = args.microbatches
        self.grad_accum = args.grad_accum
        # Forward graphs kept to the backward (no recompute).
        self.keep_graph = self.schedule == "gpipe" or args.stash == "residuals"
        self.table = unit_table(self.schedule, model.S, max(model.V, 1),
                                self.M)
        # The reference's attend (pipeline.py:218): K1 / K2 in bf16, the
        # plain attention in f32.
        self.attend = moe.attend_for(model.dtype)(0)
        self.stash_peak: Dict[int, int] = {}

    def _exchange(self, sends, recvs) -> None:
        """Post one tick's sends (dst, tensor) and receives (src, tensor)
        together and wait for all of them."""
        ops = [dist.P2POp(dist.isend, t, dst) for dst, t in sends]
        ops += [dist.P2POp(dist.irecv, t, src) for src, t in recvs]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    def _run(self, tokens: torch.Tensor, seed: float,
             acc: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One pass of the table over ``tokens`` [b, T] (this data rank's
        rows, M microbatches), the loss seeded ``seed``: gradients add
        into ``acc``; returns this process's share of the loss."""
        model, mesh = self.model, self.mesh
        S, M, chunks = model.S, self.M, model.n_chunks
        b, t_len = tokens.shape
        if b % M:
            raise ValueError(f"per-data-rank batch {b} not divisible by "
                             f"microbatches={M}")
        tok_mb = tokens.reshape(M, b // M, t_len)
        act_shape = (b // M, t_len, self.args.dim)
        local = set(model.local)
        stash: Dict[Tuple[int, int], Any] = {}
        pend_f: Dict[Tuple[int, int], torch.Tensor] = {}
        pend_b: Dict[Tuple[int, int], torch.Tensor] = {}
        dys: Dict[int, torch.Tensor] = {}
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        self.stash_peak = {d: 0 for d in model.local}
        head_acc = [acc["ln_f.scale"], acc["ln_f.bias"], acc["head"]]

        def forward(c: int, j: int, d: int, m: int) -> torch.Tensor:
            x = model.embed(tok_mb[m]) if c == 0 else pend_f.pop((c, m))
            stage = model.chunks[(j, d)]
            if self.keep_graph:
                x = x.detach().requires_grad_(True)
                with torch.enable_grad():
                    y = stage(x, self.attend)
                stash[(c, m)] = (x, y)
            else:
                with torch.no_grad():
                    y = stage(x, self.attend)
                stash[(c, m)] = x
            return y.detach()

        def gpipe_loss() -> None:
            """The whole batch's loss and head gradient from the last
            chunk's outputs (``forward`` + ``next_token_nll``)."""
            nonlocal loss
            ys = [stash[(chunks - 1, m)][1].detach().requires_grad_(True)
                  for m in range(M)]
            with torch.enable_grad():
                lm = train.next_token_nll(
                    model.head_logits(torch.cat(ys)), tokens)
                grads = torch.autograd.grad(
                    lm, model.head_params() + ys,
                    grad_outputs=torch.tensor(seed, device=lm.device))
            for a, g in zip(head_acc, grads[:3]):
                a.add_(g)
            dys.update(enumerate(grads[3:]))
            loss = loss + lm.detach() * seed

        def backward(c: int, j: int, d: int, m: int) -> Optional[torch.Tensor]:
            nonlocal loss
            if self.schedule == "gpipe" and c == chunks - 1 and not dys:
                gpipe_loss()
            entry = stash.pop((c, m))
            stage = model.chunks[(j, d)]
            if self.keep_graph:
                x, y = entry
            else:
                x = entry.detach().requires_grad_(True)
                with torch.enable_grad():
                    y = stage(x, self.attend)
            if c == chunks - 1:
                if self.schedule == "gpipe":
                    dy = dys.pop(m)
                else:
                    # _seed_cotangent: the head+loss vjp seeded 1/M.
                    y_leaf = y.detach().requires_grad_(True)
                    with torch.enable_grad():
                        lm = train.next_token_nll(model.head_logits(y_leaf),
                                                  tok_mb[m])
                        *g_head, dy = torch.autograd.grad(
                            lm, model.head_params() + [y_leaf],
                            grad_outputs=torch.tensor(seed / M,
                                                      device=lm.device))
                    for a, g in zip(head_acc, g_head):
                        a.add_(g)
                    loss = loss + lm.detach() * (seed / M)
                    dy = dy.to(model.dtype)
            else:
                dy = pend_b.pop((c, m))
            params = list(stage.parameters())
            grads = torch.autograd.grad(y, params + [x], dy)
            for name, g in zip(model.stage_names, grads[:-1]):
                model.stack_slot(acc[f"stages.{name}"], j, d).add_(g)
            dx = grads[-1]
            if c == 0:
                # _embed_grad_if_first: the vjp of the embedding at dx.
                flat = tok_mb[m].reshape(-1)
                acc["tok_embed"].index_add_(
                    0, flat, dx.reshape(flat.numel(), -1).float())
                acc["pos_embed"][:t_len].add_(dx.sum(0).float())
                return None
            return dx

        for row in self.table:
            sends: List[Tuple[int, torch.Tensor]] = []
            recvs: List[Tuple[int, torch.Tensor]] = []
            arrived: List[Tuple[Dict, Tuple[int, int], torch.Tensor]] = []
            for d in model.local:
                cell = row[d]
                if cell is None:
                    continue
                kind, j, m = cell
                c = j * S + d
                if kind == "F":
                    out = forward(c, j, d, m)
                    key, dst, box = (c + 1, m), (c + 1) % S, pend_f
                    last = c == chunks - 1
                else:
                    out = backward(c, j, d, m)
                    key, dst, box = (c - 1, m), (c - 1) % S, pend_b
                    last = c == 0
                if last:
                    continue
                if dst in local:
                    box[key] = out
                else:
                    sends.append((mesh.owner(dst), out.contiguous()))
            for d in local:
                self.stash_peak[d] = max(self.stash_peak[d], sum(
                    1 for (c, _m) in stash if c % S == d))
            # What remote stages send this tick to the stages held here.
            for d, cell in enumerate(row):
                if cell is None or d in local:
                    continue
                kind, j, m = cell
                c = j * S + d
                if kind == "F" and c < chunks - 1 and (c + 1) % S in local:
                    buf = torch.empty(act_shape, dtype=model.dtype,
                                      device=model.device)
                    recvs.append((mesh.owner(d), buf))
                    arrived.append((pend_f, (c + 1, m), buf))
                elif kind == "B" and c > 0 and (c - 1) % S in local:
                    buf = torch.empty(act_shape, dtype=model.dtype,
                                      device=model.device)
                    recvs.append((mesh.owner(d), buf))
                    arrived.append((pend_b, (c - 1, m), buf))
            self._exchange(sends, recvs)
            for box, key, buf in arrived:
                box[key] = buf
        if stash or pend_f or pend_b:
            raise AssertionError(
                f"schedule left {len(stash)} stashed, {len(pend_f)} + "
                f"{len(pend_b)} pending values")
        return loss

    def loss_and_grads(self, tokens: torch.Tensor
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, f32 gradients by parameter name) of this data rank's
        ``tokens``, reduced over the mesh: stage gradients the mean over
        the data group, the embedding's and head's and the loss the sum
        over the data x pipe processes of this model rank divided by the
        data ranks (``_reduce_pipeline_grads``). Every model rank holds the
        same embedding, head and loss (``TPShards.enter`` has already
        summed the stage input's gradient over the model group), so each
        counts once; a split stage weight's gradient is its part's."""
        model, mesh = self.model, self.mesh
        acc = {n: torch.zeros_like(p, dtype=torch.float32)
               for n, p in model.params.items()}
        if self.schedule == "gpipe":
            k = self.grad_accum
            if tokens.shape[0] % k:
                raise ValueError(f"batch {tokens.shape[0]} not divisible by "
                                 f"grad_accum={k}")
            loss = sum(self._run(part, 1.0 / k, acc)
                       for part in tokens.chunk(k))
        else:
            loss = self._run(tokens, 1.0, acc)
        if mesh.procs * mesh.data > 1:
            replicated = [n for n in acc if not n.startswith("stages.")]
            flat = torch.cat([acc[n].reshape(-1) for n in replicated]
                             + [loss.reshape(1)])
            dist.all_reduce(flat, group=mesh.replica_group)
            flat /= mesh.data
            offset = 0
            for n in replicated:
                size = acc[n].numel()
                acc[n] = flat[offset:offset + size].view_as(acc[n])
                offset += size
            loss = flat[offset]
            if mesh.data > 1:
                staged = [n for n in acc if n.startswith("stages.")]
                flat = torch.cat([acc[n].reshape(-1) for n in staged])
                dist.all_reduce(flat, group=mesh.data_group)
                flat /= mesh.data
                offset = 0
                for n in staged:
                    size = acc[n].numel()
                    acc[n] = flat[offset:offset + size].view_as(acc[n])
                    offset += size
        return loss, acc


class Zero1(NamedTuple):
    """Where ZeRO-1 splits each parameter's optimizer state: ``dims`` by
    parameter name (absent: whole on every data rank), over ``size`` data
    ranks of which this process is ``rank``."""

    dims: Dict[str, int]
    size: int
    rank: int

    def view(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This data rank's part of ``t`` (a parameter or its gradient)."""
        if name not in self.dims:
            return t
        dim = self.dims[name]
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.rank * n, n)


def zero1_dims(model: PipelineLM, data: int, optimizer: str) -> Dict[str, int]:
    """The reference's ``state_shardings(zero1=True)`` rule for each
    parameter: a leaf of at least 1024 elements (counted on its whole
    array) splits on its first dim that neither the pipe nor the model
    axis splits (under ``--tensor-parallel`` N > 1, whether or not the
    shards share a process) and that ``data`` divides. adam8's moments are
    blocked along the last dim (``train.quantized_aware``): they split
    there only when the blocks split evenly (the part a multiple of the
    block), else stay whole."""
    tp_dims = model.tp_dims()
    dims = {}
    for name, p in model.params.items():
        shape = list(p.shape)
        taken = set()
        if name.startswith("stages."):
            taken.add(model.stack_dim)
            shape[model.stack_dim] = model.S  # the whole stack
        if name in tp_dims:
            taken.add(tp_dims[name][0])
            shape[tp_dims[name][0]] *= model.tp.procs
        last = len(shape) - 1
        if optimizer == "adam8":
            blocks = -(-shape[-1] // optimizers.BLOCK)
            shape[-1] = blocks * optimizers.BLOCK  # the reference's proxy
        if math.prod(shape) < ZERO1_MIN_ELEMENTS:
            continue
        for i, size in enumerate(shape):
            if i in taken or size % data:
                continue
            if optimizer == "adam8" and i == last and \
                    p.shape[-1] % (data * optimizers.BLOCK):
                break
            dims[name] = i
            break
    return dims


def opt_state_dims(opt_state, names: Sequence[str],
                   dims: Dict[str, int]) -> Dict[str, int]:
    """``dims`` (by parameter name) mapped onto the optimizer state's
    tensor names (``mu.<i>`` / ``nu.<i>``, adam8's ``m.q.<i>`` /
    ``m.scale.<i>`` / ``v.q.<i>`` / ``v.scale.<i>``): adam8's block dims
    take a split of the parameter's last dim on their block-count dim."""
    out = {}
    index = {i: n for i, n in enumerate(names)}
    for key, t in opt_state.state_dict().items():
        parts = key.split(".")
        if not t.dim() or not parts[-1].isdigit():
            continue
        name = index[int(parts[-1])]
        if name not in dims:
            continue
        dim = dims[name]
        out[key] = min(dim, t.dim() - 1 - (parts[1] == "q"))
    return out


class Built(NamedTuple):
    model: PipelineLM
    pipeline: Pipeline
    optimizer: Any
    opt_state: Any
    step: Callable[[torch.Tensor], train.Metrics]
    batches: Iterator[Tuple]
    device: torch.device
    mesh: PipeMesh
    zero1: Optional[Zero1]

    @property
    def state(self) -> checkpoint.TrainState:
        """The params and optimizer state the step updates in place, with
        the split of the stage stacks over the pipe group, of the split
        weights and their moments over the model group and of the ZeRO-1
        moments over the data group, and the layout (a restore across
        another ``--pipeline``, ``--virtual-stages`` or ``--zero1`` is
        refused; ``--tensor-parallel`` is not part of it)."""
        model, mesh = self.model, self.mesh
        shards = None
        if self.zero1 is not None and mesh.data > 1:
            shards = checkpoint.Shards(
                {checkpoint.OPT_FILE: opt_state_dims(
                    self.opt_state, list(model.params), self.zero1.dims)},
                mesh.data_group, mesh.data, mesh.data_rank)
        if mesh.model_procs > 1:
            shards = self._tp_shards(shards)
        if mesh.procs > 1:
            names = list(model.params)
            staged = {i for i, n in enumerate(names)
                      if n.startswith("stages.")}
            opt = {n: model.stack_dim
                   for n, t in self.opt_state.state_dict().items()
                   if t.dim() and n.rsplit(".", 1)[-1].isdigit()
                   and int(n.rsplit(".", 1)[-1]) in staged}
            shards = checkpoint.Shards(
                {checkpoint.PARAMS_FILE: {names[i]: model.stack_dim
                                          for i in staged},
                 checkpoint.OPT_FILE: opt},
                mesh.pipe_group, mesh.procs, mesh.pipe_rank, inner=shards)
        return checkpoint.TrainState(
            dict(model.params), self.opt_state, shards=shards,
            model={"name": "pipeline", "pipeline": model.S,
                   "virtualStages": model.V, "zero1": self.zero1 is not None})

    def _tp_shards(self, inner: Optional[checkpoint.Shards]
                   ) -> checkpoint.Shards:
        """The split stage weights and their moments (``mu.<i>`` /
        ``nu.<i>``, shaped as their param or as its ZeRO-1 part) over the
        model group. adam8's block-quantized moments do not split along a
        param's dims: refused, as the transformer payload refuses them."""
        model, mesh = self.model, self.mesh
        dims = model.tp_dims()
        names = list(model.params)
        opt = {}
        for key, t in self.opt_state.state_dict().items():
            index = key.rsplit(".", 1)[-1]
            if not t.dim() or not index.isdigit():
                continue
            name = names[int(index)]
            if name not in dims:
                continue
            param = model.params[name]
            want = self.zero1.view(name, param) if self.zero1 else param
            if t.shape != want.shape:
                raise ValueError(
                    f"optimizer state {key} {tuple(t.shape)} is not shaped "
                    f"as its param {name} {tuple(want.shape)}: it does not "
                    f"split over --tensor-parallel processes for a "
                    f"checkpoint (use --optimizer adam)")
            opt[key] = dims[name]
        return checkpoint.Shards({checkpoint.PARAMS_FILE: dims,
                                  checkpoint.OPT_FILE: opt},
                                 mesh.model_group, mesh.model_procs,
                                 mesh.model_rank, inner=inner)


def opt_targets(model: PipelineLM, zero1: Optional[Zero1]
                ) -> List[torch.Tensor]:
    """The tensors the optimizer updates: each parameter, or under
    ZeRO-1 this data rank's part of it (a view, made outside autograd)."""
    with torch.no_grad():
        return [zero1.view(n, p) if zero1 else p
                for n, p in model.params.items()]


def make_pipe_train_step(pipe: Pipeline, optimizer, opt_state,
                         zero1: Optional[Zero1]
                         ) -> Callable[[torch.Tensor], train.Metrics]:
    """``step(tokens) -> {"loss"}``: :meth:`Pipeline.loss_and_grads`, then
    the optimizer update in place, on this data rank's ZeRO-1 part of
    each parameter when ``zero1`` is given, its parts then all-gathered
    over the data group."""
    model = pipe.model
    names = list(model.params)
    params = [model.params[n] for n in names]
    targets = opt_targets(model, zero1)
    split = [i for i, n in enumerate(names) if zero1 and n in zero1.dims
             and zero1.size > 1]

    def step(tokens: torch.Tensor) -> train.Metrics:
        loss, grads = pipe.loss_and_grads(tokens)
        for n, target in zip(names, targets):
            target.grad = zero1.view(n, grads[n]) if zero1 else grads[n]
        optimizer.step(targets, opt_state)
        for target in targets:
            target.grad = None
        if split:
            with torch.no_grad():
                mine = torch.cat([targets[i].reshape(-1) for i in split])
                parts = [torch.empty_like(mine) for _ in range(zero1.size)]
                dist.all_gather(parts, mine, group=pipe.mesh.data_group)
                for r, part in enumerate(parts):
                    offset = 0
                    for i in split:
                        dim = zero1.dims[names[i]]
                        n = params[i].shape[dim] // zero1.size
                        dst = params[i].narrow(dim, r * n, n)
                        dst.copy_(part[offset:offset + dst.numel()]
                                  .view(dst.shape))
                        offset += dst.numel()
        return {"loss": loss.detach()}

    return step


def check_schedule(args, mesh: PipeMesh) -> None:
    """The reference's schedule contracts (``make_pipe_train_step``
    ``:1255-1273``), refused at build."""
    schedule = args.schedule
    if args.stash != "input" and schedule != "1f1b":
        raise ValueError(
            f"--stash residuals is a plain-1f1b knob; --schedule "
            f"{schedule} does not consume it")
    if schedule in ("1f1b", "1f1b-interleaved"):
        if args.grad_accum != 1:
            raise ValueError(
                "--schedule 1f1b already streams microbatches; use "
                "--microbatches instead of --grad-accum")
        if schedule == "1f1b-interleaved" \
                and args.microbatches % mesh.stages != 0:
            raise ValueError(
                f"interleaved 1F1B needs --microbatches "
                f"({args.microbatches}) divisible by --pipeline "
                f"({mesh.stages})")


def build(args, device=None, mesh: Optional[PipeMesh] = None,
          num_slices: int = 1) -> Built:
    """Model (seeded init), optimizer and its state, step and host batches
    for the flags. ``device`` defaults to ``--device`` (CUDA unless it
    says ``cpu``); ``mesh`` to the (data, pipe, model) mesh of the job's
    process group at ``--pipeline`` and ``--tensor-parallel`` over
    ``num_slices`` slices."""
    mesh = mesh or make_pipe_mesh(pipeline=args.pipeline,
                                  tensor_parallel=args.tensor_parallel,
                                  num_slices=num_slices)
    if (mesh.stages, mesh.tp_shards) != (args.pipeline,
                                         args.tensor_parallel):
        raise ValueError(f"mesh has {mesh.stages} stages and "
                         f"{mesh.tp_shards} tensor-parallel shards, the "
                         f"flags {args.pipeline} and {args.tensor_parallel}")
    grad_accum = args.grad_accum
    if grad_accum < 1 or \
            args.batch % (mesh.data * args.microbatches * grad_accum):
        raise ValueError(
            f"--batch {args.batch} must divide by data shards x "
            f"microbatches x grad_accum ({mesh.data} x "
            f"{args.microbatches} x {grad_accum})")
    virtual_stages(args)
    check_schedule(args, mesh)
    dev = resolve_device(device if device is not None
                         else (args.device or None))
    model = PipelineLM(args, mesh, dev)
    pipe = Pipeline(args, model)
    optimizer = optimizers.from_args(args)
    zero1 = None
    if args.zero1:
        optim = getattr(args, "optimizer", "adam")
        zero1 = Zero1(zero1_dims(model, mesh.data, optim), mesh.data,
                      mesh.data_rank)
    opt_state = optimizer.init(opt_targets(model, zero1))
    step = make_pipe_train_step(pipe, optimizer, opt_state, zero1)
    return Built(model, pipe, optimizer, opt_state, step,
                 data_mod.lm_batches(args, mesh), dev, mesh, zero1)


def run(info: bootstrap.ProcessInfo, args=None) -> dict:
    args = args or parse_args([])
    built = build(args, num_slices=info.num_slices)
    mesh = built.mesh
    log.info("mesh: {'data': %d, 'pipe': %d, 'model': %d} over %d "
             "processes (%d stages and %d tensor-parallel shards a "
             "process); %d layers / %d stages, %d microbatches, schedule "
             "%s, %s on %s", mesh.data, mesh.procs, mesh.model_procs,
             mesh.world, mesh.per_proc, mesh.tp_shards // mesh.model_procs,
             args.layers, args.pipeline, args.microbatches, args.schedule,
             args.dtype, built.device)
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
            prefetch=autotune.resolve_prefetch_depth(args.prefetch_depth),
            checkpointer=ckpt, state=built.state,
            profile_dir=args.profile_dir,
            compile_fn=train.kernel_loader(built.device))
    finally:
        if ckpt is not None:
            ckpt.close()
    log.info("final: loss %.4f", metrics.get("loss", float("nan")))
    if built.device.type == "cuda":
        log.info("kernel launches: %s", json.dumps(fa.launch_counts()))
    return metrics


def main() -> None:
    args = parse_args()
    bootstrap.main_wrapper(lambda info: run(info, args),
                           device=args.device or None)


if __name__ == "__main__":
    main()
