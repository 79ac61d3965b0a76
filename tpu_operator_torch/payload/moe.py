"""Expert-parallel mixture-of-experts LM training payload, one process per
CUDA card (counterpart of ``tpu_operator/payload/moe.py``).

    python -m tpu_operator_torch.payload.moe --dim 1024 --layers 8 \\
        --heads 8 --kv-heads 4 --experts 8 --batch 8 --seq-len 2048 \\
        --vocab 32768 --capacity-factor 1.25

trains the reference's bench row (``bench.py:730``
``moe_e8_top2_single_chip``) on the synthetic recurrence; ``--device cpu``
with small widths runs the plain PyTorch path. The design is the
reference's GShard / Switch recipe:

- every odd block is MoE (:class:`MoEMLP` in the block's MLP hook,
  ``models.DecoderBlock``); the others keep the dense FFN;
- top-2 routing in index form (:func:`top2_routing`): f32 router logits
  from the f32 LayerNorm output, cumsum slot bookkeeping (no sort),
  second choices filling after every first choice, capacity
  ``max(4, ceil(2 n cf / E))`` per group (a batch row), overflow dropped;
- ``--dispatch einsum`` moves tokens with the one-hot ``[G, n, E, C]``
  products, ``--dispatch gather`` through a unique-slot buffer; both read
  the same routing, so they agree;
- bf16 expert products from f32 master stacks ``w1`` ``[E, D, 4D]`` and
  ``w2`` ``[E, 4D, D]``, tanh GELU between them;
- the loss is ``lm + aux_coef * aux + router_z_coef * z``, aux (Switch
  load balance) and z (router z-loss) the means over the MoE layers;
  ``drop_frac`` is reported beside them.

The attention is the differentiable flash attention in bf16 (the K1
forward and K2 backward kernels on the card, through the ``flash_fwd`` /
``flash_bwd`` custom ops), and the plain attention under ``--dtype f32``,
as the reference's ``attend`` chooses.

Expert parallelism (``--expert-parallel N``, :func:`make_moe_mesh`): the
processes form a (data, expert, model) mesh, model innermost: ``P_m =
min(world, --tensor-parallel)`` neighbouring processes form a model
group, ``P_e = min(world / P_m, N)`` model groups an expert group, and
each process holds ``E / P_e`` experts of every MoE layer and their
optimizer moments. Unlike the reference, which shards the batch over
``data`` only and replicates it across an expert group, every model group
holds a batch shard of its own (``world / P_m`` shards): it routes its
rows, sends each expert's slots to the process that holds the expert and
takes the outputs back (two autograd all-to-alls a layer, the exchange
the reference's docstring describes). Routing, capacity and the aux,
z and drop scalars are per row, so the loss is the reference's.

EP x TP (``--tensor-parallel``, the reference's ``moe.py:330-337`` and
``:445-461``): inside each expert shard the FFN is the Megatron pair,
``w1`` ``[E/P_e, D, 4D/N]`` column-parallel and ``w2`` ``[E/P_e, 4D/N,
D]`` row-parallel, GELU per shard and one ``TPShards.reduce`` of the
``w2`` products per layer, before the combine; the dense blocks and the
vocab-split ``lm_head`` follow the transformer's rule
(``models.DecoderBlock._forward_tp``) and the router stays whole. The N
shards run as units of ``N / P_m`` a process (one process may hold them
all). Every model rank computes the same routing, loss and aux / z /
drop scalars, so those count once: the dense parameters' gradients
(whole or split) and the metrics are averaged over the processes of one
model rank, and the expert stacks' summed over the processes that hold
the same experts and the same model part, divided by the batch shards
(``train.all_reduce_grads``). A checkpoint holds whole stacks and whole
split weights: process 0 gathers them at a save, and a restore takes
this process's part (``checkpoint.Shards``), so a save under one layout
restores under another.

``--checkpoint-dir`` (or ``$TPU_CHECKPOINT_DIR``), ``--profile-dir`` and
``--prefetch-depth`` work as in the transformer payload: the loop is
``train.train_loop``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
import os
import threading
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, \
    Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
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
from tpu_operator_torch.payload import optimizers
from tpu_operator_torch.payload import train
from tpu_operator_torch.payload import transformer

log = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=16, help="global batch size")
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--kv-heads", type=int, default=0,
                   help="grouped-query attention K/V heads (0 = MHA, "
                        "1 = MQA); must divide --heads")
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--experts", type=int, default=4,
                   help="experts per MoE layer (--expert-parallel must "
                        "divide it)")
    p.add_argument("--expert-parallel", type=int, default=1,
                   help="expert-parallel shards: the job's processes form "
                        "expert groups of min(world, N) neighbouring "
                        "processes, each holding E / that many experts")
    p.add_argument("--tensor-parallel", type=int, default=1,
                   help="tensor-parallel shards inside each expert shard "
                        "(and of the dense blocks): model groups of "
                        "min(world, N) neighbouring processes, N / that "
                        "many shards a process")
    p.add_argument("--capacity-factor", type=float, default=1.25)
    p.add_argument("--split-qkv", choices=("auto", "on", "off"),
                   default="auto",
                   help="separate q/k/v projections (on) or a fused one "
                        "(auto / off without --tensor-parallel); grouped "
                        "K/V always split")
    p.add_argument("--aux-coef", type=float, default=1e-2,
                   help="load-balance auxiliary loss coefficient")
    p.add_argument("--router-z-coef", type=float, default=1e-3,
                   help="router z-loss coefficient (ST-MoE): penalizes "
                        "mean(logsumexp(router logits)^2)")
    p.add_argument("--dispatch", choices=("einsum", "gather"),
                   default="einsum",
                   help="token -> expert dispatch: einsum = GShard one-hot "
                        "products; gather = scatter / gather through a "
                        "unique-slot buffer (the same routing, the same "
                        "result)")
    p.add_argument("--dtype", choices=("bf16", "f32"), default="bf16",
                   help="compute dtype (params stay f32); f32 takes the "
                        "plain attention, as the reference does")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="accumulate gradients over K sequential "
                        "microbatches")
    compute.add_lm_compute_flags(p)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--data", default=os.environ.get("TPU_DATA_PATH", ""),
                   help="mounted .npy token file (1-D int array); empty = "
                        "synthetic recurrence")
    p.add_argument("--checkpoint-dir", default="",
                   help="checkpoint/resume dir (default: "
                        "$TPU_CHECKPOINT_DIR)")
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


def check_flags(args) -> None:
    """The reference's ValueErrors for experts that do not split over
    ``--expert-parallel`` (``moe.py:368``) and, under tensor
    parallelism, for heads, K/V heads or a width that do not split over
    ``--tensor-parallel`` (``models.validate_heads_dims``, which the
    reference's ``_build_model`` calls); at TP 1 the head counts are the
    block's to check (``models.DecoderBlock``)."""
    if args.tensor_parallel > 1:
        models.validate_heads_dims(args.heads, args.kv_heads, args.dim,
                                   args.tensor_parallel)
    if args.expert_parallel < 1 or args.experts % args.expert_parallel:
        raise ValueError(
            f"--experts {args.experts} not divisible by the mesh expert "
            f"axis ({args.expert_parallel})")


# --- routing -----------------------------------------------------------------


def capacity_of(tokens: int, experts: int, capacity_factor: float) -> int:
    """Slots per expert and group of ``tokens`` (``moe.py:283``)."""
    return max(4, int(math.ceil(2 * tokens * capacity_factor / experts)))


def top2_routing(logits: torch.Tensor, capacity: int) -> Dict[str, Any]:
    """Top-2 routing of ``[G, n, E]`` router logits in index form, in f32
    (the reference's ``top2_routing``, the one definition both dispatch
    modes read). A token's slot in an expert is the count of earlier
    tokens of its group routed there (cumsum, no sort); second choices
    fill after every first choice; slots >= ``capacity`` drop. ``argmax``
    takes the first of tied maxima, as ``jnp.argmax`` does.

    Returns the ``[G, n]`` ``idx`` / ``slot`` / ``kept`` / ``gate`` of each
    choice, the ``[G, n, E]`` ``keep`` / ``pos`` masks the one-hot path
    needs, and three scalars: ``aux`` (the Switch loss E * sum_e f_e p_e,
    a mean over groups), ``z_loss`` (mean logsumexp(logits)^2) and
    ``drop_frac`` (the share of the 2 n routed assignments a group drops,
    averaged; no gradient)."""
    logits = logits.float()
    probs = torch.softmax(logits, dim=-1)
    num_experts = probs.shape[-1]
    idx1 = probs.argmax(dim=-1)
    mask1 = F.one_hot(idx1, num_experts).float()
    idx2 = (probs * (1.0 - mask1)).argmax(dim=-1)
    mask2 = F.one_hot(idx2, num_experts).float()

    f_e = mask1.mean(dim=1)
    p_e = probs.mean(dim=1)
    aux = num_experts * (f_e * p_e).sum(dim=-1).mean()
    z = torch.logsumexp(logits, dim=-1)
    z_loss = (z * z).mean()

    pos1 = torch.cumsum(mask1, dim=1) * mask1 - mask1
    count1 = mask1.sum(dim=1, keepdim=True)
    pos2 = (torch.cumsum(mask2, dim=1) * mask2 - mask2) + count1
    keep1 = mask1 * (pos1 < capacity)
    keep2 = mask2 * (pos2 < capacity)
    n_tokens = logits.shape[0] * logits.shape[1]
    drop_frac = 1.0 - (keep1.sum() + keep2.sum()) / (2.0 * n_tokens)

    gate1 = (probs * keep1).sum(dim=-1)
    gate2 = (probs * keep2).sum(dim=-1)
    denom = torch.clamp(gate1 + gate2, min=1e-9)
    gate1, gate2 = gate1 / denom, gate2 / denom
    return {
        "idx1": idx1, "idx2": idx2,
        "slot1": pos1.sum(dim=-1).int(),
        "slot2": (pos2 * mask2).sum(dim=-1).int(),
        "keep1": keep1, "keep2": keep2,
        "kept1": keep1.sum(dim=-1), "kept2": keep2.sum(dim=-1),
        "pos1": pos1, "pos2": pos2,
        "gate1": gate1, "gate2": gate2,
        "aux": aux, "z_loss": z_loss, "drop_frac": drop_frac.detach(),
    }


def _slots(keep: torch.Tensor, pos: torch.Tensor,
           capacity: int) -> torch.Tensor:
    """``[G, n, E]`` keep mask and slot positions -> ``[G, n, E, C]`` f32
    one-hot over capacity: ``keep`` written at slot ``pos * keep`` (the
    reference's ``keep * one_hot(pos * keep)``, with no int64 one-hot in
    between)."""
    out = keep.new_zeros(*keep.shape, capacity)
    return out.scatter_(-1, (pos * keep).long()[..., None], keep[..., None])


class _GatedSlots(torch.autograd.Function):
    """``gate[..., None, None] * _slots(keep, pos)``: one choice's share of
    the combine tensor. The backward gathers the gate's gradient at the
    kept slots, so autograd keeps the ``[G, n, E]`` masks and not the
    ``[G, n, E, C]`` one-hot (the reference's product saves the one-hot;
    the gradient is the same single nonzero term of its sum)."""

    @staticmethod
    def forward(ctx, gate, keep, pos, capacity: int):
        ctx.save_for_backward(keep, pos)
        return gate[..., None, None] * _slots(keep, pos, capacity)

    @staticmethod
    def backward(ctx, grad):
        keep, pos = ctx.saved_tensors
        at = grad.gather(-1, (pos * keep).long()[..., None])[..., 0]
        return (at * keep).sum(dim=-1), None, None, None


def onehot_tensors(r: Dict[str, Any], capacity: int):
    """Routing -> (dispatch ``[G, n, E, C]`` f32 0/1, combine ``[G, n, E,
    C]`` f32, aux, drop_frac): the einsum path's one-hot tensors (the
    reference's ``_onehot_tensors``)."""
    dispatch = _slots(r["keep1"], r["pos1"], capacity) \
        + _slots(r["keep2"], r["pos2"], capacity)
    combine = _GatedSlots.apply(r["gate1"], r["keep1"], r["pos1"], capacity) \
        + _GatedSlots.apply(r["gate2"], r["keep2"], r["pos2"], capacity)
    return dispatch, combine, r["aux"], r["drop_frac"]


def top2_dispatch(logits: torch.Tensor, capacity: int):
    """One-hot form of :func:`top2_routing`: (dispatch, combine, aux,
    drop_frac)."""
    return onehot_tensors(top2_routing(logits, capacity), capacity)


# --- the sown scalars ----------------------------------------------------------

_SOWN = threading.local()


@contextlib.contextmanager
def sown():
    """``with sown() as rows:`` collects ``(aux, z_loss, drop_frac)`` of
    every MoE layer the forward inside runs (the reference's ``sow`` into
    ``intermediates``). A remat block replays its forward in the
    backward, outside any such region, so the replay adds nothing: the
    scalars are counted once a step."""
    prev = getattr(_SOWN, "rows", None)
    rows: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []
    _SOWN.rows = rows
    try:
        yield rows
    finally:
        _SOWN.rows = prev


def _sow(r: Dict[str, Any]) -> None:
    rows = getattr(_SOWN, "rows", None)
    if rows is not None:
        rows.append((r["aux"], r["z_loss"], r["drop_frac"]))


# --- expert parallelism ---------------------------------------------------------


class ExpertShard(NamedTuple):
    """This process's part of the experts: the expert group of ``size``
    processes (``group``, None with one), this process's place ``rank``
    in it."""

    size: int = 1
    rank: int = 0
    group: Any = None


def _to_experts(x: torch.Tensor, shard: ExpertShard) -> torch.Tensor:
    """``[E, G, C, D]`` slots of this process's rows -> ``[E/P, P*G, C,
    D]``: every process's slots of the experts held here, in process
    order."""
    if shard.size == 1:
        return x
    e, g, c, d = x.shape
    p = shard.size
    got = collectives.AllToAll.apply(x.reshape(p, e // p, g, c, d), shard.group)
    return got.transpose(0, 1).reshape(e // p, p * g, c, d)


def _from_experts(y: torch.Tensor, shard: ExpertShard) -> torch.Tensor:
    """The inverse of :func:`_to_experts`: ``[E/P, P*G, C, D]`` -> ``[E,
    G, C, D]``, this process's rows for every expert."""
    if shard.size == 1:
        return y
    el, pg, c, d = y.shape
    p = shard.size
    y = y.reshape(el, p, pg // p, c, d).transpose(0, 1).contiguous()
    return collectives.AllToAll.apply(y, shard.group).reshape(el * p, pg // p, c, d)


# --- the MoE MLP ---------------------------------------------------------------


class MoEMLP(nn.Module):
    """The reference's ``MoEMLP``: route, dispatch, expert products,
    combine, over groups G = batch rows. Takes the f32 ``ln_mlp`` output
    ``[G, n, D]`` and returns ``[G, n, D]`` in the compute dtype.

    Params: ``router`` (``[E, D]``, no bias, f32 product on the f32
    input, whole under TP), ``w1`` ``[E/P, D, 4D]`` and ``w2`` ``[E/P, 4D,
    D]`` (this process's experts of the f32 master stacks, cast to the
    compute dtype at use). Under ``tp`` (N shards, N / P_m a process) this
    process holds ``w1``'s columns and ``w2``'s rows of its shards'
    ``4D / N`` hidden units each: every shard takes the experts' input
    through ``tp.enter``, runs its ``w1`` product and the GELU on its
    hidden units, and the shards' ``w2`` partial products are summed once
    (``tp.reduce``) before the combine.

    ``dispatch`` ``einsum``: the one-hot products ``gnec,gnd->egcd`` and
    ``gnec,egcd->gnd`` (plain matrix products in the reference too);
    ``gather``: each kept assignment added into its own row of a ``[G,
    E*C + 2n, D]`` slot buffer, a dropped one into a private dump row, and
    the expert outputs read back by the same rows."""

    def __init__(self, dim: int, experts: int, capacity_factor: float,
                 dispatch: str = "einsum",
                 compute_dtype: Optional[torch.dtype] = None,
                 shard: ExpertShard = ExpertShard(),
                 param_dtype: torch.dtype = torch.float32, device=None,
                 tp: collectives.TPShards = collectives.TPShards()):
        super().__init__()
        if dispatch not in ("einsum", "gather"):
            raise ValueError(f"unknown dispatch {dispatch!r}")
        if experts % shard.size:
            raise ValueError(f"{experts} experts do not split over "
                             f"{shard.size} processes")
        self.dim, self.experts = dim, experts
        self.capacity_factor = capacity_factor
        self.dispatch, self.compute_dtype = dispatch, compute_dtype
        self.shard, self.tp = shard, tp
        local = experts // shard.size
        hidden = 4 * dim * tp.local // tp.shards
        w = dict(dtype=param_dtype, device=device)
        self.router = nn.Linear(dim, experts, bias=False, **w)
        self.w1 = nn.Parameter(torch.empty(local, dim, hidden, **w))
        self.w2 = nn.Parameter(torch.empty(local, hidden, dim, **w))

    def tp_dims(self) -> Dict[str, Tuple[int, int]]:
        """{param name: (split dim, sections)} of the stacks split over the
        model group: ``w1`` by column (dim 2), ``w2`` by row (dim 1)."""
        if self.tp.shards == 1:
            return {}
        return {"w1": (2, 1), "w2": (1, 1)}

    def part(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This process's part of a whole ``[E, ...]`` stack: its experts,
        and under TP over processes its model part of them."""
        t = whole.chunk(self.shard.size)[self.shard.rank]
        dims = self.tp_dims()
        if name in dims and self.tp.procs > 1:
            t = collectives.part_of(t, *dims[name], self.tp.procs,
                                    self.tp.index)
        return t

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The whole stacks drawn normal with std 1/sqrt(fan_in) (fan_in
        D for w1, 4D for w2: the expert dim is a batch dim, as
        ``lecun_normal(batch_axis=0)`` has it), this process's part kept:
        any expert or tensor parallelism draws the same weights."""
        d, f = self.dim, 4 * self.dim
        for name, shape, fan_in in (("w1", (d, f), d), ("w2", (f, d), f)):
            whole = torch.randn((self.experts, *shape), generator=generator,
                                device=generator.device, dtype=torch.float32)
            getattr(self, name).copy_(
                self.part(name, whole).mul_(1.0 / math.sqrt(fan_in)))

    def _experts(self, expert_in: torch.Tensor, dt) -> torch.Tensor:
        """``[E/P, P*G, C, D]`` slots -> the experts' outputs, each shard
        of ``tp`` on its hidden units and the ``w2`` partials summed."""
        if self.tp.shards == 1:
            h = torch.einsum("egcd,edf->egcf", expert_in, self.w1.to(dt))
            h = F.gelu(h, approximate="tanh")
            return torch.einsum("egcf,efd->egcd", h, self.w2.to(dt))
        fw = 4 * self.dim // self.tp.shards
        parts = []
        for u, xu in enumerate(self.tp.enter(expert_in)):
            h = torch.einsum("egcd,edf->egcf", xu,
                             self.w1.narrow(2, u * fw, fw).to(dt))
            h = F.gelu(h, approximate="tanh")
            parts.append(torch.einsum("egcf,efd->egcd", h,
                                      self.w2.narrow(1, u * fw, fw).to(dt)))
        return self.tp.reduce(parts)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g, n, d = x.shape
        e = self.experts
        capacity = capacity_of(n, e, self.capacity_factor)
        dt = self.compute_dtype or models.COMPUTE_DTYPE
        r = top2_routing(F.linear(x.float(), self.router.weight.float()),
                         capacity)
        _sow(r)
        xd = x.to(dt)
        if self.dispatch == "gather":
            rows = e * capacity + 2 * n
            tok = torch.arange(n, device=x.device)[None, :]
            f1 = torch.where(r["kept1"] > 0,
                             r["idx1"] * capacity + r["slot1"],
                             e * capacity + tok)
            f2 = torch.where(r["kept2"] > 0,
                             r["idx2"] * capacity + r["slot2"],
                             e * capacity + n + tok)
            base = (torch.arange(g, device=x.device) * rows)[:, None]
            flat1, flat2 = (base + f1).reshape(-1), (base + f2).reshape(-1)
            # Every kept assignment owns its slot and every dropped one
            # its dump row, so the indices are unique: each row receives
            # one addition into zero, and index_add (atomic on CUDA) is
            # deterministic here, as is its backward, an index_select.
            buf = xd.new_zeros(g * rows, d).index_add(
                0, torch.cat([flat1, flat2]),
                torch.cat([xd.reshape(-1, d), xd.reshape(-1, d)]))
            expert_in = buf.view(g, rows, d)[:, :e * capacity].reshape(
                g, e, capacity, d).transpose(0, 1)
        else:
            dispatch, combine, _aux, _drop = onehot_tensors(r, capacity)
            # The f32 one-hots are cast once; only the compute-dtype
            # copies are held for the backward.
            dispatch, combine = dispatch.to(dt), combine.to(dt)
            expert_in = torch.einsum("gnec,gnd->egcd", dispatch, xd)
        expert_out = _from_experts(
            self._experts(_to_experts(expert_in, self.shard), dt),
            self.shard)
        if self.dispatch == "gather":
            out_full = torch.cat([
                expert_out.transpose(0, 1).reshape(g, e * capacity, d),
                expert_out.new_zeros(g, 2 * n, d)], dim=1).reshape(-1, d)
            y1 = out_full.index_select(0, flat1).view(g, n, d)
            y2 = out_full.index_select(0, flat2).view(g, n, d)
            return (r["gate1"][..., None].to(dt) * y1
                    + r["gate2"][..., None].to(dt) * y2)
        return torch.einsum("gnec,egcd->gnd", combine, expert_out)


def compute_dtype(args) -> torch.dtype:
    return torch.bfloat16 if args.dtype == "bf16" else torch.float32


def mlp_factory(args, shard: ExpertShard = ExpertShard(),
                tp: collectives.TPShards = collectives.TPShards()
                ) -> models.MlpFactory:
    """The block MLP hook's factory of the flags' :class:`MoEMLP`."""
    dtype = compute_dtype(args)

    def make(param_dtype, device):
        return MoEMLP(args.dim, args.experts, args.capacity_factor,
                      dispatch=args.dispatch, compute_dtype=dtype,
                      shard=shard, param_dtype=param_dtype, device=device,
                      tp=tp)

    return make


def is_expert_param(name: str) -> bool:
    """An expert stack of a MoE layer (``blocks.<i>.moe.w1`` / ``w2``)."""
    parts = name.split(".")
    return len(parts) >= 2 and parts[-2] == "moe" and parts[-1] in ("w1",
                                                                    "w2")


def build_model(args, device, shard: ExpertShard = ExpertShard(),
                tp: Optional[collectives.TPShards] = None
                ) -> models.TransformerLM:
    """``MoELM`` (``moe.py:397``): ``models.TransformerLM`` at the flags'
    widths and compute dtype with :class:`MoEMLP` in every odd block,
    f32 master params, the block of ``compute.lm_block`` (rematerialized
    under ``--remat``), from a seeded init on ``device``. ``tp`` (default:
    ``--tensor-parallel`` shards in this process) splits the dense blocks,
    the ``lm_head`` and the experts' FFNs, and ``--split-qkv`` resolves as
    the reference's does (split under TP)."""
    tp = tp or collectives.TPShards(args.tensor_parallel, 1)
    factory = mlp_factory(args, shard, tp)
    split = models.resolve_split_qkv(args.split_qkv, tp.shards, log)
    # Every other block is MoE (GShard): dense blocks keep a gradient
    # path for every token when hot experts overflow.
    model = models.TransformerLM(
        args.vocab, args.dim, args.heads, args.layers, args.seq_len,
        kv_heads=args.kv_heads, split_qkv=split or None,
        param_dtype=torch.float32, device=device,
        block=compute.lm_block(args), compute_dtype=compute_dtype(args),
        mlp_for_layer=lambda i: factory if i % 2 == 1 else None, tp=tp)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(args.seed))
    return model.init_weights(gen)


def attend_for(dtype: torch.dtype) -> Callable[[int], models.Attend]:
    """The per-layer attention of ``moe.py:376``: the differentiable flash
    attention in bf16 (K1 and K2 on the card), the plain attention in f32
    (``fa.reference_attention``, on either device)."""
    if dtype == torch.bfloat16:
        return lambda _i: (lambda q, k, v: fa.flash_attention(
            q, k, v, causal=True))
    return lambda _i: (lambda q, k, v: fa.reference_attention(
        q, k, v, causal=True))


# --- the mesh ------------------------------------------------------------------


class MoEMesh(NamedTuple):
    """The (data, expert, model) layout of the job's processes: ``world``
    processes, ``procs`` (P_e) neighbouring model groups per expert group
    (the ``--expert-parallel`` degree ``ep`` spread over them: ep / P_e
    shards a process), ``model_procs`` (P_m) neighbouring processes per
    model group holding the ``tp`` (N = ``--tensor-parallel``) shards, N /
    P_m each, ``data`` = world / (P_e·P_m). Ranks are data-major, model
    innermost: rank = (data_rank·P_e + expert_rank)·P_m + model_rank.
    Every model group holds a batch shard of its own (``batch_rank`` of
    ``batch_ranks`` = world / P_m). ``expert_group`` is this process's
    expert group (the same data and model rank), ``replica_group`` the
    processes holding the same experts and model part, ``model_group`` its
    model group and ``dense_group`` the processes of its model rank (each
    None when it would hold one process, or when it is the world)."""

    world: int
    rank: int
    ep: int
    procs: int
    expert_group: Any = None
    replica_group: Any = None
    tp_shards: int = 1
    model_procs: int = 1
    model_group: Any = None
    dense_group: Any = None

    @property
    def data(self) -> int:
        return self.world // (self.procs * self.model_procs)

    @property
    def data_rank(self) -> int:
        return self.rank // (self.procs * self.model_procs)

    @property
    def expert_rank(self) -> int:
        return (self.rank // self.model_procs) % self.procs

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_procs

    @property
    def batch_rank(self) -> int:
        return self.rank // self.model_procs

    @property
    def batch_ranks(self) -> int:
        return self.world // self.model_procs

    def shard(self) -> ExpertShard:
        return ExpertShard(self.procs, self.expert_rank, self.expert_group)

    def tp(self) -> collectives.TPShards:
        return collectives.TPShards(self.tp_shards, self.model_procs,
                                    self.model_rank, self.model_group)


def make_moe_mesh(world: Optional[int] = None, rank: Optional[int] = None,
                  expert_parallel: int = 1,
                  tensor_parallel: int = 1, num_slices: int = 1) -> MoEMesh:
    """The (data, expert, model) mesh over the job's processes (default:
    the process group, or one process without one): P_m = min(world, tp)
    processes per model group, P_e = min(world / P_m, ep) model groups per
    expert group, data = world / (P_e·P_m); each degree must split over
    its P, and the world over P_e·P_m (the reference's ``make_mesh3``
    layout, model innermost); with ``num_slices`` > 1 each expert x model
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
    procs = min(world // mprocs, expert_parallel)
    if expert_parallel < 1 or expert_parallel % procs \
            or world % (procs * mprocs):
        raise ValueError(f"--expert-parallel {expert_parallel} does not lay "
                         f"out over {world // mprocs} model groups")
    collectives.check_slices(world, procs * mprocs, "expert x model",
                             num_slices)
    mesh = MoEMesh(world, rank, expert_parallel, procs,
                   tp_shards=tensor_parallel, model_procs=mprocs)
    if not grouped or world == 1:
        return mesh

    inner = procs * mprocs
    groups = {}
    if procs > 1:
        groups["expert_group"] = collectives.own_group(rank, (
            list(range(first + m, first + inner, mprocs))
            for first in range(0, world, inner) for m in range(mprocs)))
    if inner > 1 and world > inner:
        groups["replica_group"] = collectives.own_group(
            rank, (list(range(r, world, inner)) for r in range(inner)))
    if mprocs > 1:
        groups["model_group"] = collectives.own_group(rank, (
            list(range(first, first + mprocs))
            for first in range(0, world, mprocs)))
        if world > mprocs:
            groups["dense_group"] = collectives.own_group(
                rank, (list(range(m, world, mprocs)) for m in range(mprocs)))
    return mesh._replace(**groups)


# --- the step -------------------------------------------------------------------


def _mean(values: List[torch.Tensor], device) -> torch.Tensor:
    """The reference's ``_mean_sown``: the mean over the MoE layers, 0
    without one."""
    if not values:
        return torch.zeros((), dtype=torch.float32, device=device)
    return sum(values) / len(values)


def make_moe_loss(model: models.TransformerLM, args):
    """``loss_fn(tokens) -> (total, metrics)`` of one microbatch: the
    next-token loss plus ``aux_coef`` times the layers' mean aux loss and
    ``router_z_coef`` times their mean z-loss (``moe.py:481``); the
    metrics ``loss`` (the LM part), ``aux_loss``, ``router_z``,
    ``drop_frac`` and ``total_loss``."""
    attend = attend_for(compute_dtype(args))
    aux_coef = float(args.aux_coef)
    z_coef = float(getattr(args, "router_z_coef", 0.0))

    def loss_fn(tokens):
        with sown() as rows:
            logits = model(tokens, None, attend)
        aux = _mean([a for a, _z, _d in rows], tokens.device)
        router_z = _mean([z for _a, z, _d in rows], tokens.device)
        drop = _mean([d for _a, _z, d in rows], tokens.device).detach()
        lm = train.next_token_nll(logits, tokens)
        total = lm + aux_coef * aux + z_coef * router_z
        return total, {"loss": lm.detach(), "aux_loss": aux.detach(),
                       "router_z": router_z.detach(), "drop_frac": drop,
                       "total_loss": total.detach()}

    return loss_fn


def make_moe_train_step(model: models.TransformerLM, optimizer, opt_state,
                        args, mesh: Optional[MoEMesh] = None):
    """The reference's ``make_moe_train_step`` (``moe.py:467``) through
    ``train.make_loss_train_step`` with ``--grad-accum``. With more than
    one batch shard the gradients and metrics are averaged over the batch
    shards after the last microbatch: summed over the processes of this
    one's model rank (every model rank computes the same loss, so each
    counts once), the expert stacks' only over the processes that hold the
    same experts and model part (``train.all_reduce_grads``)."""
    mesh = mesh or make_moe_mesh(1, 0, 1)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    params = [p for _n, p in named]
    reduce = None
    if mesh.batch_ranks > 1:
        split = mesh.procs > 1 or mesh.model_procs > 1
        sharded = [i for i, (n, _p) in enumerate(named)
                   if split and is_expert_param(n)]

        def reduce(ps, metrics):
            return train.all_reduce_grads(ps, metrics, mesh.batch_ranks,
                                          sharded, mesh.replica_group,
                                          group=mesh.dense_group)

    return train.make_loss_train_step(make_moe_loss(model, args), params,
                                      optimizer, opt_state,
                                      grad_accum=args.grad_accum,
                                      reduce=reduce)


def state_shards(model: models.TransformerLM, opt_state,
                 mesh: MoEMesh) -> Optional[checkpoint.Shards]:
    """The reference's ``state_shardings`` (``moe.py:429``) as what each
    process holds: E / P_e experts of every ``w1`` / ``w2`` stack and
    their optimizer moments (adam's, adam8's and sgd's state is per
    parameter) over the expert group, and under TP over processes the
    model part of every split weight and of its moments over the model
    group (``transformer.tp_shards``; the expert stacks split on both);
    everything else whole. None when a process holds every part."""
    tp_level = transformer.tp_shards(model, opt_state)
    if mesh.procs == 1:
        return tp_level
    names = [n for n, _p in model.named_parameters()]
    experts = {i for i, n in enumerate(names) if is_expert_param(n)}
    opt_names = frozenset(
        n for n, t in opt_state.state_dict().items()
        if t.dim() and n.rsplit(".", 1)[-1].isdigit()
        and int(n.rsplit(".", 1)[-1]) in experts)
    return checkpoint.Shards(
        {checkpoint.PARAMS_FILE: frozenset(names[i] for i in experts),
         checkpoint.OPT_FILE: opt_names},
        mesh.expert_group, mesh.procs, mesh.expert_rank, inner=tp_level)



class Built(NamedTuple):
    model: models.TransformerLM
    optimizer: Any
    opt_state: Any
    step: Callable[[torch.Tensor], train.Metrics]
    batches: Iterator[Tuple]
    device: torch.device
    mesh: MoEMesh
    experts: int

    @property
    def state(self) -> checkpoint.TrainState:
        """The params and optimizer state the step updates in place, with
        the expert stacks' split and the model's name and expert count
        (a restore at another ``--experts`` is refused)."""
        return checkpoint.TrainState(
            dict(self.model.named_parameters()), self.opt_state,
            shards=state_shards(self.model, self.opt_state, self.mesh),
            model={"name": "moe", "experts": self.experts})


def build(args, device=None, mesh: Optional[MoEMesh] = None,
          num_slices: int = 1) -> Built:
    """Model (seeded init, gradients on), optimizer and its state, step
    and host batches for the flags. ``device`` defaults to ``--device``
    (CUDA unless it says ``cpu``); ``mesh`` to the (data, expert, model)
    mesh of the job's process group at ``--expert-parallel`` and
    ``--tensor-parallel`` over ``num_slices`` slices."""
    check_flags(args)
    mesh = mesh or make_moe_mesh(expert_parallel=args.expert_parallel,
                                 tensor_parallel=args.tensor_parallel,
                                 num_slices=num_slices)
    if (mesh.ep, mesh.tp_shards) != (args.expert_parallel,
                                     args.tensor_parallel):
        raise ValueError(f"mesh has expert and tensor parallelism "
                         f"{mesh.ep} x {mesh.tp_shards}, the flags "
                         f"{args.expert_parallel} x {args.tensor_parallel}")
    if args.batch % mesh.batch_ranks:
        raise ValueError(f"--batch {args.batch} must split over "
                         f"{mesh.batch_ranks} batch shards")
    rows = args.batch // mesh.batch_ranks
    if args.grad_accum < 1 or rows % args.grad_accum:
        raise ValueError(f"{rows} rows per batch shard must divide by "
                         f"--grad-accum {args.grad_accum} >= 1")
    dev = resolve_device(device if device is not None
                         else (args.device or None))
    optimizer = optimizers.from_args(args)
    model = build_model(args, dev, mesh.shard(),
                        mesh.tp()).requires_grad_(True)
    opt_state = optimizer.init(list(model.parameters()))
    step = make_moe_train_step(model, optimizer, opt_state, args, mesh)
    return Built(model, optimizer, opt_state, step,
                 data_mod.lm_batches(args, mesh), dev, mesh, args.experts)


def run(info: bootstrap.ProcessInfo, args=None) -> dict:
    args = args or parse_args([])
    built = build(args, num_slices=info.num_slices)
    mesh = built.mesh
    log.info("mesh: {'data': %d, 'expert': %d, 'model': %d} over %d "
             "processes (%d experts and %d tensor-parallel shards a "
             "process); %d experts, capacity factor %.2f, dispatch %s, %s "
             "on %s", mesh.data, mesh.procs, mesh.model_procs, mesh.world,
             args.experts // mesh.procs, mesh.tp_shards // mesh.model_procs,
             args.experts, args.capacity_factor, args.dispatch, args.dtype,
             built.device)
    ckpt = checkpoint.from_env_or_args(args.checkpoint_dir,
                                       save_every=args.checkpoint_every)
    if ckpt is not None and ckpt.latest_step() is not None:
        log.info("attempt %d: resuming from %s (latest step: %d)",
                 info.attempt, ckpt.directory, ckpt.latest_step())
    try:
        metrics = train.train_loop(
            built.step, built.batches, args.steps, device=built.device,
            log_every=args.log_every,
            log_fn=lambda i, m: log.info(
                "step %d loss %.4f aux %.4f drop %.3f", i, m["loss"],
                m["aux_loss"], m["drop_frac"]),
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
