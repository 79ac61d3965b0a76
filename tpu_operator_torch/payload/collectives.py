"""Autograd collectives shared by the parallel payloads.

- :class:`AllToAll`: equal chunks of dim 0 to every process of a group,
  chunk j to process j; its own transpose, so the backward is the same
  exchange. The MoE payload's expert dispatch and the Ulysses head scatter
  (``ulysses.py``) both run on it.
- :class:`TPShards` and its three functions, the Megatron pairing of the
  reference's ``lm_tp_shardings`` (``tpu_operator/payload/
  transformer.py:256``): ``enter`` (identity forward, gradients summed
  over the tensor-parallel group: before a column-parallel layer),
  ``reduce`` (the row-parallel partial products summed: their forward
  all-reduce, identity backward), both summing in shard order, and
  ``gather`` (the column-parallel ``lm_head``'s vocab shards joined; the
  backward keeps this process's).
  ``N`` shards spread over the ``P`` processes of a group, ``N / P`` a
  process; the shards a process holds run as units one after another, so
  one process holding all ``N`` runs the same code as ``P`` processes, with
  local sums in place of the collectives.
- :class:`FSDPShard` and :func:`fsdp_gather`, the transformer's ``--fsdp``
  (the reference's ``train.fsdp_shardings``): a param split over the
  data group is gathered whole where it is used, and the backward
  reduce-scatters the whole gradient into the f32 shard's; with
  :func:`regather_saved` around the forward, autograd keeps the shard in
  place of a gathered weight it saves and gathers again when the
  backward unpacks it.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class AllToAll(torch.autograd.Function):
    """Equal chunks of dim 0 to every process of ``group``, chunk j to
    process j; its own transpose, so the backward is the same exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return exchange(x, group)

    @staticmethod
    def backward(ctx, grad):
        return exchange(grad, ctx.group), None


def exchange(x: torch.Tensor, group) -> torch.Tensor:
    # Contiguous first: empty_like keeps a permuted input's strides, and
    # the collective writes the output's storage in row-major order.
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def own_group(rank: int, members) -> Any:
    """Create the process group of each rank list in ``members`` (every
    process must create them all, in the same order: ``dist.new_group``
    is collective) and return the one holding ``rank`` (None if none)."""
    found = None
    for ranks in members:
        group = dist.new_group(ranks)
        if rank in ranks:
            found = group
    return found


def check_slices(world: int, inner: int, label: str,
                 num_slices: int = 1) -> None:
    """The reference's multi-slice rule (``train._mesh_device_layout``)
    over the job's processes. ``num_slices`` > 1 (``MEGASCALE_NUM_SLICES``)
    needs a world that divides into that many slices of adjacent ranks
    (the operator orders ``JAX_PROCESS_ID`` slice-major), and an inner
    group (``inner`` adjacent ranks: the processes of one model, seq,
    pipe or expert group) that fits whole inside one slice, so that its
    per-op collectives never cross a slice (on GPUs, a node) boundary and
    only the data axis spans slices. Raises ValueError otherwise; one
    slice accepts every layout."""
    if num_slices < 1:
        raise ValueError(f"num_slices must be >= 1, got {num_slices}")
    if num_slices == 1:
        return
    if world % num_slices:
        raise ValueError(f"{world} processes not divisible by "
                         f"num_slices={num_slices}")
    per_slice = world // num_slices
    if per_slice % inner:
        raise ValueError(f"{label}={inner} processes do not fit within one "
                         f"slice ({per_slice} processes): inner-axis "
                         f"collectives must stay inside a slice")


def part_of(t: torch.Tensor, dim: int, sections: int, size: int,
            rank: int) -> torch.Tensor:
    """Part ``rank`` of ``size`` of a whole tensor split along ``dim``:
    that share of each of ``sections`` equal sections, joined (3 for the
    fused ``qkv``, whose q, k and v thirds each split by head)."""
    parts = [x.chunk(size, dim=dim)[rank] for x in t.chunk(sections, dim=dim)]
    return parts[0] if sections == 1 else torch.cat(parts, dim=dim)


class TPShards(NamedTuple):
    """This process's part of the tensor-parallel (``model``) axis:
    ``shards`` (N) shards over ``procs`` (P) processes, this one the
    ``index``-th of them holding shards ``index·N/P .. (index+1)·N/P - 1``;
    ``group`` their process group (None with one process)."""

    shards: int = 1
    procs: int = 1
    index: int = 0
    group: Any = None

    @property
    def local(self) -> int:
        return self.shards // self.procs

    def enter(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """``x`` once for each shard this process holds (views); the
        gradient is the shards' gradients summed in shard order, then over
        the group's processes. The fixed order makes one process holding
        two shards compute what two processes holding one each do."""
        return _Enter.apply(x, self.local, self.group if self.procs > 1
                            else None)

    def reduce(self, partials: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum of every shard's partial product, in f32, back in the
        partials' dtype: this process's, in shard order, then over the
        group. Each partial's gradient is the sum's."""
        total = partials[0].float()
        for p in partials[1:]:
            total = total + p.float()
        if self.procs > 1:
            total = _Reduce.apply(total, self.group)
        return total.to(partials[0].dtype)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every process's ``x`` joined along ``dim`` in process order; the
        gradient keeps this process's part (every process computes the same
        function of the whole)."""
        if self.procs == 1:
            return x
        return _Gather.apply(x, dim, self.procs, self.index, self.group)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, units, group):
        ctx.group = group
        return tuple(x.view_as(x) for _ in range(units))

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for g in grads:
            if g is not None:
                total = g if total is None else total + g
        if ctx.group is not None and total is not None:
            total = total.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(total, group=ctx.group)
        return total, None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, procs, index, group):
        ctx.dim, ctx.index, ctx.size = dim, index, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(procs)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        part = grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size)
        return part.contiguous(), None, None, None, None


# --- FSDP ---------------------------------------------------------------------


class FSDPShard(NamedTuple):
    """Where a param's FSDP shard lies (the shard's attribute ``fsdp``):
    the whole split along ``dim`` into ``size`` equal parts over the
    processes of ``group`` (the data group; None with one process in it),
    this process holding part ``rank``. With a group of one both
    collectives are the identity and everything around them runs the
    same."""

    dim: int
    size: int = 1
    rank: int = 0
    group: Any = None

    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        """The whole: every process's part joined along ``dim`` in rank
        order (the list forms of the collectives, in every torch this
        payload runs on)."""
        if self.size == 1:
            return shard
        shard = shard.contiguous()
        parts = [torch.empty_like(shard) for _ in range(self.size)]
        dist.all_gather(parts, shard, group=self.group)
        return torch.cat(parts, dim=self.dim)

    def scatter(self, whole: torch.Tensor) -> torch.Tensor:
        """This process's part of the sum over the group of every
        process's ``whole``."""
        if self.size == 1:
            return whole
        chunks = [c.contiguous()
                  for c in whole.chunk(self.size, dim=self.dim)]
        out = torch.empty_like(chunks[self.rank])
        dist.reduce_scatter(out, chunks, group=self.group)
        return out


def fsdp_gather(shard: torch.Tensor, spec: FSDPShard,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The whole of ``shard`` (split as ``spec`` says) in ``dtype``
    (default its own): gathered, then cast, which is exact. The backward
    casts the whole gradient to the shard's dtype (f32) and
    reduce-scatters it over the group: the gradient of this process's
    part, summed over the data ranks (the train step divides by them
    once, after the last microbatch, as it does every gradient)."""
    return _FSDPGather.apply(shard, spec, dtype or shard.dtype)


class _FSDPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, spec, dtype):
        ctx.spec, ctx.dtype = spec, shard.dtype
        whole = spec.gather(shard).to(dtype)
        if whole is not shard:
            # For regather_saved: what to gather again in place of this.
            whole._fsdp_source = (shard, spec, dtype)
        return whole

    @staticmethod
    def backward(ctx, grad):
        return ctx.spec.scatter(grad.to(ctx.dtype)), None, None


def _pack(t: torch.Tensor):
    base = t if t._base is None else t._base
    source = getattr(base, "_fsdp_source", None)
    if source is None:
        return t
    return source, t.size(), t.stride(), t.storage_offset()


def _unpack(packed):
    if isinstance(packed, torch.Tensor):
        return packed
    (shard, spec, dtype), size, stride, offset = packed
    with torch.no_grad():
        whole = spec.gather(shard).to(dtype)
    return whole.as_strided(size, stride, offset)


def regather_saved():
    """A ``saved_tensors_hooks`` context: a gathered whole (or a view of
    it) that autograd saves for the backward is kept as its shard, and
    gathered again when the backward unpacks it, so no gathered weight
    outlives the op that used it. Inside a rematerialized block the
    checkpoint's own hooks take precedence: there the policy recomputes
    the gather (``models.gathered``)."""
    return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)
