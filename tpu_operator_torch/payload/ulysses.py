"""Ulysses sequence parallelism: all-to-all head-scatter attention
(counterpart of ``tpu_operator/payload/ulysses.py``).

The second sequence-parallel strategy beside the ring
(``ring_attention.py``), the DeepSpeed-Ulysses recipe:

- activations arrive sequence-sharded, ``[B, T/N, H, D]`` a shard;
- one all-to-all re-shards them by head: shard j gets the *whole*
  sequence for heads ``j·H/N .. (j+1)·H/N - 1`` (and K/V heads
  ``j·KVH/N ..``, so GQA groups stay whole). Attention then runs with no
  further communication: the flash kernels (K1, and K2 in the backward)
  over the full T on H/N heads;
- a second all-to-all brings the output back to the sequence layout.

The ``N`` shards spread over the ``P`` processes of a seq group as the
ring's do (:class:`ring_attention.SeqRing`, contiguous layout only):
each process holds the slab of its ``N / P`` consecutive shards. The
exchange (``collectives.AllToAll`` over the seq group) sends process j
the slab's heads of j's shards; the process then runs the flash kernels
once over the heads of all the shards it holds. The kernels treat each
head on its own, so one process holding all N (the exchange the
identity) computes what P processes do.

The reference refuses heads or K/V heads that do not divide by N; so does
this module, with its messages.
"""

from __future__ import annotations

from typing import Any

import torch

from tpu_operator_torch.payload import collectives
from tpu_operator_torch.payload import flash_attention as fa
from tpu_operator_torch.payload.ring_attention import SeqRing


def check_heads(heads: int, kv_heads: int, shards: int,
                seq_axis: str = "seq") -> None:
    """The reference's refusals (``ulysses.py:69-79``)."""
    if heads % shards != 0:
        raise ValueError(
            f"ulysses needs heads ({heads}) divisible by the {seq_axis!r} "
            f"axis size ({shards}); use --sp-mode ring otherwise")
    if kv_heads % shards != 0:
        raise ValueError(
            f"ulysses needs kv_heads ({kv_heads}) divisible by the "
            f"{seq_axis!r} axis size ({shards}); use --sp-mode ring or a "
            f"larger --kv-heads")


def _scatter_heads(x: torch.Tensor, procs: int, group: Any) -> torch.Tensor:
    """``[B, L·C, Hx, D]`` (this process's L shards of C positions) ->
    ``[B, P·L·C, Hx/P, D]``: the whole sequence, in process order, for the
    heads of this process's shards."""
    b, t, h, d = x.shape
    if procs == 1:
        return x
    parts = x.reshape(b, t, procs, h // procs, d).permute(2, 0, 1, 3, 4)
    got = collectives.AllToAll.apply(parts, group)  # [P, B, L·C, Hx/P, D]
    return got.permute(1, 0, 2, 3, 4).reshape(b, procs * t, h // procs, d)


def _gather_heads(y: torch.Tensor, procs: int, group: Any) -> torch.Tensor:
    """The inverse of :func:`_scatter_heads`: ``[B, P·L·C, Hx/P, D]`` ->
    ``[B, L·C, Hx, D]``."""
    b, t, h, d = y.shape
    if procs == 1:
        return y
    parts = y.reshape(b, procs, t // procs, h, d).transpose(0, 1)
    got = collectives.AllToAll.apply(parts, group)  # [P, B, L·C, Hx/P, D]
    return got.permute(1, 2, 0, 3, 4).reshape(b, t // procs, procs * h, d)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      ring: SeqRing, group: Any = None, *,
                      causal: bool = True) -> torch.Tensor:
    """Exact attention over the seq group's sequence, on this process's
    slab: q ``[B, (N/P)·C, H, D]``, k/v ``[B, (N/P)·C, KVH, D]`` in the
    contiguous layout, ``group`` the seq group's processes (None with
    one); returns the output slab ``[B, (N/P)·C, H, D]`` in q's dtype.
    Differentiable (the exchange is its own transpose)."""
    check_heads(q.shape[2], k.shape[2], ring.shards)
    qs, ks, vs = (_scatter_heads(x, ring.procs, group).contiguous()
                  for x in (q, k, v))
    out = fa.flash_attention(qs, ks, vs, causal=causal)
    return _gather_heads(out, ring.procs, group).contiguous()
