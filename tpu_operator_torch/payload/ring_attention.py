"""Ring attention: exact sequence-parallel attention (counterpart of
``tpu_operator/payload/ring_attention.py``).

The sequence of ``N`` shards (``--seq-parallel N``) is spread over the
``P`` processes of a seq group, ``N / P`` consecutive shards per process;
each process holds the slab ``[B, (N/P)·C, H, D]`` of its shards
(``C = T / N``). Queries stay resident; K/V blocks rotate around the ring
of shards, and every visit is folded into an f32 streaming-softmax carry by
:func:`flash_attention.merge_kv_block` (the merge kernel on the card). The
reference maps one shard to a device and rotates with ``lax.ppermute``;
here :class:`SeqRing` rotates by one ring position: inside a process it
re-indexes the held blocks, and across processes the last held block goes
to the next process while one comes in from the previous one
(``dist.batch_isend_irecv``). The same code runs for every P, so every
shard merges its blocks in the same order whatever P is: with P = 1 the
whole ring runs in one process, and a run with P > 1 is bit-equal to it.

The backward is a second ring (:class:`RingAttention`), as in the
reference's custom VJP: the forward saves (q, k, v, out, L), the backward
computes D = rowsum(dO·O) once and runs
:func:`flash_attention.attention_block_grads` (the backward kernels, given
D, f32 grads) for every block pair; dK/dV accumulators travel with their
blocks and a final hop brings them home.

Layouts: contiguous, shard r holds positions [rC, (r+1)C) (slot c is
position rC + c); striped (:func:`stripe_permutation`), shard r holds
positions r, r+N, r+2N, ... (slot c is position r + Nc), which balances
the causal work across shards. The caller lays the sequence out.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from tpu_operator_torch.payload import flash_attention as fa


def stripe_permutation(t: int, shards: int) -> Tuple[np.ndarray, np.ndarray]:
    """(perm, inv) for the striped layout: ``x[:, perm]`` lays tokens out
    so shard r's contiguous slice holds global positions r, r+N, r+2N, ..."""
    if t % shards:
        raise ValueError(f"seq {t} not divisible by {shards} shards")
    perm = np.arange(t).reshape(t // shards, shards).T.reshape(-1)
    return perm, np.argsort(perm)


def ring_offsets(shard: int, kv_shard: int, shards: int, chunk: int,
                 stripe: bool) -> Tuple[int, int, int]:
    """(q_off, k_off, stride) of shard ``shard``'s queries against the block
    born on shard ``kv_shard``: slot c of shard r is position r·C + c
    (contiguous) or r + N·c (striped)."""
    if stripe:
        return shard, kv_shard, shards
    return shard * chunk, kv_shard * chunk, 1


Block = Tuple[torch.Tensor, ...]


class SeqRing:
    """The seq axis of one process: ``shards`` (N) shards over the
    ``len(ranks)`` (P) processes of its seq group, ``ranks`` being their
    global ranks in ring order and ``index`` this process's place among
    them. The process holds shards ``index·N/P .. (index+1)·N/P - 1``."""

    def __init__(self, shards: int, ranks: Sequence[int] = (0,),
                 index: int = 0):
        procs = len(ranks)
        if shards < 1 or procs < 1 or shards % procs:
            raise ValueError(f"{shards} shards do not spread over {procs} "
                             f"processes")
        if not 0 <= index < procs:
            raise ValueError(f"ring index {index} outside {procs} processes")
        self.shards, self.procs, self.index = shards, procs, index
        self.ranks = tuple(int(r) for r in ranks)
        self.local = shards // procs

    def shard_ids(self) -> range:
        """The global shard indices this process holds, in slab order."""
        return range(self.index * self.local, (self.index + 1) * self.local)

    def rotate(self, blocks: List[Block]) -> List[Block]:
        """Move every shard's block one ring position on: shard i then
        holds what shard i - 1 held. ``blocks`` holds one tuple of tensors
        per held shard, in slab order."""
        if len(blocks) != self.local:
            raise ValueError(f"{len(blocks)} blocks for {self.local} shards")
        last = blocks[-1]
        if self.procs == 1:
            incoming = last
        else:
            import torch.distributed as dist

            nxt = self.ranks[(self.index + 1) % self.procs]
            prev = self.ranks[(self.index - 1) % self.procs]
            incoming = tuple(torch.empty(t.shape, dtype=t.dtype,
                                         device=t.device) for t in last)
            ops = [dist.P2POp(dist.isend, t.contiguous(), nxt) for t in last]
            ops += [dist.P2POp(dist.irecv, t, prev) for t in incoming]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return [incoming] + list(blocks[:-1])


def _shards(x: torch.Tensor, n: int) -> List[torch.Tensor]:
    """[B, n·C, ...] -> n contiguous [B, C, ...] blocks."""
    return [c.contiguous() for c in x.chunk(n, dim=1)]


def _ring_forward(qs, ks, vs, ring: SeqRing, causal: bool, stripe: bool
                  ) -> List[fa.Carry]:
    """The forward ring: each held shard's carry after its home block and
    the N - 1 blocks that visit it."""
    n, chunk = ring.shards, qs[0].shape[1]
    ids = ring.shard_ids()
    b, _c, h, d = qs[0].shape
    carries = [fa.merge_kv_block(
        q, k, v, fa.init_carry(b, h, chunk, d, device=q.device),
        ring_offsets(idx, idx, n, chunk, stripe), causal=causal)
        for q, k, v, idx in zip(qs, ks, vs, ids)]
    cur = list(zip(ks, vs))
    for i in range(1, n):
        cur = ring.rotate(cur)
        # After i rotations shard idx holds the block born on (idx - i) % n.
        carries = [fa.merge_kv_block(
            q, k, v, carry, ring_offsets(idx, (idx - i) % n, n, chunk,
                                         stripe), causal=causal)
            for q, (k, v), carry, idx in zip(qs, cur, carries, ids)]
    return carries


class RingAttention(torch.autograd.Function):
    """Ring attention over a process's slab, differentiated by a backward
    ring (the reference's ``_ring_local_attn`` custom VJP)."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                ring: SeqRing, causal: bool, stripe: bool) -> torch.Tensor:
        qs, ks, vs = (_shards(x, ring.local) for x in (q, k, v))
        carries = _ring_forward(qs, ks, vs, ring, causal, stripe)
        outs = [fa.finalize(c, q.dtype).permute(0, 2, 1, 3) for c in carries]
        lse = torch.stack([fa._logsumexp_rows(l, m) for _o, l, m in carries])
        out = torch.cat(outs, dim=1).contiguous()
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring, ctx.causal, ctx.stripe = ring, causal, stripe
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        q, k, v, out, lse = ctx.saved_tensors
        ring, causal, stripe = ctx.ring, ctx.causal, ctx.stripe
        n, local = ring.shards, ring.local
        qs, ks, vs, gs, outs = (_shards(x, local) for x in (q, k, v, g, out))
        chunk = qs[0].shape[1]
        ids = ring.shard_ids()
        # D once per backward, reused by every block pair.
        ds = [fa.row_dot(gg, o) for gg, o in zip(gs, outs)]

        def grads(j: int, k_blk, v_blk, kv_idx: int):
            return fa.attention_block_grads(
                qs[j], k_blk, v_blk, gs[j], lse[j], outs[j],
                ring_offsets(ids[j], kv_idx, n, chunk, stripe),
                causal=causal, grad_dtype=torch.float32, D=ds[j])

        dqs, cur = [], []
        for j, idx in enumerate(ids):
            dq, dk, dv = grads(j, ks[j], vs[j], idx)
            dqs.append(dq)
            cur.append((ks[j], vs[j], dk, dv))
        for i in range(1, n):
            cur = ring.rotate(cur)
            for j, idx in enumerate(ids):
                k_blk, v_blk, dk, dv = cur[j]
                dq_b, dk_b, dv_b = grads(j, k_blk, v_blk, (idx - i) % n)
                dqs[j] = dqs[j] + dq_b
                cur[j] = (k_blk, v_blk, dk + dk_b, dv + dv_b)
        # N - 1 rotations leave every block one hop short of home.
        home = ring.rotate([(dk, dv) for _k, _v, dk, dv in cur])
        dq = torch.cat(dqs, dim=1).to(q.dtype)
        dk = torch.cat([x for x, _ in home], dim=1).to(k.dtype)
        dv = torch.cat([y for _, y in home], dim=1).to(v.dtype)
        return dq, dk, dv, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   ring: SeqRing, *, causal: bool = True,
                   stripe: bool = False) -> torch.Tensor:
    """Exact attention over the ring's sequence, on this process's slab:
    q [B, (N/P)·C, H, D], k/v [B, (N/P)·C, KVH, D] in the layout ``stripe``
    names; returns the output slab [B, (N/P)·C, H, D] in q's dtype.
    Differentiable."""
    return RingAttention.apply(q, k, v, ring, causal, stripe)
