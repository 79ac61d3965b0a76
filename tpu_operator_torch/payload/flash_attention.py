"""Flash attention: CUDA kernels plus their plain PyTorch versions
(counterpart of ``tpu_operator/payload/flash_attention.py``).

Five kernels in four sources, all in ``tpu_operator_torch/kernels/csrc/``:

- :func:`flash_attention` (prefill) launches ``flash_fwd.cu``, the port of
  the TPU kernel ``_fwd_kernel``: exact attention over ``[B, T, H, D]``,
  causal or not, GQA-native (query head ``h`` reads K/V head
  ``h // group``), f32 online softmax, bf16 output plus the f32 per-row
  logsumexp ``L [B, H, T, 1]``.
- :func:`flash_decode` (every decode step) launches ``flash_decode.cu``,
  the port of ``_decode_kernel``: ``[B, Tq, H, D]`` new-token queries
  against a ``[B, S, KVH, D]`` cache with per-row int32 ``lengths``; keys
  at positions ``>= lengths[b]`` are never read. The kernel splits the
  key range into chunks of :data:`DECODE_CHUNK` keys; the wrapper gives
  it a workspace for the chunks' partial states (per launch) and arrival
  counters (once per device and stream). A launch takes at most
  :data:`DECODE_ROWS` query rows (group x Tq); the wrapper launches it
  once per panel of ``DECODE_ROWS // group`` query slots, so any Tq works.
- :func:`attention_block_grads` (the backward of every training block)
  launches the two kernels of ``flash_bwd.cu``, the port of
  ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``: dQ, dK, dV from the forward's
  O and L, with D = rowsum(dO * O) fused or given, causal offsets with a
  stride, and grads in bf16 or f32.
- :func:`merge_kv_block` (every step of the forward ring,
  ``ring_attention.py``) launches ``flash_merge.cu``, the port of
  ``_merge_kernel``: one visiting K/V block folded into the f32 (o, l, m)
  carry of the resident queries, causal offsets with a stride, no
  finalize. It writes a new carry and leaves the one it was given intact.

K1 and K2 are reached through two torch custom ops,
``tpu_operator_torch::flash_fwd`` and ``tpu_operator_torch::flash_bwd``
(:func:`flash_fwd_op`, :func:`flash_bwd_op`): the forward op's autograd
pairs them (the custom VJP of the reference's ``_attn``), so
:func:`flash_attention` is differentiable, and a selective-checkpoint
policy can save the forward's two outputs by op (``models.remat_policy``).

Dispatch is by the tensors' device and nothing else: a CUDA tensor goes to
the kernel (bf16, any head dim, contiguous) or the call raises; a CPU
tensor goes to the plain version (:func:`_attn_ref`, :func:`_decode_ref`,
:func:`_bwd_ref`, :func:`_merge_ref`), which is also the yardstick ``chip_smoke.py`` holds
each kernel against. There is no fallback from the kernel to the plain
version.

Head dims. K1 and K2 are built for head dims 64 and 128, K3 and K4 for
128 (:data:`KERNEL_HEAD_DIMS`). Above 128 every kernel takes its wide
path: a grid axis over column blocks of the output, 256 columns wide for
K1, dq and K4 and 128 for dkv and K3 (:data:`WIDE_BLOCKS`; the backward
pair pads to dq's 256). Every wide kernel computes each score tile once
per thread-block cluster of column blocks (:func:`wide_cluster_size`;
``csrc/flash_wide.cuh`` for K1 and K4, ``csrc/flash_bwd.cu`` for dq and
dkv, ``csrc/flash_decode.cu`` for K3). K2's wide kernels take D =
rowsum(dO O) given (:func:`row_dot`), since it spans every block. Any
other head dim runs through :func:`at_kernel_head_dim`: q / k / v (and
dO, O, the merge carry's o) are zero-padded to the next size the kernel
runs at, the kernel runs with the softmax scale of the true head dim, and
the outputs are cut back. Zero columns add nothing to Q K^T or to
rowsum(dO O), and P V and the gradients come back zero in them, so the
result is exact.

Masking uses the finite ``NEG_INF = -1e30`` of the reference: a masked key
adds exactly 0 once its row has seen a valid key, and a row that saw none
yields O = 0 and L = 0.

``LAUNCHES`` counts kernel launches per kernel (the plain versions never
count), so a run can show that its main path went through the kernels;
:func:`launch_counts` also gives them by the caller's :func:`launch_scope`
(a serve pod's card). Threads may launch at once, so every count is taken
under one lock.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, \
    Tuple

import torch

NEG_INF = -1e30

Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # o, l, m

_LAUNCH_LOCK = threading.Lock()
# Kernel launches since the last reset, by kernel; by (scope, kernel) for
# launches inside a launch_scope.
LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_decode": 0,
                            "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                            "flash_merge": 0}  # guarded-by: _LAUNCH_LOCK
_BY_SCOPE: Dict[Tuple[Any, str], int] = {}  # guarded-by: _LAUNCH_LOCK
_SCOPE = threading.local()  # .name: the calling thread's launch scope


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        _BY_SCOPE.clear()


def launch_counts(scope: Any = None) -> Dict[str, int]:
    """Launches by kernel since the last reset: every launch, or those made
    inside ``launch_scope(scope)``."""
    with _LAUNCH_LOCK:
        if scope is None:
            return dict(LAUNCHES)
        return {name: _BY_SCOPE.get((scope, name), 0) for name in LAUNCHES}


@contextlib.contextmanager
def launch_scope(scope: Any) -> Iterator[None]:
    """Count the calling thread's launches under ``scope`` as well, until
    the block ends (a serve pod's card index)."""
    previous = getattr(_SCOPE, "name", None)
    _SCOPE.name = scope
    try:
        yield
    finally:
        _SCOPE.name = previous


def _count(name: str) -> None:
    """One launch of kernel ``name``: the wrappers call it where they
    launch, and nowhere else."""
    scope = getattr(_SCOPE, "name", None)
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1
        if scope is not None:
            _BY_SCOPE[(scope, name)] = _BY_SCOPE.get((scope, name), 0) + 1


def _group_of(hq: int, hkv: int) -> int:
    """Query heads per K/V head. 1 = MHA."""
    if hkv <= 0 or hq % hkv != 0:
        raise ValueError(
            f"query heads {hq} must be a multiple of K/V heads {hkv}")
    return hq // hkv


# --- plain versions (CPU path; the kernels' yardstick on the card) -----------


def init_carry(batch: int, heads: int, tq: int, dim: int,
               device=None) -> Carry:
    """Zero accumulators of a fresh streaming softmax ([B,H,Tq,D] f32 out,
    [B,H,Tq,1] row sum and row max)."""
    return (torch.zeros(batch, heads, tq, dim, dtype=torch.float32,
                        device=device),
            torch.zeros(batch, heads, tq, 1, dtype=torch.float32,
                        device=device),
            torch.full((batch, heads, tq, 1), NEG_INF, dtype=torch.float32,
                       device=device))


def finalize(carry: Carry, dtype: torch.dtype) -> torch.Tensor:
    """carry -> output [B,H,Tq,D]; a row that never saw a valid key
    (m still NEG_INF) yields 0."""
    o, l, m = carry
    valid = m > NEG_INF / 2
    out = torch.where(valid, o / torch.clamp(l, min=1e-30),
                      torch.zeros((), dtype=o.dtype, device=o.device))
    return out.to(dtype)


def _logsumexp_rows(l: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Per-row logsumexp [B,H,T,1] f32; 0 for a row that saw no key."""
    return torch.where(m > NEG_INF / 2,
                       m + torch.log(torch.clamp(l, min=1e-30)),
                       torch.zeros((), dtype=m.dtype, device=m.device))


def _merge_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               o: torch.Tensor, l: torch.Tensor, m: torch.Tensor,
               offsets: Sequence[int], causal: bool,
               scale: Optional[float] = None) -> Carry:
    """Fold one K/V block into the streaming-softmax carry, on [B,H,T,D]
    blocks (K/V may carry grouped heads). ``offsets`` is (q_off, k_off) or
    (q_off, k_off, stride): slot i sits at global position off + stride*i.
    ``scale`` defaults to D ** -0.5."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = _group_of(hq, hkv)
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, hkv, group, tq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if causal:
        stride = int(offsets[2]) if len(offsets) >= 3 else 1
        q_pos = int(offsets[0]) + stride * torch.arange(
            tq, dtype=torch.int32, device=q.device)
        k_pos = int(offsets[1]) + stride * torch.arange(
            tk, dtype=torch.int32, device=q.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                        torch.full((), NEG_INF, device=q.device))
    s = s.reshape(b, hq, tq, tk)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhgqk,bhkd->bhgqd",
                      p.reshape(b, hkv, group, tq, tk),
                      v.float()).reshape(b, hq, tq, d)
    o_new = o * alpha + pv
    return o_new, l_new, m_new


def _attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B,H,T,D] in q.dtype, L [B,H,T,1] f32) on [B,H,T,D] blocks:
    the reference's plain branch of ``_attn_impl``."""
    b, h, t, d = q.shape
    carry = init_carry(b, h, t, d, device=q.device)
    o, l, m = _merge_ref(q, k, v, *carry, (0, 0, 1), causal, scale)
    return finalize((o, l, m), q.dtype), _logsumexp_rows(l, m)


def _normalize_offsets(offsets: Sequence[int]) -> Tuple[int, int, int]:
    """(q_off, k_off, stride) ints; the contiguous two-element form gets
    stride 1."""
    offs = [int(x) for x in offsets]
    if len(offs) == 2:
        offs.append(1)
    if len(offs) != 3 or offs[2] <= 0:
        raise ValueError(f"offsets must be (q_off, k_off[, stride > 0]), "
                         f"got {tuple(offsets)}")
    return offs[0], offs[1], offs[2]


def _bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             g: torch.Tensor, L: torch.Tensor, D: torch.Tensor,
             offsets: Sequence[int], causal: bool,
             scale: Optional[float] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) f32 of one K/V block on [B,H,T,D] blocks (K/V may carry
    grouped heads; dk/dv come back at that size), from the *global* row
    logsumexp ``L`` and ``D = rowsum(dO * O)``, both [B,H,Tq,1] f32. The
    reference's ``_bwd_ref``: f32 throughout, scores materialised.
    ``scale`` defaults to D ** -0.5."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = _group_of(hq, hkv)
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, hkv, group, tq, d).float()
    gg = g.reshape(b, hkv, group, tq, d).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) * scale
    if causal:
        q_off, k_off, stride = _normalize_offsets(offsets)
        q_pos = q_off + stride * torch.arange(tq, dtype=torch.int32,
                                              device=q.device)
        k_pos = k_off + stride * torch.arange(tk, dtype=torch.int32,
                                              device=q.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                        torch.full((), NEG_INF, device=q.device))
    p = torch.exp(s - L.float().reshape(b, hkv, group, tq, 1))
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, gg)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", gg, vf)
    ds = p * (dp - D.float().reshape(b, hkv, group, tq, 1))
    dq = scale * torch.einsum("bhgqk,bhkd->bhgqd", ds, kf)
    dk = scale * torch.einsum("bhgqk,bhgqd->bhkd", ds, qg)
    return dq.reshape(b, hq, tq, d), dk, dv


def _decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lengths: torch.Tensor,
                scale: Optional[float] = None) -> torch.Tensor:
    """Length-masked attention, [B,Tq,H,D] queries against a [B,S,KVH,D]
    cache. Query slot j of row b sits at position lengths[b] - Tq + j;
    keys count iff their position is <= the query's (hence < lengths[b]).
    Single-pass max-subtracted softmax: masked lanes are exactly zero.
    ``scale`` defaults to D ** -0.5."""
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    group = _group_of(hq, hkv)
    scale = d ** -0.5 if scale is None else scale
    qg = q.float().permute(0, 2, 1, 3).reshape(b, hkv, group, tq, d)
    kf = k.float().permute(0, 2, 1, 3)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) * scale
    q_pos = lengths.to(torch.int32)[:, None] - tq \
        + torch.arange(tq, dtype=torch.int32, device=q.device)[None, :]
    k_pos = torch.arange(tk, dtype=torch.int32, device=q.device)
    valid = k_pos[None, None, :] <= q_pos[:, :, None]            # [B,Tq,S]
    s = torch.where(valid[:, None, None], s,
                    torch.full((), NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p,
                     v.float().permute(0, 2, 1, 3))
    alive = m > NEG_INF / 2
    o = torch.where(alive, o / torch.clamp(l, min=1e-30),
                    torch.zeros((), device=q.device))
    return o.reshape(b, hq, tq, d).permute(0, 2, 1, 3).to(q.dtype)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Vanilla full attention, [B,T,H,D] layout (the reference's parity
    oracle): grouped K/V are repeated to the full head count, query head h
    reading K/V head h // group."""
    if k.shape[2] != q.shape[2]:
        group = _group_of(q.shape[2], k.shape[2])
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        t = q.shape[1]
        mask = torch.tril(torch.ones(t, t, dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None, None], s,
                        torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


# --- kernel wrappers ---------------------------------------------------------


# Head dims each kernel is built for (the template instances of its
# source) up to 128. A head dim between two of them runs at the next one
# up; above the largest, every kernel runs its wide path at the next
# multiple of its WIDE_BLOCKS.
KERNEL_HEAD_DIMS: Dict[str, Tuple[int, ...]] = {
    "flash_fwd": (64, 128), "flash_bwd": (64, 128),
    "flash_decode": (128,), "flash_merge": (128,)}
# Head-dim columns of one chunk of the kernels' wide path (D > 128).
WIDE_CHUNK = 128
# Head-dim columns of a column block of each kernel's wide path: a grid
# axis over blocks of this width ("flash_bwd" is dkv's, "flash_bwd_dq"
# dq's). A 256-column CTA (K1, dq, K4) exchanges half the cluster's scores
# per product that a 128-column one does; dkv keeps 128 (at 256 its
# resident K, V and staged Q, dO would not fit in shared memory), and so
# does K3: its exchange is one [group x Tq][64] score tile a key tile,
# small beside the K and V blocks each rank streams.
WIDE_BLOCKS: Dict[str, int] = {"flash_fwd": 2 * WIDE_CHUNK,
                               "flash_bwd": WIDE_CHUNK,
                               "flash_bwd_dq": 2 * WIDE_CHUNK,
                               "flash_decode": WIDE_CHUNK,
                               "flash_merge": 2 * WIDE_CHUNK}
# The cluster kernels of the wide path, each by the wrapper whose head dim
# it runs at: the backward pair pads once, to the coarser of its blocks.
CLUSTER_KERNELS: Dict[str, str] = {"flash_fwd": "flash_fwd",
                                   "flash_bwd_dq": "flash_bwd",
                                   "flash_bwd": "flash_bwd",
                                   "flash_merge": "flash_merge",
                                   "flash_decode": "flash_decode"}


def kernel_head_dim(name: str, d: int) -> int:
    """The head dim ``name``'s kernel runs at for a true head dim ``d``:
    the smallest size it is built for that holds ``d``, or above 128 the
    next multiple of its :data:`WIDE_BLOCKS` (the wide path; for
    "flash_bwd" of the coarser of dq's and dkv's)."""
    if d <= 0:
        raise ValueError(f"{name}: head dim {d} must be positive")
    for size in KERNEL_HEAD_DIMS[name]:
        if d <= size:
            return size
    block = WIDE_BLOCKS[name]
    if name == "flash_bwd":
        block = max(block, WIDE_BLOCKS["flash_bwd_dq"])
    return -(-d // block) * block


def wide_cluster_size(name: str, d: int) -> int:
    """The thread-block cluster of a wide cluster kernel at head dim ``d``
    (> 128): K1 (``name`` "flash_fwd"), dq ("flash_bwd_dq"), dkv
    ("flash_bwd"), K4 ("flash_merge") or K3 ("flash_decode"). It is the
    largest divisor of the kernel's column-block count (the head dim it
    runs at over its :data:`WIDE_BLOCKS`) that is at most 8, the portable
    cluster size (``csrc/hopper.cuh`` ``wide_cluster_size``). A cluster
    computes each score tile once."""
    if name not in CLUSTER_KERNELS or d <= WIDE_CHUNK:
        raise ValueError(f"{name} at head dim {d} runs no cluster: the "
                         f"cluster kernels are K1, dq, dkv, K4 and K3 "
                         f"({', '.join(CLUSTER_KERNELS)}) above head dim "
                         f"{WIDE_CHUNK}")
    nb = kernel_head_dim(CLUSTER_KERNELS[name], d) // WIDE_BLOCKS[name]
    return max(c for c in range(1, min(nb, 8) + 1) if nb % c == 0)


def pad_head_dim(x: torch.Tensor, size: int) -> torch.Tensor:
    """``x`` [..., d] with zero columns appended up to [..., size],
    contiguous (``x`` itself when d == size)."""
    d = x.shape[-1]
    if d == size:
        return x
    return torch.nn.functional.pad(x, (0, size - d)).contiguous()


def at_kernel_head_dim(name: str, launch: Callable[..., Any],
                       padded: Sequence[Optional[torch.Tensor]], *rest):
    """``launch(*padded, *rest, scale=d ** -0.5)`` at the head dim
    ``name``'s kernel is built for: ``padded`` (the tensors whose last dim
    is the head dim d, None skipped) zero-padded to
    :func:`kernel_head_dim`, and every output of that last dim cut back to
    d. The scale is the true head dim's. Exact: zero columns add nothing
    to Q K^T or rowsum(dO O), and come back zero in P V and the
    gradients."""
    d = padded[0].shape[-1]
    size = kernel_head_dim(name, d)
    scale = d ** -0.5
    if size == d:
        return launch(*padded, *rest, scale=scale)
    outs = launch(*(None if x is None else pad_head_dim(x, size)
                    for x in padded), *rest, scale=scale)
    if isinstance(outs, torch.Tensor):
        return outs[..., :d].contiguous()
    return tuple(x[..., :d].contiguous() if x.shape[-1] == size else x
                 for x in outs)


def _check_kernel_inputs(name: str, tensors: Dict[str, torch.Tensor]
                         ) -> None:
    device = None
    for arg, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} is on {t.device}, not CUDA")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.dim() == 4 and t.data_ptr() % 16 != 0:
            # The kernels read rows of q/k/v as 16-byte vectors.
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def _flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_fwd: q, k, v must be [B, T, H, D]")
    b, t, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != t \
            or k.shape[3] != d:
        raise ValueError(f"flash_fwd: k/v {tuple(k.shape)} do not match "
                         f"q {tuple(q.shape)}")
    for arg, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise ValueError(f"flash_fwd: {arg} must be bfloat16, "
                             f"got {x.dtype}")
    _check_kernel_inputs("flash_fwd", {"q": q, "k": k, "v": v})
    group = _group_of(h, k.shape[2])
    if 64 % group != 0:
        raise ValueError(f"flash_fwd: group {group} must divide 64")
    if t == 0:
        raise ValueError("flash_fwd: empty sequence")
    return at_kernel_head_dim("flash_fwd", _fwd_launch, (q, k, v), causal)


def _fwd_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, *, scale: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the forward kernel on checked inputs at a head dim it
    is built for."""
    from tpu_operator_torch.kernels import build

    b, t, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, h, t, 1, dtype=torch.float32, device=q.device)
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_fwd_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                out.data_ptr(), lse.data_ptr(), b, t, h,
                                k.shape[2], d, int(bool(causal)), scale,
                                stream)
    build.check(rc, "flash_fwd")
    _count("flash_fwd")
    return out, lse


# Keys per CTA of the decode kernel (CHUNK in flash_decode.cu): the grid
# splits the cache capacity S into ceil(S / DECODE_CHUNK) chunks.
DECODE_CHUNK = 256

# The decode kernel's arrival counters (int32, one per (batch row, KV
# head)), by (device index, stream): zero before the first launch, and
# every launch leaves them zero. Launches on one stream run in order, so
# threads that share a device's stream share its counters.
_DECODE_COUNTERS_LOCK = threading.Lock()
# guarded-by: _DECODE_COUNTERS_LOCK
_DECODE_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _decode_counters(device: torch.device, stream: int,
                     n: int) -> torch.Tensor:
    key = (device.index, stream)
    with _DECODE_COUNTERS_LOCK:
        counters = _DECODE_COUNTERS.get(key)
        if counters is None or counters.numel() < n:
            counters = torch.zeros(n, dtype=torch.int32, device=device)
            _DECODE_COUNTERS[key] = counters
        return counters


# Query rows (group x Tq) of one decode-kernel launch: a longer Tq is
# split into panels of DECODE_ROWS // group query slots, one launch each.
DECODE_ROWS = 16


def _decode_panels(tq: int, group: int) -> List[Tuple[int, int]]:
    """(first slot, slots) of each decode-kernel launch over ``tq`` query
    slots: panels of ``DECODE_ROWS // group`` slots."""
    per = DECODE_ROWS // group
    if per == 0:
        raise ValueError(f"flash_decode: group {group} exceeds the kernel's "
                         f"{DECODE_ROWS} query rows")
    return [(a, min(per, tq - a)) for a in range(0, tq, per)]


def _decode_by_panels(attend: Callable[..., torch.Tensor], q: torch.Tensor,
                      k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """``attend(q, k, v, lengths)`` over [B,Tq,H,D] queries, one call per
    panel of :func:`_decode_panels`. The panel [a, a + n) passes lengths
    - (Tq - a - n), so its slot j sits at lengths - Tq + a + j, where the
    whole-Tq call places it; a length that falls below 0 masks every key,
    as it does for those slots in the whole-Tq call."""
    tq = q.shape[1]
    panels = _decode_panels(tq, _group_of(q.shape[2], k.shape[2]))
    if len(panels) == 1:
        return attend(q, k, v, lengths)
    return torch.cat([attend(q[:, a:a + n].contiguous(), k, v,
                             lengths - (tq - a - n))
                      for a, n in panels], dim=1)


def _flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_decode: q [B,Tq,H,D], k/v [B,S,KVH,D]")
    b, tq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_decode: k/v {tuple(k.shape)} do not match "
                         f"q {tuple(q.shape)}")
    for arg, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise ValueError(f"flash_decode: {arg} must be bfloat16, "
                             f"got {x.dtype}")
    if lengths.dtype != torch.int32 or lengths.shape != (b,):
        raise ValueError(f"flash_decode: lengths must be int32 [{b}]")
    _decode_panels(tq, _group_of(h, k.shape[2]))
    _check_kernel_inputs("flash_decode",
                         {"q": q, "k": k, "v": v, "lengths": lengths})

    def launch(q, k, v, lengths, *, scale):
        return _decode_by_panels(
            lambda *a: _decode_launch(*a, scale=scale), q, k, v, lengths)

    return at_kernel_head_dim("flash_decode", launch, (q, k, v), lengths)


def _decode_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   lengths: torch.Tensor, *, scale: float) -> torch.Tensor:
    """One launch of the decode kernel on checked inputs at a head dim it
    is built for, with group x Tq <= DECODE_ROWS."""
    from tpu_operator_torch.kernels import build

    b, tq, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    # Each chunk's partial state: group x Tq rows of (acc[D], m, l) in f32;
    # on the wide path (D > 128) one such state of WIDE_CHUNK columns for
    # each of the D / WIDE_CHUNK column blocks, each with its own counter.
    blocks = d // WIDE_CHUNK if d > WIDE_CHUNK else 1
    part = WIDE_CHUNK + 2 if blocks > 1 else d + 2
    ws_floats = b * kvh * -(-s // DECODE_CHUNK) * group * tq * blocks * part
    if ws_floats >= 2 ** 31:
        raise ValueError(f"flash_decode: workspace of {ws_floats} floats "
                         f"overflows int32")
    out = torch.empty_like(q)
    ws = torch.empty(ws_floats, dtype=torch.float32, device=q.device)
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        counters = _decode_counters(q.device, stream, b * kvh * blocks)
        rc = lib.flash_decode_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   lengths.data_ptr(), out.data_ptr(),
                                   ws.data_ptr(), counters.data_ptr(), b, tq,
                                   s, h, kvh, d, ws_floats, scale, stream)
    build.check(rc, "flash_decode")
    _count("flash_decode")
    return out


def _check_positions(name: str, offsets: Tuple[int, int, int], tq: int,
                     tk: int) -> None:
    q_off, k_off, stride = offsets
    if max(abs(q_off), abs(k_off)) + stride * max(tq, tk) >= 2 ** 31:
        raise ValueError(f"{name}: positions overflow int32")


_GRAD_DTYPES = (torch.bfloat16, torch.float32)


def _flash_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    g: torch.Tensor, L: torch.Tensor,
                    out: Optional[torch.Tensor], D: Optional[torch.Tensor],
                    offsets: Tuple[int, int, int], causal: bool,
                    grad_dtype: torch.dtype
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both backward kernels. Exactly one of ``out`` (fused D: the dq
    kernel computes D and hands it to dkv) and ``D`` ([B,H,Tq,1] f32) is
    given."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_bwd: q/dO [B,Tq,H,D], k/v [B,Tk,KVH,D]")
    b, tq, h, d = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    if g.shape != q.shape or (out is not None and out.shape != q.shape):
        raise ValueError(f"flash_bwd: dO/O must match q {tuple(q.shape)}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_bwd: k/v {tuple(k.shape)} do not match "
                         f"q {tuple(q.shape)}")
    rows = {"q": q, "k": k, "v": v, "dO": g}
    if out is not None:
        rows["O"] = out
    for arg, x in rows.items():
        if x.dtype != torch.bfloat16:
            raise ValueError(f"flash_bwd: {arg} must be bfloat16, "
                             f"got {x.dtype}")
    stats = {"L": L} if D is None else {"L": L, "D": D}
    for arg, x in stats.items():
        if x.dtype != torch.float32 or tuple(x.shape) != (b, h, tq, 1):
            raise ValueError(f"flash_bwd: {arg} must be f32 [{b},{h},{tq},1]")
    if grad_dtype not in _GRAD_DTYPES:
        raise ValueError(f"flash_bwd: grad_dtype must be bf16 or f32, "
                         f"got {grad_dtype}")
    group = _group_of(h, kvh)
    if 64 % group != 0:
        raise ValueError(f"flash_bwd: group {group} must divide 64")
    _check_kernel_inputs("flash_bwd", {**rows, **stats})
    _check_positions("flash_bwd", offsets, tq, tk)
    if D is None and kernel_head_dim("flash_bwd", d) > WIDE_CHUNK:
        # D = rowsum(dO O) spans the whole head dim, which the wide
        # kernels' column blocks split: they take it given.
        D = row_dot(g, out)
    return at_kernel_head_dim("flash_bwd", _bwd_launch,
                              (q, k, v, g, None if D is not None else out),
                              L, D, offsets, causal, grad_dtype)


def row_dot(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO O) [B,H,Tq,1] f32 of [B,Tq,H,D] ``g`` and ``out``."""
    return (g.float() * out.float()).sum(-1).permute(0, 2, 1)[..., None] \
        .contiguous()


def _bwd_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                g: torch.Tensor, out: Optional[torch.Tensor],
                L: torch.Tensor, D: Optional[torch.Tensor],
                offsets: Tuple[int, int, int], causal: bool,
                grad_dtype: torch.dtype, *, scale: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of each backward kernel on checked inputs at a head dim
    they are built for: D fused (from ``out``) when ``D`` is None."""
    from tpu_operator_torch.kernels import build

    b, tq, h, d = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    q_off, k_off, stride = offsets
    dq = torch.empty(q.shape, dtype=grad_dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=grad_dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=grad_dtype, device=q.device)
    # Fused D: the dq kernel computes it and writes it here for dkv.
    fused = D is None
    if fused:
        D = torch.empty(b, h, tq, 1, dtype=torch.float32, device=q.device)
    o_ptr = out.data_ptr() if fused else None
    scalars = (b, tq, tk, h, kvh, d, int(bool(causal)), q_off, k_off, stride,
               scale, int(grad_dtype == torch.float32))
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_bwd_dq_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            L.data_ptr(), o_ptr, None if fused else D.data_ptr(),
            D.data_ptr() if fused else None, dq.data_ptr(), *scalars, stream)
        build.check(rc, "flash_bwd_dq")
        _count("flash_bwd_dq")
        rc = lib.flash_bwd_dkv_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    g.data_ptr(), L.data_ptr(), D.data_ptr(),
                                    dk.data_ptr(), dv.data_ptr(), *scalars,
                                    stream)
        build.check(rc, "flash_bwd_dkv")
        _count("flash_bwd_dkv")
    return dq, dk, dv


def _flash_merge_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      carry: Carry, offsets: Tuple[int, int, int],
                      causal: bool) -> Carry:
    """The merge kernel; the carry it returns is new (the given one is
    read, not written)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_merge: q [B,Tq,H,D], k/v [B,Tk,KVH,D]")
    b, tq, h, d = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_merge: k/v {tuple(k.shape)} do not match "
                         f"q {tuple(q.shape)}")
    for arg, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise ValueError(f"flash_merge: {arg} must be bfloat16, "
                             f"got {x.dtype}")
    o, l, m = carry
    for arg, x, shape in (("o", o, (b, h, tq, d)), ("l", l, (b, h, tq, 1)),
                          ("m", m, (b, h, tq, 1))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"flash_merge: carry {arg} must be f32 "
                             f"{list(shape)}")
    group = _group_of(h, kvh)
    if 64 % group != 0:
        raise ValueError(f"flash_merge: group {group} must divide 64")
    _check_kernel_inputs("flash_merge", {"q": q, "k": k, "v": v, "o": o,
                                         "l": l, "m": m})
    _check_positions("flash_merge", offsets, tq, tk)
    return at_kernel_head_dim("flash_merge", _merge_launch, (q, k, v, o),
                              l, m, offsets, causal)


def _merge_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, l: torch.Tensor, m: torch.Tensor,
                  offsets: Tuple[int, int, int], causal: bool, *,
                  scale: float) -> Carry:
    """One launch of the merge kernel on checked inputs at a head dim it
    is built for."""
    from tpu_operator_torch.kernels import build

    b, tq, h, d = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    o_out, l_out, m_out = (torch.empty_like(x) for x in (o, l, m))
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_merge_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            l.data_ptr(), m.data_ptr(), o_out.data_ptr(), l_out.data_ptr(),
            m_out.data_ptr(), b, tq, tk, h, kvh, d, int(bool(causal)),
            *offsets, scale, stream)
    build.check(rc, "flash_merge")
    _count("flash_merge")
    return o_out, l_out, m_out


def _route(q: torch.Tensor) -> str:
    if q.is_cuda:
        return "cuda"
    if q.device.type == "cpu":
        return "cpu"
    raise ValueError(f"no attention path for device {q.device}")


# --- K1 and K2 as torch custom ops -------------------------------------------
#
# A ctypes call is not a torch op: no TorchDispatchMode sees it, so a
# selective-checkpoint policy (models.remat_policy) could not save the
# forward kernel's outputs. The two ops below are what every
# differentiable attention (flash_attention) and every prefill
# (flash_attention_with_lse) dispatch. Each has a CUDA implementation (the
# kernels, or raise), a CPU one (the plain versions) and a fake one
# (shapes and dtypes only). Launches are counted inside the CUDA wrappers,
# so a fake or CPU call never counts.


@torch.library.custom_op("tpu_operator_torch::flash_fwd", mutates_args=(),
                         device_types="cuda")
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B,T,H,D] in q.dtype, L [B,H,T,1] f32): K1 on CUDA."""
    return _flash_fwd_cuda(q, k, v, causal)


@flash_fwd_op.register_kernel("cpu")
def _flash_fwd_cpu(q, k, v, causal):
    out, lse = _attn_ref(q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3),
                         v.permute(0, 2, 1, 3), causal)
    return out.permute(0, 2, 1, 3).contiguous(), lse


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, causal):
    b, t, h, _d = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((b, h, t, 1), dtype=torch.float32))


@torch.library.custom_op("tpu_operator_torch::flash_bwd", mutates_args=(),
                         device_types="cuda")
def flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 g: torch.Tensor, L: torch.Tensor, out: torch.Tensor,
                 causal: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_fwd_op` at offsets (0, 0, 1), D fused,
    grads in q's dtype: K2's two kernels on CUDA."""
    return _flash_bwd_cuda(q, k, v, g, L, out, None, (0, 0, 1), causal,
                           q.dtype)


@flash_bwd_op.register_kernel("cpu")
def _flash_bwd_cpu(q, k, v, g, L, out, causal):
    return tuple(x.contiguous() for x in attention_block_grads(
        q, k, v, g, L, out, (0, 0, 1), causal=causal, grad_dtype=q.dtype))


@flash_bwd_op.register_fake
def _flash_bwd_fake(q, k, v, g, L, out, causal):
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            torch.empty_like(k, memory_format=torch.contiguous_format),
            torch.empty_like(v, memory_format=torch.contiguous_format))


def _flash_fwd_setup(ctx, inputs, output) -> None:
    q, k, v, causal = inputs
    out, lse = output
    # L is a residual of the backward, as in the reference's custom VJP:
    # it carries no gradient.
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal = causal


def _flash_fwd_backward(ctx, g, _g_lse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_bwd_op(q, k, v, g.contiguous(), lse, out, ctx.causal)
    return dq, dk, dv, None


flash_fwd_op.register_autograd(_flash_fwd_backward,
                               setup_context=_flash_fwd_setup)

# The overload a TorchDispatchMode (a remat policy) sees.
FLASH_FWD = torch.ops.tpu_operator_torch.flash_fwd.default


# --- public entry points -----------------------------------------------------


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B,T,H,D] in q.dtype, L [B,H,T,1] f32). K/V may carry fewer
    (grouped) heads. CUDA: the fused kernel; CPU: the plain version; both
    through the ``flash_fwd`` op. Differentiable in ``out`` (L carries no
    gradient)."""
    _route(q)
    return flash_fwd_op(q, k, v, causal)


def attention_block_grads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          g: torch.Tensor, L: torch.Tensor,
                          out: Optional[torch.Tensor],
                          offsets: Sequence[int], *, causal: bool = True,
                          grad_dtype: torch.dtype = torch.float32,
                          D: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) contributions of one K/V block, given the *global* row
    logsumexp ``L`` [B,H,Tq,1] f32 and the forward output ``out``: the
    reference's contract, in the port's [B,T,H,D] layout (q, dO ``g`` and
    ``out`` [B,Tq,H,D]; k, v [B,Tk,KVH,D], and dk/dv come back at that KV
    size). ``offsets`` is (q_off, k_off) or (q_off, k_off, stride): slot i
    sits at global position off + stride*i. By default D = rowsum(dO*O) is
    fused into the kernels; a caller reusing one dO/O across many blocks
    passes ``D`` [B,H,Tq,1] f32 instead (``out`` is then unused). Grads
    come in ``grad_dtype``. CUDA: the two backward kernels; CPU: the plain
    version. A direct call, not an op: the ring's backward (given D, f32
    grads) runs it, and no remat policy saves its outputs."""
    offs = _normalize_offsets(offsets)
    if _route(q) == "cuda":
        if D is not None:
            return _flash_bwd_cuda(q, k, v, g, L, None, D, offs, causal,
                                   grad_dtype)
        return _flash_bwd_cuda(q, k, v, g, L, out, None, offs, causal,
                               grad_dtype)
    if D is None:
        D = row_dot(g, out)
    dq, dk, dv = _bwd_ref(q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3),
                          v.permute(0, 2, 1, 3), g.permute(0, 2, 1, 3), L, D,
                          offs, causal)
    return tuple(x.permute(0, 2, 1, 3).to(grad_dtype) for x in (dq, dk, dv))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Single-device exact attention, [B,T,H,D] in and out; differentiable
    through the ``flash_fwd`` op's autograd (the reference's ``_attn``
    custom VJP): the forward saves (q, k, v, O, L) and the backward is the
    ``flash_bwd`` op at offsets (0, 0, 1) with fused D and grads in the
    input dtype."""
    return flash_attention_with_lse(q, k, v, causal=causal)[0]


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """Cached-decode attention: [B,Tq,H,D] queries against a [B,S,KVH,D]
    cache with per-row valid ``lengths`` (int32 [B]). Query slot j of row b
    sits at position lengths[b] - Tq + j. CUDA: the decode kernel; CPU:
    the plain version."""
    if _route(q) == "cuda":
        return _flash_decode_cuda(q, k, v, lengths)
    return _decode_ref(q, k, v, lengths)


def merge_kv_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   carry: Carry, offsets: Sequence[int], *,
                   causal: bool = True) -> Carry:
    """Fold K/V block ``k``/``v`` [B,Tk,KVH,D] into the streaming softmax
    of the resident queries ``q`` [B,Tq,H,D]; ``carry`` is (o [B,H,Tq,D],
    l, m [B,H,Tq,1]) f32, at query-head size (:func:`init_carry`).
    ``offsets`` is (q_off, k_off) or (q_off, k_off, stride): slot i sits at
    global position off + stride*i. Returns the new carry; the given one is
    left as it was. CUDA: the merge kernel; CPU: the plain version."""
    offs = _normalize_offsets(offsets)
    if _route(q) == "cuda":
        return _flash_merge_cuda(q, k, v, carry, offs, causal)
    return _merge_ref(q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3),
                      v.permute(0, 2, 1, 3), *carry, offs, causal)
