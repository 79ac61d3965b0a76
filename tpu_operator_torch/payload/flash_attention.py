"""Flash attention for the serve path: CUDA kernels plus their plain
PyTorch versions (counterpart of ``tpu_operator/payload/flash_attention.py``).

Two kernels, both in ``tpu_operator_torch/kernels/csrc/``:

- :func:`flash_attention` (prefill) launches ``flash_fwd.cu``, the port of
  the TPU kernel ``_fwd_kernel``: exact attention over ``[B, T, H, D]``,
  causal or not, GQA-native (query head ``h`` reads K/V head
  ``h // group``), f32 online softmax, bf16 output plus the f32 per-row
  logsumexp ``L [B, H, T, 1]``.
- :func:`flash_decode` (every decode step) launches ``flash_decode.cu``,
  the port of ``_decode_kernel``: ``[B, Tq, H, D]`` new-token queries
  against a ``[B, S, KVH, D]`` cache with per-row int32 ``lengths``; keys
  at positions ``>= lengths[b]`` are never read.

Dispatch is by the tensors' device and nothing else: a CUDA tensor goes to
the kernel (bf16, head dim 128, contiguous) or the call raises; a CPU
tensor goes to the plain version (:func:`_attn_ref`, :func:`_decode_ref`),
which is also the yardstick ``chip_smoke.py`` holds each kernel against.
There is no fallback from the kernel to the plain version.

Masking uses the finite ``NEG_INF = -1e30`` of the reference: a masked key
adds exactly 0 once its row has seen a valid key, and a row that saw none
yields O = 0 and L = 0.

``LAUNCHES`` counts kernel launches per kernel (the plain versions never
count), so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

NEG_INF = -1e30

Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # o, l, m

# Kernel launches since the last reset, by kernel.
LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_decode": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


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
               offsets: Sequence[int], causal: bool) -> Carry:
    """Fold one K/V block into the streaming-softmax carry, on [B,H,T,D]
    blocks (K/V may carry grouped heads). ``offsets`` is (q_off, k_off) or
    (q_off, k_off, stride): slot i sits at global position off + stride*i."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = _group_of(hq, hkv)
    scale = d ** -0.5
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
              causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B,H,T,D] in q.dtype, L [B,H,T,1] f32) on [B,H,T,D] blocks:
    the reference's plain branch of ``_attn_impl``."""
    b, h, t, d = q.shape
    carry = init_carry(b, h, t, d, device=q.device)
    o, l, m = _merge_ref(q, k, v, *carry, (0, 0, 1), causal)
    return finalize((o, l, m), q.dtype), _logsumexp_rows(l, m)


def _decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
    """Length-masked attention, [B,Tq,H,D] queries against a [B,S,KVH,D]
    cache. Query slot j of row b sits at position lengths[b] - Tq + j;
    keys count iff their position is <= the query's (hence < lengths[b]).
    Single-pass max-subtracted softmax: masked lanes are exactly zero."""
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    group = _group_of(hq, hkv)
    scale = d ** -0.5
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


# --- kernel wrappers -----------------------------------------------------------


def _check_kernel_inputs(name: str, tensors: Dict[str, torch.Tensor],
                         head_dim: int) -> None:
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
    if head_dim != 128:
        raise ValueError(f"{name}: the kernel takes head dim 128, "
                         f"got {head_dim}")


def _flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    from tpu_operator_torch.kernels import build

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
    _check_kernel_inputs("flash_fwd", {"q": q, "k": k, "v": v}, d)
    group = _group_of(h, k.shape[2])
    if 64 % group != 0:
        raise ValueError(f"flash_fwd: group {group} must divide 64")
    if t == 0:
        raise ValueError("flash_fwd: empty sequence")
    out = torch.empty_like(q)
    lse = torch.empty(b, h, t, 1, dtype=torch.float32, device=q.device)
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_fwd_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                out.data_ptr(), lse.data_ptr(), b, t, h,
                                k.shape[2], d, int(bool(causal)),
                                d ** -0.5, stream)
    build.check(rc, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def _flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    from tpu_operator_torch.kernels import build

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
    _check_kernel_inputs("flash_decode",
                         {"q": q, "k": k, "v": v, "lengths": lengths}, d)
    group = _group_of(h, k.shape[2])
    if group * tq > 16:
        raise ValueError(f"flash_decode: group x Tq = {group * tq} "
                         f"exceeds the kernel's 16 query rows")
    out = torch.empty_like(q)
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_decode_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   lengths.data_ptr(), out.data_ptr(), b, tq,
                                   k.shape[1], h, k.shape[2], d, d ** -0.5,
                                   stream)
    build.check(rc, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return out


def _route(q: torch.Tensor) -> str:
    if q.is_cuda:
        return "cuda"
    if q.device.type == "cpu":
        return "cpu"
    raise ValueError(f"no attention path for device {q.device}")


# --- public entry points -------------------------------------------------------


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B,T,H,D] in q.dtype, L [B,H,T,1] f32). K/V may carry fewer
    (grouped) heads. CUDA: the fused kernel; CPU: the plain version."""
    if _route(q) == "cuda":
        return _flash_fwd_cuda(q, k, v, causal)
    out, lse = _attn_ref(q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3),
                         v.permute(0, 2, 1, 3), causal)
    return out.permute(0, 2, 1, 3), lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Single-device exact attention, [B,T,H,D] in and out."""
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
