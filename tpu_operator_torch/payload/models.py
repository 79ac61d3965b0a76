"""The decoder LM as ``nn.Module``s (counterpart of
``tpu_operator/payload/models.py``'s ``DecoderBlock``, the decode mirrors
``decoder_block_decode`` / ``lm_decode_apply``, and the training
``TransformerLM`` of ``tpu_operator/payload/transformer.py``).

``TransformerLM.forward(tokens, positions, attend_for_layer)`` takes the
per-row positions and a per-layer attention factory, exactly as
``lm_decode_apply`` does: the paged engine's prefill injects the causal
flash forward, its decode step injects the cache write + flash decode,
and training injects the differentiable flash attention.

Numerics follow the reference, which decides parity:

- LayerNorm in f32 with epsilon 1e-6 (flax's default), on a bf16 input;
- dense layers and embeddings compute in bf16 (``COMPUTE_DTYPE``) from
  params stored in ``param_dtype``: f32 master params for training, cast
  to bf16 on every call as flax ``Dense``/``Embed(dtype=bf16)`` do; bf16
  storage for serving, where the cast is a no-op and rounds exactly as
  flax's per-call cast does. The bias is added in bf16; only ``mlp_up``
  and ``mlp_down`` carry biases;
- GELU is the tanh approximation, applied to the bf16 tensor;
- the residual stream is bf16 (bf16 embeddings, bf16 adds);
- logits come back in bf16.

Param layouts: a fused ``qkv`` projection (MHA) or split ``q``/``k``/``v``
(always under GQA), as the reference's checkpoints hold them.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6
COMPUTE_DTYPE = torch.bfloat16

# The reference's --remat-policy names (models.py:232); remat itself is
# not ported yet, so they only parse.
REMAT_POLICIES = ("full", "dots", "dots_attn", "dots_attn_gelu", "attn",
                  "attn_block")

Attend = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax ``Dense(dtype=bf16)``: cast the input and the weight to the
    compute dtype, matmul, then add the bias in that dtype."""
    y = F.linear(x.to(COMPUTE_DTYPE), layer.weight.to(COMPUTE_DTYPE))
    if layer.bias is not None:
        y = y + layer.bias.to(COMPUTE_DTYPE)
    return y


def _embed(table: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
    """flax ``Embed(dtype=bf16)``: the rows of the table in the compute
    dtype (gathered, then cast: the same values as casting the table)."""
    return table(ids).to(COMPUTE_DTYPE)


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """f32 LayerNorm, f32 output (flax ``LayerNorm(dtype=float32)``)."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps)


class DecoderBlock(nn.Module):
    """Pre-LN decoder block; ``attend`` is injected per call."""

    def __init__(self, dim: int, heads: int, kv_heads: int = 0,
                 split_qkv: Optional[bool] = None,
                 param_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        kvh = kv_heads or heads
        if kvh <= 0 or heads % kvh != 0:
            raise ValueError(
                f"heads {heads} must divide by kv_heads {kvh} > 0")
        if dim % heads != 0:
            raise ValueError(f"dim {dim} must divide by heads {heads}")
        split = (kvh != heads) if split_qkv is None else bool(split_qkv)
        if kvh != heads and not split:
            raise ValueError("grouped K/V heads need split q/k/v")
        self.dim, self.heads, self.kv_heads = dim, heads, kvh
        self.head_dim = dim // heads
        kv_dim = kvh * self.head_dim
        w = dict(dtype=param_dtype, device=device)
        self.ln_attn = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        if split:
            self.q = nn.Linear(dim, dim, bias=False, **w)
            self.k = nn.Linear(dim, kv_dim, bias=False, **w)
            self.v = nn.Linear(dim, kv_dim, bias=False, **w)
        else:
            self.qkv = nn.Linear(dim, 3 * dim, bias=False, **w)
        self.split_qkv = split
        self.attn_out = nn.Linear(dim, dim, bias=False, **w)
        self.ln_mlp = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.mlp_up = nn.Linear(dim, 4 * dim, bias=True, **w)
        self.mlp_down = nn.Linear(4 * dim, dim, bias=True, **w)

    def forward(self, x: torch.Tensor, attend: Attend) -> torch.Tensor:
        b, t, _ = x.shape
        hd = self.head_dim
        h = _layer_norm(self.ln_attn, x)
        if self.split_qkv:
            q, k, v = _dense(self.q, h), _dense(self.k, h), _dense(self.v, h)
        else:
            q, k, v = _dense(self.qkv, h).chunk(3, dim=-1)
        q = q.reshape(b, t, self.heads, hd)
        k = k.reshape(b, t, self.kv_heads, hd)
        v = v.reshape(b, t, self.kv_heads, hd)
        out = attend(q.contiguous(), k.contiguous(), v.contiguous())
        x = x + _dense(self.attn_out, out.reshape(b, t, self.dim))
        h = _layer_norm(self.ln_mlp, x)
        h = F.gelu(_dense(self.mlp_up, h), approximate="tanh")
        return x + _dense(self.mlp_down, h)


class TransformerLM(nn.Module):
    """Embed + blocks + ln_final + lm_head, with explicit positions and a
    per-layer attention factory (``attend_for_layer(i)`` returns block
    ``i``'s attend callable). Returns [B, T, vocab] bf16 logits.

    Params are built with gradients off (the serve path); a trainer turns
    them on with ``requires_grad_(True)``."""

    def __init__(self, vocab: int, dim: int, heads: int, layers: int,
                 max_seq: int, kv_heads: int = 0,
                 split_qkv: Optional[bool] = None,
                 param_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.vocab, self.dim, self.heads = vocab, dim, heads
        self.layers, self.max_seq = layers, max_seq
        self.kv_heads = kv_heads
        w = dict(dtype=param_dtype, device=device)
        self.tok_embed = nn.Embedding(vocab, dim, **w)
        self.pos_embed = nn.Embedding(max_seq, dim, **w)
        self.blocks = nn.ModuleList(
            DecoderBlock(dim, heads, kv_heads, split_qkv, param_dtype,
                         device)
            for _ in range(layers))
        self.ln_final = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.lm_head = nn.Linear(dim, vocab, bias=False, **w)
        self.requires_grad_(False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "TransformerLM":
        """Seeded init drawn from ``generator`` (on the generator's
        device): the reference's scales — dense kernels normal with std
        1/sqrt(fan_in), embeddings std 1/sqrt(dim), zero biases, unit
        LayerNorm scales."""
        def normal_(p: torch.Tensor, std: float) -> None:
            draw = torch.randn(p.shape, generator=generator,
                               device=generator.device,
                               dtype=torch.float32)
            p.copy_(draw.mul_(std))

        for module in self.modules():
            if isinstance(module, nn.Linear):
                normal_(module.weight, 1.0 / math.sqrt(module.in_features))
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.Embedding):
                normal_(module.weight, 1.0 / math.sqrt(self.dim))
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
        return self

    def forward(self, tokens: torch.Tensor, positions: Optional[torch.Tensor],
                attend_for_layer: Callable[[int], Attend]) -> torch.Tensor:
        if positions is None:
            positions = torch.arange(tokens.shape[1],
                                     device=tokens.device)[None, :]
        x = _embed(self.tok_embed, tokens) + _embed(self.pos_embed, positions)
        for i, block in enumerate(self.blocks):
            x = block(x, attend_for_layer(i))
        x = _layer_norm(self.ln_final, x)
        return _dense(self.lm_head, x)


def add_remat_policy_flag(parser) -> None:
    """``--remat-policy``, with the reference's choices; it takes effect
    only under ``--remat``, which the port refuses (compute.lm_block)."""
    parser.add_argument(
        "--remat-policy", choices=REMAT_POLICIES, default="full",
        help="what --remat recomputes (remat is not ported yet)")
