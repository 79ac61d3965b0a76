"""The plain reference of the benchmark's language model, in float32.

A pre-LN decoder (GPT-2's block, arXiv 2019 "Language Models are
Unsupervised Multitask Learners") with grouped-query attention
(arXiv:2305.13245): learned token and position embeddings; per block
``x + W_o·attn(q, k, v)`` over ``LN(x)`` and ``x + W_down·gelu_tanh(W_up
LN(x) + b_up) + b_down``; a final LayerNorm and an untied output head. No
bias on q, k, v, the attention output or the head; LayerNorm epsilon from
the configuration. Query head h reads K/V head h // (heads / kv_heads).

Plain ``torch`` operations on a dict of named tensors, with no kernel,
cache or batching of the program's; it imports nothing of the program.
``quant`` (the control) rounds both inputs of every dense product, which
runs in float32 otherwise. :func:`set_exact_float32` turns TF32 off, so
the products on the card are float32 products.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Quant = Optional[Callable[[torch.Tensor, bool], torch.Tensor]]


def set_exact_float32() -> None:
    """No TF32 in matrix products or convolutions on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           quant: Quant) -> torch.Tensor:
    if quant is not None:
        x, w = quant(x, False), quant(w, True)
    y = x @ w.t()
    return y if b is None else y + b


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Causal attention on [B, T, H, D] queries and [B, T, KVH, D] keys
    and values at the given positions ([T], shared by the rows)."""
    group = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = positions[:, None] >= positions[None, :]
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(dim=-1), v)


def forward(params: Params, cfg: Dict, tokens: torch.Tensor,
            quant: Quant = None, hidden_only: bool = False
            ) -> torch.Tensor:
    """[B, T] token ids at positions 0 .. T-1 -> [B, T, vocab] float32
    logits (or, with ``hidden_only``, the final LayerNorm's output)."""
    d = cfg["hidden_size"]
    heads, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // heads
    eps = cfg["layer_norm_epsilon"]
    b, t = tokens.shape
    pos = torch.arange(t, device=tokens.device)
    x = params["tok_embed.weight"][tokens] + params["pos_embed.weight"][pos]
    for i in range(cfg["num_hidden_layers"]):
        p = f"blocks.{i}."
        h = F.layer_norm(x, (d,), params[p + "ln_attn.weight"],
                         params[p + "ln_attn.bias"], eps)
        q = _dense(h, params[p + "q.weight"], None, quant)
        k = _dense(h, params[p + "k.weight"], None, quant)
        v = _dense(h, params[p + "v.weight"], None, quant)
        o = _attention(q.view(b, t, heads, hd), k.view(b, t, kvh, hd),
                       v.view(b, t, kvh, hd), pos)
        x = x + _dense(o.reshape(b, t, d), params[p + "attn_out.weight"],
                       None, quant)
        h = F.layer_norm(x, (d,), params[p + "ln_mlp.weight"],
                         params[p + "ln_mlp.bias"], eps)
        u = F.gelu(_dense(h, params[p + "mlp_up.weight"],
                          params[p + "mlp_up.bias"], quant),
                   approximate="tanh")
        x = x + _dense(u, params[p + "mlp_down.weight"],
                       params[p + "mlp_down.bias"], quant)
    x = F.layer_norm(x, (d,), params["ln_final.weight"],
                     params["ln_final.bias"], eps)
    if hidden_only:
        return x
    return _dense(x, params["lm_head.weight"], None, quant)


def next_token_loss(params: Params, cfg: Dict, tokens: torch.Tensor,
                    quant: Quant = None) -> torch.Tensor:
    """Mean cross-entropy of token t+1 given tokens 0..t, over every row
    and position but the last."""
    logits = forward(params, cfg, tokens, quant)
    v = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, v),
                           tokens[:, 1:].reshape(-1))


class Adam:
    """Adam as optax gives it (bias-corrected moments, epsilon outside the
    square root), in float32, over a dict of params with ``.grad``."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.mu: Params = {}
        self.nu: Params = {}

    @torch.no_grad()
    def step(self, params: Params) -> None:
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for name, p in params.items():
            g = p.grad
            if name not in self.mu:
                self.mu[name] = torch.zeros_like(p)
                self.nu[name] = torch.zeros_like(p)
            mu, nu = self.mu[name], self.nu[name]
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (mu / c1) / ((nu / c2).sqrt() + self.eps))
