"""Weights made from the seed, handed alike to the program and to the
reference.

:func:`leaves` lists the language model's tensors by the names both sides
use (the program's ``TransformerLM`` parameter names), each with its shape
and its init: dense weights normal with std 1/sqrt(fan_in), embeddings
std 1/sqrt(hidden), biases 0, LayerNorm scales 1. :func:`make` draws every
normal tensor from one ``torch.Generator`` on the device in a single call,
so the same seed on the same card gives the same values to both sides.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple, Union

import torch

Init = Union[float, str]  # a std, or "zeros" / "ones"


def leaves(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], Init]]:
    d = cfg["hidden_size"]
    heads, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    ffn = cfg["intermediate_size"]
    vocab, pos = cfg["vocab_size"], cfg["max_position_embeddings"]
    kv_dim = kvh * (d // heads)
    emb = 1.0 / math.sqrt(d)
    out: List[Tuple[str, Tuple[int, ...], Init]] = [
        ("tok_embed.weight", (vocab, d), emb),
        ("pos_embed.weight", (pos, d), emb)]
    for i in range(cfg["num_hidden_layers"]):
        p = f"blocks.{i}."
        out += [(p + "ln_attn.weight", (d,), "ones"),
                (p + "ln_attn.bias", (d,), "zeros"),
                (p + "q.weight", (d, d), 1.0 / math.sqrt(d)),
                (p + "k.weight", (kv_dim, d), 1.0 / math.sqrt(d)),
                (p + "v.weight", (kv_dim, d), 1.0 / math.sqrt(d)),
                (p + "attn_out.weight", (d, d), 1.0 / math.sqrt(d)),
                (p + "ln_mlp.weight", (d,), "ones"),
                (p + "ln_mlp.bias", (d,), "zeros"),
                (p + "mlp_up.weight", (ffn, d), 1.0 / math.sqrt(d)),
                (p + "mlp_up.bias", (ffn,), "zeros"),
                (p + "mlp_down.weight", (d, ffn), 1.0 / math.sqrt(ffn)),
                (p + "mlp_down.bias", (d,), "zeros")]
    out += [("ln_final.weight", (d,), "ones"),
            ("ln_final.bias", (d,), "zeros"),
            ("lm_head.weight", (vocab, d), 1.0 / math.sqrt(d))]
    return out


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2 ** 63 - 1))
    return gen


@torch.no_grad()
def make(cfg: Dict, seed: int, device, dtype: torch.dtype = torch.float32
         ) -> Dict[str, torch.Tensor]:
    """name -> tensor in ``dtype`` on ``device``: the normal tensors are
    consecutive views of one float32 draw, scaled, then cast."""
    spec = leaves(cfg)
    total = sum(math.prod(shape) for _, shape, init in spec
                if not isinstance(init, str))
    draw = torch.randn(total, generator=generator(seed, device),
                       device=device, dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, init in spec:
        if init == "zeros":
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            n = math.prod(shape)
            out[name] = draw[at:at + n].view(shape).mul_(init).to(dtype)
            at += n
    return out


@torch.no_grad()
def load_into(model: torch.nn.Module, values: Dict[str, torch.Tensor]
              ) -> None:
    """Copy ``values`` into the program's model of the same widths (every
    parameter must be named)."""
    for name, p in model.named_parameters():
        src = values[name]
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"weight {name}: the benchmark made "
                             f"{tuple(src.shape)}, the program holds "
                             f"{tuple(p.shape)}")
        p.copy_(src)
