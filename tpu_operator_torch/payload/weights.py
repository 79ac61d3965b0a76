"""Carry a flax LM param tree across to the port's ``TransformerLM``.

The tree is the reference's ``TransformerLM`` params as nested dicts of
numpy arrays (``tok_embed``, ``pos_embed``, ``block{i}``, ``ln_final``,
``lm_head``). Flax dense kernels are ``[in, out]``; torch ``Linear``
weights are ``[out, in]``, so kernels are transposed. Weights land in
bf16 (the reference casts them to bf16 at every apply, with the same
rounding), LayerNorm params stay f32.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from tpu_operator_torch.payload.models import TransformerLM


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _load_dense(layer: torch.nn.Linear, tree: Mapping[str, Any]) -> None:
    kernel = _t(tree["kernel"])
    if tuple(kernel.shape) != (layer.in_features, layer.out_features):
        raise ValueError(f"dense kernel {tuple(kernel.shape)} does not fit "
                         f"[{layer.in_features}, {layer.out_features}]")
    layer.weight.copy_(kernel.t())
    if layer.bias is not None:
        layer.bias.copy_(_t(tree["bias"]))
    elif "bias" in tree:
        raise ValueError("unexpected dense bias")


def _load_ln(ln: torch.nn.LayerNorm, tree: Mapping[str, Any]) -> None:
    ln.weight.copy_(_t(tree["scale"]))
    ln.bias.copy_(_t(tree["bias"]))


@torch.no_grad()
def from_flax(params: Mapping[str, Any], *, heads: int,
              device=None) -> TransformerLM:
    """``TransformerLM`` holding the flax tree's weights. ``heads`` is not
    recoverable from shapes; vocab, dim, layers, max_seq, the K/V head
    count and the qkv layout are read from the tree."""
    vocab, dim = np.shape(params["tok_embed"]["embedding"])
    max_seq = np.shape(params["pos_embed"]["embedding"])[0]
    layers = 0
    while f"block{layers}" in params:
        layers += 1
    block0 = params["block0"]
    if "qkv" in block0:
        kv_heads, split = 0, False
    else:
        kv_dim = np.shape(block0["k"]["kernel"])[1]
        kv_heads, split = kv_dim // (dim // heads), True
    model = TransformerLM(vocab, dim, heads, layers, max_seq,
                          kv_heads=kv_heads, split_qkv=split, device=device)
    model.tok_embed.weight.copy_(_t(params["tok_embed"]["embedding"]))
    model.pos_embed.weight.copy_(_t(params["pos_embed"]["embedding"]))
    for i, block in enumerate(model.blocks):
        tree = params[f"block{i}"]
        _load_ln(block.ln_attn, tree["ln_attn"])
        names = ("q", "k", "v") if split else ("qkv",)
        for name in names + ("attn_out", "mlp_up", "mlp_down"):
            _load_dense(getattr(block, name), tree[name])
        _load_ln(block.ln_mlp, tree["ln_mlp"])
    _load_ln(model.ln_final, params["ln_final"])
    _load_dense(model.lm_head, params["lm_head"])
    return model
