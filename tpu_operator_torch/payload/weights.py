"""Carry a flax LM param tree across to the port's ``TransformerLM`` and
back.

The tree is the reference's ``TransformerLM`` params as nested dicts of
numpy arrays (``tok_embed``, ``pos_embed``, ``block{i}``, ``ln_final``,
``lm_head``). Flax dense kernels are ``[in, out]``; torch ``Linear``
weights are ``[out, in]``, so kernels are transposed. Dense and embedding
weights land in ``param_dtype``: bf16 for serving (the reference casts
them to bf16 at every apply, with the same rounding), f32 for training
(the reference's f32 master params). LayerNorm params stay f32.
:func:`to_flax` is the inverse, as f32 numpy arrays, so a test can compare
parameters leaf by leaf.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

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
def from_flax(params: Mapping[str, Any], *, heads: int, device=None,
              param_dtype: torch.dtype = torch.bfloat16) -> TransformerLM:
    """``TransformerLM`` holding the flax tree's weights. ``heads`` is not
    recoverable from shapes; vocab, dim, layers, max_seq, the K/V head
    count and the qkv layout are read from the tree. Gradients stay off
    (the model's default)."""
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
                          kv_heads=kv_heads, split_qkv=split,
                          param_dtype=param_dtype, device=device)
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


def _np(p: torch.Tensor) -> np.ndarray:
    return p.detach().float().cpu().numpy()


def _dense_tree(layer: torch.nn.Linear) -> Dict[str, np.ndarray]:
    tree = {"kernel": _np(layer.weight).T.copy()}
    if layer.bias is not None:
        tree["bias"] = _np(layer.bias)
    return tree


def _ln_tree(ln: torch.nn.LayerNorm) -> Dict[str, np.ndarray]:
    return {"scale": _np(ln.weight), "bias": _np(ln.bias)}


def to_flax(model: TransformerLM) -> Dict[str, Any]:
    """The flax param tree of ``model`` as f32 numpy arrays (the inverse
    of :func:`from_flax`)."""
    tree: Dict[str, Any] = {
        "tok_embed": {"embedding": _np(model.tok_embed.weight)},
        "pos_embed": {"embedding": _np(model.pos_embed.weight)},
    }
    for i, block in enumerate(model.blocks):
        names = ("q", "k", "v") if block.split_qkv else ("qkv",)
        sub = {name: _dense_tree(getattr(block, name))
               for name in names + ("attn_out", "mlp_up", "mlp_down")}
        sub["ln_attn"] = _ln_tree(block.ln_attn)
        sub["ln_mlp"] = _ln_tree(block.ln_mlp)
        tree[f"block{i}"] = sub
    tree["ln_final"] = _ln_tree(model.ln_final)
    tree["lm_head"] = _dense_tree(model.lm_head)
    return tree
