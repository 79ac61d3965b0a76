"""Carry a flax param tree across to the port's models and back: the LM
(``TransformerLM``), the CIFAR ResNet (``CifarResNet``, params and
``batch_stats``, the ``--scan-blocks`` tree included) and the linear
regressor.

The tree is the reference's ``TransformerLM`` params as nested dicts of
numpy arrays (``tok_embed``, ``pos_embed``, ``block{i}``, ``ln_final``,
``lm_head``). Flax dense kernels are ``[in, out]``; torch ``Linear``
weights are ``[out, in]``, so kernels are transposed. Dense and embedding
weights land in ``param_dtype``: bf16 for serving (the reference casts
them to bf16 at every apply, with the same rounding), f32 for training
(the reference's f32 master params). LayerNorm params stay f32.
:func:`to_flax` is the inverse, as f32 numpy arrays, so a test can compare
parameters leaf by leaf.

The classifier: conv kernels HWIO <-> OIHW, the dense head ``[in, out]``
<-> ``Linear.weight [out, in]``, BatchNorm ``scale`` / ``bias`` and the
``batch_stats`` ``mean`` / ``var`` as they are. Under ``--scan-blocks``
the reference stacks each stage's blocks 1..n-1 under
``stage{s}_scan/block`` with a leading ``[n-1]`` axis; the port's block
``stage{s}_block{b}`` is slice ``b - 1`` of it. Everything stays f32.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from tpu_operator_torch.payload.models import (BatchNorm, CifarResNet, Conv,
                                               LinearRegressor, TransformerLM)


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
              param_dtype: torch.dtype = torch.bfloat16,
              block: type = None) -> TransformerLM:
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
                          param_dtype=param_dtype, device=device,
                          block=block)
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


# --- the classifier ----------------------------------------------------------


_BN_NAMES = ("bn_stem", "bn1", "bn2", "bn_proj")
_CONV_NAMES = ("stem", "conv1", "conv2", "proj")


def _slice_tree(tree: Mapping[str, Any], index: int) -> Dict[str, Any]:
    """Slice ``index`` of every leaf's leading (stacked) axis."""
    return {k: (_slice_tree(v, index) if isinstance(v, Mapping)
                else np.asarray(v)[index]) for k, v in tree.items()}


def _stack_trees(trees) -> Dict[str, Any]:
    """The inverse of :func:`_slice_tree` over a list of equal trees."""
    first = trees[0]
    return {k: (_stack_trees([t[k] for t in trees])
                if isinstance(first[k], Mapping)
                else np.stack([t[k] for t in trees])) for k in first}


def _block_trees(tree: Mapping[str, Any], stage: int,
                 blocks: int) -> Dict[str, Any]:
    """The subtree of every ``stage{stage}_block{b}``, unstacking the
    ``stage{stage}_scan/block`` tree of the scanned layout."""
    if f"stage{stage}_scan" not in tree:
        return {f"stage{stage}_block{b}": tree[f"stage{stage}_block{b}"]
                for b in range(blocks)}
    scanned = tree[f"stage{stage}_scan"]["block"]
    out = {f"stage{stage}_block0": tree[f"stage{stage}_block0"]}
    for b in range(1, blocks):
        out[f"stage{stage}_block{b}"] = _slice_tree(scanned, b - 1)
    return out


def _unscanned(tree: Mapping[str, Any], stages: int,
               blocks: int) -> Dict[str, Any]:
    out = {k: v for k, v in tree.items()
           if not k.startswith("stage")}
    for s in range(stages):
        out.update(_block_trees(tree, s, blocks))
    return out


@torch.no_grad()
def cifar_from_flax(params: Mapping[str, Any],
                    batch_stats: Mapping[str, Any], device=None
                    ) -> CifarResNet:
    """``CifarResNet`` holding the flax classifier's params and running
    statistics, f32. Widths, blocks per stage, classes and the scan
    layout are read from the tree."""
    stages = 0
    while f"stage{stages}_block0" in params:
        stages += 1
    widths = [np.shape(params[f"stage{s}_block0"]["conv1"]["kernel"])[3]
              for s in range(stages)]
    scan = "stage0_scan" in params
    if scan:
        blocks = 1 + np.shape(params["stage0_scan"]["block"]["conv1"]
                              ["kernel"])[0]
    else:
        blocks = 0
        while f"stage0_block{blocks}" in params:
            blocks += 1
    num_classes = np.shape(params["head"]["kernel"])[1]
    model = CifarResNet(num_classes, blocks, widths, scan_blocks=scan,
                        device=device)
    flat_p = _unscanned(params, stages, blocks)
    flat_s = _unscanned(batch_stats, stages, blocks)
    for name, module in model.named_modules():
        path = name.split(".")
        if isinstance(module, Conv):
            kernel = np.asarray(_get(flat_p, path)["kernel"], np.float32)
            w = torch.from_numpy(np.ascontiguousarray(
                kernel.transpose(3, 2, 0, 1)))
            if tuple(w.shape) != tuple(module.weight.shape):
                raise ValueError(f"{name}: conv kernel {kernel.shape} does "
                                 f"not fit {tuple(module.weight.shape)} "
                                 f"(OIHW)")
            module.weight.copy_(w)
        elif isinstance(module, BatchNorm):
            p, st = _get(flat_p, path), _get(flat_s, path)
            for attr, src in (("scale", p), ("bias", p), ("mean", st),
                              ("var", st)):
                getattr(module, attr).copy_(_t(src[attr]))
    model.head.weight.copy_(_t(params["head"]["kernel"]).t())
    model.head.bias.copy_(_t(params["head"]["bias"]))
    return model


def _get(tree: Mapping[str, Any], path) -> Mapping[str, Any]:
    for key in path:
        tree = tree[key]
    return tree


def cifar_to_flax(model: CifarResNet) -> Tuple[Dict[str, Any],
                                                Dict[str, Any]]:
    """(params, batch_stats) of ``model`` as f32 numpy trees in the
    reference's layout (the scanned one when ``model.scan_blocks``): the
    inverse of :func:`cifar_from_flax`."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for name, module in model.named_modules():
        *parent, leaf = name.split(".") if name else [""]
        if isinstance(module, Conv):
            dst = params
            for key in parent:
                dst = dst.setdefault(key, {})
            dst[leaf] = {"kernel": _np(module.weight).transpose(2, 3, 1, 0)
                         .copy()}
        elif isinstance(module, BatchNorm):
            for tree, names in ((params, ("scale", "bias")),
                                (stats, ("mean", "var"))):
                dst = tree
                for key in parent:
                    dst = dst.setdefault(key, {})
                dst[leaf] = {n: _np(getattr(module, n)) for n in names}
    params["head"] = _dense_tree(model.head)
    n = model.blocks_per_stage
    if model.scan_blocks and n > 1:
        for tree in (params, stats):
            for s in range(len(model.widths)):
                rest = [tree.pop(f"stage{s}_block{b}") for b in range(1, n)]
                tree[f"stage{s}_scan"] = {"block": _stack_trees(rest)}
    return params, stats


# --- the linear regressor ----------------------------------------------------


@torch.no_grad()
def linear_from_flax(params: Mapping[str, Any], device=None
                     ) -> LinearRegressor:
    kernel = np.shape(params["linear"]["kernel"])
    model = LinearRegressor(kernel[0], kernel[1], device=device)
    _load_dense(model.linear, params["linear"])
    return model


def linear_to_flax(model: LinearRegressor) -> Dict[str, Any]:
    return {"linear": _dense_tree(model.linear)}
