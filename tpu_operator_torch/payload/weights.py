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

The MoE LM (:func:`moe_from_flax`, :func:`moe_to_flax`): the same tree,
its odd blocks holding ``moe/{router/kernel, w1, w2}`` in place of
``mlp_up`` / ``mlp_down``; the stacks ``w1`` ``[E, D, 4D]`` and ``w2``
``[E, 4D, D]`` are the port's layout as they are (an expert-parallel
model takes its part of them and gives back only that part).

The pipeline LM (:func:`pipeline_from_flax`, :func:`pipeline_to_flax`):
the reference's ``pipeline.py`` tree (``tok_embed``, ``pos_embed``, the
``stages`` stacks of ``block{i}`` subtrees, ``ln_f``, ``head``), each
stage leaf ``[S, ...]`` or ``[V, S, ...]``; a process takes and gives
back the stages it holds (under tensor parallelism over processes, its
model part of each split weight).

The classifier: conv kernels HWIO <-> OIHW, the dense head ``[in, out]``
<-> ``Linear.weight [out, in]``, BatchNorm ``scale`` / ``bias`` and the
``batch_stats`` ``mean`` / ``var`` as they are. Under ``--scan-blocks``
the reference stacks each stage's blocks 1..n-1 under
``stage{s}_scan/block`` with a leading ``[n-1]`` axis; the port's block
``stage{s}_block{b}`` is slice ``b - 1`` of it. Everything stays f32.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from tpu_operator_torch.payload.collectives import TPShards, part_of
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


def _lm_shape(params: Mapping[str, Any], heads: int) -> Dict[str, Any]:
    """TransformerLM's arguments read from the tree (``heads`` is not
    recoverable from shapes): vocab, dim, layers, max_seq, the K/V head
    count and the qkv layout."""
    vocab, dim = np.shape(params["tok_embed"]["embedding"])
    layers = 0
    while f"block{layers}" in params:
        layers += 1
    block0 = params["block0"]
    if "qkv" in block0:
        kv_heads, split = 0, False
    else:
        kv_dim = np.shape(block0["k"]["kernel"])[1]
        kv_heads, split = kv_dim // (dim // heads), True
    return dict(vocab=int(vocab), dim=int(dim), heads=heads, layers=layers,
                max_seq=int(np.shape(params["pos_embed"]["embedding"])[0]),
                kv_heads=kv_heads, split_qkv=split)


def lm_leaf_paths(model: TransformerLM
                  ) -> Dict[str, Tuple[Tuple[str, ...], bool]]:
    """Each param name of ``model`` outside a block MLP -> (its path in
    the reference's tree, whether the leaf is a transposed dense kernel):
    the one map of the LM's names that :func:`from_flax`, :func:`to_flax`
    and ``train.fsdp_dims`` read."""
    paths = {}
    for name, _p in model.named_parameters():
        *owner, kind = name.split(".")
        if owner[0] == "blocks":
            if owner[2] == "moe":
                continue
            tree = (f"block{owner[1]}", owner[2])
        else:
            tree = (owner[0],)
        module = model.get_submodule(".".join(owner))
        if isinstance(module, torch.nn.Embedding):
            paths[name] = (tree + ("embedding",), False)
        elif isinstance(module, torch.nn.LayerNorm):
            paths[name] = (tree + ("scale" if kind == "weight" else "bias",),
                           False)
        else:
            paths[name] = (tree + ("kernel" if kind == "weight" else "bias",),
                           kind == "weight")
    return paths


def _load_lm(model: TransformerLM, params: Mapping[str, Any]) -> None:
    """Copy the tree into ``model``; a block holding ``moe`` takes the
    router and its part of the expert stacks."""
    for name, (path, transposed) in lm_leaf_paths(model).items():
        leaf = _t(_get(params, path))
        if transposed:
            leaf = leaf.t()
        live = model.get_parameter(name)
        if tuple(leaf.shape) != tuple(live.shape):
            raise ValueError(f"{'/'.join(path)} {tuple(leaf.shape)} does not "
                             f"fit {tuple(live.shape)}")
        live.copy_(leaf)
    for i, block in enumerate(model.blocks):
        if block.moe is None:
            continue
        moe, sub = block.moe, params[f"block{i}"]["moe"]
        _load_dense(moe.router, sub["router"])
        for name in ("w1", "w2"):
            whole = _t(sub[name])
            part = moe.part(name, whole)
            live = getattr(moe, name)
            if tuple(part.shape) != tuple(live.shape):
                raise ValueError(f"block{i}/moe/{name} "
                                 f"{tuple(whole.shape)} does not fit "
                                 f"{tuple(live.shape)} a process")
            live.copy_(part)


@torch.no_grad()
def from_flax(params: Mapping[str, Any], *, heads: int, device=None,
              param_dtype: torch.dtype = torch.bfloat16,
              block: type = None, tensor_parallel: int = 1) -> TransformerLM:
    """``TransformerLM`` holding the flax tree's weights. ``heads`` is not
    recoverable from shapes; vocab, dim, layers, max_seq, the K/V head
    count and the qkv layout are read from the tree. ``tensor_parallel``
    N splits the model into N shards held by this one process (the
    reference's ``--tensor-parallel``: the same whole arrays). Gradients
    stay off (the model's default)."""
    model = TransformerLM(**_lm_shape(params, heads),
                          param_dtype=param_dtype, device=device,
                          block=block, tp=TPShards(tensor_parallel))
    _load_lm(model, params)
    return model


@torch.no_grad()
def moe_from_flax(params: Mapping[str, Any], args, device=None,
                  shard=None) -> TransformerLM:
    """The MoE LM (``moe.build_model``) of the flags ``args`` (heads,
    capacity factor, dispatch, compute dtype, remat; the widths must fit
    the tree) holding the reference ``MoELM``'s weights, f32, with
    ``shard`` (``moe.ExpertShard``, default every expert) of each expert
    stack. Gradients stay off."""
    from tpu_operator_torch.payload import moe

    shape = _lm_shape(params, args.heads)
    experts = int(np.shape(params["block1"]["moe"]["w1"])[0]) \
        if shape["layers"] > 1 else args.experts
    if (shape["vocab"], shape["dim"], shape["layers"], shape["max_seq"],
            experts) != (args.vocab, args.dim, args.layers, args.seq_len,
                         args.experts):
        raise ValueError(f"the tree's widths {shape} with {experts} experts "
                         f"do not fit the flags")
    model = moe.build_model(args, device, shard or moe.ExpertShard())
    _load_lm(model, params)
    return model.requires_grad_(False)


def _np(p: torch.Tensor) -> np.ndarray:
    return p.detach().float().cpu().numpy()


def _dense_tree(layer: torch.nn.Linear) -> Dict[str, np.ndarray]:
    tree = {"kernel": _np(layer.weight).T.copy()}
    if layer.bias is not None:
        tree["bias"] = _np(layer.bias)
    return tree


def to_flax(model: TransformerLM) -> Dict[str, Any]:
    """The flax param tree of ``model`` as f32 numpy arrays (the inverse
    of :func:`from_flax`, and of :func:`moe_from_flax` for a MoE LM:
    :func:`moe_to_flax`)."""
    tree: Dict[str, Any] = {}
    for name, (path, transposed) in lm_leaf_paths(model).items():
        arr = _np(model.get_parameter(name))
        dst = tree
        for key in path[:-1]:
            dst = dst.setdefault(key, {})
        dst[path[-1]] = arr.T.copy() if transposed else arr
    for i, block in enumerate(model.blocks):
        if block.moe is not None:
            tree[f"block{i}"]["moe"] = {
                "router": _dense_tree(block.moe.router),
                "w1": _np(block.moe.w1), "w2": _np(block.moe.w2)}
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
                    batch_stats: Mapping[str, Any], device=None,
                    tp: TPShards = TPShards(), data_group=None
                    ) -> CifarResNet:
    """``CifarResNet`` holding the flax classifier's params and running
    statistics, f32. Widths, blocks per stage, classes and the scan
    layout are read from the tree. Under tensor parallelism (``tp``, and
    ``data_group`` as :class:`CifarResNet` takes it) each split tensor
    holds this process's part of the whole (``CifarResNet.tp_dims``)."""
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
                        device=device, tp=tp, data_group=data_group)
    dims = model.tp_dims()

    def part(name: str, whole: torch.Tensor) -> torch.Tensor:
        if name not in dims:
            return whole
        return part_of(whole, *dims[name], tp.procs, tp.index)

    flat_p = _unscanned(params, stages, blocks)
    flat_s = _unscanned(batch_stats, stages, blocks)
    for name, module in model.named_modules():
        path = name.split(".")
        if isinstance(module, Conv):
            kernel = np.asarray(_get(flat_p, path)["kernel"], np.float32)
            w = part(f"{name}.weight", torch.from_numpy(
                np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))))
            if tuple(w.shape) != tuple(module.weight.shape):
                raise ValueError(f"{name}: conv kernel {kernel.shape} does "
                                 f"not fit {tuple(module.weight.shape)} "
                                 f"(OIHW)")
            module.weight.copy_(w)
        elif isinstance(module, BatchNorm):
            p, st = _get(flat_p, path), _get(flat_s, path)
            for attr, src in (("scale", p), ("bias", p), ("mean", st),
                              ("var", st)):
                getattr(module, attr).copy_(part(f"{name}.{attr}",
                                                 _t(src[attr])))
    model.head.weight.copy_(part("head.weight",
                                 _t(params["head"]["kernel"]).t()))
    model.head.bias.copy_(part("head.bias", _t(params["head"]["bias"])))
    return model


def _get(tree: Mapping[str, Any], path) -> Mapping[str, Any]:
    for key in path:
        tree = tree[key]
    return tree


def cifar_to_flax(model: CifarResNet) -> Tuple[Dict[str, Any],
                                                Dict[str, Any]]:
    """(params, batch_stats) of ``model`` as f32 numpy trees in the
    reference's layout (the scanned one when ``model.scan_blocks``): the
    inverse of :func:`cifar_from_flax`, for a model that holds whole
    tensors (every model shard in this process)."""
    if model.tp.procs > 1:
        raise ValueError("cifar_to_flax: the model holds a part of each "
                         "split tensor (its model group spans processes)")
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


# The reference ``MoELM`` tree of a MoE LM (the inverse of
# :func:`moe_from_flax`; the expert stacks are this process's part).
moe_to_flax = to_flax


# --- the pipeline LM -----------------------------------------------------------


def _stage_leaf_paths(model) -> Dict[str, Tuple[Tuple[str, str, str], bool]]:
    """Each stage param name of ``model`` (``pipeline.PipelineLM``:
    ``block{i}.<layer>.weight|bias``) -> (its path under the reference's
    ``stages`` tree, whether the leaf is a transposed dense kernel)."""
    stage = next(iter(model.chunks.values()))
    paths = {}
    for name, _p in stage.named_parameters():
        block, layer, kind = name.split(".")
        if isinstance(stage.get_submodule(f"{block}.{layer}"),
                      torch.nn.LayerNorm):
            paths[name] = ((block, layer,
                            "scale" if kind == "weight" else "bias"), False)
        else:
            paths[name] = ((block, layer,
                            "kernel" if kind == "weight" else "bias"),
                           kind == "weight")
    return paths


@torch.no_grad()
def pipeline_from_flax(params: Mapping[str, Any], model) -> None:
    """Copy the reference pipeline's param tree into ``model``
    (``pipeline.PipelineLM``) in place: ``tok_embed`` [vocab, dim],
    ``pos_embed`` [seq, dim], ``ln_f`` and ``head`` [dim, vocab] as they
    are, and of every ``stages`` leaf (``[S, ...]``, or ``[V, S, ...]``
    under the interleaved schedule: chunk c = j·S + d at ``[j, d]``) the
    stages this process holds, dense kernels transposed to ``Linear``'s
    ``[out, in]``, and under tensor parallelism over processes its model
    part of each split weight. Raises ValueError where a shape does not
    fit."""
    lo, k = model.local[0], len(model.local)
    tp, split = model.tp, model.tp_dims()
    for name, (path, transpose) in _stage_leaf_paths(model).items():
        leaf = np.asarray(_get(params["stages"], path))
        part = _t(leaf[:, lo:lo + k] if model.V else leaf[lo:lo + k])
        if transpose:
            part = part.transpose(-1, -2)
        if f"stages.{name}" in split and tp.procs > 1:
            part = part_of(part, *split[f"stages.{name}"], tp.procs,
                           tp.index)
        live = model.stacks[name]
        if tuple(part.shape) != tuple(live.shape):
            raise ValueError(f"stages/{'/'.join(path)} {leaf.shape} does not "
                             f"fit {tuple(live.shape)} a process")
        live.copy_(part)
    for live, leaf in ((model.tok_embed, params["tok_embed"]),
                       (model.pos_embed, params["pos_embed"]),
                       (model.ln_f_scale, params["ln_f"]["scale"]),
                       (model.ln_f_bias, params["ln_f"]["bias"]),
                       (model.head, params["head"])):
        t = _t(leaf)
        if tuple(t.shape) != tuple(live.shape):
            raise ValueError(f"a {tuple(t.shape)} leaf does not fit "
                             f"{tuple(live.shape)}")
        live.copy_(t)


def pipeline_to_flax(model, tensors: Optional[Mapping[str, torch.Tensor]]
                     = None) -> Dict[str, Any]:
    """The reference pipeline's param tree of ``model``
    (``pipeline.PipelineLM``) as f32 numpy arrays, or of ``tensors`` (the
    same names as ``model.params``, e.g. the gradients of
    ``Pipeline.loss_and_grads``): the inverse of
    :func:`pipeline_from_flax` over the stages (and model parts) this
    process holds."""
    values = model.params if tensors is None else tensors
    tree: Dict[str, Any] = {
        "tok_embed": _np(values["tok_embed"]),
        "pos_embed": _np(values["pos_embed"]),
        "stages": {},
        "ln_f": {"scale": _np(values["ln_f.scale"]),
                 "bias": _np(values["ln_f.bias"])},
        "head": _np(values["head"]),
    }
    for name, (path, transpose) in _stage_leaf_paths(model).items():
        arr = _np(values[f"stages.{name}"])
        if transpose:
            arr = np.swapaxes(arr, -1, -2).copy()
        block, layer, leaf = path
        tree["stages"].setdefault(block, {}).setdefault(layer, {})[leaf] = arr
    return tree
