"""The payload models as ``nn.Module``s (counterpart of
``tpu_operator/payload/models.py``: ``DecoderBlock``, the decode mirrors
``decoder_block_decode`` / ``lm_decode_apply``, the training
``TransformerLM`` of ``tpu_operator/payload/transformer.py``, the remat
policies, and the classifier models ``BasicBlock``, ``CifarResNet`` and
``LinearRegressor``).

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

A model or block built with ``compute_dtype`` (the MoE payload's
``--dtype f32``) computes its embeddings, dense layers and logits in that
dtype instead. A block given ``mlp`` (the reference's
``DecoderBlock.mlp``, the MoE payload's every odd block) holds that
module as ``moe`` in place of ``mlp_up`` / ``mlp_down``.

Param layouts: a fused ``qkv`` projection (MHA) or split ``q``/``k``/``v``
(always under GQA), as the reference's checkpoints hold them.

Remat (``--remat``): :func:`remat_block` is the block class whose forward
runs under ``torch.utils.checkpoint.checkpoint`` (non-reentrant) with the
selective-checkpoint policy of :func:`remat_policy`. A policy saves an
op's output by the op (``aten.mm`` for the dense layers, the
``tpu_operator_torch::flash_fwd`` op for the attention forward) or by a
name: :func:`checkpoint_name` tags the ops that produce one of the
reference's named values (``attn_q``, ``attn_k``, ``attn_v``,
``attn_residual``, ``mlp_gelu``). PyTorch replays a checkpointed forward
in order up to the last value the backward needs, and has no dead-code
elimination, so a named region holds the op that produces the value (the
q/k/v projection, the attention output projection with its residual
add): the reference's backward skips those products once the name is
saved, and so does the port's.

The classifier (``BasicBlock``, ``CifarResNet``): convolutions and the
stem in bf16 with flax's SAME padding (asymmetric at stride 2), the port's
own :class:`BatchNorm` with flax's numerics in f32, the head in f32; under
tensor parallelism the stage-2 blocks split by output channel and the head
by class, each shard a unit (``CifarResNet``'s ``tp``).
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as checkpoint_mod

from tpu_operator_torch.payload import flash_attention as fa
from tpu_operator_torch.payload.collectives import (TPShards, fsdp_gather,
                                                    part_of, regather_saved)

LN_EPS = 1e-6
COMPUTE_DTYPE = torch.bfloat16

# The reference's --remat-policy names (models.py:232).
REMAT_POLICIES = ("full", "dots", "dots_attn", "dots_attn_gelu", "attn",
                  "attn_block")

Attend = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


# --- remat: names and policies -----------------------------------------------

_NAMES = threading.local()


class checkpoint_name:  # noqa: N801 — used like the reference's function
    """``with checkpoint_name("attn_q"): q = ...`` tags every op run inside
    as producing the named value, for :func:`remat_policy` to match. A
    thread-local set on entry and reset on exit: no op, no copy. The
    recompute runs the block's forward again, so it sets the same names
    around the same ops."""

    __slots__ = ("names", "prev")

    def __init__(self, *names: str):
        self.names = frozenset(names)

    def __enter__(self) -> None:
        self.prev = getattr(_NAMES, "current", frozenset())
        _NAMES.current = self.names

    def __exit__(self, *exc) -> None:
        _NAMES.current = self.prev


def current_names() -> frozenset:
    """The names of the innermost :class:`checkpoint_name` region."""
    return getattr(_NAMES, "current", frozenset())


# Products with no batch dims: the reference's
# dots_with_no_batch_dims_saveable (the dense layers; not bmm).
DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
ATTN_BLOCK_NAMES = ("attn_q", "attn_k", "attn_v", "attn_residual")
# Dtype casts inside a named region are recomputed, not saved: each dense
# layer casts its input and weight to bf16 itself (so the projections'
# input gradients meet in f32, as in the reference), and saving those
# casts would keep a bf16 copy of the block's input per projection.
_CAST = torch.ops.aten._to_copy.default


def remat_policy(mode: str):
    """The selective-checkpoint policy of a ``--remat-policy`` mode, as a
    ``policy(ctx, func, *args, **kwargs) -> CheckpointPolicy`` (None for
    ``full``: save nothing, recompute everything). The reference's
    meanings: ``dots`` saves the outputs of products with no batch dims
    (``aten.mm`` / ``aten.addmm``); ``dots_attn`` adds the ``flash_fwd``
    op's two outputs (O and L, the reference's ``flash_attn_out`` /
    ``flash_attn_lse``); ``dots_attn_gelu`` adds ``mlp_gelu``; ``attn``
    saves only the ``flash_fwd`` outputs; ``attn_block`` adds ``attn_q``,
    ``attn_k``, ``attn_v`` and ``attn_residual``. On a path without the
    flash op (the ring) the attention names never occur, as in the
    reference."""
    if mode not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {mode!r}")
    if mode == "full":
        return None
    dots = mode.startswith("dots")
    flash = mode != "dots"
    names = frozenset(("mlp_gelu",) if mode == "dots_attn_gelu" else
                      ATTN_BLOCK_NAMES if mode == "attn_block" else ())
    save = checkpoint_mod.CheckpointPolicy.MUST_SAVE
    recompute = checkpoint_mod.CheckpointPolicy.PREFER_RECOMPUTE

    def policy(_ctx, func, *_args, **_kwargs):
        if (dots and func in DOT_OPS) or (flash and func is fa.FLASH_FWD) \
                or (names and func is not _CAST
                    and names & current_names()):
            return save
        return recompute

    return policy


def checkpointed(fn: Callable, mode: str, *args):
    """``fn(*args)`` under a non-reentrant ``torch.utils.checkpoint`` with
    the policy of ``mode``: the backward recomputes what the policy does
    not save."""
    policy = remat_policy(mode)
    kwargs = {}
    if policy is not None:
        kwargs["context_fn"] = functools.partial(
            checkpoint_mod.create_selective_checkpoint_contexts, policy)
    return checkpoint_mod.checkpoint(fn, *args, use_reentrant=False,
                                     preserve_rng_state=False, **kwargs)


def gathered(p: torch.Tensor,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``p`` whole in ``dtype`` (default its own): an FSDP shard (a param
    with ``fsdp``, a :class:`~collectives.FSDPShard`) gathered over its
    data group and cast, any other param cast. The gather runs outside
    every named region, so no remat policy saves it: a rematerialized
    block gathers again in its recompute."""
    spec = getattr(p, "fsdp", None)
    if spec is None:
        return p if dtype is None else p.to(dtype)
    with checkpoint_name():
        return fsdp_gather(p, spec, dtype)


def _dense(layer: nn.Linear, x: torch.Tensor,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """flax ``Dense(dtype=bf16)``: cast the input and the weight to the
    compute dtype (``dtype``, default :data:`COMPUTE_DTYPE`), matmul, then
    add the bias in that dtype."""
    dtype = dtype or COMPUTE_DTYPE
    y = F.linear(x.to(dtype), gathered(layer.weight, dtype))
    if layer.bias is not None:
        y = y + gathered(layer.bias, dtype)
    return y


def _dense_part(layer: nn.Linear, x: torch.Tensor, dim: int, start: int,
                size: int, dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
    """:func:`_dense` through rows (``dim`` 0: output features, with their
    bias) or columns (``dim`` 1: input features, no bias: a row-parallel
    partial product, whose bias joins after the sum) ``start .. start +
    size - 1`` of ``layer``'s weight."""
    dtype = dtype or COMPUTE_DTYPE
    y = F.linear(x.to(dtype), layer.weight.narrow(dim, start, size).to(dtype))
    if dim == 0 and layer.bias is not None:
        y = y + layer.bias.narrow(0, start, size).to(dtype)
    return y


def resolve_split_qkv(mode: str, tp: int, log) -> bool:
    """The shared --split-qkv resolution (the reference's
    ``models.resolve_split_qkv``): 'auto' splits under TP (each model shard
    owns whole heads); an explicit 'off' under TP is allowed (fused-kernel
    checkpoint layouts) but warned. The port's shards then take their
    heads' rows of each third of the fused ``qkv``, the same arithmetic."""
    if mode == "off" and tp > 1:
        log.warning(
            "--split-qkv off with --tensor-parallel %d: the fused qkv "
            "kernel's column shards straddle the q/k/v thirds (heads not "
            "shard-local); use auto/on unless checkpoint layout "
            "compatibility requires the fused kernel", tp)
    return mode == "on" or (mode == "auto" and tp > 1)


def validate_heads_dims(heads: int, kv_heads: int, dim: int, tp: int) -> None:
    """The shared --kv-heads / --tensor-parallel divisibility contract
    (the reference's ``models.validate_heads_dims``), with its messages."""
    if kv_heads < 0:
        raise ValueError(f"--kv-heads must be >= 0, got {kv_heads}")
    if kv_heads and heads % kv_heads != 0:
        raise ValueError(
            f"--heads {heads} must divide by --kv-heads {kv_heads}")
    if tp > 1:
        if heads % tp != 0:
            raise ValueError(
                f"--heads {heads} must divide by --tensor-parallel {tp} "
                f"(TP shards whole heads)")
        if kv_heads and kv_heads % tp != 0:
            raise ValueError(
                f"--kv-heads {kv_heads} must divide by --tensor-parallel "
                f"{tp} (TP shards whole K/V heads)")
        if dim % tp != 0:
            raise ValueError(
                f"--dim {dim} must divide by --tensor-parallel {tp}")


def _embed(table: nn.Embedding, ids: torch.Tensor,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """flax ``Embed(dtype=bf16)``: the rows of the table in the compute
    dtype (gathered, then cast: the same values as casting the table)."""
    return F.embedding(ids, gathered(table.weight)).to(
        dtype or COMPUTE_DTYPE)


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """f32 LayerNorm, f32 output (flax ``LayerNorm(dtype=float32)``)."""
    return F.layer_norm(x.float(), ln.normalized_shape, gathered(ln.weight),
                        gathered(ln.bias), ln.eps)


# A block's MLP in place of the dense FFN: ``mlp(param_dtype, device)``
# builds the module, which takes the f32 ``ln_mlp`` output and returns the
# MLP's output in the compute dtype.
MlpFactory = Callable[[torch.dtype, Optional[torch.device]], nn.Module]


class DecoderBlock(nn.Module):
    """Pre-LN decoder block; ``attend`` is injected per call.

    ``compute_dtype`` is the dense layers' dtype (default
    :data:`COMPUTE_DTYPE`, bf16; f32 for the MoE payload's ``--dtype
    f32``). ``mlp`` (the reference's ``DecoderBlock.mlp``) replaces the
    dense FFN: the block holds ``moe = mlp(param_dtype, device)`` in place
    of ``mlp_up`` / ``mlp_down`` and returns ``x + moe(ln_mlp(x))``; under
    tensor parallelism the MLP is built on the block's ``tp`` and splits
    its own products."""

    def __init__(self, dim: int, heads: int, kv_heads: int = 0,
                 split_qkv: Optional[bool] = None,
                 param_dtype: torch.dtype = torch.bfloat16, device=None,
                 compute_dtype: Optional[torch.dtype] = None,
                 mlp: Optional[MlpFactory] = None,
                 tp: TPShards = TPShards()):
        super().__init__()
        self.compute_dtype = compute_dtype
        kvh = kv_heads or heads
        if kvh <= 0 or heads % kvh != 0:
            raise ValueError(
                f"heads {heads} must divide by kv_heads {kvh} > 0")
        if dim % heads != 0:
            raise ValueError(f"dim {dim} must divide by heads {heads}")
        split = (kvh != heads) if split_qkv is None else bool(split_qkv)
        if kvh != heads and not split:
            raise ValueError("grouped K/V heads need split q/k/v")
        if tp.shards > 1:
            validate_heads_dims(heads, kv_heads, dim, tp.shards)
        self.dim, self.heads, self.kv_heads = dim, heads, kvh
        self.head_dim = dim // heads
        self.tp = tp
        # This process's rows (column-parallel) or columns (row-parallel)
        # of each split weight: L = N / P shards' worth.
        part = tp.local
        n = tp.shards
        kv_dim = kvh * self.head_dim
        w = dict(dtype=param_dtype, device=device)
        self.ln_attn = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        if split:
            self.q = nn.Linear(dim, dim * part // n, bias=False, **w)
            self.k = nn.Linear(dim, kv_dim * part // n, bias=False, **w)
            self.v = nn.Linear(dim, kv_dim * part // n, bias=False, **w)
        else:
            self.qkv = nn.Linear(dim, 3 * dim * part // n, bias=False, **w)
        self.split_qkv = split
        self.attn_out = nn.Linear(dim * part // n, dim, bias=False, **w)
        self.ln_mlp = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.moe = mlp(param_dtype, device) if mlp is not None else None
        if mlp is None:
            self.mlp_up = nn.Linear(dim, 4 * dim * part // n, bias=True, **w)
            self.mlp_down = nn.Linear(4 * dim * part // n, dim, bias=True,
                                      **w)

    def tp_dims(self) -> Dict[str, Tuple[int, int]]:
        """{param name: (split dim, sections)} of the params split over the
        tensor-parallel processes: column-parallel along dim 0 (the fused
        ``qkv`` in 3 sections), row-parallel along dim 1; the rest (the
        LayerNorms, ``mlp_down``'s bias) is whole on every process. A block
        MLP adds its own (``moe.<name>``, from its ``tp_dims()``)."""
        if self.tp.shards == 1:
            return {}
        col = ["q.weight", "k.weight", "v.weight"] if self.split_qkv \
            else []
        if self.moe is None:
            col += ["mlp_up.weight", "mlp_up.bias"]
        dims = {name: (0, 1) for name in col}
        if not self.split_qkv:
            dims["qkv.weight"] = (0, 3)
        dims["attn_out.weight"] = (1, 1)
        if self.moe is None:
            dims["mlp_down.weight"] = (1, 1)
        else:
            dims.update({f"moe.{n}": d
                         for n, d in self.moe.tp_dims().items()})
        return dims

    def _forward_tp(self, x: torch.Tensor, attend: Attend) -> torch.Tensor:
        """The Megatron pairing over this process's shards, one unit each:
        q/k/v and ``mlp_up`` column-parallel (each shard's heads' rows),
        ``attn_out`` and ``mlp_down`` row-parallel (partial products summed
        over every shard, ``mlp_down``'s bias added once after the sum);
        attention is head-local, ``attend`` once per shard on its H/N query
        heads and KVH/N K/V heads. A block MLP (the MoE layer) takes the
        ``ln_mlp`` output whole and splits its experts' work itself."""
        b, t, _ = x.shape
        hd, dt, tp = self.head_dim, self.compute_dtype, self.tp
        hq, hkv = self.heads // tp.shards, self.kv_heads // tp.shards
        qw, kw = hq * hd, hkv * hd
        hs = tp.enter(_layer_norm(self.ln_attn, x))
        outs = []
        for u, h in enumerate(hs):
            if self.split_qkv:
                with checkpoint_name("attn_q"):
                    q = _dense_part(self.q, h, 0, u * qw, qw, dt)
                with checkpoint_name("attn_k"):
                    k = _dense_part(self.k, h, 0, u * kw, kw, dt)
                with checkpoint_name("attn_v"):
                    v = _dense_part(self.v, h, 0, u * kw, kw, dt)
            else:
                third = tp.local * qw
                with checkpoint_name("attn_q", "attn_k", "attn_v"):
                    q, k, v = (_dense_part(self.qkv, h, 0, j * third + u * qw,
                                           qw, dt) for j in range(3))
            outs.append(attend(q.reshape(b, t, hq, hd).contiguous(),
                               k.reshape(b, t, hkv, hd).contiguous(),
                               v.reshape(b, t, hkv, hd).contiguous()))
        with checkpoint_name("attn_residual"):
            x = x + tp.reduce([
                _dense_part(self.attn_out, o.reshape(b, t, qw), 1, u * qw,
                            qw, dt) for u, o in enumerate(outs)])
        if self.moe is not None:
            # The block MLP splits its own work over the same shards.
            return x + self.moe(_layer_norm(self.ln_mlp, x))
        hs = tp.enter(_layer_norm(self.ln_mlp, x))
        fw = 4 * self.dim // tp.shards
        parts = []
        for u, h in enumerate(hs):
            up = _dense_part(self.mlp_up, h, 0, u * fw, fw, dt)
            with checkpoint_name("mlp_gelu"):
                up = F.gelu(up, approximate="tanh")
            parts.append(_dense_part(self.mlp_down, up, 1, u * fw, fw, dt))
        down = tp.reduce(parts) + self.mlp_down.bias.to(dt or COMPUTE_DTYPE)
        return x + down

    def forward(self, x: torch.Tensor, attend: Attend) -> torch.Tensor:
        if self.tp.shards > 1:
            return self._forward_tp(x, attend)
        b, t, _ = x.shape
        hd = self.head_dim
        dt = self.compute_dtype
        h = _layer_norm(self.ln_attn, x)
        if self.split_qkv:
            with checkpoint_name("attn_q"):
                q = _dense(self.q, h, dt).reshape(b, t, self.heads, hd)
            with checkpoint_name("attn_k"):
                k = _dense(self.k, h, dt).reshape(b, t, self.kv_heads, hd)
            with checkpoint_name("attn_v"):
                v = _dense(self.v, h, dt).reshape(b, t, self.kv_heads, hd)
        else:
            with checkpoint_name("attn_q", "attn_k", "attn_v"):
                q, k, v = _dense(self.qkv, h, dt).chunk(3, dim=-1)
                q = q.reshape(b, t, self.heads, hd)
                k = k.reshape(b, t, self.kv_heads, hd)
                v = v.reshape(b, t, self.kv_heads, hd)
        out = attend(q.contiguous(), k.contiguous(), v.contiguous())
        with checkpoint_name("attn_residual"):
            x = x + _dense(self.attn_out, out.reshape(b, t, self.dim), dt)
        h = _layer_norm(self.ln_mlp, x)
        if self.moe is not None:
            return x + self.moe(h)
        h = _dense(self.mlp_up, h, dt)
        with checkpoint_name("mlp_gelu"):
            h = F.gelu(h, approximate="tanh")
        return x + _dense(self.mlp_down, h, dt)


@functools.lru_cache(maxsize=None)
def remat_block(mode: str) -> type:
    """:class:`DecoderBlock` with its forward rematerialized under the
    ``--remat-policy`` ``mode`` (the reference's ``nn.remat(DecoderBlock,
    policy=remat_policy(mode))``): the same params, the same outputs and
    gradients; the backward recomputes what the policy does not save."""
    remat_policy(mode)  # validates the mode

    class RematDecoderBlock(DecoderBlock):
        def forward(self, x: torch.Tensor, attend: Attend) -> torch.Tensor:
            return checkpointed(super().forward, mode, x, attend)

    RematDecoderBlock.__name__ = RematDecoderBlock.__qualname__ = \
        f"RematDecoderBlock_{mode}"
    return RematDecoderBlock


class TransformerLM(nn.Module):
    """Embed + blocks + ln_final + lm_head, with explicit positions and a
    per-layer attention factory (``attend_for_layer(i)`` returns block
    ``i``'s attend callable). Returns [B, T, vocab] bf16 logits.
    ``block`` is the block class (:class:`DecoderBlock`, or
    :func:`remat_block`'s under ``--remat``). ``compute_dtype`` is the
    embeddings', dense layers' and logits' dtype (default
    :data:`COMPUTE_DTYPE`); ``mlp_for_layer(i)`` gives block ``i``'s MLP
    factory, or None for the dense FFN (the MoE LM's every odd block).

    Params are built with gradients off (the serve path); a trainer turns
    them on with ``requires_grad_(True)``."""

    def __init__(self, vocab: int, dim: int, heads: int, layers: int,
                 max_seq: int, kv_heads: int = 0,
                 split_qkv: Optional[bool] = None,
                 param_dtype: torch.dtype = torch.bfloat16, device=None,
                 block: type = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 mlp_for_layer: Optional[
                     Callable[[int], Optional[MlpFactory]]] = None,
                 tp: TPShards = TPShards()):
        super().__init__()
        self.vocab, self.dim, self.heads = vocab, dim, heads
        self.layers, self.max_seq = layers, max_seq
        self.kv_heads = kv_heads
        self.compute_dtype = compute_dtype
        if vocab % tp.shards:
            raise ValueError(f"--vocab {vocab} must divide by "
                             f"--tensor-parallel {tp.shards} (lm_head "
                             f"splits over vocab)")
        self.tp = tp
        w = dict(dtype=param_dtype, device=device)
        self.tok_embed = nn.Embedding(vocab, dim, **w)
        self.pos_embed = nn.Embedding(max_seq, dim, **w)
        block = block or DecoderBlock
        self.blocks = nn.ModuleList(
            block(dim, heads, kv_heads, split_qkv, param_dtype, device,
                  compute_dtype=compute_dtype,
                  mlp=mlp_for_layer(i) if mlp_for_layer else None, tp=tp)
            for i in range(layers))
        self.ln_final = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.lm_head = nn.Linear(dim, vocab // tp.procs, bias=False, **w)
        self.requires_grad_(False)
        # Set by transformer.shard_fsdp: the forward then keeps a gathered
        # weight that autograd saves as its shard (regather_saved).
        self.fsdp = False

    def tp_dims(self) -> Dict[str, Tuple[int, int]]:
        """{param name: (split dim, sections)} of every param split over
        the tensor-parallel processes (:meth:`DecoderBlock.tp_dims`, and
        ``lm_head`` over vocab); empty without tensor parallelism."""
        if self.tp.shards == 1:
            return {}
        dims = {"lm_head.weight": (0, 1)}
        for i, block in enumerate(self.blocks):
            dims.update({f"blocks.{i}.{n}": d
                         for n, d in block.tp_dims().items()})
        return dims

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "TransformerLM":
        """Seeded init drawn from ``generator`` (on the generator's
        device): the reference's scales — dense kernels normal with std
        1/sqrt(fan_in), embeddings std 1/sqrt(dim), zero biases, unit
        LayerNorm scales. A block MLP with an ``init_weights(generator)``
        of its own draws its weights there, in module order. A param split
        over tensor-parallel processes draws the whole tensor and keeps
        this process's part, so every layout holds one model."""
        split = self.tp_dims()

        def normal_(p: torch.Tensor, std: float, name: str) -> None:
            shape = list(p.shape)
            if name in split and self.tp.procs > 1:
                shape[split[name][0]] *= self.tp.procs
            draw = torch.randn(shape, generator=generator,
                               device=generator.device,
                               dtype=torch.float32)
            if name in split and self.tp.procs > 1:
                draw = part_of(draw, *split[name], self.tp.procs,
                               self.tp.index)
            p.copy_(draw.mul_(std))

        for mname, module in self.named_modules():
            if isinstance(module, nn.Linear):
                fan_in = module.in_features
                wname = f"{mname}.weight"
                if wname in split and split[wname][0] == 1:
                    fan_in *= self.tp.procs  # row-parallel: a part of the input
                normal_(module.weight, 1.0 / math.sqrt(fan_in), wname)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.Embedding):
                normal_(module.weight, 1.0 / math.sqrt(self.dim),
                        f"{mname}.weight")
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif module is not self and hasattr(module, "init_weights"):
                module.init_weights(generator)
        return self

    def forward(self, tokens: torch.Tensor, positions: Optional[torch.Tensor],
                attend_for_layer: Callable[[int], Attend],
                return_hidden: bool = False) -> torch.Tensor:
        """Logits, or with ``return_hidden`` the ``ln_final`` output in
        bf16 before ``lm_head`` (the reference's ``return_hidden``: the
        chunked loss applies the head itself, chunk by chunk)."""
        with regather_saved() if self.fsdp else contextlib.nullcontext():
            if positions is None:
                positions = torch.arange(tokens.shape[1],
                                         device=tokens.device)[None, :]
            dt = self.compute_dtype
            x = _embed(self.tok_embed, tokens, dt) \
                + _embed(self.pos_embed, positions, dt)
            for i, block in enumerate(self.blocks):
                x = block(x, attend_for_layer(i))
            x = _layer_norm(self.ln_final, x)
            if return_hidden:
                return x.to(dt or COMPUTE_DTYPE)
            if self.tp.shards == 1:
                return _dense(self.lm_head, x, dt)
            # Column-parallel over vocab: each shard's rows, joined.
            vw = self.vocab // self.tp.shards
            logits = [_dense_part(self.lm_head, xu, 0, u * vw, vw, dt)
                      for u, xu in enumerate(self.tp.enter(x))]
            return self.tp.gather(torch.cat(logits, dim=-1), dim=-1)


def add_remat_policy_flag(parser) -> None:
    """``--remat-policy``, with the reference's choices and help."""
    parser.add_argument(
        "--remat-policy", choices=REMAT_POLICIES, default="full",
        help="what --remat recomputes: full = everything (min memory); "
             "dots = save the dense layers' products, recompute "
             "elementwise; dots_attn = dots + the flash forward's outputs "
             "(attention not re-run in the backward); dots_attn_gelu = "
             "dots_attn + the MLP gelu output; attn = ONLY the flash "
             "forward's outputs (the long-context setting); attn_block = "
             "attn + q/k/v and the post-attention residual (only mlp_up "
             "and the gelu recompute). The classifier payloads take it "
             "without --remat: anything but full checkpoints the step's "
             "forward")


# --- the classifier and the regressor ----------------------------------------

BN_MOMENTUM = 0.99
BN_EPS = 1e-5


def _data_group_size(group=None) -> int:
    """Processes whose batches one BatchNorm reduces over: ``group`` (the
    classifier's data ranks), or this process alone when it is None."""
    if group is not None and dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1


def _all_reduce_sums(sums: torch.Tensor, group=None) -> torch.Tensor:
    if _data_group_size(group) > 1:
        dist.all_reduce(sums, group=group)
    return sums


class _BatchNormTrain(torch.autograd.Function):
    """flax ``BatchNorm(use_running_average=False, dtype=float32)`` over
    the global batch: per channel of [N, C, H, W], in f32, the mean and
    ``var = max(E[x^2] - E[x]^2, 0)`` (flax's fast variance) from sums
    all-reduced over ``group`` (None: none), then ``(x -
    mean) * (rsqrt(var + eps) * scale) + bias``. The backward all-reduces
    the matching sums (sum dy, sum dy * xhat), so every process's dx is
    its share of the global batch's gradient; the scale and bias
    gradients stay local (the train step's gradient all-reduce sums them).
    Returns (y f32, mean, var), the statistics without gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, group):
        xf = x.float()
        dims = (0, 2, 3)
        count = torch.full((1,), xf.numel() // xf.shape[1],
                           dtype=torch.float32, device=x.device)
        sums = _all_reduce_sums(torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                                           count]), group)
        c = xf.shape[1]
        total = sums[-1]
        mean = sums[:c] / total
        var = torch.clamp(sums[c:2 * c] / total - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + eps)
        mul = rstd * scale
        shape = (1, c, 1, 1)
        y = (xf - mean.view(shape)) * mul.view(shape) + bias.view(shape)
        ctx.save_for_backward(x, mean, rstd, mul, total)
        ctx.mark_non_differentiable(mean, var)
        ctx.group = group
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, rstd, mul, total = ctx.saved_tensors
        shape = (1, -1, 1, 1)
        dims = (0, 2, 3)
        xhat = (x.float() - mean.view(shape)) * rstd.view(shape)
        dy = dy.float()
        local = torch.cat([dy.sum(dims), (dy * xhat).sum(dims)])
        c = mean.shape[0]
        dbias, dscale = local[:c].clone(), local[c:].clone()
        sums = _all_reduce_sums(local, ctx.group) / total
        dx = mul.view(shape) * (dy - sums[:c].view(shape)
                                - xhat * sums[c:].view(shape))
        return dx.to(x.dtype), dscale, dbias, None, None


# A tensor-parallel unit's channels of a split layer: (first, count)
# within this process's part of its params (None: every channel).
Part = Optional[Tuple[int, int]]


def _rows(t: torch.Tensor, part: Part) -> torch.Tensor:
    return t if part is None else t.narrow(0, *part)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(dtype=float32)`` with its defaults (momentum
    0.99, epsilon 1e-5, the biased batch variance into ``var``): params
    ``scale`` / ``bias``, running statistics ``mean`` / ``var`` as
    buffers. Not ``nn.BatchNorm2d``, whose momentum, variance and
    reduction differ. The running statistics are never updated in place
    by the forward: in training it returns the new ones beside the output
    (:meth:`CifarResNet.forward`), so a recompute under remat cannot
    apply them twice. ``group`` is the processes whose batches it reduces
    over (None: this process's batch is the whole). A forward given
    ``part`` normalizes that slice of the channels (a tensor-parallel
    unit's)."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))
        self.group = None

    def forward(self, x: torch.Tensor, train: bool,
                stats: Optional[list], part: Part = None) -> torch.Tensor:
        scale, bias = _rows(self.scale, part), _rows(self.bias, part)
        if not train:
            mul = torch.rsqrt(_rows(self.var, part) + BN_EPS) * scale
            shape = (1, -1, 1, 1)
            return (x.float() - _rows(self.mean, part).view(shape)) \
                * mul.view(shape) + bias.view(shape)
        y, mean, var = _BatchNormTrain.apply(x, scale, bias, BN_EPS,
                                             self.group)
        if stats is not None:
            with torch.no_grad():
                stats.append((self, BN_MOMENTUM * _rows(self.mean, part)
                              + (1 - BN_MOMENTUM) * mean,
                              BN_MOMENTUM * _rows(self.var, part)
                              + (1 - BN_MOMENTUM) * var))
        return y


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax / XLA "SAME" padding of one spatial dim: (lo, hi) with the
    odd pixel at the end, so a 3x3 stride-2 conv on 32 pads (0, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides, padding="SAME",
    use_bias=False, dtype=bfloat16)`` on NCHW: the input and the OIHW
    kernel cast to bf16, flax's SAME padding applied explicitly (not
    ``padding=1``, which would sample a shifted grid at stride 2). A
    forward given ``part`` computes that slice of the output channels."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, device=None):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel,
                                               kernel, device=device))

    def forward(self, x: torch.Tensor, part: Part = None) -> torch.Tensor:
        h_lo, h_hi = same_padding(x.shape[2], self.kernel, self.stride)
        w_lo, w_hi = same_padding(x.shape[3], self.kernel, self.stride)
        x = x.to(COMPUTE_DTYPE)
        if h_lo or h_hi or w_lo or w_hi:
            x = F.pad(x, (w_lo, w_hi, h_lo, h_hi))
        return F.conv2d(x, _rows(self.weight, part).to(COMPUTE_DTYPE),
                        stride=self.stride)


def _join(tp: TPShards, units: Sequence[torch.Tensor]) -> torch.Tensor:
    """Every shard's channels (dim 1) joined in shard order: this
    process's units, then over the model group. Its gradient keeps this
    process's part, so before a layer that needs every channel
    ``tp.enter`` of the join sums that gradient over the group first
    (all-gather forward, reduce-scatter backward). Activations join
    channels-last (the layout the NHWC images give every convolution),
    whether the shards are units or processes, so that both layouts
    reduce every BatchNorm sum in one order."""
    if units[0].dim() == 4:
        nhwc = [u.permute(0, 2, 3, 1) for u in units]
        return tp.gather(torch.cat(nhwc, dim=-1), dim=-1).permute(0, 3, 1, 2)
    return tp.gather(torch.cat(list(units), dim=1), dim=1)


class BasicBlock(nn.Module):
    """The reference's CIFAR basic block: two 3x3 convs with BatchNorm,
    a 1x1 projection (+ BatchNorm) when the shape changes, relu of the
    f32 sum.

    Split over ``tp``'s shards (``tp.shards`` > 1: the reference's
    ``param_partition_spec`` of a stage-2 block), each conv is
    column-parallel over its output channels: its params hold this
    process's ``features * local / shards`` channels, and each shard this
    process holds computes its ``features / shards`` as a unit, one after
    another, its BatchNorms normalizing its channels. A conv that needs
    every input channel takes the join of every shard's (``_join`` then
    ``tp.enter``); the identity residual takes the unit's own channels. A
    split block returns its units' outputs as a list, an unsplit one a
    tensor; either takes either (an unsplit one joins a list over
    ``joins``, the model's shards)."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 device=None, tp: TPShards = TPShards(),
                 joins: TPShards = TPShards()):
        super().__init__()
        self.tp, self.joins = tp, joins
        self.width = features // tp.shards
        here = self.width * tp.local
        self.conv1 = Conv(in_features, here, 3, strides, device)
        self.bn1 = BatchNorm(here, device)
        self.conv2 = Conv(features, here, 3, 1, device)
        self.bn2 = BatchNorm(here, device)
        self.project = in_features != features or strides != 1
        if self.project:
            self.proj = Conv(in_features, here, 1, strides, device)
            self.bn_proj = BatchNorm(here, device)

    @property
    def split(self) -> bool:
        return self.tp.shards > 1

    def forward(self, x, train: bool, stats: Optional[list]):
        if not self.split:
            if isinstance(x, list):
                x = _join(self.joins, x)
            return self._forward_whole(x, train, stats)
        tp, n = self.tp, self.width
        ins = tp.enter(_join(tp, x) if isinstance(x, list) else x)
        parts = [(u * n, n) for u in range(tp.local)]
        hidden = [F.relu(self.bn1(self.conv1(xu, p), train, stats, p))
                  for xu, p in zip(ins, parts)]
        mids = tp.enter(_join(tp, hidden))
        out = []
        for u, (yu, p) in enumerate(zip(mids, parts)):
            y = self.bn2(self.conv2(yu, p), train, stats, p)
            if self.project:
                residual = self.bn_proj(self.proj(ins[u], p), train, stats,
                                        p)
            elif isinstance(x, list):
                residual = x[u]
            else:
                residual = ins[u].narrow(1, (tp.index * tp.local + u) * n, n)
            out.append(F.relu(y + residual.to(y.dtype)))
        return out

    def _forward_whole(self, x: torch.Tensor, train: bool,
                       stats: Optional[list]) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train, stats))
        y = self.bn2(self.conv2(y), train, stats)
        residual = x
        if self.project:
            residual = self.bn_proj(self.proj(x), train, stats)
        return F.relu(y + residual.to(y.dtype))


def split_blocks(stages: int, blocks_per_stage: int,
                 scan_blocks: bool) -> List[str]:
    """The blocks whose convs the reference's ``param_partition_spec``
    splits over the model axis (its 4-D ``stage2*`` kernels): every
    ``stage2_block{b}``, or under ``scan_blocks`` (blocks 1.. stacked
    into 5-D kernels, left whole) only ``stage2_block0``."""
    if stages < 3:
        return []
    count = 1 if scan_blocks and blocks_per_stage > 1 else blocks_per_stage
    return [f"stage2_block{b}" for b in range(count)]


class CifarResNet(nn.Module):
    """ResNet-6n+2 for 32x32 inputs (the reference's ``CifarResNet``): a
    3x3 stem, three stages at ``widths`` with ``blocks_per_stage`` blocks
    each (stride 2 entering stages 1 and 2), global average pool, f32
    dense head. Takes NHWC images (the data's layout) and runs NCHW.

    ``scan_blocks`` changes only the reference's param tree (each stage's
    blocks 1..n-1 stacked under ``stage{s}_scan/block``); the port keeps
    one module per block, and ``weights`` maps the stacked tree.

    ``tp`` (``--model-parallel``): the reference's ``param_partition_spec``
    over ``tp.shards`` model shards, ``tp.local`` of them in this process:
    the blocks of :func:`split_blocks` split by output channel
    (:class:`BasicBlock`), their BatchNorms' params and statistics with
    their channels, and the head column-parallel over classes, its bias
    with it; the rest is whole on every process. ``data_group`` is the
    processes whose rows every BatchNorm reduces over, one a data rank
    (None: this process's rows are the whole batch). The seeded init
    draws every whole tensor and keeps the part, so every layout holds
    one model."""

    def __init__(self, num_classes: int = 10, blocks_per_stage: int = 3,
                 widths: Sequence[int] = (16, 32, 64),
                 scan_blocks: bool = False, device=None,
                 tp: TPShards = TPShards(), data_group=None):
        super().__init__()
        self.num_classes, self.blocks_per_stage = num_classes, blocks_per_stage
        self.widths, self.scan_blocks = tuple(widths), bool(scan_blocks)
        self.tp = tp
        split = split_blocks(len(widths), blocks_per_stage, scan_blocks)
        for what, size in (("the classes", num_classes),
                           ("the stage-2 width", widths[-1])):
            if size % tp.shards:
                raise ValueError(f"--model-parallel {tp.shards} does not "
                                 f"divide {what} ({size})")
        self.stem = Conv(3, widths[0], 3, 1, device)
        self.bn_stem = BatchNorm(widths[0], device)
        self.block_names: List[str] = []
        prev = widths[0]
        for stage, width in enumerate(widths):
            for block in range(blocks_per_stage):
                strides = 2 if (stage > 0 and block == 0) else 1
                name = f"stage{stage}_block{block}"
                self.add_module(name, BasicBlock(
                    prev, width, strides, device,
                    tp if name in split else TPShards(), tp))
                self.block_names.append(name)
                prev = width
        self.head = nn.Linear(prev, num_classes // tp.shards * tp.local,
                              device=device)
        for module in self.modules():
            if isinstance(module, BatchNorm):
                module.group = data_group

    def tp_dims(self) -> Dict[str, Tuple[int, int]]:
        """{name: (split dim, sections)} of every param and running
        statistic split over the model shards, each along dim 0 (a conv's
        output channels, a BatchNorm's channels, the head's classes);
        empty without tensor parallelism."""
        if self.tp.shards == 1:
            return {}
        dims = {"head.weight": (0, 1), "head.bias": (0, 1)}
        for name in self.block_names:
            block = getattr(self, name)
            if block.split:
                dims.update((f"{name}.{n}", (0, 1)) for n, _t in (
                    *block.named_parameters(), *block.named_buffers()))
        return dims

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "CifarResNet":
        """Seeded init from ``generator``: conv and dense kernels normal
        with std 1/sqrt(fan_in), zero head bias; BatchNorm scale 1, bias
        0, running mean 0 and var 1. A split kernel draws the whole and
        keeps this process's part."""
        dims, tp = self.tp_dims(), self.tp
        for name, module in self.named_modules():
            if isinstance(module, (Conv, nn.Linear)):
                w = module.weight
                split = f"{name}.weight" in dims
                shape = (w.shape[0] * tp.procs, *w.shape[1:]) if split \
                    else w.shape
                whole = torch.randn(shape, generator=generator,
                                    device=generator.device).mul_(
                    1.0 / math.sqrt(w[0].numel()))
                w.copy_(part_of(whole, 0, 1, tp.procs, tp.index) if split
                        else whole)
                if getattr(module, "bias", None) is not None:
                    module.bias.zero_()
        return self

    def forward(self, images: torch.Tensor, train: bool = True):
        """``train``: (logits [B, classes] f32, the new running statistics
        by buffer name), the statistics of this batch folded in with
        momentum 0.99; else the logits from the running statistics."""
        stats: Optional[list] = [] if train else None
        x = images.permute(0, 3, 1, 2)
        x = F.relu(self.bn_stem(self.stem(x), train, stats))
        for name in self.block_names:
            x = getattr(self, name)(x, train, stats)
        logits = self._head(x)
        if not train:
            return logits
        # A split BatchNorm gives one piece a unit, in unit order.
        names = {id(m): n for n, m in self.named_modules()}
        pieces: Dict[str, list] = {}
        for module, mean, var in stats:
            pieces.setdefault(names[id(module)], []).append((mean, var))
        new = {}
        for name, parts in pieces.items():
            for i, key in enumerate(("mean", "var")):
                new[f"{name}.{key}"] = parts[0][i] if len(parts) == 1 \
                    else torch.cat([p[i] for p in parts])
        return logits, new

    def _head(self, x) -> torch.Tensor:
        """The pooled features through the f32 head; under tensor
        parallelism column-parallel over classes (each unit its classes),
        the pooled features joined before it and the logits after."""
        tp = self.tp
        pooled = _join(tp, [u.mean(dim=(2, 3)) for u in x]) \
            if isinstance(x, list) else x.mean(dim=(2, 3))
        if tp.shards == 1:
            return self.head(pooled)
        c = self.num_classes // tp.shards
        logits = [F.linear(xu, self.head.weight.narrow(0, u * c, c),
                           self.head.bias.narrow(0, u * c, c))
                  for u, xu in enumerate(tp.enter(pooled))]
        return tp.gather(torch.cat(logits, dim=-1), dim=-1)

    @torch.no_grad()
    def load_batch_stats(self, stats: Dict[str, torch.Tensor]) -> None:
        """Copy new running statistics (as :meth:`forward` names them)
        into the buffers."""
        buffers = dict(self.named_buffers())
        for name, value in stats.items():
            buffers[name].copy_(value)


class LinearRegressor(nn.Module):
    """The reference's linear-regression payload model, ``y = Wx + b`` in
    f32 (flax ``Dense(features, dtype=float32)``)."""

    def __init__(self, in_features: int, features: int = 1, device=None):
        super().__init__()
        self.linear = nn.Linear(in_features, features, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "LinearRegressor":
        w = self.linear.weight
        w.copy_(torch.randn(w.shape, generator=generator,
                            device=generator.device)
                .mul_(1.0 / math.sqrt(w.shape[1])))
        self.linear.bias.zero_()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x)
