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
own :class:`BatchNorm` with flax's numerics in f32, the head in f32.
"""

from __future__ import annotations

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
            with checkpoint_name("attn_q"):
                q = _dense(self.q, h).reshape(b, t, self.heads, hd)
            with checkpoint_name("attn_k"):
                k = _dense(self.k, h).reshape(b, t, self.kv_heads, hd)
            with checkpoint_name("attn_v"):
                v = _dense(self.v, h).reshape(b, t, self.kv_heads, hd)
        else:
            with checkpoint_name("attn_q", "attn_k", "attn_v"):
                q, k, v = _dense(self.qkv, h).chunk(3, dim=-1)
                q = q.reshape(b, t, self.heads, hd)
                k = k.reshape(b, t, self.kv_heads, hd)
                v = v.reshape(b, t, self.kv_heads, hd)
        out = attend(q.contiguous(), k.contiguous(), v.contiguous())
        with checkpoint_name("attn_residual"):
            x = x + _dense(self.attn_out, out.reshape(b, t, self.dim))
        h = _layer_norm(self.ln_mlp, x)
        h = _dense(self.mlp_up, h)
        with checkpoint_name("mlp_gelu"):
            h = F.gelu(h, approximate="tanh")
        return x + _dense(self.mlp_down, h)


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
    :func:`remat_block`'s under ``--remat``).

    Params are built with gradients off (the serve path); a trainer turns
    them on with ``requires_grad_(True)``."""

    def __init__(self, vocab: int, dim: int, heads: int, layers: int,
                 max_seq: int, kv_heads: int = 0,
                 split_qkv: Optional[bool] = None,
                 param_dtype: torch.dtype = torch.bfloat16, device=None,
                 block: type = None):
        super().__init__()
        self.vocab, self.dim, self.heads = vocab, dim, heads
        self.layers, self.max_seq = layers, max_seq
        self.kv_heads = kv_heads
        w = dict(dtype=param_dtype, device=device)
        self.tok_embed = nn.Embedding(vocab, dim, **w)
        self.pos_embed = nn.Embedding(max_seq, dim, **w)
        block = block or DecoderBlock
        self.blocks = nn.ModuleList(
            block(dim, heads, kv_heads, split_qkv, param_dtype, device)
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
                attend_for_layer: Callable[[int], Attend],
                return_hidden: bool = False) -> torch.Tensor:
        """Logits, or with ``return_hidden`` the ``ln_final`` output in
        bf16 before ``lm_head`` (the reference's ``return_hidden``: the
        chunked loss applies the head itself, chunk by chunk)."""
        if positions is None:
            positions = torch.arange(tokens.shape[1],
                                     device=tokens.device)[None, :]
        x = _embed(self.tok_embed, tokens) + _embed(self.pos_embed, positions)
        for i, block in enumerate(self.blocks):
            x = block(x, attend_for_layer(i))
        x = _layer_norm(self.ln_final, x)
        if return_hidden:
            return x.to(COMPUTE_DTYPE)
        return _dense(self.lm_head, x)


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


def _data_group_size() -> int:
    """Processes whose batches one BatchNorm reduces over: the whole
    process group (the classifier payloads are data parallel only)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _all_reduce_sums(sums: torch.Tensor) -> torch.Tensor:
    if _data_group_size() > 1:
        dist.all_reduce(sums)
    return sums


class _BatchNormTrain(torch.autograd.Function):
    """flax ``BatchNorm(use_running_average=False, dtype=float32)`` over
    the global batch: per channel of [N, C, H, W], in f32, the mean and
    ``var = max(E[x^2] - E[x]^2, 0)`` (flax's fast variance) from sums
    all-reduced over the process group, then ``(x - mean) * (rsqrt(var +
    eps) * scale) + bias``. The backward all-reduces the matching sums
    (sum dy, sum dy * xhat), so every process's dx is its share of the
    global batch's gradient; the scale and bias gradients stay local (the
    train step's gradient all-reduce sums them). Returns (y f32, mean,
    var), the statistics without gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float):
        xf = x.float()
        dims = (0, 2, 3)
        count = torch.full((1,), xf.numel() // xf.shape[1],
                           dtype=torch.float32, device=x.device)
        sums = _all_reduce_sums(torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                                           count]))
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
        sums = _all_reduce_sums(local) / total
        dx = mul.view(shape) * (dy - sums[:c].view(shape)
                                - xhat * sums[c:].view(shape))
        return dx.to(x.dtype), dscale, dbias, None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(dtype=float32)`` with its defaults (momentum
    0.99, epsilon 1e-5, the biased batch variance into ``var``): params
    ``scale`` / ``bias``, running statistics ``mean`` / ``var`` as
    buffers. Not ``nn.BatchNorm2d``, whose momentum, variance and
    reduction differ. The running statistics are never updated in place
    by the forward: in training it returns the new ones beside the output
    (:meth:`CifarResNet.forward`), so a recompute under remat cannot
    apply them twice."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, train: bool,
                stats: Optional[list]) -> torch.Tensor:
        if not train:
            mul = torch.rsqrt(self.var + BN_EPS) * self.scale
            shape = (1, -1, 1, 1)
            return (x.float() - self.mean.view(shape)) * mul.view(shape) \
                + self.bias.view(shape)
        y, mean, var = _BatchNormTrain.apply(x, self.scale, self.bias,
                                             BN_EPS)
        if stats is not None:
            with torch.no_grad():
                stats.append((self, BN_MOMENTUM * self.mean
                              + (1 - BN_MOMENTUM) * mean,
                              BN_MOMENTUM * self.var
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
    ``padding=1``, which would sample a shifted grid at stride 2)."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, device=None):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel,
                                               kernel, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h_lo, h_hi = same_padding(x.shape[2], self.kernel, self.stride)
        w_lo, w_hi = same_padding(x.shape[3], self.kernel, self.stride)
        x = x.to(COMPUTE_DTYPE)
        if h_lo or h_hi or w_lo or w_hi:
            x = F.pad(x, (w_lo, w_hi, h_lo, h_hi))
        return F.conv2d(x, self.weight.to(COMPUTE_DTYPE), stride=self.stride)


class BasicBlock(nn.Module):
    """The reference's CIFAR basic block: two 3x3 convs with BatchNorm,
    a 1x1 projection (+ BatchNorm) when the shape changes, relu of the
    f32 sum."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 device=None):
        super().__init__()
        self.conv1 = Conv(in_features, features, 3, strides, device)
        self.bn1 = BatchNorm(features, device)
        self.conv2 = Conv(features, features, 3, 1, device)
        self.bn2 = BatchNorm(features, device)
        self.project = in_features != features or strides != 1
        if self.project:
            self.proj = Conv(in_features, features, 1, strides, device)
            self.bn_proj = BatchNorm(features, device)

    def forward(self, x: torch.Tensor, train: bool,
                stats: Optional[list]) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train, stats))
        y = self.bn2(self.conv2(y), train, stats)
        residual = x
        if self.project:
            residual = self.bn_proj(self.proj(x), train, stats)
        return F.relu(y + residual.to(y.dtype))


class CifarResNet(nn.Module):
    """ResNet-6n+2 for 32x32 inputs (the reference's ``CifarResNet``): a
    3x3 stem, three stages at ``widths`` with ``blocks_per_stage`` blocks
    each (stride 2 entering stages 1 and 2), global average pool, f32
    dense head. Takes NHWC images (the data's layout) and runs NCHW.

    ``scan_blocks`` changes only the reference's param tree (each stage's
    blocks 1..n-1 stacked under ``stage{s}_scan/block``); the port keeps
    one module per block, and ``weights`` maps the stacked tree."""

    def __init__(self, num_classes: int = 10, blocks_per_stage: int = 3,
                 widths: Sequence[int] = (16, 32, 64),
                 scan_blocks: bool = False, device=None):
        super().__init__()
        self.num_classes, self.blocks_per_stage = num_classes, blocks_per_stage
        self.widths, self.scan_blocks = tuple(widths), bool(scan_blocks)
        self.stem = Conv(3, widths[0], 3, 1, device)
        self.bn_stem = BatchNorm(widths[0], device)
        self.block_names: List[str] = []
        prev = widths[0]
        for stage, width in enumerate(widths):
            for block in range(blocks_per_stage):
                strides = 2 if (stage > 0 and block == 0) else 1
                name = f"stage{stage}_block{block}"
                self.add_module(name, BasicBlock(prev, width, strides,
                                                 device))
                self.block_names.append(name)
                prev = width
        self.head = nn.Linear(prev, num_classes, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "CifarResNet":
        """Seeded init from ``generator``: conv and dense kernels normal
        with std 1/sqrt(fan_in), zero head bias; BatchNorm scale 1, bias
        0, running mean 0 and var 1."""
        for module in self.modules():
            if isinstance(module, (Conv, nn.Linear)):
                w = module.weight
                fan_in = w[0].numel()
                w.copy_(torch.randn(w.shape, generator=generator,
                                    device=generator.device)
                        .mul_(1.0 / math.sqrt(fan_in)))
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
        logits = self.head(x.mean(dim=(2, 3)))
        if not train:
            return logits
        names = {id(m): n for n, m in self.named_modules()}
        new = {}
        for module, mean, var in stats:
            new[f"{names[id(module)]}.mean"] = mean
            new[f"{names[id(module)]}.var"] = var
        return logits, new

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
