"""The payload optimizers (counterpart of
``tpu_operator/payload/optimizers.py`` and the ``optax.adam`` /
``optax.sgd`` the payloads build through it).

Every optimizer works on a parameter list in place: ``init(params)`` makes
its state, ``step(params, state)`` applies one update from the params'
``.grad``. ``torch.optim`` is not used: it cannot keep adam's mu in bf16
beside f32 params, nor the int8 moments.

:func:`adam` reproduces ``optax.adam`` step for step, a bf16 first moment
(``mu_dtype``) included. Per step, with count the step number from 1:

- ``mu = (1 - b1) * g + b1 * mu`` in f32 (optax forms it from the stored
  mu: a bf16 mu is scaled by ``b1`` in bf16, then added in f32);
- ``nu = (1 - b2) * g * g + b2 * nu`` in f32;
- ``mu_hat = mu / (1 - b1**count)``, ``nu_hat = nu / (1 - b2**count)``,
  the corrections in f32;
- ``p += -lr * mu_hat / (sqrt(nu_hat) + eps)``;
- then mu is stored cast to ``mu_dtype``.

:func:`adam8` is the reference's 8-bit adam: both moments int8 in blocks
of :data:`BLOCK` along the last axis with an f32 absmax scale per block,
``m`` linear and ``v`` in the sqrt domain, requantized every step by
stochastic rounding ``floor(x + u)``, ``u ~ U[0, 1)``. The uniforms come
from an explicit ``torch.Generator`` seeded per draw from (seed, count,
leaf index, moment), so the state is the moments plus ``count`` and
``seed``, and a resume is bit-equal with no generator state. The draws
are the port's own (the reference folds a JAX key), so adam8 matches the
reference in distribution, not bit for bit.

:func:`sgd` is ``optax.sgd(lr, momentum)``: the trace ``t = g + momentum
* t`` (no trace state when ``momentum`` is None), update ``-lr * t``.

Each state's ``state_dict`` names its live tensors for a checkpoint and
``load_state_dict`` copies a saved one back in place, checking every name,
shape and dtype first, so the step function's tensors stay the same
across a restore.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, \
    Sequence

import numpy as np
import torch
import torch.nn.functional as F

LM_OPTIMIZERS = ("adam", "adam8")
CLASSIFIER_OPTIMIZERS = ("sgd", "adam", "adam8")

# adam8's block along the last axis, and its int8 code's range.
BLOCK = 256
QMAX = 127


def _scalar(x: int) -> torch.Tensor:
    return torch.tensor(int(x), dtype=torch.int64)


@torch.no_grad()
def _load_named(kind: str, live: Dict[str, torch.Tensor],
                saved: Mapping[str, torch.Tensor]) -> None:
    """Copy ``saved`` into the ``live`` tensors of the same names in
    place, 0-d entries (the counters) excepted. Raises ValueError, before
    copying anything, when a name, shape or dtype differs."""
    if set(saved) != set(live):
        missing = sorted(set(live) - set(saved))
        extra = sorted(set(saved) - set(live))
        raise ValueError(f"{kind} state names differ: missing "
                         f"{missing[:4]}, extra {extra[:4]}")
    for name, t in live.items():
        got = saved[name]
        if got.shape != t.shape or got.dtype != t.dtype:
            raise ValueError(
                f"{kind} state {name}: saved {got.dtype}{list(got.shape)}, "
                f"live {t.dtype}{list(t.shape)}")
    for name, t in live.items():
        if t.dim():
            t.copy_(saved[name])


def _correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in f32, as optax takes it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


@dataclasses.dataclass
class AdamState:
    """Step count and the two moments, one tensor per parameter."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]

    kind = "adam"

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The state by name: ``count`` (a 0-d int64 CPU tensor) and the
        live moment tensors ``mu.<i>`` / ``nu.<i>`` in parameter order,
        each in its own dtype (a bf16 mu stays bf16)."""
        out = {"count": _scalar(self.count)}
        for name, moments in (("mu", self.mu), ("nu", self.nu)):
            out.update((f"{name}.{i}", t) for i, t in enumerate(moments))
        return out

    def load_state_dict(self, saved: Mapping[str, torch.Tensor]) -> None:
        """Copy ``saved`` (as :meth:`state_dict` names it) into the live
        moments in place. Raises ValueError, before copying anything, when
        a name, shape or dtype differs."""
        _load_named(self.kind, self.state_dict(), saved)
        self.count = int(saved["count"])


class Adam:
    """``optax.adam(lr, b1, b2, eps, mu_dtype=mu_dtype)`` over a list of
    parameters whose ``.grad`` holds the step's gradient."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, mu_dtype: Optional[torch.dtype] = None):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu_dtype = mu_dtype

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        return AdamState(
            count=0,
            mu=[torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                for p in params],
            nu=[torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], state: AdamState) -> None:
        """One update of ``params`` (in place) from their ``.grad``."""
        state.count += 1
        bc1 = _correction(self.b1, state.count)
        bc2 = _correction(self.b2, state.count)
        # b1 in mu's dtype (optax scales a bf16 mu in bf16), made once per
        # step and device.
        b1s: Dict[tuple, torch.Tensor] = {}
        for p, mu, nu in zip(params, state.mu, state.nu):
            g = p.grad
            if g is None:
                raise ValueError("adam: a parameter has no gradient")
            key = (mu.dtype, mu.device)
            b1 = b1s.get(key)
            if b1 is None:
                b1 = b1s[key] = torch.tensor(self.b1, dtype=mu.dtype,
                                             device=mu.device)
            m = g.mul(1 - self.b1).add_(mu.mul(b1))
            nu.mul_(self.b2).add_(g.mul(g).mul_(1 - self.b2))
            update = m.div(bc1).div_(nu.div(bc2).sqrt_().add_(self.eps))
            p.add_(update.mul_(-self.lr))
            mu.copy_(m)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         mu_dtype: Optional[torch.dtype] = None) -> Adam:
    return Adam(lr, b1=b1, b2=b2, eps=eps, mu_dtype=mu_dtype)


# --- adam8 -------------------------------------------------------------------


class Quantized(NamedTuple):
    """One int8-quantized tensor in last-axis block layout: values ``q``
    [..., nblocks, BLOCK] int8 and per-block f32 ``scale`` [..., nblocks]."""

    q: torch.Tensor
    scale: torch.Tensor


def _to_blocks(x: torch.Tensor) -> torch.Tensor:
    """[..., n] -> [..., nblocks, BLOCK] (the last axis zero-padded); a
    0-d tensor becomes (1,) first."""
    if x.dim() == 0:
        x = x.reshape(1)
    pad = (-x.shape[-1]) % BLOCK
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(*x.shape[:-1], -1, BLOCK)


def _from_blocks(x: torch.Tensor, shape) -> torch.Tensor:
    """[..., nblocks, BLOCK] -> ``shape`` (the padding dropped)."""
    flat = x.reshape(*x.shape[:-2], -1)
    n_last = shape[-1] if len(shape) else 1
    return flat[..., :n_last].reshape(shape)


def _quantize(x: torch.Tensor, u: Optional[torch.Tensor],
              sqrt_domain: bool) -> Quantized:
    """f32 [..., nb, BLOCK] -> int8 blocks. ``sqrt_domain`` stores sqrt(x)
    (x >= 0). ``u`` (uniforms of x's shape) rounds stochastically,
    ``floor(x / scale + u)``; None rounds to nearest (half to even, as
    ``jnp.round``)."""
    if sqrt_domain:
        x = torch.sqrt(x)
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / float(QMAX)
    ratio = x / scale
    q = torch.round(ratio) if u is None else torch.floor(ratio + u)
    q = torch.clamp(q, -QMAX, QMAX).to(torch.int8)
    return Quantized(q, scale[..., 0])


def _dequantize(t: Quantized, sqrt_domain: bool) -> torch.Tensor:
    x = t.q.float() * t.scale[..., None]
    return x * x if sqrt_domain else x


def _mix64(*words: int) -> int:
    """A 63-bit seed from integers (splitmix64 over each word in turn)."""
    mask = (1 << 64) - 1
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h ^ (int(w) & mask)) + 0x9E3779B97F4A7C15 & mask
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & mask
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & mask
        h ^= h >> 31
    return h >> 1


def draw_uniform(shape, device, seed: int, count: int, leaf: int,
                 moment: int) -> torch.Tensor:
    """adam8's rounding uniforms for one (step, leaf, moment): f32 U[0, 1)
    from a generator on ``device`` seeded by (seed, count, leaf, moment)
    alone."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_mix64(seed, count, leaf, moment))
    return torch.rand(shape, generator=gen, device=device,
                      dtype=torch.float32)


@dataclasses.dataclass
class Adam8State:
    """Step count, the rounding seed, and both moments block-quantized,
    one :class:`Quantized` per parameter."""

    count: int
    seed: int
    m: List[Quantized]
    v: List[Quantized]

    kind = "adam8"

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """``count`` and ``seed`` (0-d int64 CPU tensors) and the live
        ``m.q.<i>``, ``m.scale.<i>``, ``v.q.<i>``, ``v.scale.<i>``."""
        out = {"count": _scalar(self.count), "seed": _scalar(self.seed)}
        for name, moments in (("m", self.m), ("v", self.v)):
            for i, t in enumerate(moments):
                out[f"{name}.q.{i}"] = t.q
                out[f"{name}.scale.{i}"] = t.scale
        return out

    def load_state_dict(self, saved: Mapping[str, torch.Tensor]) -> None:
        _load_named(self.kind, self.state_dict(), saved)
        self.count = int(saved["count"])
        self.seed = int(saved["seed"])


Uniform = Callable[..., torch.Tensor]


class Adam8:
    """The reference's ``adam8(lr, b1, b2, eps, seed)``: dequantize both
    moments, update them and take the bias-corrected step in f32 with the
    ``v_floor`` guard (``optimizers.py:219``), then requantize both by
    stochastic rounding. ``uniform(shape, device, seed, count, leaf,
    moment)`` draws the rounding uniforms (:func:`draw_uniform`; a test
    injects its own)."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, seed: int = 0,
                 uniform: Uniform = draw_uniform):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.seed = int(seed)
        self.uniform = uniform

    def init(self, params: Sequence[torch.Tensor]) -> Adam8State:
        def q_init(p: torch.Tensor) -> Quantized:
            shape = tuple(p.shape) or (1,)
            nb = -(-shape[-1] // BLOCK)
            return Quantized(
                torch.zeros(*shape[:-1], nb, BLOCK, dtype=torch.int8,
                            device=p.device),
                torch.full((*shape[:-1], nb), 1e-12 / QMAX,
                           dtype=torch.float32, device=p.device))

        return Adam8State(0, self.seed, [q_init(p) for p in params],
                          [q_init(p) for p in params])

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor],
             state: Adam8State) -> None:
        """One update of ``params`` (in place) from their ``.grad``; the
        moments are replaced in place too."""
        state.count += 1
        bc1 = _correction(self.b1, state.count)
        bc2 = _correction(self.b2, state.count)
        b1, b2 = self.b1, self.b2
        for i, (p, mq, vq) in enumerate(zip(params, state.m, state.v)):
            g = p.grad
            if g is None:
                raise ValueError("adam8: a parameter has no gradient")
            gp = _to_blocks(g.float())
            m = _dequantize(mq, False).mul_(b1).add_(gp * (1.0 - b1))
            v = _dequantize(vq, True).mul_(b2).add_(gp * (1.0 - b2) * gp)
            # The reference's quantization-noise floor on the denominator
            # (half an ulp of the v code, decayed): see its comment.
            v_floor = (vq.scale[..., None] * 0.5) ** 2 * b2
            denom = torch.maximum(v, v_floor).div_(bc2).sqrt_().add_(
                self.eps)
            upd = (m / bc1).mul_(-self.lr).div_(denom)
            p.add_(_from_blocks(upd, p.shape).to(p.dtype))
            um = self.uniform(m.shape, m.device, state.seed, state.count,
                              i, 0)
            uv = self.uniform(v.shape, v.device, state.seed, state.count,
                              i, 1)
            for old, new in ((mq, _quantize(m, um, False)),
                             (vq, _quantize(v, uv, True))):
                old.q.copy_(new.q)
                old.scale.copy_(new.scale)


def adam8(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          seed: int = 0) -> Adam8:
    return Adam8(lr, b1=b1, b2=b2, eps=eps, seed=seed)


# --- sgd ---------------------------------------------------------------------


@dataclasses.dataclass
class SGDState:
    """The momentum trace, one tensor per parameter; None without
    momentum (optax.sgd then keeps no state)."""

    trace: Optional[List[torch.Tensor]]

    kind = "sgd"

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {f"trace.{i}": t for i, t in enumerate(self.trace or ())}

    def load_state_dict(self, saved: Mapping[str, torch.Tensor]) -> None:
        _load_named(self.kind, self.state_dict(), saved)


class SGD:
    """``optax.sgd(lr, momentum)``: ``t = g + momentum * t``, then
    ``p += -lr * t``; without momentum ``p += -lr * g``."""

    def __init__(self, lr: float, momentum: Optional[float] = None):
        self.lr, self.momentum = lr, momentum

    def init(self, params: Sequence[torch.Tensor]) -> SGDState:
        if self.momentum is None:
            return SGDState(None)
        return SGDState([torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], state: SGDState) -> None:
        traces = state.trace or [None] * len(params)
        for p, t in zip(params, traces):
            g = p.grad
            if g is None:
                raise ValueError("sgd: a parameter has no gradient")
            if t is not None:
                t.copy_(g + t * self.momentum)
                g = t
            p.add_(g * -self.lr)


def sgd(lr: float, momentum: Optional[float] = None) -> SGD:
    return SGD(lr, momentum=momentum)


# --- construction from flags -------------------------------------------------


def from_args(args, default: str = "adam"):
    """The payload optimizer from parsed CLI args, the one construction
    site of every payload: ``--optimizer sgd|adam|adam8`` (``default``
    when the parser has none: adam for the LMs, sgd for the classifier
    and regression payloads), ``--adam-mu-dtype`` for adam, ``--momentum``
    for sgd where the payload defines it (None otherwise, as the
    reference passes it), ``--seed`` for adam8's rounding, ``--lr``."""
    choice = getattr(args, "optimizer", default) or default
    if choice == "adam8":
        return adam8(args.lr, seed=getattr(args, "seed", 0))
    if choice == "sgd":
        return sgd(args.lr, momentum=getattr(args, "momentum", None))
    if choice != "adam":
        raise ValueError(f"unknown optimizer {choice!r}")
    mu_dtype = (torch.bfloat16
                if getattr(args, "adam_mu_dtype", "f32") == "bf16" else None)
    return adam(args.lr, mu_dtype=mu_dtype)


def add_optimizer_flag(parser, choices: Sequence[str] = LM_OPTIMIZERS,
                       default: str = "adam") -> None:
    """``--optimizer``, shared by every payload parser: the LM payloads'
    (adam, adam8), the classifier payloads' (sgd, adam, adam8) with sgd
    the default."""
    parser.add_argument(
        "--optimizer", choices=tuple(choices), default=default,
        help="adam8 = int8 block-quantized moments with stochastic "
             "rounding (4x less optimizer memory than f32 adam)"
             + (" ; sgd = the classifier default (momentum from "
                "--momentum where the payload defines it)"
                if "sgd" in choices else ""))
