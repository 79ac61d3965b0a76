"""Head dims other than the kernels' own, on the CPU.

K1 and K2 are built for head dims 64 and 128, K3 and K4 for 128
(``flash_attention.KERNEL_HEAD_DIMS``). The CUDA wrappers run any other
head dim through ``flash_attention.at_kernel_head_dim``: q / k
/ v (and dO, O, the merge carry's o) zero-padded to the next size the
kernel is built for, the softmax scale of the true head dim, the outputs
cut back. The kernels cannot run here, so the same helper drives each
kernel's plain version in the kernel's own argument layout: padded, it
must give what the plain version gives at the true head dim. f32
throughout; the padded columns add exact zeros, but a longer contraction
may sum in another order, so the bound is 1e-6 of the largest value (a
wrong scale moves the output by O(10%), a column left in by O(1)).

The port's plain attention at head dims 32 and 64 is also held to the JAX
``flash_attention`` (its Pallas kernels in interpret mode) at 2e-5, the
bound of ``tests/test_torch_flash_attention.py``. Head dims above 128 (the
kernels' wide path) are held in ``tests/test_torch_wide_heads.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_operator.payload import flash_attention as jfa
from tpu_operator_torch.payload import flash_attention as tfa

HEAD_DIMS = (16, 32, 64, 96, 128)
PAD_TOL = 1e-6
JAX_TOL = 2e-5


def _inputs(seed, b, tq, h, kvh, d, tk=None):
    rng = np.random.default_rng(seed)
    tk = tq if tk is None else tk
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 for shape in ((b, tq, h, d), (b, tk, kvh, d),
                               (b, tk, kvh, d), (b, tq, h, d)))


def _close(got, want, tol=PAD_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _t(x):
    """[B,T,H,D] <-> [B,H,T,D]."""
    return x.permute(0, 2, 1, 3)


# The plain versions in each kernel launch's argument layout and order.

def _fwd_plain(q, k, v, causal, *, scale):
    out, lse = tfa._attn_ref(_t(q), _t(k), _t(v), causal, scale)
    return _t(out).contiguous(), lse


def _bwd_plain(q, k, v, g, out, L, D, offsets, causal, grad_dtype, *,
               scale):
    if D is None:
        D = (g * out).sum(-1).permute(0, 2, 1)[..., None]
    grads = tfa._bwd_ref(_t(q), _t(k), _t(v), _t(g), L, D, offsets, causal,
                         scale)
    return tuple(_t(x).to(grad_dtype).contiguous() for x in grads)


def _merge_plain(q, k, v, o, l, m, offsets, causal, *, scale):
    return tfa._merge_ref(_t(q), _t(k), _t(v), o, l, m, offsets, causal,
                          scale)


def _decode_plain(q, k, v, lengths, *, scale):
    return tfa._decode_ref(q, k, v, lengths, scale)


def test_kernel_head_dims():
    """The size each kernel runs at: K1 / K2 natively at 64 and 128, the
    next one up between; K3 / K4 at 128; above 128 every kernel's wide
    path at the next multiple of its column block: 256 for K1, K4 and
    the backward pair (dq's block), 128 for K3."""
    for d, size in ((1, 64), (16, 64), (32, 64), (64, 64), (65, 128),
                    (96, 128), (128, 128)):
        assert tfa.kernel_head_dim("flash_fwd", d) == size
        assert tfa.kernel_head_dim("flash_bwd", d) == size
        assert tfa.kernel_head_dim("flash_decode", d) == 128
        assert tfa.kernel_head_dim("flash_merge", d) == 128
    for d, size in ((129, 256), (160, 256), (192, 256), (256, 256),
                    (1000, 1024), (1024, 1024), (4096, 4096)):
        for name in tfa.KERNEL_HEAD_DIMS:
            assert tfa.kernel_head_dim(name, d) == size
    for d, fwd, other in ((300, 512, 384), (384, 512, 384),
                          (1500, 1536, 1536), (1536, 1536, 1536)):
        for name in ("flash_fwd", "flash_bwd", "flash_merge"):
            assert tfa.kernel_head_dim(name, d) == fwd
        assert tfa.kernel_head_dim("flash_decode", d) == other
    with pytest.raises(ValueError, match="positive"):
        tfa.kernel_head_dim("flash_fwd", 0)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_padded_forward_is_the_plain_forward(d, causal):
    q, k, v, _g = _inputs(d, 2, 40, 4, 2, d)
    out, lse = tfa.at_kernel_head_dim("flash_fwd", _fwd_plain, (q, k, v),
                                      causal)
    want_out, want_lse = _fwd_plain(q, k, v, causal, scale=d ** -0.5)
    assert out.shape == q.shape
    _close(out, want_out)
    _close(lse, want_lse)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("fused", [True, False], ids=["fused_d", "given_d"])
def test_padded_backward_is_the_plain_backward(d, fused):
    """dq, dk and dv through the padded path, with D fused from the padded
    dO and O (rowsum unchanged by zero columns) or given, at GQA group 2
    and offsets with a stride."""
    q, k, v, g = _inputs(100 + d, 2, 24, 4, 2, d, tk=40)
    offsets = (16, 0, 2)
    out = torch.from_numpy(np.random.default_rng(d).normal(
        size=q.shape).astype(np.float32))
    L = torch.from_numpy(np.random.default_rng(d + 1).normal(
        size=(2, 4, 24, 1)).astype(np.float32)) + 3.0
    D = None if fused else (g * out).sum(-1).permute(0, 2, 1)[..., None]
    got = tfa.at_kernel_head_dim(
        "flash_bwd", _bwd_plain, (q, k, v, g, None if D is not None else out),
        L, D, offsets, True, torch.float32)
    want = _bwd_plain(q, k, v, g, out, L, D, offsets, True, torch.float32,
                      scale=d ** -0.5)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        _close(a, b)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_padded_merge_is_the_plain_merge(d):
    """K4's plain form: a live carry (its o padded with the inputs) folded
    with an earlier block, then a home block."""
    q, k, v, _g = _inputs(200 + d, 1, 32, 4, 2, d)
    carry = tfa.init_carry(1, 4, 32, d)
    for offsets in ((32, 0, 1), (32, 32, 1)):
        o, l, m = carry
        got = tfa.at_kernel_head_dim("flash_merge", _merge_plain,
                                     (q, k, v, o), l, m, offsets, True)
        want = _merge_plain(q, k, v, o, l, m, offsets, True,
                            scale=d ** -0.5)
        for a, b in zip(got, want):
            _close(a, b)
        carry = want


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_padded_decode_is_the_plain_decode(d):
    """K3's plain form over a padded cache, ragged lengths including 0."""
    q, k, v, _g = _inputs(300 + d, 3, 2, 8, 2, d, tk=48)
    lengths = torch.tensor([0, 17, 48], dtype=torch.int32)
    got = tfa.at_kernel_head_dim("flash_decode", _decode_plain, (q, k, v),
                                 lengths)
    want = _decode_plain(q, k, v, lengths, scale=d ** -0.5)
    assert got.shape == q.shape
    _close(got, want)


def test_the_scale_is_the_true_head_dims():
    """A launch at the padded size with the padded size's scale differs:
    the helper's scale is what makes the padded path exact."""
    d = 32
    q, k, v, _g = _inputs(7, 1, 16, 2, 2, d)
    wrong, _ = _fwd_plain(*(tfa.pad_head_dim(x, 64) for x in (q, k, v)),
                          True, scale=64 ** -0.5)
    want, _ = _fwd_plain(q, k, v, True, scale=d ** -0.5)
    assert float((wrong[..., :d] - want).abs().max()) > 1e-3


@pytest.mark.parametrize("d", [32, 64])
def test_plain_attention_matches_jax_at_head_dim(monkeypatch, d):
    """The port's attention (plain forward, its autograd through the plain
    backward) against the JAX flash_attention with its Pallas kernels in
    interpret mode, 64x64 blocks over T 128, GQA group 2: O, L and the q /
    k / v gradients of sum(O * w)."""
    monkeypatch.setenv("TPU_OPERATOR_FWD_BLOCKS", "64,64")
    q, k, v, w = _inputs(400 + d, 2, 128, 4, 2, d)
    jq, jk, jv, jw = (jnp.asarray(x.numpy()) for x in (q, k, v, w))
    want = jfa.flash_attention(jq, jk, jv, causal=True, use_pallas=True)

    def jloss(a, b, c):
        return jnp.sum(jfa.flash_attention(a, b, c, causal=True,
                                           use_pallas=True) * jw)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (x.clone().requires_grad_(True) for x in (q, k, v))
    got, lse = tfa.flash_attention_with_lse(tq, tk, tv, causal=True)
    _close(got.detach(), want, JAX_TOL)
    qt, kt, vt = (jnp.einsum("bthd->bhtd", x) for x in (jq, jk, jv))
    _want_o, want_l = jfa._attn_impl(True, True, qt, kt, vt)
    _close(lse.detach(), want_l, JAX_TOL)
    (got * w).sum().backward()
    for name, x, jg in zip("qkv", (tq, tk, tv), jgrads):
        _close(x.grad, jg, JAX_TOL)
