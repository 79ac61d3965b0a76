"""Parity of the port's attention (tpu_operator_torch.payload.flash_attention)
with the JAX package's, on the CPU.

The port's CPU path is the plain PyTorch version of each CUDA kernel; the
JAX side runs its Pallas kernels in interpret mode (``use_pallas=True``)
or its jnp reference, exactly as tests/test_flash_attention.py does. The
same numpy inputs (from a seed) feed both. f32 throughout, tolerance
2e-5 as in tests/test_kvcache.py: both sides compute the same f32 math in
a different summation order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_operator.payload import flash_attention as jfa
from tpu_operator.payload import ring_attention as jring
from tpu_operator_torch.payload import flash_attention as tfa

TOL = 2e-5


def _inputs(seed, b, t, h, kvh, d, tk=None):
    rng = np.random.default_rng(seed)
    tk = t if tk is None else tk
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    k = rng.normal(size=(b, tk, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, tk, kvh, d)).astype(np.float32)
    return q, k, v


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_flash_attention_matches_jax_pallas(monkeypatch, causal, group):
    """Port O and L vs the JAX fused forward kernel (interpret mode), with
    64x64 blocks over T 128 so the JAX kernel walks a 2x2 tile grid (the
    online-softmax carry and the causal tile skip both engage)."""
    monkeypatch.setenv("TPU_OPERATOR_FWD_BLOCKS", "64,64")
    h, d = 4, 16
    q, k, v = _inputs(group, 2, 128, h, h // group, d)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal,
                               use_pallas=True)
    got, lse = tfa.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    _close(got, want)
    qt, kt, vt = (jnp.einsum("bthd->bhtd", jnp.asarray(x)) for x in (q, k, v))
    want_o, want_l = jfa._attn_impl(causal, True, qt, kt, vt)
    _close(got.permute(0, 2, 1, 3), want_o)
    _close(lse, want_l)


@pytest.mark.parametrize("causal", [True, False])
def test_attn_ref_matches_jax_reference_branch(causal):
    """The port's plain forward vs the JAX jnp branch of _attn_impl, at a
    ragged T and GQA group 2."""
    q, k, v = _inputs(11, 2, 37, 4, 2, 8)
    qt, kt, vt = (np.einsum("bthd->bhtd", x) for x in (q, k, v))
    want_o, want_l = jfa._attn_impl(causal, False, jnp.asarray(qt),
                                    jnp.asarray(kt), jnp.asarray(vt))
    got_o, got_l = tfa._attn_ref(torch.from_numpy(qt), torch.from_numpy(kt),
                                 torch.from_numpy(vt), causal)
    _close(got_o, want_o)
    _close(got_l, want_l)


def test_fully_masked_rows_yield_zero_output_and_lse():
    """Keys wholly in the queries' future (k offset past every q row): each
    such row ends with m = NEG_INF, and both sides give O = 0 and L = 0."""
    q, k, v = _inputs(3, 1, 8, 4, 2, 8)
    qt, kt, vt = (np.einsum("bthd->bhtd", x) for x in (q, k, v))
    offsets = (0, 4)  # rows 0..3 see no key; rows 4..7 see some
    jcarry = jfa.init_carry(1, 4, 8, 8)
    jo, jl, jm = jfa._merge_ref(jnp.asarray(qt), jnp.asarray(kt),
                                jnp.asarray(vt), *jcarry,
                                jnp.asarray(offsets, jnp.int32), True)
    want_o = jfa.finalize((jo, jl, jm), jnp.float32)
    want_l = jfa._logsumexp_rows(jl, jm)
    tcarry = tfa.init_carry(1, 4, 8, 8)
    to, tl, tm = tfa._merge_ref(torch.from_numpy(qt), torch.from_numpy(kt),
                                torch.from_numpy(vt), *tcarry, offsets, True)
    got_o = tfa.finalize((to, tl, tm), torch.float32)
    got_l = tfa._logsumexp_rows(tl, tm)
    _close(got_o, want_o)
    _close(got_l, want_l)
    assert torch.equal(got_o[:, :, :4], torch.zeros_like(got_o[:, :, :4]))
    assert torch.equal(got_l[:, :, :4], torch.zeros_like(got_l[:, :, :4]))
    assert bool((got_l[:, :, 4:] != 0).all())


@pytest.mark.parametrize("group", [1, 4])
def test_reference_attention_matches_jax(group):
    """The repeat-based oracle: query head h reads K/V head h // group
    (repeat_interleave semantics) on both sides."""
    q, k, v = _inputs(5, 2, 12, 4, 4 // group, 8)
    want = jring.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True)
    got = tfa.reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=True)
    _close(got, want)


@pytest.mark.parametrize("tq", [1, 3])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_flash_decode_matches_jax_pallas(tq, group):
    """Port decode vs the JAX decode kernel (interpret mode): ragged
    lengths including 1 and S, Tq 1 and 3 (causal within the Tq tail; a
    row of length 1 at Tq 3 has fully masked query slots)."""
    b, s, h, d = 4, 32, 4, 16
    q, k, v = _inputs(20 + tq, b, tq, h, h // group, d, tk=s)
    lengths = np.array([1, 17, 32, 9], np.int32)
    want = jfa.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(lengths), use_pallas=True)
    got = tfa.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(lengths))
    _close(got, want)
    want_ref = jfa._decode_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(lengths))
    _close(got, want_ref)


def test_flash_decode_ignores_garbage_past_length():
    """Positions >= length contribute exactly nothing: poisoning them
    leaves the port's output bit-equal (the reference's masking test)."""
    rng = np.random.default_rng(1)
    b, s, h, d = 2, 16, 2, 8
    q = torch.from_numpy(rng.normal(size=(b, 1, h, d)).astype(np.float32))
    k = rng.normal(size=(b, s, h, d)).astype(np.float32)
    v = rng.normal(size=(b, s, h, d)).astype(np.float32)
    lengths = torch.tensor([5, 12], dtype=torch.int32)
    clean = tfa.flash_decode(q, torch.from_numpy(k.copy()),
                             torch.from_numpy(v.copy()), lengths)
    k[0, 5:], v[0, 5:] = 1e30, -1e30
    k[1, 12:], v[1, 12:] = 1e30, -1e30
    dirty = tfa.flash_decode(q, torch.from_numpy(k), torch.from_numpy(v),
                             lengths)
    assert torch.equal(clean, dirty)


def test_cpu_path_never_counts_kernel_launches():
    """The launch counters count kernel launches only: the CPU (plain)
    path leaves them untouched."""
    tfa.reset_launch_counts()
    q, k, v = _inputs(2, 1, 8, 2, 1, 8)
    qt = torch.from_numpy(q).requires_grad_(True)
    tfa.flash_attention(qt, torch.from_numpy(k),
                        torch.from_numpy(v)).sum().backward()
    tfa.flash_decode(torch.from_numpy(q[:, :1]), torch.from_numpy(k),
                     torch.from_numpy(v), torch.tensor([8], dtype=torch.int32))
    tfa.merge_kv_block(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), tfa.init_carry(1, 2, 8, 8),
                       (0, 0), causal=True)
    assert tfa.launch_counts() == {"flash_fwd": 0, "flash_decode": 0,
                                   "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                                   "flash_merge": 0}
