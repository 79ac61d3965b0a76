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


@pytest.mark.parametrize("tq", [1, 3, 4])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_flash_decode_matches_jax_pallas(tq, group):
    """Port decode vs the JAX decode kernel (interpret mode): ragged
    lengths including 0 (O = 0), 1 and S, Tq 1, 3 and 4 (causal within the
    Tq tail; a row of length 1 at Tq 3 has fully masked query slots;
    group 4 x Tq 4 is the kernel's most query rows, 16)."""
    b, s, h, d = 5, 32, 4, 16
    q, k, v = _inputs(20 + tq, b, tq, h, h // group, d, tk=s)
    lengths = np.array([1, 17, 32, 9, 0], np.int32)
    want = jfa.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(lengths), use_pallas=True)
    got = tfa.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(lengths))
    _close(got, want)
    want_ref = jfa._decode_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(lengths))
    _close(got, want_ref)


def _decode_kernel_args(**over):
    """Arguments the decode kernel takes (bf16, head dim 128, group 4,
    int32 lengths, contiguous) except for ``over``; on the CPU, so the
    wrapper must refuse them before any launch whatever else is right."""
    b, tq, s, h, kvh, d = 2, 1, 64, 8, 2, 128
    args = {"q": torch.zeros(b, tq, h, d, dtype=torch.bfloat16),
            "k": torch.zeros(b, s, kvh, d, dtype=torch.bfloat16),
            "v": torch.zeros(b, s, kvh, d, dtype=torch.bfloat16),
            "lengths": torch.full((b,), s, dtype=torch.int32)}
    args.update(over)
    return args


@pytest.mark.parametrize("over,why", [
    ({}, "not CUDA"),  # right in every way but the device
    ({"q": torch.zeros(2, 1, 8, 128)}, "bfloat16"),
    ({"lengths": torch.full((2,), 64, dtype=torch.int64)}, "int32"),
    ({"q": torch.zeros(2, 1, 34, 128, dtype=torch.bfloat16)},
     "16 query rows"),  # group 17: one query slot is 17 rows
    ({"k": torch.zeros(2, 64, 3, 128, dtype=torch.bfloat16),
      "v": torch.zeros(2, 64, 3, 128, dtype=torch.bfloat16)}, "multiple"),
], ids=["cpu", "f32", "lengths_int64", "group_17", "kv_heads"])
def test_decode_kernel_wrapper_refuses_what_the_kernel_cannot_take(over, why):
    tfa.reset_launch_counts()
    with pytest.raises(ValueError, match=why):
        tfa._flash_decode_cuda(**_decode_kernel_args(**over))
    assert tfa.launch_counts()["flash_decode"] == 0
    assert not tfa._DECODE_COUNTERS


@pytest.mark.parametrize("tq,panels", [(5, [(0, 4), (4, 1)]),
                                       (8, [(0, 4), (4, 4)])],
                         ids=["tq5", "tq8"])
def test_decode_panels_give_the_whole_tq_decode(tq, panels):
    """The decode kernel takes at most 16 query rows (group x Tq) a launch,
    so its wrapper splits Tq into panels of 16 // group slots
    (``_decode_by_panels``). Applied to the plain decode, the panels give
    the whole-Tq result bit-equal (every query row is computed alone, from
    the same keys), at group 4 with lengths 0, 3 (< Tq: slots before
    position 0 see no key) and S; and the whole-Tq result matches the JAX
    reference at TOL."""
    b, s, h, kvh, d = 5, 32, 8, 2, 16
    assert tfa._decode_panels(tq, h // kvh) == panels
    q, k, v = _inputs(40 + tq, b, tq, h, kvh, d, tk=s)
    lengths = np.array([0, 3, s, 17, 9], np.int32)
    args = [torch.from_numpy(x) for x in (q, k, v, lengths)]
    calls = []

    def attend(*a):
        calls.append(a[0].shape[1])
        return tfa._decode_ref(*a)

    got = tfa._decode_by_panels(attend, *args)
    assert calls == [n for _a, n in panels]
    want = tfa._decode_ref(*args)
    assert torch.equal(got, want)
    assert not bool(got[0].any())  # length 0: every slot sees no key
    _close(want, jfa._decode_ref(*(jnp.asarray(x)
                                   for x in (q, k, v, lengths))))


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
