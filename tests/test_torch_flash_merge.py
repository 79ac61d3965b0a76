"""Parity of the port's ring merge (tpu_operator_torch.payload.
flash_attention: ``merge_kv_block``) with the JAX package's, on the CPU.

The port's CPU path is the plain PyTorch version of the merge kernel
(``_merge_ref``); the JAX side runs the Pallas kernel ``_merge_pallas`` in
interpret mode, as tests/test_flash_attention.py does, and its plain
``_merge_ref``. The same numpy inputs (from a seed) feed all three, with a
live carry (from an earlier merge) so that seeding is tested too. Inputs
are f32, so the kernel's bf16 rounding of P is a no-op and every side
computes the same f32 math in another summation order: tolerance 2e-5,
the one tests/test_flash_attention.py holds the merge to (carry values
reach ~40 here, so this is a few f32 ulps of a sum of ~100 terms, far
below a dropped or misplaced key, which moves o by O(1)).

The Pallas kernel never loads a tile wholly in a row's future, so a row
that has seen no key yet carries other weight-1 sums of masked keys there
than the plain merges do (``finalize`` discards them): against it, o and l
are compared on the rows that have seen a key, and the set of those rows
must be the same.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_operator.payload import flash_attention as jfa
from tpu_operator.payload import ring_attention as jring
from tpu_operator_torch.payload import flash_attention as tfa

TOL = 2e-5
D = 32
H = 4


def _block(rng, b, t, heads):
    return rng.normal(size=(b, t, heads, D)).astype(np.float32)


def _live_carry(rng, b, tq, kvh):
    """A carry after one merge of a random block at (0, 0), causal: rows
    with finite m, real l and o, from numpy inputs."""
    q, k, v = _block(rng, b, tq, H), _block(rng, b, tq, kvh), \
        _block(rng, b, tq, kvh)
    carry = tfa.init_carry(b, H, tq, D)
    return tfa.merge_kv_block(*(torch.from_numpy(x) for x in (q, k, v)),
                              carry, (0, 0, 1), causal=True)


def _jax_t(x):
    """[B,T,H,D] numpy -> the reference's [B,H,T,D]."""
    return jnp.einsum("bthd->bhtd", jnp.asarray(x))


CASES = {
    # label: (Tq, Tk, offsets, causal)
    "contiguous_home": (64, 64, (64, 64, 1), True),
    "contiguous_earlier_block": (64, 64, (64, 0, 1), True),
    "wholly_future_block": (64, 64, (0, 64, 1), True),
    "striped_r_lt_kv": (64, 64, (1, 2, 4), True),
    "striped_r_gt_kv": (64, 64, (2, 1, 4), True),
    "ragged_tq_ne_tk": (64, 48, (16, 0, 1), True),
    "noncausal_ragged": (64, 48, (0, 0, 1), False),
}


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_merge_matches_jax_kernel_and_reference(case, group):
    tq, tk, offsets, causal = CASES[case]
    b, kvh = 2, H // group
    rng = np.random.default_rng(10 * list(CASES).index(case) + group)
    carry = _live_carry(rng, b, tq, kvh)
    q, k, v = _block(rng, b, tq, H), _block(rng, b, tk, kvh), \
        _block(rng, b, tk, kvh)
    got = tfa.merge_kv_block(*(torch.from_numpy(x) for x in (q, k, v)),
                             carry, offsets, causal=causal)
    jcarry = tuple(jnp.asarray(x.numpy()) for x in carry)
    joffs = jfa._normalize_offsets(jnp.asarray(offsets, jnp.int32))
    jq, jk, jv = _jax_t(q), _jax_t(k), _jax_t(v)
    want_ref = jfa._merge_ref(jq, jk, jv, *jcarry, joffs, causal)
    want_pallas = jfa._merge_pallas(jq, jk, jv, *jcarry, joffs, causal,
                                    interpret=True)
    for mine, theirs in zip(got, want_ref):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   rtol=TOL, atol=TOL)
    seen = np.asarray(want_pallas[2]) > jfa.NEG_INF / 2
    np.testing.assert_array_equal(got[2].numpy() > tfa.NEG_INF / 2, seen)
    for mine, theirs in zip(got, want_pallas):
        np.testing.assert_allclose(
            np.where(seen, mine.numpy(), 0.0),
            np.where(seen, np.asarray(theirs), 0.0), rtol=TOL, atol=TOL)
    if case == "wholly_future_block":
        # Every row of the live carry has seen a key: nothing changes.
        assert seen.all()
        for mine, before in zip(got, carry):
            np.testing.assert_array_equal(mine.numpy(), before.numpy())


def test_merge_leaves_the_given_carry_intact():
    rng = np.random.default_rng(3)
    carry = _live_carry(rng, 1, 16, 2)
    before = [x.clone() for x in carry]
    q, k, v = _block(rng, 1, 16, H), _block(rng, 1, 16, 2), \
        _block(rng, 1, 16, 2)
    tfa.merge_kv_block(*(torch.from_numpy(x) for x in (q, k, v)), carry,
                       (16, 0), causal=True)
    for x, y in zip(carry, before):
        assert torch.equal(x, y)


@pytest.mark.parametrize("group", [1, 2])
def test_two_merges_equal_one_over_the_concatenated_block(group):
    """Visiting the second half of K/V first, then the first half, equals
    one merge over the whole K/V, and finalises to dense causal attention
    (tests/test_flash_attention.py:35 for the reference)."""
    rng = np.random.default_rng(4 + group)
    b, t, kvh = 2, 64, H // group
    half = t // 2
    q, k, v = (torch.from_numpy(x) for x in (
        _block(rng, b, t, H), _block(rng, b, t, kvh), _block(rng, b, t, kvh)))
    carry = tfa.init_carry(b, H, t, D)
    two = tfa.merge_kv_block(q, k[:, half:], v[:, half:], carry, (0, half),
                             causal=True)
    two = tfa.merge_kv_block(q, k[:, :half], v[:, :half], two, (0, 0),
                             causal=True)
    one = tfa.merge_kv_block(q, k, v, carry, (0, 0), causal=True)
    for x, y in zip(two, one):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=TOL, atol=TOL)
    out = tfa.finalize(two, torch.float32).permute(0, 2, 1, 3)
    want = jring.reference_attention(*(jnp.asarray(x.numpy())
                                       for x in (q, k, v)), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_merge_kernel_wrapper_refuses_what_it_cannot_take():
    """The CUDA route raises on what the kernel does not take; it never
    falls back to the plain version."""
    q = torch.zeros(1, 8, 4, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16)
    carry = tfa.init_carry(1, 4, 8, 128)
    with pytest.raises(ValueError, match="not CUDA"):
        tfa._flash_merge_cuda(q, k, k, carry, (0, 0, 1), True)
    with pytest.raises(ValueError, match="bfloat16"):
        tfa._flash_merge_cuda(q.float(), k, k, carry, (0, 0, 1), True)
    with pytest.raises(ValueError, match="carry o"):
        tfa._flash_merge_cuda(q, k, k, (carry[0][:, :2], *carry[1:]),
                              (0, 0, 1), True)
    with pytest.raises(ValueError, match="overflow"):
        tfa._check_positions("flash_merge", (2 ** 31 - 8, 0, 1), 8, 8)
    assert tfa.LAUNCHES["flash_merge"] == 0
