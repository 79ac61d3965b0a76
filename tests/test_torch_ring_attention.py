"""The port's sequence-parallel path (tpu_operator_torch.payload:
ring_attention, transformer --seq-parallel) against the JAX package's, on
the CPU, with the whole ring of N = 4 shards in one process (P = 1).

The JAX side runs on its 8-device CPU mesh (data 2 x seq 4,
``make_lm_mesh(8, seq_parallel=4)``), as tests/test_ring_attention.py
does; inputs come from numpy with a seed, and each comparison states its
tolerance. The SP training step is held against the JAX package's in
tests/test_torch_sp_train.py, the multi-process runs (P = 2 over gloo)
in tests/test_torch_ring_multiprocess.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_operator.payload import ring_attention as jring
from tpu_operator.payload import transformer as jtransformer
from tpu_operator_torch.payload import flash_attention as fa
from tpu_operator_torch.payload import ring_attention as ring

N = 4


@pytest.fixture(scope="module")
def mesh():
    return jtransformer.make_lm_mesh(8, seq_parallel=N)  # (data=2, seq=4)


def _qkv(seed, b=2, t=64, h=4, kvh=2, d=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, t, hh, d)).astype(np.float32)
                 for hh in (h, kvh, kvh, h))


def test_stripe_permutation_matches_reference():
    for t, n in ((16, 4), (64, 4), (96, 8)):
        perm, inv = ring.stripe_permutation(t, n)
        want_perm, want_inv = jring.stripe_permutation(t, n)
        np.testing.assert_array_equal(perm, want_perm)
        np.testing.assert_array_equal(inv, want_inv)
    with pytest.raises(ValueError):
        ring.stripe_permutation(10, 4)


@pytest.mark.parametrize("layout", ["contiguous", "striped"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_matches_jax_ring(mesh, causal, layout):
    """Forward and the q/k/v gradients of a random cotangent, both sides
    on the same (striped or natural) slab, GQA group 2. f32 throughout:
    the two compute the same math in another summation order, so the
    output is held to 2e-5 and the gradients to 1e-4, what
    tests/test_ring_attention.py holds the JAX ring to against dense
    attention (gradients reach ~10)."""
    q, k, v, cot = _qkv(1 if causal else 2)
    stripe = layout == "striped"
    perm = ring.stripe_permutation(64, N)[0] if stripe else np.arange(64)
    q, k, v, cot = (x[:, perm] for x in (q, k, v, cot))

    def jloss(q, k, v):
        out = jring.ring_attention(q, k, v, mesh, causal=causal,
                                   stripe=stripe)
        return jnp.sum(out * cot), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = ring.ring_attention(*ts, ring.SeqRing(N), causal=causal,
                              stripe=stripe)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=2e-5, atol=2e-5)
    for mine, theirs in zip(ts, jgrads):
        np.testing.assert_allclose(mine.grad.numpy(), np.asarray(theirs),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", ["contiguous", "striped"])
def test_causal_first_position_attends_only_itself(layout):
    """Position 0's output is exactly its own V row (query head h reads
    K/V head h // group): no later key leaks in across ring steps."""
    q, k, v, _ = _qkv(3)
    stripe = layout == "striped"
    perm, inv = ring.stripe_permutation(64, N) if stripe \
        else (np.arange(64), np.arange(64))
    out = ring.ring_attention(*(torch.from_numpy(x[:, perm])
                                for x in (q, k, v)),
                              ring.SeqRing(N), causal=True,
                              stripe=stripe)[:, torch.from_numpy(inv)]
    want = np.repeat(v[:, 0], 2, axis=1)  # [B, H, D]
    np.testing.assert_allclose(out[:, 0].numpy(), want, rtol=1e-6,
                               atol=1e-6)


def test_ring_matches_the_single_shard_path():
    """One shard is flash_attention's plain path; four shards agree with it
    to f32 summation order (2e-5)."""
    q, k, v, _ = _qkv(4)
    ts = [torch.from_numpy(x) for x in (q, k, v)]
    one = ring.ring_attention(*ts, ring.SeqRing(1), causal=True)
    four = ring.ring_attention(*ts, ring.SeqRing(N), causal=True)
    dense = fa.flash_attention(*ts, causal=True)
    np.testing.assert_allclose(one.numpy(), dense.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(four.numpy(), dense.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_seq_ring_rotation_and_layout():
    r = ring.SeqRing(8, ranks=(4, 5), index=1)
    assert (r.shards, r.procs, r.local) == (8, 2, 4)
    assert list(r.shard_ids()) == [4, 5, 6, 7]
    one = ring.SeqRing(3)
    blocks = [(torch.tensor([i]),) for i in range(3)]
    assert [int(b[0]) for b in one.rotate(blocks)] == [2, 0, 1]
    assert ring.ring_offsets(2, 1, 4, 16, False) == (32, 16, 1)
    assert ring.ring_offsets(2, 1, 4, 16, True) == (2, 1, 4)
    with pytest.raises(ValueError):
        ring.SeqRing(3, ranks=(0, 1))
