"""The port's TransformerLM (tpu_operator_torch.payload.models), loaded
through ``weights.from_flax`` from the JAX package's own init, against the
reference decode mirror ``models.lm_decode_apply`` on the CPU.

Both sides compute in bf16 (bf16 weights, bf16 residual stream, f32
LayerNorm) and attend with their f32 reference attention. They differ in
where XLA and PyTorch round inside a bf16 matmul, the LayerNorm variance
formula and the GELU's internal precision, so logits agree to bf16
resolution, not bit for bit: tolerance 2^-4 absolute on logits of
magnitude below 4 (bf16's ulp in [2, 4) is 2^-6, so four ulps of drift
through 2 layers; the largest difference seen is 2^-5).
"""

import argparse

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tpu_operator.payload import models
from tpu_operator.payload import ring_attention as jring
from tpu_operator.payload import train
from tpu_operator.payload import transformer
from tpu_operator_torch.payload import flash_attention as tfa
from tpu_operator_torch.payload import weights
from tpu_operator_torch.payload.models import DecoderBlock, TransformerLM

LOGIT_TOL = 2.0 ** -4
WINDOW, NEW, VOCAB, DIM, HEADS = 16, 4, 32, 16, 2


def jax_params(kv_heads, layers=2, seed=0):
    """(model, params) on the serve payload's build path (the fixture of
    tests/test_kvcache.py)."""
    shim = argparse.Namespace(
        vocab=VOCAB, dim=DIM, heads=HEADS, kv_heads=kv_heads, layers=layers,
        seq_len=WINDOW + NEW, seq_parallel=1, tensor_parallel=1,
        split_qkv="auto", sp_mode="ring", sp_layout="contiguous",
        remat=False)
    mesh = train.make_mesh(axis_names=("data", "model"))
    model = transformer._build_model(shim, mesh)
    sample = jnp.zeros((2, WINDOW), jnp.int32)
    state = train.create_train_state(model, jax.random.key(seed), sample,
                                     optax.adam(1e-3))
    return model, jax.tree_util.tree_map(np.asarray, state.params)


def tokens_of(seed, length=WINDOW, batch=2):
    rng = np.random.default_rng(seed)
    return rng.integers(0, VOCAB, size=(batch, length)).astype(np.int32)


@pytest.mark.parametrize("kv_heads", [0, 1])
def test_from_flax_logits_match_lm_decode_apply(kv_heads):
    """Fused qkv (kv_heads 0, MHA) and split q/k/v (kv_heads 1, GQA):
    port logits vs the reference mirror at the same positions."""
    _model, params = jax_params(kv_heads)
    tm = weights.from_flax(params, heads=HEADS)
    assert tm.blocks[0].split_qkv == (kv_heads != 0)
    tokens = tokens_of(kv_heads)
    positions = np.tile(np.arange(WINDOW, dtype=np.int32), (2, 1))
    want = models.lm_decode_apply(
        params, jnp.asarray(tokens), jnp.asarray(positions),
        lambda _i: lambda q, k, v: jring.reference_attention(q, k, v, True),
        vocab=VOCAB, dim=DIM, heads=HEADS, kv_heads=kv_heads, layers=2,
        max_seq=WINDOW + NEW)
    got = tm(torch.from_numpy(tokens), torch.from_numpy(positions),
             lambda _i: lambda q, k, v: tfa.flash_attention(q, k, v))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=LOGIT_TOL)
    # The greedy tokens agree wherever the reference's top-1 margin
    # exceeds twice the tolerance.
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * LOGIT_TOL
    assert clear.any()
    np.testing.assert_array_equal(got.float().numpy().argmax(-1)[clear],
                                  want.argmax(-1)[clear])


def test_from_flax_matches_flax_module_forward():
    """The port against the flax TransformerLM itself (default positions),
    the module the reference's decode mirror is bit-equal to."""
    model, params = jax_params(1)
    tm = weights.from_flax(params, heads=HEADS)
    tokens = tokens_of(9)
    want = np.asarray(model.apply({"params": params},
                                  jnp.asarray(tokens)).astype(jnp.float32))
    got = tm(torch.from_numpy(tokens), None,
             lambda _i: lambda q, k, v: tfa.flash_attention(q, k, v))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=LOGIT_TOL)


def test_init_weights_is_seeded_and_finite():
    """The seeded init draws from the given generator: same seed, same
    weights; another seed, other weights; logits finite."""
    def build(seed):
        g = torch.Generator().manual_seed(seed)
        return TransformerLM(VOCAB, DIM, HEADS, 2, WINDOW,
                             kv_heads=1).init_weights(g)

    a, b, c = build(0), build(0), build(1)
    for (name, pa), (_n, pb), (_m, pc) in zip(a.state_dict().items(),
                                              b.state_dict().items(),
                                              c.state_dict().items()):
        assert torch.equal(pa, pb), name
        if "ln" not in name and "bias" not in name:
            assert not torch.equal(pa, pc), name
    logits = a(torch.from_numpy(tokens_of(0)), None,
               lambda _i: lambda q, k, v: tfa.flash_attention(q, k, v))
    assert logits.shape == (2, WINDOW, VOCAB)
    assert bool(torch.isfinite(logits.float()).all())


def test_gqa_requires_split_projections_and_divisible_heads():
    with pytest.raises(ValueError):
        DecoderBlock(DIM, HEADS, kv_heads=1, split_qkv=False)
    with pytest.raises(ValueError):
        DecoderBlock(DIM, 4, kv_heads=3)
