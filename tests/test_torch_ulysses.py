"""The port's Ulysses sequence parallelism (``ulysses.py``, ``--sp-mode
ulysses``) against the JAX package's ``ulysses_attention`` on its 8-device
CPU mesh (data 2 x seq 4, ``make_lm_mesh(8, seq_parallel=4)``), case for
case as ``tests/test_ulysses.py`` holds the reference: the forward, the
gradients, equality with the ring, GQA, the two divisibility refusals,
the transformer's loss against one shard (and its step against the JAX
step), and descent. The port holds the 4 shards in one process (one
kernel call over their heads);
inputs come from numpy with a seed, f32 throughout, each comparison with
its tolerance stated.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_operator.payload import data as jdata
from tpu_operator.payload import ring_attention as jring
from tpu_operator.payload import transformer as jtransformer
from tpu_operator.payload import ulysses as julysses
from tpu_operator_torch.payload import optimizers
from tpu_operator_torch.payload import ring_attention as ring
from tpu_operator_torch.payload import transformer
from tpu_operator_torch.payload import ulysses
from tpu_operator_torch.payload import weights

N = 4


@pytest.fixture(scope="module")
def mesh():
    return jtransformer.make_lm_mesh(8, seq_parallel=N)  # (data=2, seq=4)


def qkv(seed, b=2, t=64, h=4, d=8):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, t, h, d)).astype(np.float32)
                 for _ in range(3))


def _port(q, k, v, causal=True):
    return ulysses.ulysses_attention(q, k, v, ring.SeqRing(N), causal=causal)


def _grads(fn, q, k, v):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    (fn(*ts).float() ** 2).sum().backward()
    return [t.grad.numpy() for t in ts]


def _jax_grads(mesh, q, k, v):
    def loss(a, b, c):
        out = julysses.ulysses_attention(a, b, c, mesh, causal=True)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    return jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                               for x in (q, k, v)))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ulysses_matches_jax_forward(mesh, causal):
    """Both sides: f32 attention over the whole sequence on each shard's
    heads; 1e-5, the reference test's bound against its oracle."""
    q, k, v = qkv(0)
    want = julysses.ulysses_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                      mesh, causal=causal)
    got = _port(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_ulysses_matches_jax_gradients(mesh):
    """Gradients of sum(O^2): 1e-4, the reference test's bound."""
    q, k, v = qkv(1)
    for got, want in zip(_grads(_port, q, k, v), _jax_grads(mesh, q, k, v)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


def test_ulysses_matches_ring():
    """The port's two SP strategies on the same 4-shard layout: f32, the
    same attention in another summation order; 1e-5 (and the JAX ring
    agrees within the same bound)."""
    q, k, v = qkv(2, t=32)
    ts = [torch.from_numpy(x) for x in (q, k, v)]
    a = _port(*ts)
    b = ring.ring_attention(*ts, ring.SeqRing(N), causal=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
    jmesh = jtransformer.make_lm_mesh(8, seq_parallel=N)
    c = jring.ring_attention(*(jnp.asarray(x) for x in (q, k, v)), jmesh,
                             causal=True)
    np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=1e-5,
                               rtol=1e-5)


def test_ulysses_rejects_indivisible_heads():
    q, k, v = (torch.from_numpy(x) for x in qkv(3, h=2))
    with pytest.raises(ValueError, match="divisible"):
        _port(q, k, v)


def test_ulysses_gqa_matches_jax(mesh):
    """8 query heads, 4 K/V heads over 4 shards (one K/V head a shard):
    forward and gradients against the JAX ulysses; the K/V gradients come
    back at the K/V head count."""
    q = qkv(4, h=8)[0]
    _, k, v = qkv(5, h=4)
    want = julysses.ulysses_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                      mesh, causal=True)
    got = _port(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    grads = _grads(_port, q, k, v)
    assert grads[1].shape == k.shape
    for g, w in zip(grads, _jax_grads(mesh, q, k, v)):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=1e-4)


def test_ulysses_rejects_indivisible_kv_heads():
    q = qkv(6, h=4)[0]
    _, k, v = qkv(7, h=2)  # 2 kv heads, 4 seq shards
    with pytest.raises(ValueError, match="kv_heads"):
        _port(*(torch.from_numpy(x) for x in (q, k, v)))
    with pytest.raises(ValueError, match="kv_heads"):
        transformer.build(transformer.parse_args(
            ["--heads", "4", "--kv-heads", "2", "--seq-parallel", "4",
             "--sp-mode", "ulysses", "--device", "cpu"]))


ARGV = ["--batch", "4", "--seq-len", "64", "--dim", "32", "--heads", "4",
        "--layers", "2", "--log-every", "0", "--checkpoint-dir", "",
        "--profile-dir", ""]


def test_transformer_ulysses_matches_single_shard_loss():
    """Same seeded params, same batch: --seq-parallel 4 --sp-mode ulysses
    against --seq-parallel 1 in the port. The same f32 attention in
    another summation order; bf16 logits can round apart by one ulp here
    and there, which moves the mean over 252 targets by far less than
    1e-3 (the reference's test holds 2e-2); a wrong shard, target or count
    moves it by O(0.1)."""
    cpu = ["--device", "cpu"]
    one = transformer.build(transformer.parse_args(ARGV + cpu))
    uly = transformer.build(transformer.parse_args(
        ARGV + cpu + ["--seq-parallel", "4", "--sp-mode", "ulysses"]))
    (tokens,) = next(one.batches)
    loss1 = float(one.step(torch.from_numpy(tokens))["loss"])
    loss4 = float(uly.step(torch.from_numpy(tokens))["loss"])
    assert abs(loss1 - loss4) < 1e-3


def test_transformer_ulysses_step_matches_jax(mesh):
    """Three steps of the JAX ulysses train step on its (data 2, seq 4)
    mesh and the port's, from the same f32 params on the same batches:
    losses within 5e-3 a step, the bound of tests/test_torch_sp_train.py
    (bf16 logits differ by up to 2^-5 between the frameworks)."""
    args = jtransformer.parse_args(ARGV + ["--seq-parallel", "4",
                                           "--sp-mode", "ulysses"])
    _m, _model, state, jstep, jbatches = jtransformer.build(args, mesh=mesh)
    params = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                    state.params)
    targs = transformer.parse_args(ARGV + ["--seq-parallel", "4",
                                           "--sp-mode", "ulysses"])
    model = weights.from_flax(params, heads=4, param_dtype=torch.float32)
    model.requires_grad_(True)
    optimizer = optimizers.from_args(targs)
    tstep = transformer.make_lm_train_step(
        model, optimizer, optimizer.init(list(model.parameters())),
        mesh=transformer.make_lm_mesh(1, 0, N), sp_mode="ulysses")
    spec = jtransformer.lm_token_spec(mesh)
    jl, tl = [], []
    for _ in range(3):
        (jb,) = next(jbatches)
        state, metrics = jstep(state, *jdata.put_global_batch(mesh, jb,
                                                              spec=spec))
        jl.append(float(jax.device_get(metrics["loss"])))
        tl.append(float(tstep(torch.from_numpy(jb))["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=5e-3)


def test_transformer_ulysses_loss_descends():
    built = transformer.build(transformer.parse_args([
        "--batch", "8", "--seq-len", "64", "--dim", "64", "--heads", "4",
        "--layers", "2", "--seq-parallel", "4", "--sp-mode", "ulysses",
        "--log-every", "0", "--lr", "1e-2", "--device", "cpu",
        "--checkpoint-dir", "", "--profile-dir", ""]))
    losses = []
    for _ in range(30):
        (tokens,) = next(built.batches)
        losses.append(float(built.step(torch.from_numpy(tokens))["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.7, losses[::5]
