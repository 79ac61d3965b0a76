"""The port's adam8 (optimizers.Adam8: int8 block-quantized moments with
stochastic rounding) against the JAX package's ``optimizers.adam8``, and
against f32 adam, on the CPU. Inputs come from numpy with a seed; each
comparison states its tolerance."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tpu_operator.payload import optimizers as joptimizers
from tpu_operator_torch.payload import optimizers

BLOCK = optimizers.BLOCK


def _values(seed, shape, spread=4):
    """Values over ``spread`` orders of magnitude, both signs."""
    rng = np.random.default_rng(seed)
    mags = 10.0 ** rng.uniform(-spread, 0, size=shape)
    return (mags * rng.choice([-1.0, 1.0], size=shape)).astype(np.float32)


@pytest.mark.parametrize("sqrt_domain", [False, True], ids=["m", "v"])
@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
def test_quantize_and_dequantize_are_bit_equal_to_the_reference(
        monkeypatch, sqrt_domain, rounding):
    """The same f32 blocks through the reference's _quantize/_dequantize
    and the port's: the same IEEE operations (abs-max, divide, round half
    to even or floor(x + u), clip), so q, scale and the dequantized values
    are bit-equal. The stochastic case injects one array of uniforms on
    both sides (the reference's draw is patched)."""
    x = _values(1, (3, 2, BLOCK))
    if sqrt_domain:
        x = np.abs(x)
    x[1, 1] = 0.0  # an all-zero block: the 1e-12 scale floor
    u = np.random.default_rng(2).random(x.shape).astype(np.float32)
    key = None
    if rounding == "stochastic":
        key = jax.random.key(0)
        monkeypatch.setattr(jax.random, "uniform",
                            lambda _key, shape, dtype: jnp.asarray(u))
    want = joptimizers._quantize(jnp.asarray(x), key, sqrt_domain)
    got = optimizers._quantize(torch.from_numpy(x),
                               torch.from_numpy(u) if key is not None
                               else None, sqrt_domain)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(
        optimizers._dequantize(got, sqrt_domain).numpy(),
        np.asarray(joptimizers._dequantize(want, sqrt_domain)))


def _numpy_step(p, g, mq, ms, vq, vs, count, um, uv, lr, b1=0.9, b2=0.999,
                eps=1e-8):
    """One adam8 update in numpy f32, written from the reference's
    ``update`` (optimizers.py:192-230), on [nb, BLOCK] blocks."""
    f = np.float32
    m = f(b1) * (mq.astype(f) * ms[:, None]) + f(1 - b1) * g
    vr = vq.astype(f) * vs[:, None]
    v = f(b2) * (vr * vr) + f(1 - b2) * g * g
    bc1 = f(1) - f(b1) ** f(count)
    bc2 = f(1) - f(b2) ** f(count)
    v_floor = f(b2) * (f(0.5) * vs[:, None]) ** 2
    upd = f(-lr) * (m / bc1) / (np.sqrt(np.maximum(v, v_floor) / bc2)
                                + f(eps))

    def quant(x, u, sqrt):
        x = np.sqrt(x) if sqrt else x
        scale = np.maximum(np.abs(x).max(-1, keepdims=True), f(1e-12)) / f(127)
        q = np.clip(np.floor(x / scale + u), -127, 127).astype(np.int8)
        return q, scale[:, 0]

    return p + upd, quant(m, um, False), quant(v, uv, True)


def test_update_with_injected_draws_equals_numpy():
    """Three steps of the port's adam8 on one [2, BLOCK] parameter with
    the uniforms injected, against the update recomputed in numpy from
    the reference's formulas: params within 1 f32 ulp of the step (the
    powers in the bias correction may round apart), the int8 codes equal
    and the scales within 1 ulp."""
    rng = np.random.default_rng(3)
    p0 = rng.normal(size=(2, BLOCK)).astype(np.float32)
    draws = {}

    def uniform(shape, device, seed, count, leaf, moment):
        u = np.random.default_rng([seed, count, leaf, moment]).random(
            shape).astype(np.float32)
        draws[(count, moment)] = u
        return torch.from_numpy(u)

    opt = optimizers.Adam8(1e-2, seed=9, uniform=uniform)
    p = torch.from_numpy(p0.copy())
    state = opt.init([p])
    np_p = p0.copy()
    mq, ms = np.zeros((2, BLOCK), np.int8), np.full(2, 1e-12 / 127, np.float32)
    vq, vs = mq.copy(), ms.copy()
    for count in (1, 2, 3):
        g = (rng.normal(size=(2, BLOCK)) * 10.0 ** rng.uniform(
            -3, 0, size=(2, BLOCK))).astype(np.float32)
        p.grad = torch.from_numpy(g)
        opt.step([p], state)
        np_p, (mq, ms), (vq, vs) = _numpy_step(
            np_p, g, mq, ms, vq, vs, count,
            draws[(count, 0)].reshape(2, BLOCK),
            draws[(count, 1)].reshape(2, BLOCK), 1e-2)
        np.testing.assert_allclose(p.numpy(), np_p, rtol=0,
                                   atol=1.2e-7 * np.abs(np_p).max())
        # The state holds [2, 1, BLOCK] codes and [2, 1] scales (one block
        # per row); the numpy side works on [2, BLOCK] rows.
        np.testing.assert_array_equal(state.m[0].q.numpy()[:, 0], mq)
        np.testing.assert_array_equal(state.v[0].q.numpy()[:, 0], vq)
        np.testing.assert_allclose(state.m[0].scale.numpy()[:, 0], ms,
                                   rtol=1.2e-7)
        np.testing.assert_allclose(state.v[0].scale.numpy()[:, 0], vs,
                                   rtol=1.2e-7)
    assert state.count == 3


def _regression_run(make, steps=60):
    """The reference's convex regression (tests/test_optimizers.py:67):
    64 x 32 least squares, lr 0.1, losses of every step."""
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
    w = torch.zeros(32, requires_grad=True)
    bias = torch.zeros(1, requires_grad=True)
    opt = make()
    state = opt.init([w, bias])
    losses = []
    for _ in range(steps):
        loss = ((a @ w + bias[0] - b) ** 2).mean()
        w.grad = bias.grad = None
        loss.backward()
        opt.step([w, bias], state)
        losses.append(float(loss.detach()))
    return np.asarray(losses)


def _jax_regression_run(tx, steps=60):
    rng = np.random.default_rng(4)
    a = jnp.asarray(rng.normal(size=(64, 32)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(64,)), jnp.float32)
    p = {"w": jnp.zeros((32,), jnp.float32),
         "bias": jnp.zeros((1,), jnp.float32)}

    def loss_fn(p):
        return jnp.mean((a @ p["w"] + p["bias"][0] - b) ** 2)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(loss_fn)(p)
        upd, s = tx.update(g, s, p)
        return optax.apply_updates(p, upd), s, loss

    state = tx.init(p)
    losses = []
    for _ in range(steps):
        p, state, loss = step(p, state)
        losses.append(float(loss))
    return np.asarray(losses)


def test_trajectory_tracks_adam_and_the_reference_adam8():
    """60 steps of the convex regression: the port's adam8 tracks the
    port's f32 adam and the reference's adam8 within the reference's own
    drop-in bound (every step within 5% relative, 5e-3 absolute). The
    draws differ between the frameworks, so the two adam8 curves are two
    samples of the same rounding noise; the port's f32 adam equals
    optax.adam to 2 ulps (tests/test_torch_train.py)."""
    got = _regression_run(lambda: optimizers.adam8(1e-1, seed=7))
    adam = _regression_run(lambda: optimizers.adam(1e-1))
    np.testing.assert_allclose(got, adam, rtol=5e-2, atol=5e-3)
    theirs = _jax_regression_run(joptimizers.adam8(1e-1, seed=7))
    np.testing.assert_allclose(got, theirs, rtol=5e-2, atol=5e-3)
    np.testing.assert_allclose(adam, _jax_regression_run(optax.adam(1e-1)),
                               rtol=1e-4, atol=1e-6)
    assert got[-1] < 0.5 * got[0]  # 0.954 -> 0.387, the least-squares floor


@pytest.mark.parametrize("shape", [(7,), (3, 300), (2, 3, 257), (1,), (256,)],
                         ids=str)
def test_non_aligned_shapes(shape):
    """Blocks run along the last axis, zero-padded to a multiple of 256:
    the state has [..., ceil(n / 256), 256] codes and [..., nb] scales,
    the update comes back in the param's shape, and the padding never
    leaks into it (a param of ones with a constant gradient moves every
    element by the same step, as adam's first step is +-lr)."""
    p = torch.ones(shape)
    opt = optimizers.adam8(1e-2)
    state = opt.init([p])
    nb = -(-shape[-1] // BLOCK)
    assert tuple(state.m[0].q.shape) == (*shape[:-1], nb, BLOCK)
    assert tuple(state.v[0].scale.shape) == (*shape[:-1], nb)
    np.testing.assert_array_equal(
        state.m[0].scale.numpy(), np.full((*shape[:-1], nb),
                                          np.float32(1e-12) / 127))
    p.grad = torch.full(shape, 0.5)
    opt.step([p], state)
    assert p.shape == shape
    np.testing.assert_allclose(p.numpy(), 1 - 1e-2, rtol=1e-5)


def test_state_is_8_bit():
    """Both moments in int8 plus one f32 scale per 256 values: about 2.03
    bytes per param, against 8 for f32 adam (the 4x the reference
    claims)."""
    params = [torch.zeros(512, 256), torch.zeros(1000), torch.zeros(3, 7)]
    n = sum(p.numel() for p in params)
    state = optimizers.adam8(1e-3).init(params)
    adam = optimizers.adam(1e-3).init(params)
    adam_bytes = sum(t.numel() * t.element_size()
                     for t in adam.mu + adam.nu)
    assert adam_bytes == 8 * n
    blocks = 512 + 4 + 3
    nbytes = sum(t.numel() * t.element_size()
                 for t in state.state_dict().values() if t.dim())
    assert nbytes == 2 * BLOCK * blocks + 2 * 4 * blocks
    assert nbytes < adam_bytes / 3.5


def test_state_dict_round_trip_resumes_bit_equal():
    """Two steps, save the state_dict, two more; a fresh state loaded from
    the saved one takes the same two steps bit-equal: the draws depend on
    (seed, count, leaf, moment) only. A state of another shape, or of
    another optimizer, is refused before anything is copied."""
    rng = np.random.default_rng(6)
    grads = [[torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for s in ((4, 300), (9,))] for _ in range(4)]

    def run(params, opt, state, gs):
        for g in gs:
            for p, gi in zip(params, g):
                p.grad = gi
            opt.step(params, state)

    opt = optimizers.adam8(1e-2, seed=3)
    params = [torch.zeros(4, 300), torch.zeros(9)]
    state = opt.init(params)
    run(params, opt, state, grads[:2])
    saved = {k: v.clone() for k, v in state.state_dict().items()}
    saved_params = [p.clone() for p in params]
    run(params, opt, state, grads[2:])

    other = optimizers.adam8(1e-2, seed=99)  # the seed comes from the state
    params2 = [p.clone() for p in saved_params]
    state2 = other.init(params2)
    state2.load_state_dict(saved)
    assert (state2.count, state2.seed) == (2, 3)
    run(params2, other, state2, grads[2:])
    for a, b in zip(params, params2):
        assert torch.equal(a, b)
    for k, v in state.state_dict().items():
        assert torch.equal(v, state2.state_dict()[k]), k

    wrong = optimizers.adam8(1e-2).init([torch.zeros(5, 300), torch.zeros(9)])
    before = {k: v.clone() for k, v in wrong.state_dict().items()}
    with pytest.raises(ValueError, match="m.q.0"):
        wrong.load_state_dict(saved)
    for k, v in wrong.state_dict().items():
        assert torch.equal(v, before[k])
    with pytest.raises(ValueError, match="names differ"):
        optimizers.adam(1e-2).init(params).load_state_dict(saved)


def test_checkpoint_names_the_optimizer_and_refuses_a_change(tmp_path):
    """A step saved with adam8 records ``"optimizer": "adam8"`` and its
    int8 moments under their own names, and restores bit-equal; a restore
    of it into adam's state raises (its bytes verify intact, so nothing is
    quarantined) and leaves the live state as it was."""
    import json

    from tpu_operator_torch.payload import checkpoint

    params = {"w": torch.zeros(3, 300), "b": torch.zeros(5)}
    opt = optimizers.adam8(1e-2, seed=4)
    state = opt.init(list(params.values()))
    for p in params.values():
        p.grad = torch.ones_like(p)
    opt.step(list(params.values()), state)
    ck = checkpoint.Checkpointer(str(tmp_path))
    ck.save(1, checkpoint.TrainState(params, state))
    ck.close()
    with open(tmp_path / "1" / checkpoint.META_FILE) as f:
        meta = json.load(f)
    assert meta["optimizer"] == "adam8" and "adamMuDtype" not in meta
    assert meta["tensors"]["opt.pt"]["m.q.0"] == {"shape": [3, 2, 256],
                                                  "dtype": "int8"}

    fresh = {k: torch.full_like(v, 7.0) for k, v in params.items()}
    fresh_state = optimizers.adam8(1e-2).init(list(fresh.values()))
    _s, step = checkpoint.Checkpointer(str(tmp_path)).restore(
        checkpoint.TrainState(fresh, fresh_state))
    assert step == 1 and fresh_state.count == 1 and fresh_state.seed == 4
    for k, v in state.state_dict().items():
        assert torch.equal(fresh_state.state_dict()[k], v), k
    assert all(torch.equal(fresh[k], params[k]) for k in params)

    live = {k: torch.full_like(v, 7.0) for k, v in params.items()}
    adam_state = optimizers.adam(1e-2).init(list(live.values()))
    with pytest.raises(checkpoint.CheckpointError, match="adam8 state"):
        checkpoint.Checkpointer(str(tmp_path)).restore(
            checkpoint.TrainState(live, adam_state))
    assert all(float(v.min()) == 7.0 for v in live.values())
    assert adam_state.count == 0
    assert checkpoint.Checkpointer(str(tmp_path)).all_steps() == [1]
