"""The port's training slice (tpu_operator_torch.payload: transformer,
train, optimizers, data, heartbeat, bootstrap) against the JAX package's,
on the CPU.

Inputs come from numpy with a seed; each comparison states its tolerance.
The train-step parity test builds a tiny LM through the JAX
``transformer.build`` on a one-device CPU mesh, carries its f32 params
across with ``weights.from_flax``, and trains both on the same synthetic
batches (the discipline of tests/test_flagship_compute.py: same seed, same
stream, trajectories to tolerance).
"""

import argparse
import math
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tpu_operator.payload import data as jdata
from tpu_operator.payload import heartbeat as jheartbeat
from tpu_operator.payload import train as jtrain
from tpu_operator.payload import transformer as jtransformer
from tpu_operator_torch.payload import bootstrap
from tpu_operator_torch.payload import data
from tpu_operator_torch.payload import heartbeat
from tpu_operator_torch.payload import optimizers
from tpu_operator_torch.payload import train
from tpu_operator_torch.payload import transformer
from tpu_operator_torch.payload import weights

TINY = ["--dim", "64", "--layers", "2", "--heads", "4", "--kv-heads", "2",
        "--vocab", "256", "--seq-len", "64", "--batch", "4",
        "--grad-accum", "2", "--log-every", "0", "--seed", "0",
        "--checkpoint-dir", "", "--profile-dir", ""]


@pytest.fixture(autouse=True)
def _clean_drain_latch():
    bootstrap.reset_drain()
    yield
    bootstrap.reset_drain()


# --- loss ----------------------------------------------------------------------


def test_next_token_nll_matches_jax():
    """bf16 logits, f32 reduction on both sides: the same f32 math in a
    different summation order, so 1e-6 relative (a few f32 ulps of a loss
    near ln 256)."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 17, 256)).astype(np.float32) * 3
    tokens = rng.integers(0, 256, size=(3, 17)).astype(np.int32)
    want = jtrain.next_token_nll(jnp.asarray(logits, jnp.bfloat16),
                                 jnp.asarray(tokens))
    got = train.next_token_nll(torch.from_numpy(logits).bfloat16(),
                               torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    mask = rng.random(size=(3, 17)) < 0.7
    want_m = jtrain.next_token_nll_masked(
        jnp.asarray(logits, jnp.bfloat16), jnp.asarray(tokens),
        jnp.asarray(mask))
    got_m = train.next_token_nll_masked(
        torch.from_numpy(logits).bfloat16(), torch.from_numpy(tokens),
        torch.from_numpy(mask))
    np.testing.assert_allclose(float(got_m), float(want_m), rtol=1e-6)


# --- optimizer -----------------------------------------------------------------


@pytest.mark.parametrize("mu_dtype", ["f32", "bf16"])
def test_adam_matches_optax(mu_dtype):
    """Five steps of the same random gradients (magnitudes from 1e-6 to
    10) through optax.adam and the port's adam. The moments are the same
    roundings of the same f32 expressions, so they must be bit-equal; the
    params may differ by the last f32 bit of the bias correction
    (1 - b**count, a power XLA and numpy evaluate differently), so they
    are held to 2 f32 ulps of a unit param, 2.4e-7."""
    rng = np.random.default_rng(1)
    shapes = [(64, 32), (32,), (7, 3, 5)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jdtype = jnp.bfloat16 if mu_dtype == "bf16" else None
    tdtype = torch.bfloat16 if mu_dtype == "bf16" else None
    tx = optax.adam(3e-3, mu_dtype=jdtype)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = optimizers.adam(3e-3, mu_dtype=tdtype)
    tstate = opt.init(tp)
    for _ in range(5):
        grads = [(rng.normal(size=s) * 10.0 ** rng.uniform(-6, 1, size=s)
                  ).astype(np.float32) for s in shapes]
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate,
                                    jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g)
        opt.step(tp, tstate)
    adam_state = jstate[0]
    assert tstate.count == int(adam_state.count) == 5
    for mine, theirs in zip(tstate.mu, adam_state.mu):
        assert mine.dtype == (tdtype or torch.float32)
        np.testing.assert_array_equal(
            mine.float().numpy(), np.asarray(theirs.astype(jnp.float32)))
    for mine, theirs in zip(tstate.nu, adam_state.nu):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    for mine, theirs in zip(tp, jp):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   rtol=0, atol=2.4e-7)


def test_optimizer_flags():
    args = transformer.parse_args(["--adam-mu-dtype", "bf16"])
    opt = optimizers.from_args(args)
    assert opt.mu_dtype == torch.bfloat16 and opt.lr == 3e-3
    assert optimizers.from_args(transformer.parse_args([])).mu_dtype is None
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        optimizers.from_args(transformer.parse_args(["--optimizer", "adam8"]))


# --- data ----------------------------------------------------------------------


@pytest.mark.parametrize("vocab", [40, 256])
def test_synthetic_lm_is_byte_identical(vocab):
    """vocab 40 moves the multiplier off 5 (gcd(5, 40) = 5)."""
    ours = data.synthetic_lm(3, 4, 33, vocab=vocab)
    theirs = jdata.synthetic_lm(3, 4, 33, vocab=vocab)
    for _ in range(3):
        (a,), (b,) = next(ours), next(theirs)
        assert a.dtype == b.dtype == np.int32
        assert a.tobytes() == b.tobytes()


def test_token_file_lm_is_byte_identical(tmp_path):
    path = tmp_path / "tokens.npy"
    np.save(path, np.random.default_rng(2).integers(0, 50, size=1000))
    ours = data.token_file_lm(str(path), 5, 3, 16, vocab=50)
    theirs = jdata.token_file_lm(str(path), 5, 3, 16, vocab=50)
    for _ in range(25):  # past the first epoch's 20 batches
        assert next(ours)[0].tobytes() == next(theirs)[0].tobytes()
    with pytest.raises(ValueError):
        data.token_file_lm(str(path), 5, 3, 16, vocab=10)


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_device_prefetch_keeps_order(depth):
    batches = [(np.full((2, 3), i, np.int32),) for i in range(5)]
    out = list(data.device_prefetch(iter(batches), torch.device("cpu"),
                                    depth=depth))
    assert [int(t[0][0, 0]) for t in out] == list(range(5))
    assert out[0][0].dtype == torch.int32
    with pytest.raises(ValueError):
        next(data.device_prefetch(iter(batches), torch.device("cpu"), -1))


# --- train step parity ---------------------------------------------------------


def _jax_build():
    args = jtransformer.parse_args(TINY)
    mesh = jtransformer.make_lm_mesh(num_devices=1)
    mesh, _model, state, step, batches = jtransformer.build(args, mesh=mesh)
    return mesh, state, step, batches


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def _port_build(params, extra=()):
    """(model, step, batches): the port's training step over the flax
    params, the pieces ``transformer.build`` assembles around its own
    seeded init."""
    args = transformer.parse_args(TINY + list(extra))
    model = weights.from_flax(params, heads=4, param_dtype=torch.float32)
    model.requires_grad_(True)
    optimizer = optimizers.from_args(args)
    state = optimizer.init(list(model.parameters()))
    step = transformer.make_lm_train_step(model, optimizer, state,
                                          grad_accum=args.grad_accum)
    return model, step, data.lm_batches(args)


def test_train_step_matches_jax():
    """Five steps of the JAX train step and the port's from the same f32
    params on the same batches (grad accumulation 2).

    - Losses: both sides compute bf16 logits whose entries differ by up to
      2^-5 (tests/test_torch_models.py); the mean over 4 x 63 targets
      averages that out, and each adam step moves the two param sets
      apart a little more (below). Tolerance 5e-3 absolute per step: the
      largest gap seen is 6.5e-4, and a wrong gradient or update moves
      the loss by the ~0.1-0.2 a step changes it.
    - Params after step 1: adam's first step is lr * g / (|g| + eps),
      which is +-lr for any gradient element much larger than eps. So
      every element agrees to f32 rounding (1e-6) except where bf16
      noise flips the sign of a near-zero gradient element; there the two
      differ by 2 lr. Held: no element apart by more than 2 lr + 1e-6,
      and at most 1% of all elements apart by more than 1e-6 (the one
      flipped element of a 64-wide LayerNorm bias is the most seen in a
      leaf). A wrong gradient flips about half."""
    mesh, state, jstep, jbatches = _jax_build()
    params0 = _np_tree(state.params)
    model, tstep, tbatches = _port_build(params0)
    spec = jtransformer.lm_token_spec(mesh)
    lr = 3e-3
    jlosses, tlosses = [], []
    for i in range(5):
        (jb,), (tb,) = next(jbatches), next(tbatches)
        assert jb.tobytes() == tb.tobytes()
        state, metrics = jstep(state, *jdata.put_global_batch(
            mesh, jb, spec=spec))
        jlosses.append(float(jax.device_get(metrics["loss"])))
        tlosses.append(float(tstep(torch.from_numpy(tb))["loss"]))
        if i == 0:
            jparams = _np_tree(state.params)
            tparams = weights.to_flax(model)
            jleaves = jax.tree_util.tree_leaves_with_path(jparams)
            tleaves = dict(jax.tree_util.tree_leaves_with_path(tparams))
            assert len(jleaves) == len(tleaves)
            flipped = total = 0
            for path, want in jleaves:
                got = tleaves[path]
                assert got.shape == want.shape, path
                gap = np.abs(got - want)
                assert gap.max() <= 2 * lr + 1e-6, path
                flipped += int((gap > 1e-6).sum())
                total += gap.size
            assert flipped <= 0.01 * total
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=5e-3)
    assert tlosses[-1] < tlosses[0] - 0.25  # it learns the recurrence


def test_grad_accumulation_matches_one_batch():
    """--grad-accum 2 and 1 on the same batch: the same loss and the same
    gradient. The forward is row-independent, so the losses differ only
    in f32 summation order (held to 1e-5 relative). Each microbatch's
    weight gradient comes out of a bf16 matmul, rounded to bf16 (2^-9
    relative) before it is accumulated in f32, and one batch rounds the
    whole sum once, so the two gradients differ by at most 2^-8 relative
    per element: held to 2^-7 of each leaf's norm (2.5e-3 seen)."""
    _mesh, state, _step, _batches = _jax_build()
    params0 = _np_tree(state.params)
    one, step1, batches = _port_build(params0, ["--grad-accum", "1"])
    two, step2, _ = _port_build(params0, ["--grad-accum", "2"])
    (tb,) = next(batches)
    m1 = step1(torch.from_numpy(tb))
    m2 = step2(torch.from_numpy(tb))
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for (name, p1), p2 in zip(one.named_parameters(), two.parameters()):
        assert p1.grad.dtype == p2.grad.dtype == torch.float32
        gap = float((p1.grad - p2.grad).norm())
        assert gap <= 2.0 ** -7 * float(p1.grad.norm()), name


# --- the entry point -----------------------------------------------------------


def test_run_on_cpu_takes_steps_and_returns_metrics():
    args = transformer.parse_args(TINY + ["--steps", "3", "--device",
                                          "cpu"])
    metrics = transformer.run(bootstrap.process_info_from_env({}), args)
    assert set(metrics) == {"loss"}
    assert math.isfinite(metrics["loss"]) and 3 < metrics["loss"] < 7


def test_build_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = transformer.parse_args(TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.build(args)


@pytest.mark.parametrize("flag", [
    ["--seq-parallel", "2"], ["--tensor-parallel", "2"],
    ["--sp-mode", "ulysses"], ["--sp-layout", "striped"],
    ["--split-qkv", "on"], ["--fsdp"], ["--loss-chunk", "32"],
    ["--remat"], ["--checkpoint-dir", "/tmp/ckpt"],
    ["--profile-dir", "/tmp/prof"], ["--optimizer", "adam8"],
], ids=lambda f: f[0])
def test_unported_flags_raise(flag):
    args = transformer.parse_args(TINY + flag + ["--device", "cpu"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        transformer.build(args)


def test_prefetch_depth_convention():
    assert transformer.prefetch_depth(transformer.parse_args([])) == 2
    assert transformer.prefetch_depth(
        transformer.parse_args(["--prefetch-depth", "5"])) == 5
    with pytest.raises(ValueError):
        transformer.prefetch_depth(
            transformer.parse_args(["--prefetch-depth", "-1"]))


# --- the loop: drain codes and heartbeats --------------------------------------


def _counting_step(on_step=None):
    calls = []

    def step(tokens):
        calls.append(int(tokens[0, 0]))
        if on_step is not None:
            on_step(len(calls))
        return {"loss": torch.tensor(float(len(calls)))}

    return step, calls


def _batches():
    i = 0
    while True:
        yield (np.full((2, 4), i, np.int32),)
        i += 1


def test_sigterm_in_the_loop_exits_143_at_the_next_step_boundary():
    """run_payload's handler, called mid-step 2 (as SIGTERM would),
    defers: step 2 completes, step 3 never starts, the exit is 143."""
    def on_step(n):
        if n == 2:
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)

    step, calls = _counting_step(on_step)
    previous = signal.getsignal(signal.SIGTERM)
    try:
        code = bootstrap.run_payload(lambda _info: train.train_loop(
            step, _batches(), 10, device="cpu", heartbeat=None,
            steptrace=None))
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert code == bootstrap.EXIT_RETRYABLE == 143
    assert calls == [0, 1]


def test_drain_directive_exits_160_and_acks():
    """A heartbeat ACK carrying a drain directive arms the planned drain:
    the loop ACKs it with the boundary step and exits 160 there."""
    bodies = []

    def poster(_url, body):
        bodies.append(body)
        if body["step"] == 2:
            return {"drain": {"id": "d-1", "reason": "node cordoned"}}
        return {}

    rep = heartbeat.HeartbeatReporter("http://s", "j", interval=0,
                                      poster=poster)
    step, calls = _counting_step()
    previous = signal.getsignal(signal.SIGTERM)
    try:
        code = bootstrap.run_payload(lambda _info: train.train_loop(
            step, _batches(), 10, device="cpu", heartbeat=rep,
            steptrace=None))
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert code == bootstrap.EXIT_PLANNED == 160
    assert calls == [0, 1]
    assert rep._drain_ack == {"id": "d-1", "step": 2}
    assert rep.take_drain_directive() is None  # consumed once


def test_loop_logs_fenced_metrics_and_returns_the_last_step():
    """Logs read the newest fenced step (one step behind after the first),
    heartbeats carry loss and tokensPerSec, the recorder times every
    phase, and the result is the last step's metrics."""
    from tpu_operator_torch.payload import steptrace

    logged, bodies = [], []
    ticks = iter(np.arange(0.0, 1000.0, 0.5))
    rep = heartbeat.HeartbeatReporter(
        "http://s", "j", interval=0, clock=lambda: float(next(ticks)),
        poster=lambda _u, body: bodies.append(body))
    step, _calls = _counting_step()
    out = train.train_loop(step, _batches(), 4, device="cpu",
                           log_every=1,
                           log_fn=lambda i, m: logged.append((i, m["loss"])),
                           heartbeat=rep, steptrace=steptrace.StepRecorder())
    assert out == {"loss": 4.0}
    assert logged == [(1, 1.0), (2, 1.0), (3, 2.0), (4, 3.0)]
    assert [b.get("loss") for b in bodies] == [1.0, 1.0, 2.0, 3.0]
    assert rep.tokens_per_batch == 8
    assert all(b["tokensPerSec"] == pytest.approx(8 / b["stepTimeSeconds"])
               for b in bodies[1:])
    phases = bodies[-1]["stepTiming"]["phases"]
    assert {"dataWait", "dispatch", "compute", "host"} <= set(phases)


def test_training_heartbeat_body_matches_jax():
    """The same calls on the port's reporter and the JAX package's, under
    the same clock, post the same bodies: loss (finite only),
    tokensPerSec, stepTimeSeconds, and the drain channel's ACK parsing
    and one-shot drainAck."""
    def drive(mod):
        ticks = iter(np.arange(0.0, 100.0, 0.75))
        bodies = []

        def poster(_url, body):
            bodies.append(body)
            return {"drain": {"id": "d-7", "reason": "r"}} \
                if body["step"] == 3 else {"ok": True}

        rep = mod.HeartbeatReporter(
            "http://s/", "j", namespace="ns", attempt=1, interval=0,
            tokens_per_batch=4096, clock=lambda: float(next(ticks)),
            poster=poster)
        taken = []
        for step, loss in enumerate([5.5, 5.25, float("nan"), 4.0, 3.5],
                                    start=1):
            if rep.due(step):
                rep.report(step, {"loss": loss})
            directive = rep.take_drain_directive()
            if directive:
                taken.append(directive)
                rep.attach_drain_ack({"id": directive["id"], "step": step})
        return bodies, taken

    ours, theirs = drive(heartbeat), drive(jheartbeat)
    assert ours == theirs
    bodies, taken = ours
    assert taken == [{"id": "d-7", "reason": "r"}]
    assert "loss" not in bodies[2] and bodies[1]["tokensPerSec"] > 0
    assert bodies[3]["drainAck"] == {"id": "d-7", "step": 3}
    assert "drainAck" not in bodies[4]  # delivered once, then dropped


def test_throughput_counts_steps_per_second():
    step, calls = _counting_step()
    rate = train.throughput(step, _batches(), 5, device="cpu", warmup=2)
    assert rate > 0 and len(calls) == 7


def test_shim_namespace_args_build():
    """transformer.build takes any namespace with the parsed flags."""
    args = argparse.Namespace(**vars(transformer.parse_args(
        TINY + ["--device", "cpu"])))
    built = transformer.build(args)
    assert built.device == torch.device("cpu")
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in built.model.parameters())
