"""The port's classifier payloads (tpu_operator_torch.payload: models'
CifarResNet / BatchNorm / LinearRegressor, weights, data, optimizers' sgd,
train's classifier and regression steps, cifar, linear) against the JAX
package's, on the CPU.

Inputs come from numpy with a seed, weights cross over with
``weights.cifar_from_flax``; each comparison states its tolerance.
"""

import math
import os
import signal

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax

from tpu_operator.payload import cifar as jcifar
from tpu_operator.payload import data as jdata
from tpu_operator.payload import models as jmodels
from tpu_operator_torch.payload import bootstrap
from tpu_operator_torch.payload import checkpoint
from tpu_operator_torch.payload import cifar
from tpu_operator_torch.payload import compute
from tpu_operator_torch.payload import data
from tpu_operator_torch.payload import linear
from tpu_operator_torch.payload import models
from tpu_operator_torch.payload import optimizers
from tpu_operator_torch.payload import train
from tpu_operator_torch.payload import weights

TINY = ["--batch", "16", "--blocks", "1", "--widths", "8", "16", "16",
        "--log-every", "0", "--seed", "0", "--checkpoint-dir", "",
        "--profile-dir", ""]


@pytest.fixture(autouse=True)
def _clean_drain_latch():
    bootstrap.reset_drain()
    yield
    bootstrap.reset_drain()


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def _flax_variables(blocks, widths, scan, seed=0, batch=8):
    """A flax CifarResNet's variables with every BatchNorm param and
    statistic moved off its init value, and an NHWC batch."""
    model = jmodels.CifarResNet(blocks_per_stage=blocks, widths=widths,
                                scan_blocks=scan)
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 0.3, size=(batch, 32, 32, 3)).astype(np.float32)
    v = model.init(jax.random.key(seed), jnp.asarray(x), train=True)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32),
        _np(v["params"]))
    stats = jax.tree_util.tree_map(
        lambda a: np.abs(a + 0.1 * rng.normal(size=a.shape)).astype(
            np.float32) + 0.5, _np(v["batch_stats"]))
    return model, params, stats, x


@pytest.mark.parametrize("scan", [False, True], ids=["blocks", "scan_blocks"])
def test_resnet_logits_and_batch_stats_match_flax(scan):
    """Train-mode logits and the new running statistics from the same
    weights, both layouts of the param tree (2 blocks per stage, so the
    scanned tree stacks one block).

    - Logits: the convolutions round their outputs to bf16 on both sides
      and normalize with batch statistics summed in different orders, so
      a bf16 rounding can move between them: held to 2^-6 of the largest
      |logit| (3.9e-3 of it seen).
    - Running statistics: f32 sums of the same bf16 conv outputs, held to
      2^-12 of each leaf's largest value (4.1e-5 seen).
    - Eval-mode logits (the running statistics): held to 2^-6 as well
      (bit-equal seen)."""
    fmodel, params, stats, x = _flax_variables(2, (8, 16, 32), scan)
    variables = {"params": params, "batch_stats": stats}
    want, mutated = fmodel.apply(variables, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
    want = np.asarray(want)
    model = weights.cifar_from_flax(params, stats)
    assert model.scan_blocks == scan
    got, new = model(torch.from_numpy(x), train=True)
    scale = np.abs(want).max()
    assert np.abs(got.detach().numpy() - want).max() <= 2 ** -6 * scale
    model.load_batch_stats(new)
    _p, got_stats = weights.cifar_to_flax(model)
    want_leaves = jax.tree_util.tree_leaves_with_path(
        _np(mutated["batch_stats"]))
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got_stats))
    assert len(want_leaves) == len(got_leaves)
    for path, w in want_leaves:
        g = got_leaves[path]
        assert g.shape == w.shape, path
        assert np.abs(g - w).max() <= 2 ** -12 * np.abs(w).max(), path
    eval_model = weights.cifar_from_flax(params, stats)
    want_eval = np.asarray(fmodel.apply(variables, jnp.asarray(x),
                                        train=False))
    got_eval = eval_model(torch.from_numpy(x), train=False).detach().numpy()
    assert np.abs(got_eval - want_eval).max() <= 2 ** -6 * np.abs(
        want_eval).max()


@pytest.mark.parametrize("scan", [False, True], ids=["blocks", "scan_blocks"])
def test_resnet_weights_round_trip(scan):
    """from_flax then to_flax gives every leaf back bit-equal, in the
    layout it came in."""
    _m, params, stats, _x = _flax_variables(3, (8, 16, 16), scan)
    p2, s2 = weights.cifar_to_flax(weights.cifar_from_flax(params, stats))
    for a, b in ((params, p2), (stats, s2)):
        la = jax.tree_util.tree_leaves_with_path(a)
        lb = dict(jax.tree_util.tree_leaves_with_path(b))
        assert len(la) == len(lb)
        for path, leaf in la:
            np.testing.assert_array_equal(lb[path], leaf)


def test_stride2_same_padding_matches_flax():
    """A 3x3 stride-2 SAME conv on 32x32 pads (0, 1) in flax; the port's
    Conv pads the same way and matches flax's bf16 conv to 2^-7 of the
    largest output (bf16 outputs from f32 accumulation in a different
    order). ``padding=1``, the torch habit, samples the grid shifted by a
    pixel: it must miss by far more."""
    assert models.same_padding(32, 3, 2) == (0, 1)
    assert models.same_padding(32, 3, 1) == (1, 1)
    assert models.same_padding(32, 1, 2) == (0, 0)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 32, 32, 4)).astype(np.float32)
    conv = nn.Conv(6, (3, 3), strides=(2, 2), padding="SAME", use_bias=False,
                   dtype=jnp.bfloat16)
    variables = conv.init(jax.random.key(1), jnp.asarray(x))
    want = np.asarray(conv.apply(variables, jnp.asarray(x)).astype(
        jnp.float32))
    kernel = np.asarray(variables["params"]["kernel"])
    port = models.Conv(4, 6, 3, 2)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = port(xt).float().permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape == (2, 16, 16, 6)
    tol = 2 ** -7 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol
    shifted = F.conv2d(xt.bfloat16(), port.weight.detach().bfloat16(),
                       stride=2, padding=1).float().permute(0, 2, 3, 1)
    assert np.abs(shifted.numpy() - want).max() > 20 * tol


@pytest.mark.parametrize("momentum", [None, 0.9])
def test_sgd_matches_optax(momentum):
    """Five steps of the same random gradients through optax.sgd and the
    port's sgd: the same f32 expressions in the same order, so the params
    and the trace are bit-equal."""
    rng = np.random.default_rng(5)
    shapes = [(16, 8), (8,), (3, 3, 2, 4)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tx = optax.sgd(0.1, momentum=momentum)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = optimizers.sgd(0.1, momentum=momentum)
    tstate = opt.init(tp)
    assert (tstate.trace is None) == (momentum is None)
    for _ in range(5):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate,
                                    jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g)
        opt.step(tp, tstate)
    for mine, theirs in zip(tp, jp):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    if momentum is not None:
        for mine, theirs in zip(tstate.trace, jstate[0].trace):
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def test_classifier_flags_and_defaults():
    args = cifar.parse_args([])
    assert (args.optimizer, args.remat_policy, args.fused_loss,
            args.scan_blocks, args.aot) == ("sgd", "full", False, False,
                                             False)
    assert (args.steps, args.batch, args.lr, args.momentum, args.blocks,
            tuple(args.widths)) == (500, 1024, 0.1, 0.9, 3, (16, 32, 64))
    assert compute.classifier_step_options(args) == {
        "remat_policy": "full", "fused_loss": False}
    opt = compute.make_optimizer(args)
    assert isinstance(opt, optimizers.SGD) and opt.momentum == 0.9
    lin = linear.parse_args([])
    assert (lin.steps, lin.batch, lin.dim, lin.lr, lin.target_loss,
            lin.optimizer) == (200, 1024, 8, 0.1, 1e-3, "sgd")
    assert compute.make_optimizer(lin).momentum is None


def _jax_cifar(extra):
    args = jcifar.parse_args(TINY[:-4] + list(extra))
    return jcifar.build(args)


def _port_cifar(variables, extra):
    """The port's classifier step over the JAX build's initial variables
    (params, batch_stats), the pieces ``cifar.build`` assembles around its
    own seeded init."""
    args = cifar.parse_args(TINY + list(extra) + ["--device", "cpu"])
    model = weights.cifar_from_flax(*variables)
    opt = compute.make_optimizer(args)
    opt_state = opt.init(list(model.parameters()))
    step = train.make_classifier_train_step(
        model, opt, opt_state, **compute.classifier_step_options(args))
    return model, step, data.synthetic_cifar(args.seed, args.batch)


@pytest.mark.parametrize("extra", [[], ["--fused-loss"],
                                   ["--remat-policy", "dots"]],
                         ids=["sgd", "fused_loss", "remat_dots"])
def test_cifar_trajectory_matches_jax(extra):
    """Five steps of the JAX cifar step and the port's from the same
    variables on the same batches (ResNet-8 at widths 8/16/16, batch 16,
    sgd 0.1 / 0.9).

    - Losses: bf16 convolutions on both sides, whose roundings differ;
      sgd at lr 0.1 carries the difference into the weights, so the gap
      grows with the steps (4.2e-4 at step 1 from the same weights, at
      most 1.3e-3 over five steps, 5.8e-3 by step 8). Held to 1e-2
      absolute at every step; a step moves the loss by ~0.1-0.4.
    - Accuracies: to 2/16 (one near-tie may flip).
    - The port against itself: ``--remat-policy dots`` gives losses
      bit-equal to the plain run (the recompute repeats the same ops);
      the fused loss is the same loss of the same logits at step 1, to
      1e-6 relative (the summation order), and then takes its own path
      through the same rounding noise, so it is held to the JAX bound."""
    mesh, _model, state, jstep, jbatches = _jax_cifar(extra)
    # The JAX step donates its state: keep host copies of the start.
    initial = (_np(state.params), _np(state.batch_stats))
    _m, tstep, tbatches = _port_cifar(initial, extra)
    jl, tl, ja, ta = [], [], [], []
    for _ in range(5):
        (jx, jy), (tx, ty) = next(jbatches), next(tbatches)
        assert jx.tobytes() == tx.tobytes()
        state, m = jstep(state, *jdata.put_global_batch(mesh, jx, jy))
        jl.append(float(m["loss"]))
        ja.append(float(m["accuracy"]))
        tm = tstep(torch.from_numpy(tx), torch.from_numpy(ty))
        tl.append(float(tm["loss"]))
        ta.append(float(tm["accuracy"]))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-2)
    np.testing.assert_allclose(ta, ja, rtol=0, atol=2 / 16 + 1e-6)
    assert tl[-1] < tl[0]
    if extra:
        _m, plain_step, plain_batches = _port_cifar(initial, [])
        plain = [float(plain_step(*(torch.from_numpy(a) for a in
                                    next(plain_batches)))["loss"])
                 for _ in range(5)]
        if extra == ["--remat-policy", "dots"]:
            assert tl == plain
        else:
            np.testing.assert_allclose(tl[0], plain[0], rtol=1e-6)


def test_linear_exit_codes():
    """Convergence exits 0; a target it cannot reach exits 1 (the
    operator's contract, through run_payload)."""
    ok = linear.parse_args(["--device", "cpu", "--steps", "60"])
    previous = signal.getsignal(signal.SIGTERM)
    try:
        assert bootstrap.run_payload(lambda info: linear.run(info, ok)) == 0
        bad = linear.parse_args(["--device", "cpu", "--steps", "3",
                                 "--target-loss", "1e-9"])
        assert bootstrap.run_payload(lambda info: linear.run(info, bad)) == 1
    finally:
        signal.signal(signal.SIGTERM, previous)


def test_linear_trajectory_matches_jax():
    """The regression step from the same weights on the same batches:
    f32 throughout, held to 1e-5 relative per step."""
    from tpu_operator.payload import train as jtrain

    rng = np.random.default_rng(2)
    kernel = rng.normal(size=(8, 1)).astype(np.float32)
    bias = np.zeros((1,), np.float32)
    jmodel = jmodels.LinearRegressor()
    mesh = jtrain.make_mesh(num_devices=1)
    tx = optax.sgd(0.1)
    state = jtrain.create_train_state(jmodel, jax.random.key(0),
                                      jnp.zeros((16, 8)), tx)
    jparams = {"linear": {"kernel": jnp.asarray(kernel),
                          "bias": jnp.asarray(bias)}}
    state = state.replace(params=jparams, opt_state=tx.init(jparams))
    jstep = jtrain.make_regression_train_step(jmodel, tx, mesh, state)
    model = weights.linear_from_flax({"linear": {"kernel": kernel,
                                                 "bias": bias}})
    opt = optimizers.sgd(0.1)
    tstep = train.make_regression_train_step(
        model, opt, opt.init(list(model.parameters())))
    jb, tb = jdata.synthetic_linear(0, 16, 8), data.synthetic_linear(0, 16, 8)
    for _ in range(5):
        (jx, jy), (tx_, ty) = next(jb), next(tb)
        assert jx.tobytes() == tx_.tobytes() and jy.tobytes() == ty.tobytes()
        state, m = jstep(state, *jdata.put_global_batch(mesh, jx, jy))
        tm = tstep(torch.from_numpy(tx_), torch.from_numpy(ty))
        np.testing.assert_allclose(float(tm["loss"]), float(m["loss"]),
                                   rtol=1e-5)


def test_classifier_data_is_byte_identical():
    for ours, theirs in ((data.synthetic_cifar(4, 6),
                          jdata.synthetic_cifar(4, 6)),
                         (data.synthetic_linear(4, 6, 5),
                          jdata.synthetic_linear(4, 6, 5))):
        for _ in range(3):
            for a, b in zip(next(ours), next(theirs)):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _npz(path, n=12, shape=(32, 32, 3), labels=None, dtype=np.uint8):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, size=(n, *shape)).astype(dtype)
    labels = rng.integers(0, 10, size=n) if labels is None else labels
    np.savez(path, images=images, labels=labels)
    return str(path)


def test_npz_classification_streams_like_the_reference(tmp_path):
    path = _npz(tmp_path / "d.npz")
    ours = data.npz_classification(path, 3, 4, num_classes=10,
                                   image_shape=data.CIFAR_SHAPE)
    theirs = jdata.npz_classification(path, 3, 4, num_classes=10,
                                      image_shape=jdata.CIFAR_SHAPE)
    for _ in range(5):  # past the first epoch's 3 batches
        (a, la), (b, lb) = next(ours), next(theirs)
        assert a.tobytes() == b.tobytes() and la.tobytes() == lb.tobytes()
    assert 0.0 <= a.min() and a.max() <= 1.0


@pytest.mark.parametrize("case,match", [
    ("labels", "12 images but 11 labels"),
    ("batch", "has 12 examples < batch 16"),
    ("shape", "model expects"),
    ("range", "labels span"),
])
def test_npz_classification_validation_errors(tmp_path, case, match):
    """The reference's eager checks and messages, raised at the call."""
    kwargs = dict(num_classes=10, image_shape=data.CIFAR_SHAPE)
    batch = 4
    if case == "labels":
        path = _npz(tmp_path / "d.npz", labels=np.zeros(11, np.int64))
    elif case == "batch":
        path, batch = _npz(tmp_path / "d.npz"), 16
    elif case == "shape":
        path = _npz(tmp_path / "d.npz", shape=(28, 28, 1))
    else:
        path = _npz(tmp_path / "d.npz", labels=np.full(12, 10))
    for mod in (data, jdata):
        with pytest.raises(ValueError, match=match):
            mod.npz_classification(path, 0, batch, **kwargs)


def _cifar_run(tmp_path, steps, attempt_dir=None):
    """``cifar.build`` at tiny widths on the CPU, ``steps`` total steps
    through train_loop, checkpointing into ``attempt_dir`` every 2 steps;
    returns (losses of the steps it ran, the final state's tensors)."""
    args = cifar.parse_args(TINY + ["--device", "cpu", "--steps", str(steps),
                                    "--checkpoint-every", "2"])
    built = cifar.build(args)
    losses = []

    def step(x, y):
        m = built.step(x, y)
        losses.append(float(m["loss"]))
        return m

    ck = (checkpoint.Checkpointer(attempt_dir, save_every=2)
          if attempt_dir else None)
    try:
        train.train_loop(step, built.batches, steps, device=built.device,
                         heartbeat=None, steptrace=None, checkpointer=ck,
                         state=built.state if ck else None)
    finally:
        if ck is not None:
            ck.close()
    s = built.state
    tensors = {**{f"p.{k}": v.clone() for k, v in s.params.items()},
               **{f"b.{k}": v.clone() for k, v in s.batch_stats.items()},
               **{f"o.{k}": v.clone() for k, v in s.opt.state_dict().items()}}
    return losses, tensors


def test_cifar_kill_and_resume_is_bit_equal(tmp_path):
    """Run A stops after step 3 (saved), run B restores it and trains to
    6: B's losses and its final params, BatchNorm statistics and sgd
    trace are bit-equal to an unbroken 6-step run's."""
    whole_losses, whole = _cifar_run(tmp_path, 6)
    ckdir = str(tmp_path / "ck")
    a_losses, _ = _cifar_run(tmp_path, 3, ckdir)
    assert a_losses == whole_losses[:3]
    meta_path = os.path.join(ckdir, "3", checkpoint.META_FILE)
    import json
    with open(meta_path) as f:
        meta = json.load(f)
    assert meta["optimizer"] == "sgd"
    assert "bn_stem.mean" in meta["tensors"][checkpoint.STATS_FILE]
    b_losses, resumed = _cifar_run(tmp_path, 6, ckdir)
    assert b_losses == whole_losses[3:]
    assert resumed.keys() == whole.keys()
    for name, t in whole.items():
        assert torch.equal(resumed[name], t), name
    assert all(math.isfinite(x) for x in whole_losses)
