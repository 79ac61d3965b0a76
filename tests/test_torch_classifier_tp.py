"""The port's classifier under tensor parallelism (``cifar --model-parallel
N``) on the CPU, one process holding every model shard as units, against
the JAX package's ``cifar.build`` at the same ``--model-parallel`` (the
conftest's 8-device mesh: data 4 x model 2) and against the port at
``--model-parallel 1``.

The reference splits the stage-2 convs by output channel and the head by
class (``models.param_partition_spec``) and lets GSPMD place the
collectives; the port computes each shard's channels and classes as a
unit and joins them where a layer needs all of them. The function is the
same, so the comparisons hold the port to the bounds of
``test_torch_classifier.py``'s unsplit trajectory test; each states its
tolerance and what was seen.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpu_operator.payload import cifar as jcifar
from tpu_operator.payload import data as jdata
from tpu_operator.payload import models as jmodels
from tpu_operator_torch.payload import bootstrap
from tpu_operator_torch.payload import checkpoint
from tpu_operator_torch.payload import cifar
from tpu_operator_torch.payload import collectives
from tpu_operator_torch.payload import compute
from tpu_operator_torch.payload import data
from tpu_operator_torch.payload import models
from tpu_operator_torch.payload import train
from tpu_operator_torch.payload import weights

# ResNet-8 (blocks 1) at widths 8/16/16: stage 2 splits 8 + 8 channels,
# the head 5 + 5 classes.
TINY = ["--batch", "16", "--blocks", "1", "--widths", "8", "16", "16",
        "--log-every", "0", "--seed", "0", "--checkpoint-dir", "",
        "--profile-dir", ""]
STEPS = 5


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def _jax_cifar(extra):
    return jcifar.build(jcifar.parse_args(TINY[:-4] + list(extra)))


def _port(variables, extra, shards):
    """The port's step over the reference's initial variables, every one
    of ``shards`` model shards in this process."""
    args = cifar.parse_args(TINY + list(extra) + ["--device", "cpu"])
    model = weights.cifar_from_flax(
        *variables, tp=collectives.TPShards(shards, 1, 0, None))
    opt = compute.make_optimizer(args)
    opt_state = opt.init(list(model.parameters()))
    step = train.make_classifier_train_step(
        model, opt, opt_state, **compute.classifier_step_options(args))
    return model, step, data.synthetic_cifar(args.seed, args.batch)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


@pytest.mark.parametrize("extra,dtype", [
    ([], "bf16"), ([], "f32"), (["--scan-blocks", "--blocks", "2"], "f32")],
    ids=["blocks-bf16", "blocks-f32", "scan_blocks-f32"])
def test_model_parallel_trajectory_matches_jax(monkeypatch, extra, dtype):
    """Five steps of the reference's cifar step at ``--model-parallel 2``
    and the port's, both shards as units, from the same variables on the
    same batches (sgd 0.1 / 0.9). ``--scan-blocks`` needs two blocks a
    stage: the reference then splits only ``stage2_block0`` (its stacked
    5-D kernels stay whole), and the port follows it. It runs in f32
    only: at two blocks a stage bf16's rounding gap grows too fast for
    the loss bound (the unsplit port itself leaves the reference's losses
    by 6.5e-3 at step 3, 1.6e-2 at step 4 and 2.1e-2 at step 5).

    - bf16 (the payload's convolutions): losses to 1e-2 absolute a step
      and accuracies to 2/16, the bounds of
      ``test_cifar_trajectory_matches_jax`` (bf16 convolutions round
      apart on the two sides, and sgd carries it on).
    - f32 (both sides' convolutions in f32, the same function up to
      summation order): five steps, losses to 1e-3 (1.8e-4 seen) and
      accuracies to 2/16; the params after five steps to 5e-2 of the
      norm of what the steps moved them, over all leaves at once (1.6e-2
      seen; per leaf, BatchNorm biases whose gradients BatchNorm nearly
      cancels differ by more, at model 1 as at 2); each running
      statistic to 1e-2 of its largest value (7.9e-4 seen). A wrong
      split, join or gradient sum is off by O(1)."""
    if dtype == "f32":
        monkeypatch.setattr(jmodels, "CifarResNet", functools.partial(
            jmodels.CifarResNet, dtype=jnp.float32))
        monkeypatch.setattr(models, "COMPUTE_DTYPE", torch.float32)
    mesh, _m, state, jstep, jbatches = _jax_cifar(
        ["--model-parallel", "2", *extra])
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {"data": 4,
                                                             "model": 2}
    initial = (_np(state.params), _np(state.batch_stats))
    model, tstep, tbatches = _port(initial, extra, 2)
    assert model.tp_dims(), "nothing split"
    jl, tl, ja, ta = [], [], [], []
    for _ in range(STEPS):
        (jx, jy), (tx, ty) = next(jbatches), next(tbatches)
        assert jx.tobytes() == tx.tobytes()
        state, m = jstep(state, *jdata.put_global_batch(mesh, jx, jy))
        jl.append(float(m["loss"]))
        ja.append(float(m["accuracy"]))
        tm = tstep(torch.from_numpy(tx), torch.from_numpy(ty))
        tl.append(float(tm["loss"]))
        ta.append(float(tm["accuracy"]))
    np.testing.assert_allclose(tl, jl, rtol=0,
                               atol=1e-2 if dtype == "bf16" else 1e-3)
    np.testing.assert_allclose(ta, ja, rtol=0, atol=2 / 16 + 1e-6)
    assert tl[-1] < tl[0]
    if dtype == "bf16":
        return
    got_p, got_s = (_leaves(t) for t in weights.cifar_to_flax(model))
    start, want_p = _leaves(initial[0]), _leaves(_np(state.params))
    assert want_p.keys() == got_p.keys()
    gap = math.sqrt(sum(np.sum((got_p[k] - w) ** 2)
                        for k, w in want_p.items()))
    moved = math.sqrt(sum(np.sum((w - start[k]) ** 2)
                          for k, w in want_p.items()))
    assert gap <= 5e-2 * moved
    want_s = _leaves(_np(state.batch_stats))
    assert want_s.keys() == got_s.keys()
    for path, w in want_s.items():
        np.testing.assert_allclose(got_s[path], w, rtol=0,
                                   atol=1e-2 * np.abs(w).max(),
                                   err_msg=str(path))


def _build(shards, extra=()):
    return cifar.build(cifar.parse_args(
        TINY + ["--model-parallel", str(shards), "--device", "cpu",
                *extra]))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_model_2_against_model_1_at_init(monkeypatch, dtype):
    """The port at ``--model-parallel 2`` against itself at 1 from the
    same seed on the same batch: the same params (the init draws each
    whole tensor and keeps the part), then

    - the logits bit-equal: each unit's convolution is the whole one's
      channel slice, and BatchNorm is per channel;
    - every gradient of the first step within 1e-5 of its norm with f32
      convolutions (the same function summed in another order; 1.6e-6
      seen), and within 2^-5 with the payload's bf16 ones (each unit's
      input gradient is its own bf16 product before the f32 sum of the
      units, where one conv rounds the sum once: 1.3e-2 seen on a
      BatchNorm bias, whose gradient BatchNorm nearly cancels). A
      missing sum over the units' input gradients is off by O(1)."""
    if dtype == "f32":
        monkeypatch.setattr(models, "COMPUTE_DTYPE", torch.float32)
    one, two = _build(1), _build(2)
    for (n1, p1), (n2, p2) in zip(one.model.named_parameters(),
                                  two.model.named_parameters()):
        assert n1 == n2 and torch.equal(p1, p2), n1
    x, y = (torch.from_numpy(a) for a in next(one.batches))
    grads = []
    for built in (one, two):
        logits, _stats = built.model(x)
        F.cross_entropy(logits, y.long()).backward()
        grads.append((logits.detach(), {n: p.grad for n, p in
                                        built.model.named_parameters()}))
    assert torch.equal(grads[0][0], grads[1][0])
    tol = 1e-5 if dtype == "f32" else 2 ** -5
    for name, want in grads[0][1].items():
        gap = (grads[1][1][name] - want).norm()
        assert gap <= tol * want.norm(), name


def test_model_2_trajectory_against_model_1():
    """Five steps of the port at ``--model-parallel 2`` and at 1 from the
    same seed on the same batches: the first loss bit-equal (the same
    logits), the rest within 1e-2 (bf16 input gradients rounded per unit,
    carried on by sgd; 1.8e-3 seen at step 5), the accuracies within
    2/16."""
    runs = []
    for shards in (1, 2):
        built = _build(shards)
        metrics = []
        for _ in range(STEPS):
            x, y = next(built.batches)
            m = built.step(torch.from_numpy(x), torch.from_numpy(y))
            metrics.append((float(m["loss"]), float(m["accuracy"])))
        runs.append(np.array(metrics))
    assert runs[0][0, 0] == runs[1][0, 0]
    np.testing.assert_allclose(runs[1][:, 0], runs[0][:, 0], rtol=0,
                               atol=1e-2)
    np.testing.assert_allclose(runs[1][:, 1], runs[0][:, 1], rtol=0,
                               atol=2 / 16 + 1e-6)


@pytest.mark.parametrize("shards", [4, 3])
def test_model_parallel_that_does_not_divide_is_refused(shards):
    """``--model-parallel 4`` does not divide the 10 classes: the
    reference refuses it at build (the head's class dim does not shard),
    and so does the port's build; 3 divides neither the classes nor the
    stage-2 width."""
    if shards == 4:
        with pytest.raises(ValueError, match="divisible by 4"):
            _jax_cifar(["--model-parallel", "4"])
    with pytest.raises(ValueError, match=f"--model-parallel {shards}"):
        _build(shards)


def test_run_trains_at_model_parallel_2(tmp_path):
    """The payload's ``run`` at ``--model-parallel 2`` on the CPU trains
    (the last loss below the first), and a checkpoint it saves restores
    into a ``--model-parallel 1`` build bit-equal: in one process the
    params are whole, so the step's files are the same arrays."""
    args = cifar.parse_args(TINY + ["--model-parallel", "2", "--device",
                                    "cpu", "--steps", "6",
                                    "--checkpoint-dir", str(tmp_path),
                                    "--checkpoint-every", "6",
                                    "--log-every", "1"])
    info = bootstrap.ProcessInfo(coordinator_address="", process_id=0,
                                 num_processes=1, worker_id=0,
                                 worker_hostnames=())
    metrics = cifar.run(info, args)
    assert np.isfinite(metrics["loss"])
    again = _build(2)
    ck = checkpoint.Checkpointer(str(tmp_path))
    try:
        _s, step = ck.restore(again.state)
    finally:
        ck.close()
    assert step == 6
    one = _build(1)
    ck = checkpoint.Checkpointer(str(tmp_path))
    try:
        _s, step = ck.restore(one.state)
    finally:
        ck.close()
    assert step == 6
    for a, b in ((again.model.state_dict(), one.model.state_dict()),
                 (again.opt_state.state_dict(), one.opt_state.state_dict())):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_from_flax_holds_this_process_part():
    """``weights.cifar_from_flax`` at model 2 over two processes: each
    process's model holds its part of every split tensor (the stage-2
    convs' output channels, their BatchNorms' params and statistics, the
    head's classes) and the whole of the rest; the two parts joined are
    the one-process model's tensors, bit-equal."""
    model = jmodels.CifarResNet(blocks_per_stage=1, widths=(8, 16, 16))
    v = model.init(jax.random.key(0), jnp.zeros((2, 32, 32, 3)), train=True)
    tree = (_np(v["params"]), _np(v["batch_stats"]))
    whole = weights.cifar_from_flax(*tree).state_dict()
    parts = [weights.cifar_from_flax(
        *tree, tp=collectives.TPShards(2, 2, r, None)).state_dict()
        for r in range(2)]
    split = set(weights.cifar_from_flax(
        *tree, tp=collectives.TPShards(2, 1, 0, None)).tp_dims())
    assert "head.bias" in split and "stage2_block0.bn2.mean" in split
    for name, t in whole.items():
        if name in split:
            assert parts[0][name].shape[0] * 2 == t.shape[0], name
            got = torch.cat([p[name] for p in parts])
        else:
            got = parts[1][name]
        assert torch.equal(got, t), name
