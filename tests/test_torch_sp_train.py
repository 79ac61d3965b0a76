"""The port's sequence-parallel training step (tpu_operator_torch.payload.
transformer --seq-parallel 4, both layouts, the 4-shard ring in one
process) against the JAX package's ``transformer.build`` on its 8-device
CPU mesh (data 2 x seq 4, ``make_lm_mesh(8, seq_parallel=4)``), and
against the port's own unsharded step. Inputs and weights come from a
seed; each comparison states its tolerance.
"""

import numpy as np
import pytest
import torch

import jax

from tpu_operator.payload import data as jdata
from tpu_operator.payload import transformer as jtransformer
from tpu_operator_torch.payload import optimizers
from tpu_operator_torch.payload import transformer
from tpu_operator_torch.payload import weights

N = 4
SP_TINY = ["--dim", "64", "--layers", "2", "--heads", "4", "--kv-heads", "2",
           "--vocab", "256", "--seq-len", "64", "--batch", "4",
           "--grad-accum", "2", "--log-every", "0", "--seed", "0",
           "--seq-parallel", "4", "--checkpoint-dir", "", "--profile-dir", ""]


@pytest.fixture(scope="module")
def mesh():
    return jtransformer.make_lm_mesh(8, seq_parallel=N)  # (data=2, seq=4)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def _jax_sp_build(mesh, layout):
    args = jtransformer.parse_args(SP_TINY + ["--sp-layout", layout])
    _mesh, _model, state, step, batches = jtransformer.build(args, mesh=mesh)
    return state, step, batches


def _port_sp_build(params, layout, seq_parallel=N):
    """The port's step over the flax params on one process holding all
    ``seq_parallel`` shards."""
    args = transformer.parse_args(SP_TINY + ["--sp-layout", layout])
    model = weights.from_flax(params, heads=4, param_dtype=torch.float32)
    model.requires_grad_(True)
    optimizer = optimizers.from_args(args)
    state = optimizer.init(list(model.parameters()))
    step = transformer.make_lm_train_step(
        model, optimizer, state, grad_accum=args.grad_accum,
        mesh=transformer.make_lm_mesh(1, 0, seq_parallel),
        sp_layout=layout)
    return model, step


@pytest.mark.parametrize("layout", ["contiguous", "striped"])
def test_sp_train_step_matches_jax(mesh, layout):
    """Five steps of the JAX SP train step on its (data 2, seq 4) mesh and
    the port's with the 4-shard ring in one process, from the same f32
    params on the same batches. The tolerances of
    tests/test_torch_train.py::test_train_step_matches_jax, for the same
    reasons: losses within 5e-3 per step (bf16 logits differ by up to
    2^-5 between the frameworks); after step 1 every param element within
    2 lr + 1e-6 of the reference's, and at most 1% of them more than 1e-6
    apart (adam's first step is +-lr, so only a bf16-flipped sign of a
    near-zero gradient moves an element). A wrong shard order, offset or
    loss normalisation moves the loss by far more than 5e-3."""
    state, jstep, jbatches = _jax_sp_build(mesh, layout)
    model, tstep = _port_sp_build(_np_tree(state.params), layout)
    spec = jtransformer.lm_token_spec(mesh)
    lr = 3e-3
    jlosses, tlosses = [], []
    for i in range(5):
        (jb,) = next(jbatches)
        state, metrics = jstep(state, *jdata.put_global_batch(
            mesh, jb, spec=spec))
        jlosses.append(float(jax.device_get(metrics["loss"])))
        tlosses.append(float(tstep(torch.from_numpy(jb))["loss"]))
        if i == 0:
            jleaves = jax.tree_util.tree_leaves_with_path(
                _np_tree(state.params))
            tleaves = dict(jax.tree_util.tree_leaves_with_path(
                weights.to_flax(model)))
            assert len(jleaves) == len(tleaves)
            flipped = total = 0
            for path, want in jleaves:
                gap = np.abs(tleaves[path] - want)
                assert gap.max() <= 2 * lr + 1e-6, path
                flipped += int((gap > 1e-6).sum())
                total += gap.size
            assert flipped <= 0.01 * total
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=5e-3)
    assert tlosses[-1] < tlosses[0] - 0.25  # it learns the recurrence


@pytest.mark.parametrize("layout", ["contiguous", "striped"])
def test_sp_loss_equals_the_unsharded_loss(layout):
    """Same seeded params, same batch: the 4-shard ring's loss and the
    one-shard (flash attention) loss of the port. Both compute the same
    f32 attention in another summation order; the bf16 logits can then
    round apart by one ulp (2^-8 relative) here and there, which moves the
    mean over 252 targets by far less than 1e-3 (the reference's own
    striped-vs-contiguous test holds 1e-4 on one step); a wrong target,
    mask or count moves it by O(0.1)."""
    cpu = ["--device", "cpu"]
    one = transformer.build(transformer.parse_args(
        SP_TINY + ["--seq-parallel", "1"] + cpu))
    four = transformer.build(transformer.parse_args(
        SP_TINY + ["--sp-layout", layout] + cpu))
    (tokens,) = next(one.batches)
    loss1 = float(one.step(torch.from_numpy(tokens))["loss"])
    loss4 = float(four.step(torch.from_numpy(tokens))["loss"])
    assert abs(loss1 - loss4) < 1e-3
