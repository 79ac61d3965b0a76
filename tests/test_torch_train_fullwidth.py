"""Full-width training parity of the port with the reference, on the CPU.

The flagship GQA LM's widths (dim 2048, 8 layers, 16 query / 4 K/V
heads, vocab 32768; ``bench.py:636``) through the JAX ``transformer.build``
and the port from the same f32 params (``weights.from_flax``), 6 steps of
adam with a bf16 first moment at lr 3e-4 on the same batches of 4 x 256
tokens. The parity tests of tests/test_torch_train.py run at 64 wide;
this one holds the widths the card trains at.

Marked ``slow``: it holds two ~0.5 B-param models and their optimizer
states on the host (~16 GB) and takes minutes, so the tier-1 sweep
(``-m 'not slow'``) leaves it out; run it alone with
``python -m pytest tests/test_torch_train_fullwidth.py -m slow``.
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

FLAGSHIP = ["--dim", "2048", "--layers", "8", "--heads", "16",
            "--kv-heads", "4", "--vocab", "32768", "--seq-len", "256",
            "--batch", "4", "--lr", "3e-4", "--adam-mu-dtype", "bf16",
            "--log-every", "0", "--seed", "0", "--checkpoint-dir", "",
            "--profile-dir", ""]
STEPS = 6
# The reading this bound stands on: the port within 1.8e-3 of the
# reference over 6 steps at lr 3e-4 (a CPU run at these widths). The
# frameworks' bf16 logits differ by up to 2^-5 per element
# (tests/test_torch_models.py), and each adam step carries the gap into
# the weights; 5e-3 is the 64-wide parity test's bound, and a wrong
# gradient or update moves the loss by the ~0.1 a step changes it here.
LOSS_TOL = 5e-3


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def fullwidth_losses(argv, steps):
    """(reference losses, port losses) of ``steps`` steps of the JAX
    transformer step on a one-device CPU mesh and the port's from its
    params, on the same batches."""
    args = jtransformer.parse_args(argv)
    mesh = jtransformer.make_lm_mesh(num_devices=1)
    mesh, _model, state, jstep, jbatches = jtransformer.build(args,
                                                              mesh=mesh)
    targs = transformer.parse_args(argv + ["--device", "cpu"])
    model = weights.from_flax(_np_tree(state.params), heads=targs.heads,
                              param_dtype=torch.float32)
    model.requires_grad_(True)
    opt = optimizers.from_args(targs)
    tstep = transformer.make_lm_train_step(
        model, opt, opt.init(list(model.parameters())))
    spec = jtransformer.lm_token_spec(mesh)
    jl, tl = [], []
    for _ in range(steps):
        (tokens,) = next(jbatches)
        state, m = jstep(state, *jdata.put_global_batch(mesh, tokens,
                                                        spec=spec))
        jl.append(float(jax.device_get(m["loss"])))
        tl.append(float(tstep(torch.from_numpy(tokens))["loss"]))
    return jl, tl


@pytest.mark.slow
def test_fullwidth_training_follows_the_reference():
    """Six steps at the flagship's widths: every loss within LOSS_TOL of
    the reference's, and the loss moves (a frozen trajectory would agree
    vacuously)."""
    jl, tl = fullwidth_losses(FLAGSHIP, STEPS)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_TOL)
    assert abs(jl[-1] - jl[0]) > 0.05
