"""The port's data-parallel classifier on the CPU: two processes in a gloo
group (``bootstrap.initialize`` from the operator's ``JAX_*`` env), each
with half of every global batch, against one process with the whole
batch. BatchNorm reduces its statistics over the global batch in the
forward and the matching sums in the backward (models._BatchNormTrain),
and the step all-reduces the gradients, so the pair trains the model the
one process does.

A module-scoped run starts three interpreters (the pair on a free
localhost port, and the single process), each with one intra-op thread;
each saves its first step's loss, accuracy, gradients and new BatchNorm
statistics and its params after two steps. It runs twice: as the payload
runs (bf16 convolutions), and with the convolutions in f32, where the
pair and the one process compute the same function up to f32 summation
order, so the bounds can be tight.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 240.0

SCRIPT = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, sys.argv[1])
    from tpu_operator_torch.payload import bootstrap, cifar, models

    out = sys.argv[2]
    if sys.argv[3] == "f32":
        models.COMPUTE_DTYPE = torch.float32
    ARGS = ["--batch", "16", "--blocks", "1", "--widths", "8", "16", "16",
            "--seed", "0", "--device", "cpu", "--checkpoint-dir", "",
            "--profile-dir", ""]

    def payload(info):
        tag = f"{out}/w{info.num_processes}r{info.process_id}"
        built = cifar.build(cifar.parse_args(ARGS))
        saved = {"init." + n: p.detach().numpy().copy()
                 for n, p in built.model.named_parameters()}
        for i in range(2):
            x, y = next(built.batches)
            m = built.step(torch.from_numpy(x), torch.from_numpy(y))
            saved[f"loss{i}"] = np.float32(m["loss"])
            saved[f"accuracy{i}"] = np.float32(m["accuracy"])
            saved[f"rows{i}"] = np.int64(x.shape[0])
            if i == 0:
                for n, p in built.model.named_parameters():
                    saved["grad." + n] = p.grad.numpy()
                for n, b in built.model.named_buffers():
                    saved["stat." + n] = b.numpy().copy()
        for n, p in built.model.named_parameters():
            saved["param." + n] = p.detach().numpy()
        np.savez(tag + ".npz", **saved)

    sys.exit(bootstrap.run_payload(payload, device="cpu"))
''')


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module", params=["bf16", "f32"])
def runs(request, tmp_path_factory):
    """(compute dtype, {(world, rank): (exit code, arrays)}) of the three
    processes."""
    out = tmp_path_factory.mktemp("cifar_gloo")
    port = _free_port()
    procs = {}
    for world, rank in ((2, 0), (2, 1), (1, 0)):
        env = dict(os.environ,
                   JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_PROCESS_ID=str(rank), JAX_NUM_PROCESSES=str(world),
                   OMP_NUM_THREADS="1")
        env.pop("TPUJOB_STATUS_URL", None)
        procs[(world, rank)] = subprocess.Popen(
            [sys.executable, "-c", SCRIPT, str(REPO), str(out),
             request.param], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    try:
        for key, proc in procs.items():
            logs[key] = proc.communicate(timeout=TIMEOUT)[0]
    except subprocess.TimeoutExpired:
        for proc in procs.values():
            proc.kill()
        pytest.fail(f"the gloo run did not finish in {TIMEOUT} s")
    result = {}
    for (world, rank), proc in procs.items():
        path = out / f"w{world}r{rank}.npz"
        assert path.exists(), logs[(world, rank)][-3000:]
        result[(world, rank)] = (proc.returncode, dict(np.load(path)))
    return request.param, result


def test_each_process_takes_half_the_batch(runs):
    _dtype, runs = runs
    assert all(code == 0 for code, _ in runs.values())
    assert int(runs[(2, 0)][1]["rows0"]) == int(runs[(2, 1)][1]["rows0"]) == 8
    assert int(runs[(1, 0)][1]["rows0"]) == 16


def test_the_pair_agrees_bit_for_bit(runs):
    """Both processes reduce the same sums and apply the same all-reduced
    gradient: their statistics, gradients and params are bit-equal."""
    _dtype, runs = runs
    a, b = runs[(2, 0)][1], runs[(2, 1)][1]
    keys = [k for k in a if k.startswith(("grad.", "stat.", "param."))]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# (loss rtol, grad gap / grad norm, param gap / update norm) per compute
# dtype; the readings in brackets. f32: the same function summed in
# another order (loss 0 at step 1 and 9e-8 at step 2; gradients 3.9e-6;
# params 3.0e-5). bf16: each half's convolution weight gradient is
# rounded to bf16 before the all-reduce sums the halves, where one
# process rounds the whole batch's once (2^-8 relative), and the
# statistics' f32 differences can flip a bf16 rounding of an activation
# (loss 4e-7 at step 1 and 6e-5 at step 2; gradients 6.3e-3; params
# 0.175 of the two-step update, on BatchNorm scales and biases whose
# gradients are nearly cancelled by the BatchNorm after them). A missing
# backward all-reduce, or a BatchNorm over half the batch, is off by
# O(1) in every row.
BOUNDS = {"f32": (1e-6, 1e-4, 1e-3), "bf16": (1e-3, 2 ** -6, 0.25)}


def test_loss_grads_and_batch_stats_match_one_process(runs):
    """The pair against one process with the whole batch at step 1 (the
    same params): BatchNorm's statistics (f32 sums of the same values in
    another order) to 1e-4 of each leaf's largest value (1.9e-5 seen),
    the loss, the accuracy to one example in 16, and every gradient to
    its norm, with the BOUNDS of the compute dtype."""
    dtype, runs = runs
    loss_tol, grad_tol, _p = BOUNDS[dtype]
    two, one = runs[(2, 0)][1], runs[(1, 0)][1]
    np.testing.assert_allclose(two["loss0"], one["loss0"], rtol=loss_tol)
    assert abs(float(two["accuracy0"]) - float(one["accuracy0"])) <= 1 / 16
    for k in one:
        if k.startswith("stat."):
            np.testing.assert_allclose(two[k], one[k], rtol=0,
                                       atol=1e-4 * np.abs(one[k]).max(),
                                       err_msg=k)
        elif k.startswith("grad."):
            gap = np.linalg.norm(two[k] - one[k])
            assert gap <= grad_tol * np.linalg.norm(one[k]), k


def test_second_step_stays_with_one_process(runs):
    """After two steps (sgd 0.1 / 0.9): the step-2 loss, and every param's
    gap to the one process's against the norm of what the two steps moved
    it, with the BOUNDS of the compute dtype."""
    dtype, runs = runs
    loss_tol, _g, param_tol = BOUNDS[dtype]
    two, one = runs[(2, 0)][1], runs[(1, 0)][1]
    np.testing.assert_allclose(two["loss1"], one["loss1"], rtol=loss_tol)
    for k in one:
        if k.startswith("param."):
            moved = np.linalg.norm(one[k] - one["init." + k[6:]])
            assert np.linalg.norm(two[k] - one[k]) <= param_tol * moved, k
