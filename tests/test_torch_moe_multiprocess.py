"""The port's expert parallelism: two processes at ``--expert-parallel 2``
(each holding half the experts of every MoE layer and half of every
batch, the expert slots exchanged by all-to-all) against one process at
``--expert-parallel 1`` holding everything.

On the CPU the pair forms a gloo group (``bootstrap.initialize`` from the
operator's ``JAX_*`` env); a module-scoped run per dispatch mode starts
the three interpreters with one intra-op thread each. Each trains 2 steps
in f32 and saves its metrics, its first step's gradients and its params
after the steps (the pair's expert stacks are halves, put back together
here), then saves a checkpoint under its layout and restores it into a
fresh build.

The card form runs the same script over NCCL on two cards (marker
``cuda``; it skips with fewer than two); the suite's conftest imports
JAX, which the card machine lacks, so run it past it:

    python -m pytest tests/test_torch_moe_multiprocess.py --noconftest \\
        -m cuda -q
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 240.0

SCRIPT = textwrap.dedent('''
    import sys, tempfile
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, sys.argv[1])
    from tpu_operator_torch.payload import bootstrap, checkpoint, moe

    out, dispatch, device = sys.argv[2], sys.argv[3], sys.argv[4]
    ckdir = sys.argv[5]

    def argv(world):
        return ["--batch", "4", "--seq-len", "32", "--dim", "32", "--heads",
                "2", "--layers", "2", "--experts", "4", "--capacity-factor",
                "1.0", "--dtype", "f32", "--lr", "1e-2", "--seed", "0",
                "--dispatch", dispatch, "--expert-parallel", str(world),
                "--device", device, "--checkpoint-dir", "",
                "--profile-dir", ""]

    def host(t):
        return t.detach().float().cpu().numpy().copy()

    def payload(info):
        torch.backends.cuda.matmul.allow_tf32 = False
        world = info.num_processes
        tag = f"{out}/w{world}r{info.process_id}"
        built = moe.build(moe.parse_args(argv(world)))
        saved = {"mesh": np.array(list(built.mesh[:4]))}
        for i in range(2):
            (tokens,) = next(built.batches)
            saved[f"rows{i}"] = np.int64(tokens.shape[0])
            m = built.step(torch.from_numpy(tokens).to(built.device))
            for k, v in m.items():
                saved[f"{k}{i}"] = np.float32(float(v))
            if i == 0:
                for n, p in built.model.named_parameters():
                    saved["grad." + n] = host(p.grad)
        for n, p in built.model.named_parameters():
            saved["param." + n] = host(p)
        ck = checkpoint.Checkpointer(ckdir, save_every=1)
        ck.save(2, built.state)
        ck.close()
        fresh = moe.build(moe.parse_args(argv(world)))
        ck = checkpoint.Checkpointer(ckdir, save_every=1)
        _state, start = ck.restore(fresh.state)
        ck.close()
        live = built.state
        got = fresh.state
        same = start == 2 and all(
            torch.equal(p, got.params[n]) for n, p in live.params.items())
        mine = got.opt.state_dict()
        same = same and all(torch.equal(t, mine[n]) for n, t
                            in live.opt.state_dict().items())
        saved["restored_bit_equal"] = np.bool_(same)
        np.savez(tag + ".npz", **saved)

    sys.exit(bootstrap.run_payload(payload, device=device))
''')


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _launch(out: Path, dispatch: str, device: str) -> dict:
    """{(world, rank): (exit code, arrays)} of the pair and the single
    process, each with a checkpoint dir of its layout's own."""
    port = _free_port()
    procs = {}
    for world, rank in ((2, 0), (2, 1), (1, 0)):
        env = dict(os.environ,
                   JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_PROCESS_ID=str(rank), JAX_NUM_PROCESSES=str(world),
                   OMP_NUM_THREADS="1")
        env.pop("TPUJOB_STATUS_URL", None)
        env.pop("TPU_CHECKPOINT_DIR", None)
        if device == "cuda":
            env["CUDA_VISIBLE_DEVICES"] = "0,1" if world == 2 else "0"
        ckdir = out / f"ck{world}"
        procs[(world, rank)] = subprocess.Popen(
            [sys.executable, "-c", SCRIPT, str(REPO), str(out), dispatch,
             device, str(ckdir)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    try:
        for key, proc in procs.items():
            logs[key] = proc.communicate(timeout=TIMEOUT)[0]
    except subprocess.TimeoutExpired:
        for proc in procs.values():
            proc.kill()
        pytest.fail(f"the {device} run did not finish in {TIMEOUT} s")
    result = {}
    for (world, rank), proc in procs.items():
        path = out / f"w{world}r{rank}.npz"
        assert path.exists(), logs[(world, rank)][-3000:]
        result[(world, rank)] = (proc.returncode, dict(np.load(path)))
    return result


@pytest.fixture(scope="module", params=["einsum", "gather"])
def runs(request, tmp_path_factory):
    out = tmp_path_factory.mktemp(f"moe_gloo_{request.param}")
    return _launch(out, request.param, "cpu")


@pytest.fixture(scope="module")
def card_runs(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA cards")
    from tpu_operator_torch.kernels import build

    build.library()  # once, before the workers load it
    return _launch(tmp_path_factory.mktemp("moe_nccl"), "einsum", "cuda")


def _whole(pair, key):
    """The pair's value of ``key``: an expert stack's two halves put back
    together in rank order, anything else as process 0 holds it."""
    a, b = pair[0][key], pair[1][key]
    if key.split(".")[-2:-1] == ["moe"] and key.endswith(("w1", "w2")):
        return np.concatenate([a, b])
    return a


def check_pair_against_one(runs, loss_tol: float, param_tol: float) -> None:
    for code, _ in runs.values():
        assert code == 0
    pair = [runs[(2, 0)][1], runs[(2, 1)][1]]
    one = runs[(1, 0)][1]
    assert list(pair[0]["mesh"]) == [2, 0, 2, 2]
    assert list(pair[1]["mesh"]) == [2, 1, 2, 2]
    assert int(pair[0]["rows0"]) == int(pair[1]["rows0"]) == 2
    assert int(one["rows0"]) == 4
    for i in range(2):
        for k in ("loss", "aux_loss", "router_z", "drop_frac", "total_loss"):
            assert float(pair[0][f"{k}{i}"]) == float(pair[1][f"{k}{i}"])
            assert abs(float(pair[0][f"{k}{i}"]) - float(one[f"{k}{i}"])) \
                <= loss_tol, (k, i)
    keys = [k for k in one if k.startswith(("grad.", "param."))]
    assert any(".moe.w1" in k for k in keys)
    for k in keys:
        got, want = _whole(pair, k), one[k]
        assert got.shape == want.shape, k
        scale = max(float(np.abs(want).max()), 1.0) \
            if k.startswith("param.") else float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=param_tol * scale, err_msg=k)
    for res in (pair[0], pair[1], one):
        assert bool(res["restored_bit_equal"])


def test_expert_parallel_pair_trains_what_one_process_does(runs):
    """f32: the loss and every metric within 1e-6 of one process (the
    reading: equal or one f32 ulp apart), the first step's gradient of
    every parameter within 1e-5 of its largest entry and every parameter
    within 1e-5 after 2 steps (the pair sums the replicated parameters'
    gradients over two halves of the batch, one process over the whole:
    f32 summation order). Both processes of the pair report the same
    metrics; a save under EP 2 restores bit-equal under EP 2."""
    check_pair_against_one(runs, loss_tol=1e-6, param_tol=1e-5)


@pytest.mark.cuda
def test_expert_parallel_pair_over_nccl(card_runs):
    """The same on two cards over NCCL (f32 products on cuBLAS, no TF32):
    the same bounds."""
    check_pair_against_one(card_runs, loss_tol=1e-6, param_tol=1e-5)
