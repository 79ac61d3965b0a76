"""The port's multi-process group on the CPU: two processes in a gloo group
formed by ``bootstrap.initialize`` from the operator's ``JAX_*`` env,
holding two ring shards each (N = 4, P = 2), against one process holding
all four (P = 1).

One module-scoped run starts three interpreters (``python -c`` of the
script below): the two of a two-process job on a free localhost port, and
a one-process job. Each runs, in order: the ring's forward and gradients
(contiguous and striped) on its slab; two training steps of the tiny LM
with ``--seq-parallel 4 --sp-layout striped``; then a drain, where the
second process of the pair sends itself SIGTERM during step 2. Each
process saves what it computed and runs with one intra-op thread, so that
the CPU kernels round the same way in every process. The run has a
timeout of its own, so a hang fails the tests instead of stalling the
suite.
"""

import json
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
    import json, os, signal, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, sys.argv[1])
    from tpu_operator_torch.payload import bootstrap, train, transformer
    from tpu_operator_torch.payload import ring_attention as ring

    out = sys.argv[2]
    TINY = ["--dim", "64", "--layers", "2", "--heads", "4", "--kv-heads",
            "2", "--vocab", "256", "--seq-len", "64", "--batch", "4",
            "--grad-accum", "2", "--log-every", "0", "--seed", "0",
            "--seq-parallel", "4", "--sp-layout", "striped", "--device",
            "cpu", "--checkpoint-dir", "", "--profile-dir", ""]

    def payload(info):
        rank, world = info.process_id, info.num_processes
        tag = f"{out}/w{world}r{rank}"
        mesh = transformer.make_lm_mesh(seq_parallel=4)
        rng = np.random.default_rng(0)
        q, k, v, cot = (rng.normal(size=(2, 64, hh, 16)).astype(np.float32)
                        for hh in (4, 2, 2, 4))
        saved = {}
        local = 64 // mesh.seq_procs
        lo = mesh.seq_rank * local
        for layout in ("contiguous", "striped"):
            perm = (ring.stripe_permutation(64, 4)[0] if layout == "striped"
                    else np.arange(64))
            ts = [torch.from_numpy(np.ascontiguousarray(
                x[:, perm][:, lo:lo + local])).requires_grad_(True)
                for x in (q, k, v)]
            o = ring.ring_attention(*ts, mesh.ring(), causal=True,
                                    stripe=layout == "striped")
            o.backward(torch.from_numpy(np.ascontiguousarray(
                cot[:, perm][:, lo:lo + local])))
            saved[f"{layout}_out"] = o.detach().numpy()
            for name, t in zip("qkv", ts):
                saved[f"{layout}_d{name}"] = t.grad.numpy()
        built = transformer.build(transformer.parse_args(TINY))
        losses = []
        for _ in range(2):
            (tokens,) = next(built.batches)
            losses.append(float(built.step(torch.from_numpy(tokens))["loss"]))
        saved["params"] = torch.cat(
            [p.detach().reshape(-1) for p in built.model.parameters()]
        ).numpy()
        np.savez(tag + ".npz", **saved)
        calls = []

        def step(tokens):
            calls.append(int(tokens[0, 0]))
            if rank == 1 and len(calls) == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return {"loss": torch.tensor(float(len(calls)))}

        def batches():
            i = 0
            while True:
                yield (np.full((2, 4), i, np.int32),)
                i += 1

        try:
            train.train_loop(step, batches(), 10, device="cpu",
                             heartbeat=None, steptrace=None)
        finally:
            with open(tag + ".json", "w") as f:
                json.dump({"losses": losses, "drain_steps": len(calls),
                           "mesh": list(mesh)}, f)

    sys.exit(bootstrap.run_payload(payload, device="cpu"))
''')


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(world, rank): (exit code, arrays, json)} of the three processes."""
    out = tmp_path_factory.mktemp("ring_gloo")
    port = _free_port()
    procs = {}
    for world, rank in ((2, 0), (2, 1), (1, 0)):
        env = dict(os.environ,
                   JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_PROCESS_ID=str(rank), JAX_NUM_PROCESSES=str(world),
                   OMP_NUM_THREADS="1")
        env.pop("TPUJOB_STATUS_URL", None)
        procs[(world, rank)] = subprocess.Popen(
            [sys.executable, "-c", SCRIPT, str(REPO), str(out)], env=env,
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
        tag = out / f"w{world}r{rank}"
        assert (tag.with_suffix(".npz")).exists(), logs[(world, rank)][-3000:]
        result[(world, rank)] = (
            proc.returncode, dict(np.load(tag.with_suffix(".npz"))),
            json.loads(tag.with_suffix(".json").read_text()))
    return result


def test_two_processes_form_the_mesh(runs):
    assert runs[(2, 0)][2]["mesh"] == [2, 0, 2, 4]  # world, rank, P, N
    assert runs[(2, 1)][2]["mesh"] == [2, 1, 2, 4]
    assert runs[(1, 0)][2]["mesh"] == [1, 0, 1, 4]


@pytest.mark.parametrize("layout", ["contiguous", "striped"])
def test_ring_with_two_processes_is_bit_equal_to_one(runs, layout):
    """Every shard merges and differentiates its blocks in the same order
    whatever P is, and gloo moves the bytes unchanged: the output and the
    q/k/v gradients of each process's slab equal the one-process run's
    halves bit for bit."""
    one = runs[(1, 0)][1]
    for rank in (0, 1):
        two = runs[(2, rank)][1]
        for name in ("out", "dq", "dk", "dv"):
            key = f"{layout}_{name}"
            half = one[key][:, rank * 32:(rank + 1) * 32]
            np.testing.assert_array_equal(two[key], half, err_msg=key)


def test_params_stay_bit_equal_across_ranks(runs):
    """Both processes apply the same all-reduced gradient to the same
    seeded params with the same optimizer."""
    a, b = runs[(2, 0)][1]["params"], runs[(2, 1)][1]["params"]
    assert a.size > 0
    np.testing.assert_array_equal(a, b)


def test_losses_match_the_one_process_run(runs):
    """The pair's all-reduced loss (each process's share of the whole
    sequence's mean, summed) against the one process's. Step 1 runs on the
    same params: the shares are summed in another order, f32 rounding
    only, held to 1e-6 relative (a wrong share, count or reduction is off
    by O(10%)). Step 2 starts from params updated with gradients summed in
    another order, where a near-zero gradient element can flip sign and
    adam's first step then moves it 2 lr the other way: held to 5e-3
    absolute, as tests/test_torch_train.py holds the port to the
    reference's step."""
    one = runs[(1, 0)][2]["losses"]
    for rank in (0, 1):
        two = runs[(2, rank)][2]["losses"]
        np.testing.assert_allclose(two[0], one[0], rtol=1e-6)
        np.testing.assert_allclose(two[1], one[1], rtol=0, atol=5e-3)


def test_a_drain_on_one_rank_exits_both_at_the_same_step(runs):
    """Rank 1 takes SIGTERM during step 2; at the next step boundary both
    processes agree (all_reduce MAX) and exit 143 with 2 steps done. The
    one-process run, never signalled, completes its 10 steps."""
    for rank in (0, 1):
        code, _arrays, meta = runs[(2, rank)]
        assert code == 143
        assert meta["drain_steps"] == 2
    code, _arrays, meta = runs[(1, 0)]
    assert code == 0 and meta["drain_steps"] == 10
