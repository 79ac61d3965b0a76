"""The port's pipeline over processes: stages handed on point to point
(``batch_isend_irecv``) and data ranks reduced, against one process
holding every stage.

On the CPU the processes form a gloo group (``bootstrap.initialize`` from
the operator's ``JAX_*`` env), each with one intra-op thread so that the
CPU kernels round alike in each. A module-scoped run starts seven
interpreters: two at ``--pipeline 2`` (one stage each), four at
``--pipeline 2`` over data 2, and one holding everything. Each trains 2
steps of every configuration it is given in f32 and saves the losses, the
first step's gradients and the params after the steps (a process saves
the stages it holds), then saves a checkpoint under its layout, restores
it into a fresh build, and tries to restore it across another
``--pipeline``.

The card form runs the pair over NCCL on two cards in bf16 (marker
``cuda``; it skips with fewer than two); the suite's conftest imports
JAX, which the card machine lacks, so run it past it:

    python -m pytest tests/test_torch_pipeline_multiprocess.py \\
        --noconftest -m cuda -q
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
import torch

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 240.0

# label -> flags, each at --pipeline 2.
CONFIGS = {
    "1f1b": ["--schedule", "1f1b"],
    "interleaved": ["--schedule", "1f1b-interleaved", "--virtual-stages",
                    "2"],
    "gpipe": ["--schedule", "gpipe"],
    "zero1": ["--schedule", "1f1b", "--zero1"],
}

SCRIPT = textwrap.dedent('''
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, sys.argv[1])
    from tpu_operator_torch.payload import bootstrap, checkpoint, pipeline

    out, device, dtype, ckroot = sys.argv[2:6]
    configs = json.loads(sys.argv[6])

    def argv(flags, pipe="2", micro="4"):
        return ["--batch", "8", "--seq-len", "32", "--dim", "32", "--heads",
                "2", "--layers", "4", "--pipeline", pipe, "--microbatches",
                micro, "--dtype", dtype, "--lr", "1e-2", "--seed", "0",
                "--device", device, "--checkpoint-dir", "",
                "--profile-dir", ""] + flags

    def host(t):
        return t.detach().float().cpu().numpy().copy()

    def payload(info):
        torch.backends.cuda.matmul.allow_tf32 = False
        world, rank = info.num_processes, info.process_id
        saved = {}
        for label, flags in configs.items():
            built = pipeline.build(pipeline.parse_args(argv(flags)))
            saved[label + ".mesh"] = np.array(list(built.mesh[:4]))
            for i in range(2):
                (tokens,) = next(built.batches)
                tokens = torch.from_numpy(tokens).to(built.device)
                if i == 0:
                    loss, grads = built.pipeline.loss_and_grads(tokens)
                    for n, g in grads.items():
                        saved[f"{label}.grad.{n}"] = host(g)
                m = built.step(tokens)
                saved[f"{label}.loss{i}"] = np.float32(float(m["loss"]))
            for n, p in built.model.params.items():
                saved[f"{label}.param.{n}"] = host(p)
            ckdir = f"{ckroot}/{label}"
            ck = checkpoint.Checkpointer(ckdir, save_every=1)
            ck.save(2, built.state)
            ck.close()
            fresh = pipeline.build(pipeline.parse_args(argv(flags)))
            ck = checkpoint.Checkpointer(ckdir, save_every=1)
            _state, start = ck.restore(fresh.state)
            ck.close()
            live, got = built.state, fresh.state
            same = start == 2 and all(
                torch.equal(p, got.params[n]) for n, p in live.params.items())
            mine = got.opt.state_dict()
            same = same and all(torch.equal(t, mine[n]) for n, t
                                in live.opt.state_dict().items())
            saved[label + ".restored_bit_equal"] = np.bool_(same)
            other = pipeline.build(pipeline.parse_args(
                argv(flags, pipe="1", micro="1")))
            ck = checkpoint.Checkpointer(ckdir, save_every=1)
            try:
                ck.restore(other.state)
                refused = False
            except checkpoint.CheckpointError as e:
                refused = "pipeline" in str(e)
            ck.close()
            saved[label + ".cross_layout_refused"] = np.bool_(refused)
        np.savez(f"{out}/w{world}r{rank}.npz", **saved)

    sys.exit(bootstrap.run_payload(payload, device=device))
''')


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _launch(out: Path, device: str, dtype: str, worlds: dict) -> dict:
    """{(world, rank): arrays} of every group in ``worlds`` (world ->
    config labels), each group on a port and checkpoint root of its own."""
    procs = {}
    for world, labels in worlds.items():
        port = _free_port()
        configs = {k: CONFIGS[k] for k in labels}
        for rank in range(world):
            env = dict(os.environ,
                       JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       JAX_PROCESS_ID=str(rank),
                       JAX_NUM_PROCESSES=str(world), OMP_NUM_THREADS="1")
            env.pop("TPUJOB_STATUS_URL", None)
            env.pop("TPU_CHECKPOINT_DIR", None)
            if device == "cuda":
                env["CUDA_VISIBLE_DEVICES"] = ",".join(
                    str(i) for i in range(world))
            procs[(world, rank)] = subprocess.Popen(
                [sys.executable, "-c", SCRIPT, str(REPO), str(out), device,
                 dtype, str(out / f"ck{world}"), json.dumps(configs)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
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
        assert proc.returncode == 0, logs[(world, rank)][-3000:]
        result[(world, rank)] = dict(np.load(out / f"w{world}r{rank}.npz"))
    return result


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("pipe_gloo"), "cpu", "f32",
                   {2: ["1f1b", "interleaved", "gpipe"],
                    4: ["1f1b", "zero1"],
                    1: ["1f1b", "interleaved", "gpipe"]})


@pytest.fixture(scope="module")
def card_runs(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA cards")
    from tpu_operator_torch.kernels import build

    build.library()  # once, before the workers load it
    return _launch(tmp_path_factory.mktemp("pipe_nccl"), "cuda", "bf16",
                   {2: ["1f1b", "interleaved"], 1: ["1f1b", "interleaved"]})


def _stage_key(key: str) -> bool:
    return ".param.stages." in key or ".grad.stages." in key


def _whole(group, key: str) -> np.ndarray:
    """A pipe pair's value of ``key``: a stage stack's two halves put back
    together along its pipe dim (dim 1 of an interleaved ``[V, S, ...]``
    stack), anything else as the pair's process 0 holds it."""
    if not _stage_key(key):
        return group[0][key]
    dim = 1 if key.startswith("interleaved.") else 0
    return np.concatenate([group[0][key], group[1][key]], axis=dim)


def _check_against_one(runs, world: int, labels, tol: float,
                       param_tol: float) -> None:
    """The group at ``world`` (its first pipe pair) against one process:
    every loss and the first step's gradients within ``tol`` of each
    value's largest entry, the params after 2 steps within ``param_tol``
    of max(1, their largest entry) (0: bit-equal)."""
    pair = [runs[(world, 0)], runs[(world, 1)]]
    one = runs[(1, 0)]
    for label in labels:
        ref = "1f1b" if label == "zero1" else label
        assert list(pair[0][label + ".mesh"]) == [world, 0, 2, 2]
        assert list(pair[1][label + ".mesh"]) == [world, 1, 2, 2]
        for i in range(2):
            got = [runs[(world, r)][f"{label}.loss{i}"] for r in range(world)]
            assert all(float(g) == float(got[0]) for g in got)
            assert abs(float(got[0]) - float(one[f"{ref}.loss{i}"])) \
                <= tol * abs(float(got[0])), (label, i)
        keys = [k[len(ref) + 1:] for k in one
                if k.startswith(ref + ".") and (".grad." in k
                                                or ".param." in k)]
        assert any("stages" in k for k in keys)
        for k in keys:
            got, want = _whole(pair, f"{label}.{k}"), one[f"{ref}.{k}"]
            assert got.shape == want.shape, k
            if k.startswith("param."):
                bound = param_tol * max(float(np.abs(want).max()), 1.0)
            else:
                bound = tol * float(np.abs(want).max())
            if bound == 0:
                np.testing.assert_array_equal(got, want, err_msg=k)
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=bound,
                                           err_msg=k)
        for r in range(world):
            assert bool(runs[(world, r)][label + ".restored_bit_equal"])
            assert bool(runs[(world, r)][label + ".cross_layout_refused"])


def test_pipe_pair_is_bit_equal_to_one_process(runs):
    """--pipeline 2 over two processes (activations and cotangents sent
    point to point; the replicated gradients summed with zeros) against
    one process holding both stages: bit-equal under 1f1b, interleaved V
    2 and gpipe; a save under pipe 2 restores bit-equal, and a restore at
    --pipeline 1 is refused."""
    _check_against_one(runs, 2, ["1f1b", "interleaved", "gpipe"], 0.0, 0.0)


def test_data_and_pipe_and_zero1_match_one_process(runs):
    """Data 2 x pipe 2 over four processes (each data rank half the batch,
    the stage gradients averaged over the data group, the replicated
    ones over the world) and the same with --zero1 (each data rank
    updates half of every optimizer leaf of >= 1024 elements and the
    params are all-gathered) against one process: every loss and the first
    step's gradients within 1e-6 of the largest value (f32 summation order
    over two half batches), every parameter after 2 adam steps within 1e-5
    of max(1, its largest entry) (adam divides by sqrt(v) ~ |g|, so that
    noise in a small gradient moves a parameter further: 1.2e-6 was read,
    the MoE pair's bound); the ZeRO-1 moments save and restore
    bit-equal."""
    _check_against_one(runs, 4, ["1f1b", "zero1"], 1e-6, 1e-5)
    for r in range(4):
        assert list(runs[(4, r)]["zero1.mesh"]) == [4, r, 2, 2]


@pytest.mark.cuda
def test_pipe_pair_over_nccl(card_runs):
    """The pair on two cards over NCCL in bf16 (K1 and K2 through the
    padded path at head dim 16) against one card: within 1e-6 (the same
    kernels on the same inputs; the bound allows a reordered f32 sum)."""
    _check_against_one(card_runs, 2, ["1f1b", "interleaved"], 1e-6, 1e-6)
