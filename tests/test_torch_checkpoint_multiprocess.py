"""The port's checkpoint / resume across processes on the CPU: two
processes in a gloo group (``bootstrap.run_payload`` from the operator's
``JAX_*`` env), data parallel over the tiny LM, against themselves and
against one process.

Each stage starts its processes with ``python -c`` of the script below
(the launcher of tests/test_torch_ring_multiprocess.py) and waits for them
under a timeout of its own, so a hang fails the test instead of stalling
the suite. A process trains to ``--steps`` through ``transformer.build``
and ``train.train_loop`` with the checkpointer of its ``--checkpoint-dir``
(none when empty), then saves its losses and its final state. One
intra-op thread per process, so that every run rounds alike (the checks
are bit-equality).

Stages, in order (one module-scoped run):

1. ``unbroken``: two processes, 4 steps, no checkpoint;
2. ``first``: two processes, 2 steps, a shared directory;
3. ``resumed``: the same two at ``TPUJOB_ATTEMPT=1``, to step 4;
4. ``per_process``: each process with a directory of its own, copied
   from the shared one, where process 1's lacks the newest step (4);
5. ``one_process``: one process restores the pair's step 4 (world 2 ->
   1) and trains no further step.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 180.0

SCRIPT = textwrap.dedent('''
    import json, logging, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, sys.argv[1])
    from tpu_operator_torch.payload import bootstrap, checkpoint, train
    from tpu_operator_torch.payload import transformer

    tag, ckdir, steps = sys.argv[2], sys.argv[3], int(sys.argv[4])
    TINY = ["--dim", "64", "--layers", "2", "--heads", "4", "--kv-heads",
            "2", "--vocab", "256", "--seq-len", "64", "--batch", "4",
            "--grad-accum", "1", "--adam-mu-dtype", "bf16", "--log-every",
            "0", "--seed", "0", "--device", "cpu", "--profile-dir", "",
            "--checkpoint-dir", ckdir, "--checkpoint-every", "2"]

    def payload(info):
        args = transformer.parse_args(TINY)
        built = transformer.build(args)
        ck = checkpoint.from_env_or_args(args.checkpoint_dir,
                                         save_every=args.checkpoint_every)
        losses, restored = [], []
        if ck is not None:
            real = ck.restore

            def restore(state):
                state, start = real(state)
                restored.append(start)
                return state, start

            ck.restore = restore

        def step(tokens):
            metrics = built.step(tokens)
            losses.append(float(metrics["loss"]))
            return metrics

        try:
            train.train_loop(step, built.batches, steps, device="cpu",
                             heartbeat=None, steptrace=None,
                             checkpointer=ck, state=built.state)
        finally:
            if ck is not None:
                ck.close()
        state = built.state
        np.savez(tag + ".npz",
                 params=torch.cat([p.detach().reshape(-1)
                                   for p in state.params.values()]).numpy(),
                 mu=torch.cat([m.float().reshape(-1)
                               for m in state.opt.mu]).numpy(),
                 nu=torch.cat([v.reshape(-1) for v in state.opt.nu]).numpy())
        with open(tag + ".json", "w") as f:
            json.dump({"losses": losses, "restored": restored,
                       "count": state.opt.count,
                       "steps": ck.all_steps() if ck is not None else [],
                       "verified": (ck.last_verified_step()
                                    if ck is not None else None)}, f)

    logging.basicConfig(level=logging.INFO)
    sys.exit(bootstrap.run_payload(payload, device="cpu"))
''')


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _launch(out: Path, name: str, dirs, steps: int, attempt: int = 0):
    """Run one job of ``len(dirs)`` processes (process r checkpoints to
    ``dirs[r]``) to ``steps``; returns [(exit code, arrays, json)] by
    rank."""
    world = len(dirs)
    port = _free_port()
    procs = []
    for rank, ckdir in enumerate(dirs):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_PROCESS_ID=str(rank), JAX_NUM_PROCESSES=str(world),
                   TPUJOB_ATTEMPT=str(attempt), OMP_NUM_THREADS="1")
        for var in ("TPUJOB_STATUS_URL", "TPU_CHECKPOINT_DIR",
                    "TPUJOB_STORE_URI"):
            env.pop(var, None)
        tag = out / f"{name}-r{rank}"
        procs.append((tag, subprocess.Popen(
            [sys.executable, "-c", SCRIPT, str(REPO), str(tag), str(ckdir),
             str(steps)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    logs = []
    try:
        for _tag, proc in procs:
            logs.append(proc.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for _tag, proc in procs:
            proc.kill()
        pytest.fail(f"stage {name} did not finish in {TIMEOUT} s")
    result = []
    for (tag, proc), log in zip(procs, logs):
        assert proc.returncode == 0, log[-3000:]
        result.append((proc.returncode,
                       dict(np.load(tag.with_suffix(".npz"))),
                       json.loads(tag.with_suffix(".json").read_text()),
                       log))
    return result


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("ckpt_gloo")
    shared = out / "shared"
    result = {
        "unbroken": _launch(out, "unbroken", ["", ""], 4),
        "first": _launch(out, "first", [shared, shared], 2),
    }
    result["resumed"] = _launch(out, "resumed", [shared, shared], 4,
                                attempt=1)
    mine, theirs = out / "p0", out / "p1"
    shutil.copytree(shared, mine)
    shutil.copytree(shared, theirs)
    shutil.rmtree(theirs / "4")
    result["dirs_before"] = (sorted(os.listdir(mine)),
                             sorted(os.listdir(theirs)))
    result["per_process"] = _launch(out, "per_process", [mine, theirs], 4,
                                    attempt=2)
    result["one_process"] = _launch(out, "one_process", [shared], 4,
                                    attempt=3)
    return result


def test_two_processes_resume_bit_equal_to_an_unbroken_pair(runs):
    """Attempt 0 trains steps 1-2 and saves 1 and 2 (process 0 writes,
    both verify); attempt 1 restores step 2 on both processes and trains
    3-4. The losses of the two attempts and the final params, mu and nu
    are bit-equal to the unbroken pair's, on both processes."""
    for rank in (0, 1):
        first = runs["first"][rank][2]
        resumed = runs["resumed"][rank][2]
        unbroken = runs["unbroken"][rank]
        assert first["restored"] == [0]
        assert first["verified"] == 2 and first["steps"] == [1, 2]
        assert resumed["restored"] == [2]
        assert "restored checkpoint step 2" in runs["resumed"][rank][3]
        assert resumed["verified"] == 4 and resumed["count"] == 4
        assert first["losses"] + resumed["losses"] == unbroken[2]["losses"]
        for key in ("params", "mu", "nu"):
            np.testing.assert_array_equal(runs["resumed"][rank][1][key],
                                          unbroken[1][key], err_msg=key)
    assert runs["resumed"][0][2]["steps"] == [1, 2, 4]


def test_per_process_dirs_agree_on_the_older_step(runs):
    """Process 0's directory holds step 4, process 1's only 1 and 2:
    the gang restores the MIN, 2, on both, trains 3-4 again and lands
    on the same state as before."""
    mine, theirs = runs["dirs_before"]
    assert mine == ["1", "2", "4"] and theirs == ["1", "2"]
    for rank in (0, 1):
        meta = runs["per_process"][rank][2]
        assert meta["restored"] == [2], rank
        assert meta["count"] == 4
        np.testing.assert_array_equal(runs["per_process"][rank][1]["params"],
                                      runs["unbroken"][rank][1]["params"])
    assert "gang agreed on step 2 (local newest valid was 4)" \
        in runs["per_process"][0][3]
    # Only process 0 writes: step 4 was saved again in its directory and
    # never in process 1's.
    assert runs["per_process"][0][2]["steps"] == [1, 2, 4]
    assert runs["per_process"][1][2]["steps"] == [1, 2]


def test_a_step_saved_by_two_processes_restores_into_one(runs):
    """The world-size change: the pair's step 4 restores into a
    one-process job (which then has nothing left to train), bit-equal
    to the pair's state."""
    (code, arrays, meta, log), = runs["one_process"]
    assert code == 0
    assert meta["restored"] == [4] and meta["losses"] == []
    assert meta["count"] == 4
    assert "restored checkpoint step 4" in log
    for key in ("params", "mu", "nu"):
        np.testing.assert_array_equal(arrays[key],
                                      runs["resumed"][0][1][key],
                                      err_msg=key)
