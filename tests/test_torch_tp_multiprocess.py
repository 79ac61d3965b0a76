"""Tensor parallelism and Ulysses across processes on the CPU: two
processes in a gloo group (``bootstrap.run_payload`` from the operator's
``JAX_*`` env), each holding one of two shards, against one process
holding both; and a checkpoint saved at ``--tensor-parallel 2`` restored
at ``--tensor-parallel 1``.

Each job starts its processes with ``python -c`` of the script below (the
launcher of tests/test_torch_ring_multiprocess.py) under a timeout of its
own, one intra-op thread per process, so that the CPU kernels round alike
in every process (the checks are bit-equality). Jobs, in order (one
module-scoped run):

1. ``tp_pair`` / ``tp_one``: ``--tensor-parallel 2`` on two processes and
   on one, 3 steps of the tiny GQA LM; the pair saves step 3 to a
   checkpoint directory;
2. ``uly_pair`` / ``uly_one``: ``--seq-parallel 2 --sp-mode ulysses``;
   each process also runs ``ulysses_attention`` on its slab of a seeded
   q / k / v and back-propagates a seeded cotangent;
3. ``restore_tp1``: one process at ``--tensor-parallel 1`` restores the
   pair's step 3 (``TPUJOB_ATTEMPT=1``) and trains no further step.
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
TIMEOUT = 180.0

SCRIPT = textwrap.dedent('''
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, sys.argv[1])
    from tpu_operator_torch.payload import bootstrap, checkpoint, train
    from tpu_operator_torch.payload import transformer, ulysses

    tag, ckdir, steps = sys.argv[2], sys.argv[3], int(sys.argv[4])
    flags = json.loads(sys.argv[5])
    TINY = ["--dim", "64", "--layers", "2", "--heads", "4", "--kv-heads",
            "2", "--vocab", "256", "--seq-len", "64", "--batch", "4",
            "--log-every", "0", "--seed", "0", "--device", "cpu",
            "--profile-dir", "", "--checkpoint-dir", ckdir,
            "--checkpoint-every", "100"] + flags

    def payload(info):
        args = transformer.parse_args(TINY)
        built = transformer.build(args)
        mesh = transformer.make_lm_mesh(seq_parallel=args.seq_parallel,
                                        tensor_parallel=args.tensor_parallel)
        saved = {}
        if args.sp_mode == "ulysses":
            rng = np.random.default_rng(0)
            q, k, v, cot = (rng.normal(size=(2, 64, h, 16)).astype(np.float32)
                            for h in (4, 2, 2, 4))
            local = 64 // mesh.seq_procs
            lo = mesh.seq_rank * local
            ts = [torch.from_numpy(np.ascontiguousarray(
                x[:, lo:lo + local])).requires_grad_(True) for x in (q, k, v)]
            out = ulysses.ulysses_attention(*ts, mesh.ring(), mesh.seq_group)
            out.backward(torch.from_numpy(np.ascontiguousarray(
                cot[:, lo:lo + local])))
            saved["uly_out"] = out.detach().numpy()
            for name, t in zip("qkv", ts):
                saved[f"uly_d{name}"] = t.grad.numpy()
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
        for name, p in built.model.named_parameters():
            saved["param." + name] = p.detach().numpy()
        np.savez(tag + ".npz", **saved)
        with open(tag + ".json", "w") as f:
            json.dump({"losses": losses, "restored": restored,
                       "mesh": [mesh.world, mesh.rank, mesh.seq_procs,
                                mesh.model_procs],
                       "tp_dims": {n: list(d) for n, d in
                                   built.model.tp_dims().items()}}, f)

    sys.exit(bootstrap.run_payload(payload, device="cpu"))
''')


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _launch(out: Path, name: str, world: int, flags, steps: int,
            ckdir="", attempt: int = 0):
    """[(arrays, json)] by rank of one job of ``world`` processes."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_PROCESS_ID=str(rank), JAX_NUM_PROCESSES=str(world),
                   TPUJOB_ATTEMPT=str(attempt), OMP_NUM_THREADS="1")
        for var in ("TPUJOB_STATUS_URL", "TPU_CHECKPOINT_DIR",
                    "TPUJOB_STORE_URI"):
            env.pop(var, None)
        tag = out / f"{name}-r{rank}"
        procs.append((tag, subprocess.Popen(
            [sys.executable, "-c", SCRIPT, str(REPO), str(tag), str(ckdir),
             str(steps), json.dumps(flags)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = []
    try:
        for _tag, proc in procs:
            logs.append(proc.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for _tag, proc in procs:
            proc.kill()
        pytest.fail(f"job {name} did not finish in {TIMEOUT} s")
    result = []
    for (tag, proc), log in zip(procs, logs):
        assert proc.returncode == 0, log[-3000:]
        result.append((dict(np.load(tag.with_suffix(".npz"))),
                       json.loads(tag.with_suffix(".json").read_text())))
    return result


TP = ["--tensor-parallel", "2"]
ULY = ["--seq-parallel", "2", "--sp-mode", "ulysses"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_gloo")
    ck = out / "ck"
    return {
        "tp_pair": _launch(out, "tp_pair", 2, TP, 3, ck),
        "tp_one": _launch(out, "tp_one", 1, TP, 3),
        "uly_pair": _launch(out, "uly_pair", 2, ULY, 3),
        "uly_one": _launch(out, "uly_one", 1, ULY, 3),
        "restore_tp1": _launch(out, "restore_tp1", 1,
                               ["--tensor-parallel", "1"], 3, ck, attempt=1),
    }


def _whole(pair, name):
    """The pair's two parts of param ``name`` joined along its split."""
    dims = pair[0][1]["tp_dims"]
    parts = [arrays["param." + name] for arrays, _meta in pair]
    if name not in dims:
        np.testing.assert_array_equal(parts[0], parts[1], err_msg=name)
        return parts[0]
    return np.concatenate(parts, axis=dims[name][0])


def test_the_pairs_form_their_meshes(runs):
    assert [m["mesh"] for _a, m in runs["tp_pair"]] == [[2, 0, 1, 2],
                                                       [2, 1, 1, 2]]
    assert [m["mesh"] for _a, m in runs["uly_pair"]] == [[2, 0, 2, 1],
                                                        [2, 1, 2, 1]]


def test_tp_over_two_processes_is_bit_equal_to_one(runs):
    """Each shard's column-parallel rows, its attention and its partial
    products are the same computations wherever it runs; the partial sums
    and the gradients entering a shard add in shard order on both layouts
    (two terms, one order), and gloo moves the bytes unchanged. So the
    losses of every step and the final params (the pair's parts joined)
    are bit-equal to one process holding both shards."""
    one_arrays, one_meta = runs["tp_one"][0]
    for _arrays, meta in runs["tp_pair"]:
        assert meta["losses"] == one_meta["losses"]
    names = [k[len("param."):] for k in one_arrays if k.startswith("param.")]
    assert names
    for name in names:
        np.testing.assert_array_equal(_whole(runs["tp_pair"], name),
                                      one_arrays["param." + name],
                                      err_msg=name)


def test_ulysses_over_two_processes_is_bit_equal_to_one(runs):
    """Each head shard attends over the whole sequence in the same
    arithmetic wherever it runs; the exchange moves bytes. The output and
    the q / k / v gradients of each process's slab equal the one-process
    run's halves bit for bit."""
    one = runs["uly_one"][0][0]
    for rank, (arrays, _meta) in enumerate(runs["uly_pair"]):
        for key in ("uly_out", "uly_dq", "uly_dk", "uly_dv"):
            half = one[key][:, rank * 32:(rank + 1) * 32]
            np.testing.assert_array_equal(arrays[key], half, err_msg=key)


def test_ulysses_losses_match_the_one_process_run(runs):
    """The pair's loss is each process's share of the sequence's mean,
    summed: another order than one process's, f32 rounding only on step 1
    (1e-6 relative); steps 2-3 start from params updated with gradients
    summed in another order (a near-zero element can flip sign and move 2
    lr): 5e-3 absolute, as tests/test_torch_ring_multiprocess.py holds
    the ring."""
    one = runs["uly_one"][0][1]["losses"]
    for _arrays, meta in runs["uly_pair"]:
        np.testing.assert_allclose(meta["losses"][0], one[0], rtol=1e-6)
        np.testing.assert_allclose(meta["losses"], one, rtol=0, atol=5e-3)


def test_a_tp2_checkpoint_restores_at_tp1_bit_equal(runs):
    """The pair wrote whole arrays (each split param gathered over the
    model group); one process at --tensor-parallel 1 restores step 3 into
    the unsplit model: every param bit-equal to the pair's joined parts."""
    arrays, meta = runs["restore_tp1"][0]
    assert meta["restored"] == [3] and meta["losses"] == []
    assert meta["tp_dims"] == {}
    for key, got in arrays.items():
        if key.startswith("param."):
            np.testing.assert_array_equal(
                got, _whole(runs["tp_pair"], key[len("param."):]),
                err_msg=key)
