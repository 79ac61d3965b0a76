"""The port's pipeline over processes: stages handed on point to point
(``batch_isend_irecv``), tensor-parallel shards reduced over model groups
and data ranks reduced, against one process holding every stage and
shard.

On the CPU the processes form a gloo group (``bootstrap.initialize`` from
the operator's ``JAX_*`` env), each with one intra-op thread so that the
CPU kernels round alike in each. A module-scoped run starts eleven
interpreters: two at ``--pipeline 2`` (one stage each; they also run data
2 at ``--tensor-parallel 2`` with both shards in each process), four at
``--pipeline 2`` over data 2, four at ``--pipeline 2
--tensor-parallel 2`` (pipe 2 x model 2) that also run data 2 x model 2
with ``--zero1``, and one holding everything. Each trains 2 steps of
every configuration it is given in f32 and saves the losses, the first
step's gradients and the params after the steps (a process saves the
stages and model parts it holds), then saves a checkpoint under its
layout, restores it into a fresh build, and tries to restore it across
another ``--pipeline``. Then one process restores each checkpoint of the
tensor-parallel group at ``--tensor-parallel 1`` and at 2.

The card forms run the pair over NCCL on two cards in bf16, and pipe 2 x
model 2 and data 2 x model 2 on four (marker ``cuda``; each skips with
fewer cards); the suite's conftest imports JAX, which the card machine
lacks, so run them past it:

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

# label -> flags, each at --pipeline 2 unless they say otherwise.
TP2 = ["--tensor-parallel", "2", "--split-qkv", "on"]
CONFIGS = {
    "1f1b": ["--schedule", "1f1b"],
    "interleaved": ["--schedule", "1f1b-interleaved", "--virtual-stages",
                    "2"],
    "gpipe": ["--schedule", "gpipe"],
    "zero1": ["--schedule", "1f1b", "--zero1"],
    "tp_1f1b": ["--schedule", "1f1b", *TP2],
    "tp_interleaved": ["--schedule", "1f1b-interleaved",
                       "--virtual-stages", "2", *TP2],
    "tp_zero1": ["--schedule", "1f1b", "--zero1", "--pipeline", "1", *TP2],
}
# The configurations whose processes are data ranks only, each holding
# every stage and model shard.
UNIT_SHARDS = {"tp_zero1_units": "tp_zero1"}

SCRIPT = textwrap.dedent('''
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, sys.argv[1])
    from tpu_operator_torch.payload import bootstrap, checkpoint, pipeline

    out, device, dtype, ckroot = sys.argv[2:6]
    configs = json.loads(sys.argv[6])
    units = json.loads(sys.argv[7])
    tag = sys.argv[8]

    def argv(flags, pipe="2", micro="4"):
        return ["--batch", "8", "--seq-len", "32", "--dim", "32", "--heads",
                "2", "--layers", "4", "--pipeline", pipe, "--microbatches",
                micro, "--dtype", dtype, "--lr", "1e-2", "--seed", "0",
                "--device", device, "--checkpoint-dir", "",
                "--profile-dir", ""] + flags

    def host(t):
        return t.detach().float().cpu().numpy().copy()

    def build(label, flags, **over):
        args = pipeline.parse_args(argv(flags, **over))
        mesh = None
        if label in units:
            # Data ranks only, each holding every stage and model shard
            # (the data group is the world: None).
            mesh = pipeline.PipeMesh(
                torch.distributed.get_world_size(),
                torch.distributed.get_rank(), args.pipeline, 1,
                tp_shards=args.tensor_parallel)
        return pipeline.build(args, mesh=mesh)

    def payload(info):
        torch.backends.cuda.matmul.allow_tf32 = False
        world, rank = info.num_processes, info.process_id
        saved = {}
        for label, flags in configs.items():
            built = build(label, flags)
            mesh = built.mesh
            saved[label + ".mesh"] = np.array(list(mesh[:4]))
            saved[label + ".layout"] = np.array(
                [mesh.data_rank, mesh.pipe_rank, mesh.model_rank,
                 mesh.procs, mesh.model_procs, built.model.stack_dim])
            for n, (dim, sections) in built.model.tp_dims().items():
                saved[f"{label}.split.{n}"] = np.array([dim, sections])
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
            fresh = build(label, flags)
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
            other_pipe = "2" if "--pipeline" in flags else "1"
            other = build(label, flags + ["--pipeline", other_pipe],
                          micro="1")
            ck = checkpoint.Checkpointer(ckdir, save_every=1)
            try:
                ck.restore(other.state)
                refused = False
            except checkpoint.CheckpointError as e:
                refused = "pipeline" in str(e)
            ck.close()
            saved[label + ".cross_layout_refused"] = np.bool_(refused)
        np.savez(f"{out}/{tag}.npz", **saved)

    sys.exit(bootstrap.run_payload(payload, device=device))
''')


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _launch(out: Path, device: str, dtype: str, groups: dict) -> dict:
    """{(group, rank): arrays} of every group in ``groups`` (key -> (world,
    config labels); a world alone is its own key), each group on a port
    and checkpoint root of its own."""
    procs = {}
    for key, labels in groups.items():
        world, labels = labels if isinstance(labels, tuple) else (key,
                                                                  labels)
        port = _free_port()
        configs = {k: CONFIGS[UNIT_SHARDS.get(k, k)] for k in labels}
        units = [k for k in labels if k in UNIT_SHARDS]
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
            procs[(key, rank)] = subprocess.Popen(
                [sys.executable, "-c", SCRIPT, str(REPO), str(out), device,
                 dtype, str(out / f"ck{key}"), json.dumps(configs),
                 json.dumps(units), f"w{key}r{rank}"],
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
    for (key, rank), proc in procs.items():
        assert proc.returncode == 0, logs[(key, rank)][-3000:]
        result[(key, rank)] = dict(np.load(out / f"w{key}r{rank}.npz"))
    return result


# One process restores a checkpoint of the tensor-parallel group at
# --tensor-parallel 1 and at 2 and saves what each holds.
RESTORE_SCRIPT = textwrap.dedent('''
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, sys.argv[1])
    from tpu_operator_torch.payload import bootstrap, checkpoint, pipeline

    out, ckroot = sys.argv[2], sys.argv[3]
    configs = json.loads(sys.argv[4])

    def payload(info):
        saved = {}
        for label, flags in configs.items():
            for tp in ("1", "2"):
                args = pipeline.parse_args(
                    ["--batch", "8", "--seq-len", "32", "--dim", "32",
                     "--heads", "2", "--layers", "4", "--pipeline", "2",
                     "--microbatches", "4", "--dtype", "f32", "--lr", "1e-2",
                     "--seed", "0", "--device", "cpu", "--checkpoint-dir",
                     "", "--profile-dir", ""] + flags
                    + ["--tensor-parallel", tp])
                built = pipeline.build(args)
                ck = checkpoint.Checkpointer(f"{ckroot}/{label}",
                                             save_every=1)
                _state, start = ck.restore(built.state)
                ck.close()
                saved[f"{label}.tp{tp}.start"] = np.int64(start)
                for n, p in built.model.params.items():
                    saved[f"{label}.tp{tp}.param.{n}"] = p.detach().numpy().copy()
                for n, t in built.opt_state.state_dict().items():
                    saved[f"{label}.tp{tp}.opt.{n}"] = t.numpy().copy()
        np.savez(f"{out}/restored.npz", **saved)

    sys.exit(bootstrap.run_payload(payload, device="cpu"))
''')
TP_LABELS = ["tp_1f1b", "tp_interleaved", "tp_zero1"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipe_gloo")
    result = _launch(out, "cpu", "f32",
                     {2: ["1f1b", "interleaved", "gpipe", "tp_zero1_units"],
                      4: ["1f1b", "zero1"],
                      "4tp": (4, TP_LABELS),
                      1: ["1f1b", "interleaved", "gpipe", *TP_LABELS]})
    env = dict(os.environ, JAX_NUM_PROCESSES="1", JAX_PROCESS_ID="0",
               JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}",
               OMP_NUM_THREADS="1")
    env.pop("TPUJOB_STATUS_URL", None)
    env.pop("TPU_CHECKPOINT_DIR", None)
    flags = {k: CONFIGS[k][:-len(TP2)] + ["--split-qkv", "on"]
             for k in TP_LABELS}
    done = subprocess.run(
        [sys.executable, "-c", RESTORE_SCRIPT, str(REPO), str(out),
         str(out / "ck4tp"), json.dumps(flags)],
        env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert done.returncode == 0, (done.stdout + done.stderr)[-3000:]
    result["restored"] = dict(np.load(out / "restored.npz"))
    return result


@pytest.fixture(scope="module")
def card_runs(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA cards")
    from tpu_operator_torch.kernels import build

    build.library()  # once, before the workers load it
    return _launch(tmp_path_factory.mktemp("pipe_nccl"), "cuda", "bf16",
                   {2: ["1f1b", "interleaved"], 1: ["1f1b", "interleaved"]})


@pytest.fixture(scope="module")
def card_tp_runs(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards")
    from tpu_operator_torch.kernels import build

    build.library()  # once, before the workers load it
    return _launch(tmp_path_factory.mktemp("pipe_tp_nccl"), "cuda", "bf16",
                   {"4tp": (4, ["tp_1f1b", "tp_zero1"]),
                    2: ["tp_zero1_units"], 1: ["tp_1f1b"]})


def _stage_key(key: str) -> bool:
    return key.startswith(("param.stages.", "grad.stages."))


def _group(runs, key) -> list:
    """The arrays of every process of group ``key``, in rank order."""
    return [runs[(key, r)] for r in range(len(runs))
            if (key, r) in runs]


def _whole(group, label: str, key: str) -> np.ndarray:
    """A group's value of ``label.key`` as one process holding every stage
    and shard would hold it: from the processes of data rank 0, each pipe
    rank's model parts joined along their split dim (each of a fused
    ``qkv``'s thirds on its own), then the pipe ranks' stacks along the
    pipe dim; anything else as the group's process 0 holds it."""
    if not _stage_key(key):
        return group[0][f"{label}.{key}"]
    at = {tuple(int(x) for x in r[label + ".layout"][:3]): r for r in group}
    procs, mprocs, stack = (int(x) for x in group[0][label + ".layout"][3:])
    split = group[0].get(f"{label}.split.{key.split('.', 1)[1]}")
    pieces = []
    for p in range(procs):
        parts = [at[(0, p, m)][f"{label}.{key}"] for m in range(mprocs)]
        if split is None or mprocs == 1:
            pieces.append(parts[0])
            continue
        dim, sections = (int(x) for x in split)
        pieces.append(np.concatenate(
            [np.concatenate([np.split(x, sections, axis=dim)[j]
                             for x in parts], axis=dim)
             for j in range(sections)], axis=dim))
    return np.concatenate(pieces, axis=stack)


def _check_against(runs, key, labels, tol: float, param_tol: float,
                   ref_key=1, ref_of=lambda label: label) -> None:
    """Group ``key`` against group ``ref_key`` (default: one process) in
    each of ``labels`` (the reference's config ``ref_of(label)``): every
    loss and the first step's gradients within ``tol`` of each value's
    largest entry, the params after 2 steps within ``param_tol`` of max(1,
    their largest entry) (0: bit-equal); every process of the group logs
    the same losses, restores its save bit-equal and refuses a restore
    across another ``--pipeline``."""
    group, ref_group = _group(runs, key), _group(runs, ref_key)
    for label in labels:
        ref = ref_of(label)
        for i in range(2):
            got = [r[f"{label}.loss{i}"] for r in group]
            assert all(float(g) == float(got[0]) for g in got)
            assert abs(float(got[0]) - float(ref_group[0][f"{ref}.loss{i}"])) \
                <= tol * abs(float(got[0])), (label, i)
        keys = [k[len(ref) + 1:] for k in ref_group[0]
                if k.startswith(ref + ".") and (".grad." in k
                                                or ".param." in k)]
        assert any("stages" in k for k in keys)
        for k in keys:
            got, want = _whole(group, label, k), _whole(ref_group, ref, k)
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
        for r in group:
            assert bool(r[label + ".restored_bit_equal"])
            assert bool(r[label + ".cross_layout_refused"])


def test_pipe_pair_is_bit_equal_to_one_process(runs):
    """--pipeline 2 over two processes (activations and cotangents sent
    point to point; the replicated gradients summed with zeros) against
    one process holding both stages: bit-equal under 1f1b, interleaved V
    2 and gpipe; a save under pipe 2 restores bit-equal, and a restore at
    --pipeline 1 is refused."""
    labels = ["1f1b", "interleaved", "gpipe"]
    for label in labels:
        for r in range(2):
            assert list(runs[(2, r)][label + ".mesh"]) == [2, r, 2, 2]
    _check_against(runs, 2, labels, 0.0, 0.0)


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
    for label in ("1f1b", "zero1"):
        for r in range(4):
            assert list(runs[(4, r)][label + ".mesh"]) == [4, r, 2, 2]
    _check_against(runs, 4, ["1f1b", "zero1"], 1e-6, 1e-5,
                   ref_of=lambda label: "1f1b")


def test_pipe_and_model_are_bit_equal_to_one_process(runs):
    """--pipeline 2 --tensor-parallel 2 over four processes (pipe 2 x
    model 2: each process one stage and one shard, the row-parallel
    partials summed over its model pair, the hand-offs to the same model
    rank of the next stage) against one process holding both stages and
    both shards: bit-equal under 1f1b and interleaved V 2 (a sum of two
    f32 values is the same in either order); each process restores its
    save bit-equal and refuses a restore at --pipeline 1."""
    group = _group(runs, "4tp")
    for label in ("tp_1f1b", "tp_interleaved"):
        assert [list(r[label + ".layout"][:5]) for r in group] == [
            [0, p, m, 2, 2] for p in range(2) for m in range(2)]
    _check_against(runs, "4tp", ["tp_1f1b", "tp_interleaved"], 0.0, 0.0)


def test_data_and_model_zero1_match_the_shards_as_units(runs):
    """--pipeline 1 --tensor-parallel 2 --zero1 over four processes (data
    2 x model 2) against two processes at data 2 that each hold both
    shards as units: bit-equal (the same half batches, the same f32 sums
    over the data pair); against one process holding everything within
    the data 2 x pipe 2 bounds (1e-6 and 1e-5: two half batches against
    one). The ZeRO-1 dim skips the model split, so the units layout splits
    the moments on the same dim."""
    group = _group(runs, "4tp")
    assert [list(r["tp_zero1.layout"][:5]) for r in group] == [
        [d, 0, m, 1, 2] for d in range(2) for m in range(2)]
    assert [list(r["tp_zero1_units.layout"][:5]) for r in _group(runs, 2)] \
        == [[d, 0, 0, 1, 1] for d in range(2)]
    _check_against(runs, "4tp", ["tp_zero1"], 0.0, 0.0, ref_key=2,
                   ref_of=lambda label: "tp_zero1_units")
    _check_against(runs, "4tp", ["tp_zero1"], 1e-6, 1e-5)


@pytest.mark.parametrize("label", TP_LABELS)
def test_tp2_checkpoint_restores_at_tp1_bit_equal(runs, label):
    """Each tensor-parallel group's step-2 save (whole arrays gathered from
    the model pairs, and from the data pair's ZeRO-1 parts) restored by
    one process at --tensor-parallel 1 and at 2: the params and the adam
    state bit-equal between the two, and the params bit-equal to the
    group's own after its 2 steps."""
    got = runs["restored"]
    assert int(got[f"{label}.tp1.start"]) == int(got[f"{label}.tp2.start"]) \
        == 2
    keys = [k[len(label) + 5:] for k in got
            if k.startswith(f"{label}.tp1.") and not k.endswith(".start")]
    assert any(k.startswith("opt.") for k in keys)
    for k in keys:
        np.testing.assert_array_equal(got[f"{label}.tp1.{k}"],
                                      got[f"{label}.tp2.{k}"], err_msg=k)
        if k.startswith("param."):
            np.testing.assert_array_equal(
                got[f"{label}.tp1.{k}"], _whole(_group(runs, "4tp"), label, k),
                err_msg=k)


@pytest.mark.cuda
def test_pipe_pair_over_nccl(card_runs):
    """The pair on two cards over NCCL in bf16 (K1 and K2 through the
    padded path at head dim 16) against one card: within 1e-6 (the same
    kernels on the same inputs; the bound allows a reordered f32 sum)."""
    _check_against(card_runs, 2, ["1f1b", "interleaved"], 1e-6, 1e-6)


@pytest.mark.cuda
def test_pipe_and_model_over_nccl(card_tp_runs):
    """Pipe 2 x model 2 on four cards over NCCL in bf16 (K1 and K2 at one
    head of dim 16 a shard, through the padded path) against one card
    holding both stages and shards, and data 2 x model 2 with --zero1
    against two cards each holding both shards: within 1e-6 (the same
    kernels on the same inputs; the bound allows a reordered f32 sum)."""
    _check_against(card_tp_runs, "4tp", ["tp_1f1b"], 1e-6, 1e-6)
    _check_against(card_tp_runs, "4tp", ["tp_zero1"], 1e-6, 1e-6,
                   ref_key=2, ref_of=lambda label: "tp_zero1_units")
