"""The port's expert parallelism: two processes at ``--expert-parallel 2``
(each holding half the experts of every MoE layer and half of every
batch, the expert slots exchanged by all-to-all) against one process at
``--expert-parallel 1`` holding everything; and EP x TP: four processes
at ``--expert-parallel 2 --tensor-parallel 2`` (expert 2 x model 2, each
model pair sharing a batch half) against two processes that each hold
both tensor-parallel shards of their experts as units, and against one
process holding everything, with a TP 2 save restored at TP 1.

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

(the EP x TP form needs four cards).
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


# --- EP x TP ---------------------------------------------------------------------

# Each process trains 2 steps of the tiny EP x TP LM (f32, einsum) on the
# mesh its group asks for, saves what it holds and where it sits, saves a
# checkpoint and restores it into a fresh build; a ``restore`` group of
# one process instead restores the four-process group's checkpoint at
# --expert-parallel 1 --tensor-parallel 1 and at 2 x 2.
TP_SCRIPT = textwrap.dedent('''
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, sys.argv[1])
    from tpu_operator_torch.payload import bootstrap, checkpoint, moe

    out, tag, device, ckdir = sys.argv[2:6]
    mode, units = sys.argv[6], json.loads(sys.argv[7])

    def args_at(ep, tp):
        return moe.parse_args(
            ["--batch", "4", "--seq-len", "32", "--dim", "32", "--heads",
             "2", "--layers", "2", "--experts", "4", "--capacity-factor",
             "1.0", "--dtype", "f32", "--lr", "1e-2", "--seed", "0",
             "--split-qkv", "on", "--expert-parallel", str(ep),
             "--tensor-parallel", str(tp), "--device", device,
             "--checkpoint-dir", "", "--profile-dir", ""])

    def host(t):
        return t.detach().float().cpu().numpy().copy()

    def build(ep, tp):
        args = args_at(ep, tp)
        mesh = None
        if units:
            # Expert ranks only, each holding both model shards of its
            # experts (the expert and dense groups are the world: None).
            world = torch.distributed.get_world_size()
            mesh = moe.MoEMesh(world, torch.distributed.get_rank(), ep,
                               world, tp_shards=tp)
        return moe.build(args, mesh=mesh)

    def restore(info):
        saved = {}
        for ep_tp in (1, 2):
            built = build(ep_tp, ep_tp)
            ck = checkpoint.Checkpointer(ckdir, save_every=1)
            _state, start = ck.restore(built.state)
            ck.close()
            saved[f"tp{ep_tp}.start"] = np.int64(start)
            for n, p in built.model.named_parameters():
                saved[f"tp{ep_tp}.param.{n}"] = host(p)
            for n, t in built.opt_state.state_dict().items():
                saved[f"tp{ep_tp}.opt.{n}"] = host(t)
        np.savez(f"{out}/{tag}.npz", **saved)

    def train(info):
        torch.backends.cuda.matmul.allow_tf32 = False
        built = build(2, 2)
        mesh, model = built.mesh, built.model
        saved = {"layout": np.array(
            [mesh.batch_rank, mesh.expert_rank, mesh.model_rank,
             mesh.procs, mesh.model_procs])}
        for n, (dim, sections) in model.tp_dims().items():
            saved["split." + n] = np.array([dim, sections])
        for i in range(2):
            (tokens,) = next(built.batches)
            saved[f"rows{i}"] = np.int64(tokens.shape[0])
            m = built.step(torch.from_numpy(tokens).to(built.device))
            for k, v in m.items():
                saved[f"{k}{i}"] = np.float32(float(v))
            if i == 0:
                for n, p in model.named_parameters():
                    saved["grad." + n] = host(p.grad)
        for n, p in model.named_parameters():
            saved["param." + n] = host(p)
        ck = checkpoint.Checkpointer(ckdir, save_every=1)
        ck.save(2, built.state)
        ck.close()
        fresh = build(2, 2)
        ck = checkpoint.Checkpointer(ckdir, save_every=1)
        _state, start = ck.restore(fresh.state)
        ck.close()
        live, got = built.state, fresh.state
        same = start == 2 and all(
            torch.equal(p, got.params[n]) for n, p in live.params.items())
        mine = got.opt.state_dict()
        same = same and all(torch.equal(t, mine[n]) for n, t
                            in live.opt.state_dict().items())
        saved["restored_bit_equal"] = np.bool_(same)
        np.savez(f"{out}/{tag}.npz", **saved)

    sys.exit(bootstrap.run_payload(restore if mode == "restore" else train,
                                   device=device))
''')


def _launch_tp(out: Path, device: str, groups: dict) -> dict:
    """{(group, rank): arrays} of the groups ``{key: (world, mode, whether
    each process holds every model shard)}``, each on a port of its own,
    started together;
    the four-process group saves its checkpoint to ``out / "ckep2tp2"``,
    which a ``restore`` group reads."""
    procs = {}
    for key, (world, mode, units) in groups.items():
        port = _free_port()
        for rank in range(world):
            env = dict(os.environ,
                       JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       JAX_PROCESS_ID=str(rank), JAX_NUM_PROCESSES=str(world),
                       OMP_NUM_THREADS="1")
            env.pop("TPUJOB_STATUS_URL", None)
            env.pop("TPU_CHECKPOINT_DIR", None)
            if device == "cuda":
                env["CUDA_VISIBLE_DEVICES"] = ",".join(
                    str(i) for i in range(world))
            ckdir = out / ("ckep2tp2" if mode == "restore" else f"ck{key}")
            procs[(key, rank)] = subprocess.Popen(
                [sys.executable, "-c", TP_SCRIPT, str(REPO), str(out),
                 f"{key}r{rank}", device, str(ckdir), mode,
                 json.dumps(units)], env=env,
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
    for (key, rank), proc in procs.items():
        assert proc.returncode == 0, logs[(key, rank)][-3000:]
        result[(key, rank)] = dict(np.load(out / f"{key}r{rank}.npz"))
    return result


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_tp_gloo")
    result = _launch_tp(out, "cpu", {"ep2tp2": (4, "train", False),
                                     "units": (2, "train", True),
                                     "one": (1, "train", False)})
    result.update(_launch_tp(out, "cpu", {"restore": (1, "restore", False)}))
    return result


@pytest.fixture(scope="module")
def card_tp_runs(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards")
    from tpu_operator_torch.kernels import build

    build.library()  # once, before the workers load it
    return _launch_tp(tmp_path_factory.mktemp("moe_tp_nccl"), "cuda",
                      {"ep2tp2": (4, "train", False),
                       "units": (2, "train", True)})


def _tp_group(runs, key) -> list:
    return [runs[(key, r)] for r in range(4) if (key, r) in runs]


def _tp_whole(group, key: str) -> np.ndarray:
    """A group's value of ``key`` as one process holding every expert and
    shard would hold it: from the processes of batch shard 0's expert
    group, each expert rank's model parts joined along their split dim
    (each of a fused ``qkv``'s thirds on its own), then an expert stack's
    expert ranks along dim 0."""
    at = {tuple(int(x) for x in r["layout"][1:3]): r for r in group
          if int(r["layout"][0]) < int(r["layout"][3])}
    procs, mprocs = (int(x) for x in group[0]["layout"][3:])
    name = key.split(".", 1)[1]
    split = group[0].get("split." + name)
    expert = name.split(".")[-2:-1] == ["moe"] and name.endswith(("w1", "w2"))
    pieces = []
    for e in range(procs if expert else 1):
        parts = [at[(e, m)][key] for m in range(mprocs)]
        if split is None or mprocs == 1:
            pieces.append(parts[0])
            continue
        dim, sections = (int(x) for x in split)
        pieces.append(np.concatenate(
            [np.concatenate([np.split(x, sections, axis=dim)[j]
                             for x in parts], axis=dim)
             for j in range(sections)], axis=dim))
    return np.concatenate(pieces)


def check_tp_against(runs, key, ref_key, loss_tol: float,
                     param_tol: float) -> None:
    """Group ``key`` against group ``ref_key``: each metric within
    ``loss_tol``, the first step's gradients within ``param_tol`` of their
    largest entry and the params after 2 steps within ``param_tol`` of
    max(1, their largest entry) (0: bit-equal); every process of ``key``
    reports the same metrics and restores its save bit-equal."""
    group, ref = _tp_group(runs, key), _tp_group(runs, ref_key)
    for i in range(2):
        for k in ("loss", "aux_loss", "router_z", "drop_frac", "total_loss"):
            got = [float(r[f"{k}{i}"]) for r in group]
            assert all(g == got[0] for g in got), (k, i)
            assert abs(got[0] - float(ref[0][f"{k}{i}"])) <= loss_tol, (k, i)
    keys = [k for k in ref[0] if k.startswith(("grad.", "param."))]
    assert any(".moe.w1" in k for k in keys)
    for k in keys:
        got, want = _tp_whole(group, k), _tp_whole(ref, k)
        assert got.shape == want.shape, k
        scale = max(float(np.abs(want).max()), 1.0) \
            if k.startswith("param.") else float(np.abs(want).max())
        if param_tol == 0:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=param_tol * scale, err_msg=k)
    for r in group:
        assert bool(r["restored_bit_equal"])


def test_expert_and_model_are_bit_equal_to_the_shards_as_units(tp_runs):
    """Expert 2 x model 2 over four processes (the experts' hidden units
    and the dense blocks split over each model pair, which shares a batch
    half; the w2 partials and the experts' input gradients summed over
    it) against two processes that each hold both shards as units:
    bit-equal (a sum of two f32 values is the same in either order); each
    process reports the same metrics and restores its save bit-equal."""
    group = _tp_group(tp_runs, "ep2tp2")
    assert [list(r["layout"]) for r in group] == [
        [e, e, m, 2, 2] for e in range(2) for m in range(2)]
    assert [list(r["layout"]) for r in _tp_group(tp_runs, "units")] == [
        [e, e, 0, 2, 1] for e in range(2)]
    assert [int(r["rows0"]) for r in group] == [2, 2, 2, 2]
    check_tp_against(tp_runs, "ep2tp2", "units", 0.0, 0.0)


def test_expert_and_model_match_one_process(tp_runs):
    """The same four processes against one process holding every expert
    and shard: the bounds of the EP pair (two half batches against one)."""
    assert int(tp_runs[("one", 0)]["rows0"]) == 4
    check_tp_against(tp_runs, "ep2tp2", "one", 1e-6, 1e-5)


def test_ep2_tp2_checkpoint_restores_at_ep1_tp1_bit_equal(tp_runs):
    """The four-process save (whole stacks and weights gathered over the
    expert and model groups) restored by one process at EP 1 x TP 1 and
    at EP 2 x TP 2: params and adam state bit-equal between the two, and
    the params bit-equal to the four processes' own after their steps."""
    got = tp_runs[("restore", 0)]
    assert int(got["tp1.start"]) == int(got["tp2.start"]) == 2
    keys = [k[4:] for k in got
            if k.startswith("tp1.") and not k.endswith(".start")]
    assert any(k.startswith("opt.") for k in keys)
    group = _tp_group(tp_runs, "ep2tp2")
    for k in keys:
        np.testing.assert_array_equal(got["tp1." + k], got["tp2." + k],
                                      err_msg=k)
        if k.startswith("param."):
            np.testing.assert_array_equal(got["tp1." + k],
                                          _tp_whole(group, k), err_msg=k)


@pytest.mark.cuda
def test_expert_and_model_over_nccl(card_tp_runs):
    """Expert 2 x model 2 on four cards over NCCL (f32 products on cuBLAS,
    no TF32) against two cards each holding both shards: within 1e-6."""
    check_tp_against(card_tp_runs, "ep2tp2", "units", 1e-6, 1e-6)
