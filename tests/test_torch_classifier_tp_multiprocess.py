"""The port's classifier under tensor parallelism across processes on the
CPU: gloo groups (``bootstrap.initialize`` from the operator's ``JAX_*``
env) at ``--model-parallel 2``, against the same shards held as units.

Five layouts of ResNet-8 at widths 8/16/16 (batch 16, sgd 0.1 / 0.9,
bf16 convolutions; ``d2m2`` and ``m1`` again with f32 ones), started
together, each process with one intra-op thread:

- ``m2``: two processes, one model shard each (the stage-2 channels and
  the head's classes split between them; data 1);
- ``m2_units``: one process holding both shards;
- ``d2m2``: four processes, data 2 x model 2;
- ``d2_units``: two processes, data 2, each holding both shards (a
  ``cifar.CifarMesh`` built by hand: one process a model group);
- ``m1``: one process at ``--model-parallel 1``.

Each process saves its first step's loss, its gradients and new
BatchNorm statistics, and its params after two steps; ``m2`` also saves
a checkpoint after its second step, tries an adam8 state, and its rank
0 trains both shards alone on a one-process mesh inside the group. The per-shard products run at the
same shapes in every layout and the collectives of two processes sum two
values, so a layout and its units are bit-equal. The join before a
stage-2 conv must sum its input's gradient over the model group before
it keeps this process's part: without that sum the stem and stage-0/1
gradients come out as a fraction of one process's. BatchNorm's sums must
run over the processes that hold the same model rank, or a channel is
added to another shard's channel.
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
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, sys.argv[1])
    from tpu_operator_torch.payload import bootstrap, checkpoint, cifar
    from tpu_operator_torch.payload import models

    out, layout = sys.argv[2], sys.argv[3]
    if sys.argv[4] == "f32":
        models.COMPUTE_DTYPE = torch.float32
    ARGS = ["--batch", "16", "--blocks", "1", "--widths", "8", "16", "16",
            "--seed", "0", "--device", "cpu", "--checkpoint-dir", "",
            "--profile-dir", "", "--model-parallel",
            "1" if layout == "m1" else "2"]

    def payload(info):
        rank = info.process_id
        mesh = None
        if layout == "d2_units":
            mesh = cifar.CifarMesh(info.num_processes, rank, 1, 2)
        built = cifar.build(cifar.parse_args(ARGS), mesh=mesh)
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
                    saved["grad." + n] = p.grad.numpy().copy()
                for n, b in built.model.named_buffers():
                    saved["stat." + n] = b.numpy().copy()
        for n, p in built.model.named_parameters():
            saved["param." + n] = p.detach().numpy()
        for n, b in built.model.named_buffers():
            saved["final_stat." + n] = b.numpy().copy()
        for n, t in built.opt_state.state_dict().items():
            saved["opt." + n] = t.numpy().copy()
        if layout == "m2":
            ck = checkpoint.Checkpointer(f"{out}/ckpt")
            try:
                ck.save(2, built.state)
                ck.flush()
            finally:
                ck.close()
            if rank == 0:
                # Both shards on rank 0 alone, inside the group: nothing
                # may reduce over the other process.
                alone = cifar.build(cifar.parse_args(ARGS),
                                    mesh=cifar.CifarMesh(1, 0, 1, 2))
                for i in range(2):
                    x, y = next(alone.batches)
                    m = alone.step(torch.from_numpy(x), torch.from_numpy(y))
                    saved[f"alone_loss{i}"] = np.float32(m["loss"])
                for n, p in alone.model.named_parameters():
                    saved["alone_param." + n] = p.detach().numpy()
            adam8 = cifar.build(cifar.parse_args(ARGS + ["--optimizer",
                                                         "adam8"]))
            try:
                adam8.state
            except ValueError as e:
                saved["adam8_refused"] = np.array(str(e))
        np.savez(f"{out}/{layout}_r{rank}.npz", **saved)

    sys.exit(bootstrap.run_payload(payload, device="cpu"))
''')

LAYOUTS = {"m2": 2, "m2_units": 1, "d2m2": 4, "d2_units": 2, "m1": 1}


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _launch(tmp_path_factory, dtype, layouts):
    """(output dir, compute dtype, {layout: [arrays of each rank]}) of
    ``layouts``, every process started at once."""
    out = tmp_path_factory.mktemp("cifar_tp_gloo")
    procs = {}
    for layout in layouts:
        world = LAYOUTS[layout]
        port = _free_port()
        for rank in range(world):
            env = dict(os.environ,
                       JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       JAX_PROCESS_ID=str(rank),
                       JAX_NUM_PROCESSES=str(world), OMP_NUM_THREADS="1")
            env.pop("TPUJOB_STATUS_URL", None)
            env.pop("TPU_CHECKPOINT_DIR", None)
            procs[(layout, rank)] = subprocess.Popen(
                [sys.executable, "-c", SCRIPT, str(REPO), str(out), layout,
                 dtype],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    logs = {}
    try:
        for key, proc in procs.items():
            logs[key] = proc.communicate(timeout=TIMEOUT)[0]
    except subprocess.TimeoutExpired:
        for proc in procs.values():
            proc.kill()
        pytest.fail(f"the gloo runs did not finish in {TIMEOUT} s")
    result = {}
    for (layout, rank), proc in procs.items():
        path = out / f"{layout}_r{rank}.npz"
        assert proc.returncode == 0 and path.exists(), \
            logs[(layout, rank)][-3000:]
        result.setdefault(layout, []).append(dict(np.load(path)))
    return out, dtype, result


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every layout as the payload runs (bf16 convolutions)."""
    return _launch(tmp_path_factory, "bf16", LAYOUTS)


@pytest.fixture(scope="module", params=["bf16", "f32"])
def against_one(request, tmp_path_factory, runs):
    """Data 2 x model 2 and one process at model 1, as the payload runs
    and with the convolutions in f32."""
    if request.param == "bf16":
        return runs
    return _launch(tmp_path_factory, "f32", ("d2m2", "m1"))


SPLIT_PREFIXES = ("stage2_block0.", "head.")


def _whole(parts, key):
    """The whole of a tensor from the model ranks' parts (dim 0 for the
    split stage-2 and head tensors; every rank holds all of the rest)."""
    name = key.split(".", 1)[1]
    if name.startswith(SPLIT_PREFIXES):
        return np.concatenate([p[key] for p in parts])
    return parts[0][key]


def _assert_layout_equal(parts, whole, prefixes):
    keys = [k for k in whole if k.startswith(prefixes)]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(_whole(parts, k), whole[k], err_msg=k)


def test_layouts_take_their_rows(runs):
    _out, _dtype, runs = runs
    rows = {layout: [int(r["rows0"]) for r in ranks]
            for layout, ranks in runs.items()}
    assert rows == {"m2": [16, 16], "m2_units": [16], "d2m2": [8] * 4,
                    "d2_units": [8, 8], "m1": [16]}


def test_model_2_over_two_processes_is_bit_equal_to_the_units(runs):
    """Two processes, one shard each, against one process holding both:
    the losses, every gradient of the first step (the stem's and stage
    0/1's among them: the join's backward summed over the model group),
    the new BatchNorm statistics (each shard's channels over its own rows)
    and the params, statistics and sgd traces after two steps, joined
    from the two parts, bit-equal."""
    _out, _dtype, runs = runs
    parts, whole = runs["m2"], runs["m2_units"][0]
    for r in parts:
        for k in ("loss0", "loss1", "accuracy0", "accuracy1"):
            assert r[k] == whole[k], k
    _assert_layout_equal(parts, whole, ("grad.", "stat.", "param.",
                                        "final_stat."))
    for k in whole:
        if k.startswith("opt."):
            index = int(k.rsplit(".", 1)[1])
            name = list(n for n in whole if n.startswith("param."))[index]
            got = (np.concatenate([p[k] for p in parts])
                   if name[6:].startswith(SPLIT_PREFIXES) else parts[0][k])
            np.testing.assert_array_equal(got, whole[k], err_msg=k)


def test_one_process_holding_both_shards_inside_a_group(runs):
    """Rank 0 of the pair, with a one-process mesh built by hand inside
    its two-process group, trains what a process alone does: bit-equal
    losses and params (its BatchNorm and gradient sums reduce over no
    other process)."""
    _out, _dtype, runs = runs
    r0, alone = runs["m2"][0], runs["m2_units"][0]
    for i in range(2):
        assert r0[f"alone_loss{i}"] == alone[f"loss{i}"]
    for k in alone:
        if k.startswith("param."):
            np.testing.assert_array_equal(r0["alone_" + k], alone[k],
                                          err_msg=k)


def test_stem_gradients_and_statistics_match_one_process(runs):
    """The gather trap and the BatchNorm group, read directly: the stem's
    and stage 0's gradients on each of the two processes equal one
    process's (a join whose backward kept only this process's part of an
    unsummed gradient leaves them a fraction of it), and so does every
    running statistic, the split stage-2 ones joined."""
    _out, _dtype, runs = runs
    whole = runs["m2_units"][0]
    for r in runs["m2"]:
        for k in ("grad.stem.weight", "grad.bn_stem.scale",
                  "grad.stage0_block0.conv1.weight"):
            np.testing.assert_array_equal(r[k], whole[k], err_msg=k)
    _assert_layout_equal(runs["m2"], whole, ("stat.",))


def test_data_2_model_2_is_bit_equal_to_data_2_units(runs):
    """Four processes (data 2 x model 2) against two processes at data 2
    each holding both shards: each data rank's model group computes what
    its one process does, the gradients and BatchNorm sums reduce over
    the same data ranks, so every gradient, statistic and param is
    bit-equal (ranks 0, 1 are data rank 0's model group)."""
    _out, _dtype, runs = runs
    four, two = runs["d2m2"], runs["d2_units"]
    for data_rank in range(2):
        parts = four[2 * data_rank:2 * data_rank + 2]
        whole = two[data_rank]
        for r in parts:
            assert r["loss0"] == whole["loss0"]
            assert r["loss1"] == whole["loss1"]
        _assert_layout_equal(parts, whole, ("grad.", "stat.", "param.",
                                            "final_stat."))


# (loss rtol, grad gap / grad norm, param gap / update norm) per compute
# dtype, test_torch_classifier_multiprocess.py's BOUNDS for its data 2
# against one process: f32, the same function summed in another order;
# bf16, each data half's convolution weight gradient rounded to bf16
# before the all-reduce, where one process rounds the whole batch's once.
BOUNDS = {"f32": (1e-6, 1e-4, 1e-3), "bf16": (1e-3, 2 ** -6, 0.25)}


def test_data_2_model_2_stays_with_one_process(against_one):
    """Four processes (data 2 x model 2) against one process at
    ``--model-parallel 1`` with the whole batch (the one process of
    ``test_torch_classifier_multiprocess.py``), at its BOUNDS: the first
    loss, the statistics to 1e-4 of each leaf's largest value, each
    gradient against its norm, and each param after two steps against
    what it moved (bf16: 1.3e-2 of a BatchNorm bias's gradient and 0.165
    of a BatchNorm scale's update seen)."""
    _out, dtype, runs = against_one
    loss_tol, grad_tol, param_tol = BOUNDS[dtype]
    four, one = runs["d2m2"][:2], runs["m1"][0]
    np.testing.assert_allclose(four[0]["loss0"], one["loss0"],
                               rtol=loss_tol)
    np.testing.assert_allclose(four[0]["loss1"], one["loss1"],
                               rtol=loss_tol)
    for k in one:
        if not k.startswith(("stat.", "grad.", "param.")):
            continue
        got = _whole(four, k)
        if k.startswith("stat."):
            np.testing.assert_allclose(got, one[k], rtol=0,
                                       atol=1e-4 * np.abs(one[k]).max(),
                                       err_msg=k)
        elif k.startswith("grad."):
            assert np.linalg.norm(got - one[k]) <= \
                grad_tol * np.linalg.norm(one[k]), k
        else:
            moved = np.linalg.norm(one[k] - one["init." + k[6:]])
            assert np.linalg.norm(got - one[k]) <= param_tol * moved, k


def test_adam8_moments_over_the_model_group_are_refused(runs):
    """adam8's block-quantized moments do not split along a param's dims:
    with the model group over two processes the state names them as
    ``transformer.tp_shards`` does for the transformer, and refuses."""
    _out, _dtype, runs = runs
    for r in runs["m2"]:
        assert "use --optimizer adam" in str(r["adam8_refused"])


def test_model_2_save_restores_at_model_1_bit_equal(runs):
    """The step ``m2`` saved over its two processes (each split tensor
    gathered whole) restores into a ``--model-parallel 1`` build in this
    process: every param, running statistic and sgd trace equal to the
    two processes' parts joined."""
    from tpu_operator_torch.payload import checkpoint, cifar

    out, _dtype, runs = runs
    parts = runs["m2"]
    built = cifar.build(cifar.parse_args(
        ["--batch", "16", "--blocks", "1", "--widths", "8", "16", "16",
         "--seed", "1", "--device", "cpu", "--checkpoint-dir", "",
         "--profile-dir", ""]))
    ck = checkpoint.Checkpointer(str(out / "ckpt"))
    try:
        _s, step = ck.restore(built.state)
    finally:
        ck.close()
    assert step == 2
    names = [n for n, _p in built.model.named_parameters()]
    for n, p in built.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      _whole(parts, "param." + n),
                                      err_msg=n)
    for n, b in built.model.named_buffers():
        np.testing.assert_array_equal(b.numpy(),
                                      _whole(parts, "final_stat." + n),
                                      err_msg=n)
    for k, t in built.opt_state.state_dict().items():
        name = names[int(k.rsplit(".", 1)[1])]
        got = (np.concatenate([p["opt." + k] for p in parts])
               if name.startswith(SPLIT_PREFIXES) else parts[0]["opt." + k])
        assert torch.equal(t, torch.from_numpy(got)), k
