"""The transformer's ``--fsdp`` across processes (the port of
tests/test_fsdp.py): two processes in a gloo group, data 2, each holding
half of every sharded param, its gradient and its moments, against one
process without ``--fsdp``.

One process at ``--grad-accum 2K`` runs the same microbatches as data 2
at ``--grad-accum K`` (each data rank takes a contiguous half of the
rows), so the two differ only in the f32 order of the gradient sums:
data 2 sums each microbatch's two halves in the reduce-scatter, then the
microbatches, where one process sums the microbatches in turn.

Each job starts its processes with ``python -c`` of the script below
(the launcher of tests/test_torch_tp_multiprocess.py), one intra-op
thread a process, every collective under a 60 s timeout and every
process under :data:`TIMEOUT`, so that a hang fails its test. Jobs (one
module-scoped run):

1. ``pair``: two processes, each configuration of :data:`PAIR` in turn;
   ``save`` writes its step 3 to a checkpoint directory;
2. ``one``: one process, each configuration of :data:`ONE`;
3. ``restore``: one process restores the pair's step 3 without
   ``--fsdp`` and with it (data 1), and trains no step.

The card forms (marker ``cuda``) run data 4 over NCCL on four cards
against one card, and data 2 x seq 2 (the ring and Ulysses) against the
same four cards without ``--fsdp``; the suite's conftest imports JAX,
which the card machine lacks, so run them past it:

    python -m pytest tests/test_torch_fsdp_multiprocess.py \\
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
TIMEOUT = 180.0

# vocab 257: the token table's reference dim 0 is odd, so it stays whole,
# and lm_head's output rows do not split in two, so it is cut along its
# input columns (the reference's own dim).
TINY = ["--dim", "64", "--layers", "2", "--heads", "4", "--kv-heads", "2",
        "--vocab", "257", "--seq-len", "64", "--batch", "4", "--seed", "0",
        "--log-every", "0", "--checkpoint-dir", "", "--profile-dir", ""]
F = ["--fsdp"]
# label -> (flags, steps) on the pair; ONE holds each one's reference.
PAIR = {
    "save": (F + ["--grad-accum", "2", "--remat"], 3),
    "plain": (F, 2),
    "adam8": (F + ["--optimizer", "adam8"], 3),
    "mu_bf16": (F + ["--adam-mu-dtype", "bf16", "--remat", "--remat-policy",
                     "attn_block"], 3),
    "chunk": (F + ["--loss-chunk", "16", "--grad-accum", "2"], 3),
    "descend": (F + ["--lr", "1e-2", "--dim", "64", "--heads", "2",
                     "--batch", "8"], 30),
    # Each process holds a whole ring of 4 (a mesh built by hand).
    "ring": (F + ["--seq-parallel", "4"], 3),
}
ONE = {
    "save": (["--grad-accum", "4", "--remat"], 3),
    "plain": (["--grad-accum", "2"], 2),
    "adam8": (["--optimizer", "adam8", "--grad-accum", "2"], 3),
    "mu_bf16": (["--adam-mu-dtype", "bf16", "--remat", "--remat-policy",
                 "attn_block", "--grad-accum", "2"], 3),
    "chunk": (["--loss-chunk", "16", "--grad-accum", "4"], 3),
    "ring": (["--seq-parallel", "4", "--grad-accum", "2"], 3),
}
RESTORE = {"no_fsdp": ([], 3), "fsdp_data1": (F, 3)}

SCRIPT = textwrap.dedent('''
    import json, sys
    from datetime import timedelta
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    sys.path.insert(0, sys.argv[1])
    from tpu_operator_torch.payload import bootstrap, checkpoint
    from tpu_operator_torch.payload import collectives, transformer

    out, tag, device, ckdir = sys.argv[2:6]
    configs = json.loads(sys.argv[6])
    tiny = json.loads(sys.argv[7])
    restore = sys.argv[8] == "restore"
    bootstrap.GROUP_TIMEOUT = timedelta(seconds=60)

    # Gathers by the data pointer of the shard they gather, reduce-
    # scatters in all, and gradients reaching each shard (by a hook).
    calls = {"gather": {}, "scatter": {}, "grad": {}}
    gather, scatter = (collectives.FSDPShard.gather,
                       collectives.FSDPShard.scatter)

    def count(kind, key):
        calls[kind][key] = calls[kind].get(key, 0) + 1

    def counted_gather(spec, t):
        count("gather", t.data_ptr())
        return gather(spec, t)

    def counted_scatter(spec, t):
        count("scatter", "all")
        return scatter(spec, t)

    collectives.FSDPShard.gather = counted_gather
    collectives.FSDPShard.scatter = counted_scatter

    def host(t):
        return t.detach().float().cpu().numpy().copy()

    def payload(info):
        torch.backends.cuda.matmul.allow_tf32 = False
        saved, meta = {}, {}
        for label, (flags, steps) in configs.items():
            args = transformer.parse_args(tiny + ["--device", device]
                                          + flags)
            mesh = None
            if label == "ring" and info.num_processes > 1:
                mesh = transformer.LMMesh(
                    info.num_processes, info.process_id, 1,
                    args.seq_parallel, data_group=dist.group.WORLD)
            built = transformer.build(args, mesh=mesh)
            params = dict(built.model.named_parameters())
            for n, p in params.items():
                if getattr(p, "fsdp", None) is not None:
                    p.register_hook(lambda g, n=n: count("grad", n))
            if restore:
                ck = checkpoint.Checkpointer(ckdir, save_every=1)
                _state, start = ck.restore(built.state)
                ck.close()
                meta[label + ".start"] = start
            losses = []
            for i in range(0 if restore else steps):
                (tokens,) = next(built.batches)
                for kind in calls:
                    calls[kind].clear()
                m = built.step(torch.from_numpy(tokens).to(built.device))
                losses.append(float(m["loss"]))
                if i == 0:
                    by_ptr = {p.data_ptr(): n for n, p in params.items()}
                    meta[label + ".calls"] = {
                        "gather": {by_ptr[k]: v
                                   for k, v in calls["gather"].items()},
                        "scatter": calls["scatter"].get("all", 0),
                        "grad": dict(calls["grad"])}
            if label == "save" and not restore:
                ck = checkpoint.Checkpointer(ckdir, save_every=1)
                ck.save(steps, built.state)
                ck.close()
            meta[label + ".losses"] = losses
            meta[label + ".fsdp"] = {
                n: [p.fsdp.dim, p.fsdp.size, p.fsdp.rank]
                for n, p in params.items()
                if getattr(p, "fsdp", None) is not None}
            meta[label + ".data"] = max(
                [s[1] for s in meta[label + ".fsdp"].values()] or [0])
            for n, p in params.items():
                saved[f"{label}.param.{n}"] = host(p)
            names = list(params)
            for k, t in built.opt_state.state_dict().items():
                if t.dim():
                    index = int(k.rsplit(".", 1)[-1])
                    saved[f"{label}.opt.{k}"] = host(t)
                    meta[f"{label}.opt_of.{k}"] = names[index]
        np.savez(f"{out}/{tag}.npz", **saved)
        with open(f"{out}/{tag}.json", "w") as f:
            json.dump(meta, f)

    sys.exit(bootstrap.run_payload(payload, device=device))
''')


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _launch(out: Path, jobs: dict, device: str = "cpu",
            ckdir: str = "", tiny=TINY) -> dict:
    """{name: [(arrays, meta) by rank]} of ``jobs`` (name -> (world,
    configs, role)), started together, each on a port of its own."""
    procs = {}
    for name, (world, configs, role) in jobs.items():
        port = _free_port()
        for rank in range(world):
            env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       JAX_PROCESS_ID=str(rank), JAX_NUM_PROCESSES=str(world),
                       TPUJOB_ATTEMPT="0", OMP_NUM_THREADS="1")
            for var in ("TPUJOB_STATUS_URL", "TPU_CHECKPOINT_DIR",
                        "TPUJOB_STORE_URI"):
                env.pop(var, None)
            if device == "cuda":
                env["CUDA_VISIBLE_DEVICES"] = ",".join(
                    str(i) for i in range(world))
            procs[(name, rank)] = subprocess.Popen(
                [sys.executable, "-c", SCRIPT, str(REPO), str(out),
                 f"{name}-r{rank}", device, str(ckdir), json.dumps(configs),
                 json.dumps(tiny), role],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    logs = {}
    try:
        for key, proc in procs.items():
            logs[key] = proc.communicate(timeout=TIMEOUT)[0]
    except subprocess.TimeoutExpired:
        for proc in procs.values():
            proc.kill()
        pytest.fail(f"jobs {sorted(jobs)} did not finish in {TIMEOUT} s")
    result = {}
    for (name, rank), proc in sorted(procs.items()):
        assert proc.returncode == 0, logs[(name, rank)][-3000:]
        result.setdefault(name, []).append((
            dict(np.load(out / f"{name}-r{rank}.npz")),
            json.loads((out / f"{name}-r{rank}.json").read_text())))
    return result


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("fsdp_gloo")
    ck = out / "ck"
    result = _launch(out, {"pair": (2, PAIR, "run"), "one": (1, ONE, "run")},
                     ckdir=ck)
    result.update(_launch(out, {"restore": (1, RESTORE, "restore")},
                          ckdir=ck))
    return result


def _whole(group, label: str, key: str) -> np.ndarray:
    """The group's ``label.key`` (a param or an optimizer state tensor)
    as one process holds it: each process's part joined along its param's
    cut, or the one whole copy every process holds (checked equal)."""
    arrays, meta = group[0]
    param = key[len("param."):] if key.startswith("param.") \
        else meta[f"{label}.opt_of.{key[len('opt.'):]}"]
    parts = [a[f"{label}.{key}"] for a, _m in group]
    spec = meta[f"{label}.fsdp"].get(param)
    if spec is None or spec[1] == 1:
        for part in parts[1:]:
            np.testing.assert_array_equal(part, parts[0], err_msg=key)
        return parts[0]
    return np.concatenate(parts, axis=spec[0])


def _keys(group, label: str):
    return [k[len(label) + 1:] for k in group[0][0]
            if k.startswith(label + ".")]


def test_each_process_holds_half_of_every_sharded_leaf(runs):
    """At data 2 each sharded param and each of its moments is half of
    the whole along its cut, the pair holds the two halves, and every
    other leaf (below 1024 elements, or the odd-sized token table) is
    whole on both; the sharded set is train.fsdp_dims's."""
    from tpu_operator_torch.payload import train, transformer

    pair, one = runs["pair"], runs["one"][0]
    for label in ("save", "adam8"):
        specs = [m[f"{label}.fsdp"] for _a, m in pair]
        assert specs[0] and specs[0].keys() == specs[1].keys()
        for rank, spec in enumerate(specs):
            assert all(s[1:] == [2, rank] for s in spec.values())
        args = transformer.parse_args(TINY + ["--device", "cpu"]
                                      + PAIR[label][0])
        model = transformer.build_model(args, "cpu")
        want = train.fsdp_dims(model, 2, args.optimizer)
        assert {n: s[0] for n, s in specs[0].items()} == want
        assert "tok_embed.weight" not in want
        assert "blocks.0.ln_attn.weight" not in want
        for key in _keys(pair, label):
            if not key.startswith(("param.", "opt.")):
                continue
            ref = one[0][f"{label}.{key}"]
            part = pair[0][0][f"{label}.{key}"]
            param = key[6:] if key.startswith("param.") else \
                pair[0][1][f"{label}.opt_of.{key[4:]}"]
            if param in want:
                assert part.size * 2 == ref.size, key
                assert part.shape[want[param]] * 2 \
                    == ref.shape[want[param]], key
            else:
                assert part.shape == ref.shape, key
    # adam8 cuts lm_head along its last dim into 32 columns: not whole
    # blocks of 256, so it stays whole there (and is cut under adam).
    assert pair[0][1]["save.fsdp"]["lm_head.weight"][0] == 1
    assert "lm_head.weight" not in pair[0][1]["adam8.fsdp"]


def test_data_two_matches_one_process_without_fsdp(runs):
    """Every configuration on the pair against one process without
    --fsdp on the same microbatches (grad-accum remat, adam8, the bf16
    first moment under attn_block, the chunked loss, the whole ring in
    each process): the same losses to 1e-6 relative, and the params and
    moments after the steps within 1e-5 of max(1, the leaf's largest
    entry) (f32 sums in another order, carried through adam's division
    by sqrt(v); the pipeline's data 2 bound). The pair logs one
    trajectory."""
    pair, one = runs["pair"], runs["one"][0]
    for label in ONE:
        got = [m[f"{label}.losses"] for _a, m in pair]
        assert got[0] == got[1], label
        np.testing.assert_allclose(got[0], one[1][f"{label}.losses"],
                                   rtol=1e-6, atol=0, err_msg=label)
        assert pair[0][1][f"{label}.data"] == 2
        for key in _keys(pair, label):
            if not key.startswith(("param.", "opt.")):
                continue
            want = one[0][f"{label}.{key}"]
            got = _whole(pair, label, key)
            bound = 1e-5 * max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got, want, rtol=0, atol=bound,
                                       err_msg=f"{label}.{key}")


def test_the_loss_descends_over_thirty_steps(runs):
    """tests/test_fsdp.py's descent check: 30 steps at lr 1e-2 (batch 8,
    2 heads) end below 0.7 of the first loss."""
    losses = runs["pair"][0][1]["descend.losses"]
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.7, losses[::5]


def test_gathered_weights_are_gathered_again_not_kept(runs):
    """Collective calls by param in one step: without remat ("plain",
    one microbatch) a dense weight is gathered for the forward and again
    when the backward unpacks it (autograd kept the shard), an embedding
    once (its backward needs only the ids); under remat ("save": full,
    2 microbatches; "mu_bf16": attn_block, whose named regions hold the
    q / k / v and attn_out products) a block's weights are gathered again
    by the recompute, never saved by the policy.
    Every sharded param's gradient is reduce-scattered once a microbatch
    (the reduce-scatters counted, and the gradients reaching each
    shard)."""
    for label, micro in (("plain", 1), ("save", 2), ("mu_bf16", 1)):
        meta = runs["pair"][0][1]
        calls, sharded = meta[f"{label}.calls"], meta[f"{label}.fsdp"]
        assert calls["gather"].keys() == calls["grad"].keys() \
            == sharded.keys(), label
        for name in sharded:
            gathers = 1 if name.endswith("embed.weight") else 2
            assert calls["gather"][name] == gathers * micro, (label, name)
            assert calls["grad"][name] == micro, (label, name)
        assert calls["scatter"] == micro * len(sharded), label


def test_a_data_two_save_restores_at_one_process_bit_equal(runs):
    """The pair's step 3 (``save``: whole arrays, each part gathered over
    the data group) restored by one process without --fsdp and by one
    with --fsdp at data 1: every param and moment bit-equal to the pair's
    halves joined."""
    pair = runs["pair"]
    arrays, meta = runs["restore"][0]
    for label in RESTORE:
        assert meta[f"{label}.start"] == 3
        for key in _keys(pair, "save"):
            if key.startswith(("param.", "opt.")):
                np.testing.assert_array_equal(
                    arrays[f"{label}.{key}"], _whole(pair, "save", key),
                    err_msg=f"{label}.{key}")


# --- four cards --------------------------------------------------------------

# label -> (flags, steps) of the four-card jobs, and each label's
# reference: (job, label). Data 4 runs the microbatches of one card at
# --grad-accum 4. Data 2 x seq 2 does not: each card's seq half of a
# weight gradient is a bf16 product of its own, where one card holding the
# whole ring forms one over the whole sequence (the losses then part by
# ~1e-4), so its reference is the same four cards without --fsdp.
CARD_DATA = {"data4": (F, 3),
             "data4_chunk": (F + ["--loss-chunk", "16"], 3)}
CARD_SEQ = {"data2_seq2": (F + ["--seq-parallel", "2"], 3),
            "data2_seq2_plain": (["--seq-parallel", "2"], 3),
            "data2_uly2": (F + ["--seq-parallel", "2", "--sp-mode",
                                "ulysses"], 3),
            "data2_uly2_plain": (["--seq-parallel", "2", "--sp-mode",
                                  "ulysses"], 3)}
CARD_ONE = {"data4": (["--grad-accum", "4"], 3),
            "data4_chunk": (["--loss-chunk", "16", "--grad-accum", "4"], 3)}
CARD_REFS = {"data4": ("one", "data4"),
             "data4_chunk": ("one", "data4_chunk"),
             "data2_seq2": ("seq", "data2_seq2_plain"),
             "data2_uly2": ("seq", "data2_uly2_plain")}


@pytest.fixture(scope="module")
def card_runs(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards")
    from tpu_operator_torch.kernels import build

    build.library()  # once, before the workers load it
    out = tmp_path_factory.mktemp("fsdp_nccl")
    result = _launch(out, {"data": (4, CARD_DATA, "run")}, "cuda")
    result.update(_launch(out, {"seq": (4, CARD_SEQ, "run")}, "cuda"))
    result.update(_launch(out, {"one": (1, CARD_ONE, "run")}, "cuda"))
    return result


@pytest.mark.cuda
@pytest.mark.parametrize("label", sorted(CARD_REFS))
def test_fsdp_over_nccl_matches_its_reference(card_runs, label):
    """Data 4 (the dense head, and the chunked one) against one card
    without --fsdp on the same microbatches; data 2 x seq 2 (the ring, and
    Ulysses, across two cards) against the same four cards without
    --fsdp: the losses to 1e-6 relative, the params after 3 steps within
    1e-5 of max(1, the leaf's largest entry), every process logging one
    trajectory."""
    group = card_runs["data" if label.startswith("data4") else "seq"]
    job, ref_label = CARD_REFS[label]
    ref = card_runs[job][0]
    meta = group[0][1]
    assert meta[f"{label}.data"] == (4 if label.startswith("data4") else 2)
    first = meta[f"{label}.losses"]
    assert all(m[f"{label}.losses"] == first for _a, m in group)
    np.testing.assert_allclose(first, ref[1][f"{ref_label}.losses"],
                               rtol=1e-6, atol=0)
    # One data group: every data rank, at seq rank 0.
    ranks = group if label.startswith("data4") else group[::2]
    for key in _keys(group, label):
        if key.startswith("param."):
            want = ref[0][f"{ref_label}.{key}"]
            got = _whole(ranks, label, key)
            bound = 1e-5 * max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got, want, rtol=0, atol=bound,
                                       err_msg=key)
