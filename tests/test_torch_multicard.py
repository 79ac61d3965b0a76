"""Sequence-parallel training across four cards: four processes, one card
each, in an NCCL group formed by ``bootstrap.initialize`` from the
operator's ``JAX_*`` env, each holding one of the 4 ring shards (P = 4).

Needs four CUDA cards and ``nvcc``; without them it skips (marker
``cuda``). It imports no JAX, so on a four-card machine without JAX run it
past the suite's conftest:

    python -m pytest tests/test_torch_multicard.py --noconftest -m cuda -q -s

One module-scoped run builds the kernels once, then starts the four
workers (``python -c`` of the script below) on a free localhost port with
a timeout of its own. Each worker:
- runs ring attention (B 1, T 4096, H 16 / 4 K/V heads) on its slab over
  NCCL (the merge kernel forward, the backward kernels in the backward
  ring) and the same ring with all four shards on its own card, and
  compares its slab of the output and of the q/k/v gradients;
- trains the long-context flagship (``bench.py:661`` widths, 2 layers, the
  full 8192 tokens, ``--seq-parallel 4 --sp-layout striped``) for 2 steps
  through ``train.train_loop`` (the gradient all-reduce over NCCL, the
  drain agreement over the gloo group beside it) and hashes its params;
- process 0 then trains the same config with the whole ring on its card
  (P = 1, no collective) for the loss comparison;
- the classifier cell at ``--model-parallel 2`` over the four cards (data
  2 x model 2) for 3 steps, and process 0 the same with both shards and
  the whole batch on its card.

Beside it, a two-card run (``pair_runs``, two cards or more): tensor
parallelism and Ulysses over NCCL, one shard a card, against one card
holding both shards, and the classifier at ``--model-parallel 2`` the same
way.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 300.0
CARDS = 4

SCRIPT = textwrap.dedent('''
    import hashlib, json, sys
    import numpy as np
    import torch
    sys.path.insert(0, sys.argv[1])
    from tpu_operator_torch.payload import bootstrap, cifar, train
    from tpu_operator_torch.payload import transformer
    from tpu_operator_torch.payload import ring_attention as ring

    out = sys.argv[2]
    ARGV = ["--steps", "2", "--batch", "4", "--seq-len", "8192",
            "--grad-accum", "2", "--adam-mu-dtype", "bf16", "--vocab",
            "32768", "--dim", "2048", "--heads", "16", "--kv-heads", "4",
            "--layers", "2", "--seq-parallel", "4", "--sp-layout",
            "striped", "--seed", "0", "--log-every", "0", "--device",
            "cuda", "--checkpoint-dir", "", "--profile-dir", ""]

    def train_run(mesh):
        """2 steps; through train_loop (and its drain agreement) when the
        mesh spans the group."""
        args = transformer.parse_args(ARGV)
        built = transformer.build(args, mesh=mesh)
        losses = []

        def step(batch):
            metrics = built.step(batch)
            losses.append(metrics["loss"])
            return metrics

        if mesh.world > 1:
            train.train_loop(step, built.batches, args.steps,
                             device=built.device, heartbeat=None,
                             steptrace=None)
        else:
            for _ in range(args.steps):
                (tokens,) = next(built.batches)
                step(torch.from_numpy(tokens).to(built.device))
        digest = hashlib.sha256()
        for p in built.model.parameters():
            digest.update(p.detach().cpu().numpy().tobytes())
        return [float(x) for x in losses], digest.hexdigest()

    def classifier_run(mesh):
        """The classifier cell (ResNet-20, batch 1024) at
        --model-parallel 2 on ``mesh``, 3 steps: its losses and a digest
        of the params this card holds."""
        args = cifar.parse_args(["--steps", "3", "--model-parallel", "2",
                                 "--seed", "0", "--log-every", "0",
                                 "--device", "cuda", "--checkpoint-dir", "",
                                 "--profile-dir", ""])
        built = cifar.build(args, mesh=mesh)
        losses = []
        for _ in range(args.steps):
            x, y = (torch.from_numpy(a).to(built.device)
                    for a in next(built.batches))
            losses.append(built.step(x, y)["loss"])
        digest = hashlib.sha256()
        for p in built.model.parameters():
            digest.update(p.detach().cpu().numpy().tobytes())
        return [float(x) for x in losses], digest.hexdigest()

    def payload(info):
        rank = info.process_id
        mesh = transformer.make_lm_mesh(seq_parallel=4)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        xs = [torch.randn(1, 4096, hh, 128, generator=gen,
                          device="cuda").bfloat16() for hh in (16, 4, 4, 16)]
        lo = mesh.seq_rank * 1024
        res = {"mesh": list(mesh)[:4], "device": str(torch.cuda.current_device())}
        for layout in ("contiguous", "striped"):
            stripe = layout == "striped"
            perm = torch.from_numpy(
                ring.stripe_permutation(4096, 4)[0] if stripe
                else np.arange(4096)).cuda()
            q, k, v, cot = (x[:, perm].contiguous() for x in xs)

            def run(slab, r):
                ts = [slab(x).requires_grad_(True) for x in (q, k, v)]
                o = ring.ring_attention(*ts, r, causal=True, stripe=stripe)
                o.backward(slab(cot))
                return [o.detach()] + [t.grad for t in ts]

            four = run(lambda x: x[:, lo:lo + 1024].contiguous(), mesh.ring())
            one = [x[:, lo:lo + 1024] for x in run(
                lambda x: x.detach().clone(), ring.SeqRing(4))]
            res[layout] = all(bool(torch.equal(a, b))
                              for a, b in zip(four, one))
        res["losses"], res["params_sha256"] = train_run(mesh)
        if rank == 0:
            res["losses_one_process"], _ = train_run(
                transformer.make_lm_mesh(1, 0, 4))
        res["classifier_d2m2"] = classifier_run(
            cifar.make_cifar_mesh(model_parallel=2))
        if rank == 0:
            res["classifier_one_card"] = classifier_run(
                cifar.CifarMesh(1, 0, 1, 2))
        with open(f"{out}/r{rank}.json", "w") as f:
            json.dump(res, f)

    sys.exit(bootstrap.run_payload(payload, device="cuda"))
''')


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """rank -> (exit code, result) of the four workers."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        pytest.skip(f"needs {CARDS} CUDA cards")
    from tpu_operator_torch.kernels import build

    build.library()  # once, before the workers load it
    out = tmp_path_factory.mktemp("multicard")
    port = _free_port()
    procs = []
    for rank in range(CARDS):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_PROCESS_ID=str(rank), JAX_NUM_PROCESSES=str(CARDS))
        env.pop("TPUJOB_STATUS_URL", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", SCRIPT, str(REPO), str(out)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
        pytest.fail(f"the four-card run did not finish in {TIMEOUT} s")
    result = {}
    for rank, proc in enumerate(procs):
        path = out / f"r{rank}.json"
        assert path.exists(), logs[rank][-3000:]
        result[rank] = (proc.returncode, json.loads(path.read_text()))
    print(json.dumps({str(r): v for r, v in result.items()}))
    return result


@pytest.mark.cuda
def test_four_processes_take_one_card_and_one_shard_each(runs):
    for rank, (code, res) in runs.items():
        assert code == 0
        assert res["mesh"] == [CARDS, rank, 4, 4]  # world, rank, P, N
        assert res["device"] == str(rank)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "striped"])
def test_ring_over_nccl_is_bit_equal_to_one_card(runs, layout):
    """The same kernels at the same per-shard shapes, merged and
    differentiated in the same order; NCCL moves the bytes unchanged."""
    assert all(res[layout] for _code, res in runs.values())


@pytest.mark.cuda
def test_params_stay_bit_equal_across_cards(runs):
    digests = {res["params_sha256"] for _code, res in runs.values()}
    assert len(digests) == 1


@pytest.mark.cuda
def test_losses_match_one_process_holding_the_whole_ring(runs):
    """The four cards' all-reduced loss against one process running all
    four shards on one card, same seeded params and batches. The dense
    layers run on 2048 positions a row per card on four cards and on 8192
    on one, so cuBLAS may round the bf16 logits apart; held to 1e-2 a
    step, the loss tolerance chip_smoke.py states for bf16 logits over
    thousands of targets (a wrong shard order, share or reduction moves
    it by O(1))."""
    one = runs[0][1]["losses_one_process"]
    for _code, res in runs.values():
        assert len(res["losses"]) == len(one) == 2
        for got, want in zip(res["losses"], one):
            assert abs(got - want) <= 1e-2


@pytest.mark.cuda
def test_classifier_data_2_model_2_over_four_cards(runs):
    """The classifier at ``--model-parallel 2`` over four cards (data 2 x
    model 2): the two data ranks' cards of one model rank hold bit-equal
    params after three steps (the same all-reduced gradient), and the
    losses stay within 1e-2 a step of one card holding both shards with
    the whole batch (each data half's bf16 weight gradient rounds before
    the all-reduce; a wrong group for BatchNorm's sums or the gradient
    reduce moves the loss by O(1))."""
    digests = {r: res["classifier_d2m2"][1] for r, (_c, res) in runs.items()}
    assert digests[0] == digests[2] and digests[1] == digests[3]
    assert digests[0] != digests[1]
    one = runs[0][1]["classifier_one_card"][0]
    for _code, res in runs.values():
        losses = res["classifier_d2m2"][0]
        assert len(losses) == len(one) == 3
        for got, want in zip(losses, one):
            assert abs(got - want) <= 1e-2


# --- two cards: tensor parallelism and Ulysses over NCCL ------------------------
#
#     python -m pytest tests/test_torch_multicard.py --noconftest -m cuda -q -s
#
# on a machine with two or more cards. Two workers, one card each: the
# long-context flagship's widths (2 layers, T 4096, 16 / 4 heads) with
# --tensor-parallel 2 (one model shard a card: the row-parallel sums and
# the gradients entering each shard over NCCL) and with --seq-parallel 2
# --sp-mode ulysses (the head-scatter all-to-all over NCCL), 2 steps each;
# worker 0 then runs both configs with both shards on its own card.

PAIR = 2

PAIR_SCRIPT = textwrap.dedent('''
    import hashlib, json, sys
    import torch
    sys.path.insert(0, sys.argv[1])
    from tpu_operator_torch.payload import bootstrap, cifar, collectives
    from tpu_operator_torch.payload import train, transformer

    out = sys.argv[2]
    BASE = ["--steps", "2", "--batch", "2", "--seq-len", "4096",
            "--vocab", "32768", "--dim", "2048", "--heads", "16",
            "--kv-heads", "4", "--layers", "2", "--seed", "0",
            "--log-every", "0", "--device", "cuda", "--checkpoint-dir", "",
            "--profile-dir", ""]
    CONFIGS = {"tp": ["--tensor-parallel", "2"],
               "ulysses": ["--seq-parallel", "2", "--sp-mode", "ulysses"]}

    def train_run(flags, mesh):
        args = transformer.parse_args(BASE + flags)
        built = transformer.build(args, mesh=mesh)
        losses = []

        def step(batch):
            metrics = built.step(batch)
            losses.append(metrics["loss"])
            return metrics

        if mesh.world > 1:
            train.train_loop(step, built.batches, args.steps,
                             device=built.device, heartbeat=None,
                             steptrace=None)
        else:
            for _ in range(args.steps):
                (tokens,) = next(built.batches)
                step(torch.from_numpy(tokens).to(built.device))
        return [float(x) for x in losses]

    # The classifier cell (ResNet-20, batch 1024) at --model-parallel 2.
    CIFAR = ["--steps", "3", "--model-parallel", "2", "--seed", "0",
             "--log-every", "0", "--device", "cuda", "--checkpoint-dir", "",
             "--profile-dir", ""]

    def digests(model, rank, procs):
        """sha256 of each param as model rank ``rank`` of ``procs`` holds
        it (the part of each split one)."""
        dims = model.tp_dims()
        out = {}
        for n, p in model.named_parameters():
            t = p.detach()
            if model.tp.procs == 1 and procs > 1 and n in dims:
                t = collectives.part_of(t, *dims[n], procs, rank)
            out[n] = hashlib.sha256(
                t.contiguous().cpu().numpy().tobytes()).hexdigest()
        return out

    def classifier_run(mesh, rank):
        args = cifar.parse_args(CIFAR)
        built = cifar.build(args, mesh=mesh)
        losses = []

        def step(x, y):
            metrics = built.step(x, y)
            losses.append(metrics["loss"])
            return metrics

        if mesh.world > 1:
            train.train_loop(step, built.batches, args.steps,
                             device=built.device, heartbeat=None,
                             steptrace=None)
        else:
            for _ in range(args.steps):
                x, y = (torch.from_numpy(a).to(built.device)
                        for a in next(built.batches))
                step(x, y)
        return {"losses": [float(x) for x in losses],
                "params": {r: digests(built.model, r, 2)
                           for r in ([rank] if mesh.world > 1
                                     else range(2))}}

    def payload(info):
        rank = info.process_id
        res = {"classifier_tp": classifier_run(
            cifar.make_cifar_mesh(model_parallel=2), rank)}
        if rank == 0:
            res["classifier_tp_one_card"] = classifier_run(
                cifar.CifarMesh(1, 0, 1, 2), rank)
        for name, flags in CONFIGS.items():
            args = transformer.parse_args(BASE + flags)
            mesh = transformer.make_lm_mesh(
                seq_parallel=args.seq_parallel,
                tensor_parallel=args.tensor_parallel)
            res[name] = train_run(flags, mesh)
            if rank == 0:
                res[name + "_one_card"] = train_run(
                    flags, transformer.make_lm_mesh(
                        1, 0, args.seq_parallel, args.tensor_parallel))
        with open(f"{out}/pair{rank}.json", "w") as f:
            json.dump(res, f)

    sys.exit(bootstrap.run_payload(payload, device="cuda"))
''')


@pytest.fixture(scope="module")
def pair_runs(tmp_path_factory):
    """rank -> (exit code, result) of the two workers."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < PAIR:
        pytest.skip(f"needs {PAIR} CUDA cards")
    from tpu_operator_torch.kernels import build

    build.library()
    out = tmp_path_factory.mktemp("pair")
    port = _free_port()
    procs = []
    for rank in range(PAIR):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_PROCESS_ID=str(rank), JAX_NUM_PROCESSES=str(PAIR))
        env.pop("TPUJOB_STATUS_URL", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", PAIR_SCRIPT, str(REPO), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
        pytest.fail(f"the two-card run did not finish in {TIMEOUT} s")
    result = {}
    for rank, proc in enumerate(procs):
        path = out / f"pair{rank}.json"
        assert path.exists(), logs[rank][-3000:]
        result[rank] = (proc.returncode, json.loads(path.read_text()))
    print(json.dumps({str(r): v for r, v in result.items()}))
    return result


@pytest.mark.cuda
def test_classifier_over_two_cards_is_bit_equal_to_one_card(pair_runs):
    """The classifier at ``--model-parallel 2``, one shard a card, against
    one card holding both: each shard's convolutions run at the same
    shapes (cuDNN deterministic), the joins move the bytes unchanged and
    the gradient sums add two values, so the three losses are equal and
    each card's params after them are bit-equal to its part of the one
    card's."""
    one = pair_runs[0][1]["classifier_tp_one_card"]
    assert len(one["losses"]) == 3
    for rank, (code, res) in pair_runs.items():
        assert code == 0
        mine = res["classifier_tp"]
        assert mine["losses"] == one["losses"]
        assert mine["params"][str(rank)] == one["params"][str(rank)]


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["tp", "ulysses"])
def test_two_cards_match_one_card_holding_both_shards(pair_runs, config):
    """Each shard's kernels and products run at the same shapes on two
    cards as on one; the sums over NCCL and the all-to-all move the same
    values. cuBLAS may still pick other algorithms per process, so the
    losses are held to 1e-2 a step, the loss tolerance chip_smoke.py
    states for bf16 logits over thousands of targets (a wrong shard, split
    or exchange moves it by O(1))."""
    one = pair_runs[0][1][config + "_one_card"]
    for code, res in pair_runs.values():
        assert code == 0
        assert len(res[config]) == len(one) == 2
        for got, want in zip(res[config], one):
            assert abs(got - want) <= 1e-2
