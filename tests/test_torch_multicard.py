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
  (P = 1, no collective) for the loss comparison.
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
    from tpu_operator_torch.payload import bootstrap, train, transformer
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

    def payload(info):
        rank = info.process_id
        mesh = transformer.make_lm_mesh(seq_parallel=4)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        xs = [torch.randn(1, 4096, hh, 128, generator=gen,
                          device="cuda").bfloat16() for hh in (16, 4, 4, 16)]
        lo = mesh.seq_rank * 1024
        res = {"mesh": list(mesh), "device": str(torch.cuda.current_device())}
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
