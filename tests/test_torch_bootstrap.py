"""The port's multi-process plumbing against the JAX package's, on the CPU:
the coordinator DNS wait, process-group formation, the (data, seq) mesh,
the data ranks' batches and the cadence-only heartbeat. The two-process
gloo runs themselves are in tests/test_torch_ring_multiprocess.py."""

import socket

import numpy as np
import pytest
import torch

from tpu_operator.payload import bootstrap as jbootstrap
from tpu_operator.payload import heartbeat as jheartbeat
from tpu_operator_torch.payload import bootstrap
from tpu_operator_torch.payload import data
from tpu_operator_torch.payload import heartbeat
from tpu_operator_torch.payload import train
from tpu_operator_torch.payload import transformer


# --- the DNS wait and the group -------------------------------------------------


@pytest.mark.parametrize("failures", [0, 3, 8])
def test_wait_for_coordinator_polls_like_the_reference(monkeypatch, failures):
    """The same failed polls give the same sleeps: 50 ms first, doubling
    up to the interval."""
    def run(mod):
        left = [failures]

        def fake_getaddrinfo(_host, _port):
            if left[0] > 0:
                left[0] -= 1
                raise socket.gaierror("not yet")
            return []

        monkeypatch.setattr(socket, "getaddrinfo", fake_getaddrinfo)
        sleeps, now = [], [0.0]

        def fake_sleep(dt):
            sleeps.append(dt)
            now[0] += dt

        mod.wait_for_coordinator("coord:8476", timeout=300.0, interval=2.0,
                                 sleep=fake_sleep, clock=lambda: now[0])
        return sleeps

    assert run(bootstrap) == run(jbootstrap)
    assert len(run(bootstrap)) == failures


def test_wait_for_coordinator_times_out(monkeypatch):
    def nope(_h, _p):
        raise socket.gaierror("never")

    monkeypatch.setattr(socket, "getaddrinfo", nope)
    now = [0.0]

    def fake_sleep(dt):
        now[0] += dt

    with pytest.raises(TimeoutError):
        bootstrap.wait_for_coordinator("coord:8476", timeout=10.0,
                                       sleep=fake_sleep, clock=lambda: now[0])


def _info(n, pid=0):
    return bootstrap.process_info_from_env({
        "JAX_COORDINATOR_ADDRESS": "127.0.0.1:1", "JAX_PROCESS_ID": str(pid),
        "JAX_NUM_PROCESSES": str(n)})


def test_one_process_forms_no_group():
    info = bootstrap.initialize(_info(1), device="cpu")
    assert info.num_processes == 1
    assert not torch.distributed.is_initialized()
    assert bootstrap.world_size() == 1


def test_nccl_never_falls_back_to_gloo(monkeypatch):
    """A multi-process job on CUDA without a card raises before it forms
    any group; gloo is only for a caller that asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        bootstrap.initialize(_info(2), device="cuda")
    with pytest.raises(RuntimeError, match="NCCL"):
        bootstrap.initialize(_info(2))
    with pytest.raises(ValueError, match="backend"):
        bootstrap.initialize(_info(2), device="meta")
    assert not torch.distributed.is_initialized()


def test_one_process_takes_its_own_drain_code_without_a_collective():
    bootstrap.reset_drain()
    try:
        assert train.agreed_drain_code() == 0
        bootstrap.request_drain()
        assert train.agreed_drain_code() == bootstrap.EXIT_RETRYABLE
        bootstrap.request_planned_drain()
        assert train.agreed_drain_code() == bootstrap.EXIT_PLANNED
    finally:
        bootstrap.reset_drain()


# --- the (data, seq) mesh and the data ranks -----------------------------------


@pytest.mark.parametrize("world,n,procs,dp", [
    (1, 1, 1, 1), (1, 4, 1, 1), (2, 4, 2, 1), (4, 4, 4, 1), (8, 4, 4, 2),
    (4, 1, 1, 4), (4, 2, 2, 2)])
def test_lm_mesh_layout(world, n, procs, dp):
    """P = min(world, N) processes per seq group, data-major ranks: a seq
    group is P neighbouring ranks, each holding N / P shards."""
    for rank in range(world):
        mesh = transformer.make_lm_mesh(world, rank, n)
        assert (mesh.seq_procs, mesh.data) == (procs, dp)
        assert mesh.data_rank == rank // procs
        ring = mesh.ring()
        assert ring.ranks == tuple(range(mesh.data_rank * procs,
                                         (mesh.data_rank + 1) * procs))
        assert ring.index == rank % procs and ring.local == n // procs


@pytest.mark.parametrize("world,n", [(3, 4), (4, 3), (6, 4)])
def test_lm_mesh_refuses_layouts_that_do_not_split(world, n):
    with pytest.raises(ValueError):
        transformer.make_lm_mesh(world, 0, n)


def test_data_ranks_keep_their_rows_of_the_global_stream():
    """Every process draws the same global batches; data rank d keeps rows
    [d·B/dp, (d+1)·B/dp), and the ranks together hold the whole batch."""
    args = transformer.parse_args(["--batch", "8", "--seq-len", "16",
                                   "--vocab", "64"])
    whole = data.lm_batches(args)
    parts = [data.lm_batches(args, transformer.make_lm_mesh(4, r, 2))
             for r in range(4)]  # P 2, data 2
    for _ in range(3):
        (full,) = next(whole)
        got = [next(p)[0] for p in parts]
        np.testing.assert_array_equal(got[0], full[:4])
        np.testing.assert_array_equal(got[1], full[:4])  # same seq group
        np.testing.assert_array_equal(got[2], full[4:])
        np.testing.assert_array_equal(got[3], full[4:])


# --- the cadence-only heartbeat -------------------------------------------------


def test_cadence_only_beats_match_the_reference():
    """A training job's other processes post identity, step cadence and the
    stepTiming digest only; the same calls on the port's reporter and the
    JAX package's post the same bodies."""
    def drive(mod):
        ticks = iter(np.arange(0.0, 100.0, 0.5))
        bodies = []
        rep = mod.HeartbeatReporter(
            "http://s/", "j", namespace="ns", process_id=3, attempt=2,
            interval=0, tokens_per_batch=4096,
            clock=lambda: float(next(ticks)),
            poster=lambda _u, body: bodies.append(body) or {},
            cadence_only=True)
        for step in (1, 2, 4):
            rep.report(step, {"loss": 1.5},
                       steptiming={"window": step, "phases": {}})
        return bodies

    ours = drive(heartbeat)
    assert ours == drive(jheartbeat)
    assert all("loss" not in b and "tokensPerSec" not in b for b in ours)
    assert ours[1]["stepTimeSeconds"] == 0.5 and ours[2]["processId"] == 3


def test_from_env_picks_the_flavour_by_process():
    base = {"TPUJOB_STATUS_URL": "http://s", "TPUJOB_NAME": "j"}
    assert not heartbeat.from_env(base).cadence_only
    other = heartbeat.from_env({**base, "JAX_PROCESS_ID": "2"})
    assert other.cadence_only and other.process_id == 2
    assert heartbeat.from_env({**base, "JAX_PROCESS_ID": "2",
                               "TPUJOB_STEPTRACE_ENABLED": "0"}) is None
    assert heartbeat.from_env({**base,
                               "TPUJOB_STEPTRACE_ENABLED": "0"}) is not None
    for env in ({**base, "JAX_PROCESS_ID": "2"},
                {**base, "JAX_PROCESS_ID": "2",
                 "TPUJOB_STEPTRACE_ENABLED": "0"}):
        mine, theirs = heartbeat.from_env(env), jheartbeat.from_env(env)
        assert (mine is None) == (theirs is None)
        if mine is not None:
            assert mine.cadence_only == theirs.cadence_only


def test_loop_sends_no_metrics_on_cadence_beats():
    """The loop hands a cadence-only reporter no metrics (no same-step
    host read); its beats carry the step cadence."""
    bodies = []
    rep = heartbeat.HeartbeatReporter(
        "http://s", "j", interval=0, process_id=1, cadence_only=True,
        poster=lambda _u, body: bodies.append(body) or {})
    calls = []

    def step(tokens):
        calls.append(1)
        return {"loss": torch.tensor(2.0)}

    def batches():
        while True:
            yield (np.zeros((2, 4), np.int32),)

    train.train_loop(step, batches(), 3, device="cpu", heartbeat=rep,
                     steptrace=None)
    assert [b["step"] for b in bodies] == [1, 2, 3]
    assert all("loss" not in b and "tokensPerSec" not in b for b in bodies)
