"""The pod launcher (``tpu_operator_torch.payload.launch``): from the env
the operator gives a GPU pod to one payload process per card, on the CPU
(gloo processes stand in for the cards; ``--device cpu --cards N``).

(a) The env table: pods x cards of 1 x 1, 1 x 4, 2 x 2 and 4 x 4 from the
    reference's own ``build_replica_env`` (two slices where there are two
    pods or more): each card's rank and world, the slice variables passed
    through, the meshes' model groups inside a pod, and which processes
    beat under which id; rank 0's check of the pods' card counts.
(b) The operator end to end: the reference ``Controller`` over a
    ``FakeClientset`` creates the pods of
    ``examples/torch/gpujob-tensor-parallel.yml`` at 2 workers of 2 cards;
    the launcher runs once per pod with the env read from the fake store;
    the four processes train TP 2 x data 2 for 3 steps. Against them, one
    process holding the same work with its two TP shards as units (a pod
    of one card), and one pod of two cards (TP 2 alone).
(c) The exit contract: a failed card, SIGTERM, a drain directive.
(d) Serve pods: one process for the pod's cards (its env, and two CPU
    cards behind one HTTP ingress end to end); the refusals.

Every job of (b) and (c) starts at once in one module-scoped fixture (each
process imports torch; one intra-op thread each, so that the CPU kernels
round alike in every process: some checks are bit-equality).
"""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request
from datetime import timedelta
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch.distributed as dist
import yaml

from tpu_operator.apis.tpujob.v1alpha1.types import ControllerConfig
from tpu_operator.apis.tpujob.v1alpha1.types import TPUJobSpec
from tpu_operator.client.fake import FakeClientset
from tpu_operator.client.informer import SharedInformerFactory
from tpu_operator.controller.controller import Controller
from tpu_operator.trainer.replicas import build_replica_env
from tpu_operator_torch.payload import bootstrap
from tpu_operator_torch.payload import cifar
from tpu_operator_torch.payload import heartbeat
from tpu_operator_torch.payload import launch
from tpu_operator_torch.payload import moe
from tpu_operator_torch.payload import pipeline
from tpu_operator_torch.payload import transformer
from tpu_operator_torch.payload import warmstore

REPO = Path(__file__).resolve().parent.parent
EXAMPLE = REPO / "examples" / "torch" / "gpujob-tensor-parallel.yml"
TIMEOUT = 180.0

# The widths of tests/test_torch_tp_multiprocess.py in place of the
# example's (dim 4096, 16 layers, 32 heads, batch 16); TP 2 on pods of two
# cards in place of TP 4 on four; 3 steps, every step logged.
WIDTHS = ["--tensor-parallel", "2", "--dim", "64", "--layers", "2",
          "--heads", "4", "--kv-heads", "2", "--vocab", "256", "--seq-len",
          "64", "--batch", "4", "--remat", "--seed", "0", "--log-every",
          "1", "--profile-dir", ""]
TINY = WIDTHS + ["--steps", "3", "--checkpoint-dir", ""]
# Runs that a signal or a directive ends.
LONG = WIDTHS + ["--steps", "100000"]


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _base_env(extra) -> dict:
    """This environment without any operator variable, plus ``extra``."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPUJOB_", "TPU_", "JAX_", "MEGASCALE_"))}
    env.update(OMP_NUM_THREADS="1", **extra)
    return env


def _pod_env(port: int, **extra) -> dict:
    """A one-pod job's operator env on ``127.0.0.1:port``."""
    return _base_env({"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                      "JAX_PROCESS_ID": "0", "JAX_NUM_PROCESSES": "1",
                      "TPUJOB_ATTEMPT": "0", **extra})


class Launch:
    """One launcher process (one pod), its output read as it comes."""

    def __init__(self, argv, env):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "tpu_operator_torch.payload.launch",
             *argv], env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.lines = []
        self.cond = threading.Condition()
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        for line in self.proc.stdout:
            with self.cond:
                self.lines.append(line.rstrip("\n"))
                self.cond.notify_all()

    def wait_for(self, pattern: str, timeout: float = TIMEOUT) -> None:
        with self.cond:
            if not self.cond.wait_for(
                    lambda: any(re.search(pattern, ln) for ln in self.lines)
                    or self.proc.poll() is not None, timeout=timeout):
                pytest.fail(f"no line matching {pattern!r} in {timeout} s")

    def finish(self, timeout: float = TIMEOUT):
        """(exit code, output lines)."""
        try:
            code = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            pytest.fail("the launcher did not finish:\n"
                        + "\n".join(self.lines[-40:]))
        self.reader.join(timeout=10)
        return code, self.lines


def card_lines(lines, card: int):
    prefix = f"[card {card}] "
    return [ln[len(prefix):] for ln in lines if ln.startswith(prefix)]


def losses(lines, card: int):
    """The card's loss trajectory from its log: the loop logs step k with
    step k - 1's loss (its fence) after step 1, and the last step's loss
    as ``final``."""
    steps, final = {}, None
    for ln in card_lines(lines, card):
        m = re.search(r" step (\d+) loss (\S+)$", ln)
        if m:
            steps[int(m.group(1))] = float(m.group(2))
        m = re.search(r" final: loss (\S+)$", ln)
        if m:
            final = float(m.group(1))
    assert steps and final is not None, card_lines(lines, card)[-20:]
    return [steps[1]] + [steps[k] for k in range(3, max(steps) + 1)] \
        + [final]


def model_group(lines, card: int):
    """(rank, world, model group ranks) from the card's mesh line."""
    for ln in card_lines(lines, card):
        m = re.search(r"mesh: process (\d+) of (\d+), .* model group "
                      r"\[([\d, ]*)\]", ln)
        if m:
            return (int(m.group(1)), int(m.group(2)),
                    [int(x) for x in m.group(3).split(",")])
    raise AssertionError(card_lines(lines, card)[-20:])


class StatusServer:
    """A stand-in for the operator's status server: records every
    heartbeat body; with ``drain``, ACKs process 0's beats from step 2 on
    with a drain directive."""

    def __init__(self, drain: bool = False):
        beats = self.beats = []

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))
                beats.append(body)
                ack = {}
                if drain and body.get("processId") == 0 \
                        and body.get("step", 0) >= 2:
                    ack = {"drain": {"id": "d-1", "reason": "cordon"}}
                out = json.dumps(ack).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            def log_message(self, *_args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


# --- (a) the env table ---------------------------------------------------------


def _operator_envs(pods: int, slices: int):
    """The reference operator's env of each worker pod of a job of
    ``pods`` workers in ``slices`` slices, plus a status URL."""
    spec = TPUJobSpec.from_dict({"replicaSpecs": [{
        "replicas": pods, "tpuReplicaType": "WORKER", "tpuPort": 8476,
        "template": {"spec": {"containers": [{"name": "tpu"}]}}}]})
    spec.num_slices = slices
    envs = [build_replica_env("job", "rid", spec, "WORKER", i)
            for i in range(pods)]
    for env in envs:
        env.update(TPUJOB_STATUS_URL="http://status:8080",
                   TPUJOB_NAMESPACE="default")
    return envs


@pytest.mark.parametrize("pods,cards", [(1, 1), (1, 4), (2, 2), (4, 4)],
                         ids=lambda x: str(x))
def test_card_env_table(pods, cards):
    slices = 2 if pods > 1 else 1
    world = pods * cards
    beats = {}
    for pod, env in enumerate(_operator_envs(pods, slices)):
        for card, e in enumerate(launch.card_envs(env, cards)):
            rank = pod * cards + card
            info = bootstrap.process_info_from_env(e)
            assert (info.process_id, info.num_processes, info.pod_cards) \
                == (rank, world, cards)
            assert info.coordinator_address == env["JAX_COORDINATOR_ADDRESS"]
            assert info.coordinator_address.endswith(":8476")
            for var in ("TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES",
                        "MEGASCALE_NUM_SLICES", "MEGASCALE_SLICE_ID",
                        "MEGASCALE_COORDINATOR_ADDRESS", "TPUJOB_NAME",
                        "TPUJOB_ATTEMPT", "TPUJOB_STATUS_URL"):
                assert e.get(var) == env.get(var), var
            assert info.num_slices == slices
            # Every mesh's model group at TP = the pod's cards lies inside
            # the pod, and the slices' check holds.
            for mesh in (
                    transformer.make_lm_mesh(world, rank,
                                             tensor_parallel=cards,
                                             num_slices=slices),
                    pipeline.make_pipe_mesh(world, rank,
                                            tensor_parallel=cards,
                                            num_slices=slices),
                    moe.make_moe_mesh(world, rank, tensor_parallel=cards,
                                      num_slices=slices),
                    cifar.make_cifar_mesh(world, rank, model_parallel=cards,
                                          num_slices=slices)):
                assert mesh.model_procs == cards
                first = rank - rank % mesh.model_procs
                assert first // cards == pod, mesh
            # One writer of the warm-start store per job: global rank 0.
            assert warmstore._is_process_zero(e) == (rank == 0)
            reporter = heartbeat.from_env(e)
            if reporter is not None:
                beats[rank] = (reporter.process_id, reporter.cadence_only)
    # Card 0 of each pod beats under the pod's id, pod 0 the full stream.
    assert beats == {p * cards: (p, p != 0) for p in range(pods)}


def test_tp4_across_two_pods_of_two_cards_is_refused_under_two_slices():
    """Two slices of 2 x 2 cards hold 2 ranks each: a TP 4 group would
    span them."""
    with pytest.raises(ValueError, match="fit within one slice"):
        transformer.make_lm_mesh(4, 0, tensor_parallel=4, num_slices=2)


def _pod_infos(counts):
    """The ProcessInfo of each card 0 (and of global rank 0) of pods
    running ``counts[p]`` cards each."""
    infos = []
    for pod, cards in enumerate(counts):
        infos.append(bootstrap.ProcessInfo(
            coordinator_address="c:1", process_id=pod * cards,
            num_processes=len(counts) * cards, worker_id=pod,
            worker_hostnames=(), pod_cards=cards))
    return infos


def test_rank_0_checks_the_pods_card_counts():
    """Each pod's card 0 writes its count; rank 0 (checking last here)
    passes when they agree and names the pod that differs, at once,
    instead of a rendezvous that waits for ranks that never come."""
    store = dist.HashStore()
    infos = _pod_infos([2, 2, 2])
    for info in infos[::-1]:
        bootstrap.check_pods(store, info, timedelta(seconds=5))
    store = dist.HashStore()
    infos = _pod_infos([4, 2])
    bootstrap.check_pods(store, infos[1], timedelta(seconds=5))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="pod 1 runs 2"):
        bootstrap.check_pods(store, infos[0], timedelta(seconds=30))
    assert time.monotonic() - t0 < 5


# --- (b), (c): the jobs, started together --------------------------------------


def _operator_pods(status_url: str):
    """The reference operator's two pods of the example at 2 workers x 2
    cards, as (container command, env) per pod in process order."""
    with open(EXAMPLE, encoding="utf-8") as f:
        (doc,) = [d for d in yaml.safe_load_all(f) if d]
    doc["metadata"]["namespace"] = "default"
    spec = doc["spec"]["replicaSpecs"][0]
    spec["replicas"] = 2
    container = spec["template"]["spec"]["containers"][0]
    assert container["resources"]["limits"] == {"nvidia.com/gpu": "4"}
    container["resources"]["limits"]["nvidia.com/gpu"] = "2"
    cmd = container["command"]
    split = cmd.index("--")
    assert cmd[:split] == ["python", "-m", "tpu_operator_torch.payload.launch"]
    assert cmd[split + 1] == "transformer"
    container["command"] = cmd[:split + 2] + TINY
    container["env"] = [{"name": "TPUJOB_HEARTBEAT_INTERVAL", "value": "0"}]
    cs = FakeClientset()
    controller = Controller(cs, SharedInformerFactory(cs, resync_period=0),
                            config=ControllerConfig(status_url=status_url))
    stop = threading.Event()
    threading.Thread(target=controller.run, args=(2, stop),
                     daemon=True).start()
    try:
        cs.tpujobs.create("default", doc)
        deadline = time.monotonic() + 30
        while len(cs.pods.list("default")) < 2:
            assert time.monotonic() < deadline, "the operator made no pods"
            time.sleep(0.05)
        pods = cs.pods.list("default")
    finally:
        stop.set()
    out = []
    for pod in pods:
        (c,) = pod["spec"]["containers"]
        assert c["resources"]["limits"] == {"nvidia.com/gpu": "2"}
        env = {e["name"]: e["value"] for e in c.get("env", [])}
        out.append((c["command"], env))
    return sorted(out, key=lambda p: int(p[1]["JAX_PROCESS_ID"]))


def _card_stub(behaviour: str, pidfile: Path) -> list:
    return [sys.executable, "-c", textwrap.dedent(f'''
        import os, signal, sys, time
        open({str(pidfile)!r}, "w").write(str(os.getpid()))
        if {behaviour!r} == "ignore":
            signal.signal(signal.SIGTERM, signal.SIG_IGN)
        if {behaviour!r} == "fail":
            time.sleep(0.5)
            raise RuntimeError("this card fails")
        time.sleep(60)
    ''')]


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    out = tmp_path_factory.mktemp("launch")
    status = StatusServer()
    drain_status = StatusServer(drain=True)
    try:
        pods = _operator_pods(status.url)
        # No cluster DNS here: only the coordinator's host becomes
        # 127.0.0.1, and its port a free one; every other variable is the
        # operator's.
        port = _free_port()
        started = {}
        for cmd, env in pods:
            host, _port = env["JAX_COORDINATOR_ADDRESS"].rsplit(":", 1)
            assert host.startswith("tensor-parallel-worker-")
            env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
            argv = ["--device", "cpu", "--cards", "2"] + cmd[3:]
            started[f"pod{env['JAX_PROCESS_ID']}"] = Launch(
                argv, _base_env(env))
        payload = ["--", "transformer", *TINY]
        started["one"] = Launch(["--device", "cpu", "--cards", "1",
                                 *payload], _pod_env(_free_port()))
        started["pair"] = Launch(["--device", "cpu", "--cards", "2",
                                  *payload], _pod_env(_free_port()))
        ck = out / "ck"
        started["sigterm"] = Launch(
            ["--device", "cpu", "--cards", "2", "--", "transformer", *LONG,
             "--checkpoint-dir", str(ck), "--checkpoint-every", "1000000"],
            _pod_env(_free_port()))
        # Two pods of two cards: the directive reaches pod 0's card 0 and
        # must carry to all four processes.
        port = _free_port()
        for pod in (0, 1):
            started[f"drain{pod}"] = Launch(
                ["--device", "cpu", "--cards", "2", "--", "transformer",
                 *LONG, "--checkpoint-dir", ""],
                _pod_env(port, JAX_PROCESS_ID=str(pod),
                         JAX_NUM_PROCESSES="2",
                         TPUJOB_STATUS_URL=drain_status.url,
                         TPUJOB_NAME="drain",
                         TPUJOB_HEARTBEAT_INTERVAL="0"))
        started["sigterm"].wait_for(r"^\[card 0\] .* step 2 loss ")
        started["sigterm"].proc.send_signal(signal.SIGTERM)
        results = {name: job.finish() for name, job in started.items()}
        yield {"results": results, "beats": status.beats,
               "drain_beats": drain_status.beats, "ck": ck}
    finally:
        status.close()
        drain_status.close()


def test_operator_pods_form_one_tp2_group_per_pod(jobs):
    """Pod p's two cards are processes 2p and 2p + 1 of 4, and each pod's
    cards are one model group: TP over the pod's cards, data across the
    pods."""
    for pod in (0, 1):
        code, lines = jobs["results"][f"pod{pod}"]
        assert code == 0, "\n".join(lines[-40:])
        for card in (0, 1):
            assert model_group(lines, card) == (2 * pod + card, 4,
                                                [2 * pod, 2 * pod + 1])


def test_operator_pods_train_like_one_process(jobs):
    """The four processes log the same losses. Against one process that
    holds the same work with its two TP shards as units: the data split
    sums each step's loss in another order, so f32 rounding only on step
    1 (1e-6 relative), and steps 2-3 start from params updated with
    gradients summed in another order (5e-3 absolute), the bounds of
    tests/test_torch_tp_multiprocess.py for the Ulysses pair."""
    got = [losses(jobs["results"][f"pod{pod}"][1], card)
           for pod in (0, 1) for card in (0, 1)]
    assert len(got[0]) == 3
    assert all(g == got[0] for g in got), got
    code, lines = jobs["results"]["one"]
    assert code == 0, "\n".join(lines[-40:])
    one = losses(lines, 0)
    np.testing.assert_allclose(got[0][0], one[0], rtol=1e-6)
    np.testing.assert_allclose(got[0], one, rtol=0, atol=5e-3)


def test_one_pod_of_two_cards_is_bit_equal_to_one_process(jobs):
    """TP 2 alone over a pod's two cards: each shard's arithmetic is the
    same wherever it runs and the partials add in shard order, so every
    loss is bit-equal to the one process holding both shards."""
    code, lines = jobs["results"]["pair"]
    assert code == 0, "\n".join(lines[-40:])
    one = losses(jobs["results"]["one"][1], 0)
    assert losses(lines, 0) == losses(lines, 1) == one


def test_heartbeats_keep_the_pods_identity(jobs):
    """Only each pod's card 0 beats, under the pod's operator id: pod 0
    the full stream (loss), pod 1 cadence-only beats."""
    beats = jobs["beats"]
    assert {b["processId"] for b in beats} == {0, 1}
    assert any("loss" in b for b in beats if b["processId"] == 0)
    assert not any("loss" in b for b in beats if b["processId"] == 1)
    assert any("step" in b for b in beats if b["processId"] == 1)
    # The startup stages come from pod 0's card 0 alone.
    assert {b["processId"] for b in beats if "startupStage" in b} <= {0}


def _drained_at(lines, code: int):
    """{card: step} of the cards that logged a drain exit with ``code``."""
    at = {}
    for card in (0, 1):
        for ln in card_lines(lines, card):
            m = re.search(r"drain: (?:checkpointed step (\d+), exiting "
                          r"(\d+)|exiting (\d+) at step (\d+))", ln)
            if m:
                step, got = (m.group(1), m.group(2)) if m.group(1) \
                    else (m.group(4), m.group(3))
                assert int(got) == code, ln
                at[card] = int(step)
    return at


def test_sigterm_drains_every_card_at_one_step(jobs):
    """SIGTERM to the launcher reaches both cards; they agree on one step
    boundary, save the checkpoint of that step, exit 143, and so does the
    launcher."""
    code, lines = jobs["results"]["sigterm"]
    assert code == bootstrap.EXIT_RETRYABLE, "\n".join(lines[-40:])
    at = _drained_at(lines, bootstrap.EXIT_RETRYABLE)
    assert set(at) == {0, 1} and at[0] == at[1] >= 2, at
    assert (jobs["ck"] / str(at[0])).is_dir(), sorted(os.listdir(jobs["ck"]))


def test_drain_directive_exits_160_everywhere(jobs):
    """Two pods of two cards. The directive rides the beat ACK of pod 0's
    card 0, global rank 0 (pod 1's card 0 sends cadence-only beats, the
    other cards none, and none of them takes it); the world's max
    carries it to all four processes: they drain at one step and exit
    160, and so do both launchers."""
    steps, took = set(), []
    for pod in (0, 1):
        code, lines = jobs["results"][f"drain{pod}"]
        assert code == bootstrap.EXIT_PLANNED, "\n".join(lines[-40:])
        at = _drained_at(lines, bootstrap.EXIT_PLANNED)
        assert set(at) == {0, 1}, at
        steps |= set(at.values())
        took += [(pod, card) for card in (0, 1)
                 if any("drain directive d-1" in ln
                        for ln in card_lines(lines, card))]
    assert len(steps) == 1
    assert took == [(0, 0)]
    assert {b["processId"] for b in jobs["drain_beats"]} == {0, 1}


def test_a_failed_card_stops_the_pod(tmp_path):
    """Card 1 raises (exit 1); card 0 ignores SIGTERM and card 2 dies of
    it: the launcher exits 1 (the codes it forced do not count), and no
    card outlives the grace period."""
    pids = [tmp_path / f"card{c}.pid" for c in range(3)]
    script = textwrap.dedent(f'''
        import sys
        from tpu_operator_torch.payload import launch
        cmds = {[_card_stub(b, p) for b, p in
                 zip(("ignore", "fail", "sleep"), pids)]!r}
        sys.exit(launch.supervise(cmds, [None] * 3, grace=1.0))
    ''')
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert time.monotonic() - t0 < 20
    assert "this card fails" in proc.stdout
    for pidfile in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(int(pidfile.read_text()), 0)


def test_chip_smoke_runs_the_example_payload_as_written():
    """``chip_smoke.py --launch-cards 4`` runs the example's payload line
    (after the launcher's ``--``) as the file writes it."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    with open(EXAMPLE, encoding="utf-8") as f:
        (doc,) = [d for d in yaml.safe_load_all(f) if d]
    (container,) = doc["spec"]["replicaSpecs"][0]["template"]["spec"][
        "containers"]
    cmd = container["command"]
    assert cmd[cmd.index("--") + 1:] == chip_smoke.GPUJOB_TP_PAYLOAD


# --- (d) serve pods and the refusals ---------------------------------------------


@pytest.mark.parametrize("payload,env,cards", [
    ("serve", {}, 2), ("serve", {"TPUJOB_SERVE": "1"}, 4),
    ("transformer", {"TPUJOB_SERVE": "1"}, 2), ("serve", {}, 1)],
    ids=["serve-2", "serve-mode-4", "serve-mode-transformer-2", "serve-1"])
def test_a_serve_pod_plans_one_process_for_its_cards(payload, env, cards):
    """A serve pod (the serve payload, or TPUJOB_SERVE=1) of C cards is
    one process: the pod's rank and world pass through (serve replicas
    form no group), it beats under the pod's id, and it is told C."""
    env = {**env, "JAX_PROCESS_ID": "3", "JAX_NUM_PROCESSES": "1",
           "TPUJOB_STATUS_URL": "http://status:8080", "TPUJOB_NAME": "svc"}
    commands, envs, _ = launch.plan(
        ["--device", "cpu", "--cards", str(cards), "--", payload], env)
    assert len(commands) == len(envs) == 1
    (e,) = envs
    assert (e["JAX_PROCESS_ID"], e["JAX_NUM_PROCESSES"]) == ("3", "1")
    assert e[heartbeat.ENV_BEAT_ID] == "3"
    assert e[bootstrap.ENV_POD_CARDS] == str(cards)
    info = bootstrap.process_info_from_env(e)
    assert (info.process_id, info.num_processes, info.pod_cards) \
        == (3, 1, cards)
    reporter = heartbeat.from_env(e)
    assert (reporter.process_id, reporter.cadence_only) == (3, True)
    assert commands[0][-2:] == ["--device", "cpu"]
    assert commands[0][2] == f"tpu_operator_torch.payload.{payload}"


def test_a_serve_pod_of_two_cards_serves_end_to_end():
    """``launch --device cpu --cards 2 -- serve ...``: one process drives
    two CPU cards behind one HTTP ingress, answers a request, logs each
    card's counts, and the pod exits 0."""
    port = _free_port()
    pod = Launch(["--device", "cpu", "--cards", "2", "--", "serve",
                  "--vocab", "32", "--dim", "16", "--heads", "2",
                  "--kv-heads", "1", "--layers", "2", "--window", "16",
                  "--decode-tokens", "4", "--batch", "4", "--load", "20:1",
                  "--http-port", str(port), "--checkpoint-dir", ""],
                 _pod_env(_free_port(), TPUJOB_SERVE="1"))
    result = {}
    body = json.dumps({"prompt": [3, 1, 4, 1, 5], "maxTokens": 4}).encode()
    deadline = time.monotonic() + TIMEOUT
    while time.monotonic() < deadline and pod.proc.poll() is None:
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/decode", data=body,
                method="POST")
            with urllib.request.urlopen(req, timeout=60) as resp:
                result = json.loads(resp.read())
            break
        except (ConnectionError, urllib.error.URLError):
            time.sleep(0.02)
    code, lines = pod.finish()
    assert code == 0, "\n".join(lines[-40:])
    assert len(result.get("tokens", [])) == 4, "\n".join(lines[-40:])
    assert not card_lines(lines, 1)  # one process for the pod
    cards = [json.loads(ln.split("serve card ", 1)[1].split(": ", 1)[1])
             for ln in card_lines(lines, 0) if "serve card " in ln]
    assert [(c["card"], c["slots"]) for c in cards] == [(0, 2), (1, 2)]
    assert sum(c["completed"] for c in cards) >= 2
    assert all(c["launches"] == dict.fromkeys(c["launches"], 0)
               for c in cards)  # the CPU runs the plain paths


def test_chip_smoke_runs_the_serve_example_payload():
    """``chip_smoke.py --serve-cards N`` runs examples/torch/gpujob-serve.yml's
    payload line as the file writes it, but for its ``--load`` (200:0
    holds forever), which it replaces by a finite schedule."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    with open(REPO / "examples" / "torch" / "gpujob-serve.yml",
              encoding="utf-8") as f:
        (doc,) = [d for d in yaml.safe_load_all(f) if d]
    assert doc["spec"]["mode"] == "serve"
    (container,) = doc["spec"]["replicaSpecs"][0]["template"]["spec"][
        "containers"]
    cmd = container["command"]
    assert cmd[:4] == ["python", "-m", "tpu_operator_torch.payload.launch",
                       "--"]
    assert container["resources"]["limits"]["nvidia.com/gpu"] == "4"
    line = cmd[cmd.index("--") + 1:]
    ran = chip_smoke.serve_cards_payload()
    load = line.index("--load")
    assert line[load + 1] == "200:0" and ran[load + 1] != "200:0"
    assert ran[:load + 1] + ran[load + 2:] == line[:load + 1] + line[load + 2:]
    assert ran[load + 1] == chip_smoke.SERVE_CARDS_LOAD


def test_a_pod_with_no_card_raises():
    """No CUDA device here and no --device cpu: the launcher raises and
    nothing falls back to the CPU; the CLI exits 1."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.plan(["--", "transformer"], {})
    assert launch.main(["--", "transformer"]) == 1
    with pytest.raises(ValueError, match="unknown payload"):
        launch.plan(["--device", "cpu", "--", "bench"], {})
