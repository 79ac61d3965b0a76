"""The port's serve loop (tpu_operator_torch.payload.serve) on the CPU: a
tiny ServeLoop completes a finite synthetic load with nothing shed and no
failed step, answers ``POST /v1/decode`` over HTTP, and frees a finished
request's slot and pages mid-iteration."""

import json
import signal
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tpu_operator.payload import heartbeat as jax_heartbeat
from tpu_operator.payload import steptrace as jax_steptrace
from tpu_operator_torch.payload import bootstrap
from tpu_operator_torch.payload import heartbeat
from tpu_operator_torch.payload import serve
from tpu_operator_torch.payload import steptrace

WINDOW, NEW, VOCAB = 16, 4, 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The loop's timing depends on each tiny CPU step staying fast; with
    several test workers, torch's default of one thread per core
    oversubscribes the machine and stalls steps past the load schedule."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def serve_args(**kw):
    defaults = {"load": "20:0.5", "batch": 2, "decode_tokens": NEW,
                "window": WINDOW, "vocab": VOCAB, "dim": 16, "heads": 2,
                "kv_heads": 1, "layers": 2, "device": "cpu",
                "checkpoint_dir": ""}
    defaults.update(kw)
    argv = []
    for key, value in defaults.items():
        argv.extend([f"--{key.replace('_', '-')}", str(value)])
    return serve.parse_args(argv)


def info():
    return bootstrap.process_info_from_env({})


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_finite_load_completes_and_http_decode_answers():
    port = free_port()
    args = serve_args(http_port=port, load="20:1.5,0:1")
    loop = serve.ServeLoop(args, info(), heartbeat=None, recorder=None)
    result = {}

    def post():
        body = json.dumps({"prompt": [1, 2, 3, 4, 5], "maxTokens": NEW})
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/v1/decode",
                    data=body.encode(), method="POST",
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=60) as resp:
                    result["status"] = resp.status
                    result["body"] = json.loads(resp.read())
                return
            except (ConnectionError, urllib.error.URLError):
                time.sleep(0.01)

    poster = threading.Thread(target=post, daemon=True)
    poster.start()
    summary = loop.run()
    poster.join(timeout=30)
    assert result.get("status") == 200, result
    tokens = result["body"]["tokens"]
    assert len(tokens) == NEW and all(0 <= t < VOCAB for t in tokens)
    assert summary["arrivals"] >= 1
    assert summary["completed"] == summary["arrivals"] + 1
    assert summary["shed"] == 0 and summary["failedSteps"] == 0
    assert summary["tokensGenerated"] == NEW * summary["completed"]
    assert summary["kvCacheUtilization"] == 0.0
    assert "p99LatencySeconds" in summary


def test_bad_http_requests_are_refused():
    port = free_port()
    args = serve_args(http_port=port, load="0:0")
    loop = serve.ServeLoop(args, info(), heartbeat=None, recorder=None)
    loop._start_http()
    try:
        for body in ({"prompt": []}, {"prompt": [VOCAB]},
                     {"prompt": list(range(WINDOW + 1))}):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/decode",
                data=json.dumps(body).encode(), method="POST")
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req, timeout=10)
            assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                   timeout=10)
        assert err.value.code == 503  # not ready before warm-up
    finally:
        loop._http.shutdown()
        loop._http.server_close()


def test_mid_iteration_completion_frees_slot_and_pages():
    """A request finishing mid-iteration frees its slot and its pages at
    once: the next queued request admits in the same admission pass."""
    args = serve_args(load="0:0")
    loop = serve.ServeLoop(args, info(), heartbeat=None, recorder=None)
    prompt = (np.arange(WINDOW) % VOCAB).astype(np.int32)
    short = loop.submit(prompt, 1)
    long1 = loop.submit(prompt, NEW)
    waiting = loop.submit(prompt, NEW)
    loop._admit_from_queue()
    assert short.done.is_set() and len(short.tokens) == 1
    assert not long1.done.is_set()
    loop._admit_from_queue()
    assert loop.queue_depth() == 0
    for _ in range(NEW):
        loop._decode_step()
    assert long1.done.is_set() and len(long1.tokens) == NEW
    assert waiting.done.is_set() and len(waiting.tokens) == NEW
    assert loop.completed == 3
    assert loop.engine.utilization() == 0.0


def test_reforward_engine_serves_the_same_load():
    args = serve_args(decode_engine="reforward", load="10:1")
    summary = serve.ServeLoop(args, info(), heartbeat=None,
                              recorder=None).run()
    assert summary["completed"] == summary["arrivals"] >= 1
    assert summary["shed"] == 0 and summary["failedSteps"] == 0


def test_load_schedule_and_generator():
    sched = serve.LoadSchedule.parse("4:1,2:1")
    assert sched.rate_at(0.5) == 4 and sched.rate_at(1.5) == 2
    assert sched.rate_at(2.5) is None
    gen = serve.LoadGenerator(sched)
    assert gen.due(0.0) == 0
    assert gen.due(0.5) == 2    # 0.5 s at 4 rps
    assert gen.due(1.5) == 2    # the rate at the later time: 2 rps
    assert gen.due(2.5) is None
    assert serve.LoadSchedule.parse("3:0").rate_at(1e9) == 3  # hold


def test_heartbeats_carry_serving_state_and_step_timing():
    beats = []
    reporter = heartbeat.HeartbeatReporter(
        "http://status", "job", interval=0,
        poster=lambda url, body: beats.append((url, body)))
    loop = serve.ServeLoop(serve_args(load="10:1"), info(),
                           heartbeat=reporter,
                           recorder=steptrace.StepRecorder())
    summary = loop.run()
    assert summary["completed"] >= 1
    assert all(url == "http://status/api/heartbeat" for url, _ in beats)
    bodies = [body for _, body in beats]
    assert any(b["serving"]["ready"] for b in bodies)
    timed = [b["stepTiming"] for b in bodies if "stepTiming" in b]
    # Each digest covers a disjoint span; the last steps may follow the
    # last beat.
    assert 0 < sum(t["steps"] for t in timed) <= loop.steps
    assert {"dataWait", "compute", "host"} <= set(timed[0]["phases"])
    assert any("stepTimeSeconds" in b for b in bodies)


def test_heartbeat_and_step_digest_wire_match_the_jax_package():
    """The same calls on the port's copies and on the JAX package's
    modules, under the same clock, post the same bodies: the operator
    reads both payloads' beats alike."""
    def drive(hb_mod, st_mod):
        ticks = iter(np.arange(0.0, 100.0, 0.25))
        clock = lambda: float(next(ticks))  # noqa: E731
        bodies = []
        rec = st_mod.StepRecorder(capacity=16, clock=clock)
        rep = hb_mod.HeartbeatReporter(
            "http://s/", "j", namespace="ns", attempt=2, interval=1.0,
            clock=clock, poster=lambda _url, body: bodies.append(body))
        for step in range(6):
            rec.begin(step)
            for phase in (st_mod.DATA, st_mod.COMPUTE, st_mod.HOST):
                rec.lap(phase)
            rec.commit()
            if rep.due(step):
                rep.report(step, steptiming=rec.summary(),
                           serving={"ready": True, "queueDepth": step})
        return bodies

    ours = drive(heartbeat, steptrace)
    assert ours and ours == drive(jax_heartbeat, jax_steptrace)


def test_run_payload_exit_codes():
    previous = signal.getsignal(signal.SIGTERM)
    try:
        assert bootstrap.run_payload(lambda _info: None) == 0
        assert bootstrap.run_payload(lambda _info: 1 / 0) == 1
        # The installed handler turns SIGTERM into the retryable exit.
        assert bootstrap.run_payload(
            lambda _info: signal.getsignal(signal.SIGTERM)(
                signal.SIGTERM, None)) == bootstrap.EXIT_RETRYABLE == 143
    finally:
        signal.signal(signal.SIGTERM, previous)
