"""The port's spans (``steptrace.span``) on the CPU: off by default at no
cost per site, what they record when on, their place on the profiler's
clock, the serve loop's repaired flight recorder and its spans, and the
training step's phases."""

import collections
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tpu_operator_torch.payload import bootstrap
from tpu_operator_torch.payload import serve
from tpu_operator_torch.payload import steptrace
from tpu_operator_torch.payload import transformer

WINDOW, NEW, VOCAB = 16, 4, 32
TINY = ["--dim", "64", "--layers", "2", "--heads", "4", "--kv-heads", "2",
        "--vocab", "256", "--seq-len", "64", "--batch", "4",
        "--grad-accum", "2", "--log-every", "0", "--seed", "0",
        "--checkpoint-dir", "", "--profile-dir", "", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _spans_off_and_empty():
    """Each test starts and ends with spans off and an empty log, on one
    torch thread (the tiny CPU serve loop's timing)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    steptrace.trace_spans(False)
    steptrace.clear_spans()
    yield
    steptrace.trace_spans(False)
    steptrace.clear_spans()
    torch.set_num_threads(threads)


class Counting:
    """Counts the calls of a wrapped callable."""

    def __init__(self, real):
        self.real = real
        self.calls = 0

    def __call__(self, *a, **k):
        self.calls += 1
        return self.real(*a, **k)


class FakeEvent:
    """A CUDA event for a CPU test: stamps the host clock when recorded;
    complete once the test says so or something waits on it."""

    made = 0
    done = False

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.at = None
        self.synced = False

    def record(self, stream=None):
        self.at = time.perf_counter()
        self.synced = False

    def query(self):
        return FakeEvent.done or self.synced

    def synchronize(self):
        self.synced = True

    def elapsed_time(self, end):
        assert end.query()  # and so the start, earlier on the stream
        return (end.at - self.at) * 1e3


@pytest.fixture
def fake_cuda(monkeypatch):
    FakeEvent.made, FakeEvent.done = 0, False
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None:
                        None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return FakeEvent


# --- the facility ----------------------------------------------------------------


def test_off_spans_read_no_clock_make_no_event_and_enter_no_range(
        monkeypatch, fake_cuda):
    ranges = Counting(torch.autograd.profiler.record_function)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", ranges)

    class Clock:
        reads = 0

        def __getattr__(self, name):
            Clock.reads += 1
            return getattr(time, name)

    monkeypatch.setattr(steptrace, "time", Clock())
    card = torch.device("cuda", 0)
    for i in range(100):
        with steptrace.span("kvcache.decode") as attrs:
            assert attrs is None
            steptrace.mark(attrs, "read_ns")
        with steptrace.span("train.forward", card, microbatch=i):
            pass
    assert (Clock.reads, fake_cuda.made, ranges.calls) == (0, 0, 0)
    assert steptrace.span_log()["spans"] == []
    # One shared context while off.
    assert steptrace.span("a") is steptrace.span("b", card)


def test_on_spans_keep_names_nesting_and_attrs_in_a_bounded_ring(
        monkeypatch):
    steptrace.trace_spans(True)
    with steptrace.span("outer", card=1) as attrs:
        with steptrace.span("inner", microbatch=0):
            pass
        steptrace.mark(attrs, "read_ns")
        with steptrace.span("inner", microbatch=1):
            pass
    spans = steptrace.span_log()["spans"]
    assert [s["name"] for s in spans] == ["inner", "inner", "outer"]
    assert [s["depth"] for s in spans] == [1, 1, 0]
    read = spans[-1]["attrs"].pop("read_ns")
    assert [s["attrs"] for s in spans] == [
        {"microbatch": 0}, {"microbatch": 1}, {"card": 1}]
    outer = spans[-1]
    for inner in spans[:2]:
        assert outer["t0"] <= inner["t0"] <= inner["t1"] <= outer["t1"]
    assert spans[0]["t1"] <= read <= spans[1]["t0"]
    assert all("device_ms" not in s for s in spans)  # no card given
    # Bounded: the newest spans stay.
    monkeypatch.setattr(steptrace, "_spans", collections.deque(maxlen=8))
    for i in range(20):
        with steptrace.span("s", i=i):
            pass
    assert [s["attrs"]["i"] for s in steptrace.span_log()["spans"]] \
        == list(range(12, 20))
    assert steptrace.SPAN_CAPACITY >= 16 * steptrace.DEFAULT_BUFFER_STEPS


def test_card_times_resolve_at_a_fence_and_reuse_their_events(fake_cuda):
    steptrace.trace_spans(True)
    card = torch.device("cuda", 0)
    with steptrace.span("train.forward", card):
        time.sleep(0.002)
    steptrace.resolve_spans()  # the end event has not completed
    assert "device_ms" not in steptrace._spans[-1]
    fake_cuda.done = True
    steptrace.resolve_spans()
    assert steptrace._spans[-1]["device_ms"] >= 2.0
    for _ in range(10):
        with steptrace.span("train.forward", card):
            pass
        steptrace.resolve_spans()
    assert fake_cuda.made == 2  # one pair, reused
    # Unfenced spans: the log waits for them.
    fake_cuda.done = False
    with steptrace.span("train.optimizer", card):
        pass
    spans = steptrace.span_log()["spans"]
    assert len(spans) == 12 and all("device_ms" in s for s in spans)


def test_spans_follow_a_profiler_window_and_enter_its_ranges(monkeypatch):
    ranges = Counting(torch.autograd.profiler.record_function)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", ranges)
    anchor = steptrace.span_log()["anchor"]
    assert not steptrace.follow_profiler()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert steptrace.follow_profiler()
        with steptrace.span("serve.admit", card=0):
            pass
    assert not steptrace.follow_profiler()
    with steptrace.span("serve.admit", card=0):
        pass
    assert ranges.calls == 1
    assert [s["name"] for s in steptrace.span_log()["spans"]] \
        == ["serve.admit"]
    # Switched on, spans stay on without a window, and enter no range.
    steptrace.trace_spans(True)
    assert steptrace.follow_profiler()
    with steptrace.span("serve.admit", card=0):
        pass
    assert ranges.calls == 1 and len(steptrace.span_log()["spans"]) == 2
    # One anchor for the log, however often spans come on.
    assert steptrace.span_log()["anchor"] == anchor


def test_spans_map_onto_the_profilers_clock_within_a_millisecond():
    """Each span, placed through the log's anchor on the profiler's epoch
    clock, lies within 1 ms of its ``record_function`` range at both
    ends. (A process's first ``record_function`` pays a one-off setup
    inside its range, so a throwaway window takes it first.)"""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.autograd.profiler.record_function("warm"):
            pass
    names = [f"span{i}" for i in range(6)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        steptrace.follow_profiler()
        for name in names:
            with steptrace.span(name):
                torch.ones(64, 64) @ torch.ones(64, 64)
                time.sleep(0.003)
    steptrace.follow_profiler()
    log = steptrace.span_log()
    anchor = log["anchor"]
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in names}
    assert set(ranges) == set(names)
    for s in log["spans"]:
        event = ranges[s["name"]]
        t0 = anchor["epoch_ns"] + s["t0"] - anchor["perf_ns"]
        t1 = anchor["epoch_ns"] + s["t1"] - anchor["perf_ns"]
        assert abs(event.start_ns() - t0) < 1e6, s["name"]
        assert abs(event.start_ns() + event.duration_ns() - t1) < 1e6


# --- the serve loop ---------------------------------------------------------------


def serve_args(**kw):
    defaults = {"load": "0:0.3", "batch": 2, "decode_tokens": NEW,
                "window": WINDOW, "vocab": VOCAB, "dim": 16, "heads": 2,
                "kv_heads": 1, "layers": 2, "device": "cpu",
                "checkpoint_dir": ""}
    defaults.update(kw)
    argv = []
    for key, value in defaults.items():
        argv.extend([f"--{key.replace('_', '-')}", str(value)])
    return serve.parse_args(argv)


def test_serve_loop_stamps_requests_and_times_admission_and_dispatch():
    steptrace.trace_spans(True)
    recorder = steptrace.StepRecorder(capacity=4096)
    loop = serve.ServeLoop(serve_args(), bootstrap.process_info_from_env({}),
                           heartbeat=None, recorder=recorder)
    engine = loop.cards[0].engine
    admit, step = engine.admit, engine.step
    admitted_at, step_walls = set(), {}

    def timed_admit(*a):
        admitted_at.add(loop.steps)
        return admit(*a)

    def timed_step(*a):
        t0 = time.perf_counter()
        out = step(*a)
        step_walls[loop.steps] = time.perf_counter() - t0
        return out

    engine.admit, engine.step = timed_admit, timed_step
    rng = np.random.default_rng(0)
    reqs = [loop.submit(rng.integers(0, VOCAB, size=int(n)).astype(np.int32),
                        NEW) for n in rng.integers(3, WINDOW, size=6)]
    summary = loop.run()
    assert summary["completed"] == len(reqs)
    assert all(len(req.tokens) == NEW for req in reqs)
    rows = {r["step"]: r for r in recorder.snapshot()}
    assert set(step_walls) == set(rows)
    for i, row in rows.items():
        phases = {k: v for k, v in row.items()
                  if k not in ("step", "stepSeconds")}
        assert set(phases) == {"dataWait", "dispatch", "compute", "host"}
        assert abs(sum(phases.values()) - row["stepSeconds"]) < 1e-5
        # The decode step lies inside dispatch + compute (6-digit rounding).
        assert row["dispatch"] + row["compute"] >= step_walls[i] - 2e-6
        assert row["dispatch"] > 0 and row["compute"] > 0
    admitting = admitted_at & set(rows)
    assert admitting
    assert all(rows[i]["dataWait"] > 0 for i in admitting)
    spans = steptrace.span_log()["spans"]
    names = collections.Counter(s["name"] for s in spans)
    # The warm-up's prefill and step are spanned too.
    assert names["serve.admit"] == names["kvcache.prefill"] - 1 == len(reqs)
    assert names["kvcache.decode"] == summary["cards"][0]["decodeSteps"]
    by_name = collections.defaultdict(list)
    for s in spans:
        by_name[s["name"]].append(s)
    for s in by_name["kvcache.decode"] + by_name["kvcache.prefill"]:
        assert s["t0"] <= s["attrs"]["read_ns"] <= s["t1"]
    # Each loop step's decode span: its launches inside DISPATCH, the
    # whole span inside DISPATCH + COMPUTE.
    decodes = by_name["kvcache.decode"][-len(rows):]
    for (_i, row), s in zip(sorted(rows.items()), decodes):
        assert row["dispatch"] >= (s["attrs"]["read_ns"] - s["t0"]) * 1e-9 \
            - 2e-6
        assert row["dispatch"] + row["compute"] \
            >= (s["t1"] - s["t0"]) * 1e-9 - 2e-6
    assert [s["attrs"] for s in by_name["serve.admit"]] \
        == [{"card": 0}] * len(reqs)
    assert [s["depth"] for s in by_name["kvcache.prefill"]] \
        == [0] + [1] * len(reqs)  # inside serve.admit


def test_serve_loop_without_spans_keeps_its_stamps_and_logs_nothing():
    """Spans off: the flight recorder still laps DISPATCH at the token
    read, and the log stays empty."""
    recorder = steptrace.StepRecorder(capacity=4096)
    loop = serve.ServeLoop(serve_args(), bootstrap.process_info_from_env({}),
                           heartbeat=None, recorder=recorder)
    req = loop.submit(np.arange(5, dtype=np.int32), NEW)
    loop.run()
    assert len(req.tokens) == NEW
    rows = recorder.snapshot()
    assert rows and all(r["dispatch"] > 0 and r["compute"] > 0
                        for r in rows)
    assert steptrace.span_log()["spans"] == []


# --- the training step ------------------------------------------------------------


def test_train_step_spans_each_microbatch_and_the_update():
    args = transformer.parse_args(TINY)
    built = transformer.build(args)
    tokens = torch.randint(0, 256, (4, 64))
    built.step(tokens)  # off: nothing
    assert steptrace.span_log()["spans"] == []
    steptrace.trace_spans(True)
    for _ in range(3):
        built.step(tokens)
    spans = steptrace.span_log()["spans"]
    names = collections.Counter(s["name"] for s in spans)
    assert names == {"train.forward": 6, "train.backward": 6,
                     "train.optimizer": 3, "train.step": 3}
    assert [s["attrs"]["microbatch"] for s in spans
            if s["name"] == "train.forward"] == [0, 1] * 3
    steps = [s for s in spans if s["name"] == "train.step"]
    for s in spans:
        assert s["depth"] == (0 if s["name"] == "train.step" else 1)
        assert any(w["t0"] <= s["t0"] <= s["t1"] <= w["t1"] for w in steps)


def test_profile_dir_window_carries_the_step_spans_and_ends_them(tmp_path):
    args = transformer.parse_args(TINY + ["--steps", "14", "--profile-dir",
                                          str(tmp_path / "p")])
    transformer.run(bootstrap.process_info_from_env({}), args)
    (trace,) = os.listdir(tmp_path / "p")
    events = json.loads(open(tmp_path / "p" / trace).read())["traceEvents"]
    names = collections.Counter(e.get("name") for e in events)
    # Steps 11-14 of the window, two microbatches each.
    assert names["train.forward"] == names["train.backward"] == 8
    assert names["train.optimizer"] == 4
    assert not steptrace.follow_profiler()
    assert len([s for s in steptrace.span_log()["spans"]
                if s["name"] == "train.step"]) == 4


def test_threads_record_and_read_the_log_at_once():
    """Writers on many threads and a reader: no span is lost, and each
    thread's nesting stays its own."""
    steptrace.trace_spans(True)
    writers, each = 12, 300
    stop = threading.Event()
    seen = []

    def write(k):
        for i in range(each):
            with steptrace.span("outer", thread=k, i=i):
                with steptrace.span("inner", thread=k, i=i):
                    pass

    def read():
        while not stop.is_set():
            seen.append(len(steptrace.span_log()["spans"]))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        reader = threading.Thread(target=read)
        reader.start()
        threads = [threading.Thread(target=write, args=(k,))
                   for k in range(writers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stop.set()
        reader.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not reader.is_alive() and not any(t.is_alive() for t in threads)
    spans = steptrace.span_log()["spans"]
    assert len(spans) == 2 * writers * each <= steptrace.SPAN_CAPACITY
    assert all(s["depth"] == (s["name"] == "inner") for s in spans)
    got = collections.Counter((s["name"], s["attrs"]["thread"]) for s in spans)
    assert set(got.values()) == {each}
    assert seen and seen == sorted(seen)
