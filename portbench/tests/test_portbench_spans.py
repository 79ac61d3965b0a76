"""The readers of the program's own spans (``portbench/spans.py`` and the
metrics that read it): on the cells' CPU forms, on a made log whose
numbers are known, and against a program that keeps no spans."""

import math

import pytest

from portbench import harness
from portbench import spans as spans_mod
from portbench.tests import tiny

MANIFEST = harness.load_json(tiny.ROOT / harness.MANIFEST)
SPAN_METRICS = {
    "serve.flagship-gqa.chat": ["serve.prefill_device_ms",
                                "serve.decode_dispatch_ms",
                                "serve.decode_device_ms",
                                "idle.serve.dispatch"],
    "train.flagship-gqa": ["train.forward_device_ms",
                           "train.backward_device_ms",
                           "train.optimizer_device_ms"],
}
# Those a CPU run can give: the rest read card times or the card's busy
# intervals.
ON_THE_CPU = {"serve.decode_dispatch_ms"}


def reader(name):
    return harness.load_module(tiny.ROOT / "portbench" / "metrics"
                               / f"{name}.py", "spans_test_" + name)


@pytest.fixture(autouse=True)
def _spans_off():
    from tpu_operator_torch.payload import steptrace

    steptrace.trace_spans(False)
    steptrace.clear_spans()
    yield
    steptrace.trace_spans(False)
    steptrace.clear_spans()


def test_each_span_metric_lists_its_cell():
    entries = {m["name"]: m for m in MANIFEST["per_layer"]}
    for cell, names in SPAN_METRICS.items():
        for name in names:
            assert entries[name]["workloads"] == [cell]


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_readers_on_the_cpu_form(cell):
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        _line, run = harness.run_cell(tiny.cell(cell, 2 ** 31 + 5, True))
    finally:
        torch.set_num_threads(threads)
    found = spans_mod.in_device_window(run, {
        "serve.admit", "kvcache.decode", "train.step"})
    assert found  # the device window held the program's spans
    for name in SPAN_METRICS[cell]:
        value = reader(name).read(run)
        if name in ON_THE_CPU:
            assert isinstance(value, float) and math.isfinite(value) \
                and value > 0, name
        else:
            assert value is None, name


class Run:
    def __init__(self, trace):
        self.trace = trace
        self.data = {}


def made_log(monkeypatch):
    """Spans at known times (ms after 1000 s of the profiler's clock),
    with a device window over [1000 s, 1000.1 s)."""
    anchor = {"epoch_ns": 1000 * 10 ** 9, "perf_ns": 5 * 10 ** 9}

    def at(ms):
        return anchor["perf_ns"] + int(ms * 1e6)

    rows = [
        # Before the window: left out.
        ("serve.admit", -5, -4, {"card": 0}, None),
        ("kvcache.decode", -3, -1, {"read_ns": at(-2)}, None),
        ("serve.admit", 1, 4, {"card": 0}, None),
        ("kvcache.prefill", 1, 4, {"read_ns": at(3)}, None),
        ("kvcache.decode", 10, 18, {"read_ns": at(16)}, None),
        ("kvcache.decode", 20, 26, {"read_ns": at(24)}, None),
        # A training step: two microbatches and the update.
        ("train.forward", 40, 41, {"microbatch": 0}, 1.0),
        ("train.backward", 41, 43, {"microbatch": 0}, 2.0),
        ("train.forward", 43, 44, {"microbatch": 1}, 1.5),
        ("train.backward", 44, 46, {"microbatch": 1}, 2.5),
        ("train.optimizer", 46, 47, {}, 0.5),
        ("train.step", 40, 47, {}, 8.0),
        # Past the window's end: left out.
        ("kvcache.decode", 99, 101, {"read_ns": at(100)}, None),
    ]
    spans = []
    for name, t0, t1, attrs, device_ms in rows:
        s = {"name": name, "t0": at(t0), "t1": at(t1), "attrs": attrs,
             "depth": 0}
        if device_ms is not None:
            s["device_ms"] = device_ms
        spans.append(s)
    monkeypatch.setattr(spans_mod, "log", lambda: {"anchor": anchor,
                                                   "spans": spans})
    # The card busy from 1 ms to 12 ms and from 22 ms to 50 ms (but at
    # 3-4 ms, in the prefill's read).
    return Run({"span": (1000.0, 1000.1), "window_s": 0.1,
                "busy": [(1000.001, 1000.003), (1000.004, 1000.012),
                         (1000.022, 1000.050)],
                "busy_s": 0.038})


def test_readers_on_a_made_log(monkeypatch):
    run = made_log(monkeypatch)
    expect = {
        # Busy 1-3 ms of the prefill [1, 4].
        "serve.prefill_device_ms": 2.0,
        "serve.decode_dispatch_ms": 5.0,  # 6 and 4
        # Busy 10-12 of [10, 18] and 22-26 of [20, 26].
        "serve.decode_device_ms": 3.0,
        # Idle while launching, to each read: in [1, 3] 0, in [10, 16]
        # 12-16, in [20, 24] 20-22: 6 ms of the 100 ms window.
        "idle.serve.dispatch": 6.0,
        "train.forward_device_ms": 2.5,
        "train.backward_device_ms": 4.5,
        "train.optimizer_device_ms": 0.5,
    }
    for name, value in expect.items():
        assert reader(name).read(run) == pytest.approx(value, rel=1e-6), name


def test_readers_give_nothing_without_program_spans(monkeypatch):
    """The parent commit's program keeps no span log: every reader gives
    None, and none raises."""
    from tpu_operator_torch.payload import steptrace

    run = made_log(monkeypatch)
    monkeypatch.undo()
    monkeypatch.delattr(steptrace, "span_log")
    assert spans_mod.log() is None
    for names in SPAN_METRICS.values():
        for name in names:
            assert reader(name).read(run) is None, name
    assert all(reader(n).read(Run(None)) is None
               for names in SPAN_METRICS.values() for n in names)
