"""The program's own spans (``steptrace.span`` in ``tpu_operator_torch``),
as the per-layer readers take them after a traced run.

The program records its spans while a ``torch.profiler`` window runs
(``steptrace.follow_profiler``, checked once a step), so a traced run's
windows hold them with no call from ``drivers/``. The readers keep the
spans that lie inside the device window (the card traced alone), placed
on the profiler's clock through the log's anchor. That window's tracing
costs the host a little on every launch, and the readers' host times
carry that cost. A program without spans (no ``steptrace.span_log``)
gives none, and each reader then gives None.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from portbench import profiling

Span = Dict  # name, t0 / t1 / read (s, the profiler's clock), attrs, ...


def log() -> Optional[Dict]:
    """The program's span log, or None where the program keeps none."""
    from tpu_operator_torch.payload import steptrace

    span_log = getattr(steptrace, "span_log", None)
    return span_log() if span_log is not None else None


def in_device_window(run, names) -> List[Span]:
    """The spans named in ``names`` that began and ended inside the
    traced run's device window, oldest first, with ``t0``, ``t1`` and,
    where the span marked one, ``read`` (its ``read_ns`` attr: where its
    token read begins) in seconds of the profiler's clock
    (``time.time()``)."""
    if run.trace is None:
        return []
    found = log()
    if found is None:
        return []
    anchor = found["anchor"]
    shift = anchor["epoch_ns"] - anchor["perf_ns"]
    a, b = run.trace["span"]
    out = []
    for s in found["spans"]:
        if s["name"] not in names:
            continue
        t0, t1 = (s["t0"] + shift) * 1e-9, (s["t1"] + shift) * 1e-9
        if a <= t0 and t1 <= b:
            placed = {**s, "t0": t0, "t1": t1}
            if "read_ns" in s["attrs"]:
                placed["read"] = (s["attrs"]["read_ns"] + shift) * 1e-9
            out.append(placed)
    return out


def mean_busy_ms(run, name: str) -> Optional[float]:
    """The card's busy time inside each of the window's ``name`` spans
    (the device trace's busy intervals that the span's wall covers),
    averaged over the spans, in ms (None without busy intervals or
    spans)."""
    t = run.trace
    if t is None or not t["busy"]:
        return None
    found = in_device_window(run, {name})
    if not found:
        return None
    return 1e3 * sum(profiling.covered(t["busy"], (s["t0"], s["t1"]))
                     for s in found) / len(found)


def per_step_device_ms(run, name: str) -> Optional[float]:
    """The card time of the ``name`` spans of one training step, summed
    over the step and averaged over the window's whole steps (the
    ``train.step`` spans that hold them), in ms."""
    spans = in_device_window(run, {name, "train.step"})
    steps = [s for s in spans if s["name"] == "train.step"]
    sums = []
    for step in steps:
        inside = [s for s in spans if s["name"] == name
                  and step["t0"] <= s["t0"] and s["t1"] <= step["t1"]]
        if not inside or not all("device_ms" in s for s in inside):
            continue
        sums.append(sum(s["device_ms"] for s in inside))
    return sum(sums) / len(sums) if sums else None
