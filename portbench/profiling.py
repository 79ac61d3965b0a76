"""Short traced windows under ``torch.profiler``, reduced to plain data
that the per-layer readers take.

A traced run takes two windows one after the other. The ``device`` window
traces the card alone, which costs the host little: the card's busy time
and its idle share, and the operations that took the most card time, come
from it. The ``host`` window traces the host's ranges too (the program's
custom ops, the harness's ``record_function`` ranges), which slows the
host's dispatch: each range's card time, and what the host was doing in
the card's idle stretches, come from it.

:func:`reduce` keeps, in seconds of the profiler's clock (the wall clock,
``time.time()``):

- ``busy``: the union of the card's operations (kernels, copies, sets;
  not the ranges the profiler mirrors onto the card's timeline), and
  ``busy_s`` / ``window_s``;
- ``device_ops``: the ten operations that took the most card time;
- ``ops``: each outermost call of the named host ranges with its start,
  end, input shapes and the card time of every operation launched while
  it ran (a launch belongs to a range when the host issued it inside it);
- ``idle_gaps``: the card's longest idle stretches, summed by the
  innermost host range running at each one's middle.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

Interval = Tuple[float, float]
LAUNCHES = ("cuda_runtime", "cuda_driver")


class Window:
    """One traced window; ``host``: trace the host's ranges as well as the
    card (``cuda``). The profiler's library has to be first started on the
    main thread; a host window traces the thread that starts it."""

    def __init__(self, cuda: bool, host: bool):
        self.cuda = cuda
        self.prof = None
        self.t0 = self.t1 = 0.0
        acts = torch.profiler.ProfilerActivity
        self.activities = ([acts.CPU] if host or not cuda else []) \
            + ([acts.CUDA] if cuda else [])
        self.shapes = host

    def start(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=self.activities,
                                           record_shapes=self.shapes)
        self.prof.__enter__()
        self.t0 = time.time()

    def stop(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self.t1 = time.time()
        self.prof.__exit__(None, None, None)

    @property
    def running(self) -> bool:
        return self.prof is not None and not self.t1

    @property
    def done(self) -> bool:
        return bool(self.t1)


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def covered(merged: Sequence[Interval], span: Interval) -> float:
    """Seconds of ``span`` that the merged intervals cover."""
    a, b = span
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged
               if y > a and x < b)


def _kind(evt) -> str:
    kind = getattr(evt, "activity_type", None)
    return str(kind()) if callable(kind) else ""


def _is_launch(evt) -> bool:
    """A host-side call of the CUDA runtime or driver (a launch, a copy,
    a set): its correlation id is the one of the card's operation."""
    name = evt.name()
    return _kind(evt) in LAUNCHES or name.startswith("cuda") \
        or (name.startswith("cu") and name[2:3].isupper())


def reduce(window: Window, op_names: Sequence[str] = ()) -> Dict:
    """The window's trace as plain data (see the module docstring)."""
    device: List[Tuple[str, float, float, int]] = []
    host: List[Tuple[str, float, float]] = []
    launches: List[Tuple[float, int]] = []
    wanted = set(op_names)
    calls: Dict[str, List[Dict]] = {n: [] for n in op_names}
    for e in window.prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        on_device = str(e.device_type()).split(".")[-1] != "CPU"
        if e.is_user_annotation() or _kind(e).startswith("gpu_user"):
            if not on_device:
                host.append((e.name(), start, end))
                if e.name() in wanted:
                    calls[e.name()].append({"start": start, "end": end,
                                            "shapes": []})
            continue
        if on_device:
            device.append((e.name(), start, end, e.correlation_id()))
        elif _is_launch(e):
            launches.append((start, e.correlation_id()))
        else:
            host.append((e.name(), start, end))
            if e.name() in wanted:
                calls[e.name()].append({
                    "start": start, "end": end,
                    "shapes": [list(s) for s in (e.shapes() or [])]})
    busy = merge((a, b) for _, a, b, _ in device)
    by_corr: Dict[int, float] = {}
    for _, a, b, corr in device:
        by_corr[corr] = by_corr.get(corr, 0.0) + (b - a)
    launches.sort()
    at = np.array([t for t, _ in launches])
    ops = {}
    for name, found in calls.items():
        found.sort(key=lambda c: c["start"])
        outer: List[Dict] = []
        for c in found:
            if outer and c["end"] <= outer[-1]["end"]:
                continue  # the same range nested in itself
            lo, hi = np.searchsorted(at, [c["start"], c["end"]])
            c["device_s"] = sum(by_corr.get(launches[i][1], 0.0)
                                for i in range(lo, hi))
            outer.append(c)
        ops[name] = outer
    totals: Dict[str, float] = {}
    for name, a, b, _ in device:
        totals[name] = totals.get(name, 0.0) + (b - a)
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    span = (window.t0, window.t1)
    linked = {c for _, c in launches}
    counts = {"device": len(device), "launches": len(launches),
              "host": len(host),
              "linked": sum(1 for *_, c in device if c in linked),
              "ranges": {n: len(v) for n, v in ops.items()}}
    return {"window_s": window.t1 - window.t0, "counts": counts,
            "busy_s": covered(busy, span), "span": span,
            "busy": busy, "ops": ops,
            "device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": idle_gaps(busy, host, span) if host else []}


def idle_gaps(busy: Sequence[Interval], host: Sequence[Tuple[str, float,
                                                              float]],
              span: Interval, named: int = 200) -> List[List]:
    """The card's idle stretches inside ``span``, summed by the innermost
    host range running at each one's middle (the ``named`` longest; the
    rest as one entry); the ten largest sums."""
    inside = [(max(a, span[0]), min(b, span[1])) for a, b in busy
              if b > span[0] and a < span[1]]
    edges = [span[0]] + [t for iv in inside for t in iv] + [span[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    starts = np.array([a for _, a, _ in host])
    ends = np.array([b for _, _, b in host])
    sums: Dict[str, float] = {}
    for i, (a, b) in enumerate(gaps):
        name = "shorter gaps"
        if i < named:
            mid = 0.5 * (a + b)
            hit = np.nonzero((starts <= mid) & (ends >= mid))[0]
            name = host[hit[np.argmin(ends[hit] - starts[hit])]][0] \
                if len(hit) else "no host range"
        sums[name[:160]] = sums.get(name[:160], 0.0) + (b - a)
    return [[n, s] for n, s in
            sorted(sums.items(), key=lambda kv: -kv[1])[:10]]


def combine(device: Dict, host: Optional[Dict]) -> Dict:
    """A traced run's trace: the device window's busy time and operations,
    the host window's ranges and idle stretches."""
    out = dict(device)
    out["ops"] = host["ops"] if host else {}
    out["idle_gaps"] = host["idle_gaps"] if host else []
    out["counts"] = {"device": device["counts"],
                     "host": host["counts"] if host else None}
    return out


def op_calls(trace: Optional[Dict], name: str) -> List[Dict]:
    return [] if trace is None else trace["ops"].get(name, [])


def busy_within(trace: Dict, spans: Sequence[Interval]) -> Tuple[float,
                                                                 float]:
    """(busy, total) seconds of the card inside the given spans (wall
    clock) that lie in the device window."""
    busy = trace["busy"]
    a0, a1 = trace["span"]
    inside = [(a, b) for a, b in spans if a >= a0 and b <= a1]
    return (sum(covered(busy, s) for s in inside),
            sum(b - a for a, b in inside))
