"""Flight recorder: per-step phase timing for the serve and training loops.

Steady-state step time, where a replica spends almost all of its life,
would otherwise be a single averaged ``stepTimeSeconds`` on the
heartbeat, with no split between device work and host work. This module
times the phases:

- :class:`StepRecorder` times each step's phases into a bounded window.
  The step path pays **timestamps only** (one ``clock()`` call and one
  dict store per phase boundary, one lock-guarded append per step);
  percentile aggregation runs off-loop, on the heartbeat cadence.
- :meth:`StepRecorder.summary` drains the since-last-summary window into
  the wire-format digest the heartbeat carries (``stepTiming``): per-phase
  p50/p95/max plus whole-step percentiles. Windowed on purpose — each
  digest describes a disjoint span of steps, so the controller can feed
  histograms without double counting.

Phases (one step, in loop order; the serve loop times DATA, DISPATCH,
COMPUTE and HOST, the training loop DATA, DISPATCH, COMPUTE, CHECKPOINT
and HOST):

- ``DATA`` — input wait before the step. In the serve loop: the loop
  iteration's admission (every prefill included), shedding and reload
  check, from the top of the iteration to the decode step.
- ``DISPATCH`` — the launch of the step's device work. In the serve
  loop: from the decode step's start to just before its token read
  (``kvcache.DecodeEngine``'s ``on_dispatch``), the host's launches of
  every layer; in the
  training loop: the ``train_step`` call, which blocks on a full launch
  queue, so it holds most of the card's time too.
- ``COMPUTE`` — the wait for device work: the decode step's token read,
  or the training loop's fence on the previous step.
- ``CHECKPOINT`` — a checkpoint save at the step boundary.
- ``HOST`` — everything else host-side: token delivery, completions,
  logs, the heartbeat post.

**Spans** (:func:`span`, off by default; :func:`trace_spans` switches
them on, and :func:`follow_profiler` keeps them on for as long as a
``torch.profiler`` window runs) name the program's own work inside a
step: a name, ``t0`` / ``t1`` from ``time.perf_counter_ns()``, attrs, and
for a span given a CUDA device the card time between a pair of CUDA
events at its edges (``device_ms``, resolved once the events are
complete: at a fence the loop already has, :func:`resolve_spans`, or at
:func:`span_log`). Events at a span's edges give the card's elapsed time,
its waits on the host included, so only spans whose launches run ahead of
the card (the training step's) take a device. :func:`mark` stamps a point
inside a span on its clock. Off, a span site reads one module flag and
returns a shared no-op context: no clock, no event, no profiler range.
The log carries one anchor, ``time.time_ns()`` and
``time.perf_counter_ns()`` read together once per log (at import and at
:func:`clear_spans`), which places every span on the profiler's clock
(epoch time). While a profiler window runs, a span also enters a
``record_function`` of its name, so a trace carries the program's names.

| Span | Where | Covers | Card time |
| --- | --- | --- | --- |
| ``serve.admit`` | ``serve.ServeLoop._admit`` | one ``engine.admit`` (attr: ``card``) | no |
| ``kvcache.prefill`` | ``kvcache.DecodeEngine._prefill`` | the forward, argmax and K/V scatter, and the token read (``read_ns``: where the read begins) | no |
| ``kvcache.decode`` | ``kvcache.DecodeEngine._step`` | the whole decode step, its token read included (``read_ns`` as above) | no |
| ``train.step`` | ``train.make_loss_train_step`` | the whole step | yes |
| ``train.forward`` / ``train.backward`` | the same, a microbatch each | ``loss_fn`` / ``.backward()`` (attr: ``microbatch``) | yes |
| ``train.reduce`` | the same | the multi-process gradient reduce | yes |
| ``train.optimizer`` | the same | ``optimizer.step`` | yes |

This is the PyTorch payload's own copy of the part of
``tpu_operator/payload/steptrace.py`` that the two loops use (stdlib
only at import, torch only inside a span that is on; a plain
``threading.Lock`` where the original takes a lock-order-witnessed one).
The wire format is the same, so the operator reads both payloads' digests
alike. The recorder also keeps the last
``capacity`` steps in a ring buffer, which :func:`postmortem_dump` writes
next to the checkpoint dir on a retryable exit
(``steptrace-attempt<N>-p<P>.json``, :func:`postmortem_path`).
"""

from __future__ import annotations

import collections
import json
import logging
import math
import os
import sys
import time
import threading
from typing import Any, Callable, Dict, List, Optional

log = logging.getLogger(__name__)

# Step phases, in loop order.
DATA = "DATA"
DISPATCH = "DISPATCH"
COMPUTE = "COMPUTE"
CHECKPOINT = "CHECKPOINT"
HOST = "HOST"

PHASES = (DATA, DISPATCH, COMPUTE, CHECKPOINT, HOST)

# Wire-format field name per phase: the keys of ``stepTiming.phases`` on
# the heartbeat and in ``status.stepTiming``.
PHASE_FIELDS = {
    DATA: "dataWait",
    DISPATCH: "dispatch",
    COMPUTE: "compute",
    CHECKPOINT: "checkpoint",
    HOST: "host",
}

# Window capacity default (the newest N steps digested per summary).
DEFAULT_BUFFER_STEPS = 512

# Operator env contract (trainer/replicas.py injects when spec.stepTrace
# is present; absent env keeps the recorder on at defaults — it costs
# timestamps only).
ENV_ENABLED = "TPUJOB_STEPTRACE_ENABLED"
ENV_BUFFER = "TPUJOB_STEPTRACE_BUFFER"


def _pct(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted list."""
    if not sorted_vals:
        return 0.0
    rank = max(0, min(len(sorted_vals) - 1,
                      math.ceil(q * len(sorted_vals)) - 1))
    return sorted_vals[rank]


def digest(values: List[float]) -> Dict[str, float]:
    """{p50Seconds, p95Seconds, maxSeconds} of one phase's samples."""
    s = sorted(values)
    return {
        "p50Seconds": round(_pct(s, 0.50), 6),
        "p95Seconds": round(_pct(s, 0.95), 6),
        "maxSeconds": round(s[-1], 6) if s else 0.0,
    }


class StepRecorder:
    """Per-step phase timing into a bounded window.

    Step-loop usage (one thread — the step loop — drives begin/lap/
    commit; ``summary`` may be called from any thread, hence the lock on
    the shared buffers)::

        rec.begin(i)
        active = active_slots();         rec.lap(steptrace.DATA)
        tokens = engine.step(model);     rec.lap(steptrace.COMPUTE)
        deliver(tokens);                 rec.lap(steptrace.HOST)
        rec.commit()

    ``lap`` attributes the time since the previous boundary to the named
    phase (re-entering a phase accumulates). ``clock`` is injectable for
    deterministic tests.
    """

    def __init__(self, capacity: int = DEFAULT_BUFFER_STEPS,
                 clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self.capacity = max(8, int(capacity))
        self._lock = threading.Lock()
        # The last `capacity` committed steps, for the postmortem dump.
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity)  # guarded-by: _lock
        # Since-last-summary window: phase -> samples, whole-step totals,
        # and per-step LOCAL time (total minus the COMPUTE wait) — the
        # straggler detector's signal. Drained and reset by summary();
        # BOUNDED at the capacity because summary() only runs when a
        # heartbeat is wired — a standalone payload (no TPUJOB_STATUS_URL)
        # with the recorder default-ON must not accumulate O(steps) floats
        # forever. A window that hit the bound simply digests the newest
        # `capacity` steps.
        self._window: Dict[str, collections.deque] = {}  # guarded-by: _lock
        self._window_steps: collections.deque = collections.deque(
            maxlen=self.capacity)  # guarded-by: _lock
        self._window_local: collections.deque = collections.deque(
            maxlen=self.capacity)  # guarded-by: _lock
        # In-flight step state: step-loop thread only, never shared.
        self._cur: Optional[Dict[str, Any]] = None
        self._t0 = 0.0
        self._tlast = 0.0
        self.steps_recorded = 0
        # Optional per-step observer (the autotune controller): called on
        # the step-loop thread with each committed record, after the ring
        # bookkeeping and outside the lock. A raising observer is logged
        # and detached; it never breaks the loop.
        self.on_commit: Optional[Callable[[Dict[str, Any]], None]] = None

    # -- step path (timestamps only) -------------------------------------------

    def begin(self, step: int) -> None:
        self._cur = {"step": int(step)}
        self._t0 = self._tlast = self._clock()

    def lap(self, phase: str) -> None:
        """Attribute time since the previous boundary to ``phase``."""
        cur = self._cur
        if cur is None:
            return
        now = self._clock()
        cur[phase] = cur.get(phase, 0.0) + (now - self._tlast)
        self._tlast = now

    def commit(self) -> None:
        cur = self._cur
        if cur is None:
            return
        self._cur = None
        cur["seconds"] = self._clock() - self._t0
        with self._lock:
            self._ring.append(cur)
            self._window_steps.append(cur["seconds"])
            # Local time = everything the COMPUTE fence did NOT cover. In
            # a synchronous gang every member's step (and compute wait)
            # converges on the slowest member — the collective equalizes
            # them — so whole-step cadence can never single out a
            # straggler; the local share is the only per-process signal
            # that stays per-process.
            self._window_local.append(
                max(0.0, cur["seconds"] - cur.get(COMPUTE, 0.0)))
            for phase in PHASES:
                if phase in cur:
                    if phase not in self._window:
                        self._window[phase] = collections.deque(
                            maxlen=self.capacity)
                    self._window[phase].append(cur[phase])
        self.steps_recorded += 1
        observer = self.on_commit
        if observer is not None:
            try:
                observer(cur)
            except Exception:  # noqa: BLE001 — observers never kill the loop
                log.exception("steptrace commit observer failed; detaching")
                self.on_commit = None

    def abandon(self) -> None:
        """Drop the in-flight step (loop exiting mid-step): a partial
        record would skew every digest low."""
        self._cur = None

    # -- off-loop aggregation --------------------------------------------------

    def summary(self) -> Optional[Dict[str, Any]]:
        """Drain the since-last-summary window into the heartbeat's
        ``stepTiming`` wire dict, or None when no step completed since the
        previous summary. Each summary describes a disjoint step span, so
        downstream histogram observation never double-counts."""
        with self._lock:
            steps = list(self._window_steps)
            local = list(self._window_local)
            window = {phase: list(v) for phase, v in self._window.items()}
            if not steps:
                return None
            self._window_steps.clear()
            self._window_local.clear()
            self._window = {}
        whole = digest(steps)
        out: Dict[str, Any] = {
            "steps": len(steps),
            "stepP50Seconds": whole["p50Seconds"],
            "stepP95Seconds": whole["p95Seconds"],
            "stepMaxSeconds": whole["maxSeconds"],
            # The straggler detector's signal: p95 of per-step LOCAL time
            # (step minus the compute wait) — see commit().
            "stepLocalP95Seconds": round(_pct(sorted(local), 0.95), 6),
        }
        phases = {
            PHASE_FIELDS[phase]: digest(values)
            for phase, values in window.items()
        }
        if phases:
            out["phases"] = phases
        return out

    def snapshot(self) -> List[Dict[str, Any]]:
        """The ring buffer's records, oldest first, with wire-format phase
        names: the postmortem artifact body."""
        with self._lock:
            ring = list(self._ring)
        out = []
        for rec in ring:
            row: Dict[str, Any] = {"step": rec["step"],
                                   "stepSeconds": round(rec["seconds"], 6)}
            for phase in PHASES:
                if phase in rec:
                    row[PHASE_FIELDS[phase]] = round(rec[phase], 6)
            out.append(row)
        return out

    def dump(self, path: str, meta: Optional[Dict[str, Any]] = None) -> str:
        """Write the ring buffer as a JSON artifact (atomic tmp+rename).
        Raises OSError on an unwritable destination: callers on exit
        paths use :func:`postmortem_dump`, which never raises."""
        body: Dict[str, Any] = {
            "kind": "tpujob-steptrace",
            "capacity": self.capacity,
            "stepsRecorded": self.steps_recorded,
            **(meta or {}),
            "steps": self.snapshot(),
        }
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(body, f)
        os.replace(tmp, path)
        return path


def from_env(env: Optional[Dict[str, str]] = None) -> Optional[StepRecorder]:
    """Recorder from the operator's env contract. Default ON (absent env):
    the recorder costs timestamps only, and a black-box data plane costs
    more. ``TPUJOB_STEPTRACE_ENABLED=0`` opts out; TPUJOB_STEPTRACE_BUFFER
    sizes the window."""
    e = env if env is not None else os.environ
    if str(e.get(ENV_ENABLED, "1")).lower() in ("0", "false"):
        return None
    try:
        capacity = int(e.get(ENV_BUFFER) or DEFAULT_BUFFER_STEPS)
    except ValueError:
        log.warning("ignoring malformed %s=%r", ENV_BUFFER, e.get(ENV_BUFFER))
        capacity = DEFAULT_BUFFER_STEPS
    return StepRecorder(capacity=capacity)


def postmortem_path(checkpoint_dir: str, attempt: int,
                    process_id: int) -> str:
    """The artifact path for one attempt's trace: a sibling of the
    checkpoint dir (same volume, so it survives the pod exactly as long
    as the checkpoints do), named by attempt and process so successive
    attempts and gang members never clobber each other. When the
    checkpoint dir IS a top-level mount point (``checkpointDir: /ckpt``
    with the volume at /ckpt), its parent is the container's root file
    system, outside the volume, so the artifact goes INSIDE the
    checkpoint dir instead (a non-numeric file there is invisible to the
    step walk and the quarantine scan)."""
    name = f"steptrace-attempt{int(attempt)}-p{int(process_id)}.json"
    ckpt = os.path.abspath(checkpoint_dir.rstrip("/") or "/")
    base = os.path.dirname(ckpt)
    if base == os.path.dirname(base):  # parent of a top-level dir: rootfs
        return os.path.join(ckpt, name)
    return os.path.join(base, name)


def postmortem_dump(recorder: StepRecorder, checkpoint_dir: str,
                    env: Optional[Dict[str, str]] = None) -> Optional[str]:
    """Best-effort ring-buffer dump on a retryable exit: writes the
    artifact next to the checkpoint dir and returns its path, or None
    (logged) when there is nowhere to write or the write failed; a
    postmortem aid must never turn a retryable exit into a permanent
    one."""
    e = env if env is not None else os.environ
    if not checkpoint_dir:
        log.debug("steptrace: no checkpoint dir; skipping postmortem dump")
        return None

    def _num(var: str) -> int:
        try:
            return int(e.get(var) or 0)
        except ValueError:
            return 0

    attempt, process_id = _num("TPUJOB_ATTEMPT"), _num("JAX_PROCESS_ID")
    path = postmortem_path(checkpoint_dir, attempt, process_id)
    meta = {
        "job": e.get("TPUJOB_NAME", ""),
        "namespace": e.get("TPUJOB_NAMESPACE", "default"),
        "attempt": attempt,
        "processId": process_id,
    }
    try:
        recorder.dump(path, meta=meta)
    except OSError as err:
        # The sibling slot can be unwritable (a read-only parent, the
        # checkpoint dir deeper than the mount): fall back INSIDE the
        # checkpoint dir, which the payload provably writes.
        fallback = os.path.join(os.path.abspath(checkpoint_dir),
                                os.path.basename(path))
        if fallback == path:
            log.warning("steptrace: postmortem dump to %s failed: %s",
                        path, err)
            return None
        try:
            recorder.dump(fallback, meta=meta)
            path = fallback
        except OSError as err2:
            log.warning("steptrace: postmortem dump failed (%s: %s; "
                        "%s: %s)", path, err, fallback, err2)
            return None
    log.info("steptrace: dumped last %d step timings to %s",
             min(recorder.steps_recorded, recorder.capacity), path)
    return path


# --- spans --------------------------------------------------------------------

# The spans the log keeps: the recorder's window of steps at up to 16
# spans a step (a training step of four microbatches records ten).
SPAN_CAPACITY = 16 * DEFAULT_BUFFER_STEPS


def _read_anchor() -> Dict[str, int]:
    """``time.time_ns()`` beside the midpoint of two
    ``time.perf_counter_ns()`` reads taken round it."""
    before = time.perf_counter_ns()
    epoch = time.time_ns()
    after = time.perf_counter_ns()
    return {"epoch_ns": epoch, "perf_ns": (before + after) // 2}


_spans_on = False  # the one flag a span site reads
_switched_on = False  # trace_spans()
_anchor = _read_anchor()  # guarded-by: _span_lock (read once per log)
_span_lock = threading.Lock()
_spans: collections.deque = collections.deque(
    maxlen=SPAN_CAPACITY)  # guarded-by: _span_lock
# Spans whose end event may not have completed: (record, card, start, end).
_pending: collections.deque = collections.deque()  # guarded-by: _span_lock
_free_events: Dict[Any, List[Any]] = {}  # guarded-by: _span_lock
_nesting = threading.local()


def _profiler_running() -> bool:
    """A ``torch.profiler`` window is running (torch's own flag; False
    while torch is not loaded)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and bool(getattr(prof, "_is_profiler_enabled",
                                             False))


def trace_spans(on: bool) -> None:
    """Switch spans on or off (off by default)."""
    global _switched_on, _spans_on
    _switched_on = bool(on)
    _spans_on = _switched_on or _profiler_running()


def follow_profiler() -> bool:
    """Spans on while :func:`trace_spans` or a ``torch.profiler`` window
    holds them on, else off; the loops call it once a step, so a window
    that anyone opens carries the program's spans. Returns the state."""
    global _spans_on
    _spans_on = _switched_on or _profiler_running()
    return _spans_on


class _NoSpan:
    """The shared context of a span site while spans are off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


def _card(device) -> Any:
    """The CUDA device a span times on the card, or None."""
    if device is None or getattr(device, "type", None) != "cuda":
        return None
    import torch

    return torch.device("cuda", device.index if device.index is not None
                        else torch.cuda.current_device())


class _Span:
    __slots__ = ("record", "card", "events", "range")

    def __init__(self, name: str, device, attrs: Dict[str, Any]):
        self.record: Dict[str, Any] = {"name": name, "attrs": attrs}
        self.card = _card(device)
        self.events = None
        self.range = None

    def __enter__(self) -> Dict[str, Any]:
        depth = getattr(_nesting, "depth", 0)
        self.record["depth"] = depth
        _nesting.depth = depth + 1
        if _profiler_running():
            import torch

            self.range = torch.autograd.profiler.record_function(
                self.record["name"])
            self.range.__enter__()
        if self.card is not None:
            import torch

            with _span_lock:
                free = _free_events.get(self.card)
                self.events = free.pop() if free else None
            if self.events is None:
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.card))
        self.record["t0"] = time.perf_counter_ns()
        return self.record["attrs"]

    def __exit__(self, *exc) -> bool:
        record = self.record
        record["t1"] = time.perf_counter_ns()
        if self.events is not None:
            import torch

            self.events[1].record(torch.cuda.current_stream(self.card))
        if self.range is not None:
            self.range.__exit__(*exc)
        _nesting.depth = record["depth"]
        with _span_lock:
            _spans.append(record)
            if self.events is not None:
                _pending.append((record, self.card) + tuple(self.events))
                if len(_pending) > SPAN_CAPACITY:
                    # Never fenced: the oldest keeps no card time.
                    _, card, start, end = _pending.popleft()
                    _free_events.setdefault(card, []).append((start, end))
        return False


def span(name: str, device=None, **attrs):
    """A context that records one span of ``name`` with ``attrs`` (and,
    with a CUDA ``device``, its card time) while spans are on; entered,
    it gives the span's attrs dict (None while off), which the caller may
    add to before the log is read."""
    if not _spans_on:
        return _NO_SPAN
    return _Span(name, device, attrs)


def mark(attrs: Optional[Dict[str, Any]], key: str) -> None:
    """Stamp ``key`` in an open span's ``attrs`` with the span clock
    (``perf_counter`` ns, placed through the anchor as ``t0`` is);
    nothing while spans are off (``attrs`` None)."""
    if attrs is not None:
        attrs[key] = time.perf_counter_ns()


def resolve_spans(wait: bool = False) -> None:
    """Turn the card times of completed spans into ``device_ms``, oldest
    first, and stop at the first whose end event has not completed
    (``wait``: wait for each instead). A loop calls it after a fence it
    already has; it never synchronizes there."""
    if not _pending:
        return
    with _span_lock:
        while _pending:
            record, card, start, end = _pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                break
            record["device_ms"] = start.elapsed_time(end)
            _pending.popleft()
            _free_events.setdefault(card, []).append((start, end))


def span_log() -> Dict[str, Any]:
    """A snapshot of the log, oldest span first (waits for the card times
    still pending): ``anchor`` maps ``t0`` / ``t1`` (perf_counter ns) onto
    the profiler's clock, epoch ns = ``epoch_ns`` + t - ``perf_ns``."""
    resolve_spans(wait=True)
    with _span_lock:
        spans = [dict(r, attrs=dict(r["attrs"])) for r in _spans]
        anchor = dict(_anchor)
    return {"anchor": anchor, "capacity": SPAN_CAPACITY, "spans": spans}


def clear_spans() -> None:
    """Empty the log and read its anchor anew (spans still open land in
    it when they end)."""
    global _anchor
    with _span_lock:
        _anchor = _read_anchor()
        _spans.clear()
        while _pending:
            _, card, start, end = _pending.popleft()
            _free_events.setdefault(card, []).append((start, end))
