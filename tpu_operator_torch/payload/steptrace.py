"""Flight recorder: per-step phase timing for the serve loop.

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

Phases (one step, in loop order; the serve loop times DATA, COMPUTE and
HOST, and the other two keep their wire names for the training slice):

- ``DATA`` — input wait before the step.
- ``DISPATCH`` — the launch of the step's device work, where a loop
  times it apart from the wait.
- ``COMPUTE`` — the decode step itself: kernel launches and the wait for
  the step's next tokens on the host.
- ``CHECKPOINT`` — a checkpoint save at the step boundary.
- ``HOST`` — everything else host-side: token delivery, completions,
  the heartbeat post.

This is the PyTorch payload's own copy of the part of
``tpu_operator/payload/steptrace.py`` that the serve loop uses (stdlib
only; a plain ``threading.Lock`` where the original takes a
lock-order-witnessed one). The wire format is the same, so the operator
reads both payloads' digests alike. The ring buffer and its postmortem
dump, keyed on a checkpoint dir, come with the slice that ports
checkpoints.
"""

from __future__ import annotations

import collections
import logging
import math
import os
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
