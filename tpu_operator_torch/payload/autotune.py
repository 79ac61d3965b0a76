"""Self-tuning data plane of the PyTorch payload: closed-loop knob control
for the step loop (counterpart of ``tpu_operator/payload/autotune.py``,
with its env contract, constants, wire keys and decisions).

The flight recorder splits each step into DATA / DISPATCH / COMPUTE /
CHECKPOINT / HOST phases. This module closes the loop on them:

- :class:`DataPlaneController` reads the recorder's per-step records and,
  every ``windowSteps`` steps, hill-climbs the live knobs with hysteresis,
  backing a change out when the next window shows the step regressed:

  * **prefetch depth** (``PrefetchControl``): the ``device_prefetch``
    buffer is resizable at refill (data.py); DATA-bound windows deepen it
    toward ``maxDepth``.
  * **host path** (``AsyncHost``): when HOST dominates the residue,
    heartbeat serialization and POSTs and log formatting move off the
    step thread onto a bounded worker.
  * **checkpoint cadence**: when CHECKPOINT stalls dominate, the save
    interval stretches (x2 up to ``CHECKPOINT_CADENCE_CAP`` x the
    configured interval, never below it). A gang's save is a collective,
    so in multi-process jobs the knob goes through the checkpointer's
    gang-agreed mode (``enable_gang_cadence``: the gang's MIN at each
    base-interval boundary).

- :class:`HostPipeline` runs the host iterator's ``next()`` and the
  pinned-memory staging of each batch on a background thread, ahead of
  consumption, so host batch generation leaves the DATA phase.

- The knobs ride the heartbeat (``dataPlane``) into ``status.dataPlane``.

Env contract (the operator injects it for ``spec.dataPlane``):
``TPUJOB_DATAPLANE_PREFETCH_DEPTH`` (0 = auto, see
:func:`resolve_prefetch_depth`), ``TPUJOB_DATAPLANE_AUTOTUNE``,
``TPUJOB_DATAPLANE_MIN_DEPTH``, ``TPUJOB_DATAPLANE_MAX_DEPTH``,
``TPUJOB_DATAPLANE_WINDOW_STEPS``. Without it the runtime is inert: the
caller's static depth, no controller, no threads.

The knobs move timing only: the batches, their order and every step's
numbers are the same whatever they do. Stdlib only, with plain
``threading`` locks.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
from typing import Any, Callable, Dict, Optional

from tpu_operator_torch.payload import heartbeat as heartbeat_mod
from tpu_operator_torch.payload import steptrace as steptrace_mod

log = logging.getLogger(__name__)

# Operator env contract (trainer/replicas.py injects when spec.dataPlane
# is present; absent env = inert runtime, the pre-autotune behavior).
ENV_PREFETCH_DEPTH = "TPUJOB_DATAPLANE_PREFETCH_DEPTH"
ENV_AUTOTUNE = "TPUJOB_DATAPLANE_AUTOTUNE"
ENV_MIN_DEPTH = "TPUJOB_DATAPLANE_MIN_DEPTH"
ENV_MAX_DEPTH = "TPUJOB_DATAPLANE_MAX_DEPTH"
ENV_WINDOW_STEPS = "TPUJOB_DATAPLANE_WINDOW_STEPS"

# Default static prefetch depth — what ``prefetchDepth: 0`` (auto)
# resolves to before the controller starts moving it; identical to the
# depth train_loop always shipped, so auto-without-autotune is exactly
# the old behavior.
DEFAULT_PREFETCH_DEPTH = 2

# Autotune bounds/window defaults (spec.dataPlane.autotune mirrors these
# in types.py; the spec module is the contract home, this is the runtime
# fallback for env-driven construction).
DEFAULT_MIN_DEPTH = 1
DEFAULT_MAX_DEPTH = 8
DEFAULT_WINDOW_STEPS = 32

# Checkpoint cadence stretches by powers of two up to this multiple of
# the payload's configured save interval — the "spec bound": autotune may
# coarsen durability, never below the configured cadence and never past
# this cap.
CHECKPOINT_CADENCE_CAP = 4

# A window only triggers tuning when the non-COMPUTE residue is material:
# at least this fraction of the mean step (and the dominant phase at
# least half of it) — µs-level noise between phases must not move knobs.
RESIDUE_FLOOR_FRACTION = 0.02

# Regression hysteresis — the verdict compares the knob's ATTRIBUTABLE
# signal, the per-process local share (step seconds minus the COMPUTE
# wait): in a synchronous gang the collectives equalize whole-step time
# to the slowest member (payload/steptrace.py's straggler rationale), so
# a whole-step verdict would revert good local changes on peer noise and
# freeze knobs gang-wide. A change is reverted when the verdict window's
# local mean exceeds the pre-change baseline by more than this fraction
# OF THE WHOLE STEP (the absolute threshold scales with the step, so a
# µs-level local share can't flap on µs-level noise).
HYSTERESIS_FRACTION = 0.03

# Coarse whole-step guard on top of the local verdict: a knob move that
# regresses the WHOLE step this much past its baseline reverts even when
# the local share looks fine (e.g. a deeper prefetch window pressuring
# device memory shows up compute-side, not in the local share). 3x the
# local hysteresis so ordinary gang-wide noise doesn't trip it.
STEP_GUARD_FRACTION = 3 * HYSTERESIS_FRACTION

# Evaluation-window floor, ONE definition with the spec layer
# (validation.py and the schema minimum import it): a smaller window's
# phase means are noise, and the hill climb would chase it.
MIN_WINDOW_STEPS = 8

# After a reverted adjustment the knob freezes for this many windows, so
# a borderline signal cannot oscillate a knob every other window.
HOLD_WINDOWS = 8

# Wire keys of the per-knob adjustment counters the heartbeat carries
# (``dataPlane.adjustments``); the statusserver sanitizes against this
# tuple and the controller fold maps each to its {knob,direction} metric
# labels via KNOB_OF.
ADJUSTMENT_KEYS = ("prefetchUp", "prefetchDown", "hostUp", "hostDown",
                   "checkpointUp", "checkpointDown")
KNOB_OF = {
    "prefetchUp": ("prefetch", "up"),
    "prefetchDown": ("prefetch", "down"),
    "hostUp": ("host", "up"),
    "hostDown": ("host", "down"),
    "checkpointUp": ("checkpoint", "up"),
    "checkpointDown": ("checkpoint", "down"),
}


def add_prefetch_argument(parser: Any,
                          env: Optional[Dict[str, str]] = None) -> None:
    """The shared ``--prefetch-depth`` arg of the operator-launched
    payloads (cifar, transformer): defaults from the injected
    env, so ``spec.dataPlane.prefetchDepth`` reaches the loop without
    per-payload plumbing and a static depth is settable without
    autotune; 0 keeps the auto convention. One definition so the
    payloads cannot drift."""
    e = env if env is not None else os.environ
    default = _env_int(e, ENV_PREFETCH_DEPTH, 0)
    parser.add_argument(
        "--prefetch-depth", type=int, default=default,
        help="device-prefetch depth: batches kept in flight ahead of "
             "the step (0 = auto — the shipped default, tuned live when "
             "spec.dataPlane.autotune is enabled; defaults from the "
             "operator-injected $TPUJOB_DATAPLANE_PREFETCH_DEPTH)")


def resolve_prefetch_depth(depth: int,
                           default: int = DEFAULT_PREFETCH_DEPTH) -> int:
    """Resolve the spec/arg-level prefetch-depth convention to a concrete
    starting depth: ``> 0`` is an explicit static depth, ``0`` means AUTO
    (the runtime picks — ``default`` statically, the controller live when
    autotune is enabled). Negative is a config error and fails loudly —
    ``device_prefetch`` historically degenerated any ``depth <= 0`` to
    the unbuffered path silently, which made a spec-level 0 mean the
    opposite of its documented convention."""
    depth = int(depth)
    if depth < 0:
        raise ValueError(
            f"prefetch depth must be >= 0 (0 = auto), got {depth}")
    return depth if depth > 0 else int(default)


class PrefetchControl:
    """Live prefetch-depth knob shared between the controller (writer, on
    the step thread) and the prefetch path (reader — the step thread in
    synchronous mode, the :class:`HostPipeline` worker in pipelined
    mode). One int behind a leaf lock; reads off the step path."""

    def __init__(self, depth: int):
        self._lock = threading.Lock()
        self._depth = max(0, int(depth))  # guarded-by: _lock

    @property
    def depth(self) -> int:
        with self._lock:
            return self._depth

    def set_depth(self, depth: int) -> None:
        with self._lock:
            self._depth = max(0, int(depth))


class AsyncHost:
    """Bounded background worker for host-side telemetry: heartbeat
    serialization + POSTs and log formatting run here instead of on the
    step thread, so the step path pays an enqueue (one lock + append)
    rather than a socket round-trip. Telemetry is lossy by contract —
    when the queue is full (a wedged status server back-pressuring
    through the POST timeout) new work is DROPPED and counted, never
    queued unboundedly and never blocking a step."""

    def __init__(self, capacity: int = 64, name: str = "dataplane-host"):
        self.capacity = max(1, int(capacity))
        self._cond = threading.Condition()
        self._queue: collections.deque = collections.deque()  # guarded-by: _cond
        self._closed = False   # guarded-by: _cond
        self._started = False  # guarded-by: _cond
        self.dropped = 0       # guarded-by: _cond
        self._warned_drop = False  # guarded-by: _cond
        self._name = name
        self._thread: Optional[threading.Thread] = None
        self._failed_once = False  # worker-thread only

    def submit(self, fn: Callable, *args: Any) -> bool:
        """Enqueue ``fn(*args)`` for the worker; False when dropped
        (queue full or closed). FIFO: posts retain their build order."""
        with self._cond:
            if self._closed:
                return False
            if len(self._queue) >= self.capacity:
                self.dropped += 1
                warn = not self._warned_drop
                self._warned_drop = True
                if warn:
                    # First of a streak, outside the hot path's happy
                    # case: lossy-by-contract must still be OBSERVABLE —
                    # the wire carries the running count (hostDropped).
                    log.warning(
                        "async host queue full (%d): dropping telemetry "
                        "work; drops ride the heartbeat as hostDropped",
                        self.capacity)
                return False
            self._queue.append((fn, args))
            self._warned_drop = False
            if not self._started:
                self._started = True
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name=self._name)
                self._thread.start()
            self._cond.notify_all()
        return True

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue:
                    return  # closed and drained
                fn, args = self._queue.popleft()
                self._cond.notify_all()
            try:
                fn(*args)
            except Exception as e:  # noqa: BLE001 — telemetry never kills training
                if not self._failed_once:
                    log.warning("async host work failed: %s", e)
                    self._failed_once = True

    @property
    def dropped_count(self) -> int:
        with self._cond:
            return self.dropped

    def close(self, timeout: float = 5.0) -> None:
        """Stop accepting work and drain what is queued (bounded): the
        final heartbeats of a finishing run usually land, a wedged poster
        cannot park the exit."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(timeout=timeout)


class HostPipeline:
    """Runs ``fill()`` — the host iterator's ``next()`` plus the
    pinned-memory staging and device copy — on a background worker,
    bounded by the live prefetch depth, so host batch generation runs
    AHEAD of consumption instead of serialized into the step's DATA
    phase. Single worker: the stream order is exactly the iterator's.

    ``fill`` raises StopIteration at end of stream; any other exception
    is re-raised to the consumer at the position it occurred (the
    pipeline never silently truncates a failing stream)."""

    def __init__(self, fill: Callable[[], Any],
                 control: Optional[PrefetchControl] = None,
                 depth: int = DEFAULT_PREFETCH_DEPTH,
                 name: str = "dataplane-pipeline"):
        self._fill = fill
        self._control = control
        self._depth = max(1, int(depth))
        self._cond = threading.Condition()
        self._buf: collections.deque = collections.deque()  # guarded-by: _cond
        self._done = False   # guarded-by: _cond
        self._stopped = False  # guarded-by: _cond
        self._error: Optional[BaseException] = None  # guarded-by: _cond
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._thread.start()

    def _target(self) -> int:
        # The live knob when wired, the fixed depth otherwise; depth
        # changes take effect at the worker's next refill decision.
        if self._control is not None:
            return max(1, self._control.depth)
        return self._depth

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._stopped and len(self._buf) >= self._target():
                    self._cond.wait()
                if self._stopped:
                    return
            # The fill — host RNG / file I/O / device placement — runs
            # OUTSIDE the lock: the consumer pops concurrently.
            try:
                item = self._fill()
            except StopIteration:
                with self._cond:
                    self._done = True
                    self._cond.notify_all()
                return
            except BaseException as e:  # noqa: BLE001 — re-raised to the consumer
                with self._cond:
                    self._error = e
                    self._done = True
                    self._cond.notify_all()
                return
            with self._cond:
                if self._stopped:
                    return
                self._buf.append(item)
                self._cond.notify_all()

    def get(self) -> Any:
        """Next batch in stream order; raises StopIteration at the end
        (or once the pipeline is closed — a post-close get must not park
        on a condition no worker will ever signal) and re-raises the
        worker's error at its stream position."""
        with self._cond:
            while not self._buf and not self._done and not self._stopped:
                self._cond.wait()
            if self._buf:
                item = self._buf.popleft()
                self._cond.notify_all()
                return item
            if self._error is not None:
                raise self._error
            raise StopIteration

    def close(self, timeout: float = 5.0) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout)


class DataPlaneController:
    """Hill-climbs the live data-plane knobs from the flight recorder's
    per-step records (``StepRecorder`` ``on_commit`` observer).

    Every ``window_steps`` completed steps the controller evaluates ONE
    action, in strict priority order:

    1. **Settle/verdict** — if the previous window changed a knob, this
       window is the verdict: mean step time above the pre-change
       baseline (carried in the in-flight record) by more than
       ``HYSTERESIS_FRACTION`` reverts the change and freezes that knob
       for ``HOLD_WINDOWS`` windows; otherwise the change sticks. One
       change in flight at a time, so cause and effect stay
       attributable.
    2. **Climb** — with nothing in flight, walk the residue phases
       (DATA / HOST / CHECKPOINT) by descending share, above the
       materiality floor, and take the first knob with headroom: deepen
       prefetch, async the host path, stretch the checkpoint cadence.
       Clamped to [min_depth, max_depth] and ``CHECKPOINT_CADENCE_CAP``
       — a clamped or held knob falls through to the next phase rather
       than dead-ending the climb.

    Runs entirely on the step-loop thread (the observer fires at commit);
    the lock guards the counters/wire snapshot other threads read
    (heartbeat build may run on the AsyncHost worker)."""

    def __init__(self, control: PrefetchControl,
                 min_depth: int = DEFAULT_MIN_DEPTH,
                 max_depth: int = DEFAULT_MAX_DEPTH,
                 window_steps: int = DEFAULT_WINDOW_STEPS,
                 enable_host_async: Optional[Callable[[bool], None]] = None,
                 checkpointer: Optional[Any] = None):
        self.control = control
        self.min_depth = max(0, int(min_depth))
        self.max_depth = max(self.min_depth, int(max_depth))
        self.window_steps = max(MIN_WINDOW_STEPS, int(window_steps))
        self._enable_host_async = enable_host_async
        self._checkpointer = checkpointer
        self.host_async = False
        control.set_depth(min(self.max_depth,
                              max(self.min_depth, control.depth)))
        # Window accumulators: step-loop thread only.
        self._n = 0
        self._sums: Dict[str, float] = {}
        self._step_sum = 0.0
        self._local_sum = 0.0
        # One in-flight change: (knob, revert_fn, down_key,
        # pre-change local mean, pre-change step mean — the verdict's
        # baselines).
        self._pending: Optional[tuple] = None
        self._holds: Dict[str, int] = {}
        self.windows_evaluated = 0
        self._lock = threading.Lock()
        self._adjustments: Dict[str, int] = {  # guarded-by: _lock
            key: 0 for key in ADJUSTMENT_KEYS}

    # -- step-loop side --------------------------------------------------------

    def on_step(self, record: Dict[str, Any]) -> None:
        """StepRecorder commit observer: accumulate one step's phase laps
        (float adds only); evaluate at window boundaries."""
        self._n += 1
        seconds = record.get("seconds", 0.0)
        self._step_sum += seconds
        # The per-process LOCAL share (seconds minus the compute wait):
        # the verdict's signal — collectives equalize everything else.
        self._local_sum += max(
            0.0, seconds - record.get(steptrace_mod.COMPUTE, 0.0))
        for phase in (steptrace_mod.DATA, steptrace_mod.HOST,
                      steptrace_mod.CHECKPOINT, steptrace_mod.COMPUTE):
            if phase in record:
                self._sums[phase] = self._sums.get(phase, 0.0) \
                    + record[phase]
        if self._n >= self.window_steps:
            try:
                self._evaluate()
            except Exception:  # noqa: BLE001 — tuning must never kill training
                log.exception("autotune window evaluation failed; "
                              "knobs left as-is")
            self._n = 0
            self._sums = {}
            self._step_sum = 0.0
            self._local_sum = 0.0

    def _mean(self, phase: str) -> float:
        return self._sums.get(phase, 0.0) / max(1, self._n)

    def _count(self, key: str) -> None:
        with self._lock:
            self._adjustments[key] += 1

    def _evaluate(self) -> None:
        self.windows_evaluated += 1
        step_mean = self._step_sum / max(1, self._n)
        local_mean = self._local_sum / max(1, self._n)
        for knob in list(self._holds):
            self._holds[knob] -= 1
            if self._holds[knob] <= 0:
                del self._holds[knob]
        if self._pending is not None:
            knob, revert, down_key, base_local, base_step = self._pending
            self._pending = None
            # The sensitive verdict is the LOCAL share — the only signal
            # a gang's collectives don't equalize to the slowest member,
            # so peer noise can't revert a good local change (threshold
            # scaled by the whole step, see HYSTERESIS_FRACTION). The
            # coarse whole-step guard still catches a move whose cost
            # lands compute-side (e.g. device memory pressure).
            regressed = (
                local_mean > base_local + HYSTERESIS_FRACTION
                * max(step_mean, base_step)
                or (base_step > 0 and step_mean > base_step
                    * (1.0 + STEP_GUARD_FRACTION)))
            if regressed:
                # Back the change out and hold the knob.
                revert()
                self._count(down_key)
                self._holds[knob] = HOLD_WINDOWS
                log.info("autotune: reverted %s (local %.6fs vs %.6fs, "
                         "step %.6fs vs %.6fs)", knob, local_mean,
                         base_local, step_mean, base_step)
            # Accepted or reverted, the verdict WAS this window's one
            # action: climbing again immediately would put a second
            # change in flight against a baseline the verdict just moved.
            return
        data_m = self._mean(steptrace_mod.DATA)
        host_m = self._mean(steptrace_mod.HOST)
        ckpt_m = self._mean(steptrace_mod.CHECKPOINT)
        floor = RESIDUE_FLOOR_FRACTION * step_mean
        if data_m + host_m + ckpt_m < floor:
            return
        # Walk knobs by descending residue share instead of only the
        # single dominant one: a capped or held knob must not dead-end
        # the climb while another material phase still has headroom.
        for phase_mean, knob in sorted(
                ((data_m, "prefetch"), (host_m, "host"),
                 (ckpt_m, "checkpoint")), reverse=True):
            if phase_mean < floor / 2:
                return  # sorted: everything after is smaller still
            if knob in self._holds:
                continue
            if self._climb(knob, local_mean, step_mean):
                return

    def _climb(self, knob: str, local_mean: float,
               step_mean: float) -> bool:
        """Propose ``knob``'s next move as the window's in-flight change;
        False when the knob has no headroom (clamped at its bound, or
        its collaborator is absent) so ``_evaluate`` can try the
        next-most-material phase instead."""
        if knob == "prefetch":
            depth = self.control.depth
            if depth >= self.max_depth:
                return False
            self.control.set_depth(depth + 1)
            self._count("prefetchUp")
            self._pending = ("prefetch",
                             lambda: self.control.set_depth(depth),
                             "prefetchDown", local_mean, step_mean)
            return True
        if knob == "host":
            if self.host_async or self._enable_host_async is None:
                return False
            self._set_host_async(True)
            self._count("hostUp")
            self._pending = ("host", lambda: self._set_host_async(False),
                             "hostDown", local_mean, step_mean)
            return True
        ck = self._checkpointer
        if ck is None:
            return False
        mult = int(getattr(ck, "cadence_multiplier", 1))
        if mult >= CHECKPOINT_CADENCE_CAP:
            return False
        ck.cadence_multiplier = mult * 2

        def revert(ck=ck, mult=mult):
            ck.cadence_multiplier = mult

        self._count("checkpointUp")
        self._pending = ("checkpoint", revert, "checkpointDown",
                         local_mean, step_mean)
        return True

    def _set_host_async(self, enabled: bool) -> None:
        self.host_async = enabled
        if self._enable_host_async is not None:
            self._enable_host_async(enabled)

    # -- wire side -------------------------------------------------------------

    def adjustments(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._adjustments)


class DataPlaneRuntime:
    """One attempt's data-plane wiring, owned by ``train_loop``: the
    resolved prefetch depth, the live control + controller when autotune
    is on, the background host pipeline, and the async host worker. An
    INERT runtime (no spec.dataPlane env) carries only the static depth
    and costs the loop nothing — no threads, no wire key, no observer."""

    def __init__(self, depth: int, control: Optional[PrefetchControl] = None,
                 controller: Optional[DataPlaneController] = None,
                 pipeline: bool = False, active: bool = False):
        self.depth = depth
        self.control = control
        self.controller = controller
        self.pipeline = pipeline
        self.active = active
        self.host: Optional[AsyncHost] = None
        self._heartbeat: Optional[Any] = None
        self._hb_interval = heartbeat_mod.DEFAULT_INTERVAL

    @classmethod
    def static(cls, depth: int) -> "DataPlaneRuntime":
        """The inert runtime: the caller's depth verbatim (train_loop's
        historical contract — 0 = unbuffered; the 0=auto convention is a
        spec/arg-level concept resolved before depths reach here)."""
        return cls(int(depth))

    @property
    def host_async(self) -> bool:
        return self.controller is not None and self.controller.host_async

    def attach(self, recorder: Optional[Any] = None,
               heartbeat: Optional[Any] = None,
               checkpointer: Optional[Any] = None,
               processes: int = 1) -> None:
        """Bind the loop's collaborators: the recorder feeds the
        controller's windows, the heartbeat gains the async sink hook,
        the checkpointer exposes its cadence knob. The heartbeat's
        posting cadence comes from ``heartbeat.interval_of`` — the ONE
        cadence source the startup ticker uses too, so the autotuner's
        host-budget view and the ticker can never disagree.

        ``processes`` is the gang's process count: a gang's save is a
        COLLECTIVE and each process's controller tunes from its own
        phase sums, so a unilaterally stretched maybe_save gate would
        wedge the gang at the save barrier. Multi-process jobs therefore
        get the knob only through the checkpointer's GANG-AGREED mode
        (``enable_gang_cadence`` — each base-interval boundary
        allgather-mins the proposals, so a disagreeing gang saves at the
        most conservative member's cadence and the barrier stays
        matched); a checkpointer without that surface is withheld, the
        pre-agreement behavior. The prefetch/host knobs are
        per-process-local and always stay wired."""
        self._heartbeat = heartbeat
        self._hb_interval = heartbeat_mod.interval_of(heartbeat)
        if self.controller is None:
            return
        self.controller._enable_host_async = self._apply_host_async
        ck = checkpointer
        if ck is not None and int(processes) > 1:
            enable = getattr(ck, "enable_gang_cadence", None)
            if enable is not None:
                enable()
            else:
                ck = None  # no agreement surface: withhold the knob
        self.controller._checkpointer = ck
        if recorder is not None:
            recorder.on_commit = self.controller.on_step
        else:
            log.warning("autotune enabled but the step recorder is off "
                        "(TPUJOB_STEPTRACE_ENABLED=0): no phase digests "
                        "to tune from; knobs stay static")

    def _apply_host_async(self, enabled: bool) -> None:
        if enabled and self.host is None:
            # Capacity sized from the heartbeat cadence: the worker holds
            # at most a couple of intervals' worth of posts + log lines
            # before dropping (lossy telemetry, bounded memory).
            self.host = AsyncHost(capacity=max(
                16, int(4 * self._hb_interval)))
        hb = self._heartbeat
        if hb is not None:
            hb.async_sink = self.host.submit if enabled else None

    def submit_host(self, fn: Callable, *args: Any) -> bool:
        """Run host-side telemetry work (log formatting) off the step
        thread when the async host path is on; inline otherwise."""
        if self.host_async and self.host is not None:
            return self.host.submit(fn, *args)
        fn(*args)
        return True

    def wire(self) -> Optional[Dict[str, Any]]:
        """The heartbeat's ``dataPlane`` body: current knob values +
        adjustment counters. None for an inert runtime — jobs without
        spec.dataPlane post exactly the bodies they always did."""
        if not self.active:
            return None
        out: Dict[str, Any] = {
            "prefetchDepth": (self.control.depth
                              if self.control is not None else self.depth),
            "hostAsync": bool(self.host_async),
        }
        if self.host is not None:
            # Telemetry is lossy by contract; the shed amount is not
            # allowed to be invisible (a wedged status server otherwise
            # looks identical to a payload that just stopped reporting).
            out["hostDropped"] = self.host.dropped_count
        ctl = self.controller
        if ctl is not None:
            ck = ctl._checkpointer
            if ck is not None:
                mult = max(1, int(getattr(ck, "cadence_multiplier", 1)))
                every = int(getattr(ck, "save_every", 0))
                if every > 0:
                    out["checkpointIntervalSteps"] = every * mult
            out["adjustments"] = ctl.adjustments()
        return out

    def close(self) -> None:
        if self.host is not None:
            hb = self._heartbeat
            if hb is not None:
                hb.async_sink = None
            self.host.close()


def _env_int(e: Dict[str, str], var: str, default: int) -> int:
    try:
        return int(e.get(var) or default)
    except ValueError:
        log.warning("ignoring malformed %s=%r", var, e.get(var))
        return default


def from_env(prefetch: int = DEFAULT_PREFETCH_DEPTH,
             env: Optional[Dict[str, str]] = None) -> DataPlaneRuntime:
    """Build the attempt's data-plane runtime from the operator's env
    contract. ``prefetch`` is the caller's depth — for operator-launched
    payloads the ``--prefetch-depth`` arg, already defaulted from the
    injected env and resolved through the 0=auto convention by the arg
    parsers; for direct train_loop callers a verbatim concrete depth.
    Without any TPUJOB_DATAPLANE_* env the runtime is INERT: the caller's
    depth untouched (0 stays the explicit unbuffered mode), no threads,
    no controller — the pre-dataplane behavior exactly."""
    e = env if env is not None else os.environ
    active = ENV_PREFETCH_DEPTH in e or ENV_AUTOTUNE in e
    depth_request = int(prefetch)
    if not active:
        return DataPlaneRuntime(depth_request)
    if depth_request == 0:
        depth_request = _env_int(e, ENV_PREFETCH_DEPTH, 0)
    depth = resolve_prefetch_depth(depth_request)
    autotune_on = str(e.get(ENV_AUTOTUNE, "0")).lower() in ("1", "true")
    if not autotune_on:
        # spec.dataPlane present, autotune off: static depth, but the
        # background host pipeline still runs (the direct residue
        # elimination) and knob state rides the heartbeat.
        return DataPlaneRuntime(depth, pipeline=True, active=True)
    min_depth = _env_int(e, ENV_MIN_DEPTH, DEFAULT_MIN_DEPTH)
    max_depth = _env_int(e, ENV_MAX_DEPTH, DEFAULT_MAX_DEPTH)
    window = _env_int(e, ENV_WINDOW_STEPS, DEFAULT_WINDOW_STEPS)
    control = PrefetchControl(depth)
    controller = DataPlaneController(control, min_depth=min_depth,
                                     max_depth=max_depth,
                                     window_steps=window)
    return DataPlaneRuntime(control.depth, control=control,
                            controller=controller, pipeline=True,
                            active=True)
