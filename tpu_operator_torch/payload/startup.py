"""Startup instrumentation of the PyTorch payload: the per-attempt stage
tracker (counterpart of ``tpu_operator/payload/startup.py``).

Every attempt pays the DNS wait, the process group's rendezvous, the
checkpoint restore and the kernel library's build or load before its
first useful step: the time to first step. :class:`StartupTracker` times
each stage (RENDEZVOUS / PREFETCH / RESTORE / COMPILE / FIRST_STEP);
stages may overlap (restore and COMPILE run concurrently in the
overlapped prologue of ``train.train_loop``), so each is timed on its own
and ``current_stage`` reports the innermost in-flight one for the
pre-first-step liveness beats. ``breakdown()`` is the wire format the
heartbeat carries into ``status.startup``: ``{rendezvousSeconds,
prefetchSeconds, restoreSeconds, compileSeconds, firstStepSeconds,
cacheHit, prefetchHit}``, the reference's names letter for letter.

COMPILE is the kernel library (``kernels/build.py``): built by ``nvcc``
on a cold attempt, loaded from the compilation cache on a warm one. A
load that ran no ``nvcc`` is a cache hit, counted by
:func:`record_kernel_load` / :func:`cache_hit_count` (the reference counts
JAX's persistent-cache events there).

Stdlib only, with a plain ``threading.Lock``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional

# Startup stages, in nominal order. COMPILE and RESTORE overlap in the
# overlapped prologue; PREFETCH (the remote warm-start store download)
# overlaps RENDEZVOUS, and its recorded duration is only the tail that
# outlived the rendezvous wait; FIRST_STEP is the first step after the
# prologue, run to completion.
RENDEZVOUS = "RENDEZVOUS"
PREFETCH = "PREFETCH"
RESTORE = "RESTORE"
COMPILE = "COMPILE"
FIRST_STEP = "FIRST_STEP"

STAGES = (RENDEZVOUS, PREFETCH, RESTORE, COMPILE, FIRST_STEP)

# Heartbeat/status field name per stage (the ``status.startup`` keys).
STAGE_FIELDS = {
    RENDEZVOUS: "rendezvousSeconds",
    PREFETCH: "prefetchSeconds",
    RESTORE: "restoreSeconds",
    COMPILE: "compileSeconds",
    FIRST_STEP: "firstStepSeconds",
}

# Rendezvous and the store prefetch happen in bootstrap.initialize, before
# any tracker exists: recorded here and seeded into every new tracker of
# this process. The writers are the main thread (bootstrap), the COMPILE
# worker (kernel loads) and the heartbeat thread reads the breakdown, so
# one lock guards all of this module's state.
_state_lock = threading.Lock()
_rendezvous_seconds: Optional[float] = None  # guarded-by: _state_lock
_prefetch_seconds: Optional[float] = None  # guarded-by: _state_lock
_prefetch_hit: Optional[bool] = None  # guarded-by: _state_lock
# The compilation cache dir bootstrap enabled ("" = cold).
_cache_dir: str = ""  # guarded-by: _state_lock
# Kernel-library loads that ran no nvcc.
_cache_hits = 0  # guarded-by: _state_lock


def record_rendezvous(seconds: float) -> None:
    global _rendezvous_seconds
    with _state_lock:
        _rendezvous_seconds = float(seconds)


def record_prefetch(seconds: float, hit: Optional[bool]) -> None:
    """Record the warm-start store prefetch: ``seconds`` is the tail the
    download kept on the critical path AFTER the rendezvous it overlapped
    (0.0 = fully hidden), ``hit`` whether it delivered anything (a
    checkpoint step or cache entries); None = store not configured."""
    global _prefetch_seconds, _prefetch_hit
    with _state_lock:
        _prefetch_seconds = float(seconds)
        _prefetch_hit = None if hit is None else bool(hit)


def reset_prefetch() -> None:
    """Test hook: clear the module-level prefetch record."""
    global _prefetch_seconds, _prefetch_hit
    with _state_lock:
        _prefetch_seconds = None
        _prefetch_hit = None


def reset() -> None:
    """Test hook: clear this process's per-process records (the
    rendezvous, the prefetch and the compilation cache dir), so a new
    tracker starts with nothing seeded."""
    global _rendezvous_seconds, _cache_dir
    reset_prefetch()
    with _state_lock:
        _rendezvous_seconds = None
        _cache_dir = ""


def set_cache_dir(path: str) -> None:
    global _cache_dir
    with _state_lock:
        _cache_dir = str(path or "")


def cache_dir() -> str:
    with _state_lock:
        return _cache_dir


def record_kernel_load(ran_nvcc: bool) -> None:
    """The kernel library was loaded; without an ``nvcc`` run that is a
    compilation-cache hit (``kernels/build.py`` calls this)."""
    global _cache_hits
    if not ran_nvcc:
        with _state_lock:
            _cache_hits += 1


def cache_hit_count() -> int:
    """Kernel-library loads this process made without running nvcc."""
    with _state_lock:
        return _cache_hits


class StartupTracker:
    """Times the startup stages of one attempt. Thread-safe: the
    overlapped prologue runs RESTORE (main thread) and COMPILE (worker
    thread) concurrently."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        self._active: List[str] = []  # innermost last
        self.durations: Dict[str, float] = {}
        self.cache_hit: Optional[bool] = None
        # Absolute clock() stamp of first-step completion.
        self.first_step_done_at: Optional[float] = None
        with _state_lock:
            self.prefetch_hit: Optional[bool] = _prefetch_hit
            if _rendezvous_seconds is not None:
                self.durations[RENDEZVOUS] = _rendezvous_seconds
            if _prefetch_seconds is not None:
                self.durations[PREFETCH] = _prefetch_seconds

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = self._clock()
        with self._lock:
            self._active.append(name)
        try:
            yield
        finally:
            dt = self._clock() - t0
            with self._lock:
                if name in self._active:
                    self._active.remove(name)
                # Keep the max across re-entries (the attempt paid the
                # longest one).
                self.durations[name] = max(self.durations.get(name, 0.0), dt)
                if name == FIRST_STEP:
                    self.first_step_done_at = self._clock()

    def current_stage(self) -> Optional[str]:
        """The innermost in-flight stage: what a pre-first-step liveness
        heartbeat reports as ``startupStage``."""
        with self._lock:
            return self._active[-1] if self._active else None

    def breakdown(self) -> Dict[str, Any]:
        """The wire-format startup breakdown (only stages actually timed)."""
        with self._lock:
            out: Dict[str, Any] = {
                STAGE_FIELDS[name]: round(self.durations[name], 6)
                for name in STAGES if name in self.durations
            }
            if self.cache_hit is not None:
                out["cacheHit"] = bool(self.cache_hit)
            if self.prefetch_hit is not None:
                out["prefetchHit"] = bool(self.prefetch_hit)
        return out


def new_tracker(clock: Callable[[], float] = time.perf_counter
                ) -> StartupTracker:
    """Fresh per-attempt tracker, pre-seeded with this process's
    rendezvous and prefetch records."""
    return StartupTracker(clock=clock)
