"""On-demand deep profiling of the PyTorch payload: a one-shot capture of
raw per-step laps (counterpart of ``tpu_operator/payload/profile.py``).

The flight recorder (``steptrace.py``) ships windowed digests on the
heartbeat; a digest has no per-step resolution and no device trace. This
module is the payload half of the profile directive's round trip:

- the operator stamps ``status.profile`` from a ``tpujobctl profile``
  request and piggybacks the directive (``{"id", "steps"}``) on a
  heartbeat ACK to process 0;
- :class:`ProfileCapture` records the NEXT N committed steps' wall laps,
  merges the flight recorder's per-phase rows for the same steps, and
  brackets the window with a ``torch.profiler`` trace (CPU activities,
  plus CUDA on the card) unless the loop's own ``--profile-dir`` window
  owns the profiler;
- the JSON artifact (``ARTIFACT_KIND``; the same keys as the reference's,
  ``jaxTraceDir`` naming the trace's directory) ships through the
  write-behind uploader's ``artifacts/`` path, and the result rides the
  next heartbeat, where the operator folds ``status.profile`` to
  ``Captured``.

While a trace runs, the program's spans (``steptrace.span``) are on,
and each enters the trace as a range of its name (``train.forward``,
``kvcache.decode`` ...); they go off again when it stops.

``torch`` is imported only when a trace starts.
"""

from __future__ import annotations

import json
import logging
import os
import re
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

# Directive defaults and bounds. The operator clamps ``steps`` too, but
# the directive crossed two trust boundaries to get here.
DEFAULT_STEPS = 8
MAX_STEPS = 512

ARTIFACT_KIND = "tpujob-profile"

# The trace file inside a capture's trace directory.
TRACE_FILE = "trace.json"


def _safe_id(raw: str) -> str:
    """Directive ids become file names; strip anything path-hostile."""
    cleaned = re.sub(r"[^A-Za-z0-9._-]", "_", raw or "")
    return cleaned or "anon"


def start_profiler(cuda: bool):
    """A started ``torch.profiler.profile`` over the CPU, and the card
    when ``cuda``."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_profiler(prof, path: str, cuda: bool) -> None:
    """Stop ``prof`` (after the card's queued work, so the trace holds
    it) and write its Chrome trace to ``path``."""
    if cuda:
        import torch

        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)


class ProfileCapture:
    """One in-flight capture window. Step-loop thread only: armed when
    the heartbeat ACK delivers a directive, ticked once per committed
    step, finished when the requested window is full.

    The wall lap is measured between consecutive :meth:`tick` calls at a
    fixed point of the loop body (after ``recorder.commit()``), so a lap
    spans exactly one step with every host phase, with no added fence."""

    def __init__(self, directive: Dict[str, Any], base_dir: str = "",
                 allow_trace: bool = True, cuda: bool = False):
        self.id = str(directive.get("id") or "")
        try:
            steps = int(directive.get("steps") or DEFAULT_STEPS)
        except (TypeError, ValueError):
            steps = DEFAULT_STEPS
        self.steps = max(1, min(MAX_STEPS, steps))
        self.base_dir = base_dir or tempfile.gettempdir()
        self._allow_trace = allow_trace
        self._cuda = cuda
        self._laps: List[Dict[str, Any]] = []
        self._t_last: Optional[float] = None
        self._prof = None
        self.trace_dir = ""
        self.first_step: Optional[int] = None
        self.last_step: Optional[int] = None

    @property
    def trace_path(self) -> str:
        return os.path.join(self.trace_dir, TRACE_FILE) \
            if self.trace_dir else ""

    # -- lifecycle ----------------------------------------------------------

    def start(self, completed_step: int) -> None:
        """Arm the window: ``completed_step`` just finished (the directive
        rode its heartbeat ACK); capture begins with the NEXT step, so
        every lap is a whole step."""
        self.first_step = completed_step + 1
        self._t_last = time.perf_counter()
        if self._allow_trace:
            try:
                self._prof = start_profiler(self._cuda)
                self.trace_dir = os.path.join(
                    self.base_dir, "profile-trace-%s" % _safe_id(self.id))
            except Exception:  # noqa: BLE001 — the trace is a bonus
                log.warning("profile %s: torch.profiler did not start",
                            self.id, exc_info=True)
                self._prof = None
        log.info("profile %s: capturing %d step(s) from step %d "
                 "(torch.profiler trace: %s)", self.id or "<anon>",
                 self.steps, self.first_step,
                 "on" if self._prof is not None else "off")

    def tick(self, completed_step: int) -> bool:
        """Record the wall lap of the step that just committed; True once
        the requested window is full (the caller then calls
        :meth:`finish`)."""
        now = time.perf_counter()
        if (self._t_last is not None and self.first_step is not None
                and completed_step >= self.first_step):
            self._laps.append({
                "step": completed_step,
                "wallSeconds": round(now - self._t_last, 6),
            })
            self.last_step = completed_step
        self._t_last = now
        return len(self._laps) >= self.steps

    def _stop_trace(self, write: bool = True) -> None:
        prof, self._prof = self._prof, None
        if prof is None:
            return
        try:
            if write:
                stop_profiler(prof, self.trace_path, self._cuda)
            else:
                prof.stop()
        except Exception:  # noqa: BLE001 — a failed stop must not kill the loop
            log.warning("profile %s: torch.profiler stop failed", self.id,
                        exc_info=True)
            self.trace_dir = ""

    def abandon(self) -> None:
        """Teardown path: stop any running profiler, drop the laps. The
        loop's ``finally`` calls it, so an exit mid-capture never leaves
        the profiler running."""
        self._stop_trace(write=False)
        self._laps = []

    # -- artifact -----------------------------------------------------------

    def _merge_recorder(self, recorder: Any) -> List[Dict[str, Any]]:
        """Join the flight recorder's per-phase rows onto the wall laps.
        The ring keys steps by the 0-based loop index while the capture
        speaks 1-based completed steps, hence the ``-1``."""
        rows = [dict(lap) for lap in self._laps]
        if recorder is None or not rows:
            return rows
        try:
            by_step = {rec.get("step"): rec for rec in recorder.snapshot()}
        except Exception:  # noqa: BLE001 — observability, not control flow
            return rows
        for row in rows:
            rec = by_step.get(row["step"] - 1)
            if not rec:
                continue
            for key, value in rec.items():
                if key != "step":
                    row.setdefault(key, value)
        return rows

    def finish(self, recorder: Any = None) -> Tuple[str, Dict[str, Any]]:
        """Close the window: stop and write the trace, write the artifact
        JSON (atomic tmp + rename), and return ``(path, result)`` where
        result is the heartbeat's ``profile`` payload. A failed write
        returns an empty path with the result intact, so the operator
        still folds ``Captured``."""
        self._stop_trace()
        steps = self._merge_recorder(recorder)
        result: Dict[str, Any] = {
            "id": self.id,
            "capturedSteps": len(steps),
        }
        body: Dict[str, Any] = {
            "kind": ARTIFACT_KIND,
            "id": self.id,
            "requestedSteps": self.steps,
            "capturedSteps": len(steps),
            "firstStep": self.first_step,
            "lastStep": self.last_step,
            "jaxTraceDir": self.trace_dir,
            "steps": steps,
        }
        path = os.path.join(self.base_dir,
                            "profile-%s.json" % _safe_id(self.id))
        try:
            os.makedirs(self.base_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(body, f, indent=1)
            os.replace(tmp, path)
        except OSError:
            log.warning("profile %s: artifact write to %s failed",
                        self.id, path, exc_info=True)
            return "", result
        return path, result
