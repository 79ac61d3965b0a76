"""Serving heartbeats: payload → operator status server.

A replica whose process hangs keeps its pod Running — kubelet sees a
healthy process, the operator sees healthy pods, and the only symptom is
*silence*. The heartbeat closes that gap from the inside: the replica
posts its step cadence and serving telemetry (readiness, tokens/s, queue
depth, KV-cache use) to the operator's status server
(``POST /api/heartbeat``), which surfaces it as per-job gauges in
``/metrics`` and as ``status.lastHeartbeat`` on the TPUJob — a stale
timestamp there IS the hang alarm, visible from ``kubectl get``.

Strictly best-effort by design: the reporter never raises, never blocks
the step loop beyond a short socket timeout, and rate-limits itself — a
down status server costs the payload one failed connect per interval,
nothing more. The env contract (TPUJOB_STATUS_URL, injected by
trainer/replicas.py when the operator advertises a URL) gates the whole
feature: unset means ``from_env`` returns None and the payload runs
exactly as before.

This is the PyTorch payload's own copy of the part of
``tpu_operator/payload/heartbeat.py`` that the serve loop uses (stdlib
only): the same wire format and env contract, so the operator reads both
payloads' beats alike. The profile, drain and startup channels come with
the slices that port those features.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from typing import Any, Callable, Dict, Optional

log = logging.getLogger(__name__)

DEFAULT_INTERVAL = 10.0  # seconds between posts (per process)
POST_TIMEOUT = 2.0       # socket timeout: never stall a decode step


def _http_post(url: str, body: Dict[str, Any]) -> None:
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=POST_TIMEOUT) as resp:
        resp.read()


class HeartbeatReporter:
    """Posts step telemetry to ``{base_url}/api/heartbeat``.

    ``clock``/``poster`` are injectable for tests. A serve replica is one
    process, so it sends the whole stream: identity, step cadence, the
    ``stepTiming`` digest and the serving state."""

    def __init__(self, base_url: str, job_name: str,
                 namespace: str = "default", process_id: int = 0,
                 attempt: int = 0, interval: float = DEFAULT_INTERVAL,
                 clock: Callable[[], float] = time.monotonic,
                 poster: Optional[Callable[[str, Dict[str, Any]], None]] = None):
        self.url = base_url.rstrip("/") + "/api/heartbeat"
        self.job_name = job_name
        self.namespace = namespace
        self.process_id = process_id
        self.attempt = attempt
        # A malformed or negative interval falls back to the default; 0
        # stays 0 (post every step).
        if not math.isfinite(interval) or interval < 0:
            interval = DEFAULT_INTERVAL
        self.interval = interval
        self._clock = clock
        self._poster = poster or _http_post
        self._last_post: Optional[float] = None
        self._last_step: Optional[int] = None
        self._failed_once = False

    def due(self, _step: int) -> bool:
        return self._last_post is None \
            or self._clock() - self._last_post >= self.interval

    def report(self, step: int,
               steptiming: Optional[Dict[str, Any]] = None,
               serving: Optional[Dict[str, Any]] = None) -> bool:
        """Post one heartbeat; returns True when the post succeeded. Step
        time is averaged over the steps since the previous post, so it is
        meaningful at any reporting interval.

        ``steptiming`` is the flight recorder's windowed phase digest
        (``StepRecorder.summary()``); ``serving`` is the replica's serving
        state (``ServeLoop.serving_wire()``)."""
        now = self._clock()
        body: Dict[str, Any] = {
            "namespace": self.namespace,
            "name": self.job_name,
            "step": int(step),
            "processId": self.process_id,
            "attempt": self.attempt,
        }
        if steptiming:
            body["stepTiming"] = dict(steptiming)
        if serving:
            body["serving"] = dict(serving)
        if self._last_post is not None and self._last_step is not None \
                and step > self._last_step:
            per_step = (now - self._last_post) / (step - self._last_step)
            body["stepTimeSeconds"] = round(per_step, 6)
        self._last_post, self._last_step = now, int(step)
        return self._post(body)

    def _post(self, body: Dict[str, Any]) -> bool:
        """Best-effort POST: never raises, logs the first failure of a
        streak rather than a stream."""
        try:
            self._poster(self.url, body)
            self._failed_once = False
            return True
        except Exception as e:  # noqa: BLE001 — heartbeats never kill serving
            if not self._failed_once:
                log.warning("heartbeat post to %s failed: %s", self.url, e)
                self._failed_once = True
            return False


def from_env(env: Optional[Dict[str, str]] = None
             ) -> Optional[HeartbeatReporter]:
    """Reporter from the operator's env contract, or None when heartbeats
    are not wired (no TPUJOB_STATUS_URL)."""
    e = env if env is not None else os.environ
    url = e.get("TPUJOB_STATUS_URL", "")
    job = e.get("TPUJOB_NAME", "")
    if not url or not job:
        return None

    # Best-effort contract: malformed env must not kill the payload.
    def _num(var: str, default, cast):
        try:
            return cast(e.get(var) or default)
        except ValueError:
            log.warning("ignoring malformed %s=%r", var, e.get(var))
            return default

    return HeartbeatReporter(
        url, job,
        namespace=e.get("TPUJOB_NAMESPACE", "default"),
        process_id=_num("JAX_PROCESS_ID", 0, int),
        attempt=_num("TPUJOB_ATTEMPT", 0, int),
        interval=_num("TPUJOB_HEARTBEAT_INTERVAL", DEFAULT_INTERVAL, float),
    )
