"""Step heartbeats: payload → operator status server.

A replica or trainer whose process hangs keeps its pod Running —
kubelet sees a healthy process, the operator sees healthy pods, and the
only symptom is *silence*. The heartbeat closes that gap from the inside:
the payload posts its step cadence and telemetry (serving: readiness,
tokens/s, queue depth, KV-cache use; training: loss, tokens/s) to the
operator's status server (``POST /api/heartbeat``), which surfaces it as
per-job gauges in
``/metrics`` and as ``status.lastHeartbeat`` on the TPUJob — a stale
timestamp there IS the hang alarm, visible from ``kubectl get``.

Strictly best-effort by design: the reporter never raises, never blocks
the step loop beyond a short socket timeout, and rate-limits itself — a
down status server costs the payload one failed connect per interval,
nothing more. The env contract (TPUJOB_STATUS_URL, injected by
trainer/replicas.py when the operator advertises a URL) gates the whole
feature: unset means ``from_env`` returns None and the payload runs
exactly as before.

This is the PyTorch payload's own copy of
``tpu_operator/payload/heartbeat.py`` (stdlib only): the same wire format
and env contract, so the operator reads both payloads' beats alike. A
training beat carries ``loss`` (finite only) and ``tokensPerSec`` (from
``tokens_per_batch``), the checkpointer's durability counters
(``lastCheckpointStep``, ``checkpointSaveFailures``,
``checkpointRestoreFallbacks``) and the store's
(``storeLastUploadedStep``, ``storeUploadFailures``), the data plane's
knobs (``dataPlane``) and, once, the startup breakdown (``startup``);
:meth:`HeartbeatReporter.report_startup` posts the pre-first-step
``startupStage`` liveness beats. The ACK body carries the operator's
directives back: a cooperative drain (``drain``; its ``drainAck``
one-shot rides every beat until a post succeeds) and an on-demand
profile (``profile``; the capture's result rides every beat until a post
succeeds). In a multi-process job only process 0 sends that stream;
every other process sends the cadence-only flavour (identity, step
cadence and the ``stepTiming`` digest, for the operator's straggler
detector). With an ``async_sink`` (the autotune host worker) steady
beats post off the step thread; a beat carrying ``startup``, ``profile``
or ``drainAck`` always posts on the caller's thread, since its one-shot
protocol needs the server's verdict.
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
POST_TIMEOUT = 2.0       # socket timeout: never stall a step

# Directive ids remembered per channel (a leak backstop: the operator
# sends one directive at a time).
SEEN_IDS_CAP = 64


def interval_of(heartbeat: Any) -> float:
    """The posting cadence of a reporter-shaped object: the one
    definition the reporter's ``due()``, the startup ticker and the
    autotune runtime share. A malformed or negative interval resolves
    to the default; 0 stays 0 (post every step)."""
    try:
        interval = float(getattr(heartbeat, "interval", DEFAULT_INTERVAL))
    except (TypeError, ValueError):
        return DEFAULT_INTERVAL
    if not math.isfinite(interval) or interval < 0:
        return DEFAULT_INTERVAL
    return interval


def _http_post(url: str, body: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """POST ``body``; returns the ACK body when it is a JSON object (the
    operator's control channel back into the payload), else None."""
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=POST_TIMEOUT) as resp:
        try:
            parsed = json.loads(resp.read() or b"{}")
        except ValueError:
            return None
        return parsed if isinstance(parsed, dict) else None


class HeartbeatReporter:
    """Posts step telemetry to ``{base_url}/api/heartbeat``.

    ``clock``/``poster`` are injectable for tests. A serve replica, the
    one-card trainer and process 0 of a training job send the whole
    stream: identity, step cadence, the ``stepTiming`` digest, and the
    serving state or the training loss. ``tokens_per_batch`` (> 0) turns
    step cadence into ``tokensPerSec``. ``cadence_only`` is the flavour of
    a training job's other processes: identity, step cadence and the
    ``stepTiming`` digest (and a serving state, which is per replica), no
    loss, tokens/s or drain ACK."""

    def __init__(self, base_url: str, job_name: str,
                 namespace: str = "default", process_id: int = 0,
                 attempt: int = 0, interval: float = DEFAULT_INTERVAL,
                 tokens_per_batch: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 poster: Optional[Callable[[str, Dict[str, Any]],
                                           Optional[Dict[str, Any]]]] = None,
                 cadence_only: bool = False):
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
        self.tokens_per_batch = tokens_per_batch
        self.cadence_only = cadence_only
        self._clock = clock
        self._poster = poster or _http_post
        self._last_post: Optional[float] = None
        self._last_step: Optional[int] = None
        self._failed_once = False
        # Async host path (``autotune.AsyncHost.submit``): steady posts
        # hand their serialization and round trip to the worker thread.
        self.async_sink: Optional[Callable[..., bool]] = None
        # On-demand profile channel, the drain channel's shape: a
        # directive from an ACK waits until the train loop takes it; the
        # capture's result rides every beat until a post succeeds.
        self._profile_directive: Optional[Dict[str, Any]] = None
        self._profile_result: Optional[Dict[str, Any]] = None
        self._profile_seen: set = set()
        # Cooperative-drain channel: a directive from an ACK waits here
        # until the train loop takes it; the loop's ``drainAck {id, step}``
        # rides every beat until a post succeeds. Seen ids dedup the
        # directive the operator resends until it sees the ACK.
        self._drain_directive: Optional[Dict[str, Any]] = None
        self._drain_ack: Optional[Dict[str, Any]] = None
        self._drain_seen: set = set()

    def due(self, _step: int) -> bool:
        return self._last_post is None \
            or self._clock() - self._last_post >= self.interval

    def report(self, step: int, metrics: Optional[Dict[str, Any]] = None,
               checkpoint: Optional[Dict[str, Any]] = None,
               startup: Optional[Dict[str, Any]] = None,
               steptiming: Optional[Dict[str, Any]] = None,
               dataplane: Optional[Dict[str, Any]] = None,
               serving: Optional[Dict[str, Any]] = None) -> bool:
        """Post one heartbeat; returns True when the post succeeded. Step
        time is averaged over the steps since the previous post, so it is
        meaningful at any reporting interval.

        ``metrics`` are the training step's host values (its ``loss`` is
        sent when finite); ``steptiming`` is the flight recorder's
        windowed phase digest (``StepRecorder.summary()``); ``serving`` is
        the replica's serving state (``ServeLoop.serving_wire()``);
        ``checkpoint`` is the checkpointer's ``stats()``, mapped onto
        ``lastCheckpointStep`` / ``checkpointSaveFailures`` /
        ``checkpointRestoreFallbacks`` and the store's
        ``storeLastUploadedStep`` / ``storeUploadFailures``; ``startup``
        is the attempt's ``StartupTracker.breakdown()``, sent once after
        the first step; ``dataplane`` is ``DataPlaneRuntime.wire()`` (the
        last three not on cadence-only beats)."""
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
        if startup and not self.cadence_only:
            body["startup"] = dict(startup)
        if dataplane and not self.cadence_only:
            body["dataPlane"] = dict(dataplane)
        if self._last_post is not None and self._last_step is not None \
                and step > self._last_step:
            per_step = (now - self._last_post) / (step - self._last_step)
            body["stepTimeSeconds"] = round(per_step, 6)
            if self.tokens_per_batch > 0 and per_step > 0 \
                    and not self.cadence_only:
                body["tokensPerSec"] = round(self.tokens_per_batch / per_step,
                                             3)
        if self.cadence_only:
            self._last_post, self._last_step = now, int(step)
            return self._post(body)
        if checkpoint:
            if checkpoint.get("lastCheckpointStep") is not None:
                body["lastCheckpointStep"] = int(
                    checkpoint["lastCheckpointStep"])
            for src, dst in (("saveFailures", "checkpointSaveFailures"),
                             ("restoreFallbacks",
                              "checkpointRestoreFallbacks"),
                             ("lastUploadedStep", "storeLastUploadedStep"),
                             ("uploadFailures", "storeUploadFailures")):
                if checkpoint.get(src) is not None:
                    body[dst] = int(checkpoint[src])
        loss = (metrics or {}).get("loss")
        if loss is not None:
            try:
                loss = float(loss)
                # A diverged step yields NaN/Inf, which the server rejects
                # (they would poison the CRD status JSON): liveness only.
                if math.isfinite(loss):
                    body["loss"] = loss
            except (TypeError, ValueError):
                pass
        self._last_post, self._last_step = now, int(step)
        if self._profile_result is not None:
            body["profile"] = dict(self._profile_result)
        if self._drain_ack is not None:
            body["drainAck"] = dict(self._drain_ack)
        return self._post(body)

    def take_profile_directive(self) -> Optional[Dict[str, Any]]:
        """The pending on-demand profile directive (``{"id", "steps"}``)
        from a heartbeat ACK, consumed exactly once."""
        directive, self._profile_directive = self._profile_directive, None
        return directive

    def attach_profile_result(self, result: Dict[str, Any]) -> None:
        """Attach a finished capture's result to every later beat until a
        post succeeds; its id joins the seen set, so the directive the
        operator resends until it folds this result is never taken
        again."""
        self._profile_seen.add(str(result.get("id", "")))
        self._profile_result = dict(result)

    def take_drain_directive(self) -> Optional[Dict[str, Any]]:
        """The pending cooperative-drain directive (``{"id", "reason",
        ...}``) from a heartbeat ACK, consumed exactly once: the train loop
        polls it after each step and arms the planned-drain latch."""
        directive, self._drain_directive = self._drain_directive, None
        return directive

    def attach_drain_ack(self, ack: Dict[str, Any]) -> None:
        """Attach the drain adoption ACK (``{"id", "step"}``) to every
        later beat until a post succeeds; its id joins the seen set so the
        resent directive is never taken again."""
        self._drain_seen.add(str(ack.get("id", "")))
        self._drain_ack = dict(ack)

    def _post(self, body: Dict[str, Any]) -> bool:
        """Best-effort POST: never raises, logs the first failure of a
        streak rather than a stream. With an ``async_sink`` a steady beat
        is handed off (True = accepted for delivery); a beat carrying
        ``startup``, ``profile`` or ``drainAck`` posts here, since its
        one-shot protocol needs the server's verdict."""
        sink = self.async_sink
        if sink is not None and "startup" not in body \
                and "profile" not in body and "drainAck" not in body:
            return bool(sink(self._post_now, body))
        return self._post_now(body)

    def _post_now(self, body: Dict[str, Any]) -> bool:
        try:
            ack = self._poster(self.url, body)
            self._failed_once = False
            if "profile" in body:
                self._profile_result = None  # the one-shot was delivered
            if "drainAck" in body:
                self._drain_ack = None  # the one-shot was delivered
            if isinstance(ack, dict):
                self._profile_directive = _take_new(
                    ack.get("profile"), self._profile_seen,
                    self._profile_directive)
                self._drain_directive = _take_new(
                    ack.get("drain"), self._drain_seen,
                    self._drain_directive)
            return True
        except Exception as e:  # noqa: BLE001 — heartbeats never kill a payload
            if not self._failed_once:
                log.warning("heartbeat post to %s failed: %s", self.url, e)
                self._failed_once = True
            return False

    def report_startup(self, stage: str) -> bool:
        """Post a pre-first-step liveness beat carrying only the in-flight
        ``startupStage``: the operator's stall watchdog counts it as
        liveness, so a long kernel build or restore never reads as a
        hang. It leaves the step-cadence bookkeeping alone (the first
        step's report fires at once, and step time never spans startup).
        Cadence-only reporters send none."""
        if self.cadence_only:
            return False
        return self._post({
            "namespace": self.namespace,
            "name": self.job_name,
            "processId": self.process_id,
            "attempt": self.attempt,
            "startupStage": str(stage),
        })

    def maybe_report(self, step: int,
                     metrics: Optional[Dict[str, Any]] = None,
                     checkpoint: Optional[Dict[str, Any]] = None,
                     serving: Optional[Dict[str, Any]] = None) -> bool:
        if not self.due(step):
            return False
        return self.report(step, metrics, checkpoint=checkpoint,
                           serving=serving)


def _take_new(directive: Any, seen: set,
              pending: Optional[Dict[str, Any]]
              ) -> Optional[Dict[str, Any]]:
    """A directive from an ACK body that this channel has not seen (its
    id joins ``seen``), else the one already pending."""
    if not isinstance(directive, dict) or not directive.get("id") \
            or str(directive["id"]) in seen:
        return pending
    if len(seen) >= SEEN_IDS_CAP:
        seen.clear()
    seen.add(str(directive["id"]))
    return dict(directive)


# Set by the pod launcher (``launch.py``) on each card process: the pod's
# own JAX_PROCESS_ID on the pod's card 0, NO_BEATS on its other cards. The
# operator's straggler detector and its remediation address pods by that
# id, so a pod beats once, under it, whatever its card count.
ENV_BEAT_ID = "TPUJOB_HEARTBEAT_ID"
NO_BEATS = "none"


def from_env(env: Optional[Dict[str, str]] = None,
             tokens_per_batch: int = 0) -> Optional[HeartbeatReporter]:
    """Reporter from the operator's env contract, or None when heartbeats
    are not wired (no TPUJOB_STATUS_URL). Process 0 sends the full stream,
    every other process cadence-only beats; those exist for the straggler
    detector, so a non-zero process sends none when the flight recorder is
    off (TPUJOB_STEPTRACE_ENABLED=0). Under the pod launcher the process
    id is the pod's (``TPUJOB_HEARTBEAT_ID``), and a card other than the
    pod's first sends none."""
    e = env if env is not None else os.environ
    url = e.get("TPUJOB_STATUS_URL", "")
    job = e.get("TPUJOB_NAME", "")
    beat_id = e.get(ENV_BEAT_ID)
    if not url or not job or beat_id == NO_BEATS:
        return None

    # Best-effort contract: malformed env must not kill the payload.
    def _num(var: str, default, cast):
        try:
            return cast(e.get(var) or default)
        except ValueError:
            log.warning("ignoring malformed %s=%r", var, e.get(var))
            return default

    process_id = _num(ENV_BEAT_ID if beat_id is not None
                      else "JAX_PROCESS_ID", 0, int)
    if process_id != 0 and str(e.get("TPUJOB_STEPTRACE_ENABLED", "1")
                               ).lower() in ("0", "false"):
        return None
    return HeartbeatReporter(
        url, job,
        namespace=e.get("TPUJOB_NAMESPACE", "default"),
        process_id=process_id,
        attempt=_num("TPUJOB_ATTEMPT", 0, int),
        interval=_num("TPUJOB_HEARTBEAT_INTERVAL", DEFAULT_INTERVAL, float),
        tokens_per_batch=tokens_per_batch,
        cadence_only=process_id != 0,
    )
