"""Serving payload: continuous-batching incremental decode on the CUDA
device (counterpart of ``tpu_operator/payload/serve.py``).

``python -m tpu_operator_torch.payload.serve`` runs one replica's decode
service:

- **Incremental decode on a paged KV cache** (``kvcache.py``, the default
  ``--decode-engine paged``): admission runs one causal prefill over the
  prompt on the flash forward kernel; every later step attends one new
  token per slot against the cached span on the flash decode kernel.
  ``--decode-engine reforward`` keeps the whole-matrix re-forward baseline.
- **Continuous batching.** Requests admit into free slots at iteration
  boundaries; a finished request frees its slot and its pages at once.
- **Backpressure.** The ingress queue is depth-bounded (``--max-queue``)
  and age-bounded (``--queue-deadline``); shed requests are counted.
- **HTTP ingress.** ``--http-port`` (``$TPUJOB_SERVE_PORT``) serves
  ``POST /v1/decode`` (``{"prompt": [ints], "maxTokens": n}`` ->
  ``{"tokens": [...]}``) and ``GET /healthz``.
- **Synthetic load.** ``--load "rps:seconds,..."`` drives open-loop
  arrivals; per-request latency is measured arrival to completion.
- **Readiness.** A replica posts ``ready: true`` after its weights are
  built and both engine paths ran once (kernels built and loaded).

Weights come from a seeded init on the device (``--seed``). Checkpoint
restore, hot reload from the warm-start store and the store watcher are
not ported yet: a non-empty ``--checkpoint-dir`` (or
``$TPU_CHECKPOINT_DIR``) raises instead of being ignored.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_operator_torch.device import resolve_device
from tpu_operator_torch.payload import bootstrap
from tpu_operator_torch.payload import flash_attention as fa
from tpu_operator_torch.payload import heartbeat as heartbeat_mod
from tpu_operator_torch.payload import kvcache
from tpu_operator_torch.payload import steptrace as steptrace_mod
from tpu_operator_torch.payload.models import TransformerLM

log = logging.getLogger(__name__)

# Operator env contract (injected when spec.mode is serve).
ENV_SERVE_PORT = "TPUJOB_SERVE_PORT"
ENV_CHECKPOINT_DIR = "TPU_CHECKPOINT_DIR"

# Idle poll when no request slot is active: the loop must not spin.
IDLE_SLEEP = 0.002

# Consecutive decode failures after which the service gives up (exit 1),
# handing the replica to the operator's per-pod restart path.
MAX_CONSECUTIVE_FAILURES = 8

# Cap on the run-level latency record.
RUN_LATENCY_CAP = 65536


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--load", default="5:30",
                   help="requests/sec schedule, 'rps:seconds[,rps:seconds"
                        "...]' — piecewise-constant open-loop arrivals; "
                        "the service exits when the schedule ends "
                        "(0 duration segment = hold forever)")
    p.add_argument("--batch", type=int, default=4,
                   help="decode slots: concurrent requests per step")
    p.add_argument("--decode-tokens", type=int, default=8,
                   help="tokens generated per request")
    p.add_argument("--window", type=int, default=64,
                   help="prompt context window (paged decode grows the "
                        "context past it by up to --decode-tokens)")
    p.add_argument("--vocab", type=int, default=128)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--kv-heads", type=int, default=2,
                   help="grouped-query attention K/V heads (0 = MHA)")
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--decode-engine", choices=("paged", "reforward"),
                   default="paged",
                   help="paged = incremental decode on the paged KV cache; "
                        "reforward = the whole-matrix re-forward baseline")
    p.add_argument("--page-size", type=int,
                   default=kvcache.DEFAULT_PAGE_SIZE,
                   help="KV cache page size in tokens (paged engine)")
    p.add_argument("--kv-pages", type=int, default=0,
                   help="KV cache pool size in pages (0 = slots x "
                        "pages-per-request)")
    p.add_argument("--max-queue", type=int, default=256,
                   help="ingress queue depth bound: arrivals past it shed")
    p.add_argument("--queue-deadline", type=float, default=30.0,
                   help="seconds a request may wait queued before being "
                        "shed oldest-first (0 = never shed on age)")
    p.add_argument("--http-port", type=int,
                   default=int(os.environ.get(ENV_SERVE_PORT) or 0),
                   help="HTTP ingress port for POST /v1/decode + GET "
                        "/healthz (default $TPUJOB_SERVE_PORT; 0 = none)")
    p.add_argument("--checkpoint-dir",
                   default=os.environ.get(ENV_CHECKPOINT_DIR, ""),
                   help="weight source; checkpoint restore is not ported "
                        "yet, so a non-empty value raises")
    p.add_argument("--device", default="",
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "PyTorch attention path)")
    return p.parse_args(argv)


# --- load generation ----------------------------------------------------------


class LoadSchedule:
    """Piecewise-constant requests/sec over time: ``[(rps, seconds), ...]``.
    A zero-duration final segment holds its rate forever."""

    def __init__(self, segments: List[Tuple[float, float]]):
        if not segments:
            raise ValueError("load schedule needs at least one segment")
        for rps, seconds in segments:
            if rps < 0 or seconds < 0:
                raise ValueError(
                    f"load segment ({rps}:{seconds}) must be non-negative")
        self.segments = list(segments)

    @classmethod
    def parse(cls, text: str) -> "LoadSchedule":
        segments = []
        for part in str(text).split(","):
            part = part.strip()
            if not part:
                continue
            rate, _, seconds = part.partition(":")
            segments.append((float(rate), float(seconds or 0)))
        return cls(segments)

    def rate_at(self, t: float) -> Optional[float]:
        """Requests/sec at elapsed time ``t``; None = schedule over."""
        at = 0.0
        for rps, seconds in self.segments:
            if seconds <= 0:  # hold forever
                return rps
            if t < at + seconds:
                return rps
            at += seconds
        return None


class LoadGenerator:
    """Open-loop arrivals at the schedule's rate: deterministic fractional
    accumulation (rate x elapsed), independent of poll cadence."""

    def __init__(self, schedule: LoadSchedule):
        self.schedule = schedule
        self._t0: Optional[float] = None
        self._last: Optional[float] = None
        self._accum = 0.0
        self.total_arrivals = 0

    def due(self, now: float) -> Optional[int]:
        """Arrivals since the previous call; None once the schedule is
        over."""
        if self._t0 is None:
            self._t0 = self._last = now
            return 0
        rate = self.schedule.rate_at(now - self._t0)
        if rate is None:
            return None
        self._accum += max(0.0, now - self._last) * rate
        self._last = now
        n = int(self._accum)
        self._accum -= n
        self.total_arrivals += n
        return n


class LatencyWindow:
    """Per-request latency + token samples since the last drain (bounded),
    plus arrival accounting; each heartbeat drains one disjoint window."""

    CAP = 4096

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._samples: List[float] = []  # guarded-by: _lock
        self._arrivals = 0  # guarded-by: _lock
        self._tokens = 0  # guarded-by: _lock
        self._since = clock()  # guarded-by: _lock

    def arrived(self, n: int = 1) -> None:
        with self._lock:
            self._arrivals += n

    def generated(self, n: int = 1) -> None:
        with self._lock:
            self._tokens += n

    def record(self, seconds: float) -> None:
        with self._lock:
            if len(self._samples) < self.CAP:
                self._samples.append(float(seconds))

    def drain(self) -> Dict[str, float]:
        """{requestsPerSecond (offered), tokensPerSecond, p50, p95, p99,
        completed} over the window since the previous drain."""
        now = self._clock()
        with self._lock:
            samples = sorted(self._samples)
            arrivals, since = self._arrivals, self._since
            tokens = self._tokens
            self._samples, self._arrivals, self._tokens = [], 0, 0
            self._since = now
        elapsed = max(1e-9, now - since)
        out: Dict[str, float] = {
            "requestsPerSecond": arrivals / elapsed,
            "tokensPerSecond": tokens / elapsed,
            "completed": float(len(samples)),
        }
        if samples:
            for name, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
                out[name] = samples[min(len(samples) - 1,
                                        int(q * len(samples)))]
        return out


# --- requests -----------------------------------------------------------------


class Request:
    """One decode request: prompt in, up to ``max_tokens`` out. ``done``
    is set on completion or shed; ``tokens`` is written only by the decode
    loop, and readers wait for ``done`` first."""

    __slots__ = ("arrived", "prompt", "max_tokens", "tokens", "done", "shed")

    def __init__(self, prompt, max_tokens: int, arrived: float):
        self.arrived = float(arrived)
        self.prompt = prompt
        self.max_tokens = int(max_tokens)
        self.tokens: List[int] = []
        self.done = threading.Event()
        self.shed = False

    def finish(self) -> None:
        self.done.set()

    def shed_now(self) -> None:
        self.shed = True
        self.done.set()


# --- the decode engines -------------------------------------------------------


def build_model(args, device=None) -> TransformerLM:
    """The serve model at the flags' widths, from a seeded init on the
    device. Its position table spans ``window + decode_tokens``, so paged
    decode's grown contexts have positions."""
    dev = resolve_device(device)
    model = TransformerLM(args.vocab, args.dim, args.heads, args.layers,
                          args.window + args.decode_tokens,
                          kv_heads=args.kv_heads, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(args.seed))
    return model.init_weights(gen).eval()


def _causal_attend(_i):
    return lambda q, k, v: fa.flash_attention(q, k, v, causal=True)


class ReforwardEngine:
    """The baseline: one forward over the whole ``[batch, window]`` sliding
    request matrix per generated token (per-token cost O(window x model))."""

    kind = "reforward"

    def __init__(self, args, device=None):
        self.args = args
        self.device = resolve_device(device)
        self._tokens = np.zeros((args.batch, args.window), np.int64)

    def can_admit(self, prompt_len: int, new_tokens: int) -> bool:
        return True

    def admit(self, slot: int, prompt, new_tokens: int,
              params) -> Tuple[bool, Optional[int]]:
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        row = np.zeros(self.args.window, np.int64)
        row[-len(prompt):] = prompt[-self.args.window:]
        self._tokens[slot] = row
        return True, None  # first token comes from the next step

    @torch.inference_mode()
    def step(self, params, active):
        tokens = torch.from_numpy(self._tokens.copy()).to(self.device)
        logits = params(tokens, None, _causal_attend)
        out = torch.argmax(logits[:, -1].float(), dim=-1).to(
            torch.int32).cpu().numpy()
        for slot in np.nonzero(np.asarray(active, bool))[0]:
            self._tokens[slot, :-1] = self._tokens[slot, 1:]
            self._tokens[slot, -1] = out[slot]
        return out

    def release(self, slot: int) -> None:
        self._tokens[slot] = 0

    def utilization(self) -> float:
        return 0.0

    def warmup(self, params) -> None:
        self.step(params, np.zeros(self.args.batch, bool))


class PagedEngine:
    """Incremental decode on the paged KV cache: prefill once at
    admission, then one-token steps against the cached span."""

    kind = "paged"

    def __init__(self, args, device=None):
        self.args = args
        spec = kvcache.ModelSpec(
            vocab=args.vocab, dim=args.dim, heads=args.heads,
            layers=args.layers, max_seq=args.window + args.decode_tokens,
            kv_heads=args.kv_heads)
        self.cache = kvcache.DecodeEngine(
            spec, slots=args.batch, prompt_pad=args.window,
            max_new=args.decode_tokens, page_size=args.page_size,
            num_pages=args.kv_pages, device=device)

    def can_admit(self, prompt_len: int, new_tokens: int) -> bool:
        return self.cache.can_admit(prompt_len, new_tokens)

    def admit(self, slot: int, prompt, new_tokens: int,
              params) -> Tuple[bool, Optional[int]]:
        token = self.cache.admit(slot, prompt, new_tokens, params)
        if token is None:
            return False, None  # page pool exhausted; request stays queued
        return True, token

    def step(self, params, active):
        return self.cache.step(params, active)

    def release(self, slot: int) -> None:
        self.cache.release(slot)

    def utilization(self) -> float:
        return self.cache.utilization()

    def warmup(self, params) -> None:
        """Run both paths (prefill + step) once before readiness, through
        a throwaway request in slot 0: the kernels are built and loaded
        and the allocator's first-touch costs are paid before the first
        real request."""
        prompt = np.ones(self.args.window, np.int32)
        self.cache.admit(0, prompt, self.args.decode_tokens, params)
        active = np.zeros(self.args.batch, bool)
        active[0] = self.args.decode_tokens > 1
        self.cache.step(params, active)
        self.cache.release(0)


def make_engine(args, device=None):
    """Engine factory for --decode-engine."""
    if args.decode_engine == "reforward":
        return ReforwardEngine(args, device)
    return PagedEngine(args, device)


# --- the serve loop -----------------------------------------------------------


class ServeLoop:
    """One replica's decode service: the ingress queue, slot-level
    continuous batching over the decode engine, readiness, and serving
    heartbeats.

    Single-threaded decode (the step loop owns the model and the engine);
    HTTP ingress threads touch only the queue (under ``_ingress_lock``)
    and each Request's ``done`` event."""

    def __init__(self, args, info: bootstrap.ProcessInfo,
                 heartbeat: Optional[Any] = "auto",
                 recorder: Optional[Any] = "auto",
                 clock: Callable[[], float] = time.monotonic,
                 device=None):
        if args.checkpoint_dir:
            raise NotImplementedError(
                "serve: checkpoint restore is not yet ported to the "
                f"PyTorch payload (--checkpoint-dir {args.checkpoint_dir!r})")
        self.args = args
        self.info = info
        self._clock = clock
        self.device = resolve_device(device or args.device or None)
        if heartbeat == "auto":
            heartbeat = heartbeat_mod.from_env()
        self.heartbeat = heartbeat
        self.recorder = steptrace_mod.from_env() if recorder == "auto" \
            else recorder
        self.model = build_model(args, self.device)
        self.engine = make_engine(args, self.device)
        self.window = LatencyWindow(clock=clock)
        self.ready = False
        self.failed_steps = 0
        self._consecutive_failures = 0
        self.completed = 0
        self.steps = 0
        self.tokens_generated = 0
        self._requests: List[Optional[Request]] = [None] * args.batch
        self._arrival_seq = 0
        self._run_latencies: List[float] = []
        self._ingress_lock = threading.Lock()
        self._queue: List[Request] = []  # guarded-by: _ingress_lock
        self._shed = 0  # guarded-by: _ingress_lock
        self._stop = threading.Event()
        self._http: Optional[Any] = None

    @property
    def shed(self) -> int:
        with self._ingress_lock:
            return self._shed

    def queue_depth(self) -> int:
        with self._ingress_lock:
            return len(self._queue)

    # -- readiness + heartbeats ------------------------------------------------

    def serving_wire(self) -> Dict[str, Any]:
        stats = self.window.drain()
        out: Dict[str, Any] = {
            "ready": bool(self.ready),
            "requestsPerSecond": round(stats["requestsPerSecond"], 3),
            "tokensPerSecond": round(stats["tokensPerSecond"], 3),
            "queueDepth": self.queue_depth(),
            "kvCacheUtilization": round(self.engine.utilization(), 4),
            "loadedStep": 0,
            "reloads": 0,
        }
        if "p50" in stats:
            out["p50LatencySeconds"] = round(stats["p50"], 6)
            out["p95LatencySeconds"] = round(stats["p95"], 6)
        return out

    def _post_beat(self, force: bool = False) -> None:
        hb = self.heartbeat
        if hb is None:
            return
        if force or hb.due(self.steps):
            hb.report(self.steps, serving=self.serving_wire(),
                      steptiming=(self.recorder.summary()
                                  if self.recorder is not None else None))

    def _set_ready(self, ready: bool) -> None:
        """Readiness transitions post a forced beat."""
        if self.ready == ready:
            return
        self.ready = ready
        self._post_beat(force=True)

    # -- ingress ---------------------------------------------------------------

    def submit(self, prompt, max_tokens: int,
               now: Optional[float] = None) -> Optional[Request]:
        """Queue a request (HTTP threads and the synthetic generator).
        Returns None when the queue is at ``--max-queue`` (shed counted)."""
        now = self._clock() if now is None else now
        max_tokens = max(1, min(int(max_tokens), self.args.decode_tokens))
        req = Request(prompt, max_tokens, now)
        with self._ingress_lock:
            if len(self._queue) >= self.args.max_queue:
                self._shed += 1
                req = None
            else:
                self._queue.append(req)
        self.window.arrived(1)
        return req

    def _synthetic_request(self, now: float) -> None:
        """One generated arrival: a full-window prompt (request id mixed
        in) asking for the standard budget."""
        self._arrival_seq += 1
        prompt = (np.arange(self.args.window) + self._arrival_seq) \
            % self.args.vocab
        self.submit(prompt.astype(np.int32), self.args.decode_tokens,
                    now=now)

    def _shed_expired(self, now: float) -> None:
        """Requests waiting past --queue-deadline shed oldest-first."""
        deadline = float(self.args.queue_deadline)
        if deadline <= 0:
            return
        expired: List[Request] = []
        with self._ingress_lock:
            keep: List[Request] = []
            for req in self._queue:
                if now - req.arrived > deadline:
                    self._shed += 1
                    expired.append(req)
                else:
                    keep.append(req)
            self._queue[:] = keep
        for req in expired:
            req.shed_now()

    def _admit_from_queue(self) -> None:
        """Iteration-boundary admission: pull queued requests into free
        slots until slots or cache pages run out. A request the cache
        cannot hold yet goes back to the queue head."""
        for slot in range(self.args.batch):
            if self._requests[slot] is not None:
                continue
            with self._ingress_lock:
                if not self._queue:
                    return
                req = self._queue.pop(0)
            admitted, token = self.engine.admit(
                slot, req.prompt, req.max_tokens, self.model)
            if not admitted:
                with self._ingress_lock:
                    self._queue.insert(0, req)
                return
            self._requests[slot] = req
            if token is not None:
                # The paged prefill emits the first token at admission.
                self._deliver(slot, req, token, self._clock())

    # -- the decode loop -------------------------------------------------------

    def _deliver(self, slot: int, req: Request, token: int,
                 now: float) -> None:
        """Hand one token to its request; on completion free the slot and
        its cache pages immediately."""
        req.tokens.append(int(token))
        self.tokens_generated += 1
        self.window.generated(1)
        if len(req.tokens) >= req.max_tokens:
            latency = now - req.arrived
            self.window.record(latency)
            if len(self._run_latencies) < RUN_LATENCY_CAP:
                self._run_latencies.append(latency)
            self.completed += 1
            self._requests[slot] = None
            self.engine.release(slot)
            req.finish()

    def _active_mask(self):
        return np.array([r is not None for r in self._requests], bool)

    def _decode_step(self) -> None:
        rec = self.recorder
        if rec is not None:
            rec.begin(self.steps)
            rec.lap(steptrace_mod.DATA)
        active = self._active_mask()
        try:
            next_tokens = self.engine.step(self.model, active)
        except Exception:  # noqa: BLE001 — a failed step must be visible
            self.failed_steps += 1
            self._consecutive_failures += 1
            log.exception("serve: decode step failed")
            if rec is not None:
                rec.abandon()
            if self._consecutive_failures >= MAX_CONSECUTIVE_FAILURES:
                raise RuntimeError(
                    f"serve: {self._consecutive_failures} consecutive "
                    f"decode failures; giving up")
            return
        self._consecutive_failures = 0
        if rec is not None:
            rec.lap(steptrace_mod.COMPUTE)
        now = self._clock()
        for slot in range(self.args.batch):
            req = self._requests[slot]
            if req is None or not active[slot]:
                continue
            self._deliver(slot, req, int(next_tokens[slot]), now)
        if rec is not None:
            rec.lap(steptrace_mod.HOST)
            rec.commit()

    def _warmup(self) -> None:
        """Run the engine's paths once before readiness. A failure counts
        like a failed decode step (the replica does not go ready)."""
        try:
            self.engine.warmup(self.model)
        except Exception:  # noqa: BLE001 — a failed warm-up must be visible
            self.failed_steps += 1
            self._consecutive_failures += 1
            log.exception("serve: engine warm-up failed")
            return
        self._consecutive_failures = 0

    def _start_http(self) -> None:
        if self.args.http_port <= 0:
            return
        self._http = _make_http_server(self, int(self.args.http_port))
        thread = threading.Thread(target=self._http.serve_forever,
                                  daemon=True, name="serve-http")
        thread.start()
        log.info("serve: HTTP ingress on port %d",
                 self._http.server_address[1])

    def run(self, duration: Optional[float] = None) -> Dict[str, Any]:
        """Serve until the load schedule ends (or ``duration`` caps it);
        returns a summary."""
        schedule = LoadSchedule.parse(self.args.load)
        gen = LoadGenerator(schedule)
        self._warmup()
        self.steps += 1
        self._set_ready(self._consecutive_failures == 0)
        self._start_http()
        t0 = self._clock()
        try:
            while not self._stop.is_set():
                now = self._clock()
                if duration is not None and now - t0 >= duration:
                    break
                arrivals = gen.due(now)
                if (arrivals is None and self.queue_depth() == 0
                        and all(r is None for r in self._requests)):
                    break  # schedule over, queue + in-flight drained
                for _ in range(arrivals or 0):
                    self._synthetic_request(now)
                self._shed_expired(now)
                self._admit_from_queue()
                if any(r is not None for r in self._requests):
                    self._decode_step()
                    self.steps += 1
                    if not self.ready and self._consecutive_failures == 0:
                        self._set_ready(True)
                else:
                    time.sleep(IDLE_SLEEP)
                self._post_beat()
        finally:
            self._stop.set()
            self._set_ready(False)
            with self._ingress_lock:
                leftover, self._queue[:] = list(self._queue), []
                self._shed += len(leftover)
            for req in leftover:
                req.shed_now()
            for slot in range(self.args.batch):
                req = self._requests[slot]
                if req is not None and not req.done.is_set():
                    req.shed_now()
            if self._http is not None:
                self._http.shutdown()
                self._http.server_close()
        elapsed = max(1e-9, self._clock() - t0)
        summary: Dict[str, Any] = {
            "steps": self.steps,
            "completed": self.completed,
            "arrivals": gen.total_arrivals,
            "failedSteps": self.failed_steps,
            "shed": self.shed,
            "tokensGenerated": self.tokens_generated,
            "elapsedSeconds": elapsed,
            "tokensPerSecond": self.tokens_generated / elapsed,
            "kvCacheUtilization": self.engine.utilization(),
        }
        lat = sorted(self._run_latencies)
        if lat:
            for name, q in (("p50LatencySeconds", 0.50),
                            ("p95LatencySeconds", 0.95),
                            ("p99LatencySeconds", 0.99)):
                summary[name] = lat[min(len(lat) - 1, int(q * len(lat)))]
        return summary

    def stop(self) -> None:
        self._stop.set()


# --- HTTP ingress -------------------------------------------------------------


def _make_http_server(loop: ServeLoop, port: int):
    """ThreadingHTTPServer for the per-replica decode endpoint. Handler
    threads queue through :meth:`ServeLoop.submit` and block on the
    request's ``done`` event; they never touch the engine or the model."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, body: Dict[str, Any]) -> None:
            data = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802 — http.server API
            if self.path != "/healthz":
                self._reply(404, {"error": "not found"})
                return
            if loop.ready:
                self._reply(200, {"ready": True})
            else:
                self._reply(503, {"ready": False})

        def do_POST(self):  # noqa: N802 — http.server API
            if self.path != "/v1/decode":
                self._reply(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(length) or b"{}")
                prompt = [int(t) for t in body["prompt"]]
                if not 1 <= len(prompt) <= loop.args.window:
                    raise ValueError(
                        f"prompt length {len(prompt)} not in "
                        f"[1, {loop.args.window}]")
                if not all(0 <= t < loop.args.vocab for t in prompt):
                    raise ValueError(
                        f"prompt tokens must lie in [0, {loop.args.vocab})")
                max_tokens = int(body.get("maxTokens",
                                          loop.args.decode_tokens))
            except Exception as e:  # noqa: BLE001 — bad request, not a bug
                self._reply(400, {"error": str(e)})
                return
            req = loop.submit(prompt, max_tokens)
            if req is None:
                self._reply(503, {"error": "queue full"})
                return
            deadline = max(30.0, float(loop.args.queue_deadline) + 30.0)
            if not req.done.wait(timeout=deadline) or req.shed:
                self._reply(503, {"error": "request shed"})
                return
            self._reply(200, {"tokens": req.tokens})

        def log_message(self, fmt, *fmt_args):
            log.debug("serve http: " + fmt, *fmt_args)

    server = ThreadingHTTPServer(("", port), Handler)
    server.daemon_threads = True
    return server


def run(info: bootstrap.ProcessInfo, args=None) -> Dict[str, Any]:
    args = args or parse_args([])
    loop = ServeLoop(args, info)
    summary = loop.run()
    log.info("serve: %d steps, %d/%d requests completed (%d shed), "
             "%.0f tokens/sec, %d failed steps",
             summary["steps"], summary["completed"], summary["arrivals"],
             summary["shed"], summary["tokensPerSecond"],
             summary["failedSteps"])
    return summary


def main() -> None:
    """Serve replicas are independent single-process servers; the
    run_payload wrapper owns the exit-code contract (SIGTERM -> 143)."""
    args = parse_args()
    bootstrap.main_wrapper(lambda info: run(info, args))


if __name__ == "__main__":
    main()
