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

Weights come from a seeded init on the device (``--seed``), replaced
before warm-up by the newest verified checkpoint's params when
``--checkpoint-dir`` (or ``$TPU_CHECKPOINT_DIR``) holds one: the verified
restore walk of ``checkpoint.py``, reading the params file only, cast to
the server's bf16 weights (the cast the trainer's forward makes).
``loadedStep`` on the heartbeat reports the step (0 = the seeded init).

**Hot weight reload.** With ``TPUJOB_SERVE`` set and the operator's
warm-start store wired (``TPUJOB_STORE_*``), a watcher thread polls the
store every ``--reload-poll`` seconds (``$TPUJOB_SERVE_RELOAD_POLL``) for
a verified step newer than the loaded one. The decode loop runs the
reload at a step boundary: readiness drops (a forced beat), replica k
waits k x ``--reload-stagger`` seconds so the fleet rolls, the step is
prefetched into the local checkpoint dir, and the verified restore
copies its params into the live weights in place (on the decode thread,
so the copy is ordered with the decode stream); ``reloads`` counts it
and readiness returns. Live KV pages are left alone: in-flight requests
go on decoding on the new weights. A failed restore keeps the old
weights and re-readies.

**A pod's cards.** Under the pod launcher a serve pod of C cards is one
process (``TPUJOB_POD_CARDS`` = C): it drives ``cuda:0`` ... ``cuda:C-1``
(``--device cpu`` gives C CPU "cards", for the tests) behind one ingress
queue, one HTTP listener, one readiness and one heartbeat identity, as the
reference's replica drives its host's chips. Each card holds a full replica
of the weights (card 0's, copied: the reference replicates ``params``; the
serve model is never split) and its own engine over a contiguous block of
the ``--batch`` slots: slot s on card floor(s·C / B), the block that the
reference's ``P("data", None)`` gives when C divides B; when it does not,
the first B mod C cards take one slot more, and a card with no slot holds
no engine. The paged pool is split with the slots (``--kv-pages`` x
slots / B a card). The loop's one thread drives every card in turn: at
each iteration boundary it admits into every card's free slots, then
steps every card that holds a request (one pod step). A reload restores
into card 0's replica and copies it to every other card before the next
pod step (no card steps on mixed weights); readiness returns once every
card holds the new step. ``MAX_CONSECUTIVE_FAILURES`` failed steps in a
row on any card stop the pod (exit 1), and every request still queued or
in flight is shed. A bare ``python -m tpu_operator_torch.payload.serve``
drives one card.
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
from tpu_operator_torch.payload import checkpoint as checkpoint_mod
from tpu_operator_torch.payload import flash_attention as fa
from tpu_operator_torch.payload import heartbeat as heartbeat_mod
from tpu_operator_torch.payload import kvcache
from tpu_operator_torch.payload import steptrace as steptrace_mod
from tpu_operator_torch.payload import warmstore
from tpu_operator_torch.payload.models import TransformerLM

log = logging.getLogger(__name__)

# Operator env contract (injected when spec.mode is serve).
ENV_SERVE_PORT = "TPUJOB_SERVE_PORT"
ENV_CHECKPOINT_DIR = checkpoint_mod.ENV_VAR
ENV_SERVE = "TPUJOB_SERVE"
ENV_RELOAD_POLL = "TPUJOB_SERVE_RELOAD_POLL"

# Default stagger between replica reloads (x replicaIndex): the fleet
# rolls through a reload instead of dropping every Service at once.
DEFAULT_RELOAD_STAGGER = 0.5

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
                   help="weight source: the newest verified step's params "
                        "(default $TPU_CHECKPOINT_DIR; empty or no step = "
                        "the seeded init); hot-reloaded when the remote "
                        "store commits a newer step")
    p.add_argument("--reload-poll", type=float,
                   default=float(os.environ.get(ENV_RELOAD_POLL) or 0) or 10.0,
                   help="seconds between remote-store newer-step polls "
                        "(default $TPUJOB_SERVE_RELOAD_POLL, else 10)")
    p.add_argument("--reload-stagger", type=float,
                   default=DEFAULT_RELOAD_STAGGER,
                   help="seconds x replicaIndex to delay a reload so the "
                        "fleet rolls (0 = reload at once)")
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
    loop (``card``: the index of the card that admitted it), and readers
    wait for ``done`` first."""

    __slots__ = ("arrived", "prompt", "max_tokens", "tokens", "done", "shed",
                 "card")

    def __init__(self, prompt, max_tokens: int, arrived: float):
        self.arrived = float(arrived)
        self.prompt = prompt
        self.max_tokens = int(max_tokens)
        self.tokens: List[int] = []
        self.done = threading.Event()
        self.shed = False
        self.card: Optional[int] = None

    def finish(self) -> None:
        self.done.set()

    def shed_now(self) -> None:
        self.shed = True
        self.done.set()


# --- the decode engines -------------------------------------------------------


def _lm(args, device) -> TransformerLM:
    return TransformerLM(args.vocab, args.dim, args.heads, args.layers,
                         args.window + args.decode_tokens,
                         kv_heads=args.kv_heads, device=device)


def build_model(args, device=None) -> TransformerLM:
    """The serve model at the flags' widths, from a seeded init on the
    device. Its position table spans ``window + decode_tokens``, so paged
    decode's grown contexts have positions."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(args.seed))
    return _lm(args, dev).init_weights(gen).eval()


@torch.no_grad()
def copy_weights(dst: TransformerLM, src: TransformerLM) -> None:
    """``src``'s weights into ``dst``'s in place (another card's replica).
    A copy across cards runs on the source card's stream, fenced both ways
    against the two cards' streams."""
    source = dict(src.named_parameters())
    for name, p in dst.named_parameters():
        p.copy_(source[name])


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

    def page_counts(self) -> Tuple[int, int]:
        return 0, 0

    def warmup(self, params) -> None:
        self.step(params, np.zeros(self.args.batch, bool))


class PagedEngine:
    """Incremental decode on the paged KV cache: prefill once at
    admission, then one-token steps against the cached span."""

    kind = "paged"

    def __init__(self, args, device=None,
                 on_dispatch: Optional[Callable[[], None]] = None):
        self.args = args
        spec = kvcache.ModelSpec(
            vocab=args.vocab, dim=args.dim, heads=args.heads,
            layers=args.layers, max_seq=args.window + args.decode_tokens,
            kv_heads=args.kv_heads)
        self.cache = kvcache.DecodeEngine(
            spec, slots=args.batch, prompt_pad=args.window,
            max_new=args.decode_tokens, page_size=args.page_size,
            num_pages=args.kv_pages, device=device,
            on_dispatch=on_dispatch)

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

    def page_counts(self) -> Tuple[int, int]:
        """(held, all) pages of this engine's pool."""
        return self.cache.allocator.held_pages, self.cache.num_pages

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


def make_engine(args, device=None,
                on_dispatch: Optional[Callable[[], None]] = None):
    """Engine factory for --decode-engine (``on_dispatch``: the paged
    engine's hook between a decode step's launches and its token read)."""
    if args.decode_engine == "reforward":
        return ReforwardEngine(args, device)
    return PagedEngine(args, device, on_dispatch)


# --- the pod's cards ----------------------------------------------------------


def pod_devices(device: str = "", cards: int = 0) -> List[torch.device]:
    """The devices a serve process drives: ``cuda:0`` ... ``cuda:C-1`` for
    a pod of C > 1 cards (``TPUJOB_POD_CARDS``, set by the pod launcher),
    C CPU "cards" when ``device`` is the CPU, else the one ``device``.
    Raises RuntimeError when the container sees fewer than C cards."""
    dev = resolve_device(device or None)
    if cards <= 1:
        return [dev]
    if dev.type == "cpu":
        return [dev] * cards
    seen = torch.cuda.device_count()
    if cards > seen:
        raise RuntimeError(f"a serve pod of {cards} cards, but this "
                           f"container sees {seen}")
    return [torch.device("cuda", c) for c in range(cards)]


def slot_blocks(batch: int, cards: int) -> List[Tuple[int, int]]:
    """[first, end) of each card's slots: slot s lies on card floor(s·C /
    B), so the first B mod C cards take one slot more, and a card is empty
    when B < C."""
    return [(-(-c * batch // cards), -(-(c + 1) * batch // cards))
            for c in range(cards)]


def card_pages(kv_pages: int, batch: int, first: int, end: int) -> int:
    """The pages of ``--kv-pages`` that the card of slots [first, end)
    holds: the pod's cards hold exactly ``kv_pages`` together (0: each
    card its slots' full span)."""
    if kv_pages <= 0:
        return 0
    return kv_pages * end // batch - kv_pages * first // batch


class Card:
    """One card of the pod: its weight replica, its engine over the pod's
    slots [first, first + args.batch) (``args``: the pod's flags with this
    card's ``--batch`` and ``--kv-pages``), the requests in those slots,
    and its counts."""

    def __init__(self, index: int, device: torch.device, first: int, args,
                 model: TransformerLM,
                 on_dispatch: Optional[Callable[[], None]] = None):
        self.index = index
        self.device = device
        self.first = first
        self.args = args
        self.model = model
        self.engine = make_engine(args, device, on_dispatch)
        self.requests: List[Optional[Request]] = [None] * args.batch
        self.steps = 0
        self.completed = 0
        self.tokens_generated = 0
        self.failed_steps = 0
        self.consecutive_failures = 0
        self.latencies: List[float] = []

    def busy(self) -> bool:
        return any(r is not None for r in self.requests)

    def summary(self) -> Dict[str, Any]:
        out = {"card": self.index, "device": str(self.device),
               "slots": len(self.requests), "steps": self.steps,
               "completed": self.completed,
               "tokensGenerated": self.tokens_generated,
               "failedSteps": self.failed_steps}
        cache = getattr(self.engine, "cache", None)
        if cache is not None:
            out.update(prefills=cache.prefills,
                       decodeSteps=cache.decode_steps)
        return out


# --- the serve loop -----------------------------------------------------------


class ServeLoop:
    """One replica's decode service: the ingress queue, slot-level
    continuous batching over each card's engine, readiness, and serving
    heartbeats.

    ``devices`` are the pod's cards (default: the one ``device``, or
    ``--device``). The thread that calls :meth:`run` alone touches the
    cards' engines, models and requests, one card after another. HTTP
    ingress threads touch only the queue (under ``_ingress_lock``) and
    each Request's ``done`` event; the store watcher only arms the reload
    target (under ``_reload_lock``), which the loop consumes between pod
    steps. ``store`` is the warm-start store (``"auto"``: from the env
    when ``TPUJOB_SERVE`` is set; or a WarmStartStore, or None)."""

    def __init__(self, args, info: bootstrap.ProcessInfo,
                 heartbeat: Optional[Any] = "auto",
                 recorder: Optional[Any] = "auto",
                 clock: Callable[[], float] = time.monotonic,
                 device=None, store: Optional[Any] = "auto",
                 devices: Optional[List[Any]] = None):
        self.args = args
        self.info = info
        self._clock = clock
        self.devices = [torch.device(d) for d in devices] if devices \
            else [resolve_device(device or args.device or None)]
        self.device = self.devices[0]
        if heartbeat == "auto":
            heartbeat = heartbeat_mod.from_env()
        self.heartbeat = heartbeat
        self.recorder = steptrace_mod.from_env() if recorder == "auto" \
            else recorder
        if store == "auto":
            store = warmstore.store_from_env() \
                if os.environ.get(ENV_SERVE) else None
        self.store = store
        self.cards = self._place(build_model(args, self.device))
        self.window = LatencyWindow(clock=clock)
        self.ready = False
        self.reloads = 0
        # Seconds each reload kept the replica unready.
        self.reload_gaps: List[float] = []
        # Pod steps (one step of every card that holds a request), the
        # warm-up's included: the heartbeat's step.
        self.steps = 0
        self._arrival_seq = 0
        self._ingress_lock = threading.Lock()
        self._queue: List[Request] = []  # guarded-by: _ingress_lock
        self._shed = 0  # guarded-by: _ingress_lock
        # The loaded step and the pending reload target: the watcher
        # compares and arms, the decode loop consumes at a step boundary.
        self._reload_lock = threading.Lock()
        self._loaded_step = 0  # guarded-by: _reload_lock
        self._reload_target: Optional[int] = None  # guarded-by: _reload_lock
        self._stop = threading.Event()
        self._watcher: Optional[threading.Thread] = None
        self._http: Optional[Any] = None

    def _place(self, model: TransformerLM) -> List[Card]:
        """One Card a device that holds a slot: card 0 keeps ``model``,
        every other card a copy of it on its device."""
        args, n = self.args, len(self.devices)
        cards: List[Card] = []
        for index, (dev, (first, end)) in enumerate(
                zip(self.devices, slot_blocks(args.batch, n))):
            if end == first:
                log.info("serve: card %d (%s) holds no slot (--batch %d "
                         "over %d cards): no engine", index, dev, args.batch,
                         n)
                continue
            pages = card_pages(args.kv_pages, args.batch, first, end)
            if args.kv_pages > 0 and pages == 0:
                raise ValueError(f"--kv-pages {args.kv_pages} leaves card "
                                 f"{index} of {n} no page")
            card_args = argparse.Namespace(**{**vars(args),
                                              "batch": end - first,
                                              "kv_pages": pages})
            if cards:
                replica = _lm(args, dev).eval()
                copy_weights(replica, model)
            else:
                replica = model
            cards.append(Card(index, dev, first, card_args, replica,
                              on_dispatch=self._lap_dispatch))
        if n > 1:
            log.info("serve: a pod of %d cards: %s", n, ", ".join(
                f"card {c.index} ({c.device}) slots {c.first}-"
                f"{c.first + c.args.batch - 1}" for c in cards))
        return cards

    def _lap_dispatch(self) -> None:
        """A paged engine's decode step has launched its work: the flight
        recorder's DISPATCH ends here, before the token read."""
        if self.recorder is not None:
            self.recorder.lap(steptrace_mod.DISPATCH)

    @property
    def model(self) -> TransformerLM:
        """Card 0's replica: the one the restore reads into."""
        return self.cards[0].model

    @property
    def engine(self):
        return self.cards[0].engine

    @property
    def completed(self) -> int:
        return sum(c.completed for c in self.cards)

    @property
    def tokens_generated(self) -> int:
        return sum(c.tokens_generated for c in self.cards)

    @property
    def failed_steps(self) -> int:
        return sum(c.failed_steps for c in self.cards)

    def _failing(self) -> bool:
        return any(c.consecutive_failures for c in self.cards)

    @property
    def loaded_step(self) -> int:
        with self._reload_lock:
            return self._loaded_step

    def _set_loaded_step(self, step: int) -> None:
        with self._reload_lock:
            self._loaded_step = int(step)

    @property
    def shed(self) -> int:
        with self._ingress_lock:
            return self._shed

    def queue_depth(self) -> int:
        with self._ingress_lock:
            return len(self._queue)

    def utilization(self) -> float:
        """Held pages over all the pod's pages (``kvCacheUtilization``)."""
        held = total = 0
        for card in self.cards:
            h, t = card.engine.page_counts()
            held, total = held + h, total + t
        return held / total if total else 0.0

    # -- readiness + heartbeats ------------------------------------------------

    def serving_wire(self) -> Dict[str, Any]:
        stats = self.window.drain()
        out: Dict[str, Any] = {
            "ready": bool(self.ready),
            "requestsPerSecond": round(stats["requestsPerSecond"], 3),
            "tokensPerSecond": round(stats["tokensPerSecond"], 3),
            "queueDepth": self.queue_depth(),
            "kvCacheUtilization": round(self.utilization(), 4),
            "loadedStep": self.loaded_step,
            "reloads": int(self.reloads),
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
        """Readiness transitions post a forced beat: the operator's
        Service gate learns at once that a reload started."""
        if self.ready == ready:
            return
        self.ready = ready
        self._post_beat(force=True)

    # -- hot reload ------------------------------------------------------------

    def _watch_store(self) -> None:
        """Watcher thread: a newer verified remote step (a committed
        manifest) arms the reload target; the decode loop runs it."""
        while not self._stop.wait(max(0.1, float(self.args.reload_poll))):
            try:
                newest = self.store.last_uploaded_step()
            except Exception as e:  # noqa: BLE001 — the watch is best-effort
                log.warning("serve: store poll failed: %s", e)
                continue
            with self._reload_lock:
                if newest is not None and newest > self._loaded_step:
                    self._reload_target = int(newest)

    def _maybe_reload(self) -> bool:
        """Step-boundary reload: drop readiness, stagger, prefetch the
        newer step, restore it into card 0's weights in place, have every
        other card copy them, re-ready. True when a reload ran. Live KV
        pages are not touched."""
        with self._reload_lock:
            target, self._reload_target = self._reload_target, None
            loaded = self._loaded_step
        if target is None or target <= loaded:
            # The watcher re-arms the same step while a reload of it is
            # still running (the loaded step moves only at its end): that
            # step is loaded now, and a second reload would drop
            # readiness again for nothing.
            return False
        log.info("serve: newer verified step %d (loaded %d); rolling "
                 "reload", target, self.loaded_step)
        t0 = self._clock()
        self._set_ready(False)
        stagger = float(self.args.reload_stagger) * self.info.replica_index
        if stagger > 0:
            self._stop.wait(stagger)
        self._prefetch_newer()
        try:
            step = self._restore_weights()
        except Exception:  # noqa: BLE001 — keep serving the old weights
            log.exception("serve: reload restore failed; continuing on "
                          "loaded step %d", self.loaded_step)
            self._set_ready(True)
            return False
        if step > self.loaded_step:
            self._sync_replicas()
            self._set_loaded_step(step)
            self.reloads += 1
            log.info("serve: weights hot-reloaded at step %d (reload %d, "
                     "no restart)", step, self.reloads)
        self._set_ready(True)
        self.reload_gaps.append(self._clock() - t0)
        return True

    def _sync_replicas(self) -> None:
        """Every other card copies card 0's weights (between pod steps)."""
        for card in self.cards[1:]:
            copy_weights(card.model, self.model)

    def _checkpoint_dir(self) -> str:
        return self.args.checkpoint_dir \
            or os.environ.get(checkpoint_mod.ENV_VAR, "")

    def _prefetch_newer(self) -> None:
        """Materialize the newest healthy remote step in the local
        checkpoint dir, where the verified walk finds it. Best-effort: a
        broken store makes the reload a no-op, never kills the service."""
        directory = self._checkpoint_dir()
        if self.store is None or not directory:
            return
        try:
            self.store.prefetch_checkpoint(directory)
        except Exception as e:  # noqa: BLE001 — the reload is best-effort
            log.warning("serve: step prefetch failed: %s", e)

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

    def _busy(self) -> bool:
        return any(card.busy() for card in self.cards)

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
        """Admission into every card in turn."""
        for card in self.cards:
            self._admit(card)

    def _admit(self, card: Card) -> None:
        """Iteration-boundary admission: pull queued requests into
        ``card``'s free slots until its slots or cache pages run out. A
        request the cache cannot hold yet goes back to the queue head."""
        for slot in range(len(card.requests)):
            if card.requests[slot] is not None:
                continue
            with self._ingress_lock:
                if not self._queue:
                    return
                req = self._queue.pop(0)
            try:
                with steptrace_mod.span("serve.admit", card=card.index), \
                        fa.launch_scope(card.index):
                    admitted, token = card.engine.admit(
                        slot, req.prompt, req.max_tokens, card.model)
            except BaseException:
                req.shed_now()
                raise
            if not admitted:
                with self._ingress_lock:
                    self._queue.insert(0, req)
                return
            req.card = card.index
            card.requests[slot] = req
            if token is not None:
                # The paged prefill emits the first token at admission.
                self._deliver(card, slot, req, token, self._clock())

    # -- the decode loop -------------------------------------------------------

    def _deliver(self, card: Card, slot: int, req: Request, token: int,
                 now: float) -> None:
        """Hand one token to its request; on completion free the slot and
        its cache pages immediately."""
        req.tokens.append(int(token))
        card.tokens_generated += 1
        self.window.generated(1)
        if len(req.tokens) >= req.max_tokens:
            latency = now - req.arrived
            self.window.record(latency)
            if len(card.latencies) < RUN_LATENCY_CAP:
                card.latencies.append(latency)
            card.completed += 1
            card.requests[slot] = None
            card.engine.release(slot)
            req.finish()

    def _decode_step(self) -> None:
        """One pod step: every card that holds a request steps in turn,
        then each card's tokens go to its requests. A failed step counts
        on its card; ``MAX_CONSECUTIVE_FAILURES`` in a row on any card
        raise. The flight recorder's step began at the top of the loop
        iteration (:meth:`run`): a paged engine's step laps ``DISPATCH``
        before its token read (:meth:`_lap_dispatch`), this laps
        ``COMPUTE`` after it, then ``HOST``."""
        rec = self.recorder
        stepped = []
        for card in self.cards:
            if not card.busy():
                continue
            active = np.array([r is not None for r in card.requests], bool)
            card.steps += 1
            try:
                with fa.launch_scope(card.index):
                    next_tokens = card.engine.step(card.model, active)
            except Exception:  # noqa: BLE001 — a failed step must be visible
                card.failed_steps += 1
                card.consecutive_failures += 1
                log.exception("serve: decode step failed on card %d",
                              card.index)
                if card.consecutive_failures >= MAX_CONSECUTIVE_FAILURES:
                    if rec is not None:
                        rec.abandon()
                    raise RuntimeError(
                        f"serve: {card.consecutive_failures} consecutive "
                        f"decode failures on card {card.index}; giving up")
                continue
            if rec is not None:
                rec.lap(steptrace_mod.COMPUTE)
            card.consecutive_failures = 0
            stepped.append((card, active, next_tokens))
        if not stepped:
            if rec is not None:
                rec.abandon()
            return
        now = self._clock()
        for card, active, next_tokens in stepped:
            for slot in range(len(card.requests)):
                req = card.requests[slot]
                if req is None or not active[slot]:
                    continue
                self._deliver(card, slot, req, int(next_tokens[slot]), now)
        if rec is not None:
            rec.lap(steptrace_mod.HOST)
            rec.commit()

    def _restore_weights(self) -> int:
        """Load the newest verified checkpoint's params into card 0's
        replica and return its step (0 = the seeded init: no directory, or
        nothing in it). A fresh reader Checkpointer per load walks,
        verifies and quarantines as the trainer's restore does, and reads
        only the params file."""
        directory = self._checkpoint_dir()
        if not directory:
            return 0
        ck = checkpoint_mod.Checkpointer(directory, save_every=1)
        try:
            _state, step = ck.restore(checkpoint_mod.TrainState(
                dict(self.model.named_parameters())))
        finally:
            ck.close()
        return int(step)

    def _warmup(self) -> None:
        """Run each card's engine paths once before readiness, in turn. A
        failure counts like a failed decode step on that
        card (the replica does not go ready)."""
        for card in self.cards:
            try:
                with fa.launch_scope(card.index):
                    card.engine.warmup(card.model)
            except Exception:  # noqa: BLE001 — a failed warm-up must be visible
                card.failed_steps += 1
                card.consecutive_failures += 1
                log.exception("serve: engine warm-up failed on card %d",
                              card.index)
                continue
            card.consecutive_failures = 0

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
        returns a summary. Raises when a card gave up."""
        schedule = LoadSchedule.parse(self.args.load)
        gen = LoadGenerator(schedule)
        step = self._restore_weights()
        if step:
            self._sync_replicas()
        self._set_loaded_step(step)
        self._warmup()
        self.steps += 1
        self._set_ready(not self._failing())
        if self.store is not None:
            self._watcher = threading.Thread(target=self._watch_store,
                                             daemon=True,
                                             name="serve-reload-watch")
            self._watcher.start()
        self._start_http()
        rec = self.recorder
        t0 = self._clock()
        try:
            while not self._stop.is_set():
                now = self._clock()
                if duration is not None and now - t0 >= duration:
                    break
                # The iteration's admission and prefills are the step's
                # DATA; an iteration with no decode step is abandoned.
                if rec is not None:
                    rec.begin(self.steps)
                steptrace_mod.follow_profiler()
                arrivals = gen.due(now)
                if (arrivals is None and self.queue_depth() == 0
                        and not self._busy()):
                    break  # schedule over, queue + in-flight drained
                for _ in range(arrivals or 0):
                    self._synthetic_request(now)
                self._shed_expired(now)
                self._admit_from_queue()
                self._maybe_reload()
                if self._busy():
                    if rec is not None:
                        rec.lap(steptrace_mod.DATA)
                    self._decode_step()
                    self.steps += 1
                    if not self.ready and not self._failing():
                        self._set_ready(True)
                else:
                    if rec is not None:
                        rec.abandon()
                    time.sleep(IDLE_SLEEP)
                self._post_beat()
        finally:
            if rec is not None:
                rec.abandon()
            self._stop.set()
            self._set_ready(False)
            with self._ingress_lock:
                leftover, self._queue[:] = list(self._queue), []
                self._shed += len(leftover)
            for req in leftover:
                req.shed_now()
            for card in self.cards:
                for req in card.requests:
                    if req is not None and not req.done.is_set():
                        req.shed_now()
            if self._http is not None:
                self._http.shutdown()
                self._http.server_close()
            if self._watcher is not None:
                self._watcher.join(timeout=2.0)
        elapsed = max(1e-9, self._clock() - t0)
        tokens = self.tokens_generated
        summary: Dict[str, Any] = {
            "steps": self.steps,
            "completed": self.completed,
            "arrivals": gen.total_arrivals,
            "failedSteps": self.failed_steps,
            "reloads": self.reloads,
            "reloadGapSeconds": list(self.reload_gaps),
            "loadedStep": self.loaded_step,
            "shed": self.shed,
            "tokensGenerated": tokens,
            "elapsedSeconds": elapsed,
            "tokensPerSecond": tokens / elapsed,
            "kvCacheUtilization": self.utilization(),
            "cards": [c.summary() for c in self.cards],
        }
        lat = sorted(x for c in self.cards for x in c.latencies)
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
    """Serve on the pod's cards (:func:`pod_devices` of ``--device`` and
    ``TPUJOB_POD_CARDS``); logs the summary, each card's counts and its
    kernel launches, and the process's launches."""
    args = args or parse_args([])
    loop = ServeLoop(args, info,
                     devices=pod_devices(args.device, info.pod_cards))
    summary = loop.run()
    log.info("serve: %d steps, %d/%d requests completed (%d shed), "
             "%.0f tokens/sec, %d reloads, %d failed steps, weights of "
             "step %d", summary["steps"], summary["completed"],
             summary["arrivals"], summary["shed"],
             summary["tokensPerSecond"], summary["reloads"],
             summary["failedSteps"], summary["loadedStep"])
    for card in summary["cards"]:
        log.info("serve card %d: %s", card["card"], json.dumps(
            {**card, "launches": fa.launch_counts(scope=card["card"])}))
    log.info("kernel launches: %s", json.dumps(fa.launch_counts()))
    return summary


def main() -> None:
    """Serve replicas are independent servers (one process drives a
    pod's cards): no process group is formed, and the run_payload
    wrapper owns the exit-code contract (SIGTERM -> 143)."""
    args = parse_args()
    bootstrap.main_wrapper(lambda info: run(info, args))


if __name__ == "__main__":
    main()
