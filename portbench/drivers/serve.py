"""The serving driver: the program's ``ServeLoop`` (continuous batching
over ``kvcache.DecodeEngine``'s paged cache) on one card, under open-loop
arrivals from ``arrivals.py``.

Set-up builds the loop at the mix's slots and window, loads the
benchmark's weights (bfloat16, as served) into its replica, and runs the
loop on a thread of its own; the loop warms its two paths (one prefill at
the padded window, one decode step over every slot) before it turns
ready. The window opens once it is ready: a harness thread submits each
request with ``now`` = its due time, so a request's latency runs from its
due time to its last token. The window closes ``--seconds`` later; the
requests due in it then get up to ``drain_s`` to finish, and one that is
shed, fails or is not done by then counts as failed and as missing from
every latency (infinite in ``serve_p50_s`` and ``serve_p95_s``, the
median and the 95th percentile of the waits, which the driver gives in its
line's ``counters`` and ``sweep.py`` reads; the manifest bounds neither).

Once the loop has stopped and the peak memory has been read, the program
is freed and the reference runs its full forward pass, in float32, over a
sample of the finished requests drawn from the seed, the one with the
longest output among them: the widest gap by which a served token's logit
lies below the reference's best at its position is compared.

With ``--trace 1`` the engine's ``admit`` and ``step`` calls are timed
(spans), and from ``profile_at`` x the window the loop thread runs the
profiler's device window for ``profile_s`` seconds and then its host
window over ``profile_steps`` decode steps (``profiling.py``), with
``flash_attention.flash_decode`` in a ``record_function`` range of its
own.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import arrivals, harness, profiling, weights
from portbench.reference import compare
from portbench.reference import model as ref_model

OPS = ("engine.admit", "engine.step", "flash_decode")


def program_args(cfg: Dict, traffic: Dict, seed: int, device: str):
    from tpu_operator_torch.payload import serve

    if cfg["intermediate_size"] != 4 * cfg["hidden_size"]:
        raise ValueError("the program's MLP is 4 x hidden wide")
    if traffic["window"] + traffic["decode_tokens"] \
            != cfg["max_position_embeddings"]:
        raise ValueError("the program's position table spans window + "
                         "decode tokens")
    return serve.parse_args([
        "--batch", str(traffic["slots"]), "--window", str(traffic["window"]),
        "--decode-tokens", str(traffic["decode_tokens"]),
        "--page-size", str(traffic["page_size"]), "--load", "0:0",
        "--vocab", str(cfg["vocab_size"]), "--dim", str(cfg["hidden_size"]),
        "--heads", str(cfg["num_attention_heads"]),
        "--kv-heads", str(cfg["num_key_value_heads"]),
        "--layers", str(cfg["num_hidden_layers"]),
        "--max-queue", str(traffic["max_queue"]),
        "--seed", str(seed % 2 ** 31), "--device", device])


class Spans:
    """The engine's calls, timed on the loop thread: admits (due time,
    start, end, prompt length), steps (start, end, active slots, keys the
    active slots attend), and each row's attended length in every step of
    the host window. The harness's thread runs the profiler's device window
    (:meth:`device_window`); then the loop thread runs its host window
    from its first step call after ``host_from`` over ``host_steps``
    decode steps (``windows``: device, host)."""

    def __init__(self, clock, due_of: Dict[int, float],
                 windows: List[profiling.Window]):
        self.clock = clock
        self.due_of = due_of
        self.admits: List[tuple] = []
        self.steps: List[tuple] = []
        self.traced_lengths: List[np.ndarray] = []
        self.windows = windows
        self.host_from = float("inf")
        self.trace_s = 0.0
        self.host_steps = 0

    def device_window(self, now: float, trace_from: float) -> None:
        """On the harness's thread: start the device window once
        ``trace_from`` has come, stop it ``trace_s`` later, and hand over
        to the loop thread's host window."""
        device = self.windows[0] if self.windows else None
        if device is None or device.done:
            return
        if device.prof is None and now >= trace_from:
            device.start()
        elif device.running and now >= trace_from + self.trace_s:
            device.stop()
            self.host_from = self.clock()

    def _turn(self) -> None:
        """On the loop thread: start or stop the host window."""
        host = self.windows[1]
        if host.prof is None and self.clock() >= self.host_from:
            host.start()
        elif host.running and len(self.traced_lengths) >= self.host_steps:
            host.stop()

    def wrap(self, engine) -> None:
        admit, step = engine.admit, engine.step
        cache = engine.cache

        def timed_admit(slot, prompt, new_tokens, params):
            t0 = self.clock()
            with torch.profiler.record_function("engine.admit"):
                out = admit(slot, prompt, new_tokens, params)
            if out[0]:
                self.admits.append((self.due_of[id(prompt)], t0,
                                    self.clock(), len(prompt)))
            return out

        def timed_step(params, active):
            if self.windows:
                self._turn()
            lengths = cache._lengths.copy()
            act = np.asarray(active, bool)
            t0 = self.clock()
            with torch.profiler.record_function("engine.step"):
                out = step(params, active)
            self.steps.append((t0, self.clock(), int(act.sum()),
                               int((lengths[act] + 1).sum())))
            if self.windows[1].running:
                self.traced_lengths.append(lengths + 1)
            return out

        engine.admit, engine.step = timed_admit, timed_step


def reference_gaps(cfg: Dict, seed: int, device, served: List,
                   quant=None) -> float:
    """The widest gap over ``served`` [(prompt, tokens)]: of the served
    tokens, or with ``quant`` of the tokens that the control puts first,
    below the float32 reference's best."""
    ref_model.set_exact_float32()
    params = {n: p.float() for n, p in weights.make(
        cfg, seed, device, dtype=torch.bfloat16).items()}
    widest = 0.0
    with torch.no_grad():
        for prompt, tokens in served:
            seq = np.concatenate([np.asarray(prompt, np.int64),
                                  np.asarray(tokens[:-1], np.int64)])
            ids = torch.from_numpy(seq).to(device)[None]
            at = slice(len(prompt) - 1, len(seq))
            logits = ref_model.forward(params, cfg, ids)[0, at]
            if quant is None:
                picked = torch.tensor(tokens, device=device)
            else:
                picked = ref_model.forward(params, cfg, ids, quant)[0, at] \
                    .argmax(dim=-1)
            widest = max(widest, compare.served_gap(logits, picked))
    return widest


def sample(done: List, traffic: Dict, seed: int) -> List:
    """The checked requests: the longest output, and others drawn from
    the seed."""
    if not done:
        return []
    order = sorted(range(len(done)), key=lambda i: (
        -len(done[i].tokens), -len(done[i].prompt)))
    rest = order[1:]
    rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), 2])
    pick = rng.choice(len(rest), min(len(rest),
                                     traffic["check_requests"] - 1),
                      replace=False) if rest else []
    return [done[order[0]]] + [done[rest[i]] for i in sorted(pick)]


def run(cell: harness.Cell) -> harness.Run:
    from tpu_operator_torch.payload import bootstrap, serve
    from tpu_operator_torch.payload import flash_attention as fa

    cfg, traffic = cell.config, cell.traffic
    args = program_args(cfg, traffic, cell.seed, cell.device)
    clock = time.monotonic
    info = bootstrap.ProcessInfo("", 0, 1, 0, ())
    loop = serve.ServeLoop(args, info, heartbeat=None, store=None,
                           clock=clock, device=cell.device)
    dev = loop.device
    cuda = dev.type == "cuda"
    weights.load_into(loop.model, weights.make(cfg, cell.seed, dev,
                                               dtype=torch.bfloat16))
    reqs = arrivals.requests(traffic, cell.seed, cell.seconds,
                             cfg["vocab_size"])
    windows = [profiling.Window(cuda, host=False),
               profiling.Window(cuda, host=True)] if cell.trace else []
    spans = Spans(clock, {id(r.prompt): 0.0 for r in reqs}, windows)
    real_decode = fa.flash_decode
    if cell.trace:
        for card in loop.cards:
            spans.wrap(card.engine)

        def traced_decode(*a, **k):
            with torch.profiler.record_function("flash_decode"):
                return real_decode(*a, **k)

        fa.flash_decode = traced_decode
    failure: List[BaseException] = []

    def serve_thread():
        try:
            loop.run()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            failure.append(e)

    thread = threading.Thread(target=serve_thread, name="serve-loop")
    thread.start()
    try:
        while not loop.ready:
            if not thread.is_alive():
                raise RuntimeError("the serve loop ended before it was "
                                   "ready") from (failure or [None])[0]
            time.sleep(0.001)
        fa.reset_launch_counts()
        t_start = clock()
        wall_offset = time.time() - clock()
        setup_s = time.perf_counter() - cell.clock_start
        for r in reqs:
            spans.due_of[id(r.prompt)] = t_start + r.due_s
        trace_from = t_start + traffic["profile_at"] * cell.seconds
        spans.trace_s = traffic["profile_s"]
        spans.host_steps = traffic["profile_steps"]
        submitted = []
        late = 0.0
        for r in reqs:
            due = t_start + r.due_s
            spans.device_window(clock(), trace_from)
            wait = due - clock()
            if wait > 0:
                time.sleep(wait)
            late = max(late, clock() - due)
            submitted.append(loop.submit(r.prompt, r.max_tokens, now=due))
        t_close = t_start + cell.seconds
        while clock() < t_close:
            spans.device_window(clock(), trace_from)
            time.sleep(min(0.01, max(0.0, t_close - clock())))
        tokens = loop.tokens_generated
        t_close = clock()
        for req in submitted:
            if req is not None:
                req.done.wait(max(0.0, t_close + traffic["drain_s"]
                                  - clock()))
    finally:
        loop.stop()
        thread.join()
        fa.flash_decode = real_decode
    if failure:
        raise failure[0]
    for w in windows:
        if w.running:
            w.stop()
    launches = fa.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    trace = profiling.combine(
        profiling.reduce(windows[0]),
        profiling.reduce(windows[1], OPS) if windows[1].done else None) \
        if windows and windows[0].done else None
    done = [r for r in submitted
            if r is not None and r.done.is_set() and not r.shed
            and len(r.tokens) == r.max_tokens]
    missing = len(reqs) - len(done)
    latencies = sorted(x for card in loop.cards for x in card.latencies)
    latencies += [float("inf")] * missing
    p50, p95 = (latencies[int(np.ceil(q * len(latencies))) - 1]
                for q in (0.5, 0.95))
    # The spans' metrics read the calls that ended before the profiler
    # began, and the card's idle share those inside its device window.
    steady = windows[0].t0 - wall_offset if windows and windows[0].prof \
        else float("inf")
    traced = [(a + wall_offset, b + wall_offset) for a, b in
              [x[1:3] for x in spans.admits] + [x[:2] for x in spans.steps]
              if a >= steady]
    checked = [(r.prompt, list(r.tokens))
               for r in sample(done, traffic, cell.seed)]
    kind = torch.cuda.get_device_name(dev) if cuda else dev.type
    loop = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    gap = reference_gaps(cfg, cell.seed, dev, checked)
    return harness.Run(
        attempted=len(reqs), failed=missing,
        end_to_end={"serve_tokens_per_s": tokens / (t_close - t_start),
                    "serve_p50_s": p50, "serve_p95_s": p95,
                    "setup_s": setup_s},
        checks={"logit_gap": gap, "unanswered": float(missing)},
        memory_peak_bytes=peak, device_kind=kind, device_count=1,
        data={"admits": [a for a in spans.admits if a[2] <= steady],
              "steps": [s for s in spans.steps if s[1] <= steady],
              "traced_spans": traced, "config": cfg,
              "traced_lengths": spans.traced_lengths, "checked": checked},
        trace=trace,
        counters={"launches": launches,
                  "trace": trace["counts"] if trace else {},
                  "checked_tokens": sum(len(t) for _, t in checked),
                  "generator_late_s": late,
                  "latency_s": {k: v if np.isfinite(v) else None
                                for k, v in (("p50", p50), ("p95", p95),
                                             ("mean", np.mean(latencies)))},
                  **occupancy(spans.steps)})


def occupancy(steps: List[tuple]) -> Dict[str, float]:
    """Of the traced run's decode steps: the mean count of busy slots and
    of the keys they attend (the cache's filled span)."""
    if not steps:
        return {}
    return {"busy_slots_mean": float(np.mean([s[2] for s in steps])),
            "kv_tokens_mean": float(np.mean([s[3] for s in steps]))}