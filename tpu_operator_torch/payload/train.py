"""The training step and loop of the PyTorch payload (counterpart of the
part of ``tpu_operator/payload/train.py`` that one process per card uses).

- :func:`next_token_nll` / :func:`next_token_nll_masked`: the reference's
  loss, the logsumexp over an f32 cast of the bf16 logits minus the target
  logit gathered from the bf16 logits.
- :func:`make_loss_train_step`: the counterpart of ``make_loss_train_step``
  (``train.py:397``). With ``grad_accum`` K, each of K microbatches runs a
  backward of ``loss / K`` into the f32 ``.grad`` of the params, then one
  optimizer update; the metrics are the microbatch mean. The reference
  sums the K gradients and divides once: the same up to f32 rounding.
  In a multi-process job :func:`all_reduce_grads` then sums the gradients
  over the world and divides by the data-parallel size, as the
  reference's psums over its (data, seq) mesh do.
- :func:`train_loop`: the reference's loop (``train.py:766``) as far as
  one process per card uses it: the DATA / DISPATCH / COMPUTE /
  CHECKPOINT / HOST laps of the flight recorder, the COMPUTE fence one
  step deep, heartbeats with ``loss`` and ``tokensPerSec`` (cadence only
  from processes other than 0), and the drain latch (SIGTERM -> exit 143,
  a drain directive -> exit 160, both at a step boundary). In a
  multi-process job every process takes the world's largest drain code at
  each step boundary (one ``all_reduce(MAX)``), so all of them exit at the
  same step with the same code; one process does no collective.

The fence: each step's metrics are copied to pinned host memory behind
the step's work, and a CUDA event is recorded after the copy. After
dispatching step i the loop waits on step i-1's event, never on step i,
so the host queues step i+1 while the card still runs step i. Logs and
heartbeats read the fenced step's host copy: a read of the step just
dispatched (``.item()``) would stall the host for a whole step.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from tpu_operator_torch.payload import bootstrap as bootstrap_mod
from tpu_operator_torch.payload import data as data_mod
from tpu_operator_torch.payload import heartbeat as heartbeat_mod
from tpu_operator_torch.payload import steptrace as steptrace_mod

log = logging.getLogger(__name__)

Metrics = Dict[str, torch.Tensor]


def next_token_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token negative log-likelihood, f32 reduction."""
    logits = logits[:, :-1]
    targets = tokens[:, 1:].long()
    lse = torch.logsumexp(logits.float(), dim=-1)
    tgt = logits.gather(-1, targets[..., None])[..., 0].float()
    return (lse - tgt).mean()


def next_token_nll_masked(logits: torch.Tensor, targets: torch.Tensor,
                          mask: torch.Tensor,
                          count: Optional[int] = None) -> torch.Tensor:
    """Next-token NLL with explicit per-slot targets and a validity mask
    ([T] or [B, T]), normalised by ``count`` when given (a sequence shard
    divides by the whole sequence's count of valid targets), else by the
    count of valid slots here."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    tgt = logits.gather(-1, targets.long()[..., None])[..., 0].float()
    mask = torch.broadcast_to(mask.float(), lse.shape)
    total = ((lse - tgt) * mask).sum()
    if count is not None:
        return total / max(int(count), 1)
    return total / torch.clamp(mask.sum(), min=1.0)


def all_reduce_grads(params: Sequence[torch.Tensor], metrics: Metrics,
                     data_size: int) -> Metrics:
    """Sum the ``.grad`` of ``params`` and the (scalar) ``metrics`` over the
    world, then divide by ``data_size``: one flat f32 collective. Each
    process's loss is its sequence shard's share of its data rank's mean,
    so the sum over a seq group is that rank's gradient and the division
    averages the data ranks. Returns the reduced metrics."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    keys = sorted(metrics)
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [metrics[k].reshape(1).float() for k in keys])
    dist.all_reduce(flat)
    flat /= data_size
    offset = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[offset:offset + n].view_as(g).to(g.dtype)
        offset += n
    return {k: flat[offset + i] for i, k in enumerate(keys)}


def make_loss_train_step(loss_fn: Callable[[torch.Tensor],
                                           Tuple[torch.Tensor, Metrics]],
                         params: Sequence[torch.Tensor], optimizer,
                         opt_state, grad_accum: int = 1,
                         reduce: Optional[Callable[[Sequence[torch.Tensor],
                                                    Metrics], Metrics]] = None
                         ) -> Callable[[torch.Tensor], Metrics]:
    """``step(batch) -> metrics``: ``loss_fn(microbatch) -> (loss,
    metrics)`` differentiated into ``params``' ``.grad`` over
    ``grad_accum`` sequential microbatches (the leading dim split), then
    ``reduce(params, metrics)`` after the last backward when given (the
    multi-process all-reduce), then one ``optimizer.step(params,
    opt_state)`` in place. The metrics stay on the device."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    params = list(params)

    def step(batch: torch.Tensor) -> Metrics:
        b = batch.shape[0]
        if b % grad_accum != 0:
            raise ValueError(
                f"batch {b} not divisible by grad_accum={grad_accum}")
        for p in params:
            p.grad = None
        micro_metrics = []
        for mb in batch.reshape(grad_accum, b // grad_accum,
                                *batch.shape[1:]):
            loss, metrics = loss_fn(mb)
            (loss / grad_accum).backward()
            micro_metrics.append({k: v.detach() for k, v in metrics.items()})
        metrics = {k: torch.stack([m[k] for m in micro_metrics]).mean()
                   for k in micro_metrics[0]}
        if reduce is not None:
            metrics = reduce(params, metrics)
        optimizer.step(params, opt_state)
        return metrics

    return step


class _Fenced:
    """One step's metrics on their way to the host: on CUDA, copied into
    pinned memory behind the step's work, with an event recorded after
    the copy."""

    def __init__(self, metrics: Metrics):
        self.event = None
        if any(v.is_cuda for v in metrics.values()):
            self.host = {k: torch.empty(v.shape, dtype=v.dtype,
                                        pin_memory=True)
                         for k, v in metrics.items()}
            for k, v in metrics.items():
                self.host[k].copy_(v, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = metrics

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def values(self) -> Dict[str, float]:
        """Host floats; call after :meth:`wait`."""
        return {k: float(v) for k, v in self.host.items()}


def _infer_tokens_per_batch(batch_args: tuple) -> int:
    """B*T when the batch is one [B, T] integer tensor, else 0."""
    if len(batch_args) != 1:
        return 0
    arr = batch_args[0]
    if arr.dim() == 2 and not arr.dtype.is_floating_point:
        return int(arr.shape[0] * arr.shape[1])
    return 0


def agreed_drain_code() -> int:
    """The drain exit code every process takes at this step boundary: the
    world's largest local code (0 = not draining). SIGTERM reaches one pod
    and a drain directive process 0 only, so the processes agree on the
    step; the max also picks EXIT_PLANNED (160) over EXIT_RETRYABLE (143),
    the operator's precedence. One CPU scalar on the host group
    (``bootstrap.host_group``), so the read never waits on the card; one
    process does no collective."""
    code = (bootstrap_mod.drain_exit_code() if bootstrap_mod.draining()
            else 0)
    if bootstrap_mod.world_size() <= 1:
        return code
    agreed = torch.tensor([code], dtype=torch.int32)
    dist.all_reduce(agreed, op=dist.ReduceOp.MAX,
                    group=bootstrap_mod.host_group())
    return int(agreed.item())


def train_loop(train_step: Callable[..., Metrics], batches, steps: int, *,
               device, log_every: int = 0,
               log_fn: Optional[Callable[[int, dict], None]] = None,
               prefetch: int = 2, heartbeat="auto",
               steptrace="auto") -> Dict[str, float]:
    """Drive ``train_step(*device_batch)`` for ``steps`` steps; returns the
    last step's metrics as host floats.

    ``heartbeat`` posts step telemetry (``"auto"``: from the operator's env
    contract, a no-op unless TPUJOB_STATUS_URL is set; or a reporter, or
    None). ``steptrace`` is the flight recorder (``"auto"``: on unless
    TPUJOB_STEPTRACE_ENABLED=0; or a StepRecorder, or None); its digests
    ride due heartbeats. SIGTERM inside the loop (via
    ``bootstrap.run_payload``) and a drain directive from a heartbeat ACK
    end the loop at the next step boundary with SystemExit 143 / 160."""
    if heartbeat == "auto":
        heartbeat = heartbeat_mod.from_env()
    recorder = steptrace_mod.from_env() if steptrace == "auto" else steptrace
    dev_batches: Iterator = data_mod.device_prefetch(batches, device,
                                                     depth=prefetch)
    fence: Optional[_Fenced] = None
    ready: Optional[_Fenced] = None
    metrics: Metrics = {}
    bootstrap_mod.enter_step_loop()  # SIGTERM now defers to a step boundary
    try:
        for i in range(steps):
            if recorder is not None:
                recorder.begin(i)
            code = agreed_drain_code()
            if code:
                log.info("drain: exiting %d at step %d", code, i)
                raise SystemExit(code)
            batch_args = next(dev_batches)
            if recorder is not None:
                recorder.lap(steptrace_mod.DATA)
            if heartbeat is not None and i == 0 \
                    and heartbeat.tokens_per_batch == 0:
                heartbeat.tokens_per_batch = _infer_tokens_per_batch(
                    batch_args)
            metrics = train_step(*batch_args)
            current = _Fenced(metrics)
            if recorder is not None:
                recorder.lap(steptrace_mod.DISPATCH)
            if i == 0:
                # The first step runs to completion (kernel builds, the
                # allocator's first touch): one fence, paid once.
                current.wait()
                ready = current
            elif fence is not None:
                fence.wait()
                ready = fence
            if recorder is not None:
                recorder.lap(steptrace_mod.COMPUTE)
            fence = current
            if log_every and log_fn and (i + 1) % log_every == 0:
                log_fn(i + 1, ready.values())
            if heartbeat is not None and heartbeat.due(i + 1):
                cadence = getattr(heartbeat, "cadence_only", False)
                heartbeat.report(
                    i + 1, None if cadence else ready.values(),
                    steptiming=(recorder.summary()
                                if recorder is not None else None))
            if recorder is not None:
                recorder.lap(steptrace_mod.HOST)
                recorder.commit()
            if heartbeat is not None:
                directive = heartbeat.take_drain_directive()
                if directive and directive.get("id"):
                    log.info("drain directive %s (%s): draining at next "
                             "step boundary", directive.get("id"),
                             directive.get("reason", ""))
                    bootstrap_mod.request_planned_drain()
                    heartbeat.attach_drain_ack({"id": str(directive["id"]),
                                                "step": i + 1})
    except SystemExit:
        if recorder is not None:
            recorder.abandon()
        raise
    finally:
        bootstrap_mod.exit_step_loop()
        dev_batches.close()
    if fence is None:
        return {}
    fence.wait()
    return fence.values()


def throughput(train_step: Callable[..., Metrics], batches, steps: int, *,
               device, warmup: int = 3,
               prefetch: int = 2) -> float:
    """Steps per second over ``steps`` timed steps after ``warmup``, fed
    through the loop's own prefetch path; both ends are fenced on the
    last step's metrics."""
    dev_batches = data_mod.device_prefetch(batches, device,
                                           depth=max(0, prefetch))
    metrics: Metrics = {}
    for _ in range(warmup):
        metrics = train_step(*next(dev_batches))
    if metrics:
        float(metrics["loss"])
    start = time.perf_counter()
    for _ in range(steps):
        metrics = train_step(*next(dev_batches))
    float(metrics["loss"])
    return steps / (time.perf_counter() - start)
