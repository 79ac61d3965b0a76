"""The training step and loop of the PyTorch payload (counterpart of the
part of ``tpu_operator/payload/train.py`` that one process per card uses).

- :func:`next_token_nll` / :func:`next_token_nll_masked`: the reference's
  loss, the logsumexp over an f32 cast of the bf16 logits minus the target
  logit gathered from the bf16 logits; :func:`chunked_next_token_nll`
  (``--loss-chunk``) computes it with the ``lm_head`` product chunk by
  chunk over T, each chunk recomputed in the backward, so the
  [B, T, vocab] logits never exist whole. :func:`cross_entropy` and
  :func:`fused_cross_entropy` are the classifier's.
- :func:`make_classifier_train_step` / :func:`make_regression_train_step`:
  the classifier (loss and accuracy; BatchNorm statistics folded in after
  the update; ``--remat-policy`` other than ``full`` checkpoints the
  forward) and the linear regression (MSE).
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
  same step with the same code; one process does no collective. With a
  checkpointer (``checkpoint.py``) it restores the newest verified step
  first and fast-forwards the host batches past it, saves on the
  interval, at a drain boundary and at the end, and exits 143 when the
  final step is not durable.

The fence: each step's metrics are copied to pinned host memory behind
the step's work, and a CUDA event is recorded after the copy. After
dispatching step i the loop waits on step i-1's event, never on step i,
so the host queues step i+1 while the card still runs step i. Logs and
heartbeats read the fenced step's host copy: a read of the step just
dispatched (``.item()``) would stall the host for a whole step.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

import torch.nn.functional as F
from torch.utils import checkpoint as checkpoint_mod

from tpu_operator_torch.payload import bootstrap as bootstrap_mod
from tpu_operator_torch.payload import data as data_mod
from tpu_operator_torch.payload import heartbeat as heartbeat_mod
from tpu_operator_torch.payload import models as models_mod
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


def _chunk_nll_sum(xc: torch.Tensor, w_head: torch.Tensor,
                   tc: torch.Tensor, mc: torch.Tensor) -> torch.Tensor:
    # The cast sits inside the chunk: its backward hands the f32 head
    # weight one gradient per chunk, summed in f32 (a cast hoisted out
    # would sum them in bf16; the reference measured 3.3x the error).
    logits = F.linear(xc, w_head.to(xc.dtype))
    lse = torch.logsumexp(logits.float(), dim=-1)
    tgt = logits.gather(-1, tc.long()[..., None])[..., 0].float()
    return ((lse - tgt) * mc).sum()


def chunked_next_token_nll_masked(hidden: torch.Tensor, w_head: torch.Tensor,
                                  targets: torch.Tensor, mask: torch.Tensor,
                                  chunk: int) -> torch.Tensor:
    """:func:`next_token_nll_masked` without the [B, T, vocab] logits:
    ``hidden`` [B, T, d] (bf16) times the head weight ``w_head``
    [vocab, d] (``lm_head.weight``, cast to hidden's dtype inside each
    chunk) and the loss, chunk by chunk over T, each chunk under
    ``torch.utils.checkpoint`` so the backward recomputes its logits. The
    per-chunk sums add in f32; equal to the unchunked loss to f32
    summation order."""
    b, t, _d = hidden.shape
    if chunk <= 0 or t % chunk != 0:
        raise ValueError(
            f"loss chunk {chunk} must be positive and divide T={t}")
    mask = torch.broadcast_to(mask.float(), (b, t))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for xc, tc, mc in zip(hidden.split(chunk, dim=1),
                          targets.split(chunk, dim=1),
                          mask.split(chunk, dim=1)):
        total = total + checkpoint_mod.checkpoint(
            _chunk_nll_sum, xc, w_head, tc, mc, use_reentrant=False,
            preserve_rng_state=False)
    return total / torch.clamp(mask.sum(), min=1.0)


def chunked_next_token_nll(hidden: torch.Tensor, w_head: torch.Tensor,
                           tokens: torch.Tensor, chunk: int) -> torch.Tensor:
    """The chunked :func:`next_token_nll`: position i's target is token
    i + 1, the last position masked out."""
    b, t = tokens.shape
    targets = torch.cat([tokens[:, 1:], tokens.new_zeros(b, 1)], dim=1)
    mask = torch.arange(t, device=tokens.device) < t - 1
    return chunked_next_token_nll_masked(hidden, w_head, targets, mask,
                                         chunk)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy from an f32 log-softmax (the reference's)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def fused_cross_entropy(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """:func:`cross_entropy` as logsumexp minus the target logit, in f32:
    no [B, classes] log-prob tensor; equal to summation order."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(1, labels.long()[:, None])[:, 0]
    return (lse - tgt).mean()


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


def make_classifier_train_step(model, optimizer, opt_state,
                               remat_policy: str = "full",
                               fused_loss: bool = False,
                               reduce: Optional[Callable[
                                   [Sequence[torch.Tensor], Metrics],
                                   Metrics]] = None
                               ) -> Callable[[torch.Tensor, torch.Tensor],
                                             Metrics]:
    """``step(images, labels) -> {"loss", "accuracy"}`` for a model whose
    ``forward(images, train=True)`` returns (logits, new running
    statistics) (``models.CifarResNet``): the loss (:func:`cross_entropy`,
    or :func:`fused_cross_entropy` with ``fused_loss``) backpropagated
    into the params' ``.grad``, ``reduce(params, metrics)`` when given
    (the multi-process all-reduce), the optimizer update, then the new
    statistics copied into the model's buffers. The statistics come out
    of the forward as values, so with ``remat_policy`` other than
    ``full`` (the forward under ``torch.utils.checkpoint`` with that
    policy, the reference's step-level remat) the recompute cannot apply
    them twice."""
    params = [p for p in model.parameters() if p.requires_grad]
    loss_of = fused_cross_entropy if fused_loss else cross_entropy
    models_mod.remat_policy(remat_policy)  # validates the mode

    def forward(images):
        return model(images, train=True)

    def step(images: torch.Tensor, labels: torch.Tensor) -> Metrics:
        for p in params:
            p.grad = None
        if remat_policy != "full":
            logits, stats = models_mod.checkpointed(forward, remat_policy,
                                                    images)
        else:
            logits, stats = forward(images)
        loss = loss_of(logits, labels)
        loss.backward()
        with torch.no_grad():
            accuracy = (logits.argmax(dim=1) == labels).float().mean()
        metrics = {"loss": loss.detach(), "accuracy": accuracy}
        if reduce is not None:
            metrics = reduce(params, metrics)
        optimizer.step(params, opt_state)
        model.load_batch_stats(stats)
        return metrics

    return step


def make_regression_train_step(model, optimizer, opt_state,
                               reduce: Optional[Callable[
                                   [Sequence[torch.Tensor], Metrics],
                                   Metrics]] = None
                               ) -> Callable[[torch.Tensor, torch.Tensor],
                                             Metrics]:
    """``step(x, y) -> {"loss"}``: the mean squared error of ``model(x)``
    against ``y``, one optimizer update (``reduce`` as in
    :func:`make_classifier_train_step`)."""
    params = [p for p in model.parameters() if p.requires_grad]

    def step(x: torch.Tensor, y: torch.Tensor) -> Metrics:
        for p in params:
            p.grad = None
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        metrics = {"loss": loss.detach()}
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


def _dump_steptrace(recorder: Optional[steptrace_mod.StepRecorder],
                    checkpointer) -> None:
    """Retryable-exit postmortem: dump the flight recorder's ring buffer
    next to the checkpoint dir. Best-effort on every branch."""
    if recorder is None:
        return
    recorder.abandon()
    ckpt_dir = getattr(checkpointer, "directory", "") \
        or os.environ.get("TPU_CHECKPOINT_DIR", "")
    steptrace_mod.postmortem_dump(recorder, ckpt_dir)


def train_loop(train_step: Callable[..., Metrics], batches, steps: int, *,
               device, log_every: int = 0,
               log_fn: Optional[Callable[[int, dict], None]] = None,
               prefetch: int = 2, heartbeat="auto",
               steptrace="auto", checkpointer=None,
               state=None) -> Dict[str, float]:
    """Drive ``train_step(*device_batch)`` up to ``steps`` total steps;
    returns the last step's metrics as host floats.

    ``heartbeat`` posts step telemetry (``"auto"``: from the operator's env
    contract, a no-op unless TPUJOB_STATUS_URL is set; or a reporter, or
    None). ``steptrace`` is the flight recorder (``"auto"``: on unless
    TPUJOB_STEPTRACE_ENABLED=0; or a StepRecorder, or None); its digests
    ride due heartbeats. SIGTERM inside the loop (via
    ``bootstrap.run_payload``) and a drain directive from a heartbeat ACK
    end the loop at the next step boundary with SystemExit 143 / 160.

    With a ``checkpointer`` (``checkpoint.Checkpointer``, owned and closed
    by the caller) and the ``state`` that ``train_step`` updates in place
    (``checkpoint.TrainState``), the loop first restores the newest
    verified step into ``state`` and skips as many host batches, so a
    restarted attempt runs steps ``start..steps-1`` on the batches it
    would have seen unbroken. It saves on the checkpointer's interval, at
    a drain boundary past the first step, and at the end; a final step
    that is not durable exits 143 after dumping the flight recorder next
    to the checkpoint dir."""
    if checkpointer is not None and state is None:
        raise ValueError("train_loop: a checkpointer needs the state it "
                         "saves and restores")
    if heartbeat == "auto":
        heartbeat = heartbeat_mod.from_env()
    recorder = steptrace_mod.from_env() if steptrace == "auto" else steptrace
    start = 0
    batches = iter(batches)
    if checkpointer is not None:
        state, start = checkpointer.restore(state)
        for _ in range(start):
            next(batches)
    # Prefetch wraps the stream only after the fast-forward above.
    dev_batches: Iterator = data_mod.device_prefetch(batches, device,
                                                     depth=prefetch)
    fence: Optional[_Fenced] = None
    ready: Optional[_Fenced] = None
    metrics: Metrics = {}
    bootstrap_mod.enter_step_loop()  # SIGTERM now defers to a step boundary
    try:
        for i in range(start, steps):
            if recorder is not None:
                recorder.begin(i)
            code = agreed_drain_code()
            if code:
                # Persist the i completed steps, then exit: the restarted
                # attempt resumes here. Every process of a gang reaches
                # this at the same i and saves collectively. A failed save
                # still exits with the drain code: the restart resumes
                # from the last verified step.
                if checkpointer is not None and i > start:
                    try:
                        checkpointer.save(i, state)
                        log.info("drain: checkpointed step %d, exiting %d",
                                 i, code)
                    except Exception:  # noqa: BLE001 — drain code regardless
                        log.exception(
                            "drain: checkpoint save of step %d failed; "
                            "exiting %d anyway (resume falls back to the "
                            "last verified step)", i, code)
                else:
                    log.info("drain: exiting %d at step %d", code, i)
                raise SystemExit(code)
            batch_args = next(dev_batches)
            if recorder is not None:
                recorder.lap(steptrace_mod.DATA)
            if heartbeat is not None and i == start \
                    and heartbeat.tokens_per_batch == 0:
                heartbeat.tokens_per_batch = _infer_tokens_per_batch(
                    batch_args)
            metrics = train_step(*batch_args)
            current = _Fenced(metrics)
            if recorder is not None:
                recorder.lap(steptrace_mod.DISPATCH)
            if i == start:
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
            if checkpointer is not None:
                # The host copy is queued behind this step's update on the
                # stream: no fence on the step just dispatched.
                checkpointer.maybe_save(i + 1, state)
                if recorder is not None:
                    recorder.lap(steptrace_mod.CHECKPOINT)
            if log_every and log_fn and (i + 1) % log_every == 0:
                log_fn(i + 1, ready.values())
            if heartbeat is not None and heartbeat.due(i + 1):
                cadence = getattr(heartbeat, "cadence_only", False)
                heartbeat.report(
                    i + 1, None if cadence else ready.values(),
                    steptiming=(recorder.summary()
                                if recorder is not None else None),
                    checkpoint=(checkpointer.stats()
                                if checkpointer is not None and not cadence
                                else None))
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
    except SystemExit as e:
        # A retryable or planned exit is when a postmortem wants the last
        # steps' phase timings.
        if getattr(e, "code", None) in (bootstrap_mod.EXIT_RETRYABLE,
                                        bootstrap_mod.EXIT_PLANNED):
            _dump_steptrace(recorder, checkpointer)
        elif recorder is not None:
            recorder.abandon()
        raise
    finally:
        bootstrap_mod.exit_step_loop()
        dev_batches.close()
    if checkpointer is not None and steps > start:
        # The final save is load-bearing: a run must not end with its end
        # state unpersisted. If it is still not durable after the flush,
        # exit retryable so the restart re-earns a durable finish.
        checkpointer.save(steps, state)
        checkpointer.flush()
        if checkpointer.last_verified_step() != steps:
            log.error(
                "final checkpoint of step %d is not durable (last verified "
                "step: %s); exiting retryable so the restart re-earns it",
                steps, checkpointer.last_verified_step())
            _dump_steptrace(recorder, checkpointer)
            raise SystemExit(bootstrap_mod.EXIT_RETRYABLE)
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
