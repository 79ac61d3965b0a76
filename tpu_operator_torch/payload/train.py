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
- :func:`fsdp_dims`: the reference's ``fsdp_shardings`` rule, which of
  the transformer's params ``--fsdp`` splits over the data ranks and
  along which dim.
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
  final step is not durable. The reference's warm-restart and operator
  runtime ride along: the overlapped prologue (COMPILE, the kernel
  library's build or load, on a worker thread beside RESTORE), the
  startup breakdown and its liveness beats (``startup.py``), the
  data-plane runtime (``autotune.py``), the ``--profile-dir`` window and
  the on-demand profile capture (``profile.py``).

The fence: each step's metrics are copied to pinned host memory behind
the step's work, and a CUDA event is recorded after the copy. After
dispatching step i the loop waits on step i-1's event, never on step i,
so the host queues step i+1 while the card still runs step i. Logs and
heartbeats read the fenced step's host copy: a read of the step just
dispatched (``.item()``) would stall the host for a whole step.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import math
import os
import threading
import time
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import torch
import torch.distributed as dist

import torch.nn.functional as F
from torch.utils import checkpoint as checkpoint_mod

from tpu_operator_torch.payload import autotune as autotune_mod
from tpu_operator_torch.payload import bootstrap as bootstrap_mod
from tpu_operator_torch.payload import data as data_mod
from tpu_operator_torch.payload import heartbeat as heartbeat_mod
from tpu_operator_torch.payload import models as models_mod
from tpu_operator_torch.payload import optimizers as optimizers_mod
from tpu_operator_torch.payload import profile as profile_mod
from tpu_operator_torch.payload import startup as startup_mod
from tpu_operator_torch.payload import steptrace as steptrace_mod
from tpu_operator_torch.payload import weights as weights_mod

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
    # Under --fsdp the gather sits there too: recomputed with the chunk.
    logits = F.linear(xc, models_mod.gathered(w_head, xc.dtype))
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
                     data_size: int, sharded: Sequence[int] = (),
                     shard_group: Any = None, group: Any = None) -> Metrics:
    """Sum the ``.grad`` of ``params`` and the (scalar) ``metrics`` over
    ``group`` (None: the world), then divide by ``data_size``: one flat f32
    collective. Each process's loss is its sequence shard's share of its
    data rank's mean, so the sum over a seq group is that rank's gradient
    and the division averages the data ranks. Under tensor parallelism
    ``group`` is the processes holding this one's model shards (the
    transformer's ``LMMesh.replica_group``): the processes of a
    tensor-parallel group compute the same loss, and each holds other
    parts of the split params. Returns the reduced metrics.

    ``sharded`` (positions in ``params``) are parameters each process
    holds a different part of (the MoE payload's expert stacks): their
    gradients sum only over ``shard_group``, the processes that hold the
    same part (None: no other process does), with the same division."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]

    def reduce(idx, tail, group, collective):
        flat = torch.cat([grads[i].reshape(-1).float() for i in idx] + tail)
        if collective:
            dist.all_reduce(flat, group=group)
        flat /= data_size
        offset = 0
        for i in idx:
            n = grads[i].numel()
            params[i].grad = flat[offset:offset + n].view_as(grads[i]).to(
                grads[i].dtype)
            offset += n
        return flat[offset:]

    split = set(sharded)
    keys = sorted(metrics)
    rest = reduce([i for i in range(len(params)) if i not in split],
                  [metrics[k].reshape(1).float() for k in keys], group,
                  group is None or dist.get_world_size(group) > 1)
    if split:
        reduce(sorted(split), [], shard_group,
               shard_group is not None
               and dist.get_world_size(shard_group) > 1)
    return {k: rest[j] for j, k in enumerate(keys)}


# The reference's size floor (train.fsdp_shardings' min_size): smaller
# leaves replicate, where a collective's latency would dominate.
FSDP_MIN_ELEMENTS = 1024


def fsdp_dims(model, data: int, optimizer: str = "adam") -> Dict[str, int]:
    """The reference's ``fsdp_shardings`` rule (``train.py:374``) for the
    transformer's params at ``data`` data ranks: {param name: the dim its
    1/``data`` parts are cut along} for every leaf of at least 1024
    elements whose dim 0 in the reference's tree divides by ``data``
    (``weights.lm_leaf_paths``: a dense kernel is the transposed
    ``Linear`` weight, so its dim 0 is the port's dim 1); every other leaf
    stays whole on every process.

    The cut is the port's dim 0 where ``data`` divides it (a ``Linear``'s
    output rows, an embedding's rows, a 1-D leaf), else the reference's
    own dim (a ``Linear``'s input columns). Rows first: adam8 blocks each
    param along its last dim (``optimizers.BLOCK``), and a row cut never
    splits a block. Under ``optimizer`` ``adam8`` a leaf cut along its
    last dim stays whole unless each part is a whole number of blocks, as
    ``pipeline.zero1_dims`` decides, so every block lies on one process."""
    dims = {}
    for name, (_path, transposed) in weights_mod.lm_leaf_paths(model).items():
        shape = model.get_parameter(name).shape
        dim0 = 1 if transposed else 0
        if math.prod(shape) < FSDP_MIN_ELEMENTS or shape[dim0] % data:
            continue
        dim = 0 if shape[0] % data == 0 else dim0
        if optimizer == "adam8" and dim == len(shape) - 1 \
                and shape[dim] // data % optimizers_mod.BLOCK:
            continue
        dims[name] = dim
    return dims


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
    opt_state)`` in place. The metrics stay on the device.

    Spans (``steptrace.span``, each with its card time on a CUDA device):
    ``train.step`` round the whole step, ``train.forward`` and
    ``train.backward`` round each microbatch's ``loss_fn`` and backward
    (attr ``microbatch``), ``train.reduce`` and ``train.optimizer``."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    params = list(params)
    device = params[0].device if params else None

    def step(batch: torch.Tensor) -> Metrics:
        b = batch.shape[0]
        if b % grad_accum != 0:
            raise ValueError(
                f"batch {b} not divisible by grad_accum={grad_accum}")
        steptrace_mod.follow_profiler()
        with steptrace_mod.span("train.step", device):
            for p in params:
                p.grad = None
            micro_metrics = []
            for j, mb in enumerate(batch.reshape(grad_accum, b // grad_accum,
                                                 *batch.shape[1:])):
                with steptrace_mod.span("train.forward", device,
                                        microbatch=j):
                    loss, metrics = loss_fn(mb)
                with steptrace_mod.span("train.backward", device,
                                        microbatch=j):
                    (loss / grad_accum).backward()
                micro_metrics.append({k: v.detach()
                                      for k, v in metrics.items()})
            metrics = {k: torch.stack([m[k] for m in micro_metrics]).mean()
                       for k in micro_metrics[0]}
            if reduce is not None:
                with steptrace_mod.span("train.reduce", device):
                    metrics = reduce(params, metrics)
            with steptrace_mod.span("train.optimizer", device):
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
    next to the checkpoint dir and, with the warm-start store wired, ship
    it through the write-behind uploader (the caller's
    ``checkpointer.close()`` drains it). Best-effort on every branch."""
    if recorder is None:
        return
    recorder.abandon()
    ckpt_dir = getattr(checkpointer, "directory", "") \
        or os.environ.get("TPU_CHECKPOINT_DIR", "")
    path = steptrace_mod.postmortem_dump(recorder, ckpt_dir)
    uploader = getattr(checkpointer, "uploader", None)
    if path is not None and uploader is not None:
        uploader.enqueue_artifact(path)


def _finish_profile(capture: profile_mod.ProfileCapture,
                    recorder: Optional[steptrace_mod.StepRecorder],
                    checkpointer, heartbeat) -> None:
    """Close a completed on-demand capture: write the artifact, ship it
    through the write-behind ``artifacts/`` path, and attach the result
    to the heartbeat, so the operator folds ``status.profile`` to
    Captured. Best-effort: a profile never takes down the step loop."""
    try:
        path, result = capture.finish(recorder)
    except Exception:  # noqa: BLE001 — capture teardown is observability only
        log.exception("profile %s: finish failed", capture.id)
        return
    uploader = getattr(checkpointer, "uploader", None)
    if path and uploader is not None:
        uploader.enqueue_artifact(path)
        result["artifactKey"] = "artifacts/" + os.path.basename(path)
    heartbeat.attach_profile_result(result)
    log.info("profile %s: captured %d step(s)%s", capture.id,
             result.get("capturedSteps", 0),
             " -> " + result["artifactKey"] if "artifactKey" in result
             else "")


def kernel_loader(device) -> Optional[Callable[[], bool]]:
    """The COMPILE work of a payload that launches the port's kernels:
    on a CUDA device, build or load the kernel library
    (``kernels/build.py``, through the compilation cache when bootstrap
    enabled one) and return whether that was a cache hit (no nvcc ran in
    this process). None on the CPU, where the plain versions need no
    build. A failed build or load raises."""
    if torch.device(device).type != "cuda":
        return None

    def load() -> bool:
        from tpu_operator_torch.kernels import build

        build.library()
        return not build.load_info().get("ranNvcc", True)

    return load


def _compile(tracker: startup_mod.StartupTracker,
             compile_fn: Callable[[], Optional[bool]]) -> None:
    """Run the COMPILE work under its stage and record its cache hit."""
    with tracker.stage(startup_mod.COMPILE):
        hit = compile_fn()
    if hit is not None:
        tracker.cache_hit = bool(hit)


def _overlapped_prologue(batches, checkpointer, state,
                         tracker: startup_mod.StartupTracker,
                         compile_fn: Optional[Callable[[], Optional[bool]]]
                         ) -> Tuple[Any, int, Iterator]:
    """The attempt's prologue with COMPILE (``compile_fn`` on a worker
    thread: the kernel library's build or load) concurrent with RESTORE
    (``checkpointer.restore`` on this thread, its gloo collectives
    included). Returns (state, start, stream).

    The same result as the serial prologue: batch 0 is peeked and
    re-chained in order, so a fresh start trains on it and a resume
    skips it as the serial fast-forward would. The worker touches no
    tensor; it is joined on every exit, failures included, and its
    failure raises here (no fallback: without its kernels the step
    cannot run on the card)."""
    it = iter(batches)
    try:
        first = [next(it)]
    except StopIteration:
        first = []
    failure: List[BaseException] = []

    def compile_worker() -> None:
        try:
            _compile(tracker, compile_fn)
        except BaseException as e:  # noqa: BLE001 — re-raised on the main thread
            failure.append(e)

    worker = None
    if compile_fn is not None:
        worker = threading.Thread(target=compile_worker, daemon=True,
                                  name="kernel-compile")
        worker.start()
    start = 0
    try:
        if checkpointer is not None:
            with tracker.stage(startup_mod.RESTORE):
                state, start = checkpointer.restore(state)
    finally:
        if worker is not None:
            worker.join()
    if failure:
        raise failure[0]
    stream = itertools.chain(first, it)
    for _ in range(start):
        next(stream)
    return state, start, stream


def _startup_heartbeat_ticker(tracker: startup_mod.StartupTracker,
                              heartbeat, stop: threading.Event) -> None:
    """Pre-first-step liveness: until the first step lands there are no
    step beats, so a long kernel build or restore would read as a hang.
    Post the in-flight ``startupStage`` on the heartbeat's cadence."""
    while not stop.wait(max(0.01, heartbeat_mod.interval_of(heartbeat))):
        stage = tracker.current_stage()
        if stage is not None:
            heartbeat.report_startup(stage)


def train_loop(train_step: Callable[..., Metrics], batches, steps: int, *,
               device, log_every: int = 0,
               log_fn: Optional[Callable[[int, dict], None]] = None,
               prefetch: int = 2, heartbeat="auto",
               steptrace="auto", checkpointer=None,
               state=None, startup=None, overlap: bool = True,
               dataplane="auto", profile_dir: str = "",
               profile_range: Tuple[int, int] = (10, 20),
               compile_fn: Optional[Callable[[], Optional[bool]]] = None
               ) -> Dict[str, float]:
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
    to the checkpoint dir.

    Startup: ``startup`` (default a fresh ``startup.StartupTracker``)
    times RESTORE, COMPILE and FIRST_STEP. ``compile_fn`` is the COMPILE
    work (:func:`kernel_loader`: the kernel library); with ``overlap``
    (default) it runs on a worker thread while the restore runs here. The
    breakdown rides the first beat after step 1, and until then the
    in-flight ``startupStage`` posts on the heartbeat's cadence.

    ``dataplane`` is the data-plane runtime (``autotune.py``; ``"auto"``:
    from the operator's env, inert without it; None: the static
    ``prefetch`` depth): the live prefetch depth, the background host
    pipeline, the autotune controller and the async host path; its knobs
    ride the heartbeat as ``dataPlane``.

    Profiling: ``profile_dir`` (``--profile-dir`` / ``TPU_PROFILE_DIR``)
    writes a ``torch.profiler`` trace of steps ``profile_range`` counted
    from this run's first step. A profile directive from a heartbeat ACK
    starts an on-demand ``profile.ProfileCapture`` (one at a time), which
    traces only when the ``profile_dir`` window is neither armed nor
    running: one profiler owner. While either window runs, the step's
    spans are on (``steptrace.follow_profiler``, checked once a step), so
    the trace carries their names; they are off again after it."""
    if checkpointer is not None and state is None:
        raise ValueError("train_loop: a checkpointer needs the state it "
                         "saves and restores")
    device = torch.device(device)
    cuda = device.type == "cuda"
    if heartbeat == "auto":
        heartbeat = heartbeat_mod.from_env()
    recorder = steptrace_mod.from_env() if steptrace == "auto" else steptrace
    if dataplane == "auto":
        runtime = autotune_mod.from_env(prefetch=prefetch)
    elif dataplane is None:
        runtime = autotune_mod.DataPlaneRuntime.static(prefetch)
    else:
        runtime = dataplane
    # A gang's save is a collective: the cadence knob of a multi-process
    # job goes through the checkpointer's gang-agreed mode.
    runtime.attach(recorder=recorder, heartbeat=heartbeat,
                   checkpointer=checkpointer,
                   processes=bootstrap_mod.world_size())
    tracker = startup if startup is not None else startup_mod.new_tracker()
    ticker_stop = threading.Event()
    if heartbeat is not None and not heartbeat.cadence_only:
        threading.Thread(target=_startup_heartbeat_ticker,
                         args=(tracker, heartbeat, ticker_stop),
                         daemon=True, name="startup-heartbeat").start()
    start = 0
    try:
        if overlap:
            state, start, batches = _overlapped_prologue(
                batches, checkpointer, state, tracker, compile_fn)
        else:
            batches = iter(batches)
            if compile_fn is not None:
                _compile(tracker, compile_fn)
            if checkpointer is not None:
                with tracker.stage(startup_mod.RESTORE):
                    state, start = checkpointer.restore(state)
            for _ in range(start):
                next(batches)
    except BaseException:
        ticker_stop.set()
        runtime.close()
        raise
    # Prefetch wraps the stream only after the fast-forward above.
    dev_batches: Iterator = data_mod.device_prefetch(
        batches, device, depth=runtime.depth, control=runtime.control,
        pipeline=runtime.pipeline)
    trace_from = start + profile_range[0]
    trace_to = start + profile_range[1]
    trace_path = os.path.join(
        profile_dir or ".",
        f"trace-p{bootstrap_mod.rank()}-from-step-{trace_from + 1}.json")
    if profile_dir and trace_from >= steps:
        log.warning("profile window [%d, %d) lies beyond the run's last "
                    "step %d; no trace will be captured", trace_from,
                    trace_to, steps)
    window = None  # the --profile-dir window's running profiler
    profiled = False
    capture: Optional[profile_mod.ProfileCapture] = None
    pending_startup: Optional[dict] = None
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
            if profile_dir and window is None and not profiled \
                    and i >= trace_from:
                window = profile_mod.start_profiler(cuda)
            batch_args = next(dev_batches)
            if recorder is not None:
                recorder.lap(steptrace_mod.DATA)
            if heartbeat is not None and i == start \
                    and heartbeat.tokens_per_batch == 0:
                heartbeat.tokens_per_batch = _infer_tokens_per_batch(
                    batch_args)
            # The first step runs to completion (the allocator's first
            # touch, any residual setup): the FIRST_STEP stage, one fence
            # paid once.
            with (tracker.stage(startup_mod.FIRST_STEP) if i == start
                  else contextlib.nullcontext()):
                metrics = train_step(*batch_args)
                current = _Fenced(metrics)
                if recorder is not None:
                    recorder.lap(steptrace_mod.DISPATCH)
                if i == start:
                    current.wait()
                    ready = current
            if i == start:
                ticker_stop.set()
                pending_startup = tracker.breakdown()
            elif fence is not None:
                fence.wait()
                ready = fence
                steptrace_mod.resolve_spans()
            if recorder is not None:
                recorder.lap(steptrace_mod.COMPUTE)
            fence = current
            if window is not None and i + 1 >= trace_to:
                profile_mod.stop_profiler(window, trace_path, cuda)
                window, profiled = None, True
                log.info("profile window: trace of steps %d-%d in %s",
                         trace_from + 1, i + 1, trace_path)
                if recorder is not None:
                    # The stop's synchronize is one-off bookkeeping.
                    recorder.lap(steptrace_mod.HOST)
            if checkpointer is not None:
                # The host copy is queued behind this step's update on the
                # stream: no fence on the step just dispatched.
                checkpointer.maybe_save(i + 1, state)
                if recorder is not None:
                    recorder.lap(steptrace_mod.CHECKPOINT)
            if log_every and log_fn and (i + 1) % log_every == 0:
                runtime.submit_host(log_fn, i + 1, ready.values())
            # The first step's report is forced: it carries the startup
            # breakdown, which then rides due beats until a post succeeds.
            if heartbeat is not None and (heartbeat.due(i + 1)
                                          or (i == start
                                              and pending_startup)):
                cadence = heartbeat.cadence_only
                if heartbeat.report(
                        i + 1, None if cadence else ready.values(),
                        checkpoint=(checkpointer.stats()
                                    if checkpointer is not None
                                    and not cadence else None),
                        startup=pending_startup,
                        steptiming=(recorder.summary()
                                    if recorder is not None else None),
                        dataplane=runtime.wire()):
                    pending_startup = None
            if recorder is not None:
                recorder.lap(steptrace_mod.HOST)
                recorder.commit()
            if heartbeat is not None:
                # After commit, so this step's recorder row is in the ring
                # when a full window merges it.
                directive = heartbeat.take_profile_directive()
                if directive and capture is None:
                    capture = profile_mod.ProfileCapture(
                        directive,
                        base_dir=(getattr(checkpointer, "directory", "")
                                  or os.environ.get("TPU_CHECKPOINT_DIR",
                                                    "")),
                        # The --profile-dir window owns the profiler while
                        # armed or running.
                        allow_trace=(window is None
                                     and (not profile_dir or profiled)),
                        cuda=cuda)
                    capture.start(i + 1)
                if capture is not None and capture.tick(i + 1):
                    _finish_profile(capture, recorder, checkpointer,
                                    heartbeat)
                    capture = None
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
        ticker_stop.set()
        bootstrap_mod.exit_step_loop()
        dev_batches.close()
        runtime.close()
        if capture is not None:
            # An exit mid-capture must not leave the profiler running; the
            # directive is one-shot and the partial window is dropped.
            capture.abandon()
        if window is not None:
            # Close the window's trace on every exit path, so the steps it
            # holds are written.
            try:
                profile_mod.stop_profiler(window, trace_path, cuda)
            except Exception:  # noqa: BLE001 — a broken device; the exit wins
                log.warning("profile window: trace stop failed",
                            exc_info=True)
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
