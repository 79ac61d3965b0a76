"""Async write-behind uploader: remote persistence OFF the step loop.

The checkpoint durability contract keeps verification off the step path (a
background verify thread, reaped at save boundaries); this applies the
same shape to remote uploads. The step loop's only interaction is
:meth:`enqueue` — a lock-guarded dict update that never touches the
backend — while a single daemon worker drains the queue:

- **Last-wins coalescing.** Under backpressure (slow remote, fast save
  cadence) pending uploads coalesce per kind: only the NEWEST pending
  checkpoint step uploads; superseded ones are dropped (the remote store
  is a warm-start source, not an archive — the newest durable step is the
  one a fresh node wants).
- **Failure accounting + escalation contract.** Upload failures are
  counted exactly like local save failures (total + consecutive); the
  step-loop side (payload/checkpoint.py) polls :meth:`escalated` at save
  boundaries and converts a persistent streak into the retryable exit
  (143), handing the broken remote to the operator's restart machinery —
  a transient blip costs nothing but a skipped upload.
- **Cache piggyback.** After each checkpoint upload the worker also syncs
  new compilation-cache entries (content-named files, set-difference
  cheap), so a fresh node's cache prefetch finds the executables the
  attempt compiled without a separate upload schedule.

The worker is a daemon: process exit never blocks on a wedged remote.
``close(flush=True)`` (end-of-run) waits up to a bounded timeout for the
final step to land — best-effort, a completed run is never converted to a
failure by its upload tail.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any, Dict, Optional

from tpu_operator_torch.payload.store.warmstart import WarmStartStore

log = logging.getLogger(__name__)

# Consecutive upload failures tolerated before the step loop escalates —
# the same default discipline as local save failures (checkpoint.py
# DEFAULT_FAIL_AFTER).
DEFAULT_FAIL_AFTER = 3

# close(flush=True) bound: a final-checkpoint upload slower than this is
# abandoned (the run already succeeded locally).
DEFAULT_FLUSH_TIMEOUT = 120.0


class WriteBehindUploader:
    """One background worker shipping verified checkpoints (and cache
    entries) to a :class:`WarmStartStore`."""

    def __init__(self, store: WarmStartStore,
                 fail_after: int = DEFAULT_FAIL_AFTER,
                 cache_dir_fn: Optional[Any] = None,
                 keep_snapshots: int = 0):
        self.store = store
        self.fail_after = max(1, int(fail_after))
        # Retention GC (spec.store.keepSnapshots): after each successful
        # commit the worker condemns-then-deletes verified snapshots
        # beyond the newest N (0 = keep everything). Runs on the worker
        # thread, after the commit — the step loop never pays it, and a
        # failed upload never GCs (the newest durable step must not lose
        # older fallbacks to a retention pass it didn't earn).
        self.keep_snapshots = max(0, int(keep_snapshots))
        self.gc_removed = 0  # guarded-by: _cond
        # Zero-arg callable resolving the live compilation-cache dir at
        # upload time (bootstrap enables the cache after the uploader may
        # already exist); None/"" = no cache sync.
        self._cache_dir_fn = cache_dir_fn
        self._cond = threading.Condition()
        # kind -> pending task; "checkpoint" holds (step, dir) last-wins,
        # "corrupt" holds a set of steps to mark, "artifacts" maps remote
        # name -> local path (postmortem step traces; last-wins per name).
        self._pending_step: Optional[tuple] = None  # guarded-by: _cond
        self._pending_corrupt: set = set()  # guarded-by: _cond
        self._pending_artifacts: Dict[str, str] = {}  # guarded-by: _cond
        self._busy = False  # guarded-by: _cond
        self._closed = False  # guarded-by: _cond
        # Counters (read by stats()/escalated() from the step loop).
        self.uploads = 0  # guarded-by: _cond
        self.upload_failures = 0  # guarded-by: _cond
        self.consecutive_failures = 0  # guarded-by: _cond
        self.last_uploaded_step: Optional[int] = None  # guarded-by: _cond
        self.cache_files_uploaded = 0  # guarded-by: _cond
        self.dropped_superseded = 0  # guarded-by: _cond
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="store-writebehind")
        self._thread.start()

    # -- step-loop side (never blocks on the backend) --------------------------

    def enqueue(self, step: int, step_dir: str) -> bool:
        """Queue one verified step for upload. Non-blocking by
        construction: a pending older step is superseded (dropped).
        Returns False when the uploader is closed (the step was REFUSED,
        not queued), so a caller racing ``close()`` can tell a refused
        enqueue from an accepted one."""
        with self._cond:
            if self._closed:
                return False
            if self._pending_step is not None \
                    and self._pending_step[0] != int(step):
                self.dropped_superseded += 1
            self._pending_step = (int(step), step_dir)
            self._cond.notify()
            return True

    def mark_corrupt(self, step: int) -> None:
        """Queue a remote quarantine mark (restore-path hook); async so a
        slow remote cannot stall the restore walk."""
        with self._cond:
            if self._closed:
                return
            self._pending_corrupt.add(int(step))
            if self._pending_step is not None \
                    and self._pending_step[0] == int(step):
                self._pending_step = None  # never upload a condemned step
            self._cond.notify()

    def enqueue_artifact(self, path: str, name: str = "") -> None:
        """Queue one small file (a postmortem step-trace dump) for remote
        upload under the job's ``artifacts/`` prefix. Same non-blocking
        discipline as checkpoints; failures are logged, never counted
        toward escalation — an artifact is a postmortem aid, not
        durability."""
        with self._cond:
            if self._closed:
                return
            self._pending_artifacts[name or os.path.basename(path)] = path
            self._cond.notify()

    def escalated(self) -> bool:
        """True when the remote has failed ``fail_after`` consecutive
        uploads — the step loop converts this to the retryable exit, the
        same contract as persistent local save failures."""
        with self._cond:
            return self.consecutive_failures >= self.fail_after

    def stats(self) -> Dict[str, int]:
        """Heartbeat-facing counters (merged into Checkpointer.stats())."""
        with self._cond:
            out: Dict[str, int] = {
                "uploadFailures": int(self.upload_failures),
            }
            if self.last_uploaded_step is not None:
                out["lastUploadedStep"] = int(self.last_uploaded_step)
            return out

    def idle(self) -> bool:
        with self._cond:
            return (self._pending_step is None
                    and not self._pending_corrupt
                    and not self._pending_artifacts and not self._busy)

    def flush(self, timeout: float = DEFAULT_FLUSH_TIMEOUT) -> bool:
        """Wait (bounded) until the queue drains; True when it did."""
        import time

        deadline = time.monotonic() + max(0.0, timeout)
        with self._cond:
            while (self._pending_step is not None
                   or self._pending_corrupt
                   or self._pending_artifacts or self._busy):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(0.1, remaining))
            return True

    def close(self, flush: bool = False,
              timeout: float = DEFAULT_FLUSH_TIMEOUT) -> None:
        """Stop accepting work; optionally drain what was accepted
        (bounded).

        The close mark lands BEFORE the drain: with drain-then-mark, an
        enqueue landing between an empty flush() and the mark would be
        accepted and then stranded when the process exits. With
        mark-first, a racing enqueue either lands before the mark (the
        flush below waits for its upload) or is refused outright
        (enqueue returns False)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if flush:
            self.flush(timeout)

    # -- worker ----------------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cond:
                while (self._pending_step is None
                       and not self._pending_corrupt
                       and not self._pending_artifacts and not self._closed):
                    self._cond.wait()
                if self._closed and self._pending_step is None \
                        and not self._pending_corrupt \
                        and not self._pending_artifacts:
                    return
                task_step = self._pending_step
                self._pending_step = None
                corrupt = set(self._pending_corrupt)
                self._pending_corrupt.clear()
                artifacts = dict(self._pending_artifacts)
                self._pending_artifacts.clear()
                self._busy = True
            try:
                for step in sorted(corrupt):
                    try:
                        self.store.mark_corrupt(step, "local quarantine")
                    except Exception as e:  # noqa: BLE001 — best-effort mark
                        log.warning("remote corrupt-mark of step %d failed: "
                                    "%s", step, e)
                for name, path in sorted(artifacts.items()):
                    try:
                        self.store.upload_artifact(path, name)
                    except Exception as e:  # noqa: BLE001 — postmortem aid
                        log.warning("artifact upload of %s failed: %s",
                                    name, e)
                if task_step is not None:
                    self._upload(*task_step)
                    # Cache sync is INDEPENDENT of the checkpoint upload's
                    # outcome (entries compiled this attempt are valuable
                    # even when the snapshot failed to ship) — a failed
                    # upload must not also forfeit the fresh-node warm
                    # compile.
                    self._sync_cache()
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def _upload(self, step: int, step_dir: str) -> None:
        try:
            self.store.upload_checkpoint(step_dir, step)
        except Exception as e:  # noqa: BLE001 — counted, never propagates
            with self._cond:
                self.upload_failures += 1
                self.consecutive_failures += 1
                consecutive = self.consecutive_failures
                total = self.upload_failures
            log.warning(
                "remote checkpoint upload of step %d failed (%d "
                "consecutive, %d total): %s", step, consecutive, total, e)
            return
        with self._cond:
            self.uploads += 1
            self.consecutive_failures = 0
            self.last_uploaded_step = int(step)
        log.info("remote store: uploaded checkpoint step %d", step)
        if self.keep_snapshots:
            try:
                n = self.store.retain(self.keep_snapshots)
            except Exception as e:  # noqa: BLE001 — GC is best-effort
                log.warning("retention GC after step %d failed: %s",
                            step, e)
                return
            if n:
                with self._cond:
                    self.gc_removed += n

    def _sync_cache(self) -> None:
        cache_dir = ""
        if self._cache_dir_fn is not None:
            try:
                cache_dir = str(self._cache_dir_fn() or "")
            except Exception:  # noqa: BLE001 — cache sync is best-effort
                cache_dir = ""
        if not cache_dir:
            return
        try:
            n = self.store.upload_cache(cache_dir)
        except Exception as e:  # noqa: BLE001 — best-effort
            log.warning("compilation-cache upload failed: %s", e)
            return
        if n:
            with self._cond:
                self.cache_files_uploaded += n
            log.info("remote store: uploaded %d compilation-cache "
                     "entries", n)
