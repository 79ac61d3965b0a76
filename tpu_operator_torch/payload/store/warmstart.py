"""The job-scoped warm-start store: checkpoints + compilation cache over a
blob backend.

Remote layout under one job prefix (``<namespace>/<job>`` by default):

    checkpoints/<step>/manifest.json + data/...   — one chunked snapshot
                                                    per durable step
    checkpoints/<step>.corrupt                    — quarantine marker
    cache/<entry>                                 — compilation-cache
                                                    entries (the kernel
                                                    library), one object
                                                    per cache file

Design decisions:

- **No central index object.** A read-modify-write index file would race
  across uploader attempts and the quarantine path; instead presence =
  the snapshot's committed manifest, and corruption = a marker object
  written FIRST (before the manifest is deleted), so there is no window
  in which a condemned step looks healthy to a fresh-node prefetch.
- **Quarantine parity with the local walk.** When the local restore walk
  quarantines ``<step>`` locally (``<step>.corrupt-N``), the checkpointer
  tells this store to :meth:`mark_corrupt` the remote copy — a fresh node
  must never re-download a step an earlier attempt already proved bad.
  Prefetch ALSO skips steps the local directory has quarantined, covering
  the window before the async mark lands.
- **Integrity fallback.** A snapshot whose chunks fail verification after
  the one retry is marked corrupt and the prefetch falls back to the
  next-oldest step — the newest→oldest discipline of the local restore
  walk, applied to the remote side.
- **Cache entries are immutable.** Every cache file is named by its
  content (the kernel library by the digest of its sources and flags), so
  sync is pure set-difference: upload what the remote lacks, download
  what the local dir lacks. No versioning, no manifest; the kernel
  library's loader checks each library's bytes against the sha256 beside
  it before loading it.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, Dict, List, Optional, Tuple

from tpu_operator_torch.payload.store import transfer
from tpu_operator_torch.payload.store.blob import (BlobBackend, BlobError,
                                                  BlobNotFound)

log = logging.getLogger(__name__)

CHECKPOINT_PREFIX = "checkpoints"
CACHE_PREFIX = "cache"
ARTIFACT_PREFIX = "artifacts"
CORRUPT_SUFFIX = ".corrupt"

# Local quarantine directory names the restore walk writes
# (checkpoint.QUARANTINE_SUFFIX): "<step>.corrupt-<n>".
_LOCAL_QUARANTINE_RE = re.compile(r"^(\d+)\.corrupt(-\d+)?$")


class WarmStartStore:
    """Checkpoint + compilation-cache persistence for ONE job."""

    def __init__(self, backend: BlobBackend, prefix: str = "",
                 upload_parallelism: int = transfer.DEFAULT_PARALLELISM,
                 chunk_size: int = transfer.DEFAULT_CHUNK_SIZE):
        self.backend = backend
        self.prefix = prefix.strip("/")
        self.upload_parallelism = max(1, int(upload_parallelism))
        self.chunk_size = max(1, int(chunk_size))

    def _key(self, *parts: str) -> str:
        bits = [self.prefix] if self.prefix else []
        bits.extend(parts)
        return "/".join(bits)

    def _step_prefix(self, step: int) -> str:
        return self._key(CHECKPOINT_PREFIX, str(int(step)))

    # -- checkpoints: write side ----------------------------------------------

    def upload_checkpoint(self, local_step_dir: str, step: int) -> None:
        """Ship one verified local step directory as a remote snapshot
        (chunks first, manifest last = commit). Raises BlobError flavors
        on failure — the write-behind uploader owns counting/escalation.

        A fresh upload CLEARS any ``.corrupt`` marker for the step: the
        marker condemned the OLD bytes; a job that quarantined step N,
        resumed from N-k, replayed, and re-saved a newly VERIFIED step N
        must not have that step invisible to prefetch forever (it would
        replay the same k steps after every preemption while heartbeats
        advertise N as remotely durable). Cleared only AFTER the new
        manifest commits, so there is no window in which the old bad
        snapshot looks healthy."""
        step = int(step)
        transfer.upload_tree(
            self.backend, local_step_dir, self._step_prefix(step),
            parallelism=self.upload_parallelism,
            chunk_size=self.chunk_size,
            meta={"step": step})
        self.backend.delete(self._key(CHECKPOINT_PREFIX,
                                      f"{step}{CORRUPT_SUFFIX}"))

    def retain(self, keep: int) -> int:
        """Retention GC: condemn-then-delete verified snapshots beyond the
        newest ``keep`` (0/negative = keep everything). Returns steps
        removed.

        Ordering is the marker-first discipline: the ``.corrupt``
        marker lands BEFORE any chunk of the victim is deleted, so there
        is no window in which a half-deleted snapshot looks committed to
        a fresh-node prefetch or the serve-mode hot-reload watcher. Once
        the tree (manifest included) is gone the marker itself is removed
        — a GC'd step is *absence*, not quarantine: leaving the marker
        would grow an unbounded marker tree, the very thing this GC
        exists to prevent. A crash between tree-delete and marker-delete
        leaves a stray marker over nothing, which the next retain() pass
        ignores (the step is no longer in checkpoint_steps)."""
        if keep < 1:
            return 0
        steps = self.checkpoint_steps()
        victims = steps[:-keep] if len(steps) > keep else []
        removed = 0
        for step in victims:
            marker = self._key(CHECKPOINT_PREFIX, f"{step}{CORRUPT_SUFFIX}")
            self.backend.put(marker, b"retention gc")
            transfer.delete_tree(self.backend, self._step_prefix(step))
            self.backend.delete(marker)
            removed += 1
            log.info("remote store: retention GC removed snapshot step %d "
                     "(keeping newest %d)", step, keep)
        return removed

    def mark_corrupt(self, step: int, reason: str = "") -> None:
        """Condemn a remote step: marker first (no healthy-looking
        window), then the snapshot itself. Idempotent and best-effort on
        the chunk sweep; the marker is the load-bearing part."""
        step = int(step)
        self.backend.put(self._key(CHECKPOINT_PREFIX,
                                   f"{step}{CORRUPT_SUFFIX}"),
                         (reason or "quarantined").encode())
        transfer.delete_tree(self.backend, self._step_prefix(step))
        log.warning("remote store: marked checkpoint step %d corrupt (%s)",
                    step, reason or "local quarantine")

    # -- artifacts (postmortem step traces etc.) ------------------------------

    def upload_artifact(self, local_path: str, name: str) -> None:
        """Ship one small file under the job's ``artifacts/`` prefix as a
        single object (postmortem step-trace dumps are a few hundred KB —
        no chunking needed; the backend's put is atomic per object).
        Raises BlobError flavors / OSError on failure — the write-behind
        worker owns the best-effort handling."""
        with open(local_path, "rb") as f:
            data = f.read()
        self.backend.put(self._key(ARTIFACT_PREFIX, name), data)

    def list_artifacts(self) -> List[str]:
        """Names of uploaded artifacts (postmortem discovery)."""
        base = self._key(ARTIFACT_PREFIX) + "/"
        return sorted(key[len(base):] for key in self.backend.list(base))

    # -- checkpoints: read side -----------------------------------------------

    def checkpoint_steps(self) -> List[int]:
        """Committed, non-condemned remote steps, ascending."""
        base = self._key(CHECKPOINT_PREFIX) + "/"
        steps, corrupt = set(), set()
        for key in self.backend.list(base):
            rest = key[len(base):]
            head = rest.split("/", 1)[0]
            if head.endswith(CORRUPT_SUFFIX):
                stem = head[:-len(CORRUPT_SUFFIX)]
                if stem.isdigit():
                    corrupt.add(int(stem))
                continue
            if head.isdigit() and rest == f"{head}/{transfer.MANIFEST_KEY}":
                steps.add(int(head))
        return sorted(steps - corrupt)

    def last_uploaded_step(self) -> Optional[int]:
        steps = self.checkpoint_steps()
        return steps[-1] if steps else None

    @staticmethod
    def _locally_quarantined(local_dir: str) -> set:
        """Steps the LOCAL restore walk already condemned: the remote copy
        of those must never be preferred, even before the async
        mark_corrupt lands (or when it failed)."""
        out = set()
        try:
            for name in os.listdir(local_dir):
                m = _LOCAL_QUARANTINE_RE.match(name)
                if m:
                    out.add(int(m.group(1)))
        except OSError:
            pass
        return out

    def prefetch_checkpoint(self, local_dir: str
                            ) -> Tuple[Optional[int], int]:
        """Materialize the newest healthy remote step into ``local_dir``
        (the local verified-restore walk then finds it like any other
        on-disk checkpoint). Returns ``(step, fallbacks)`` — step None
        when nothing usable exists remotely.

        Walks newest→oldest: a snapshot whose chunks fail verification
        after the per-chunk retry is marked corrupt remotely and the walk
        continues to the next-oldest (counted in ``fallbacks``)."""
        os.makedirs(local_dir, exist_ok=True)
        condemned = self._locally_quarantined(local_dir)
        fallbacks = 0
        for step in reversed(self.checkpoint_steps()):
            if step in condemned:
                log.warning(
                    "prefetch: skipping remote step %d (locally "
                    "quarantined); marking it corrupt remotely", step)
                try:
                    self.mark_corrupt(step, "locally quarantined")
                except BlobError as e:
                    log.warning("prefetch: remote corrupt-mark of step %d "
                                "failed: %s", step, e)
                continue
            target = os.path.join(local_dir, str(step))
            if os.path.isdir(target):
                # Already materialized (a peer process on a shared dir, or
                # the attempt's own training history): nothing to fetch —
                # the verified-restore walk will judge it as usual.
                return step, fallbacks
            # Stage under a NON-NUMERIC name and rename the COMPLETE dir
            # into place: the verified restore walk
            # must never observe a half-materialized step directory — a
            # prefetch outliving its bounded join races the restore walk,
            # and a torn step dir seen there would be quarantined locally
            # AND condemned remotely, destroying a healthy snapshot.
            staging = f"{target}.prefetch.{os.getpid()}"
            try:
                transfer.download_tree(
                    self.backend, self._step_prefix(step), staging,
                    parallelism=self.upload_parallelism)
                try:
                    os.rename(staging, target)
                except OSError:
                    # A peer renamed its complete copy first: same bytes.
                    self._scrub_partial(staging)
                return step, fallbacks
            except BlobNotFound:
                self._scrub_partial(staging)
                continue  # raced a concurrent mark/GC; older step next
            except transfer.IntegrityError as e:
                fallbacks += 1
                log.error("prefetch: remote step %d failed verification "
                          "(%s); falling back to next-oldest", step, e)
                try:
                    self.mark_corrupt(step, f"prefetch verification: {e}")
                except BlobError as e2:
                    log.warning("prefetch: corrupt-mark of step %d failed: "
                                "%s", step, e2)
                self._scrub_partial(staging)
            except BlobError:
                # Transient backend failure mid-download (network blip,
                # mount hiccup): scrub the staging dir and let the caller
                # proceed cold — it says nothing about the snapshot, so
                # no condemnation and no further walking.
                self._scrub_partial(staging)
                raise
        return None, fallbacks

    @staticmethod
    def _scrub_partial(target: str) -> None:
        """Remove a partially-materialized step dir so the local verified
        walk never sees a torn, manifest-less directory as a candidate."""
        import shutil

        shutil.rmtree(target, ignore_errors=True)

    # -- compilation cache ----------------------------------------------------

    def upload_cache(self, cache_dir: str) -> int:
        """Sync new local cache entries up; returns files uploaded.
        Entries are content-named, so exists == identical."""
        if not cache_dir or not os.path.isdir(cache_dir):
            return 0
        try:
            remote = set(self.backend.list(self._key(CACHE_PREFIX) + "/"))
        except BlobError as e:
            log.warning("cache upload: listing remote failed: %s", e)
            return 0
        uploaded = 0
        for relpath in transfer.iter_local_files(cache_dir):
            key = self._key(CACHE_PREFIX, relpath)
            if key in remote:
                continue
            path = os.path.join(cache_dir, *relpath.split("/"))
            try:
                with open(path, "rb") as f:
                    self.backend.put(key, f.read())
                uploaded += 1
            except (OSError, BlobError) as e:
                log.warning("cache upload of %s failed: %s", relpath, e)
        return uploaded

    def prefetch_cache(self, cache_dir: str) -> int:
        """Sync missing cache entries down; returns files downloaded.
        Strictly best-effort: a failed entry degrades that compile to
        cold, never the attempt."""
        if not cache_dir:
            return 0
        os.makedirs(cache_dir, exist_ok=True)
        base = self._key(CACHE_PREFIX) + "/"
        try:
            remote = self.backend.list(base)
        except BlobError as e:
            log.warning("cache prefetch: listing remote failed: %s", e)
            return 0
        downloaded = 0
        for key in remote:
            relpath = key[len(base):]
            if not relpath or relpath.startswith("/") \
                    or ".." in relpath.split("/"):
                continue
            target = os.path.join(cache_dir, *relpath.split("/"))
            if os.path.exists(target):
                continue
            try:
                data = self.backend.get(key)
            except BlobError as e:
                log.warning("cache prefetch of %s failed: %s", relpath, e)
                continue
            tmp = f"{target}.{os.getpid()}.tmp"
            try:
                os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, target)
                downloaded += 1
            except OSError as e:
                log.warning("cache prefetch write of %s failed: %s",
                            relpath, e)
                try:
                    os.remove(tmp)
                except OSError:
                    pass
        return downloaded

    # -- introspection --------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        steps = self.checkpoint_steps()
        return {
            "prefix": self.prefix,
            "backend": type(self.backend).__name__,
            "checkpointSteps": steps,
            "cacheEntries": len(
                self.backend.list(self._key(CACHE_PREFIX) + "/")),
        }
