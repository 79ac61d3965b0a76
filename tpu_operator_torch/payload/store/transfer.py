"""Chunked, parallel, integrity-checked directory transfer over a blob
backend.

One local directory tree ↔ one remote *snapshot* under a key prefix:

    <prefix>/manifest.json                      — commit marker, written LAST
    <prefix>/data/<relpath>/<idx>-<sha16>       — one object per chunk

The manifest records every file's size plus each chunk's size and sha256 —
the same per-file integrity discipline as the local checkpoint manifest,
applied to the wire. Properties the warm-start store builds
on:

- **Commit marker.** Chunks upload first, the manifest last: a snapshot
  without a manifest does not exist (a killed upload leaves harmless
  orphan chunks, never a half-snapshot a restore could prefer).
- **Torn-upload resume.** Chunk keys embed the chunk's own sha256 prefix,
  so an object that ``exists`` is *provably* the right bytes (backends
  write atomically) — a retried upload skips straight past everything the
  torn attempt landed and pays only the missing tail.
- **Per-chunk verification + one retry.** Every downloaded chunk is
  re-hashed; a mismatch is re-fetched once (transient corruption — a torn
  read, a flaky proxy) before :class:`IntegrityError` aborts the snapshot,
  at which point the caller (warmstart.py) falls back to the next-oldest
  snapshot rather than restoring known-bad bytes.
- **Bounded parallelism.** Chunks fan out across a thread pool
  (``parallelism``), first-error propagation, so a multi-GB checkpoint
  moves at aggregate-stream rather than single-stream throughput.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from tpu_operator_torch.payload.store.blob import (BlobBackend, BlobError,
                                                  BlobNotFound)

log = logging.getLogger(__name__)

MANIFEST_KEY = "manifest.json"
DATA_PREFIX = "data"

# 8 MiB chunks: large enough that per-object overhead amortizes, small
# enough that parallelism has units to work with on checkpoint-sized files.
DEFAULT_CHUNK_SIZE = 8 << 20
DEFAULT_PARALLELISM = 4


class TransferError(BlobError):
    """A chunked transfer failed."""


class IntegrityError(TransferError):
    """A chunk's bytes failed verification after the retry — the snapshot
    must not be restored."""


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def iter_local_files(local_dir: str) -> List[str]:
    """Relative paths of every transferable file (tmp files skipped)."""
    out: List[str] = []
    for dirpath, _dirs, files in os.walk(local_dir):
        for fn in files:
            if fn.endswith(".tmp"):
                continue
            out.append(os.path.relpath(os.path.join(dirpath, fn), local_dir)
                       .replace(os.sep, "/"))
    return sorted(out)


def _chunk_key(prefix: str, relpath: str, idx: int, sha: str) -> str:
    return f"{prefix}/{DATA_PREFIX}/{relpath}/{idx}-{sha[:16]}"


def _run_pool(tasks: List, parallelism: int) -> None:
    """Run thunks across a bounded pool with first-error propagation (the
    replicas.run_creates discipline, minus the cancel bookkeeping: chunk
    puts/gets are idempotent, so completing in-flight work is harmless)."""
    if not tasks:
        return
    if parallelism <= 1 or len(tasks) == 1:
        for t in tasks:
            t()
        return
    with ThreadPoolExecutor(max_workers=min(parallelism, len(tasks)),
                            thread_name_prefix="blob-xfer") as pool:
        for future in [pool.submit(t) for t in tasks]:
            future.result()


def upload_tree(backend: BlobBackend, local_dir: str, prefix: str,
                parallelism: int = DEFAULT_PARALLELISM,
                chunk_size: int = DEFAULT_CHUNK_SIZE,
                meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Upload ``local_dir`` as the snapshot at ``prefix``; returns the
    manifest. Chunks whose content-addressed key already exists are
    skipped (torn-upload resume)."""
    chunk_size = max(1, int(chunk_size))
    files: List[Dict[str, Any]] = []
    tasks = []
    for relpath in iter_local_files(local_dir):
        path = os.path.join(local_dir, *relpath.split("/"))
        chunks: List[Dict[str, Any]] = []
        try:
            # Pass 1 streams the file once to hash chunk spans (bytes
            # discarded); each pool task re-reads ITS OWN span at put
            # time — peak memory is parallelism × chunk_size, never the
            # whole tree (a multi-GB checkpoint buffered in closures
            # would sit in the training process's RSS for the entire
            # upload). Step dirs are immutable post-verification, so the
            # two passes see the same bytes; a mutation between them
            # would fail the downloader's per-chunk verification anyway.
            with open(path, "rb") as f:
                idx, offset = 0, 0
                while True:
                    data = f.read(chunk_size)
                    if not data and idx > 0:
                        break
                    sha = _sha256(data)
                    key = _chunk_key(prefix, relpath, idx, sha)
                    chunks.append({"idx": idx, "size": len(data),
                                   "sha256": sha})

                    def put(key=key, path=path, offset=offset,
                            size=len(data)):
                        # exists-then-put: the common resume case pays one
                        # cheap probe instead of re-shipping the chunk; a
                        # racing writer of the same key writes identical
                        # bytes (content-addressed), so skip is safe.
                        if backend.exists(key):
                            return
                        with open(path, "rb") as g:
                            g.seek(offset)
                            backend.put(key, g.read(size))

                    tasks.append(put)
                    offset += len(data)
                    idx += 1
                    if not data:
                        break
        except OSError as e:
            raise TransferError(f"reading {path}: {e}") from e
        files.append({"path": relpath,
                      "size": sum(c["size"] for c in chunks),
                      "chunks": chunks})
    _run_pool(tasks, parallelism)
    manifest: Dict[str, Any] = {"files": files}
    if meta:
        manifest["meta"] = dict(meta)
    backend.put(f"{prefix}/{MANIFEST_KEY}",
                json.dumps(manifest, sort_keys=True).encode())
    return manifest


def read_manifest(backend: BlobBackend, prefix: str) -> Dict[str, Any]:
    """The snapshot's manifest (BlobNotFound when the snapshot was never
    committed; TransferError when the manifest bytes are unparseable)."""
    raw = backend.get(f"{prefix}/{MANIFEST_KEY}")
    try:
        doc = json.loads(raw)
        if not isinstance(doc, dict):
            raise ValueError("manifest must be a JSON object")
        return doc
    except ValueError as e:
        raise TransferError(f"unreadable manifest at {prefix}: {e}") from e


def _fetch_chunk(backend: BlobBackend, key: str, want_sha: str,
                 want_size: int) -> bytes:
    """One chunk, verified; a mismatched read is retried exactly once."""
    for attempt in (0, 1):
        data = backend.get(key)
        if len(data) == want_size and _sha256(data) == want_sha:
            return data
        if attempt == 0:
            log.warning("chunk %s failed verification; re-downloading once",
                        key)
    raise IntegrityError(f"chunk {key} failed verification after retry")


def download_tree(backend: BlobBackend, prefix: str, local_dir: str,
                  parallelism: int = DEFAULT_PARALLELISM,
                  manifest: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
    """Materialize the snapshot at ``prefix`` into ``local_dir``; returns
    the manifest. Files already present locally with matching bytes are
    skipped (idempotent across the gang's processes on a shared
    filesystem); each file is assembled in a pid-suffixed tmp and
    ``os.replace``d, so concurrent downloaders last-win complete files."""
    if manifest is None:
        manifest = read_manifest(backend, prefix)
    # Each chunk task fetches, verifies, and pwrite()s its span into a
    # preallocated pid-suffixed tmp — chunk-level parallelism WITHOUT
    # buffering the snapshot in memory (peak = parallelism × chunk_size;
    # the old gather-then-write shape held the whole tree in RAM).
    pending: List[Tuple[int, str, str]] = []  # (fd, tmp, target)
    fetch_tasks = []
    try:
        for entry in manifest.get("files", []):
            relpath = str(entry.get("path", ""))
            if not relpath or relpath.startswith("/") \
                    or ".." in relpath.split("/"):
                raise TransferError(f"manifest names unsafe path {relpath!r}")
            target = os.path.join(local_dir, *relpath.split("/"))
            if _local_file_matches(target, entry):
                continue
            os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
            tmp = f"{target}.{os.getpid()}.tmp"
            try:
                fd = os.open(tmp, os.O_CREAT | os.O_RDWR | os.O_TRUNC, 0o644)
                os.ftruncate(fd, int(entry.get("size", 0)))
            except OSError as e:
                raise TransferError(f"preparing {tmp}: {e}") from e
            pending.append((fd, tmp, target))
            offset = 0
            for chunk in entry.get("chunks", []):
                key = _chunk_key(prefix, relpath, int(chunk["idx"]),
                                 str(chunk["sha256"]))

                def fetch(fd=fd, key=key, chunk=chunk, offset=offset):
                    data = _fetch_chunk(backend, key, str(chunk["sha256"]),
                                        int(chunk["size"]))
                    if data:
                        os.pwrite(fd, data, offset)

                fetch_tasks.append(fetch)
                offset += int(chunk["size"])
        _run_pool(fetch_tasks, parallelism)
        while pending:
            # pop-then-process: each fd is closed exactly once (a second
            # close of a released fd number could hit an unrelated file
            # another thread just opened), and the error-path scrub below
            # only ever sees genuinely unprocessed entries.
            fd, tmp, target = pending.pop()
            try:
                try:
                    os.fsync(fd)
                finally:
                    os.close(fd)
                os.replace(tmp, target)
            except OSError as e:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                raise TransferError(f"writing {target}: {e}") from e
    finally:
        for fd, tmp, _target in pending:  # error path: scrub partials
            try:
                os.close(fd)
            except OSError:
                pass
            try:
                os.remove(tmp)
            except OSError:
                pass
    return manifest


def _local_file_matches(target: str, entry: Dict[str, Any]) -> bool:
    """Skip-if-present probe: the local file byte-matches the manifest
    entry (size, then each chunk's sha over the recorded chunk spans) —
    what makes gang-wide prefetch into one shared directory idempotent."""
    try:
        if not os.path.isfile(target) \
                or os.path.getsize(target) != entry.get("size"):
            return False
        with open(target, "rb") as f:
            for chunk in entry.get("chunks", []):
                data = f.read(int(chunk["size"]))
                if _sha256(data) != str(chunk["sha256"]):
                    return False
        return True
    except OSError:
        return False


def delete_tree(backend: BlobBackend, prefix: str) -> int:
    """Best-effort removal of a snapshot: the manifest FIRST (the snapshot
    stops existing atomically), then its chunks. Returns objects deleted."""
    deleted = 0
    try:
        backend.delete(f"{prefix}/{MANIFEST_KEY}")
        deleted += 1
    except BlobNotFound:
        pass
    except BlobError as e:
        log.warning("deleting manifest under %s: %s", prefix, e)
    try:
        for key in backend.list(f"{prefix}/{DATA_PREFIX}/"):
            try:
                backend.delete(key)
                deleted += 1
            except BlobError as e:
                log.warning("deleting chunk %s: %s", key, e)
    except BlobError as e:
        log.warning("listing chunks under %s: %s", prefix, e)
    return deleted
