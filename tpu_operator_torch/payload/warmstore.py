"""Payload-side adapter for the remote warm-start store (counterpart of
``tpu_operator/payload/warmstore.py``).

The env-contract consumer half of ``spec.store``: the operator injects
``TPUJOB_STORE_*``; this module turns it into a
:class:`~tpu_operator_torch.payload.store.WarmStartStore`, a write-behind
uploader for the checkpointer, and the rendezvous-overlapped prefetch
that ``bootstrap.initialize`` runs.

Injected env contract (the reference's):

- ``TPUJOB_STORE_BACKEND``     — localfs | fake (spec.store.backend)
- ``TPUJOB_STORE_URI``         — blob-store root the backend resolves
- ``TPUJOB_STORE_PARALLELISM`` — chunk-transfer fan-out
- ``TPUJOB_STORE_PREFETCH``    — "0"/"false" skips the startup download
- ``TPUJOB_STORE_KEEP``        — remote snapshots kept (0 = all)

Job identity (``TPUJOB_NAMESPACE``/``TPUJOB_NAME``) scopes the store
prefix. The compilation cache the store syncs is the kernel library's
directory (``JAX_COMPILATION_CACHE_DIR`` / ``TPUJOB_CACHE_PATH``, the
operator's names): ``kernels/build.py`` keeps its content-named library
there.

Everything here is best-effort at startup: a misconfigured or unreachable
store logs and the attempt proceeds cold. Persistent UPLOAD failures do
escalate, through the checkpointer's save-failure contract.

Prefetch sequencing: ``start_prefetch`` runs BEFORE the coordinator DNS
wait and ``finish_prefetch`` after the process group forms, so the
download overlaps the rendezvous and only the tail that outlives it is
paid (the PREFETCH startup stage). The checkpoint lands in the local
checkpoint dir, where the verified restore walk judges it like any other
on-disk step.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, Optional

from tpu_operator_torch.payload import startup as startup_mod

log = logging.getLogger(__name__)

ENV_BACKEND = "TPUJOB_STORE_BACKEND"
ENV_URI = "TPUJOB_STORE_URI"
ENV_PARALLELISM = "TPUJOB_STORE_PARALLELISM"
ENV_PREFETCH = "TPUJOB_STORE_PREFETCH"
ENV_KEEP = "TPUJOB_STORE_KEEP"

# How long finish_prefetch waits for the download tail after rendezvous
# before proceeding cold: the store must never hang startup.
PREFETCH_JOIN_TIMEOUT = 300.0


def cache_dir_from_env(env: Dict[str, str]) -> str:
    """The compilation-cache dir the operator injected ("" = none)."""
    return env.get("JAX_COMPILATION_CACHE_DIR", "") \
        or env.get("TPUJOB_CACHE_PATH", "")


def store_from_env(env: Optional[Dict[str, str]] = None) -> Optional[Any]:
    """The job's WarmStartStore from the injected env, or None when the
    store is not wired. Never raises: a bad URI or backend logs and
    returns None (the attempt proceeds store-less)."""
    e = env if env is not None else os.environ
    uri = e.get(ENV_URI, "")
    if not uri:
        return None
    from tpu_operator_torch.payload.store import WarmStartStore, blob

    try:
        backend = blob.from_uri(uri)
    except Exception as err:  # noqa: BLE001 — never fail the attempt
        # An unmounted or read-only root raises OSError from makedirs,
        # a registered factory anything: all of it degrades to store-less.
        log.warning("warm-start store disabled (unusable %s=%r): %s",
                    ENV_URI, uri, err)
        return None
    parallelism = _env_int(e, ENV_PARALLELISM, 4)
    namespace = e.get("TPUJOB_NAMESPACE", "default") or "default"
    job = e.get("TPUJOB_NAME", "") or "job"
    return WarmStartStore(backend, prefix=f"{namespace}/{job}",
                          upload_parallelism=parallelism)


def _env_int(e: Dict[str, str], var: str, default: int) -> int:
    try:
        return int(e.get(var) or default)
    except ValueError:
        log.warning("ignoring malformed %s=%r", var, e.get(var))
        return default


def _is_process_zero(env: Dict[str, str]) -> bool:
    try:
        return int(env.get("JAX_PROCESS_ID") or 0) == 0
    except ValueError:
        return True


def uploader_from_env(env: Optional[Dict[str, str]] = None,
                      fail_after: Optional[int] = None) -> Optional[Any]:
    """The write-behind uploader for this process, or None when the store
    is unwired OR this is not process 0: one writer per job keeps the
    remote layout race-free."""
    e = env if env is not None else os.environ
    if not _is_process_zero(dict(e)):
        return None
    store = store_from_env(e)
    if store is None:
        return None
    from tpu_operator_torch.payload.store import writebehind

    return writebehind.WriteBehindUploader(
        store,
        fail_after=(fail_after if fail_after is not None
                    else writebehind.DEFAULT_FAIL_AFTER),
        # Resolved at upload time: bootstrap enables the cache after the
        # checkpointer (and this uploader) may already exist.
        cache_dir_fn=startup_mod.cache_dir,
        keep_snapshots=_env_int(e, ENV_KEEP, 0))


# --- rendezvous-overlapped prefetch ------------------------------------------

_prefetch_lock = threading.Lock()
_prefetch_thread: Optional[threading.Thread] = None  # guarded-by: _prefetch_lock
_prefetch_result: Dict[str, Any] = {}  # guarded-by: _prefetch_lock


def _prefetch_worker(store: Any, cache_dir: str, ckpt_dir: str) -> None:
    result: Dict[str, Any] = {"checkpointStep": None, "cacheFiles": 0,
                              "fallbacks": 0}
    try:
        if cache_dir:
            result["cacheFiles"] = store.prefetch_cache(cache_dir)
        if ckpt_dir:
            step, fallbacks = store.prefetch_checkpoint(ckpt_dir)
            result["checkpointStep"] = step
            result["fallbacks"] = fallbacks
    except Exception as e:  # noqa: BLE001 — prefetch must never fail startup
        log.warning("warm-start prefetch failed (proceeding cold): %s", e)
        result["error"] = str(e)
    with _prefetch_lock:
        _prefetch_result.update(result)


def start_prefetch(env: Optional[Dict[str, str]] = None) -> bool:
    """Start the store download on a worker thread (idempotent; False
    when the store is unwired or prefetch is disabled). Call BEFORE the
    rendezvous wait."""
    global _prefetch_thread
    e = env if env is not None else os.environ
    if str(e.get(ENV_PREFETCH, "1")).lower() in ("0", "false"):
        return False
    store = store_from_env(e)
    if store is None:
        return False
    cache_dir = cache_dir_from_env(e)
    ckpt_dir = e.get("TPU_CHECKPOINT_DIR", "")
    if not cache_dir and not ckpt_dir:
        return False
    with _prefetch_lock:
        if _prefetch_thread is not None:
            return True
        _prefetch_result.clear()
        _prefetch_result["started_at"] = time.perf_counter()
        _prefetch_thread = threading.Thread(
            target=_prefetch_worker, args=(store, cache_dir, ckpt_dir),
            daemon=True, name="store-prefetch")
        _prefetch_thread.start()
    return True


def finish_prefetch(timeout: float = PREFETCH_JOIN_TIMEOUT
                    ) -> Optional[Dict[str, Any]]:
    """Join the prefetch (bounded) and record the PREFETCH startup stage:
    the tail paid HERE, beyond whatever the download overlapped. Returns
    the result dict, or None when no prefetch ran."""
    global _prefetch_thread
    with _prefetch_lock:
        thread = _prefetch_thread
    if thread is None:
        return None
    t0 = time.perf_counter()
    thread.join(timeout)
    tail = time.perf_counter() - t0
    if thread.is_alive():
        log.warning("warm-start prefetch still running after %.0fs; "
                    "proceeding cold (download continues best-effort)",
                    timeout)
        startup_mod.record_prefetch(tail, False)
        return {"timeout": True}
    with _prefetch_lock:
        result = dict(_prefetch_result)
        _prefetch_thread = None
    hit = bool(result.get("cacheFiles")) \
        or result.get("checkpointStep") is not None
    startup_mod.record_prefetch(tail, hit)
    result["tailSeconds"] = tail
    if hit:
        log.info(
            "warm-start prefetch: checkpoint step %s, %d cache entries "
            "(%.2fs beyond rendezvous)", result.get("checkpointStep"),
            result.get("cacheFiles", 0), tail)
    else:
        log.info("warm-start prefetch: nothing to fetch (cold store)")
    return result


def upload_cache_once(env: Optional[Dict[str, str]] = None) -> int:
    """One-shot best-effort compilation-cache sync (process 0 only), run
    by ``bootstrap.run_payload`` at exits 0, 143 and 160: a job with a
    store but no checkpointing has no write-behind uploader, and an
    attempt that built its kernels may exit before its first save.
    Returns files uploaded (0 on any failure)."""
    e = env if env is not None else os.environ
    if not _is_process_zero(dict(e)):
        return 0
    store = store_from_env(e)
    if store is None:
        return 0
    # The cache dir bootstrap enabled is authoritative only for the
    # ambient path (env=None); an explicit env is the caller's whole
    # contract.
    cache_dir = cache_dir_from_env(e)
    if env is None:
        cache_dir = startup_mod.cache_dir() or cache_dir
    if not cache_dir:
        return 0
    try:
        n = store.upload_cache(cache_dir)
    except Exception as err:  # noqa: BLE001 — exit-path best-effort
        log.warning("exit-path compilation-cache upload failed: %s", err)
        return 0
    if n:
        log.info("exit-path cache sync: uploaded %d compilation-cache "
                 "entries", n)
    return n


def reset_prefetch() -> None:
    """Test hook: forget any in-flight/finished prefetch state."""
    global _prefetch_thread
    with _prefetch_lock:
        _prefetch_thread = None
        _prefetch_result.clear()
    startup_mod.reset_prefetch()
