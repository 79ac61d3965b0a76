"""Durable checkpoint / resume of the PyTorch payload (counterpart of
``tpu_operator/payload/checkpoint.py``).

A whole-group restart (the operator restarts every process of a gang
after a drain exit or a lost pod) starts each attempt from step 0 unless
the payload persists its state. This module makes resume part of the
payload contract, as the reference does:

- the operator injects ``TPU_CHECKPOINT_DIR`` when ``spec.checkpointDir``
  is set; :func:`from_env_or_args` turns the flag or that env into a
  :class:`Checkpointer` (None when neither is set);
- ``train.train_loop`` restores the newest *verified* step before its
  first step, saves on the interval, at a drain boundary and once at the
  end; the server loads the newest verified step's params.

The on-disk format is the port's own (orbax checkpoints are not read). A
step is the directory ``<dir>/<step>/`` holding

- ``params.pt``: the named params, ``torch.save`` of CPU tensors;
- ``opt.pt``: the optimizer state under its own names (adam's
  ``count``, ``mu.<i>``, ``nu.<i>``; adam8's ``count``, ``seed`` and the
  int8 moments with their scales; sgd's ``trace.<i>``: each state's
  ``state_dict``), absent for a params-only state;
- ``batch_stats.pt``: a classifier's BatchNorm running statistics, when
  the state has them;
- ``meta.json``: the step, every tensor's shape and dtype, the optimizer
  (``optimizer``) and adam's mu dtype (``adamMuDtype``);
- ``manifest.tpuop.json``: every other file's size and sha256, written
  last.

A save is written into ``<dir>/<step>.tmp-<pid>-<n>/``, each file and the
directory fsynced, then committed by ``os.rename`` to ``<dir>/<step>/``.
A finalized step is a numeric directory name and a tmp name never is, so
the step walk never sees a half-written save. A server reads
``params.pt`` (1.96 GB at the flagship's width) and never ``opt.pt``.

Durability, as in the reference:

- **Asynchronous, verified saves.** At the save the state is copied to
  host memory: on the card, asynchronous copies into pinned buffers on
  the current stream, behind the step that produced the state, so the
  step loop waits for nothing but their launch. One background thread
  waits for the copies, writes, fsyncs, renames, hashes and writes the
  manifest; the loop joins it at the next save boundary, on
  :meth:`flush` and on :meth:`close`. :meth:`last_verified_step`
  advances only once the manifest is written.
- **Save-failure tolerance.** An I/O error is counted and skipped;
  ``fail_after`` consecutive failures raise ``SystemExit(143)`` on the
  step-loop thread, so the operator restarts the group.
- **Verified restore walk.** Newest step first: the commit, then each
  manifest entry of the files the restore reads (size, sha256). A
  failing step is renamed to ``<step>.corrupt-<n>`` and counted in
  ``restore_fallbacks``, and the walk goes on to the next older step;
  tmp directories a killed save left behind are renamed aside
  (``+ .orphaned``) first. A load that fails on bytes that still match
  their manifest (a model of another width) raises and quarantines
  nothing. With nothing left the state comes back untouched at step 0.
- **Gang-consistent resume.** The gang agrees on the MIN of every
  process's newest intact step (:func:`gang_agree_step`), loads it, then
  runs a confirm round, so a peer whose load failed makes the whole gang
  walk again together.
- **Any world size.** The port's state is whole on every process (data
  parallelism all-reduces the gradients; the sequence-parallel ring keeps
  whole params), so a step saved by a world of N restores into any world:
  the port's counterpart of the reference's reshard-restore.
- **One writer.** Process 0 writes; every process joins each save as a
  collective at the boundary that finalizes it (process 0 broadcasts the
  outcome on the host group), so all of them count the same failures,
  advance the same verified step and escalate together. The restore
  walk's renames (quarantine, orphan sweep) run on every process, as in
  the reference: on a shared directory the first rename wins.

Not ported yet (ROADMAP Queue A 3): the remote warm-start store's
write-behind uploader and the autotune cadence multiplier (the
configured interval always applies).
"""

from __future__ import annotations

import collections
import hashlib
import json
import logging
import os
import shutil
import threading
import time
from typing import (Any, Callable, Deque, Dict, List, NamedTuple,
                    Optional, Tuple)

import torch
import torch.distributed as dist

from tpu_operator_torch.payload import bootstrap

log = logging.getLogger(__name__)

ENV_VAR = "TPU_CHECKPOINT_DIR"

# Manifest sidecar written into a step directory after its save commits.
MANIFEST_NAME = "manifest.tpuop.json"

# Quarantined step dirs: ``<step>.corrupt-<n>``. Non-numeric, so the step
# walk ignores them; the bytes stay on disk for postmortem.
QUARANTINE_SUFFIX = ".corrupt"

# Orphaned tmp dirs from a killed save are renamed aside with this suffix.
ORPHAN_SUFFIX = ".orphaned"

# Consecutive save failures tolerated before a retryable exit.
DEFAULT_FAIL_AFTER = 3

PARAMS_FILE = "params.pt"
OPT_FILE = "opt.pt"
STATS_FILE = "batch_stats.pt"
META_FILE = "meta.json"
FORMAT_VERSION = 1

# A save in progress: ``<step>.tmp-<pid>-<n>``.
TMP_MARK = ".tmp-"

# The remote warm-start store's env (the reference's warmstore.ENV_URI).
ENV_STORE_URI = "TPUJOB_STORE_URI"


class TrainState(NamedTuple):
    """What a checkpoint holds: the named params, for a trainer the
    optimizer state (``optimizers.AdamState``, ``Adam8State`` or
    ``SGDState``), and a classifier's BatchNorm running statistics by
    buffer name. A restore copies into these tensors in place, so a step
    function built on them needs no rebuild."""

    params: Dict[str, torch.Tensor]
    opt: Optional[Any] = None
    batch_stats: Optional[Dict[str, torch.Tensor]] = None


class CheckpointError(Exception):
    """A checkpoint operation failed (carried in logs and counters; only
    escalation raises out of the step loop)."""


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fsync(path: str) -> None:
    """fsync a file or a directory by path."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def gang_agree_step(candidate: Optional[int]) -> Optional[int]:
    """Group consensus on the restore step: the MIN over the processes of
    each one's newest locally intact step (None is sent as -1), one int64
    CPU scalar all-reduced on the host group. One process does no
    collective. The MIN is the only safe choice: every process holds the
    steps up to its own newest one, so the group lands on state all of
    them hold."""
    if bootstrap.world_size() <= 1:
        return candidate
    local = torch.tensor([-1 if candidate is None else int(candidate)],
                         dtype=torch.int64)
    dist.all_reduce(local, op=dist.ReduceOp.MIN,
                    group=bootstrap.host_group())
    agreed = int(local.item())
    return None if agreed < 0 else agreed


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _parts(state: TrainState) -> Dict[str, Dict[str, torch.Tensor]]:
    """file name -> {tensor name: live tensor}."""
    parts = {PARAMS_FILE: dict(state.params)}
    if state.opt is not None:
        parts[OPT_FILE] = state.opt.state_dict()
    if state.batch_stats:
        parts[STATS_FILE] = dict(state.batch_stats)
    return parts


class _Snapshot(NamedTuple):
    """A save's host copy: file -> {name: host tensor}, the meta document,
    and the CUDA event after the copies (None on the CPU)."""

    files: Dict[str, Dict[str, torch.Tensor]]
    meta: Dict[str, Any]
    event: Optional[Any]


class Checkpointer:
    """Verified asynchronous saves, the quarantine-and-fall-back restore
    walk and save-failure tolerance over one directory of steps.

    ``agree_fn`` (default :func:`gang_agree_step`) is injectable for
    tests, as in the reference."""

    def __init__(self, directory: str, save_every: int = 100,
                 max_to_keep: int = 3,
                 fail_after: int = DEFAULT_FAIL_AFTER,
                 agree_fn: Optional[Callable[[Optional[int]],
                                             Optional[int]]] = None):
        self.directory = os.path.abspath(directory)
        self.save_every = max(1, int(save_every))
        self.max_to_keep = max(1, int(max_to_keep))
        self.fail_after = max(1, int(fail_after))
        self._agree = agree_fn or gang_agree_step
        self.save_failures = 0
        self.consecutive_save_failures = 0
        self.restore_fallbacks = 0
        self._last_verified: Optional[int] = None
        # The newest step saved or restored this attempt: the interval
        # policy's memory (the same on every process of a gang).
        self._last_saved: Optional[int] = None
        self._pending: Optional[int] = None  # issued, not yet finalized
        self._writer = bootstrap.rank() == 0
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # The writer thread's (step, error-or-None) handoff.
        self._outcome: Optional[Tuple[int, Optional[Exception]]] = None  # guarded-by: _lock
        # Host buffers (pinned for a state on the card), reused by every
        # save of a state with the same layout.
        self._host: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self._host_layout: Any = None
        self._tmp_seq = 0
        # Steps condemned this process: never walked again.
        self._condemned: set = set()
        # Seconds and bytes by stage: the newest saves this process
        # issued, one dict each, and the newest restore's.
        self.save_timings: Deque[Dict[str, Any]] = collections.deque(
            maxlen=8)
        self.restore_timings: Dict[str, Any] = {}

    # -- introspection ---------------------------------------------------------

    def all_steps(self) -> List[int]:
        """Finalized steps on disk (numeric directory names), oldest
        first."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(int(n) for n in names if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        """Newest step on disk: NOT necessarily durable; restart decisions
        should prefer :meth:`last_verified_step`."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def last_verified_step(self) -> Optional[int]:
        """Newest step whose save was committed and verified (or that a
        restore loaded): the step a restart is guaranteed to resume
        from."""
        return self._last_verified

    def stats(self) -> Dict[str, int]:
        """Durability counters for the heartbeat body."""
        out = {"saveFailures": int(self.save_failures),
               "restoreFallbacks": int(self.restore_fallbacks)}
        if self._last_verified is not None:
            out["lastCheckpointStep"] = int(self._last_verified)
        return out

    # -- save path -------------------------------------------------------------

    def maybe_save(self, step: int, state: TrainState) -> bool:
        """Save if the interval policy says so: orbax's, which the
        reference uses: the first save of an attempt that restored
        nothing lands at once, then every ``save_every`` steps, never at
        or below a step already saved or restored. Asynchronous: the
        previous save is finalized first, blocking only when a new save
        is due. I/O failures never propagate: they are counted,
        escalating to SystemExit(143) only after ``fail_after``
        consecutive failures."""
        step = int(step)
        last = self._last_saved
        if last is not None and (step <= last or step % self.save_every):
            self._finalize_pending(block=False)
            return False
        self._finalize_pending(block=True)
        return self._save(step, state)

    def save(self, step: int, state: TrainState) -> bool:
        """Unconditional save (the final state, a drain); a no-op when
        that step is already verified. The pending save is finalized
        first, so an in-flight interval save of the same step dedups
        instead of being written twice, and one that failed is retried
        here."""
        step = int(step)
        self._finalize_pending(block=True)
        if self._last_verified == step:
            return False
        return self._save(step, state)

    def flush(self) -> None:
        """Block until the in-flight save (if any) has committed and
        verified; after this, :meth:`last_verified_step` reflects it."""
        self._finalize_pending(block=True)

    def _save(self, step: int, state: TrainState) -> bool:
        self._pending = self._last_saved = step
        if not self._writer:
            return True
        timings: Dict[str, Any] = {"step": step}
        self.save_timings.append(timings)
        t0 = time.perf_counter()
        try:
            snap = self._snapshot(step, state, timings)
        except Exception as e:  # noqa: BLE001 — tolerance: counted at finalize
            with self._lock:
                self._outcome = (step, e)
            return True
        timings["snapshot_s"] = time.perf_counter() - t0
        self._thread = threading.Thread(
            target=self._write_worker, args=(step, snap, timings),
            name="ckpt-write", daemon=True)
        self._thread.start()
        return True

    def _host_buffers(self, parts) -> Dict[str, Dict[str, torch.Tensor]]:
        """Host tensors shaped like ``parts``, allocated once per layout:
        one flat buffer per file and dtype (pinned when the state is on
        the card), viewed per tensor, so ``torch.save`` writes each
        file's tensors as one storage per dtype."""
        layout = {f: [(n, tuple(t.shape), t.dtype, t.is_cuda)
                      for n, t in ts.items()] for f, ts in parts.items()}
        if layout == self._host_layout:
            return self._host
        host: Dict[str, Dict[str, torch.Tensor]] = {}
        for fname, tensors in parts.items():
            by_dtype: Dict[torch.dtype, int] = {}
            pinned = False
            for t in tensors.values():
                by_dtype[t.dtype] = by_dtype.get(t.dtype, 0) + t.numel()
                pinned = pinned or t.is_cuda
            flat = {dt: torch.empty(n, dtype=dt, pin_memory=pinned)
                    for dt, n in by_dtype.items()}
            offset = {dt: 0 for dt in by_dtype}
            views = {}
            for name, t in tensors.items():
                o = offset[t.dtype]
                views[name] = flat[t.dtype][o:o + t.numel()].view(t.shape)
                offset[t.dtype] = o + t.numel()
            host[fname] = views
        self._host, self._host_layout = host, layout
        return host

    @torch.no_grad()
    def _snapshot(self, step: int, state: TrainState,
                  timings: Dict[str, Any]) -> _Snapshot:
        """The step loop's whole share of a save: copies of the state
        into host buffers, queued on the current stream behind the work
        that produced it (on the CPU they are done on return)."""
        parts = _parts(state)
        t0 = time.perf_counter()
        host = self._host_buffers(parts)
        timings["host_alloc_s"] = time.perf_counter() - t0
        on_card = False
        for fname, tensors in parts.items():
            for name, t in tensors.items():
                host[fname][name].copy_(t, non_blocking=t.is_cuda)
                on_card = on_card or t.is_cuda
        event = None
        if on_card:
            event = torch.cuda.Event()
            event.record()
        meta: Dict[str, Any] = {
            "format": FORMAT_VERSION,
            "step": int(step),
            "tensors": {f: {n: {"shape": list(t.shape),
                                "dtype": _dtype_name(t.dtype)}
                            for n, t in ts.items()}
                        for f, ts in parts.items()},
        }
        if state.opt is not None:
            meta["optimizer"] = state.opt.kind
            if state.opt.kind == "adam":
                mu = state.opt.mu[0].dtype if state.opt.mu else torch.float32
                meta["adamMuDtype"] = ("bf16" if mu == torch.bfloat16
                                       else "f32")
        return _Snapshot(host, meta, event)

    def _write_worker(self, step: int, snap: _Snapshot,
                      timings: Dict[str, Any]) -> None:
        """Background half of a save: wait for the host copies, write and
        fsync every file, commit by rename, hash into the manifest, drop
        steps beyond ``max_to_keep``. Only records the outcome; counters
        and escalation belong to the step-loop thread."""
        err: Optional[Exception] = None
        try:
            t0 = time.perf_counter()
            if snap.event is not None:
                snap.event.synchronize()
            t1 = time.perf_counter()
            self._commit(step, snap)
            t2 = time.perf_counter()
            ok, why = self._verify_commit(step)
            if not ok:
                raise CheckpointError(why)
            try:
                self._write_manifest(step)
            except Exception as e:  # noqa: BLE001 — manifest is best-effort
                # The commit itself is good; without a manifest the step
                # falls back to load-attempt verification.
                log.warning("checkpoint step %d: manifest write failed: %s",
                            step, e)
            timings.update(copy_wait_s=t1 - t0, write_s=t2 - t1,
                           manifest_s=time.perf_counter() - t2,
                           bytes=self._file_sizes(step))
            self._drop_old_steps()
        except Exception as e:  # noqa: BLE001 — applied on the loop thread
            err = e
        with self._lock:
            self._outcome = (step, err)

    def _commit(self, step: int, snap: _Snapshot) -> None:
        self._tmp_seq += 1
        final = self._step_dir(step)
        tmp = f"{final}{TMP_MARK}{os.getpid()}-{self._tmp_seq}"
        os.makedirs(tmp)  # and the checkpoint dir, at its first save
        for fname, tensors in snap.files.items():
            path = os.path.join(tmp, fname)
            torch.save(tensors, path)
            _fsync(path)
        meta_path = os.path.join(tmp, META_FILE)
        with open(meta_path, "w", encoding="utf-8") as f:
            json.dump(snap.meta, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync(tmp)
        stale = None
        if os.path.exists(final):
            # A copy of this step from an earlier attempt that the gang did
            # not resume from: move it aside (a tmp name, never walked),
            # commit, then drop it.
            stale = f"{tmp}-replaced"
            os.rename(final, stale)
        os.rename(tmp, final)
        _fsync(self.directory)
        if stale is not None:
            shutil.rmtree(stale, ignore_errors=True)

    def _drop_old_steps(self) -> None:
        """Keep the newest ``max_to_keep`` steps (orbax's retention)."""
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def _finalize_pending(self, block: bool) -> None:
        """Apply the pending save's outcome: advance the verified step or
        count the failure. ``block=True`` joins the writer first; after
        it returns, the pending save is verified or counted as failed.
        ``block=False`` never waits, and in a gang it defers to the next
        blocking boundary, where every process applies the outcome
        together."""
        if self._pending is None:
            return
        gang = bootstrap.world_size() > 1
        thread = self._thread
        if not block and (gang or (thread is not None and thread.is_alive())):
            return
        if thread is not None:
            t0 = time.perf_counter()
            thread.join()
            self._thread = None
            if self.save_timings:
                self.save_timings[-1]["join_wait_s"] = \
                    time.perf_counter() - t0
        step, self._pending = self._pending, None
        with self._lock:
            outcome, self._outcome = self._outcome, None
        err: Optional[Exception] = None
        if self._writer:
            err = outcome[1] if outcome is not None else CheckpointError(
                "checkpoint writer finished without an outcome")
        if gang:
            flag = torch.tensor([1 if err is None else 0], dtype=torch.int64)
            dist.broadcast(flag, src=0, group=bootstrap.host_group())
            if not self._writer and not int(flag.item()):
                err = CheckpointError(
                    f"process 0's save of step {step} failed")
        if err is not None:
            self._record_save_failure(step, err)
            return
        self._last_verified = step
        self.consecutive_save_failures = 0
        log.info("checkpoint step %d verified in %s", step, self.directory)

    def _record_save_failure(self, step: int, err: Exception) -> None:
        self.save_failures += 1
        self.consecutive_save_failures += 1
        log.warning(
            "checkpoint save of step %d failed (%d consecutive, %d total, "
            "last durable step %s): %s", step,
            self.consecutive_save_failures, self.save_failures,
            self._last_verified, err)
        if self.consecutive_save_failures >= self.fail_after:
            log.error(
                "checkpoint storage failing persistently (%d consecutive "
                "save failures); exiting retryable so the operator restarts "
                "the group", self.consecutive_save_failures)
            raise SystemExit(bootstrap.EXIT_RETRYABLE)

    # -- verification / manifest -----------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _file_sizes(self, step: int) -> Dict[str, int]:
        root = self._step_dir(step)
        return {fn: os.path.getsize(os.path.join(root, fn))
                for fn in sorted(os.listdir(root))}

    def _verify_commit(self, step: int) -> Tuple[bool, str]:
        """Did the save of ``step`` commit? The commit is the rename of a
        complete tmp directory (its meta file written last) to the step's
        numeric name."""
        path = self._step_dir(step)
        if not os.path.isdir(path):
            return False, "step directory missing"
        if not os.path.isfile(os.path.join(path, META_FILE)):
            return False, f"{META_FILE} missing (uncommitted step)"
        return True, ""

    def _write_manifest(self, step: int) -> None:
        """Record every committed file's size and sha256 in an atomically
        replaced sidecar (``{"step", "files": [{"path", "size",
        "sha256"}]}``, the reference's document)."""
        root = self._step_dir(step)
        files = []
        for dirpath, _dirnames, filenames in os.walk(root):
            for fn in sorted(filenames):
                if fn == MANIFEST_NAME or fn.endswith(".tmp"):
                    continue
                p = os.path.join(dirpath, fn)
                files.append({
                    "path": os.path.relpath(p, root),
                    "size": os.path.getsize(p),
                    "sha256": _sha256_file(p),
                })
        doc = {"step": int(step), "files": files}
        tmp = os.path.join(root, MANIFEST_NAME + ".tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(root, MANIFEST_NAME))

    def _verify_step(self, step: int,
                     reads: Tuple[str, ...] = ()) -> Tuple[bool, str]:
        """Integrity check of an on-disk step: the commit, then the
        manifest's entries of the files a restore reads (``reads``; all
        of them when empty). A step without a manifest passes tentatively
        and relies on the load's own failure handling."""
        ok, why = self._verify_commit(step)
        if not ok:
            return False, why
        mpath = os.path.join(self._step_dir(step), MANIFEST_NAME)
        if not os.path.exists(mpath):
            return True, "unmanifested checkpoint"
        try:
            with open(mpath, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            return False, f"manifest unreadable: {e}"
        root = self._step_dir(step)
        for entry in doc.get("files", []):
            if reads and entry.get("path") not in reads:
                continue
            p = os.path.join(root, entry.get("path", ""))
            if not os.path.isfile(p):
                return False, f"missing file {entry.get('path')}"
            if os.path.getsize(p) != entry.get("size"):
                return False, (f"size mismatch on {entry.get('path')}: "
                               f"{os.path.getsize(p)} != {entry.get('size')}")
            if _sha256_file(p) != entry.get("sha256"):
                return False, f"checksum mismatch on {entry.get('path')}"
        return True, ""

    def _has_intact_manifest(self, step: int, reads: Tuple[str, ...]
                             ) -> bool:
        """True when the step carries a manifest AND its bytes still match
        it: a load failure on this step cannot be blamed on torn or
        corrupt data."""
        if not os.path.exists(
                os.path.join(self._step_dir(step), MANIFEST_NAME)):
            return False
        ok, _why = self._verify_step(step, reads)
        return ok

    # -- restore path ----------------------------------------------------------

    def _quarantine(self, step: int, why: str) -> None:
        """Move a failed step aside under a non-numeric name: the walk
        stops seeing it and the bytes survive for postmortem. A peer
        quarantining the same step on a shared filesystem: whoever renames
        first wins."""
        self._condemned.add(int(step))
        src = self._step_dir(step)
        n = 0
        dst = f"{src}{QUARANTINE_SUFFIX}-{n}"
        while os.path.exists(dst):
            n += 1
            dst = f"{src}{QUARANTINE_SUFFIX}-{n}"
        try:
            os.rename(src, dst)
            log.error("quarantined checkpoint step %d -> %s (%s)",
                      step, os.path.basename(dst), why)
        except OSError as e:
            log.warning("quarantine of step %d raced/failed (%s); "
                        "continuing fallback: %s", step, why, e)

    def _sweep_orphaned_tmp(self) -> None:
        """Rename aside the tmp directories a killed save left behind
        (``<step>.tmp-<pid>-<n>``), so they are visibly inert."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        for name in names:
            head, mark, _tail = name.partition(TMP_MARK)
            if not mark or not head.isdigit() \
                    or name.endswith(ORPHAN_SUFFIX):
                continue
            src = os.path.join(self.directory, name)
            try:
                os.rename(src, src + ORPHAN_SUFFIX)
                log.warning("swept orphaned tmp checkpoint %s (killed save)",
                            name)
            except OSError:
                pass  # a peer swept it, or it is gone

    def _newest_intact_step(self, reads: Tuple[str, ...]) -> Optional[int]:
        """Newest step passing verification; anything newer that fails is
        quarantined and counted as a restore fallback."""
        for step in reversed(self.all_steps()):
            if step in self._condemned:
                continue
            ok, why = self._verify_step(step, reads)
            if ok:
                return step
            self.restore_fallbacks += 1
            self._quarantine(step, why)
        return None

    @torch.no_grad()
    def _load(self, step: int, state: TrainState) -> None:
        """Read the step's files for ``state`` and copy them in place.
        Every file is read and checked against the live tensors (names,
        shapes; the optimizer's kind and dtypes too) before anything is
        copied, so a failed load leaves the state as it was. Params copy
        into the live dtype (a server keeps bf16 weights)."""
        root = self._step_dir(step)
        with open(os.path.join(root, META_FILE), encoding="utf-8") as f:
            meta = json.load(f)
        if meta.get("format") != FORMAT_VERSION or meta.get("step") != step:
            raise CheckpointError(
                f"{META_FILE} of step {step}: format {meta.get('format')}, "
                f"step {meta.get('step')} (wanted {FORMAT_VERSION}, {step})")
        if state.opt is not None:
            # A step saved before the optimizer was named holds adam's.
            saved_kind = meta.get("optimizer", "adam")
            if saved_kind != state.opt.kind:
                raise CheckpointError(
                    f"step {step} holds {saved_kind} state; the optimizer "
                    f"is {state.opt.kind} (a restore across a change of "
                    f"--optimizer is refused)")
        saved = {fname: torch.load(os.path.join(root, fname),
                                   map_location="cpu", weights_only=True)
                 for fname in _parts(state)}
        named = [(PARAMS_FILE, "param", state.params)]
        if state.batch_stats:
            named.append((STATS_FILE, "batch stat", state.batch_stats))
        for fname, what, live_tensors in named:
            got = saved[fname]
            if set(got) != set(live_tensors):
                missing = sorted(set(live_tensors) - set(got))
                extra = sorted(set(got) - set(live_tensors))
                raise CheckpointError(f"{what}s differ from the model: "
                                      f"missing {missing[:4]}, extra "
                                      f"{extra[:4]}")
            for name, live in live_tensors.items():
                if got[name].shape != live.shape:
                    raise CheckpointError(
                        f"{what} {name}: saved shape "
                        f"{list(got[name].shape)}, model {list(live.shape)}")
        if state.opt is not None:
            state.opt.load_state_dict(saved[OPT_FILE])  # checks, then copies
        for fname, _what, live_tensors in named:
            for name, live in live_tensors.items():
                live.copy_(saved[fname][name])

    def restore(self, state: TrainState) -> Tuple[TrainState, int]:
        """``(state, start_step)``: the newest valid step agreed across the
        gang, copied into ``state`` in place, or ``state`` untouched at
        step 0 when nothing survives.

        The walk: sweep orphaned tmp dirs; verify newest -> quarantine
        failures -> gang-agree the MIN of everyone's newest intact step ->
        load it -> gang-confirm the load. A load that raises anywhere in
        the gang on bytes that do not verify quarantines the step there
        and the whole walk repeats together; on bytes that verify intact
        it raises."""
        reads = tuple(_parts(state)) + (META_FILE,)
        self._sweep_orphaned_tmp()
        t0 = time.perf_counter()
        verify_s = 0.0
        while True:
            tv = time.perf_counter()
            candidate = self._newest_intact_step(reads)
            verify_s += time.perf_counter() - tv
            agreed = self._agree(candidate)
            if agreed is None:
                # Every process sees the same None: no confirm round.
                if self.restore_fallbacks:
                    log.error(
                        "no valid checkpoint survives in %s (%d quarantined); "
                        "restarting from step 0", self.directory,
                        self.restore_fallbacks)
                return state, 0
            err: Optional[Exception] = None
            tl = time.perf_counter()
            try:
                self._load(int(agreed), state)
            except Exception as e:  # noqa: BLE001 — gang-confirmed below
                err = e
            load_s = time.perf_counter() - tl
            intact = err is not None and self._has_intact_manifest(
                int(agreed), reads)
            # Every process reaches this second collective each round,
            # success or failure, so the rounds stay paired gang-wide.
            confirmed = self._agree(agreed if err is None else None)
            if err is not None:
                if intact:
                    # The bytes verify against their manifest, so this is
                    # not corruption (a model of another width, another
                    # optimizer dtype): quarantining would condemn every
                    # resumable step in turn.
                    log.error(
                        "restore of step %d failed but its bytes verify "
                        "intact: not corruption; refusing to quarantine",
                        agreed)
                    raise err
                self.restore_fallbacks += 1
                self._quarantine(int(agreed), f"restore failed: {err}")
                continue
            if confirmed != agreed:
                # A peer's load of this step failed: re-agree together on
                # an older step instead of forking state.
                log.warning(
                    "restore of step %d succeeded locally but failed on a "
                    "peer; retrying the walk collectively", agreed)
                continue
            self._last_verified = self._last_saved = int(agreed)
            self.restore_timings = {
                "step": int(agreed), "verify_s": verify_s, "load_s": load_s,
                "total_s": time.perf_counter() - t0,
                "read_bytes": sum(os.path.getsize(os.path.join(
                    self._step_dir(int(agreed)), f)) for f in reads)}
            if candidate is not None and agreed != candidate:
                log.warning(
                    "gang agreed on step %d (local newest valid was %d)",
                    agreed, candidate)
            if self.restore_fallbacks:
                log.warning(
                    "restored checkpoint step %d from %s after %d "
                    "fallback(s)", agreed, self.directory,
                    self.restore_fallbacks)
            else:
                log.info("restored checkpoint step %d from %s", agreed,
                         self.directory)
            return state, int(agreed)

    # -- lifecycle -------------------------------------------------------------

    def close(self) -> None:
        """Flush and verify the in-flight save. Best-effort: escalation
        (SystemExit) belongs to the step loop, not to teardown; a
        completed run is not turned into a retryable exit by its final
        flush."""
        try:
            self._finalize_pending(block=True)
        except SystemExit:
            pass
        except Exception as e:  # noqa: BLE001
            log.warning("checkpoint flush on close failed: %s", e)


def from_env_or_args(checkpoint_dir: str = "", save_every: int = 100,
                     max_to_keep: int = 3,
                     fail_after: int = DEFAULT_FAIL_AFTER,
                     env: Optional[dict] = None) -> Optional[Checkpointer]:
    """A Checkpointer from an explicit flag, falling back to the
    operator-injected TPU_CHECKPOINT_DIR; None when neither is set. A
    remote warm-start store (``TPUJOB_STORE_URI``) is not ported yet: the
    job runs without one, as the reference does for a store it cannot
    use."""
    e = env if env is not None else os.environ
    directory = checkpoint_dir or e.get(ENV_VAR, "")
    if not directory:
        return None
    if e.get(ENV_STORE_URI):
        log.warning("%s is set, but the remote warm-start store is not "
                    "ported to the PyTorch payload yet (ROADMAP Queue A 3); "
                    "checkpointing to %s without it", ENV_STORE_URI,
                    directory)
    return Checkpointer(directory, save_every=save_every,
                        max_to_keep=max_to_keep, fail_after=fail_after)
