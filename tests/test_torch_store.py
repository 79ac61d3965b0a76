"""The PyTorch payload's warm-start store (``payload/store``,
``payload/warmstore.py``) against its reference (``tpu_operator/store``,
``tpu_operator/payload/warmstore.py``).

The reference's own payload-side tests, run on the port's copy: blob
backends, chunked transfer (resume, per-chunk verification, the manifest
as commit marker), the job-scoped store (the corrupt index, prefetch
fallback, local-quarantine parity, cache set-difference sync, retention),
the write-behind uploader, the env adapter and its rendezvous-overlapped
prefetch, and the checkpointer's use of the uploader. Then the wire: a
tree either payload uploads is read back by the other, and a beat that
carries the store's counters is accepted by the reference's status
server.
"""

import os
import time

import pytest
import torch

from tpu_operator.store import WarmStartStore as RefStore
from tpu_operator.store import blob as ref_blob
from tpu_operator_torch.payload import bootstrap
from tpu_operator_torch.payload import checkpoint
from tpu_operator_torch.payload import startup as startup_mod
from tpu_operator_torch.payload import warmstore
from tpu_operator_torch.payload.heartbeat import HeartbeatReporter
from tpu_operator_torch.payload.store import blob as blob_mod
from tpu_operator_torch.payload.store import transfer
from tpu_operator_torch.payload.store.blob import (BlobError, BlobNotFound,
                                                   FakeBackend,
                                                   LocalFSBackend)
from tpu_operator_torch.payload.store.warmstart import WarmStartStore
from tpu_operator_torch.payload.store.writebehind import WriteBehindUploader


@pytest.fixture(autouse=True)
def _reset_prefetch_state():
    warmstore.reset_prefetch()
    blob_mod.reset_fake_backends()
    yield
    warmstore.reset_prefetch()
    blob_mod.reset_fake_backends()


SAMPLE = {"a.bin": os.urandom(40_000), "sub/b.txt": b"hello", "empty": b""}


def tiny_state(step=0):
    """A one-tensor checkpoint state whose values encode the step."""
    w = torch.arange(64, dtype=torch.float32) + float(step)
    return checkpoint.TrainState({"w": w})


def write_tree(root, files):
    for rel, data in files.items():
        path = os.path.join(root, *rel.split("/"))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)


def read_tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            p = os.path.join(dirpath, fn)
            out[os.path.relpath(p, root).replace(os.sep, "/")] = \
                open(p, "rb").read()
    return out


def make_store(chunk=4096, backend=None):
    return WarmStartStore(backend or FakeBackend(), prefix="default/job",
                          chunk_size=chunk)


def test_localfs_roundtrip_and_key_safety(tmp_path):
    be = LocalFSBackend(str(tmp_path / "root"))
    be.put("x/y", b"one")
    assert be.get("x/y") == b"one"
    assert be.exists("x/y") and not be.exists("x/z")
    assert be.list("") == ["x/y"]
    be.delete("x/y")
    be.delete("x/y")  # idempotent
    assert not be.exists("x/y")
    with pytest.raises(BlobNotFound):
        be.get("x/y")
    for bad in ("", "/abs", "a/../b", "a//b", "."):
        with pytest.raises(BlobError):
            be.put(bad, b"nope")


def test_fake_backend_latency_faults_and_counters():
    boom = {"arm": False}

    def fault(op, _key):
        if boom["arm"] and op == "put":
            raise BlobError("injected")

    slept = []
    be = FakeBackend(latency=0.5, fault_hook=fault, sleep=slept.append)
    be.put("k", b"v")
    assert be.get("k") == b"v"
    assert slept == [0.5, 0.5]
    assert be.op_counts["put"] == 1 and be.op_counts["get"] == 1
    boom["arm"] = True
    with pytest.raises(BlobError):
        be.put("k2", b"v2")
    be.corrupt_once("k")
    assert be.get("k") != b"v"   # one poisoned read...
    assert be.get("k") == b"v"   # ...then healthy again


def test_from_uri_schemes(tmp_path):
    assert isinstance(blob_mod.from_uri(str(tmp_path)), LocalFSBackend)
    assert isinstance(blob_mod.from_uri(f"file://{tmp_path}"),
                      LocalFSBackend)
    # fake:// is a process-shared registry: same name = same instance.
    assert blob_mod.from_uri("fake://t1") is blob_mod.from_uri("fake://t1")
    assert blob_mod.from_uri("fake://t1") is not blob_mod.from_uri("fake://t2")
    # Cloud schemes are GATED, not vendored: a clear error naming the
    # registration hook, never an SDK import error at job runtime.
    with pytest.raises(BlobError, match="register_backend"):
        blob_mod.from_uri("gs://bucket/prefix")
    blob_mod.register_backend("gs", lambda uri: FakeBackend())
    assert isinstance(blob_mod.from_uri("gs://bucket/prefix"), FakeBackend)


def test_upload_download_roundtrip_multichunk(tmp_path):
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    write_tree(src, SAMPLE)
    be = FakeBackend()
    manifest = transfer.upload_tree(be, src, "snap", chunk_size=4096)
    assert {f["path"] for f in manifest["files"]} == set(SAMPLE)
    big = next(f for f in manifest["files"] if f["path"] == "a.bin")
    assert len(big["chunks"]) == 10  # 40000 / 4096 rounded up
    transfer.download_tree(be, "snap", dst)
    assert read_tree(dst) == SAMPLE
    # Idempotent re-download into the same dir (the gang-shared-fs case).
    gets_before = be.op_counts.get("get", 0)
    transfer.download_tree(be, "snap", dst)
    # Only the manifest is re-read; matching local files skip their chunks.
    assert be.op_counts.get("get", 0) == gets_before + 1


def test_torn_upload_resume_skips_committed_chunks(tmp_path):
    src = str(tmp_path / "src")
    write_tree(src, SAMPLE)
    state = {"puts": 0}

    def fault(op, key):
        if op == "put" and state["puts"] >= 4 and "manifest" not in key:
            raise BlobError("torn: remote went away mid-upload")

    be = FakeBackend(fault_hook=fault)

    def count_put(op, key):
        if op == "put":
            state["puts"] += 1
        fault(op, key)

    be.fault_hook = count_put
    with pytest.raises(BlobError):
        transfer.upload_tree(be, src, "snap", chunk_size=4096,
                             parallelism=1)
    assert not be.exists("snap/" + transfer.MANIFEST_KEY)  # not committed
    landed = len(be.list("snap/"))
    assert landed == 3  # the 4th put died mid-flight
    be.fault_hook = None
    puts_before = be.op_counts.get("put", 0)
    transfer.upload_tree(be, src, "snap", chunk_size=4096, parallelism=1)
    # Resume re-puts only the missing tail + the manifest: chunk keys are
    # content-addressed, so exists == provably-identical bytes.
    total_chunks = sum(
        len(f["chunks"])
        for f in transfer.read_manifest(be, "snap")["files"])
    assert be.op_counts["put"] - puts_before == total_chunks - landed + 1


def test_chunk_corruption_retries_once_then_fails(tmp_path):
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    write_tree(src, SAMPLE)
    be = FakeBackend()
    transfer.upload_tree(be, src, "snap", chunk_size=4096)
    chunk_key = be.list("snap/data/a.bin/")[0]
    # Transient: one poisoned read, the retry sees healthy bytes.
    be.corrupt_once(chunk_key)
    transfer.download_tree(be, "snap", dst)
    assert read_tree(dst) == SAMPLE
    # Permanent: retry also fails → IntegrityError, never silent bad bytes.
    be.corrupt(chunk_key)
    with pytest.raises(transfer.IntegrityError):
        transfer.download_tree(be, "snap", str(tmp_path / "dst2"))


def test_manifest_is_the_commit_marker(tmp_path):
    src = str(tmp_path / "src")
    write_tree(src, SAMPLE)
    be = FakeBackend()
    transfer.upload_tree(be, src, "snap", chunk_size=4096)
    be.delete("snap/" + transfer.MANIFEST_KEY)
    with pytest.raises(BlobNotFound):
        transfer.download_tree(be, "snap", str(tmp_path / "dst"))


def test_warmstore_checkpoint_roundtrip(tmp_path):
    step_dir = str(tmp_path / "ck" / "5")
    write_tree(step_dir, SAMPLE)
    ws = make_store()
    ws.upload_checkpoint(step_dir, 5)
    assert ws.checkpoint_steps() == [5]
    assert ws.last_uploaded_step() == 5
    fresh = str(tmp_path / "fresh")
    step, fallbacks = ws.prefetch_checkpoint(fresh)
    assert (step, fallbacks) == (5, 0)
    assert read_tree(os.path.join(fresh, "5")) == SAMPLE


def test_mark_corrupt_hides_step_and_prefetch_falls_back(tmp_path):
    step_dir = str(tmp_path / "sd")
    write_tree(step_dir, SAMPLE)
    ws = make_store()
    ws.upload_checkpoint(step_dir, 3)
    ws.upload_checkpoint(step_dir, 7)
    ws.mark_corrupt(7, "local quarantine")
    assert ws.checkpoint_steps() == [3]
    step, _ = ws.prefetch_checkpoint(str(tmp_path / "fresh"))
    assert step == 3
    # Idempotent re-mark is fine.
    ws.mark_corrupt(7)


def test_prefetch_never_prefers_locally_quarantined_step(tmp_path):
    """A step the LOCAL walk condemned
    (``<step>.corrupt-N``) must never be re-materialized from the remote —
    and prefetch pushes the condemnation back to the remote index."""
    step_dir = str(tmp_path / "sd")
    write_tree(step_dir, SAMPLE)
    ws = make_store()
    ws.upload_checkpoint(step_dir, 4)
    ws.upload_checkpoint(step_dir, 8)
    local = str(tmp_path / "local")
    os.makedirs(os.path.join(local, "8.corrupt-0"))
    step, _ = ws.prefetch_checkpoint(local)
    assert step == 4
    assert not os.path.exists(os.path.join(local, "8"))
    # The local verdict propagated: the remote index now condemns 8 too,
    # so even a TRULY fresh node (no quarantine dir) never restores it.
    assert ws.checkpoint_steps() == [4]
    step, _ = ws.prefetch_checkpoint(str(tmp_path / "fresh"))
    assert step == 4


def test_fresh_upload_clears_stale_corrupt_marker(tmp_path):
    """A re-SAVED step must not stay condemned by its predecessor's
    marker: quarantine step N → resume from N-k → replay → a newly
    verified step N uploads — prefetch must prefer it again, or the job
    replays the same k steps after every preemption forever while
    heartbeats advertise N as remotely durable."""
    step_dir = str(tmp_path / "sd")
    write_tree(step_dir, SAMPLE)
    ws = make_store()
    ws.upload_checkpoint(step_dir, 90)
    ws.upload_checkpoint(step_dir, 100)
    ws.mark_corrupt(100, "failed local verification")
    assert ws.checkpoint_steps() == [90]
    # The replayed attempt re-saves a NEW verified step 100 and ships it.
    ws.upload_checkpoint(step_dir, 100)
    assert ws.checkpoint_steps() == [90, 100]
    step, _ = ws.prefetch_checkpoint(str(tmp_path / "fresh"))
    assert step == 100


def test_prefetch_integrity_fallback_next_oldest(tmp_path):
    step_dir = str(tmp_path / "sd")
    write_tree(step_dir, SAMPLE)
    be = FakeBackend()
    ws = make_store(backend=be)
    ws.upload_checkpoint(step_dir, 1)
    ws.upload_checkpoint(step_dir, 2)
    be.corrupt(be.list("default/job/checkpoints/2/data/a.bin/")[0])
    fresh = str(tmp_path / "fresh")
    step, fallbacks = ws.prefetch_checkpoint(fresh)
    assert (step, fallbacks) == (1, 1)
    # The torn partial materialization was scrubbed — the local verified
    # walk must never see a manifest-less step dir candidate.
    assert not os.path.exists(os.path.join(fresh, "2"))
    assert ws.checkpoint_steps() == [1]  # condemned remotely


def test_prefetch_never_exposes_partial_step_dir(tmp_path):
    """The restore walk must never observe a half-materialized step: the
    download stages under a non-numeric name and renames the COMPLETE
    dir into place — a torn step dir seen by the restore walk would be
    quarantined locally and condemned remotely, destroying a healthy
    snapshot (the timed-out-prefetch race)."""
    step_dir = str(tmp_path / "sd")
    write_tree(step_dir, SAMPLE)
    be = FakeBackend()
    ws = make_store(backend=be)
    ws.upload_checkpoint(step_dir, 5)
    gets = {"n": 0}

    def die_mid_download(op, _key):
        if op == "get":
            gets["n"] += 1
            if gets["n"] > 2:
                raise BlobError("network blip mid-download")

    be.fault_hook = die_mid_download
    local = str(tmp_path / "local")
    with pytest.raises(BlobError):
        ws.prefetch_checkpoint(local)
    # No numeric step dir AND no staging leftovers: the walk sees nothing.
    assert os.listdir(local) == []
    be.fault_hook = None
    step, _ = ws.prefetch_checkpoint(local)
    assert step == 5
    assert read_tree(os.path.join(local, "5")) == SAMPLE


def test_store_from_env_unusable_localfs_proceeds_storeless(tmp_path):
    """An unmounted/read-only store root raises OSError (not BlobError)
    from LocalFSBackend's makedirs — the env adapter must swallow it and
    run store-less, never crash the attempt into a permanent failure."""
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("file, not a mount")
    env = {"TPUJOB_STORE_URI": str(blocker / "warmstore"),
           "TPUJOB_NAME": "jb"}
    assert warmstore.store_from_env(env) is None
    assert warmstore.uploader_from_env(env) is None


def test_cache_sync_is_set_difference(tmp_path):
    cache_a = str(tmp_path / "ca")
    write_tree(cache_a, {"e1-cache": b"x1", "e2-cache": b"x2"})
    be = FakeBackend()
    ws = make_store(backend=be)
    assert ws.upload_cache(cache_a) == 2
    assert ws.upload_cache(cache_a) == 0  # content-named: exists == same
    write_tree(cache_a, {"e3-cache": b"x3"})
    assert ws.upload_cache(cache_a) == 1
    cache_b = str(tmp_path / "cb")
    write_tree(cache_b, {"e1-cache": b"x1"})
    assert ws.prefetch_cache(cache_b) == 2  # only the missing two
    assert read_tree(cache_b) == {"e1-cache": b"x1", "e2-cache": b"x2",
                                  "e3-cache": b"x3"}


def test_writebehind_uploads_and_coalesces(tmp_path):
    step_dir = str(tmp_path / "sd")
    write_tree(step_dir, {"f": b"data"})
    be = FakeBackend(latency=0.05)
    up = WriteBehindUploader(WarmStartStore(be, prefix="p"), fail_after=3)
    try:
        for step in (1, 2, 3):
            up.enqueue(step, step_dir)
        assert up.flush(10.0)
        assert up.last_uploaded_step == 3
        ws = WarmStartStore(be, prefix="p")
        # 3 enqueued at save cadence faster than the slow remote: only the
        # newest pending step per drain cycle ships (last-wins).
        assert 3 in ws.checkpoint_steps()
        assert up.stats()["lastUploadedStep"] == 3
        assert up.stats()["uploadFailures"] == 0
    finally:
        up.close()


def test_writebehind_failure_escalation_counters(tmp_path):
    step_dir = str(tmp_path / "sd")
    write_tree(step_dir, {"f": b"data"})

    def fault(_op, _key):
        raise BlobError("remote down")

    up = WriteBehindUploader(
        WarmStartStore(FakeBackend(fault_hook=fault), prefix="p"),
        fail_after=2)
    try:
        assert not up.escalated()
        up.enqueue(1, step_dir)
        up.flush(5.0)
        assert up.upload_failures == 1 and not up.escalated()
        up.enqueue(2, step_dir)
        up.flush(5.0)
        assert up.escalated()
        assert up.stats()["uploadFailures"] == 2
    finally:
        up.close()


def test_writebehind_cache_sync_survives_failed_checkpoint_upload(tmp_path):
    """Cache entries compiled this attempt ship even when the checkpoint
    snapshot fails to upload — a broken upload must not ALSO forfeit the
    fresh-node warm compile."""
    step_dir = str(tmp_path / "sd")
    write_tree(step_dir, {"f": b"data"})
    cache_dir = str(tmp_path / "cache")
    write_tree(cache_dir, {"jit_a-cache": b"exe"})

    def fault(op, key):
        if op == "put" and "checkpoints/" in key:
            raise BlobError("snapshot uploads broken")

    be = FakeBackend(fault_hook=fault)
    up = WriteBehindUploader(WarmStartStore(be, prefix="p"),
                             fail_after=1_000,
                             cache_dir_fn=lambda: cache_dir)
    try:
        up.enqueue(1, step_dir)
        assert up.flush(10.0)
        assert up.upload_failures == 1
        assert up.cache_files_uploaded == 1
        assert WarmStartStore(be, prefix="p").prefetch_cache(
            str(tmp_path / "fresh")) == 1
    finally:
        up.close()


def test_upload_cache_once_for_checkpointless_jobs(tmp_path):
    """Jobs with a store but NO checkpointing never build an uploader;
    the bootstrap exit hook still ships their compiled executables."""
    cache_dir = str(tmp_path / "cache")
    write_tree(cache_dir, {"jit_z-cache": b"exe"})
    env = {"TPUJOB_STORE_URI": "fake://exitpath", "TPUJOB_NAMESPACE": "ns",
           "TPUJOB_NAME": "jb", "JAX_COMPILATION_CACHE_DIR": cache_dir}
    assert warmstore.upload_cache_once(env) == 1
    assert warmstore.upload_cache_once(env) == 0  # set-difference
    ws = WarmStartStore(blob_mod.fake_backend("exitpath"), prefix="ns/jb")
    assert ws.prefetch_cache(str(tmp_path / "fresh")) == 1
    # Not process 0 / no store: no-op.
    assert warmstore.upload_cache_once(
        {**env, "JAX_PROCESS_ID": "2"}) == 0
    assert warmstore.upload_cache_once(
        {"JAX_COMPILATION_CACHE_DIR": cache_dir}) == 0


def test_upload_cache_once_ignores_ambient_cache_global(tmp_path):
    """An explicit env mapping is the caller's whole contract: the
    module-level cache dir (what bootstrap enabled in THIS process) must
    not leak into it, or one test's enable_compilation_cache() would
    pollute a later explicit-env upload."""
    cache_dir = str(tmp_path / "cache")
    write_tree(cache_dir, {"jit_a": b"x"})
    ambient = str(tmp_path / "ambient")
    write_tree(ambient, {"jit_b": b"y", "jit_c": b"z"})
    startup_mod.set_cache_dir(ambient)
    try:
        env = {"TPUJOB_STORE_URI": "fake://ambient-leak",
               "TPUJOB_NAMESPACE": "ns", "TPUJOB_NAME": "jb",
               "JAX_COMPILATION_CACHE_DIR": cache_dir}
        # exactly the env's one entry — never the ambient dir's two
        assert warmstore.upload_cache_once(env) == 1
    finally:
        startup_mod.set_cache_dir("")


def test_writebehind_ships_artifacts(tmp_path):
    """Postmortem step-trace dumps ride the same async worker as
    checkpoints: enqueue_artifact never blocks, the file lands under the
    job's artifacts/ prefix, and an upload failure is logged — never
    counted toward the escalation streak (a postmortem aid must not
    convert a retryable exit into a failed remote)."""
    art = tmp_path / "steptrace-attempt1-p0.json"
    art.write_text('{"kind": "tpujob-steptrace", "steps": []}')
    ws = WarmStartStore(FakeBackend(), prefix="ns/aj")
    up = WriteBehindUploader(ws)
    try:
        up.enqueue_artifact(str(art))
        assert up.flush(timeout=10.0)
        assert ws.list_artifacts() == ["steptrace-attempt1-p0.json"]
        # a missing file fails the upload quietly, without escalation
        up.enqueue_artifact(str(tmp_path / "gone.json"))
        assert up.flush(timeout=10.0)
        assert up.consecutive_failures == 0 and not up.escalated()
    finally:
        up.close()


def test_writebehind_enqueue_never_blocks(tmp_path):
    step_dir = str(tmp_path / "sd")
    write_tree(step_dir, {"f": os.urandom(10_000)})
    up = WriteBehindUploader(
        WarmStartStore(FakeBackend(latency=0.3), prefix="p"))
    try:
        t0 = time.perf_counter()
        up.enqueue(1, step_dir)
        up.mark_corrupt(99)
        assert time.perf_counter() - t0 < 0.1  # never touches the backend
        assert up.flush(15.0)
    finally:
        up.close()


def test_store_from_env_and_process_zero_uploader():
    assert warmstore.store_from_env({}) is None
    env = {"TPUJOB_STORE_URI": "fake://adapter", "TPUJOB_NAMESPACE": "ns",
           "TPUJOB_NAME": "jb", "TPUJOB_STORE_PARALLELISM": "2"}
    ws = warmstore.store_from_env(env)
    assert ws is not None and ws.prefix == "ns/jb"
    assert ws.upload_parallelism == 2
    # Malformed URI disables the store instead of failing the attempt.
    assert warmstore.store_from_env(
        {"TPUJOB_STORE_URI": "weird://nope"}) is None
    up = warmstore.uploader_from_env(env)
    assert up is not None
    up.close()
    # Only process 0 uploads (single remote writer, like the manifest).
    assert warmstore.uploader_from_env(
        {**env, "JAX_PROCESS_ID": "3"}) is None


def test_prefetch_records_startup_stage(tmp_path):
        
    # Seed the shared fake store with a checkpoint + a cache entry.
    sd = str(tmp_path / "sd")
    write_tree(sd, SAMPLE)
    ws = WarmStartStore(blob_mod.fake_backend("pf"), prefix="ns/jb")
    ws.upload_checkpoint(sd, 6)
    cache_src = str(tmp_path / "cs")
    write_tree(cache_src, {"jit_x-cache": b"exe"})
    ws.upload_cache(cache_src)

    cache_dir = str(tmp_path / "cache")
    ckpt_dir = str(tmp_path / "ckpt")
    env = {"TPUJOB_STORE_URI": "fake://pf", "TPUJOB_NAMESPACE": "ns",
           "TPUJOB_NAME": "jb", "JAX_COMPILATION_CACHE_DIR": cache_dir,
           "TPU_CHECKPOINT_DIR": ckpt_dir}
    assert warmstore.start_prefetch(env)
    result = warmstore.finish_prefetch(timeout=30.0)
    assert result["checkpointStep"] == 6
    assert result["cacheFiles"] == 1
    tracker = startup_mod.new_tracker()
    bd = tracker.breakdown()
    assert bd.get("prefetchHit") is True
    assert "prefetchSeconds" in bd
    assert os.path.isfile(os.path.join(cache_dir, "jit_x-cache"))
    assert os.path.isdir(os.path.join(ckpt_dir, "6"))
    # Disabled prefetch / unwired store: no thread, no stage.
    warmstore.reset_prefetch()
    assert not warmstore.start_prefetch({**env, "TPUJOB_STORE_PREFETCH": "0"})
    assert not warmstore.start_prefetch({})


def test_prefetch_miss_records_false(tmp_path):
        
    env = {"TPUJOB_STORE_URI": "fake://coldpf", "TPUJOB_NAMESPACE": "ns",
           "TPUJOB_NAME": "jb",
           "TPU_CHECKPOINT_DIR": str(tmp_path / "ck")}
    assert warmstore.start_prefetch(env)
    result = warmstore.finish_prefetch(timeout=30.0)
    assert result["checkpointStep"] is None
    assert startup_mod.new_tracker().breakdown()["prefetchHit"] is False


def test_checkpointer_uploads_verified_saves(tmp_path):
    be = FakeBackend()
    up = WriteBehindUploader(WarmStartStore(be, prefix="p"), fail_after=3)
    ck = checkpoint.Checkpointer(str(tmp_path / "ck"), save_every=1,
                                 uploader=up)
    ck.maybe_save(1, tiny_state(1))
    ck.maybe_save(2, tiny_state(2))
    ck.flush()
    assert up.flush(30.0)
    stats = ck.stats()
    assert stats["lastCheckpointStep"] == 2
    assert stats["lastUploadedStep"] == 2
    assert stats["uploadFailures"] == 0
    assert 2 in WarmStartStore(be, prefix="p").checkpoint_steps()
    ck.close()


def test_checkpointer_upload_escalation_exits_retryable(tmp_path):
        
    def fault(_op, _key):
        raise BlobError("remote persistently down")

    up = WriteBehindUploader(
        WarmStartStore(FakeBackend(fault_hook=fault), prefix="p"),
        fail_after=2)
    ck = checkpoint.Checkpointer(str(tmp_path / "ck"), save_every=1,
                                 uploader=up)
    # Saves stay locally healthy while the remote fails; once the streak
    # reaches fail_after, the NEXT save boundary escalates retryably —
    # exactly the local save-failure contract.
    step = 1
    with pytest.raises(SystemExit) as exc:
        for step in range(1, 20):
            ck.maybe_save(step, tiny_state(step))
            ck.flush()
            up.flush(10.0)
    assert exc.value.code == bootstrap.EXIT_RETRYABLE
    assert step >= 2  # never on the first transient failure
    ck.close()


def test_writebehind_stays_off_the_step_path(tmp_path):
    """The step-loop side of the non-blocking contract at Checkpointer
    granularity: with a 300 ms/op remote, interval saves must not slow
    down measurably vs no store at all."""
    up = WriteBehindUploader(
        WarmStartStore(FakeBackend(latency=0.3), prefix="p"))
    ck = checkpoint.Checkpointer(str(tmp_path / "ck"), save_every=1,
                                 uploader=up)
    ck.maybe_save(1, tiny_state(1))
    ck.flush()  # local verify done; upload now pending in background
    t0 = time.perf_counter()
    ck.maybe_save(2, tiny_state(2))
    ck.flush()
    assert time.perf_counter() - t0 < 2.0
    ck.close()


def test_heartbeat_body_carries_store_fields():
    posts = []
    rep = HeartbeatReporter("http://x", "job", poster=lambda _u, b:
                            posts.append(b))
    rep.report(5, {}, checkpoint={"saveFailures": 0, "restoreFallbacks": 0,
                                  "lastCheckpointStep": 4,
                                  "lastUploadedStep": 3,
                                  "uploadFailures": 2})
    assert posts[0]["storeLastUploadedStep"] == 3
    assert posts[0]["storeUploadFailures"] == 2


def test_retain_keeps_newest_n_marker_first(tmp_path):
    """retain(2) removes every verified snapshot but the newest two —
    condemn-then-delete, MARKER-FIRST: the victim's
    .corrupt marker must land before any of its objects is deleted, and
    the marker itself is removed once the tree is gone (a GC'd step is
    absence, not quarantine — markers must not accumulate)."""
    step_dir = str(tmp_path / "sd")
    write_tree(step_dir, SAMPLE)
    be = FakeBackend()
    ws = WarmStartStore(be, prefix="p", chunk_size=4096)
    for step in (1, 2, 3, 4):
        ws.upload_checkpoint(step_dir, step)
    removed = ws.retain(2)
    assert removed == 2
    assert ws.checkpoint_steps() == [3, 4]
    # No stray markers: a later prefetch sees clean absence.
    assert not [k for k in be.list("p/checkpoints/")
                if k.endswith(".corrupt")]
    # Survivors intact: a fresh node prefetches the newest.
    step, fallbacks = ws.prefetch_checkpoint(str(tmp_path / "fresh"))
    assert (step, fallbacks) == (4, 0)
    # Idempotent: nothing more to remove.
    assert ws.retain(2) == 0
    # keep <= 0 = keep everything (the default, pre-GC behavior).
    assert ws.retain(0) == 0


def test_retain_op_order_marker_before_delete(tmp_path):
    """Op-count/op-order proof on the fake backend: for each victim the
    marker PUT precedes every DELETE of the victim's objects, and the
    final op on the victim is the marker's own delete."""
    step_dir = str(tmp_path / "sd")
    write_tree(step_dir, {"w.bin": b"x" * 100})
    be = FakeBackend()
    ws = WarmStartStore(be, prefix="p", chunk_size=4096)
    ws.upload_checkpoint(step_dir, 1)
    ws.upload_checkpoint(step_dir, 2)
    puts_before = be.op_counts.get("put", 0)
    deletes_before = be.op_counts.get("delete", 0)
    objects_of_1 = [k for k in be.list("p/checkpoints/1/")]
    assert ws.retain(1) == 1
    # Exactly one marker put; deletes = victim's objects + the marker.
    assert be.op_counts.get("put", 0) - puts_before == 1
    assert (be.op_counts.get("delete", 0) - deletes_before
            == len(objects_of_1) + 1)
    assert be.list("p/checkpoints/1/") == []


def test_writebehind_retention_runs_after_commit(tmp_path):
    """The write-behind worker GCs AFTER each successful upload (never
    on failure, never on the step loop): keepSnapshots=2 holds the
    remote tree at the newest two as commits stream."""
    step_dir = str(tmp_path / "sd")
    write_tree(step_dir, {"w.bin": b"y" * 64})
    be = FakeBackend()
    ws = WarmStartStore(be, prefix="p", chunk_size=4096)
    up = WriteBehindUploader(ws, keep_snapshots=2)
    try:
        for step in (10, 20, 30):
            up.enqueue(step, step_dir)
            assert up.flush(10.0)
        assert ws.checkpoint_steps() == [20, 30]
        assert up.gc_removed == 1
    finally:
        up.close()


def test_uploader_from_env_wires_keep(tmp_path):
    env = {"TPUJOB_STORE_URI": f"fake://keep-{os.getpid()}",
           "TPUJOB_STORE_BACKEND": "fake",
           "TPUJOB_STORE_KEEP": "3",
           "TPUJOB_NAMESPACE": "default", "TPUJOB_NAME": "kj",
           "JAX_PROCESS_ID": "0"}
    up = warmstore.uploader_from_env(env)
    try:
        assert up is not None and up.keep_snapshots == 3
    finally:
        up.close()
    # Malformed keep degrades to 0 (keep all), never kills the payload.
    up2 = warmstore.uploader_from_env({**env, "TPUJOB_STORE_KEEP": "lots"})
    try:
        assert up2 is not None and up2.keep_snapshots == 0
    finally:
        up2.close()



def test_quarantine_condemns_remote_copy(tmp_path):
    """A step uploaded remotely and later quarantined by the local restore
    walk is condemned in the remote index: a fresh node's prefetch never
    prefers it."""
    be = FakeBackend()
    up = WriteBehindUploader(WarmStartStore(be, prefix="p"), fail_after=3)
    ck = checkpoint.Checkpointer(str(tmp_path / "ck"), save_every=1,
                                 uploader=up)
    # Each step uploads before the next is saved: a step still pending
    # when the next arrives is superseded by design (last-wins), which a
    # loaded machine can reach.
    for step in (1, 2):
        ck.maybe_save(step, tiny_state(step))
        ck.flush()
        assert up.flush(30.0)
    assert WarmStartStore(be, prefix="p").checkpoint_steps() == [1, 2]
    ck.close()
    victim = tmp_path / "ck" / "2" / checkpoint.PARAMS_FILE
    data = bytearray(victim.read_bytes())
    data[len(data) // 2] ^= 0xFF
    victim.write_bytes(bytes(data))
    up2 = WriteBehindUploader(WarmStartStore(be, prefix="p"), fail_after=3)
    reader = checkpoint.Checkpointer(str(tmp_path / "ck"), save_every=1,
                                     uploader=up2)
    _state, start = reader.restore(tiny_state())
    assert start == 1 and reader.restore_fallbacks == 1
    assert up2.flush(30.0)
    reader.close()
    assert WarmStartStore(be, prefix="p").checkpoint_steps() == [1]


def _port_store(root):
    return WarmStartStore(blob_mod.from_uri(str(root)), prefix="ns/jb",
                          chunk_size=4096)


def _ref_store(root):
    return RefStore(ref_blob.from_uri(str(root)), prefix="ns/jb",
                    chunk_size=4096)


@pytest.mark.parametrize("writer,reader", [
    (_port_store, _ref_store), (_ref_store, _port_store)],
    ids=["port_writes", "reference_writes"])
def test_a_tree_one_payload_writes_the_other_reads(tmp_path, writer,
                                                   reader):
    """Same keys, chunking, manifest and markers: checkpoints, the
    corrupt index, cache entries and artifacts written through one
    implementation read back through the other, byte for byte."""
    root = tmp_path / "bucket"
    step_dir = str(tmp_path / "sd")
    write_tree(step_dir, SAMPLE)
    cache = str(tmp_path / "cache")
    write_tree(cache, {"kernels/libkernels-ab.so": b"\x7fELF" * 99,
                       "kernels/libkernels-ab.sha256": b"f00d\n"})
    art = tmp_path / "profile-x.json"
    art.write_text('{"kind": "tpujob-profile"}')
    w = writer(root)
    w.upload_checkpoint(step_dir, 3)
    w.upload_checkpoint(step_dir, 5)
    w.upload_checkpoint(step_dir, 7)
    w.mark_corrupt(7, "quarantined")
    assert w.upload_cache(cache) == 2
    w.upload_artifact(str(art), art.name)
    r = reader(root)
    assert r.checkpoint_steps() == [3, 5]
    assert r.last_uploaded_step() == 5
    fresh = str(tmp_path / "fresh")
    assert r.prefetch_checkpoint(fresh) == (5, 0)
    assert read_tree(os.path.join(fresh, "5")) == SAMPLE
    fresh_cache = str(tmp_path / "fresh_cache")
    assert r.prefetch_cache(fresh_cache) == 2
    assert read_tree(fresh_cache) == read_tree(cache)
    assert r.list_artifacts() == [art.name]
    assert r.retain(1) == 1 and w.checkpoint_steps() == [5]


def test_store_beat_passes_the_reference_status_server():
    """The store's counters on the port's beat (storeLastUploadedStep,
    storeUploadFailures) pass the reference server's door: a standby
    refuses it as standby, never as a bad body."""
    from tpu_operator.controller.statusserver import Metrics, StatusServer

    posts = []
    rep = HeartbeatReporter("http://x", "job",
                            poster=lambda _u, b: posts.append(b) or {})
    rep.report(5, {"loss": 1.0},
               checkpoint={"saveFailures": 0, "restoreFallbacks": 0,
                           "lastCheckpointStep": 4, "lastUploadedStep": 3,
                           "uploadFailures": 2})
    server = StatusServer(0, metrics=Metrics())
    server.start()
    try:
        ok, msg = server.record_heartbeat(posts[0])
        assert not ok and msg.startswith("standby"), msg
        bad = dict(posts[0], storeUploadFailures=-1)
        ok, msg = server.record_heartbeat(bad)
        assert not ok and "negative" in msg
    finally:
        server.stop()
