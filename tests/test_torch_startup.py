"""The PyTorch payload's warm restart on the CPU: the startup tracker
(``payload/startup.py``) against the reference's names, the kernel
library as the compilation cache (``kernels/build.py``, with a stub
compiler in place of nvcc), the cache through the warm-start store,
bootstrap's cache and rendezvous records, and ``train_loop``'s overlapped
prologue and startup beats, held to the reference's status server.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from tpu_operator.controller.statusserver import Metrics, StatusServer
from tpu_operator.payload import startup as jstartup
from tpu_operator_torch.kernels import build
from tpu_operator_torch.payload import bootstrap
from tpu_operator_torch.payload import checkpoint
from tpu_operator_torch.payload import cifar
from tpu_operator_torch.payload import heartbeat
from tpu_operator_torch.payload import startup
from tpu_operator_torch.payload import train
from tpu_operator_torch.payload import transformer
from tpu_operator_torch.payload import warmstore
from tpu_operator_torch.payload.store import WarmStartStore, blob

TINY = ["--dim", "64", "--layers", "2", "--heads", "4", "--kv-heads", "2",
        "--vocab", "256", "--seq-len", "64", "--batch", "4",
        "--grad-accum", "2", "--log-every", "0", "--seed", "0",
        "--checkpoint-dir", "", "--profile-dir", "", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _clean_process_state(monkeypatch):
    """Each test starts with no per-process startup record in either
    implementation: a rendezvous recorded by an earlier test in this
    process (``bootstrap.initialize``) would seed every new tracker."""
    for name in ("_rendezvous_seconds", "_prefetch_seconds",
                 "_prefetch_hit"):
        monkeypatch.setattr(jstartup, name, None)
    bootstrap.reset_drain()
    warmstore.reset_prefetch()
    startup.reset()
    yield
    bootstrap.reset_drain()
    warmstore.reset_prefetch()
    startup.reset()


# --- the tracker ---------------------------------------------------------------


def test_stage_names_and_fields_equal_the_reference():
    """The status server and the schema import these from the reference;
    the port's beats must carry the same names letter for letter."""
    assert startup.STAGES == jstartup.STAGES
    assert startup.STAGE_FIELDS == jstartup.STAGE_FIELDS
    for name in ("RENDEZVOUS", "PREFETCH", "RESTORE", "COMPILE",
                 "FIRST_STEP"):
        assert getattr(startup, name) == getattr(jstartup, name)


def test_tracker_times_overlapping_stages_and_the_breakdown():
    """Overlapping stages are timed on their own, the innermost in-flight
    one is current, a re-entered stage keeps its longest duration, and
    the breakdown carries the wire fields of the stages timed. The same
    clock through the reference's tracker gives the same breakdown."""
    def drive(mod):
        ticks = iter(float(x) for x in range(100))
        tr = mod.StartupTracker(clock=lambda: next(ticks))
        with tr.stage(mod.RESTORE):
            with tr.stage(mod.COMPILE):
                assert tr.current_stage() == mod.COMPILE
            assert tr.current_stage() == mod.RESTORE
        with tr.stage(mod.RESTORE):
            pass
        with tr.stage(mod.FIRST_STEP):
            pass
        assert tr.current_stage() is None
        tr.cache_hit = True
        return tr.breakdown()

    ours = drive(startup)
    assert ours == drive(jstartup)
    assert ours == {"restoreSeconds": 3.0, "compileSeconds": 1.0,
                    "firstStepSeconds": 1.0, "cacheHit": True}


def test_a_rendezvous_recorded_earlier_does_not_seed_the_next_tracker():
    """``bootstrap.initialize`` records the rendezvous in module state
    (0.0 for a one-process job); the fixture's reset clears it, so a test
    that runs after one that initialized sees a tracker with no
    ``rendezvousSeconds``."""
    bootstrap.initialize(bootstrap.process_info_from_env({}), device="cpu")
    assert startup.new_tracker().breakdown() == {"rendezvousSeconds": 0.0}
    startup.reset()
    assert "rendezvousSeconds" not in startup.new_tracker().breakdown()
    assert startup.cache_dir() == ""


def test_kernel_loads_without_nvcc_count_as_cache_hits():
    before = startup.cache_hit_count()
    startup.record_kernel_load(ran_nvcc=True)
    assert startup.cache_hit_count() == before
    startup.record_kernel_load(ran_nvcc=False)
    assert startup.cache_hit_count() == before + 1


# --- the kernel library as the compilation cache ------------------------------


class StubCompiler:
    """Stands in for nvcc: writes ``payload`` as the library."""

    def __init__(self, payload=b"\x7fELF stub kernel library"):
        self.payload = payload
        self.calls = 0

    def __call__(self, out, log_file):
        self.calls += 1
        out.write_bytes(self.payload)
        log_file.write_text("stub build\n")


def test_a_verified_library_loads_with_no_build(tmp_path):
    """The first build writes the library under its digest's name with
    the sha256 of its bytes beside it; the next call finds it verified
    and builds nothing: the cache hit."""
    stub = StubCompiler()
    path = build.build(tmp_path, compiler=stub)
    assert path.name == build.lib_name(build.source_digest())
    assert path.read_bytes() == stub.payload and build.verified(path)
    assert stub.calls == 1
    assert build.build(tmp_path, compiler=stub) == path
    assert stub.calls == 1
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


@pytest.mark.parametrize("damage", ["corrupt_library", "torn_library",
                                    "wrong_sha256", "sha256_lost"])
def test_a_library_that_fails_verification_is_rebuilt_never_loaded(
        tmp_path, damage):
    """Bytes that do not hash to the recorded sha256, or no record at
    all, mean a rebuild from the sources: the damaged bytes are never
    returned."""
    stub = StubCompiler()
    path = build.build(tmp_path, compiler=stub)
    stamp = path.with_suffix(".sha256")
    if damage == "corrupt_library":
        data = bytearray(path.read_bytes())
        data[3] ^= 0xFF
        path.write_bytes(bytes(data))
    elif damage == "torn_library":
        path.write_bytes(path.read_bytes()[:5])
    elif damage == "wrong_sha256":
        stamp.write_text("0" * 64 + "\n")
    else:
        stamp.unlink()
    assert not build.verified(path)
    assert build.build(tmp_path, compiler=stub) == path
    assert stub.calls == 2
    assert path.read_bytes() == stub.payload and build.verified(path)


def test_a_source_change_gets_another_library(tmp_path, monkeypatch):
    """A library built for other sources has another name: it is never
    taken for the current sources' library (a store syncing by file name
    cannot hand out a stale one)."""
    stub = StubCompiler()
    old = build.build(tmp_path, compiler=stub)
    monkeypatch.setattr(build, "source_digest", lambda: "f" * 64)
    new = build.build(tmp_path, compiler=stub)
    assert new != old and stub.calls == 2
    assert old.exists() and new.exists()


def test_a_failed_build_raises_and_leaves_nothing(tmp_path):
    def broken(out, log_file):
        out.write_bytes(b"partial")
        raise RuntimeError("nvcc failed for ['flash_fwd.cu']")

    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build(tmp_path, compiler=broken)
    assert not [p for p in os.listdir(tmp_path) if "libkernels" in p
                and not p.endswith(".log")]


def test_nvcc_that_cannot_start_raises(tmp_path, monkeypatch):
    """A missing or failing nvcc is a failed build, never a fallback."""
    monkeypatch.setenv("NVCC", str(tmp_path / "no-such-nvcc"))
    with pytest.raises(RuntimeError, match="did not start"):
        build.build(tmp_path / "out")


def test_the_cache_dir_bootstrap_enables_holds_the_library(tmp_path):
    """enable_compilation_cache probes the operator's dir and points the
    library there; an unusable dir, or TPUJOB_CACHE_ENABLED=0, keeps the
    build directory in the package (a cold attempt, never a failed
    one)."""
    cache = tmp_path / "cache"
    assert bootstrap.enable_compilation_cache(
        {"TPUJOB_CACHE_PATH": str(cache)}) == str(cache)
    assert startup.cache_dir() == str(cache)
    assert build.kernel_dir() == cache / build.CACHE_SUBDIR
    startup.set_cache_dir("")
    assert build.kernel_dir() == build.BUILD_DIR
    blocker = tmp_path / "file"
    blocker.write_text("not a dir")
    assert bootstrap.enable_compilation_cache(
        {"JAX_COMPILATION_CACHE_DIR": str(blocker / "c")}) == ""
    assert bootstrap.enable_compilation_cache(
        {"JAX_COMPILATION_CACHE_DIR": str(cache),
         "TPUJOB_CACHE_ENABLED": "0"}) == ""
    assert startup.cache_dir() == ""


def test_the_library_travels_through_the_store_to_a_fresh_node(tmp_path):
    """Attempt 0 builds into its cache dir and ships it; a fresh node's
    prefetch fills an empty cache dir and loads with no build. A library
    whose bytes were damaged in the store is rebuilt, not loaded."""
    stub = StubCompiler()
    env = {"TPUJOB_STORE_URI": str(tmp_path / "bucket"),
           "TPUJOB_NAMESPACE": "ns", "TPUJOB_NAME": "jb"}
    node_a = tmp_path / "node_a"
    lib = build.build(node_a / build.CACHE_SUBDIR, compiler=stub)
    assert warmstore.upload_cache_once(
        {**env, "TPUJOB_CACHE_PATH": str(node_a)}) == 3  # .so, .sha256, .log
    node_b = tmp_path / "node_b"
    assert warmstore.start_prefetch({**env, "TPUJOB_CACHE_PATH":
                                     str(node_b)})
    assert warmstore.finish_prefetch(30.0)["cacheFiles"] == 3
    assert build.build(node_b / build.CACHE_SUBDIR, compiler=stub) \
        == node_b / build.CACHE_SUBDIR / lib.name
    assert stub.calls == 1
    store = WarmStartStore(blob.from_uri(env["TPUJOB_STORE_URI"]),
                           prefix="ns/jb")
    key = f"ns/jb/cache/{build.CACHE_SUBDIR}/{lib.name}"
    store.backend.put(key, b"\x7fELF torn")
    node_c = tmp_path / "node_c"
    assert store.prefetch_cache(str(node_c)) == 3
    assert build.build(node_c / build.CACHE_SUBDIR, compiler=stub) \
        .read_bytes() == stub.payload
    assert stub.calls == 2


# --- bootstrap -------------------------------------------------------------------


def test_initialize_records_rendezvous_and_the_prefetch_tail(tmp_path,
                                                            monkeypatch):
    """A one-process job forms no group: RENDEZVOUS is 0 and the store
    prefetch (started first, joined last) lands as PREFETCH with its
    hit."""
    sd = tmp_path / "sd"
    sd.mkdir()
    (sd / "f").write_bytes(b"x")
    WarmStartStore(blob.from_uri(str(tmp_path / "bucket")),
                   prefix="ns/jb").upload_checkpoint(str(sd), 4)
    for k, v in {"TPUJOB_STORE_URI": str(tmp_path / "bucket"),
                 "TPUJOB_NAMESPACE": "ns", "TPUJOB_NAME": "jb",
                 "TPU_CHECKPOINT_DIR": str(tmp_path / "ck")}.items():
        monkeypatch.setenv(k, v)
    bootstrap.initialize(bootstrap.process_info_from_env({}), device="cpu")
    bd = startup.new_tracker().breakdown()
    assert bd["rendezvousSeconds"] == 0.0
    assert bd["prefetchHit"] is True and bd["prefetchSeconds"] >= 0
    assert os.path.isdir(tmp_path / "ck" / "4")


def test_run_payload_ships_the_cache_on_a_clean_exit(tmp_path, monkeypatch):
    """A job with a store but no checkpointer has no uploader: the exit
    of run_payload ships the library it built (exits 0, 143 and 160),
    and not after an application error."""
    cache = tmp_path / "cache"
    for k, v in {"TPUJOB_STORE_URI": str(tmp_path / "bucket"),
                 "TPUJOB_NAMESPACE": "ns", "TPUJOB_NAME": "jb",
                 "TPUJOB_CACHE_PATH": str(cache)}.items():
        monkeypatch.setenv(k, v)
    store = WarmStartStore(blob.from_uri(str(tmp_path / "bucket")),
                           prefix="ns/jb")

    def boom(_info):
        build.build(compiler=StubCompiler())
        raise ValueError("application error")

    assert bootstrap.run_payload(boom, device="cpu") == 1
    assert store.backend.list("ns/jb/cache/") == []
    assert bootstrap.run_payload(lambda _info: None, device="cpu") == 0
    names = sorted(k.rsplit("/", 1)[1]
                   for k in store.backend.list("ns/jb/cache/"))
    assert names == sorted(os.listdir(cache / build.CACHE_SUBDIR))


# --- train_loop: the overlapped prologue and the startup beats ----------------


def _losses(built, steps, ck=None, **kw):
    losses = []

    def step(tokens):
        metrics = built.step(tokens)
        losses.append(float(metrics["loss"]))
        return metrics

    train.train_loop(step, built.batches, steps, device="cpu",
                     heartbeat=None, steptrace=None, checkpointer=ck,
                     state=built.state, **kw)
    return losses


def test_the_overlapped_prologue_trains_and_resumes_like_the_serial_one(
        tmp_path):
    """COMPILE on its worker beside RESTORE changes nothing: a fresh run
    and a resumed one train bit-equal with and without the overlap, and
    equal the unbroken run."""
    def args():
        return transformer.parse_args(TINY)

    unbroken = transformer.build(args())
    u = _losses(unbroken, 6)
    compiled = []

    def stub_compile():
        time.sleep(0.05)
        compiled.append(threading.current_thread().name)
        return True

    runs = {}
    for overlap in (True, False):
        ckdir = tmp_path / f"ck-{overlap}"
        ck = checkpoint.Checkpointer(str(ckdir), save_every=3)
        first = _losses(transformer.build(args()), 3, ck, overlap=overlap,
                        compile_fn=stub_compile)
        ck.close()
        resumed = transformer.build(args())
        ck = checkpoint.Checkpointer(str(ckdir), save_every=3)
        tracker = startup.new_tracker()
        rest = _losses(resumed, 6, ck, overlap=overlap,
                       compile_fn=stub_compile, startup=tracker)
        ck.close()
        bd = tracker.breakdown()
        assert {"restoreSeconds", "compileSeconds",
                "firstStepSeconds"} <= set(bd) and bd["cacheHit"] is True
        runs[overlap] = (first + rest,
                         {n: p.detach().clone() for n, p in
                          resumed.model.named_parameters()})
    assert runs[True][0] == runs[False][0] == u
    for name, p in unbroken.model.named_parameters():
        assert torch.equal(runs[True][1][name], p.detach())
        assert torch.equal(runs[False][1][name], p.detach())
    assert compiled == ["kernel-compile", "kernel-compile", "MainThread",
                        "MainThread"]


def test_a_failed_compile_raises_after_the_restore_joins_it(tmp_path):
    """No fallback that hides the kernels: a COMPILE failure raises out
    of the loop, after the restore beside it finished and the worker was
    joined; no step ran."""
    built = transformer.build(transformer.parse_args(TINY))
    ck = checkpoint.Checkpointer(str(tmp_path / "ck"), save_every=2)
    restored = []
    real = ck.restore

    def slow_restore(state):
        time.sleep(0.1)
        restored.append(True)
        return real(state)

    ck.restore = slow_restore

    def broken():
        raise RuntimeError("nvcc failed for ['flash_fwd.cu']")

    ran = []
    with pytest.raises(RuntimeError, match="nvcc failed"):
        train.train_loop(lambda t: ran.append(t), built.batches, 3,
                         device="cpu", heartbeat=None, steptrace=None,
                         checkpointer=ck, state=built.state,
                         compile_fn=broken)
    ck.close()
    assert restored == [True] and ran == []
    assert not [t for t in threading.enumerate()
                if t.name == "kernel-compile"]


class _Jobs:
    @staticmethod
    def get(_namespace, _name):
        return {"metadata": {"name": "jb", "namespace": "ns"}}


class _Informer:
    store = _Jobs()


class _Controller:
    """Just enough controller for StatusServer.record_heartbeat: the job
    is known and every beat is recorded."""

    job_informer = _Informer()

    def __init__(self):
        self.beats = []

    def record_heartbeat(self, _namespace, _name, hb):
        self.beats.append(hb)
        return True


def _server_poster(server, bodies):
    def poster(_url, body):
        ok, msg = server.record_heartbeat(body)
        assert ok, msg
        bodies.append(body)
        return {}

    return poster


def test_train_loop_posts_startup_stage_and_breakdown_to_the_server():
    """Before the first step the ticker posts the in-flight startupStage
    (COMPILE here); the first step's beat carries the breakdown. The
    reference's status server accepts both and records what it sanitized:
    the same fields."""
    server = StatusServer(0, metrics=Metrics())
    server.start()
    controller = _Controller()
    server.set_controller(controller)
    bodies = []
    try:
        rep = heartbeat.HeartbeatReporter(
            "http://s", "jb", namespace="ns", interval=0.02,
            poster=_server_poster(server, bodies))

        def slow_compile():
            time.sleep(0.3)
            return False

        step = lambda tokens: {"loss": torch.tensor(1.5)}  # noqa: E731
        batches = ((np.zeros((2, 4), np.int32),) for _ in range(9))
        train.train_loop(step, batches, 3, device="cpu", heartbeat=rep,
                         steptrace=None, compile_fn=slow_compile)
    finally:
        server.stop()
    stages = [b["startupStage"] for b in bodies if "startupStage" in b]
    assert stages and set(stages) == {"COMPILE"}
    carried = [b["startup"] for b in bodies if "startup" in b]
    assert len(carried) == 1 and carried[0]["cacheHit"] is False
    assert carried[0]["compileSeconds"] >= 0.3
    assert carried[0]["firstStepSeconds"] > 0
    recorded = [hb["startup"] for hb in controller.beats if "startup" in hb]
    assert recorded == carried
    assert [hb["startupStage"] for hb in controller.beats
            if "startupStage" in hb] == stages


def test_cifar_aot_runs_the_prologue_with_the_kernel_library(monkeypatch):
    """--aot routes the classifier through the overlapped prologue with
    the kernel library as its COMPILE work; without it the classifier
    has none."""
    loads = []

    def fake_loader(device):
        return lambda: loads.append(str(device)) or True

    monkeypatch.setattr(train, "kernel_loader", fake_loader)
    base = ["--batch", "16", "--blocks", "1", "--widths", "8", "16", "16",
            "--log-every", "0", "--steps", "2", "--checkpoint-dir", "",
            "--profile-dir", "", "--device", "cpu"]
    info = bootstrap.process_info_from_env({})
    cifar.run(info, cifar.parse_args(base))
    assert loads == []
    metrics = cifar.run(info, cifar.parse_args(base + ["--aot"]))
    assert loads == ["cpu"] and np.isfinite(metrics["loss"])


def test_kernel_loader_is_none_on_the_cpu():
    """The plain versions need no build: the CPU has no COMPILE work."""
    assert train.kernel_loader("cpu") is None
    assert callable(train.kernel_loader("cuda"))


def test_heartbeat_channels_match_the_reference():
    """The same calls through the port's reporter and the reference's:
    the same bodies (startup beats, the breakdown and dataPlane once,
    the store counters, the profile directive taken once from the ACK
    and its result resent until a post succeeds, the drain channel) and
    the same directives handed to the loop."""
    from tpu_operator.payload import heartbeat as jheartbeat

    def drive(mod):
        bodies, taken = [], []
        acks = iter([{}, {"profile": {"id": "p1", "steps": 2}},
                     {"profile": {"id": "p1", "steps": 2}}, None,
                     {"drain": {"id": "d1", "reason": "cordon"}}, {}, {},
                     {}])
        failing = {"n": 0}

        def poster(_url, body):
            bodies.append(dict(body))
            ack = next(acks)
            if ack is None:
                failing["n"] += 1
                raise OSError("status server down")
            return ack

        ticks = iter(float(x) for x in range(100))
        rep = mod.HeartbeatReporter("http://s", "jb", namespace="ns",
                                    interval=0.0, poster=poster,
                                    clock=lambda: next(ticks),
                                    tokens_per_batch=64)
        rep.report_startup("COMPILE")
        rep.report(1, {"loss": 2.5},
                   checkpoint={"saveFailures": 0, "restoreFallbacks": 0,
                               "lastUploadedStep": 1, "uploadFailures": 0},
                   startup={"compileSeconds": 1.25, "cacheHit": True},
                   dataplane={"prefetchDepth": 2, "hostAsync": False})
        taken.append(rep.take_profile_directive())
        rep.report(2, {"loss": 2.0})
        taken.append(rep.take_profile_directive())
        rep.attach_profile_result({"id": "p1", "capturedSteps": 2})
        rep.report(3, {"loss": float("nan")})
        rep.report(4, {"loss": 1.5})
        taken.append(rep.take_drain_directive())
        rep.attach_drain_ack({"id": "d1", "step": 4})
        rep.report(5, {"loss": 1.25})
        rep.report(6, None)
        return bodies, taken

    ours, theirs = drive(heartbeat), drive(jheartbeat)
    assert ours == theirs
    bodies, taken = ours
    assert bodies[0] == {"namespace": "ns", "name": "jb", "processId": 0,
                         "attempt": 0, "startupStage": "COMPILE"}
    assert taken == [{"id": "p1", "steps": 2}, None,
                     {"id": "d1", "reason": "cordon"}]
    assert [("profile" in b, "drainAck" in b) for b in bodies[1:]] == [
        (False, False), (False, False), (True, False), (True, False),
        (False, True), (False, False)]
