"""The PyTorch payload's profiling on the CPU: the on-demand
``ProfileCapture`` (``payload/profile.py``) against the reference's
(``tpu_operator/payload/profile.py``), its ``torch.profiler`` trace, the
directive's round trip through ``train_loop`` and the reference's status
server, the loop's own ``--profile-dir`` window, and the rule that one
profiler owner runs at a time.
"""

import json
import os

import numpy as np
import pytest
import torch

from tpu_operator.controller.statusserver import (Metrics, StatusServer,
                                                  _sanitize_profile)
from tpu_operator.payload import profile as jprofile
from tpu_operator_torch.payload import bootstrap
from tpu_operator_torch.payload import checkpoint
from tpu_operator_torch.payload import heartbeat
from tpu_operator_torch.payload import profile
from tpu_operator_torch.payload import steptrace
from tpu_operator_torch.payload import train
from tpu_operator_torch.payload import transformer
from tpu_operator_torch.payload.store import WarmStartStore, blob
from tpu_operator_torch.payload.store.writebehind import WriteBehindUploader

TINY = ["--dim", "32", "--layers", "1", "--heads", "2", "--kv-heads", "1",
        "--vocab", "64", "--seq-len", "16", "--batch", "2",
        "--log-every", "0", "--seed", "0", "--checkpoint-dir", "",
        "--device", "cpu"]


@pytest.fixture(autouse=True)
def _clean_drain_latch():
    bootstrap.reset_drain()
    yield
    bootstrap.reset_drain()


def _recorder(first, last):
    """A flight recorder holding the 0-based loop steps first..last."""
    rec = steptrace.StepRecorder(capacity=64)
    for i in range(first, last + 1):
        rec.begin(i)
        rec.lap(steptrace.DATA)
        rec.lap(steptrace.COMPUTE)
        rec.commit()
    return rec


def _capture(mod, directive, base_dir, recorder, **kw):
    cap = mod.ProfileCapture(directive, base_dir=str(base_dir), **kw)
    cap.start(4)
    done = False
    step = 4
    while not done:
        step += 1
        done = cap.tick(step)
    path, result = cap.finish(recorder)
    return cap, path, result


@pytest.mark.parametrize("directive", [
    {"id": "p-1", "steps": 3}, {"id": "a/b c", "steps": "2"},
    {"id": "dflt", "steps": None}, {"id": "bad", "steps": "many"}],
    ids=["plain", "path_hostile", "default_steps", "bad_steps"])
def test_artifact_and_result_equal_the_references(tmp_path, directive):
    """The same directive and the same ticks through both captures: the
    same clamps, ids, file names, result and artifact keys; the laps merge
    the same recorder rows."""
    rec = _recorder(0, 40)
    ours, opath, ores = _capture(profile, directive, tmp_path / "ours", rec,
                                 allow_trace=False)
    theirs, tpath, tres = _capture(jprofile, directive, tmp_path / "ref",
                                   rec, allow_jax_trace=False)
    assert ores == tres
    assert os.path.basename(opath) == os.path.basename(tpath)
    mine, ref = json.loads(open(opath).read()), json.loads(open(tpath).read())
    assert set(mine) == set(ref)
    for key in ("kind", "id", "requestedSteps", "capturedSteps",
                "firstStep", "lastStep", "jaxTraceDir"):
        assert mine[key] == ref[key], key
    assert [sorted(r) for r in mine["steps"]] == \
        [sorted(r) for r in ref["steps"]]
    assert [r["step"] for r in mine["steps"]] == \
        [r["step"] for r in ref["steps"]]
    assert mine["kind"] == profile.ARTIFACT_KIND == jprofile.ARTIFACT_KIND
    clean, err = _sanitize_profile(ores)
    assert not err and clean == ores


def test_the_clamps_equal_the_references():
    for steps in (0, 1, 8, 512, 513, 10_000, -5, None, "x"):
        a = profile.ProfileCapture({"id": "c", "steps": steps},
                                   allow_trace=False)
        b = jprofile.ProfileCapture({"id": "c", "steps": steps},
                                    allow_jax_trace=False)
        assert a.steps == b.steps, steps
    for raw in ("ok-1.2_x", "../../etc", "a b/c", "", "é"):
        assert profile._safe_id(raw) == jprofile._safe_id(raw)


def test_a_capture_writes_a_cpu_torch_profiler_trace(tmp_path):
    """With the trace allowed, the window is bracketed by torch.profiler
    (CPU activities here) and its Chrome trace lands in the artifact's
    trace dir, holding the window's ops."""
    cap = profile.ProfileCapture({"id": "t1", "steps": 2},
                                 base_dir=str(tmp_path))
    cap.start(0)
    a = torch.randn(32, 32)
    for step in (1, 2):
        (a @ a).sum()
        done = cap.tick(step)
    assert done
    path, result = cap.finish()
    body = json.loads(open(path).read())
    assert body["jaxTraceDir"] == cap.trace_dir != ""
    trace = json.loads(open(cap.trace_path).read())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names or "aten::matmul" in names
    assert result == {"id": "t1", "capturedSteps": 2}


def test_abandon_stops_the_profiler(tmp_path):
    cap = profile.ProfileCapture({"id": "ab", "steps": 5},
                                 base_dir=str(tmp_path))
    cap.start(0)
    cap.tick(1)
    cap.abandon()
    # A new profiler can start: the abandoned one was stopped.
    prof = profile.start_profiler(cuda=False)
    profile.stop_profiler(prof, str(tmp_path / "after.json"), cuda=False)
    assert os.path.isfile(tmp_path / "after.json")


class _Jobs:
    @staticmethod
    def get(_namespace, _name):
        return {"metadata": {"name": "jb", "namespace": "default"}}


class _Informer:
    store = _Jobs()


class _Controller:
    job_informer = _Informer()

    def __init__(self):
        self.beats = []

    def record_heartbeat(self, _namespace, _name, hb):
        self.beats.append(hb)
        return True


def _step_fn():
    calls = []

    def step(tokens):
        calls.append(int(tokens[0, 0]))
        return {"loss": torch.tensor(float(len(calls)))}

    return step, calls


def _batches():
    i = 0
    while True:
        yield (np.full((2, 4), i, np.int32),)
        i += 1


def test_the_directive_round_trip_through_train_loop(tmp_path):
    """The ACK of step 2's beat carries the directive; the next 3 steps
    are captured with the recorder's rows, the artifact ships through the
    store uploader's artifacts/ path, and the next beat carries the
    result, which the reference's server accepts. The directive, resent,
    is not taken twice."""
    server = StatusServer(0, metrics=Metrics())
    server.start()
    ctl = _Controller()
    server.set_controller(ctl)
    bodies = []

    def poster(_url, body):
        ok, msg = server.record_heartbeat(body)
        assert ok, msg
        bodies.append(body)
        if body.get("step", 0) >= 2:
            return {"profile": {"id": "prof-7", "steps": 3}}
        return {}

    store = WarmStartStore(blob.from_uri(str(tmp_path / "bucket")),
                           prefix="default/jb")
    ck = checkpoint.Checkpointer(str(tmp_path / "ck"), save_every=100,
                                 uploader=WriteBehindUploader(store))
    rep = heartbeat.HeartbeatReporter("http://s", "jb", interval=0.0,
                                      poster=poster)
    step, _calls = _step_fn()
    state = checkpoint.TrainState({"w": torch.zeros(4)})
    try:
        train.train_loop(step, _batches(), 9, device="cpu", heartbeat=rep,
                         steptrace=steptrace.StepRecorder(),
                         checkpointer=ck, state=state)
        ck.close()
    finally:
        server.stop()
    results = [(b["step"], b["profile"]) for b in bodies if "profile" in b]
    assert results == [(6, {"id": "prof-7", "capturedSteps": 3,
                            "artifactKey": "artifacts/profile-prof-7.json"})]
    assert [hb["profile"] for hb in ctl.beats if "profile" in hb] == \
        [results[0][1]]
    assert store.list_artifacts() == ["profile-prof-7.json"]
    body = json.loads(open(tmp_path / "ck" / "profile-prof-7.json").read())
    assert [r["step"] for r in body["steps"]] == [3, 4, 5]
    assert all({"wallSeconds", "dataWait", "compute", "stepSeconds"}
               <= set(r) for r in body["steps"])
    assert os.path.isfile(os.path.join(body["jaxTraceDir"],
                                       profile.TRACE_FILE))


def test_profile_dir_window_writes_its_trace_and_owns_the_profiler(
        tmp_path, monkeypatch):
    """--profile-dir traces steps profile_range of the run; a directive
    arriving while the window is armed captures laps without a second
    profiler, one arriving after the window closed traces."""
    directives = {2: "early", 5: "late"}

    def poster(_url, body):
        tag = directives.get(body.get("step"))
        return {"profile": {"id": tag, "steps": 1}} if tag else {}

    monkeypatch.setenv("TPU_CHECKPOINT_DIR", str(tmp_path / "ckd"))
    rep = heartbeat.HeartbeatReporter("http://s", "jb", interval=0.0,
                                      poster=poster)
    step, _calls = _step_fn()
    prof_dir = tmp_path / "prof"
    train.train_loop(step, _batches(), 8, device="cpu", heartbeat=rep,
                     steptrace=None, profile_dir=str(prof_dir),
                     profile_range=(2, 4))
    (trace,) = os.listdir(prof_dir)
    assert trace == "trace-p0-from-step-3.json"
    events = json.loads(open(prof_dir / trace).read())["traceEvents"]
    assert events
    base = str(tmp_path / "ckd")
    early = json.loads(open(os.path.join(base, "profile-early.json")).read())
    late = json.loads(open(os.path.join(base, "profile-late.json")).read())
    assert early["jaxTraceDir"] == "" and early["capturedSteps"] == 1
    assert late["jaxTraceDir"] != "" and late["capturedSteps"] == 1


def test_transformer_profile_dir_writes_a_trace(tmp_path):
    """The CLI path: --profile-dir is ported (it raised before); the run's
    steps 11-20 land in a torch.profiler trace."""
    args = transformer.parse_args(TINY + ["--steps", "20", "--profile-dir",
                                          str(tmp_path / "p")])
    metrics = transformer.run(bootstrap.process_info_from_env({}), args)
    assert np.isfinite(metrics["loss"])
    (trace,) = os.listdir(tmp_path / "p")
    events = json.loads(open(tmp_path / "p" / trace).read())["traceEvents"]
    assert any(e.get("name") == "ProfilerStep" or "aten::" in
               str(e.get("name")) for e in events)
