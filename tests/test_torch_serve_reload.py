"""Serve hot reload of the PyTorch payload on the CPU (``payload/serve.py``
with the warm-start store): a ServeLoop under steady load picks up a newer
verified step that is uploaded mid-run, counts one reload, leaves the live
KV pages of in-flight requests alone, completes every request, and then
decodes a fixed prompt exactly as a fresh server loaded at that step. A
failed reload keeps the old weights and re-readies. Its beats pass the
reference's status server.
"""

import shutil
import threading
import time

import numpy as np
import pytest
import torch

from tpu_operator.controller.statusserver import _sanitize_serving
from tpu_operator_torch.payload import bootstrap
from tpu_operator_torch.payload import checkpoint
from tpu_operator_torch.payload import heartbeat
from tpu_operator_torch.payload import serve
from tpu_operator_torch.payload import train
from tpu_operator_torch.payload import transformer
from tpu_operator_torch.payload.store import WarmStartStore, blob

WIDTHS = ["--vocab", "32", "--dim", "16", "--heads", "2", "--kv-heads", "1",
          "--layers", "2"]
PROMPT = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8], np.int32)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Keep each tiny CPU decode step fast under parallel test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _train_steps(tmp_path):
    """A trainer at the server's widths (its sequence = window + decode
    tokens) saves step 2 into ``early`` and step 4 into ``late``."""
    targs = transformer.parse_args(WIDTHS + [
        "--seq-len", "20", "--batch", "2", "--log-every", "0",
        "--device", "cpu", "--checkpoint-dir", "", "--profile-dir", ""])
    built = transformer.build(targs)
    dirs = {}
    for name, steps in (("early", 2), ("late", 4)):
        ck = checkpoint.Checkpointer(str(tmp_path / name), save_every=100)
        train.train_loop(built.step, built.batches, steps, device="cpu",
                         heartbeat=None, steptrace=None, checkpointer=ck,
                         state=built.state, dataplane=None)
        ck.close()
        dirs[name] = tmp_path / name / str(steps)
    return dirs


def _serve_args(ckdir, load):
    return serve.parse_args(WIDTHS + [
        "--batch", "2", "--window", "16", "--decode-tokens", "4",
        "--load", load, "--device", "cpu", "--checkpoint-dir", str(ckdir),
        "--reload-poll", "0.1", "--reload-stagger", "0"])


def greedy(loop, prompt, new_tokens):
    """The replica's greedy tokens for ``prompt`` decoded alone in slot 0
    (the loop must be idle)."""
    admitted, token = loop.engine.admit(0, prompt, new_tokens, loop.model)
    assert admitted
    out = [int(token)]
    active = np.zeros(loop.args.batch, bool)
    active[0] = True
    while len(out) < new_tokens:
        out.append(int(loop.engine.step(loop.model, active)[0]))
    loop.engine.release(0)
    return out


def test_a_step_uploaded_mid_run_is_hot_reloaded(tmp_path):
    dirs = _train_steps(tmp_path)
    local = tmp_path / "replica"
    local.mkdir()
    shutil.copytree(dirs["early"], local / "2")
    store = WarmStartStore(blob.from_uri(str(tmp_path / "bucket")),
                           prefix="ns/svc")
    beats = []
    rep = heartbeat.HeartbeatReporter(
        "http://s", "svc", interval=0.0,
        poster=lambda _u, body: beats.append(body) or {})
    loop = serve.ServeLoop(_serve_args(local, "25:2.5"),
                           bootstrap.process_info_from_env({}),
                           heartbeat=rep, recorder=None, store=store)
    pages_at_reload = []
    real_reload = loop._maybe_reload

    def watched_reload():
        before = {s: loop.engine.cache.slot_pages(s)
                  for s in range(loop.args.batch)}
        if all(p is None for p in before.values()):
            # Hold the armed target for a boundary with requests in
            # flight: those are the pages the swap must leave alone.
            return False
        ran = real_reload()
        if ran:
            after = {s: loop.engine.cache.slot_pages(s)
                     for s in range(loop.args.batch)}
            pages_at_reload.append((before, after))
        return ran

    loop._maybe_reload = watched_reload

    def upload_mid_run():
        while loop.steps < 10:
            time.sleep(0.01)
        store.upload_checkpoint(str(dirs["late"]), 4)

    uploader = threading.Thread(target=upload_mid_run, daemon=True)
    uploader.start()
    summary = loop.run()
    uploader.join(timeout=10)
    assert summary["reloads"] == 1 and loop.loaded_step == 4
    assert summary["shed"] == 0 and summary["failedSteps"] == 0
    assert summary["completed"] == summary["arrivals"] >= 10
    assert len(summary["reloadGapSeconds"]) == 1
    (before, after), = pages_at_reload
    assert before == after
    assert any(p is not None for p in before.values())
    readiness = [b["serving"]["ready"] for b in beats]
    assert readiness[0] is True and False in readiness
    assert readiness[readiness.index(False) + 1] is True
    assert beats[-1]["serving"]["reloads"] == 1
    for body in beats:
        clean, err = _sanitize_serving(body["serving"])
        assert not err and clean == body["serving"]
    fresh = serve.ServeLoop(_serve_args(local, "0:0"),
                            bootstrap.process_info_from_env({}),
                            heartbeat=None, recorder=None, store=None)
    assert fresh._restore_weights() == 4
    assert greedy(loop, PROMPT, 4) == greedy(fresh, PROMPT, 4)
    served = dict(loop.model.named_parameters())
    for name, p in fresh.model.named_parameters():
        assert torch.equal(served[name], p), name


def test_a_slow_reload_runs_once(tmp_path):
    """A reload that outlasts the watcher's poll: the watcher re-arms the
    same step while it runs (the loaded step moves only at its end), and
    that stale target must not run a second reload and drop readiness
    again."""
    dirs = _train_steps(tmp_path)
    local = tmp_path / "replica"
    local.mkdir()
    shutil.copytree(dirs["early"], local / "2")
    store = WarmStartStore(blob.from_uri(str(tmp_path / "bucket")),
                           prefix="ns/svc")
    store.upload_checkpoint(str(dirs["late"]), 4)
    beats = []
    rep = heartbeat.HeartbeatReporter(
        "http://s", "svc", interval=3600.0,
        poster=lambda _u, body: beats.append(body) or {})
    loop = serve.ServeLoop(_serve_args(local, "20:2"),
                           bootstrap.process_info_from_env({}),
                           heartbeat=rep, recorder=None, store=store)
    real = loop._restore_weights

    def slow_restore():
        if loop.loaded_step:
            time.sleep(0.6)  # six polls of the watcher
        return real()

    loop._restore_weights = slow_restore
    summary = loop.run()
    assert summary["reloads"] == 1 and summary["loadedStep"] == 4
    assert len(summary["reloadGapSeconds"]) == 1
    drops = [b for b in beats if b["serving"]["ready"] is False]
    assert len(drops) == 2  # the reload's, and the shutdown's
    assert summary["shed"] == 0 and summary["failedSteps"] == 0


def test_a_failed_reload_keeps_the_old_weights_and_re_readies(tmp_path):
    dirs = _train_steps(tmp_path)
    local = tmp_path / "replica"
    local.mkdir()
    shutil.copytree(dirs["early"], local / "2")
    store = WarmStartStore(blob.from_uri(str(tmp_path / "bucket")),
                           prefix="ns/svc")
    store.upload_checkpoint(str(dirs["late"]), 4)
    loop = serve.ServeLoop(_serve_args(local, "20:1"),
                           bootstrap.process_info_from_env({}),
                           heartbeat=None, recorder=None, store=store)

    def broken_restore():
        raise OSError("checkpoint volume went away")

    loop._restore_weights = lambda real=loop._restore_weights: (
        real() if loop.loaded_step == 0 else broken_restore())
    summary = loop.run()
    assert summary["reloads"] == 0 and summary["loadedStep"] == 2
    assert summary["shed"] == 0 and summary["failedSteps"] == 0
    assert summary["completed"] == summary["arrivals"] >= 1
    old = serve.ServeLoop(_serve_args(local, "0:0"),
                          bootstrap.process_info_from_env({}),
                          heartbeat=None, recorder=None, store=None)
    shutil.rmtree(local / "4", ignore_errors=True)
    assert old._restore_weights() == 2
    for name, p in old.model.named_parameters():
        assert torch.equal(dict(loop.model.named_parameters())[name], p)


def test_the_store_comes_from_the_env_only_in_serve_mode(tmp_path,
                                                         monkeypatch):
    """``TPUJOB_SERVE`` gates the watcher: without it a replica never
    reads the store (the reference's contract); --reload-poll defaults
    from the operator's env."""
    monkeypatch.setenv("TPUJOB_STORE_URI", str(tmp_path / "bucket"))
    monkeypatch.setenv("TPUJOB_NAME", "svc")
    monkeypatch.delenv("TPUJOB_SERVE", raising=False)
    args = _serve_args(tmp_path / "ck", "0:0")
    info = bootstrap.process_info_from_env({})
    assert serve.ServeLoop(args, info, heartbeat=None,
                           recorder=None).store is None
    monkeypatch.setenv("TPUJOB_SERVE", "1")
    loop = serve.ServeLoop(args, info, heartbeat=None, recorder=None)
    assert loop.store is not None and loop.store.prefix == "default/svc"
    monkeypatch.setenv("TPUJOB_SERVE_RELOAD_POLL", "3.5")
    assert serve.parse_args([]).reload_poll == 3.5
