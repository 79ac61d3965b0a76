"""The PyTorch payload's self-tuning data plane (``payload/autotune.py``,
``data.device_prefetch``'s live depth and host pipeline) against its
reference (``tpu_operator/payload/autotune.py``) on the CPU.

The reference's own payload-side tests, run on the port; then the port's
and the reference's controllers fed the same recorder digests take the
same decision at every window; the wire keys equal the reference's; a
resized or pipelined prefetch keeps the batch order byte-identical; the
``dataPlane`` body a training loop posts passes the reference's status
server; and the gang-agreed checkpoint cadence holds across two gloo
processes.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_operator.controller.statusserver import Metrics, StatusServer
from tpu_operator.payload import autotune as jautotune
from tpu_operator.payload import steptrace as jsteptrace
from tpu_operator_torch.payload import autotune
from tpu_operator_torch.payload import checkpoint
from tpu_operator_torch.payload import cifar
from tpu_operator_torch.payload import data as data_mod
from tpu_operator_torch.payload import heartbeat as heartbeat_mod
from tpu_operator_torch.payload import steptrace
from tpu_operator_torch.payload import train

REPO = Path(__file__).resolve().parent.parent


def tiny_state(step=0):
    w = torch.arange(16, dtype=torch.float32) + float(step)
    return checkpoint.TrainState({"w": w})


def feed_window(ctl_, steps, data=0.0, host=0.0, ckpt=0.0, compute=0.010):
    """Drive one controller window of identical synthetic step records."""
    for _ in range(steps):
        ctl_.on_step({"seconds": compute + data + host + ckpt,
                      steptrace.DATA: data, steptrace.HOST: host,
                      steptrace.CHECKPOINT: ckpt,
                      steptrace.COMPUTE: compute})


def test_resolve_prefetch_depth_convention():
    assert autotune.resolve_prefetch_depth(0) == \
        autotune.DEFAULT_PREFETCH_DEPTH
    assert autotune.resolve_prefetch_depth(5) == 5
    with pytest.raises(ValueError):
        autotune.resolve_prefetch_depth(-1)


def test_from_env_gating():
    # no env → inert: caller's depth verbatim (0 stays unbuffered for
    # direct train_loop callers), no controller, no pipeline
    rt = autotune.from_env(prefetch=0, env={})
    assert rt.depth == 0 and not rt.active and not rt.pipeline
    assert rt.controller is None and rt.wire() is None
    # spec block without autotune → static depth + pipeline + wire
    rt = autotune.from_env(prefetch=0, env={
        autotune.ENV_PREFETCH_DEPTH: "5"})
    assert rt.depth == 5 and rt.active and rt.pipeline
    assert rt.controller is None
    assert rt.wire() == {"prefetchDepth": 5, "hostAsync": False}
    # autotune on: controller with env bounds, auto depth resolves
    rt = autotune.from_env(prefetch=0, env={
        autotune.ENV_PREFETCH_DEPTH: "0",
        autotune.ENV_AUTOTUNE: "1",
        autotune.ENV_MIN_DEPTH: "2",
        autotune.ENV_MAX_DEPTH: "6",
        autotune.ENV_WINDOW_STEPS: "16"})
    assert rt.controller is not None and rt.control is not None
    assert rt.controller.min_depth == 2 and rt.controller.max_depth == 6
    assert rt.controller.window_steps == 16
    assert rt.control.depth == autotune.DEFAULT_PREFETCH_DEPTH
    # an explicit --prefetch-depth wins over the env value
    rt = autotune.from_env(prefetch=3, env={
        autotune.ENV_PREFETCH_DEPTH: "5"})
    assert rt.depth == 3


def test_add_prefetch_argument_defaults_from_env():
    import argparse

    p = argparse.ArgumentParser()
    autotune.add_prefetch_argument(p, env={
        autotune.ENV_PREFETCH_DEPTH: "7"})
    assert p.parse_args([]).prefetch_depth == 7
    assert p.parse_args(["--prefetch-depth", "2"]).prefetch_depth == 2
    # malformed env never kills the payload at arg-parse time
    p2 = argparse.ArgumentParser()
    autotune.add_prefetch_argument(p2, env={
        autotune.ENV_PREFETCH_DEPTH: "lots"})
    assert p2.parse_args([]).prefetch_depth == 0


def test_controller_converges_up_on_data_bound_digests():
    """DATA-bound windows climb the depth until the (synthetic) data wait
    stops dominating — the plant rewards depth, so the controller keeps
    each move and converges without a single revert."""
    control = autotune.PrefetchControl(1)
    c = autotune.DataPlaneController(control, min_depth=1, max_depth=8,
                                     window_steps=8)
    for _ in range(16):
        d = control.depth
        # data wait shrinks as depth covers the burst; compute 10 ms
        data = max(0.0, 0.006 - (d - 1) * 0.002)
        feed_window(c, 8, data=data)
    assert control.depth == 4  # climbed until DATA fell under the floor
    adj = c.adjustments()
    assert adj["prefetchUp"] == 3 and adj["prefetchDown"] == 0


def test_controller_backs_off_on_regression():
    control = autotune.PrefetchControl(2)
    c = autotune.DataPlaneController(control, window_steps=8)
    feed_window(c, 8, data=0.005)            # DATA dominant → depth 3
    assert control.depth == 3
    feed_window(c, 8, data=0.005, compute=0.025)  # step time regressed
    assert control.depth == 2                # reverted
    adj = c.adjustments()
    assert adj["prefetchUp"] == 1 and adj["prefetchDown"] == 1
    # the knob is now held: the same DATA-bound signal does not re-climb
    # within the hold window
    feed_window(c, 8, data=0.005)
    assert control.depth == 2


def test_controller_hysteresis_no_flap():
    """Steady digests with sub-hysteresis noise after convergence make NO
    adjustments — the no-flap contract."""
    control = autotune.PrefetchControl(2)
    c = autotune.DataPlaneController(control, window_steps=8)
    feed_window(c, 8, data=0.005)
    feed_window(c, 8, data=0.001)            # improved → accepted
    settled = dict(c.adjustments())
    for i in range(12):
        # ±1% step-time noise, residue under the materiality floor
        feed_window(c, 8, data=0.00005,
                    compute=0.010 * (1.0 + (0.01 if i % 2 else -0.01)))
    assert c.adjustments() == settled
    assert control.depth == 3


def test_controller_verdict_ignores_gang_wide_noise():
    """The verdict is the LOCAL share (step minus compute wait): a
    modest whole-step slowdown during the verdict window — a peer
    hiccup, equalized into COMPUTE by the gang's collectives — must not
    revert a change that improved the knob's own signal, else recurring
    gang noise pins every member's knobs. A large whole-step regression
    still reverts via the coarse step guard (the backs-off test)."""
    control = autotune.PrefetchControl(2)
    c = autotune.DataPlaneController(control, window_steps=8)
    feed_window(c, 8, data=0.005)                 # climb -> depth 3
    feed_window(c, 8, data=0.001, compute=0.010 * 1.05)
    assert control.depth == 3                     # kept
    adj = c.adjustments()
    assert adj["prefetchUp"] == 1 and adj["prefetchDown"] == 0


def test_controller_clamps_to_min_max():
    control = autotune.PrefetchControl(1)
    c = autotune.DataPlaneController(control, min_depth=1, max_depth=3,
                                     window_steps=8)
    for _ in range(10):
        feed_window(c, 8, data=0.008)        # permanently DATA-bound
    assert control.depth == 3                # never past maxDepth
    assert c.adjustments()["prefetchUp"] == 2
    # construction clamps an out-of-range starting depth too
    control2 = autotune.PrefetchControl(9)
    autotune.DataPlaneController(control2, min_depth=2, max_depth=4)
    assert control2.depth == 4


def test_controller_falls_through_to_next_knob_when_capped():
    """A clamped dominant knob must not dead-end the climb: the
    next-most-material phase's knob gets the window's action."""
    control = autotune.PrefetchControl(3)
    calls = []
    c = autotune.DataPlaneController(control, min_depth=1, max_depth=3,
                                     window_steps=8,
                                     enable_host_async=calls.append)
    # DATA dominates but depth is already at max; HOST is material too.
    feed_window(c, 8, data=0.006, host=0.004)
    assert control.depth == 3 and calls == [True]
    adj = c.adjustments()
    assert adj["hostUp"] == 1 and adj["prefetchUp"] == 0


def test_controller_host_knob_enables_async_path():
    control = autotune.PrefetchControl(2)
    calls = []
    c = autotune.DataPlaneController(control, window_steps=8,
                                     enable_host_async=calls.append)
    feed_window(c, 8, host=0.004)            # HOST dominates the residue
    assert c.host_async and calls == [True]
    feed_window(c, 8, host=0.0001)           # improved → accepted
    assert c.host_async
    adj = c.adjustments()
    assert adj["hostUp"] == 1 and adj["hostDown"] == 0


def test_controller_checkpoint_cadence_stretches_within_cap(tmp_path):
    class _State:
        pass

    ck = checkpoint.Checkpointer(str(tmp_path / "ck"), save_every=10)
    control = autotune.PrefetchControl(2)
    c = autotune.DataPlaneController(control, window_steps=8,
                                     checkpointer=ck)
    for _ in range(8):
        feed_window(c, 8, ckpt=0.004)        # CHECKPOINT-stall bound
    assert ck.cadence_multiplier == autotune.CHECKPOINT_CADENCE_CAP
    assert c.adjustments()["checkpointUp"] == 2  # 1 → 2 → 4, capped
    # maybe_save honors the stretched cadence: only every mult'th
    # interval boundary saves
    saved = []
    ck._save = lambda step, state: saved.append(step) or True
    ck.maybe_save(10, None)
    ck.maybe_save(20, None)
    ck.maybe_save(40, None)
    assert saved == [40]


def test_controller_survives_observer_exceptions():
    rec = steptrace.StepRecorder(capacity=16)

    def boom(_record):
        raise RuntimeError("observer bug")

    rec.on_commit = boom
    rec.begin(0)
    rec.lap(steptrace.COMPUTE)
    rec.commit()                              # must not raise
    assert rec.on_commit is None              # detached after the failure
    assert rec.steps_recorded == 1


def test_pipeline_preserves_order_and_propagates_errors():
    fed = list(range(10))

    def failing():
        for v in fed:
            yield v
        raise RuntimeError("stream died")

    it = iter(failing())
    pl = autotune.HostPipeline(fill=lambda: next(it), depth=3)
    got = [pl.get() for _ in range(10)]
    assert got == fed
    with pytest.raises(RuntimeError, match="stream died"):
        pl.get()
    pl.close()

    # clean end-of-stream raises StopIteration, close() never hangs
    it2 = iter([1, 2])
    pl2 = autotune.HostPipeline(fill=lambda: next(it2), depth=2)
    assert pl2.get() == 1 and pl2.get() == 2
    with pytest.raises(StopIteration):
        pl2.get()
    pl2.close()


def test_pipeline_thread_stops_when_consumer_abandons():
    it = iter(range(1000))
    gen_closed = threading.Event()

    def fill():
        try:
            return next(it)
        except StopIteration:
            gen_closed.set()
            raise

    pl = autotune.HostPipeline(fill=fill, depth=2)
    assert pl.get() == 0
    pl.close()
    assert not pl._thread.is_alive()
    # A post-close get() must raise, not park on a condition no worker
    # will ever signal (buffered leftovers still drain first).
    while True:
        try:
            pl.get()
        except StopIteration:
            break


def test_async_host_runs_work_in_order_and_bounds_queue():
    host = autotune.AsyncHost(capacity=64)
    ran = []
    done = threading.Event()
    for i in range(10):
        assert host.submit(ran.append, i)
    host.submit(lambda: done.set())
    assert done.wait(5)
    assert ran == list(range(10))
    host.close()
    assert not host.submit(ran.append, 99)    # closed → refused

    # a wedged worker bounds the queue and counts drops
    gate = threading.Event()
    slow = autotune.AsyncHost(capacity=2)
    slow.submit(gate.wait)                    # parks the worker
    time.sleep(0.05)
    assert slow.submit(lambda: None)
    assert slow.submit(lambda: None)
    assert not slow.submit(lambda: None)      # over capacity → dropped
    assert slow.dropped == 1
    gate.set()
    slow.close()


def test_heartbeat_async_sink_defers_posts_but_not_startup():
    posts = []
    gate = threading.Event()

    def poster(_url, body):
        gate.wait(5)
        posts.append(body)

    reporter = heartbeat_mod.HeartbeatReporter(
        "http://x", "j", poster=poster, clock=lambda: 0.0)
    host = autotune.AsyncHost()
    reporter.async_sink = host.submit
    # steady beat: accepted for async delivery, nothing posted yet
    assert reporter.report(5, {"loss": 1.0})
    assert posts == []
    # startup-carrying beat: synchronous (its ACK protocol needs the
    # real verdict) — the poster runs on THIS thread once ungated
    gate.set()
    assert reporter.report(6, {"loss": 0.9},
                           startup={"compileSeconds": 1.0})
    assert any("startup" in p for p in posts)
    host.close()
    assert len(posts) == 2                    # the deferred beat drained
    assert any(p.get("startup") == {"compileSeconds": 1.0} for p in posts)


def test_interval_of_is_the_single_cadence_source():
    class _NoInterval:
        pass

    class _Bad:
        interval = "soon"

    class _Neg:
        interval = -3

    assert heartbeat_mod.interval_of(None) == heartbeat_mod.DEFAULT_INTERVAL
    assert heartbeat_mod.interval_of(_NoInterval()) == \
        heartbeat_mod.DEFAULT_INTERVAL
    assert heartbeat_mod.interval_of(_Bad()) == heartbeat_mod.DEFAULT_INTERVAL
    assert heartbeat_mod.interval_of(_Neg()) == heartbeat_mod.DEFAULT_INTERVAL
    reporter = heartbeat_mod.HeartbeatReporter("http://x", "j",
                                               interval=3.5)
    assert heartbeat_mod.interval_of(reporter) == 3.5


def test_attach_withholds_checkpoint_knob_in_multiprocess():
    """A gang's save is a collective: the cadence knob must not be wired
    when the gang has more than one process (a unilaterally stretched
    maybe_save gate wedges the save barrier); the per-process-local
    knobs stay available."""
    class _Ck:
        cadence_multiplier = 1
        save_every = 10

    for procs, wired in ((1, True), (4, False)):
        rt = autotune.from_env(prefetch=0, env={
            autotune.ENV_PREFETCH_DEPTH: "0", autotune.ENV_AUTOTUNE: "1"})
        ck = _Ck()
        rt.attach(recorder=steptrace.StepRecorder(capacity=8),
                  checkpointer=ck, processes=procs)
        assert (rt.controller._checkpointer is ck) is wired, procs
        assert rt.controller._enable_host_async is not None
        rt.close()


def test_runtime_wire_and_host_toggle():
    rt = autotune.from_env(prefetch=0, env={
        autotune.ENV_PREFETCH_DEPTH: "0", autotune.ENV_AUTOTUNE: "1",
        autotune.ENV_WINDOW_STEPS: "8"})
    posts = []
    reporter = heartbeat_mod.HeartbeatReporter(
        "http://x", "j", poster=lambda _u, b: posts.append(b),
        clock=lambda: 0.0)
    rec = steptrace.StepRecorder(capacity=16)
    rt.attach(recorder=rec, heartbeat=reporter)
    assert rec.on_commit == rt.controller.on_step
    wire = rt.wire()
    assert wire["prefetchDepth"] == autotune.DEFAULT_PREFETCH_DEPTH
    assert wire["hostAsync"] is False
    assert wire["adjustments"]["prefetchUp"] == 0
    # the controller's host knob swaps the reporter's sink live
    rt._apply_host_async(True)
    assert reporter.async_sink is not None
    rt._apply_host_async(False)
    assert reporter.async_sink is None
    rt.close()


def test_gang_agreed_cadence_disagreeing_gang(tmp_path):
    """The disagreeing-gang regression: one member's controller proposes
    a 4x stretch while a peer still proposes 1 — the allgather-min
    agreement lands on 1, every member saves at the base interval, and
    the save barrier never mismatches. The collective runs ONLY at
    base-interval boundaries (spec-uniform), so participation is
    identical on every process regardless of local proposals."""
    calls = []

    def peer_agrees_one(mult):  # a gang peer still proposes 1 → min 1
        calls.append(mult)
        return min(int(mult), 1)

    ck = checkpoint.Checkpointer(str(tmp_path / "a"), save_every=10,
                                 agree_fn=peer_agrees_one)
    try:
        ck.cadence_multiplier = 4
        # Without gang mode the local proposal applies directly and the
        # collective NEVER runs (single-process back-compat).
        assert ck._effective_cadence_multiplier(20) == 4
        assert calls == []
        ck.enable_gang_cadence()
        # Non-boundary steps skip the collective on every process alike
        # and gate on the gang's last agreement (none yet: 1), never on
        # the local proposal.
        assert ck._effective_cadence_multiplier(25) == 1
        assert calls == []
        # Boundary: agreement → the gang saves at the base cadence.
        assert ck._effective_cadence_multiplier(20) == 1
        assert calls == [4]
        assert ck._effective_cadence_multiplier(25) == 1
        # The un-withheld knob is live end to end: maybe_save at a base
        # boundary SAVES despite the local 4x proposal.
        assert ck.maybe_save(10, tiny_state(10)) is True
        ck.flush()
        assert ck.last_verified_step() == 10
    finally:
        ck.close()


def test_gang_agreed_cadence_uniform_gang_stretches(tmp_path):
    """The agreeing gang actually gets the stretch: every member proposes
    2, the min is 2, and only every 2nd base boundary saves."""
    ck = checkpoint.Checkpointer(str(tmp_path / "u"), save_every=10,
                                 agree_fn=lambda m: m)
    try:
        ck.enable_gang_cadence()
        ck.cadence_multiplier = 2
        assert ck.maybe_save(10, tiny_state(10)) is False  # stretched away
        assert ck.maybe_save(20, tiny_state(20)) is True
        ck.flush()
        assert ck.last_verified_step() == 20
    finally:
        ck.close()


def test_attach_unwithholds_cadence_knob_via_gang_agreement():
    """DataPlaneRuntime.attach: a multi-process job's checkpointer is no
    longer withheld — it is switched into gang-agreed cadence mode; an
    object WITHOUT the agreement surface stays withheld (never a wedged
    barrier)."""

    class AgreedCk:
        cadence_multiplier = 1
        save_every = 10
        enabled = False

        def enable_gang_cadence(self):
            self.enabled = True

    class LegacyCk:
        cadence_multiplier = 1
        save_every = 10

    control = autotune.PrefetchControl(2)
    ctl_ = autotune.DataPlaneController(control)
    runtime = autotune.DataPlaneRuntime(2, control=control,
                                        controller=ctl_, pipeline=True,
                                        active=True)
    ck = AgreedCk()
    runtime.attach(checkpointer=ck, processes=4)
    assert ck.enabled is True
    assert ctl_._checkpointer is ck
    # Single-process: wired directly, gang mode NOT flipped on.
    ck2 = AgreedCk()
    ctl2 = autotune.DataPlaneController(autotune.PrefetchControl(2))
    runtime2 = autotune.DataPlaneRuntime(2, control=runtime.control,
                                         controller=ctl2, pipeline=True,
                                         active=True)
    runtime2.attach(checkpointer=ck2, processes=1)
    assert ck2.enabled is False
    assert ctl2._checkpointer is ck2
    # No agreement surface: withheld in a gang (barrier safety first).
    ctl3 = autotune.DataPlaneController(autotune.PrefetchControl(2))
    runtime3 = autotune.DataPlaneRuntime(2, control=runtime.control,
                                         controller=ctl3, pipeline=True,
                                         active=True)
    runtime3.attach(checkpointer=LegacyCk(), processes=4)
    assert ctl3._checkpointer is None



# --- the port against the reference -------------------------------------------


def test_wire_keys_and_constants_equal_the_reference():
    assert autotune.ADJUSTMENT_KEYS == jautotune.ADJUSTMENT_KEYS
    assert autotune.KNOB_OF == jautotune.KNOB_OF
    for name in ("ENV_PREFETCH_DEPTH", "ENV_AUTOTUNE", "ENV_MIN_DEPTH",
                 "ENV_MAX_DEPTH", "ENV_WINDOW_STEPS",
                 "DEFAULT_PREFETCH_DEPTH", "DEFAULT_MIN_DEPTH",
                 "DEFAULT_MAX_DEPTH", "DEFAULT_WINDOW_STEPS",
                 "CHECKPOINT_CADENCE_CAP", "RESIDUE_FLOOR_FRACTION",
                 "HYSTERESIS_FRACTION", "STEP_GUARD_FRACTION",
                 "MIN_WINDOW_STEPS", "HOLD_WINDOWS"):
        assert getattr(autotune, name) == getattr(jautotune, name), name


class _Cadence:
    """The checkpointer surface the controller moves."""

    def __init__(self):
        self.cadence_multiplier = 1
        self.save_every = 10


def _controller(mod):
    control = mod.PrefetchControl(2)
    toggles = []
    ck = _Cadence()
    ctl = mod.DataPlaneController(control, min_depth=1, max_depth=5,
                                  window_steps=8,
                                  enable_host_async=toggles.append,
                                  checkpointer=ck)
    return ctl, control, toggles, ck


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_digests_same_decisions_as_the_reference(seed):
    """A seeded stream of step records, with regimes that favour each
    knob and windows that regress, fed to both controllers: at every
    window the depth, the host path, the cadence and every adjustment
    counter agree."""
    rng = np.random.default_rng(seed)
    ours, theirs = _controller(autotune), _controller(jautotune)
    moved = set()
    for window in range(48):
        regime = rng.integers(0, 4)
        scale = 1.0 + (0.5 if rng.random() < 0.25 else 0.0)
        for _ in range(8):
            compute = 0.010 * scale * (1.0 + 0.02 * rng.standard_normal())
            rec = {
                steptrace.DATA: abs(rng.normal(0.004 if regime == 0
                                               else 0.0002, 0.0005)),
                steptrace.HOST: abs(rng.normal(0.004 if regime == 1
                                               else 0.0002, 0.0005)),
                steptrace.CHECKPOINT: abs(rng.normal(
                    0.004 if regime == 2 else 0.0, 0.0005)),
                steptrace.COMPUTE: compute,
            }
            rec["seconds"] = sum(rec.values())
            assert steptrace.DATA == jsteptrace.DATA
            ours[0].on_step(dict(rec))
            theirs[0].on_step(dict(rec))
        a = (ours[1].depth, ours[0].host_async, ours[3].cadence_multiplier,
             ours[0].adjustments(), ours[2])
        b = (theirs[1].depth, theirs[0].host_async,
             theirs[3].cadence_multiplier, theirs[0].adjustments(),
             theirs[2])
        assert a == b, f"window {window}"
        moved |= {k for k, v in a[3].items() if v}
    # The stream exercised climbs and reverts of more than one knob.
    assert {"prefetchUp", "hostUp", "checkpointUp"} & moved
    assert len(moved) >= 3


def _byte_stream(n, rows=4):
    rng = np.random.default_rng(7)
    for _ in range(n):
        yield (rng.normal(size=(rows, 3)).astype(np.float32),
               rng.integers(0, 9, size=(rows,)).astype(np.int32))


def test_device_prefetch_rejects_negative_depth():
    with pytest.raises(ValueError):
        list(data_mod.device_prefetch(iter([]), "cpu", depth=-2))


def test_dynamic_depth_resize_preserves_order_byte_identically():
    static = [tuple(a.tobytes() for a in b) for b in _byte_stream(20)]
    control = autotune.PrefetchControl(1)
    out = []
    for i, b in enumerate(data_mod.device_prefetch(
            _byte_stream(20), "cpu", depth=1, control=control)):
        out.append(tuple(t.numpy().tobytes() for t in b))
        if i == 3:
            control.set_depth(7)              # grow mid-stream
        if i == 11:
            control.set_depth(1)              # shrink mid-stream
    assert out == static


@pytest.mark.parametrize("resize", [False, True])
def test_pipelined_device_prefetch_matches_the_sync_stream(resize):
    sync = [tuple(t.numpy().tobytes() for t in b)
            for b in data_mod.device_prefetch(_byte_stream(16), "cpu",
                                              depth=2)]
    control = autotune.PrefetchControl(2) if resize else None
    piped = []
    for i, b in enumerate(data_mod.device_prefetch(
            _byte_stream(16), "cpu", depth=2, control=control,
            pipeline=True)):
        piped.append(tuple(t.numpy().tobytes() for t in b))
        if resize and i == 2:
            control.set_depth(6)
        if resize and i == 9:
            control.set_depth(1)
    assert piped == sync


def test_pipelined_device_prefetch_raises_at_the_failing_batch():
    def failing():
        yield from _byte_stream(5)
        raise OSError("dataset mount went away")

    got = []
    with pytest.raises(OSError, match="mount went away"):
        for b in data_mod.device_prefetch(failing(), "cpu", depth=3,
                                          pipeline=True):
            got.append(b)
    assert len(got) == 5
    assert not [t for t in threading.enumerate()
                if t.name == "dataplane-pipeline" and t.is_alive()]


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


def test_train_loop_dataplane_body_passes_the_reference_server():
    """A classifier run with autotune on, every step due: each beat's
    dataPlane body passes the reference server's sanitizer unchanged
    (known keys, sane values), the knobs moved timing only (the losses
    equal a static run's), and the controller evaluated its windows."""
    server = StatusServer(0, metrics=Metrics())
    server.start()
    ctl = _Controller()
    server.set_controller(ctl)
    base = ["--batch", "16", "--blocks", "1", "--widths", "8", "8", "8",
            "--log-every", "0", "--steps", "18", "--checkpoint-dir", "",
            "--profile-dir", "", "--device", "cpu"]

    def run(dataplane, heartbeat):
        built = cifar.build(cifar.parse_args(base))
        losses = []

        def step(images, labels):
            m = built.step(images, labels)
            losses.append(float(m["loss"]))
            return m

        train.train_loop(step, built.batches, 18, device="cpu",
                         heartbeat=heartbeat,
                         steptrace=steptrace.StepRecorder(capacity=32),
                         dataplane=dataplane)
        return losses

    bodies = []

    def poster(_url, body):
        ok, msg = server.record_heartbeat(body)
        assert ok, msg
        bodies.append(body)
        return {}

    try:
        runtime = autotune.from_env(prefetch=2, env={
            autotune.ENV_PREFETCH_DEPTH: "0", autotune.ENV_AUTOTUNE: "1",
            autotune.ENV_WINDOW_STEPS: "8"})
        rep = heartbeat_mod.HeartbeatReporter(
            "http://s", "jb", interval=0.0, poster=poster)
        tuned = run(runtime, rep)
        static = run(None, None)
    finally:
        server.stop()
    assert tuned == static
    sent = [b["dataPlane"] for b in bodies if "dataPlane" in b]
    kept = [hb["dataPlane"] for hb in ctl.beats if "dataPlane" in hb]
    assert len(sent) == 18 and kept == sent
    assert set(sent[-1]["adjustments"]) == set(autotune.ADJUSTMENT_KEYS)
    assert runtime.controller.windows_evaluated == 2


# --- the gang-agreed cadence across two processes --------------------------------

GANG_SCRIPT = textwrap.dedent('''
    import json, sys
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, sys.argv[1])
    from tpu_operator_torch.payload import autotune, bootstrap, checkpoint

    out, ckdir, proposal = sys.argv[2], sys.argv[3], int(sys.argv[4])

    def payload(info):
        ck = checkpoint.Checkpointer(ckdir, save_every=10)
        rt = autotune.from_env(prefetch=2, env={
            autotune.ENV_PREFETCH_DEPTH: "0", autotune.ENV_AUTOTUNE: "1"})
        rt.attach(checkpointer=ck, processes=bootstrap.world_size())
        ck.cadence_multiplier = proposal
        saved = []
        for step in range(5, 85, 5):
            w = torch.arange(8, dtype=torch.float32) + step
            if ck.maybe_save(step, checkpoint.TrainState({"w": w})):
                saved.append(step)
        ck.flush()
        ck.close()
        with open(out, "w") as f:
            json.dump({"saved": saved, "verified": ck.last_verified_step(),
                       "wired": rt.controller._checkpointer is ck}, f)

    sys.exit(bootstrap.run_payload(payload, device="cpu"))
''')


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.mark.parametrize("proposals,saved", [
    ((4, 2), [5, 20, 40, 60, 80]),
    ((4, 1), [5, 10, 20, 30, 40, 50, 60, 70, 80]),
], ids=["min_is_2", "a_member_at_1"])
def test_gang_agreed_cadence_across_two_gloo_processes(tmp_path, proposals,
                                                       saved):
    """Two processes propose different stretches before their first save;
    each base-interval boundary takes the gang's MIN and the steps between
    gate on the last agreement, so both save the same steps (the save is
    a collective: a mismatch would hang the pair), the attempt's first
    save at once, and end on the same verified step."""
    port = _free_port()
    procs = []
    for rank, proposal in enumerate(proposals):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_PROCESS_ID=str(rank), JAX_NUM_PROCESSES="2",
                   OMP_NUM_THREADS="1")
        for var in ("TPUJOB_STATUS_URL", "TPU_CHECKPOINT_DIR",
                    "TPUJOB_STORE_URI"):
            env.pop(var, None)
        out = tmp_path / f"r{rank}.json"
        procs.append((out, subprocess.Popen(
            [sys.executable, "-c", GANG_SCRIPT, str(REPO), str(out),
             str(tmp_path / "ck"), str(proposal)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    try:
        logs = [p.communicate(timeout=120)[0] for _o, p in procs]
    except subprocess.TimeoutExpired:
        for _o, p in procs:
            p.kill()
        pytest.fail("the gang's processes did not finish in 120 s")
    results = []
    for (out, proc), log in zip(procs, logs):
        assert proc.returncode == 0, log[-3000:]
        results.append(json.loads(out.read_text()))
    for r in results:
        assert r == {"saved": saved, "verified": 80, "wired": True}
