"""The port's checkpoint / resume (tpu_operator_torch.payload.checkpoint,
its wiring into train.train_loop, transformer.run and serve.ServeLoop) on
the CPU.

Each test that mirrors one of tests/test_checkpoint.py or
tests/test_checkpoint_durability.py (the JAX package's) carries its name.
Some are held against the JAX package itself: the heartbeat body, the
postmortem path, the manifest's sha256, and a resumed training trajectory
against the reference's unbroken one. The rest hold the port to itself:
two runs sharing a checkpoint directory are bit-equal to one unbroken
run. Every model here is the tiny LM of tests/test_torch_train.py.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

from tpu_operator.payload import checkpoint as jcheckpoint
from tpu_operator.payload import heartbeat as jheartbeat
from tpu_operator.payload import steptrace as jsteptrace
from tpu_operator.payload import transformer as jtransformer
from tpu_operator_torch.payload import bootstrap
from tpu_operator_torch.payload import checkpoint
from tpu_operator_torch.payload import data
from tpu_operator_torch.payload import heartbeat
from tpu_operator_torch.payload import optimizers
from tpu_operator_torch.payload import serve
from tpu_operator_torch.payload import steptrace
from tpu_operator_torch.payload import train
from tpu_operator_torch.payload import transformer
from tpu_operator_torch.payload import weights

TINY = ["--dim", "64", "--layers", "2", "--heads", "4", "--kv-heads", "2",
        "--vocab", "256", "--seq-len", "64", "--batch", "4",
        "--grad-accum", "2", "--log-every", "0", "--seed", "0",
        "--checkpoint-dir", "", "--profile-dir", "", "--device", "cpu"]

EXIT_RETRYABLE = bootstrap.EXIT_RETRYABLE


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """One intra-op thread (the bit-equality checks need every run to
    round alike), a clean drain latch, and none of the operator's env."""
    for var in ("TPU_CHECKPOINT_DIR", "TPUJOB_ATTEMPT", "JAX_PROCESS_ID",
                "TPUJOB_STATUS_URL", "TPUJOB_STORE_URI"):
        monkeypatch.delenv(var, raising=False)
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    bootstrap.reset_drain()
    yield
    bootstrap.reset_drain()
    torch.set_num_threads(before)


def tiny_state(step=0):
    """A raw state (no model): one param and an adam state with a bf16
    mu, every value a function of ``step``."""
    return checkpoint.TrainState(
        {"w": torch.arange(64, dtype=torch.float32) + step},
        optimizers.AdamState(
            count=step,
            mu=[torch.full((64,), step / 4, dtype=torch.bfloat16)],
            nu=[torch.full((3, 5), step / 8, dtype=torch.float32)]))


def assert_state_equal(got, want):
    assert got.params.keys() == want.params.keys()
    for name in want.params:
        assert torch.equal(got.params[name], want.params[name]), name
    if want.opt is None:
        assert got.opt is None
        return
    assert got.opt.count == want.opt.count
    for a, b in zip(got.opt.mu + got.opt.nu, want.opt.mu + want.opt.nu):
        assert a.dtype == b.dtype and torch.equal(a, b)


def make_ck(path, **kw):
    kw.setdefault("save_every", 2)
    return checkpoint.Checkpointer(str(path), **kw)


def save_steps(path, steps):
    ck = make_ck(path, save_every=1)
    for s in steps:
        assert ck.maybe_save(s, tiny_state(s))
    ck.close()
    return ck


def corrupt_a_file(step_dir, keep_size=False):
    """Damage the params file of a step dir (the one every restore
    reads): overwrite bytes in place, or append (a torn size)."""
    victim = os.path.join(step_dir, checkpoint.PARAMS_FILE)
    if keep_size:
        with open(victim, "r+b") as f:
            f.seek(os.path.getsize(victim) // 2)
            f.write(b"\xde\xad\xbe\xef")
    else:
        with open(victim, "ab") as f:
            f.write(b"TORN")
    return victim


def _build(extra=()):
    return transformer.build(transformer.parse_args(TINY + list(extra)))


def _loop(built, steps, ck=None, **kw):
    """train_loop over ``built`` to ``steps`` total; returns the loss of
    every step this run trained."""
    losses = []

    def step(tokens):
        metrics = built.step(tokens)
        losses.append(float(metrics["loss"]))
        return metrics

    train.train_loop(step, built.batches, steps, device="cpu",
                     heartbeat=None, steptrace=None, checkpointer=ck,
                     state=built.state, **kw)
    return losses


# --- from_env_or_args --------------------------------------------------------


def test_from_env_or_args_unconfigured_is_none():
    assert checkpoint.from_env_or_args("", env={}) is None


def test_from_env_or_args_env_fallback(tmp_path):
    ck = checkpoint.from_env_or_args(
        "", env={"TPU_CHECKPOINT_DIR": str(tmp_path / "ck")})
    assert ck is not None
    assert ck.directory == str(tmp_path / "ck")
    ck.close()


def test_from_env_or_args_attaches_the_store_uploader(tmp_path):
    """With the operator's store env, process 0's checkpointer gets the
    write-behind uploader: a verified save lands in the store, and its
    counters ride stats(); any other process gets none."""
    from tpu_operator_torch.payload.store import WarmStartStore, blob

    env = {"TPUJOB_STORE_URI": str(tmp_path / "store"),
           "TPUJOB_NAMESPACE": "ns", "TPUJOB_NAME": "jb"}
    ck = checkpoint.from_env_or_args(str(tmp_path / "ck"), save_every=1,
                                     env=env)
    assert ck is not None and ck.uploader is not None
    assert ck.maybe_save(1, tiny_state(1))
    ck.flush()
    assert ck.uploader.flush(30.0)
    assert ck.stats()["lastUploadedStep"] == 1
    ck.close()
    remote = WarmStartStore(blob.from_uri(str(tmp_path / "store")),
                            prefix="ns/jb")
    assert remote.checkpoint_steps() == [1]
    other = checkpoint.from_env_or_args(
        str(tmp_path / "ck2"), env={**env, "JAX_PROCESS_ID": "1"})
    assert other.uploader is None
    other.close()


# --- save / restore ----------------------------------------------------------


def test_save_restore_roundtrip(tmp_path):
    """Three trained steps saved, then a fresh build (the restarted
    group's) restores them: params, mu, nu and count bit-equal."""
    built = _build(["--adam-mu-dtype", "bf16"])
    for _ in range(3):
        (tokens,) = next(built.batches)
        built.step(torch.from_numpy(tokens))
    ck = checkpoint.Checkpointer(str(tmp_path / "ck"), save_every=1)
    assert ck.maybe_save(3, built.state)
    ck.close()

    fresh = _build(["--adam-mu-dtype", "bf16"])
    assert not torch.equal(fresh.model.tok_embed.weight,
                           built.model.tok_embed.weight)
    ck2 = checkpoint.Checkpointer(str(tmp_path / "ck"), save_every=1)
    restored, start = ck2.restore(fresh.state)
    ck2.close()
    assert start == 3
    assert fresh.opt_state.count == 3
    assert fresh.opt_state.mu[0].dtype == torch.bfloat16
    assert_state_equal(restored, built.state)
    # In place: the step function's tensors are the restored ones.
    assert restored.params["tok_embed.weight"] is fresh.model.tok_embed.weight


def test_restore_without_checkpoint_is_identity(tmp_path):
    built = _build()
    before = {n: p.clone() for n, p in built.state.params.items()}
    state = built.state
    ck = checkpoint.Checkpointer(str(tmp_path / "empty"), save_every=1)
    same, start = ck.restore(state)
    ck.close()
    assert start == 0
    assert same is state
    for name, p in state.params.items():
        assert torch.equal(p, before[name])


def test_train_loop_resumes_to_target_total(tmp_path):
    """``steps`` is the target total: a restart with a step-4 checkpoint
    runs only the remaining steps, lands on step 6 and saves it."""
    ckdir = str(tmp_path / "ck")
    built = _build()
    ck = checkpoint.Checkpointer(ckdir, save_every=2)
    assert len(_loop(built, 4, ck)) == 4
    ck.close()
    assert built.opt_state.count == 4

    fresh = _build()
    ck2 = checkpoint.Checkpointer(ckdir, save_every=2)
    assert ck2.latest_step() == 4
    assert len(_loop(fresh, 6, ck2)) == 2
    ck2.close()
    assert fresh.opt_state.count == 6
    assert checkpoint.Checkpointer(ckdir).latest_step() == 6


def test_resume_fast_forwards_data_stream(tmp_path):
    """The resumed run consumes batches start..steps-1, not
    0..remaining: the seeded stream is advanced past what the first
    attempt trained on (a bounded prefetch look-ahead may read more)."""
    ckdir = str(tmp_path / "ck")
    built = _build()
    ck = checkpoint.Checkpointer(ckdir, save_every=1)
    _loop(built, 4, ck)
    ck.close()

    args = transformer.parse_args(TINY)
    consumed, seen = [], []

    def counting_stream():
        for i, b in enumerate(data.lm_batches(args)):
            consumed.append(i)
            yield b

    fresh = _build()

    def step(tokens):
        seen.append(tokens.clone())
        return fresh.step(tokens)

    ck2 = checkpoint.Checkpointer(ckdir, save_every=1)
    train.train_loop(step, counting_stream(), 6, device="cpu",
                     heartbeat=None, steptrace=None, checkpointer=ck2,
                     state=fresh.state)
    ck2.close()
    assert consumed[:6] == [0, 1, 2, 3, 4, 5]
    assert len(consumed) <= 6 + 2
    stream = data.lm_batches(args)
    want = [next(stream)[0] for _ in range(6)][4:]
    assert [t.numpy().tobytes() for t in seen] \
        == [w.tobytes() for w in want]


def test_interval_policy_skips_off_interval_steps(tmp_path):
    """orbax's policy, which the reference uses: the first save of an
    attempt lands at once, then only steps on the interval."""
    ck = checkpoint.Checkpointer(str(tmp_path / "ck"), save_every=10)
    assert ck.maybe_save(1, tiny_state(1))       # first save always lands
    assert not ck.maybe_save(2, tiny_state(2))   # off-interval: skipped
    assert not ck.maybe_save(9, tiny_state(9))
    assert ck.maybe_save(10, tiny_state(10))     # on the interval: saved
    ck.close()
    assert ck.all_steps() == [1, 10]


def test_sigterm_drain_checkpoints_current_step(tmp_path):
    """The first SIGTERM drains: train_loop saves the CURRENT step (not
    the last interval save) and exits retryable."""
    built = _build()
    ck = checkpoint.Checkpointer(str(tmp_path / "ck"), save_every=1000)

    def drain_after_step_3(i, _metrics):
        if i == 3:
            bootstrap.request_drain()

    with pytest.raises(SystemExit) as exc:
        _loop(built, 50, ck, log_every=1, log_fn=drain_after_step_3)
    assert exc.value.code == EXIT_RETRYABLE
    ck.close()
    # The drain fired entering step index 3 (3 steps completed); step 1
    # is the attempt's first interval save.
    assert ck.all_steps() == [1, 3]
    assert ck.last_verified_step() == 3
    fresh = _build()
    _state, start = checkpoint.Checkpointer(str(tmp_path / "ck")).restore(
        fresh.state)
    assert start == 3 and fresh.opt_state.count == 3


def test_drain_without_checkpointer_still_exits_retryable():
    built = _build()
    bootstrap.request_drain()
    with pytest.raises(SystemExit) as exc:
        _loop(built, 5)
    assert exc.value.code == EXIT_RETRYABLE
    assert built.opt_state.count == 0


# --- verified saves ----------------------------------------------------------


def test_verified_save_writes_manifest_and_tracks_step(tmp_path):
    ck = make_ck(tmp_path / "ck")
    assert ck.maybe_save(1, tiny_state(1))
    assert ck.maybe_save(2, tiny_state(2))
    ck.close()
    assert ck.last_verified_step() == 2
    manifest = tmp_path / "ck" / "2" / checkpoint.MANIFEST_NAME
    assert manifest.exists()
    doc = json.loads(manifest.read_text())
    assert doc["step"] == 2
    assert sorted(e["path"] for e in doc["files"]) == [
        checkpoint.META_FILE, checkpoint.OPT_FILE, checkpoint.PARAMS_FILE]
    assert all({"path", "size", "sha256"} <= set(e) for e in doc["files"])
    assert ck.stats() == {"saveFailures": 0, "restoreFallbacks": 0,
                          "lastCheckpointStep": 2}
    meta = json.loads((tmp_path / "ck" / "2" / checkpoint.META_FILE
                       ).read_text())
    assert meta["step"] == 2 and meta["adamMuDtype"] == "bf16"
    assert meta["tensors"]["opt.pt"]["mu.0"] == {"shape": [64],
                                                 "dtype": "bfloat16"}
    # Nothing but finalized steps is left in the directory.
    assert sorted(os.listdir(tmp_path / "ck")) == ["1", "2"]


def test_last_verified_lags_latest_until_commit_checked(tmp_path):
    ck = make_ck(tmp_path / "ck")
    assert ck.maybe_save(1, tiny_state(1))
    # The save may already be on disk, but it has not been VERIFIED on
    # the step loop's thread yet: it is not advertised as durable.
    assert ck.last_verified_step() is None
    ck.close()  # flush + verify
    assert ck.last_verified_step() == 1


def test_save_dedups_in_flight_interval_save_of_same_step(tmp_path):
    """save() of a step whose interval save is in flight finalizes that
    save and skips: no second write."""
    ck = make_ck(tmp_path / "ck")
    assert ck.maybe_save(2, tiny_state(2))  # in flight
    calls = []
    real = ck._commit

    def spying_commit(*a, **kw):
        calls.append(a[0])
        return real(*a, **kw)

    ck._commit = spying_commit
    assert ck.save(2, tiny_state(2)) is False
    assert calls == []
    assert ck.last_verified_step() == 2
    ck.close()


def test_save_still_writes_new_final_step(tmp_path):
    ck = make_ck(tmp_path / "ck")
    assert ck.maybe_save(2, tiny_state(2))
    assert ck.save(3, tiny_state(3)) is True
    ck.close()
    assert ck.latest_step() == 3
    assert ck.last_verified_step() == 3


def test_max_to_keep_drops_the_oldest_steps(tmp_path):
    ck = make_ck(tmp_path / "ck", save_every=1, max_to_keep=2)
    for s in (1, 2, 3, 4):
        assert ck.maybe_save(s, tiny_state(s))
    ck.close()
    assert ck.all_steps() == [3, 4]


def test_saving_a_step_an_earlier_attempt_left_replaces_it(tmp_path):
    """A gang that resumed below a step some process still holds saves
    that step again: the new bytes replace the old ones."""
    save_steps(tmp_path / "ck", [2, 4])
    ck = make_ck(tmp_path / "ck")
    assert ck.save(4, tiny_state(40))
    ck.close()
    assert ck.last_verified_step() == 4
    got = tiny_state(0)
    _state, start = make_ck(tmp_path / "ck").restore(got)
    assert start == 4
    assert_state_equal(got, tiny_state(40))
    assert sorted(os.listdir(tmp_path / "ck")) == ["2", "4"]


# --- save-failure tolerance --------------------------------------------------


def _exploding(*_a, **_kw):
    raise OSError(28, "No space left on device")


def test_interval_save_failure_is_skipped_and_counted(tmp_path):
    """The write runs in the background, so the port counts a failed
    save where it finalizes it (the next boundary or a flush) where the
    reference's synchronous orbax call counted it at once."""
    ck = make_ck(tmp_path / "ck", fail_after=3)
    ck._commit = _exploding
    assert ck.maybe_save(2, tiny_state(2))  # issued; fails in the writer
    ck.flush()
    assert ck.save_failures == 1
    assert ck.consecutive_save_failures == 1
    assert ck.stats() == {"saveFailures": 1, "restoreFallbacks": 0}
    del ck._commit  # healthy again
    assert ck.maybe_save(4, tiny_state(4))
    ck.flush()
    # A verified commit resets the streak, not the total.
    assert ck.consecutive_save_failures == 0
    assert ck.save_failures == 1
    assert ck.last_verified_step() == 4
    ck.close()


def test_consecutive_save_failures_escalate_retryable(tmp_path):
    ck = make_ck(tmp_path / "ck", fail_after=3)
    ck._commit = _exploding
    assert ck.maybe_save(2, tiny_state(2))
    assert ck.maybe_save(4, tiny_state(4))  # finalizes 2: failure 1
    assert ck.maybe_save(6, tiny_state(6))  # failure 2
    with pytest.raises(SystemExit) as exc:
        ck.maybe_save(8, tiny_state(8))     # failure 3: escalate
    assert exc.value.code == EXIT_RETRYABLE
    assert ck.save_failures == 3


def test_writer_handoff_under_a_short_switch_interval(tmp_path):
    """The writer thread's outcome handoff with a 1 us switch interval:
    40 saves, every third failing in the writer, each boundary also
    polled without blocking. Every save is applied exactly once: 13
    failures counted, the rest verified, the newest kept on disk."""
    ck = make_ck(tmp_path / "ck", save_every=1, fail_after=1000)
    real = ck._commit

    def flaky(step, snap):
        if step % 3 == 0:
            raise OSError("flaky volume")
        return real(step, snap)

    ck._commit = flaky
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for step in range(1, 41):
            assert ck.maybe_save(step, tiny_state(step))
            ck._finalize_pending(block=False)
        ck.flush()
    finally:
        sys.setswitchinterval(before)
    assert ck._thread is None and ck._pending is None
    assert ck.save_failures == 13
    assert ck.last_verified_step() == 40
    assert ck.all_steps() == [37, 38, 40]


def test_drain_save_failure_still_exits_retryable(tmp_path):
    """An error in the drain's save must not escape train_loop as a
    permanent exit: the drain still exits 143."""
    built = _build()
    ck = make_ck(tmp_path / "ck", save_every=1000)

    def exploding_save(_step, _state):
        raise RuntimeError("checkpoint volume vanished mid-drain")

    ck.save = exploding_save

    def drain_after_step_3(i, _metrics):
        if i == 3:
            bootstrap.request_drain()

    with pytest.raises(SystemExit) as exc:
        _loop(built, 50, ck, log_every=1, log_fn=drain_after_step_3)
    assert exc.value.code == EXIT_RETRYABLE
    ck.close()


def test_final_save_failure_exits_retryable_not_done(tmp_path):
    """The final save is load-bearing: when it never becomes durable the
    loop exits retryable and dumps the flight recorder at the postmortem
    path next to the checkpoint dir."""
    built = _build()
    ck = make_ck(tmp_path / "ck", save_every=1000, fail_after=100)
    ck._commit = _exploding
    recorder = steptrace.StepRecorder()
    with pytest.raises(SystemExit) as exc:
        train.train_loop(built.step, built.batches, 5, device="cpu",
                         heartbeat=None, steptrace=recorder,
                         checkpointer=ck, state=built.state)
    assert exc.value.code == EXIT_RETRYABLE
    assert ck.save_failures >= 1
    assert ck.last_verified_step() is None
    path = steptrace.postmortem_path(str(tmp_path / "ck"), 0, 0)
    assert path == str(tmp_path / "steptrace-attempt0-p0.json")
    body = json.loads(open(path).read())
    assert body["kind"] == "tpujob-steptrace"
    assert [row["step"] for row in body["steps"]] == [0, 1, 2, 3, 4]
    assert all("checkpoint" in row for row in body["steps"])
    ck.close()


def test_restore_failure_on_intact_bytes_raises_not_quarantines(tmp_path):
    """A load that raises on bytes that still verify against their
    manifest is NOT corruption: it surfaces as an error and no healthy
    step is quarantined."""
    save_steps(tmp_path / "ck", [2, 4])
    ck = make_ck(tmp_path / "ck")

    def incompatible(*_a, **_kw):
        raise ValueError("shape mismatch: saved (8,) vs live (16,)")

    ck._load = incompatible
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(tiny_state(0))
    ck.close()
    assert (tmp_path / "ck" / "4").is_dir()
    assert (tmp_path / "ck" / "2").is_dir()
    assert ck.restore_fallbacks == 0


def test_restore_into_a_model_of_another_width_raises(tmp_path):
    """The real case of the test above: a trainer's step loaded into a
    model of another width fails its shape check on intact bytes."""
    built = _build()
    ck = checkpoint.Checkpointer(str(tmp_path / "ck"), save_every=1)
    _loop(built, 2, ck)
    ck.close()
    wider = transformer.build(transformer.parse_args(
        TINY + ["--dim", "128"]))
    before = wider.model.tok_embed.weight.clone()
    with pytest.raises(checkpoint.CheckpointError, match="shape"):
        checkpoint.Checkpointer(str(tmp_path / "ck")).restore(wider.state)
    assert torch.equal(wider.model.tok_embed.weight, before)
    assert checkpoint.Checkpointer(str(tmp_path / "ck")).all_steps() \
        == [1, 2]


# --- the restore walk --------------------------------------------------------


def test_restore_empty_dir_is_identity(tmp_path):
    ck = make_ck(tmp_path / "empty")
    state = tiny_state(0)
    same, start = ck.restore(state)
    ck.close()
    assert start == 0
    assert same is state
    assert ck.restore_fallbacks == 0


def test_restore_missing_dir_is_identity(tmp_path):
    """A reader never creates the directory it walks (only process 0's
    writer would): a missing one is step 0."""
    ck = make_ck(tmp_path / "missing")
    state = tiny_state(0)
    assert ck.restore(state) == (state, 0)


def test_corrupt_latest_falls_back_to_older_verified_step(tmp_path):
    save_steps(tmp_path / "ck", [1, 2, 3])
    corrupt_a_file(str(tmp_path / "ck" / "3"), keep_size=True)  # checksum
    ck = make_ck(tmp_path / "ck")
    restored, start = ck.restore(tiny_state(0))
    ck.close()
    assert start == 2
    assert_state_equal(restored, tiny_state(2))
    assert ck.restore_fallbacks == 1
    assert ck.last_verified_step() == 2
    # Quarantined, not deleted.
    assert (tmp_path / "ck" / "3.corrupt-0" / checkpoint.PARAMS_FILE
            ).is_file()
    assert ck.all_steps() == [1, 2]


def test_torn_latest_size_mismatch_falls_back(tmp_path):
    save_steps(tmp_path / "ck", [1, 2])
    corrupt_a_file(str(tmp_path / "ck" / "2"), keep_size=False)  # size
    ck = make_ck(tmp_path / "ck")
    _restored, start = ck.restore(tiny_state(0))
    ck.close()
    assert start == 1
    assert ck.restore_fallbacks == 1


def test_orphaned_tmp_dir_from_killed_save_is_swept(tmp_path):
    """The litter a kill -9 mid-save leaves, in the port's own tmp
    naming (``<step>.tmp-<pid>-<n>``)."""
    save_steps(tmp_path / "ck", [1, 2])
    tmp_dir = tmp_path / "ck" / "4.tmp-123-1"
    tmp_dir.mkdir()
    (tmp_dir / checkpoint.PARAMS_FILE).write_bytes(b"half-written")
    ck = make_ck(tmp_path / "ck")
    _restored, start = ck.restore(tiny_state(0))
    ck.close()
    assert start == 2  # the tmp dir never shadows the real latest
    assert ck.restore_fallbacks == 0
    assert (tmp_path / "ck" / ("4.tmp-123-1" + checkpoint.ORPHAN_SUFFIX)
            ).is_dir()
    assert not tmp_dir.exists()


def test_all_corrupt_reaches_step_zero(tmp_path):
    save_steps(tmp_path / "ck", [1, 2])
    for step in ("1", "2"):
        corrupt_a_file(str(tmp_path / "ck" / step), keep_size=True)
    ck = make_ck(tmp_path / "ck")
    state = tiny_state(0)
    same, start = ck.restore(state)
    ck.close()
    assert start == 0
    assert same is state
    assert_state_equal(state, tiny_state(0))
    assert ck.restore_fallbacks == 2
    assert ck.stats()["restoreFallbacks"] == 2


def test_unmanifested_corrupt_step_quarantined_on_restore_failure(tmp_path):
    """A step without a manifest passes the static check; when its load
    then fails it is still quarantined and the walk goes on."""
    save_steps(tmp_path / "ck", [1, 2])
    os.remove(tmp_path / "ck" / "2" / checkpoint.MANIFEST_NAME)
    (tmp_path / "ck" / "2" / checkpoint.PARAMS_FILE).write_bytes(b"gutted")
    ck = make_ck(tmp_path / "ck")
    restored, start = ck.restore(tiny_state(0))
    ck.close()
    assert start == 1
    assert_state_equal(restored, tiny_state(1))
    assert ck.restore_fallbacks == 1


def test_gang_disagreement_restores_min_step(tmp_path):
    """This process saw 4, a lagging peer only 2: the gang restores the
    MIN; the agree round saw 4, the confirm round 2."""
    save_steps(tmp_path / "ck", [2, 4])
    seen = []

    def lagging_peer_agree(candidate):
        seen.append(candidate)
        return min(candidate, 2) if candidate is not None else None

    ck = make_ck(tmp_path / "ck", agree_fn=lagging_peer_agree)
    restored, start = ck.restore(tiny_state(0))
    ck.close()
    assert seen == [4, 2]
    assert start == 2
    assert_state_equal(restored, tiny_state(2))
    assert ck.last_verified_step() == 2


def test_peer_restore_failure_retries_walk_collectively(tmp_path):
    """A peer whose load of the agreed step failed reports None in the
    confirm round: this process discards its own successful load and
    re-agrees with the gang on an older step."""
    save_steps(tmp_path / "ck", [2, 4])
    calls = []

    def peer_restore_fails_once(candidate):
        calls.append(candidate)
        if len(calls) == 1:
            return candidate        # agree: everyone's newest is 4
        if len(calls) == 2:
            return None             # confirm: a peer's load of 4 failed
        if len(calls) == 3:
            return min(candidate, 2)  # re-agree: that peer fell back to 2
        return candidate            # confirm: everyone loaded 2

    ck = make_ck(tmp_path / "ck", agree_fn=peer_restore_fails_once)
    restored, start = ck.restore(tiny_state(0))
    ck.close()
    assert calls == [4, 4, 4, 2]
    assert start == 2
    assert_state_equal(restored, tiny_state(2))
    assert ck.restore_fallbacks == 0
    assert (tmp_path / "ck" / "4").is_dir()


def test_gang_agree_single_process_is_identity():
    assert checkpoint.gang_agree_step(7) == 7
    assert checkpoint.gang_agree_step(None) is None


# --- the heartbeat and the postmortem, held against the JAX package ----------


def test_heartbeat_carries_checkpoint_fields():
    posts = []
    r = heartbeat.HeartbeatReporter(
        "http://x:1", "job", poster=lambda _u, b: posts.append(b),
        clock=lambda: 0.0)
    assert r.report(5, {"loss": 1.0},
                    checkpoint={"lastCheckpointStep": 4, "saveFailures": 1,
                                "restoreFallbacks": 2})
    body = posts[0]
    assert body["lastCheckpointStep"] == 4
    assert body["checkpointSaveFailures"] == 1
    assert body["checkpointRestoreFallbacks"] == 2
    assert r.report(6, None, checkpoint={"saveFailures": 0,
                                         "restoreFallbacks": 0})
    assert "lastCheckpointStep" not in posts[1]
    cadence = heartbeat.HeartbeatReporter(
        "http://x:1", "job", poster=lambda _u, b: posts.append(b),
        clock=lambda: 0.0, cadence_only=True)
    assert cadence.report(7, None, checkpoint={"lastCheckpointStep": 4,
                                               "saveFailures": 1})
    assert not {"lastCheckpointStep", "checkpointSaveFailures"} & set(
        posts[2])


def test_heartbeat_checkpoint_body_matches_jax(monkeypatch):
    """The same stats dicts through the port's reporter and the JAX
    package's, each with ``_http_post`` stubbed: the same bodies."""
    def drive(mod):
        bodies = []
        monkeypatch.setattr(mod, "_http_post",
                            lambda _url, body: bodies.append(body) or {})
        ticks = iter(np.arange(0.0, 100.0, 0.5))
        rep = mod.HeartbeatReporter("http://s/", "j", namespace="ns",
                                    attempt=2, interval=0,
                                    clock=lambda: float(next(ticks)))
        for step, stats in enumerate([
                {"saveFailures": 0, "restoreFallbacks": 0},
                {"saveFailures": 0, "restoreFallbacks": 1,
                 "lastCheckpointStep": 3},
                {"saveFailures": 2, "restoreFallbacks": 1,
                 "lastCheckpointStep": 6},
                None], start=1):
            rep.report(step, {"loss": 2.5}, checkpoint=stats)
        return bodies

    ours, theirs = drive(heartbeat), drive(jheartbeat)
    assert len(ours) == 4 and ours == theirs
    assert ours[2]["checkpointSaveFailures"] == 2


@pytest.mark.parametrize("ckdir", [
    "/ckpt", "/ckpt/", "/ckpt/run1", "/mnt/vol/jobs/run7/", "/",
    "relative/dir"])
@pytest.mark.parametrize("attempt,pid", [(0, 0), (3, 5)])
def test_postmortem_path_matches_jax(ckdir, attempt, pid):
    assert steptrace.postmortem_path(ckdir, attempt, pid) \
        == jsteptrace.postmortem_path(ckdir, attempt, pid)


def test_postmortem_dump_falls_back_into_the_checkpoint_dir(tmp_path):
    """An unwritable sibling slot: the artifact lands inside the
    checkpoint dir instead, as in the reference."""
    ckdir = tmp_path / "ro" / "ck"
    ckdir.mkdir(parents=True)
    rec = steptrace.StepRecorder()
    rec.begin(0)
    rec.lap(steptrace.COMPUTE)
    rec.commit()
    sibling = steptrace.postmortem_path(str(ckdir), 1, 0)
    os.mkdir(sibling)  # a directory where the file should go
    path = steptrace.postmortem_dump(rec, str(ckdir),
                                     env={"TPUJOB_ATTEMPT": "1"})
    assert path == str(ckdir / "steptrace-attempt1-p0.json")
    body = json.loads(open(path).read())
    assert body["attempt"] == 1 and body["steps"][0]["step"] == 0
    assert steptrace.postmortem_dump(rec, "") is None


def test_manifest_sha256_matches_jax(tmp_path):
    save_steps(tmp_path / "ck", [3])
    root = tmp_path / "ck" / "3"
    doc = json.loads((root / checkpoint.MANIFEST_NAME).read_text())
    assert len(doc["files"]) == 3
    for entry in doc["files"]:
        path = str(root / entry["path"])
        assert entry["sha256"] == jcheckpoint._sha256_file(path)
        assert entry["size"] == os.path.getsize(path)


# --- resumed training against the reference and against itself ---------------


def test_resumed_trajectory_matches_jax(tmp_path):
    """The port trains 2 steps from the reference's weights (carried
    across with ``weights.from_flax``) and checkpoints, then a fresh
    model resumes to step 4; the JAX package trains the same 4 steps
    unbroken on the same batches. Held as test_torch_train.py's
    train-step parity holds the two: 5e-3 absolute per step."""
    jargs = jtransformer.parse_args(TINY[:-2])
    mesh = jtransformer.make_lm_mesh(num_devices=1)
    mesh, _model, jstate, jstep, jbatches = jtransformer.build(jargs,
                                                               mesh=mesh)
    params0 = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                     jstate.params)
    spec = jtransformer.lm_token_spec(mesh)
    from tpu_operator.payload import data as jdata

    jlosses = []
    for _ in range(4):
        (jb,) = next(jbatches)
        jstate, metrics = jstep(jstate, *jdata.put_global_batch(
            mesh, jb, spec=spec))
        jlosses.append(float(jax.device_get(metrics["loss"])))

    args = transformer.parse_args(TINY)

    def port_build():
        model = weights.from_flax(params0, heads=4,
                                  param_dtype=torch.float32)
        model.requires_grad_(True)
        optimizer = optimizers.from_args(args)
        opt_state = optimizer.init(list(model.parameters()))
        step = transformer.make_lm_train_step(model, optimizer, opt_state,
                                              grad_accum=args.grad_accum)
        state = checkpoint.TrainState(dict(model.named_parameters()),
                                      opt_state)
        return step, state

    losses = []
    for steps in (2, 4):
        step, state = port_build()

        def recording(tokens, step=step):
            metrics = step(tokens)
            losses.append(float(metrics["loss"]))
            return metrics

        ck = checkpoint.Checkpointer(str(tmp_path / "ck"), save_every=100)
        train.train_loop(recording, data.lm_batches(args), steps,
                         device="cpu", heartbeat=None, steptrace=None,
                         checkpointer=ck, state=state)
        ck.close()
        assert ck.last_verified_step() == steps
    assert len(losses) == 4
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=5e-3)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("extra", [
    ["--grad-accum", "1"],
    ["--grad-accum", "2", "--adam-mu-dtype", "bf16"],
], ids=["defaults", "grad_accum2_bf16_mu"])
def test_two_runs_sharing_the_dir_are_bit_equal_to_one(tmp_path,
                                                       monkeypatch, extra):
    """Attempt 0 trains 3 steps (saves 1, 2 and the final 3); attempt 1
    (TPUJOB_ATTEMPT=1, a fresh build from the same seed) restores 3 and
    trains to 6. Its losses and its final params, mu, nu and count are
    bit-equal to one unbroken 6-step run."""
    def args_for(ckdir):
        return transformer.parse_args(
            TINY + extra + ["--checkpoint-dir", ckdir,
                            "--checkpoint-every", "2"])

    def attempt(ckdir, steps):
        args = args_for(ckdir)
        built = transformer.build(args)
        ck = checkpoint.from_env_or_args(args.checkpoint_dir,
                                         save_every=args.checkpoint_every)
        try:
            losses = _loop(built, steps, ck)
        finally:
            if ck is not None:
                ck.close()
        return built, losses

    shared = str(tmp_path / "shared")
    _first, losses_a = attempt(shared, 3)
    monkeypatch.setenv("TPUJOB_ATTEMPT", "1")
    resumed, losses_b = attempt(shared, 6)
    monkeypatch.delenv("TPUJOB_ATTEMPT")
    unbroken = transformer.build(transformer.parse_args(TINY + extra))
    losses_u = _loop(unbroken, 6)
    assert len(losses_a) == 3 and len(losses_b) == 3
    assert losses_a + losses_b == losses_u
    assert_state_equal(resumed.state, unbroken.state)
    assert resumed.opt_state.count == 6
    # Attempt 1 saved 4 and 6; three steps are kept.
    assert checkpoint.Checkpointer(shared).all_steps() == [3, 4, 6]


# --- the server --------------------------------------------------------------

SERVE_WIDTHS = {"vocab": 32, "dim": 16, "heads": 2, "kv_heads": 1,
                "layers": 2}


def serve_args(**kw):
    values = {"load": "20:0.3", "batch": 2, "decode_tokens": 4,
              "window": 16, "device": "cpu", "checkpoint_dir": "",
              **SERVE_WIDTHS}
    values.update(kw)
    argv = []
    for key, value in values.items():
        argv.extend([f"--{key.replace('_', '-')}", str(value)])
    return serve.parse_args(argv)


def _served(loop):
    return dict(loop.model.named_parameters())


@pytest.mark.parametrize("which", ["empty", "missing"])
def test_serve_without_a_checkpoint_serves_the_init_weights(tmp_path,
                                                            which):
    ckdir = tmp_path / "ck"
    if which == "empty":
        ckdir.mkdir()
    args = serve_args(checkpoint_dir=str(ckdir))
    loop = serve.ServeLoop(args, bootstrap.process_info_from_env({}),
                           heartbeat=None, recorder=None)
    summary = loop.run()
    assert summary["loadedStep"] == 0 and loop.loaded_step == 0
    assert loop.serving_wire()["loadedStep"] == 0
    assert summary["completed"] == summary["arrivals"] >= 1
    assert summary["shed"] == 0 and summary["failedSteps"] == 0
    init = serve.build_model(args, "cpu")
    for name, p in init.named_parameters():
        assert torch.equal(_served(loop)[name], p), name


def test_serve_restores_the_newest_verified_step(tmp_path):
    """A trainer at the server's widths (its sequence = window + decode
    tokens, the server's position table) leaves steps 3 and 4 and a
    corrupt 5; the server quarantines 5 and loads step 4's params, each
    bit-equal to the trainer's in the server's storage dtype (bf16
    weights, f32 LayerNorms: the cast the trainer's forward makes), and
    reports loadedStep 4 on its heartbeat."""
    ckdir = tmp_path / "ck"
    targs = transformer.parse_args([
        "--vocab", "32", "--dim", "16", "--heads", "2", "--kv-heads", "1",
        "--layers", "2", "--seq-len", "20", "--batch", "2",
        "--log-every", "0", "--device", "cpu", "--checkpoint-dir", "",
        "--profile-dir", ""])
    built = transformer.build(targs)
    ck = checkpoint.Checkpointer(str(ckdir), save_every=1)
    _loop(built, 4, ck)
    ck.close()
    trained = {n: p.detach().clone() for n, p in built.state.params.items()}
    _loop(built, 5, checkpoint.Checkpointer(str(ckdir), save_every=1))
    corrupt_a_file(str(ckdir / "5"), keep_size=True)

    beats = []
    reporter = heartbeat.HeartbeatReporter(
        "http://status", "job", interval=0,
        poster=lambda _url, body: beats.append(body))
    args = serve_args(checkpoint_dir=str(ckdir))
    loop = serve.ServeLoop(args, bootstrap.process_info_from_env({}),
                           heartbeat=reporter, recorder=None)
    summary = loop.run()
    assert summary["loadedStep"] == 4 and loop.loaded_step == 4
    assert loop.serving_wire()["loadedStep"] == 4
    assert beats and all(b["serving"]["loadedStep"] == 4 for b in beats)
    assert summary["completed"] == summary["arrivals"] >= 1
    assert summary["shed"] == 0 and summary["failedSteps"] == 0
    served = _served(loop)
    assert served.keys() == trained.keys()
    for name, want in trained.items():
        got = served[name]
        assert torch.equal(got, want.to(got.dtype)), name
    assert served["tok_embed.weight"].dtype == torch.bfloat16
    assert sorted(os.listdir(ckdir)) == ["3", "4", "5.corrupt-0"]
