"""A serve pod's cards (``tpu_operator_torch.payload.serve``) on the CPU: C
CPU "cards" behind one ingress, each holding a weight replica and a block
of the slots, the loop's one thread driving every card in turn.

- Pods of 2 and 3 cards at ``--batch 8`` (blocks 4 + 4 and 3 + 3 + 2), with
  both engines, serve a burst, a finite load and concurrent HTTP requests:
  every request answered, nothing shed or failed, every card admitted
  requests, and each request's tokens are bit-equal to those of a one-card
  server with that card's slot count.
- Against the JAX ``ServeLoop`` on the 8-device CPU mesh of
  ``tests/conftest.py``, its weights carried by ``weights.from_flax``: the
  logits of every decoded position within 2^-4, and the greedy tokens equal
  wherever the reference's top-1 margin exceeds twice that (the rule of
  ``tests/test_torch_kvcache.py``), for both engines.
- Hot reload over two cards (one readiness drop; every card on the new
  weights; a failed restore keeps both on the old), a failing card, SIGTERM,
  the serving wire, the slot and page split, the launch counts.
"""

import json
import os
import shutil
import signal
import socket
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_operator.payload import models as jmodels
from tpu_operator.payload import ring_attention as jring
from tpu_operator.payload import serve as jserve
from tpu_operator.payload import bootstrap as jbootstrap
from tpu_operator_torch.payload import bootstrap
from tpu_operator_torch.payload import checkpoint
from tpu_operator_torch.payload import flash_attention as fa
from tpu_operator_torch.payload import heartbeat
from tpu_operator_torch.payload import serve
from tpu_operator_torch.payload import train
from tpu_operator_torch.payload import transformer
from tpu_operator_torch.payload import weights
from tpu_operator_torch.payload.store import WarmStartStore, blob

WINDOW, NEW, VOCAB, HEADS = 16, 4, 32, 2
WIDTHS = ["--vocab", str(VOCAB), "--dim", "16", "--heads", str(HEADS),
          "--kv-heads", "1", "--layers", "2"]
LOGIT_TOL = 2.0 ** -4  # bf16, see tests/test_torch_models.py
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: tiny CPU steps stay fast under parallel test
    workers, and the cards' matmuls round alike (bit-equality checks)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def serve_args(*extra, **kw):
    flags = {"load": "0:0.05", "batch": 8, "decode_tokens": NEW,
             "window": WINDOW, "device": "cpu", "checkpoint_dir": "",
             **kw}
    argv = list(WIDTHS) + list(extra)
    for key, value in flags.items():
        argv.extend([f"--{key.replace('_', '-')}", str(value)])
    return serve.parse_args(argv)


def info():
    return bootstrap.process_info_from_env({})


def pod(args, cards, **kw):
    kw.setdefault("heartbeat", None)
    kw.setdefault("recorder", None)
    kw.setdefault("store", None)
    return serve.ServeLoop(args, info(), devices=[CPU] * cards, **kw)


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def recorded(loop):
    """Every request ``loop`` queues (HTTP, synthetic or direct), in order."""
    reqs = []
    real = loop.submit

    def submit(*a, **kw):
        req = real(*a, **kw)
        if req is not None:
            reqs.append(req)
        return req

    loop.submit = submit
    return reqs


def post(port, prompt, result, timeout=120.0):
    """POST /v1/decode once the listener is up (it binds after warm-up)."""
    body = json.dumps({"prompt": [int(t) for t in prompt],
                       "maxTokens": NEW}).encode()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/decode", data=body,
                method="POST", headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                result["status"] = resp.status
                result["tokens"] = json.loads(resp.read())["tokens"]
            return
        except (ConnectionError, urllib.error.URLError):
            time.sleep(0.01)


def greedy(engine, model, slots, prompt, n):
    """``prompt``'s greedy tokens decoded alone in slot 0 of ``engine``
    (idle), as a one-card server of ``slots`` slots decodes it."""
    admitted, token = engine.admit(0, prompt, n, model)
    assert admitted
    out = [] if token is None else [int(token)]
    active = np.zeros(slots, bool)
    active[0] = True
    while len(out) < n:
        out.append(int(engine.step(model, active)[0]))
    engine.release(0)
    return out


def prompt_of(seed, length=WINDOW):
    return (np.arange(length) * 3 + seed + 1).astype(np.int32) % VOCAB


# --- placement ----------------------------------------------------------------


def test_slots_and_pages_split_over_the_cards(caplog):
    """Slot s on card floor(s·C / B): the first B mod C cards take one
    slot more, a card with no slot holds no engine (and the start says
    so), and the cards' pools add up to --kv-pages."""
    assert serve.slot_blocks(8, 2) == [(0, 4), (4, 8)]
    assert serve.slot_blocks(8, 3) == [(0, 3), (3, 6), (6, 8)]
    assert serve.slot_blocks(2, 3) == [(0, 1), (1, 2), (2, 2)]
    for b in range(1, 12):
        for c in range(1, 5):
            blocks = serve.slot_blocks(b, c)
            owner = [c_ for c_, (lo, hi) in enumerate(blocks)
                     for _ in range(lo, hi)]
            assert owner == [s * c // b for s in range(b)]
    assert [serve.card_pages(10, 8, lo, hi) for lo, hi in
            serve.slot_blocks(8, 3)] == [3, 4, 3]
    with caplog.at_level("INFO"):
        loop = pod(serve_args(batch=2), 3)
    assert [(c.index, c.args.batch) for c in loop.cards] == [(0, 1), (1, 1)]
    assert "card 2 (cpu) holds no slot" in caplog.text
    loop = pod(serve_args("--kv-pages", "10", batch=8), 3)
    assert [c.engine.cache.num_pages for c in loop.cards] == [3, 4, 3]
    with pytest.raises(ValueError, match="no page"):
        pod(serve_args("--kv-pages", "1", batch=8), 3)


def test_the_pods_devices():
    """TPUJOB_POD_CARDS C > 1 drives C cards; --device cpu gives C CPU
    cards; one card otherwise; no CUDA card here and none asked: raise."""
    assert serve.pod_devices("cpu", 0) == [CPU]
    assert serve.pod_devices("cpu", 1) == [CPU]
    assert serve.pod_devices("cpu", 3) == [CPU] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.pod_devices("", 2)
    env = {"TPUJOB_POD_CARDS": "2"}
    assert bootstrap.process_info_from_env(env).pod_cards == 2


def test_replicas_are_copies_of_card_0():
    loop = pod(serve_args(batch=4), 2)
    a, b = (dict(c.model.named_parameters()) for c in loop.cards)
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name
        assert a[name].data_ptr() != b[name].data_ptr(), name


# --- the pod under load -------------------------------------------------------


@pytest.mark.parametrize("engine,cards", [("paged", 2), ("paged", 3),
                                          ("reforward", 2),
                                          ("reforward", 3)])
def test_a_pod_serves_through_one_ingress(engine, cards):
    """A burst of twice the slots (so that every card admits), a finite
    load and four concurrent HTTP requests through one ingress: every
    request answered, completed = arrivals + burst + HTTP, nothing shed or
    failed; then each request's tokens equal a one-card server's with the
    slot count of the card that served it."""
    port = free_port()
    args = serve_args(load="40:0.5", decode_engine=engine, http_port=port)
    loop = pod(args, cards)
    reqs = recorded(loop)
    burst = [loop.submit(prompt_of(100 + i, 5 + i % (WINDOW - 4)), NEW)
             for i in range(2 * args.batch)]
    http = [{} for _ in range(4)]
    posters = [threading.Thread(target=post, daemon=True,
                                args=(port, prompt_of(200 + i, 3 + 3 * i),
                                      http[i]))
               for i in range(len(http))]
    for t in posters:
        t.start()
    summary = loop.run()
    for t in posters:
        t.join(timeout=60)
    assert all(r.get("status") == 200 for r in http), http
    assert summary["arrivals"] >= 1
    assert summary["completed"] == (summary["arrivals"] + len(burst)
                                    + len(http)) == len(reqs)
    assert summary["shed"] == 0 and summary["failedSteps"] == 0
    assert summary["tokensGenerated"] == NEW * summary["completed"]
    blocks = serve.slot_blocks(args.batch, cards)
    per_card = summary["cards"]
    assert [c["slots"] for c in per_card] == [hi - lo for lo, hi in blocks]
    assert all(c["completed"] > 0 for c in per_card), per_card
    assert sum(c["completed"] for c in per_card) == summary["completed"]
    assert summary["kvCacheUtilization"] == 0.0
    one_card = {}
    for req in reqs:
        assert req.done.is_set() and not req.shed
        slots = blocks[req.card][1] - blocks[req.card][0]
        if slots not in one_card:
            one_card[slots] = serve.ServeLoop(
                serve_args(batch=slots, decode_engine=engine), info(),
                heartbeat=None, recorder=None, store=None)
        ref = one_card[slots]
        assert req.tokens == greedy(ref.engine, ref.model, slots,
                                    req.prompt, req.max_tokens), req.card
    assert sorted(r["tokens"] for r in http) == sorted(
        req.tokens for req in reqs if isinstance(req.prompt, list))


# --- against the JAX ServeLoop ------------------------------------------------


def _jax_loop(args):
    jargs = jserve.parse_args(
        [a for a in WIDTHS] + [
            "--batch", str(args.batch), "--window", str(WINDOW),
            "--decode-tokens", str(NEW), "--decode-engine",
            args.decode_engine, "--page-size", str(args.page_size),
            "--load", "0:0"])
    return jserve.ServeLoop(jargs, jbootstrap.process_info_from_env({}),
                            heartbeat=None, store=None, recorder=None)


def _jax_tokens(jloop, prompts):
    """The reference loop's tokens for ``prompts``, driven on this thread
    (admission and steps, as its run loop does)."""
    reqs = [jloop.submit(p, NEW) for p in prompts]
    while not all(r.done.is_set() for r in reqs):
        jloop._admit_from_queue()
        if any(r is not None for r in jloop._requests):
            jloop._decode_step()
    return [r.tokens for r in reqs]


def _contexts(engine, prompt, tokens):
    """(context row, positions, logit rows) the engine decoded ``tokens``
    from: the paged engine one growing context (its logits at every
    decoded position; padded at the end to one length for every prompt,
    which the causal mask hides from the rows read, so the reference
    traces one shape), the re-forward engine the last ``WINDOW`` tokens at
    positions 0.. per step."""
    ctx = np.concatenate([prompt, tokens[:-1]]).astype(np.int32)
    if engine == "paged":
        row = np.zeros(WINDOW + NEW - 1, np.int32)
        row[:len(ctx)] = ctx
        yield row, np.arange(len(row)), slice(len(prompt) - 1, len(ctx))
        return
    for i in range(len(tokens)):
        row = ctx[:len(prompt) + i][-WINDOW:]
        yield row, np.arange(len(row)), slice(len(row) - 1, None)


@pytest.mark.parametrize("engine", ["paged", "reforward"])
def test_a_pod_agrees_with_the_jax_serve_loop(engine):
    """The pod's cards hold the JAX loop's weights (``from_flax``); the
    same prompts through both: logits within 2^-4 at every decoded
    position, tokens equal up to the first step whose reference margin is
    not clear."""
    args = serve_args(decode_engine=engine, page_size=4)
    jloop = _jax_loop(args)
    params = jax.tree_util.tree_map(np.asarray, jloop._state.params)
    model = weights.from_flax(params, heads=HEADS)
    loop = pod(args, 2)
    for card in loop.cards:
        serve.copy_weights(card.model, model)
    # Full-window prompts for the re-forward engine (it left-pads with
    # token 0); the paged engine also takes short ones.
    lengths = [WINDOW] * 6 if engine == "reforward" else [9, WINDOW, 5,
                                                           WINDOW, 12, 3]
    prompts = [prompt_of(7 * i, n) for i, n in enumerate(lengths)]
    reqs = [loop.submit(p, NEW) for p in prompts]
    summary = loop.run()
    assert summary["completed"] == len(prompts) and summary["shed"] == 0
    assert {r.card for r in reqs} == {0, 1}
    ref = _jax_tokens(jloop, prompts)
    spec = dict(vocab=VOCAB, dim=16, heads=HEADS, layers=2,
                max_seq=WINDOW + NEW, kv_heads=1)
    for prompt, req, want_toks in zip(prompts, reqs, ref):
        want, got = [], []
        for row, pos, rows in _contexts(engine, prompt, want_toks):
            want.append(np.asarray(jmodels.lm_decode_apply(
                params, jnp.asarray(row[None]), jnp.asarray(pos[None]),
                lambda _i: lambda q, k, v: jring.reference_attention(
                    q, k, v), **spec).astype(jnp.float32))[0, rows])
            with torch.inference_mode():
                got.append(model(
                    torch.from_numpy(row[None]).long(),
                    torch.from_numpy(pos[None]).long(),
                    lambda _i: lambda q, k, v: fa.flash_attention(q, k, v)
                ).float().numpy()[0, rows])
        want, got = np.concatenate(want), np.concatenate(got)
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * LOGIT_TOL
        for i in range(NEW):
            if not clear[i]:
                break
            assert req.tokens[i] == want_toks[i], (prompt, i)


def test_the_serving_wire_keeps_the_reference_keys():
    """The pod's beat body has the JAX package's serving keys, and
    kvCacheUtilization is held pages over the whole pod's pages."""
    loop = pod(serve_args("--kv-pages", "6", batch=4), 2)
    ref_window = jserve.LatencyWindow()
    for window in (loop.window, ref_window):
        window.arrived(2)
        window.generated(3)
        window.record(0.25)
    stub = types.SimpleNamespace(
        window=ref_window, ready=True, queue_depth=lambda: 0,
        engine=types.SimpleNamespace(utilization=lambda: 0.0),
        loaded_step=0, reloads=0)
    want = jserve.ServeLoop.serving_wire(stub)
    assert [c.engine.cache.num_pages for c in loop.cards] == [3, 3]
    for i in range(2):
        loop.submit(prompt_of(i), NEW)
    loop._admit(loop.cards[0])
    loop._admit(loop.cards[1])
    got = loop.serving_wire()
    assert set(got) == set(want)
    held = [c.engine.cache.allocator.held_pages for c in loop.cards]
    assert held == [2, 2]
    assert got["kvCacheUtilization"] == round(4 / 6, 4)


# --- hot reload over two cards ------------------------------------------------


def _train_steps(tmp_path):
    """A trainer at the server's widths saves step 2 into ``early`` and
    step 4 into ``late``."""
    targs = transformer.parse_args(WIDTHS + [
        "--seq-len", str(WINDOW + NEW), "--batch", "2", "--log-every", "0",
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


def _reload_args(ckdir, load):
    return serve_args("--reload-poll", "0.1", "--reload-stagger", "0",
                      batch=4, load=load, checkpoint_dir=str(ckdir))


def _one_card_at(ckdir):
    fresh = serve.ServeLoop(_reload_args(ckdir, "0:0"), info(),
                            heartbeat=None, recorder=None, store=None)
    step = fresh._restore_weights()
    return fresh, step


def _same_weights(a, b):
    want = dict(b.named_parameters())
    return all(torch.equal(p, want[n]) for n, p in a.named_parameters())


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return _train_steps(tmp_path_factory.mktemp("trained"))


def test_a_reload_rolls_over_every_card(tmp_path, trained):
    """A step uploaded mid-run (a burst first, so that both cards serve):
    one readiness drop for the pod, then every card holds the new weights
    and decodes their greedy continuation."""
    local = tmp_path / "replica"
    local.mkdir()
    shutil.copytree(trained["early"], local / "2")
    store = WarmStartStore(blob.from_uri(str(tmp_path / "bucket")),
                           prefix="ns/svc")
    beats = []
    rep = heartbeat.HeartbeatReporter(
        "http://s", "svc", interval=3600.0,
        poster=lambda _u, body: beats.append(body) or {})
    loop = pod(_reload_args(local, "25:2.5"), 2, heartbeat=rep, store=store)
    burst = [loop.submit(prompt_of(i), NEW) for i in range(8)]

    def upload_mid_run():
        while loop.steps < 10:
            time.sleep(0.01)
        store.upload_checkpoint(str(trained["late"]), 4)

    uploader = threading.Thread(target=upload_mid_run, daemon=True)
    uploader.start()
    summary = loop.run()
    uploader.join(timeout=10)
    assert summary["reloads"] == 1 and loop.loaded_step == 4
    assert summary["shed"] == 0 and summary["failedSteps"] == 0
    assert summary["completed"] == summary["arrivals"] + len(burst)
    assert summary["arrivals"] >= 10
    assert all(c["completed"] > 0 for c in summary["cards"])
    drops = [b for b in beats if b["serving"]["ready"] is False]
    assert len(drops) == 2  # the reload's, and the shutdown's
    ready = [b["serving"]["ready"] for b in beats]
    assert ready[ready.index(False) + 1] is True
    fresh, step = _one_card_at(local)
    assert step == 4
    prompt = prompt_of(3, 12)
    want = greedy(fresh.engine, fresh.model, 4, prompt, NEW)
    for card in loop.cards:
        assert _same_weights(card.model, fresh.model), card.index
        assert greedy(card.engine, card.model, 2, prompt, NEW) == want


def test_a_failed_reload_keeps_every_card_on_the_old_weights(tmp_path,
                                                             trained):
    local = tmp_path / "replica"
    local.mkdir()
    shutil.copytree(trained["early"], local / "2")
    store = WarmStartStore(blob.from_uri(str(tmp_path / "bucket")),
                           prefix="ns/svc")
    store.upload_checkpoint(str(trained["late"]), 4)
    loop = pod(_reload_args(local, "20:1"), 2, store=store)
    real = loop._restore_weights

    def restore():
        if loop.loaded_step:
            raise OSError("checkpoint volume went away")
        return real()

    loop._restore_weights = restore
    summary = loop.run()
    assert summary["reloads"] == 0 and summary["loadedStep"] == 2
    assert summary["shed"] == 0 and summary["failedSteps"] == 0
    assert summary["completed"] == summary["arrivals"] >= 1
    shutil.rmtree(local / "4", ignore_errors=True)
    old, step = _one_card_at(local)
    assert step == 2
    for card in loop.cards:
        assert _same_weights(card.model, old.model), card.index


# --- failure and shutdown -----------------------------------------------------


@pytest.mark.parametrize("where", ["step", "admit"])
def test_a_failing_card_stops_the_pod(where):
    """Card 1's steps raise (the pod gives up after
    MAX_CONSECUTIVE_FAILURES of them), or its admission raises: the pod
    raises within seconds, exits 1 under the payload contract, and every
    request still queued or in flight is shed, card 0's too (card 0
    admits first, and its requests outlast card 1's eight failed steps)."""
    loop = pod(serve_args(load="200:30", batch=4), 2)
    reqs = recorded(loop)

    def fault(*_a, **_kw):
        raise RuntimeError("card fault")

    setattr(loop.cards[1].engine, where, fault)
    for i in range(8):  # both cards' slots, twice over
        loop.submit(prompt_of(i), NEW)
    errors = []

    def payload(_info):
        try:
            loop.run()
        except RuntimeError as e:
            errors.append(e)
            raise

    t0 = time.monotonic()
    previous = signal.getsignal(signal.SIGTERM)
    try:
        code = bootstrap.run_payload(payload)
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert code == 1
    assert time.monotonic() - t0 < 20
    assert ("failures on card 1; giving up" if where == "step"
            else "card fault") in str(errors[0])
    assert reqs and all(r.done.is_set() for r in reqs)
    assert any(r.shed and r.card == 0 for r in reqs)
    if where == "step":
        assert loop.cards[1].failed_steps == serve.MAX_CONSECUTIVE_FAILURES


def test_sigterm_exits_143_with_every_card_stopped():
    loop = pod(serve_args(load="50:60", batch=4), 2)
    reqs = recorded(loop)
    previous = signal.getsignal(signal.SIGTERM)
    timer = threading.Timer(1.5, os.kill, (os.getpid(), signal.SIGTERM))
    try:
        timer.start()
        code = bootstrap.run_payload(lambda _info: loop.run())
    finally:
        timer.cancel()
        signal.signal(signal.SIGTERM, previous)
    assert code == bootstrap.EXIT_RETRYABLE == 143
    assert reqs and all(r.done.is_set() for r in reqs)


# --- the launch counts --------------------------------------------------------


def test_launch_counts_are_exact_across_threads():
    """More counting threads than cores, switching every microsecond,
    lose no launch, by kernel and by scope; the plain (CPU) paths count
    nothing."""
    fa.reset_launch_counts()
    workers, n = min(64, (os.cpu_count() or 2) + 1), 2000
    barrier = threading.Barrier(workers)

    def launch(scope):
        barrier.wait(timeout=30)
        with fa.launch_scope(scope % 2):
            for _ in range(n):
                fa._count("flash_decode")

    threads = [threading.Thread(target=launch, args=(s,))
               for s in range(workers)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert fa.launch_counts()["flash_decode"] == workers * n
    assert fa.launch_counts(scope=0)["flash_decode"] == (workers + 1) // 2 * n
    assert fa.launch_counts(scope=1)["flash_decode"] == workers // 2 * n
    assert fa.launch_counts(scope=2) == dict.fromkeys(fa.LAUNCHES, 0)
    fa.reset_launch_counts()
    loop = pod(serve_args(batch=4), 2)
    loop.submit(prompt_of(0), NEW)
    loop.submit(prompt_of(1), NEW)
    loop._admit_from_queue()
    loop._decode_step()
    assert fa.launch_counts() == dict.fromkeys(fa.LAUNCHES, 0)
