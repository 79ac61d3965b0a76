"""The port's MoE LM payload (``tpu_operator_torch.payload.moe``) against
the JAX package's (``tpu_operator/payload/moe.py``) on the CPU.

Inputs come from numpy with a seed; the reference runs as
``tests/test_moe.py`` runs it: plain attention, a one-device mesh from
``make_moe_mesh(1)``, and for EP x TP the conftest's 8 devices as
(data 2, expert 2, model 2) from ``make_moe_mesh(8, expert_parallel=2,
tensor_parallel=2)``; the port holds every expert and shard in one
process (the gloo tests split them over processes). Weights cross over
with ``weights.moe_from_flax``. Routes are compared exactly in f32; every
other comparison states its tolerance.
"""

import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_operator.payload import data as jdata
from tpu_operator.payload import moe as jmoe
from tpu_operator.payload import train as jtrain
from tpu_operator_torch.payload import bootstrap
from tpu_operator_torch.payload import checkpoint
from tpu_operator_torch.payload import moe
from tpu_operator_torch.payload import weights


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the whole module: beside the suite's other
    workers, a torch op that spreads over every core waits on threads the
    other workers hold (a 20-step run of these widths took 230 s in a
    full parallel run and 5 s alone)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

REPO = Path(__file__).resolve().parent.parent

# The reference's test_moe sizes, one process.
TINY = dict(batch=4, seq_len=32, dim=32, heads=2, layers=2, experts=4,
            capacity_factor=2.0, dtype="f32", lr=1e-2, seed=0,
            log_every=0)


def _argv(**over):
    base = dict(TINY)
    base.update(over)
    argv = []
    for k, v in base.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return argv


def _port_args(**over):
    return moe.parse_args(_argv(**over) + ["--device", "cpu"])


@pytest.fixture(autouse=True)
def _clean_drain_latch():
    bootstrap.reset_drain()
    yield
    bootstrap.reset_drain()


@pytest.fixture(scope="module")
def mesh1():
    return jmoe.make_moe_mesh(1)


def _np(x):
    return np.asarray(x, dtype=np.float32)


# --- routing -------------------------------------------------------------------


def _logits(case):
    rng = np.random.default_rng(7)
    if case == "random":
        return rng.normal(size=(3, 16, 4)).astype(np.float32), 12
    if case == "starved":
        return rng.normal(size=(3, 16, 4)).astype(np.float32), 4
    if case == "ties":
        # Rows 0-3 tie on all four experts, rows 4-7 tie on experts 1 and
        # 3 for the first choice, and on 0 and 2 for the second.
        x = rng.normal(size=(2, 16, 4)).astype(np.float32)
        x[:, :4] = 0.5
        x[:, 4:8] = np.array([1.0, 2.0, 1.0, 2.0], np.float32)
        return x, 6
    # A hot expert: every token prefers expert 2.
    x = rng.normal(size=(2, 16, 4)).astype(np.float32)
    x[..., 2] += 4.0
    return x, 5


ROUTE_EXACT = ("idx1", "idx2", "slot1", "slot2", "keep1", "keep2", "kept1",
               "kept2", "pos1", "pos2")


@pytest.mark.parametrize("case", ["random", "starved", "ties", "hot"])
def test_top2_routing_matches_jax(case):
    """Same f32 logits: indices, slots, keeps, positions and drop_frac
    exactly equal; gates, aux and z_loss within 1e-6 (the same f32
    expressions in another summation order)."""
    logits, capacity = _logits(case)
    want = jmoe.top2_routing(jnp.asarray(logits), capacity)
    got = moe.top2_routing(torch.from_numpy(logits), capacity)
    for key in ROUTE_EXACT:
        np.testing.assert_array_equal(
            np.asarray(got[key]).astype(np.int64),
            np.asarray(want[key]).astype(np.int64), err_msg=key)
    assert float(got["drop_frac"]) == float(want["drop_frac"])
    for key in ("gate1", "gate2", "aux", "z_loss"):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   _np(want[key]), rtol=1e-6, atol=1e-6,
                                   err_msg=key)
    if case == "starved":
        assert float(got["drop_frac"]) > 0.2
    if case == "ties":
        # argmax takes the first of tied maxima in both frameworks.
        assert (got["idx1"][:, :4] == 0).all() and (got["idx2"][:, :4]
                                                    == 1).all()
        assert (got["idx1"][:, 4:8] == 1).all() and (got["idx2"][:, 4:8]
                                                     == 3).all()


def test_capacity_drops_tokens_not_correctness():
    """The reference's all-ties case: 16 tokens tie on two experts, so
    every first choice is expert 0 and every second expert 1; 4 slots
    each keep 8 of 32 assignments (drop 0.75), and the tensors stay
    finite."""
    dispatch, combine, _aux, drop = moe.top2_dispatch(torch.zeros(1, 16, 2),
                                                      capacity=4)
    assert float(dispatch[0, :, 0].sum()) == 4.0
    assert torch.isfinite(combine).all()
    assert float(drop) == 0.75


@pytest.mark.parametrize("case", ["random", "starved"])
def test_onehot_tensors_and_their_gradient_match_jax(case):
    """dispatch exactly equal, combine within 1e-6 (its gates are the
    routing's, 1e-6 apart); the gradient of a weighted sum of the combine
    tensor into the logits (the port's gathered gate gradient against the
    reference's product) within 1e-6."""
    logits, capacity = _logits(case)
    w = np.random.default_rng(3).normal(
        size=logits.shape + (capacity,)).astype(np.float32)

    def jloss(lg):
        _d, comb, aux, _drop = jmoe.top2_dispatch(lg, capacity)
        return jnp.sum(comb * w) + aux

    jd, jc, _a, _dr = jmoe.top2_dispatch(jnp.asarray(logits), capacity)
    jgrad = jax.grad(jloss)(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    d, c, aux, _drop = moe.top2_dispatch(lg, capacity)
    np.testing.assert_array_equal(d.numpy(), _np(jd))
    np.testing.assert_allclose(c.detach().numpy(), _np(jc), rtol=1e-6,
                               atol=1e-6)
    ((c * torch.from_numpy(w)).sum() + aux).backward()
    np.testing.assert_allclose(lg.grad.numpy(), _np(jgrad), rtol=1e-6,
                               atol=1e-6)


# --- the MoE MLP ---------------------------------------------------------------


def _layer_pair(mesh, dispatch, cf, dim=32, experts=4):
    """(jax layer, its params, port layer holding them)."""
    cls = jmoe._moe_mlp_class(mesh, jnp.float32)
    layer = cls(dim=dim, experts=experts, capacity_factor=cf,
                dispatch_mode=dispatch)
    x = np.random.default_rng(3).normal(size=(4, 32, dim)).astype(np.float32)
    params = layer.init(jax.random.key(4), jnp.asarray(x))["params"]
    port = moe.MoEMLP(dim, experts, cf, dispatch=dispatch,
                      compute_dtype=torch.float32)
    with torch.no_grad():
        port.router.weight.copy_(torch.from_numpy(
            _np(params["router"]["kernel"]).T.copy()))
        port.w1.copy_(torch.from_numpy(_np(params["w1"])))
        port.w2.copy_(torch.from_numpy(_np(params["w2"])))
    return layer, params, port, x


@pytest.mark.parametrize("cf", [4.0, 0.5])
@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_moe_mlp_matches_jax(mesh1, dispatch, cf):
    """f32, same weights and input: the output within 1e-5 of the
    reference's (the same products summed in another order), at an ample
    and a starved capacity factor; each parameter's gradient of the
    summed squared output within 1e-4 of its largest entry."""
    layer, params, port, x = _layer_pair(mesh1, dispatch, cf)
    want = layer.apply({"params": params}, jnp.asarray(x))
    xt = torch.from_numpy(x)
    got = port(xt)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=1e-5,
                               atol=1e-5)
    jg = jax.grad(lambda p: jnp.sum(
        layer.apply({"params": p}, jnp.asarray(x)) ** 2))(params)
    (got ** 2).sum().backward()
    pairs = ((port.router.weight.grad.T, jg["router"]["kernel"]),
             (port.w1.grad, jg["w1"]), (port.w2.grad, jg["w2"]))
    for mine, theirs in pairs:
        theirs = _np(theirs)
        np.testing.assert_allclose(mine.numpy(), theirs, rtol=0,
                                   atol=1e-4 * np.abs(theirs).max())


@pytest.mark.parametrize("cf", [4.0, 0.5])
def test_gather_dispatch_matches_einsum(mesh1, cf):
    """The two modes read one routing: outputs within 1e-5 of each other,
    gradients within 1e-5 of the largest entry."""
    _l, _p, ein, x = _layer_pair(mesh1, "einsum", cf)
    gat = moe.MoEMLP(32, 4, cf, dispatch="gather",
                     compute_dtype=torch.float32)
    gat.load_state_dict(ein.state_dict())
    xt = torch.from_numpy(x)
    a, b = ein(xt), gat(xt)
    np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    (a ** 2).sum().backward()
    (b ** 2).sum().backward()
    for (n, p), q in zip(ein.named_parameters(), gat.parameters()):
        ref = p.grad.numpy()
        np.testing.assert_allclose(q.grad.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=n)


def test_identical_experts_degenerate_to_dense_ffn():
    """Every expert the same and ample capacity: the layer computes
    gelu(x w1) w2 (the gates sum to 1), within 1e-4 (the reference's
    test and bound)."""
    torch.manual_seed(0)
    layer = moe.MoEMLP(32, 4, 4.0, compute_dtype=torch.float32)
    with torch.no_grad():
        w1 = torch.randn(32, 128) / math.sqrt(32)
        w2 = torch.randn(128, 32) / math.sqrt(128)
        layer.router.weight.normal_()
        layer.w1.copy_(w1.expand(4, -1, -1))
        layer.w2.copy_(w2.expand(4, -1, -1))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 16, 32)).astype(np.float32))
    want = torch.nn.functional.gelu(x @ w1, approximate="tanh") @ w2
    np.testing.assert_allclose(layer(x).detach().numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_capacity_is_the_reference_formula():
    for n, e, cf in ((2048, 8, 1.25), (32, 4, 2.0), (16, 4, 0.25),
                     (7, 3, 1.0)):
        assert moe.capacity_of(n, e, cf) == max(4, int(math.ceil(
            2 * n * cf / e)))
    assert moe.capacity_of(2048, 8, 1.25) == 640


# --- the LM ----------------------------------------------------------------------


def _jax_build(mesh, **over):
    args = jmoe.parse_args(_argv(**over))
    return args, jmoe.build(args, mesh=mesh)


def _jax_loss_and_grads(model, params, tokens, args):
    """The reference's loss (``make_moe_train_step``'s ``loss_fn``) and
    its gradient."""
    def loss_fn(p):
        logits, inter = model.apply({"params": p}, tokens,
                                    mutable=["intermediates"])
        flat = jax.tree_util.tree_flatten_with_path(
            inter["intermediates"])[0]

        def mean(name):
            leaves = [leaf for path, leaf in flat
                      if any(getattr(k, "key", None) == name for k in path)]
            return sum(leaves) / len(leaves)

        lm = jtrain.next_token_nll(logits, tokens)
        total = lm + args.aux_coef * mean("aux_loss") \
            + args.router_z_coef * mean("router_z")
        return total, {"loss": lm, "aux_loss": mean("aux_loss"),
                       "router_z": mean("router_z"),
                       "drop_frac": mean("drop_frac")}

    return jax.value_and_grad(loss_fn, has_aux=True)(params)


def _flat_grads(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_grads(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = _np(v)
    return out


@pytest.mark.parametrize("layers,kv_heads,dispatch",
                         [(2, 0, "einsum"), (4, 1, "gather")])
def test_lm_loss_and_every_gradient_match_jax(mesh1, layers, kv_heads,
                                              dispatch):
    """f32 at small widths (dim 32, 4 experts, 2 or 4 layers, MHA and
    GQA): the total loss and its parts within 1e-5, and every parameter's
    gradient within 1e-4 of its own largest entry (the same f32 math in
    another summation order; a missing term or a wrong route is off by
    O(1))."""
    over = dict(layers=layers, kv_heads=kv_heads, dispatch=dispatch,
                capacity_factor=1.0)
    args, (_m, model, state, _s, batches) = _jax_build(mesh1, **over)
    (tokens,) = next(batches)
    (jtotal, jm), jgrads = _jax_loss_and_grads(
        model, state.params, jnp.asarray(tokens), args)
    pargs = _port_args(**over)
    port = weights.moe_from_flax(jax.device_get(state.params), pargs,
                                 device="cpu").requires_grad_(True)
    loss_fn = moe.make_moe_loss(port, pargs)
    total, metrics = loss_fn(torch.from_numpy(tokens))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-5)
    for key in ("loss", "aux_loss", "router_z", "drop_frac"):
        np.testing.assert_allclose(float(metrics[key]), float(jm[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    assert 0.0 < float(metrics["drop_frac"]) < 1.0
    grads = _flat_grads(weights.to_flax(_grad_model(port)))
    want = _flat_grads(jax.device_get(jgrads))
    assert set(grads) == set(want)
    for name, ref in want.items():
        np.testing.assert_allclose(grads[name], ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), 1e-12),
                                   err_msg=name)


def _grad_model(model):
    """A copy of ``model`` whose params hold its gradients, for
    ``weights.to_flax``."""
    import copy

    twin = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(twin.parameters(), model.parameters()):
            p.copy_(q.grad)
    return twin


def _pair(mesh, **over):
    """The reference's (mesh, state, step, batches) and the port's step
    over the same f32 params (adam)."""
    args, (m, _model, state, step, batches) = _jax_build(mesh, **over)
    pargs = _port_args(**over)
    port = weights.moe_from_flax(jax.device_get(state.params), pargs,
                                 device="cpu").requires_grad_(True)
    optimizer = moe.optimizers.from_args(pargs)
    opt_state = optimizer.init(list(port.parameters()))
    pstep = moe.make_moe_train_step(port, optimizer, opt_state, pargs)
    return m, state, step, batches, pstep


@pytest.mark.parametrize("accum", [1, 2])
def test_train_trajectory_matches_jax(mesh1, accum):
    """Five steps of the reference's step and the port's from the same
    params on the same batches, f32 (adam, lr 1e-2, with and without
    gradient accumulation): every loss within 5e-3, the bound of the
    transformer test (tests/test_torch_train.py); aux, z and the total
    alike, and drop_frac equal (the routes agree; the readings differed
    by 1e-5 at most)."""
    m, state, step, batches, pstep = _pair(
        mesh1, grad_accum=accum, capacity_factor=1.25, seq_len=64)
    for i in range(5):
        (tokens,) = next(batches)
        (dev,) = jdata.put_global_batch(m, tokens)
        state, jm = step(state, dev)
        pm = pstep(torch.from_numpy(tokens))
        for key in ("loss", "aux_loss", "router_z", "total_loss"):
            assert abs(float(pm[key]) - float(jm[key])) <= 5e-3, (i, key)
        assert float(pm["drop_frac"]) == float(jm["drop_frac"]), i


def test_bf16_step_matches_jax(mesh1):
    """The first step in bf16 (the payload's default dtype), before any
    update: the loss, aux, z and total within 5e-3. Both sides round the
    residual stream and the products to bf16 at other points (0.6e-3 on
    the loss and 2.3e-3 on z were read), so routes near a tie may differ;
    later steps drift further apart (7e-3 by step 4), the chaos of
    routing under adam at this size, which the f32 trajectory above
    excludes."""
    m, state, step, batches, pstep = _pair(
        mesh1, dtype="bf16", capacity_factor=1.25, seq_len=64)
    (tokens,) = next(batches)
    (dev,) = jdata.put_global_batch(m, tokens)
    _state, jm = step(state, dev)
    pm = pstep(torch.from_numpy(tokens))
    for key in ("loss", "aux_loss", "router_z", "total_loss"):
        assert abs(float(pm[key]) - float(jm[key])) <= 5e-3, key


def test_drop_frac_reported_in_training_metrics():
    """~0 at an ample capacity factor, decidedly nonzero when starved,
    always within [0, 1] (the reference's test)."""
    out = {}
    for cf in (4.0, 0.25):
        built = moe.build(_port_args(batch=8, capacity_factor=cf))
        (tokens,) = next(built.batches)
        m = built.step(torch.from_numpy(tokens))
        assert set(m) == {"loss", "aux_loss", "router_z", "drop_frac",
                          "total_loss"}
        out[cf] = float(m["drop_frac"])
    assert out[4.0] < 0.05 and 0.2 < out[0.25] <= 1.0, out


def test_aux_loss_trains_drop_frac_down():
    """The reference's trajectory test at its size: from a near-init
    router at capacity factor 1.0, 60 steps with aux coefficient 5e-2
    must bring the dropped fraction down by more than 0.05."""
    built = moe.build(_port_args(batch=8, seq_len=64, capacity_factor=1.0,
                                 lr=3e-3, aux_coef=5e-2))
    it = iter(built.batches)
    early = float(built.step(torch.from_numpy(next(it)[0]))["drop_frac"])
    drops = [float(built.step(torch.from_numpy(next(it)[0]))["drop_frac"])
             for _ in range(60)]
    late = float(np.mean(drops[-10:]))
    assert late < early - 0.05, (early, late, drops[-5:])


def test_router_z_loss_shrinks_router_logits():
    """A large z coefficient trains smaller router weights than none
    (the reference's test)."""
    def router_norm(z_coef):
        built = moe.build(_port_args(batch=8, router_z_coef=z_coef,
                                     lr=3e-3))
        it = iter(built.batches)
        for _ in range(25):
            m = built.step(torch.from_numpy(next(it)[0]))
        assert math.isfinite(float(m["router_z"]))
        return sum(float((p ** 2).sum())
                   for n, p in built.model.named_parameters()
                   if "router" in n)

    assert router_norm(1.0) < router_norm(0.0)


@pytest.mark.parametrize("policy", ["full", "dots_attn_gelu"])
def test_remat_is_bit_equal_and_sows_once(policy):
    """Under --remat the step's losses, metrics and params are bit-equal
    to no remat, and the sown scalars are counted once a step: the
    replay in the backward runs outside the collector."""
    plain = moe.build(_port_args(batch=4))
    rem = moe.build(moe.parse_args(_argv(batch=4) + [
        "--device", "cpu", "--remat", "--remat-policy", policy]))
    assert type(rem.model.blocks[1]).__name__.startswith("RematDecoder")
    counted = []
    real = moe._sow
    try:
        moe._sow = lambda r: (counted.append(1), real(r))
        for _ in range(2):
            (tokens,) = next(plain.batches)
            next(rem.batches)
            a = plain.step(torch.from_numpy(tokens))
            n0 = len(counted)
            b = rem.step(torch.from_numpy(tokens))
            # One MoE layer; the remat side's forward adds one sow and
            # its replay adds a call that records nothing.
            assert len(counted) - n0 == 2
            assert {k: float(v) for k, v in a.items()} == \
                {k: float(v) for k, v in b.items()}
    finally:
        moe._sow = real
    for (n, p), q in zip(plain.model.named_parameters(),
                         rem.model.parameters()):
        assert torch.equal(p, q), n


def test_block_hook_holds_moe_in_place_of_the_dense_mlp():
    model = moe.build_model(_port_args(layers=4), "cpu")
    for i, block in enumerate(model.blocks):
        assert (block.moe is not None) == (i % 2 == 1)
        assert hasattr(block, "mlp_up") == (i % 2 == 0)
    remat = moe.build_model(moe.parse_args(
        _argv(layers=2) + ["--device", "cpu", "--remat"]), "cpu")
    assert isinstance(remat.blocks[1].moe, moe.MoEMLP)


def test_weights_round_trip_through_the_reference_tree(mesh1):
    _args, (_m, _model, state, _s, _b) = _jax_build(mesh1, layers=4)
    tree = jax.device_get(state.params)
    port = weights.moe_from_flax(tree, _port_args(layers=4), device="cpu")
    back = _flat_grads(weights.moe_to_flax(port))
    want = _flat_grads(tree)
    assert set(back) == set(want)
    for name, ref in want.items():
        np.testing.assert_array_equal(back[name], ref, err_msg=name)
    shard = moe.ExpertShard(2, 1)
    half = weights.moe_from_flax(tree, _port_args(layers=4), device="cpu",
                                 shard=shard)
    np.testing.assert_array_equal(half.blocks[1].moe.w1.numpy(),
                                  want["block1/moe/w1"][2:])


# --- flags -----------------------------------------------------------------------


def test_indivisible_experts_raise_value_error():
    with pytest.raises(ValueError, match="divisible"):
        moe.build(_port_args(experts=3, expert_parallel=2))
    with pytest.raises(ValueError, match="kv_heads"):
        moe.build(_port_args(heads=4, kv_heads=3))


def test_flags_take_the_reference_defaults():
    ours, theirs = moe.parse_args([]), jmoe.parse_args([])
    for name, value in vars(theirs).items():
        assert getattr(ours, name) == value, name


def test_the_entry_point_trains_on_the_cpu(tmp_path):
    """``python -m tpu_operator_torch.payload.moe --device cpu`` at small
    widths exits 0 and logs the reference's step line."""
    out = subprocess.run(
        [sys.executable, "-m", "tpu_operator_torch.payload.moe", "--device",
         "cpu", "--steps", "3", "--batch", "4", "--seq-len", "32", "--dim",
         "32", "--heads", "2", "--layers", "2", "--experts", "4",
         "--log-every", "1", "--checkpoint-dir", str(tmp_path / "ck"),
         "--checkpoint-every", "2", "--profile-dir", ""],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "step 3 loss" in out.stderr and " aux " in out.stderr \
        and " drop " in out.stderr
    assert (tmp_path / "ck" / "3" / "meta.json").exists()


# --- checkpoint --------------------------------------------------------------------


@pytest.mark.parametrize("optimizer", ["adam", "adam8"])
def test_checkpoint_round_trip(tmp_path, optimizer):
    """A MoE state saved after 2 steps and restored into a fresh build is
    bit-equal; both then take the same third step. meta.json names the
    model and its expert count, and a restore at another --experts is
    refused without quarantining the step."""
    flags = ["--optimizer", optimizer]
    a = moe.build(moe.parse_args(_argv() + ["--device", "cpu"] + flags))
    for _ in range(2):
        a.step(torch.from_numpy(next(a.batches)[0]))
    ck = checkpoint.Checkpointer(str(tmp_path), save_every=1)
    ck.save(2, a.state)
    ck.close()
    meta = (tmp_path / "2" / "meta.json").read_text()
    assert '"model": {"name": "moe", "experts": 4}' in meta
    b = moe.build(moe.parse_args(_argv() + ["--device", "cpu"] + flags))
    ck = checkpoint.Checkpointer(str(tmp_path), save_every=1)
    state, start = ck.restore(b.state)
    assert start == 2
    for n, p in a.model.named_parameters():
        assert torch.equal(p, dict(b.model.named_parameters())[n]), n
    for n, t in a.opt_state.state_dict().items():
        assert torch.equal(t, b.opt_state.state_dict()[n]), n
    tokens = next(a.batches)[0]
    next(b.batches), next(b.batches)
    ma = a.step(torch.from_numpy(tokens))
    mb = b.step(torch.from_numpy(tokens))
    assert float(ma["loss"]) == float(mb["loss"])
    other = moe.build(moe.parse_args(
        _argv(experts=2) + ["--device", "cpu"] + flags))
    with pytest.raises(checkpoint.CheckpointError, match="experts"):
        checkpoint.Checkpointer(str(tmp_path)).restore(other.state)
    assert (tmp_path / "2").exists()



# --- EP x TP ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh_ep_tp():
    return jmoe.make_moe_mesh(8, expert_parallel=2, tensor_parallel=2)


EP_TP = dict(expert_parallel=2, tensor_parallel=2)


def test_ep_tp_loss_and_aux_match_the_unsharded_side():
    """The counterpart of test_ep_tp_loss_matches_unsharded: one step of
    EP 2 x TP 2 and of EP 1 x TP 1 (--split-qkv on, the same param tree
    and seeded init) on the same batch, f32: the loss, aux, z and
    drop_frac within 1e-5 (the reference's bound is 1e-4), and the
    params before the step equal."""
    sides = [moe.build(_port_args(split_qkv="on", **over))
             for over in ({}, EP_TP)]
    for (n, p), (m, q) in zip(sides[0].model.named_parameters(),
                              sides[1].model.named_parameters()):
        assert n == m and torch.equal(p, q), n
    (tokens,) = next(sides[0].batches)
    one, split = (b.step(torch.from_numpy(tokens)) for b in sides)
    for key in ("loss", "aux_loss", "router_z", "drop_frac", "total_loss"):
        assert abs(float(one[key]) - float(split[key])) <= 1e-5, key


@pytest.mark.parametrize("kv_heads,dispatch", [(0, "einsum"), (0, "gather"),
                                               (2, "einsum")],
                         ids=["mha_einsum", "mha_gather", "gqa_einsum"])
def test_ep_tp_loss_and_every_gradient_match_jax(mesh_ep_tp, kv_heads,
                                                 dispatch):
    """f32, 4 heads (2 a shard; GQA on 2 K/V heads, 1 a shard), 4 experts
    over EP 2 x TP 2: the reference's loss and gradients on its 3-axis mesh
    (the params placed under its ``state_shardings``) against the port's
    in one process at the same params, within
    test_lm_loss_and_every_gradient_match_jax's bounds (1e-5 on the loss
    and its parts, 1e-4 of each gradient's largest entry)."""
    over = dict(heads=4, kv_heads=kv_heads, dispatch=dispatch,
                capacity_factor=1.0, **EP_TP)
    args, (m, model, state, _s, batches) = _jax_build(mesh_ep_tp, **over)
    assert state.params["block0"]["q"]["kernel"].shape == (32, 32)
    (tokens,) = next(batches)
    (dev,) = jdata.put_global_batch(m, tokens)
    (jtotal, jm), jgrads = jax.jit(lambda p, t: _jax_loss_and_grads(
        model, p, t, args))(state.params, dev)
    pargs = _port_args(**over)
    port = weights.moe_from_flax(jax.device_get(state.params), pargs,
                                 device="cpu").requires_grad_(True)
    assert port.tp.shards == 2 and port.blocks[1].moe.tp.shards == 2
    total, metrics = moe.make_moe_loss(port, pargs)(torch.from_numpy(tokens))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-5)
    for key in ("loss", "aux_loss", "router_z", "drop_frac"):
        np.testing.assert_allclose(float(metrics[key]), float(jm[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    grads = _flat_grads(weights.to_flax(_grad_model(port)))
    want = _flat_grads(jax.device_get(jgrads))
    assert set(grads) == set(want)
    for name, ref in want.items():
        np.testing.assert_allclose(grads[name], ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), 1e-12),
                                   err_msg=name)


def test_ep_tp_weight_split():
    """The counterpart of test_ep_tp_state_shardings: on each process of
    an expert 2 x model 2 mesh, ``w1`` holds its experts' columns and
    ``w2`` their rows of the hidden units, q / k / v and the lm_head split
    by column, attn_out by row, the router whole; each part is that
    process's share of the one-process model's seeded init."""
    args = _port_args(heads=4, kv_heads=2, **EP_TP)
    one = moe.build(args).model
    whole = dict(one.named_parameters())
    dims = one.tp_dims()
    assert dims["blocks.1.moe.w1"] == (2, 1)
    assert dims["blocks.1.moe.w2"] == (1, 1)
    assert dims["blocks.0.q.weight"] == (0, 1)
    assert dims["blocks.1.attn_out.weight"] == (1, 1)
    assert dims["lm_head.weight"] == (0, 1)
    assert "blocks.1.moe.router.weight" not in dims
    for rank in range(4):
        mesh = moe.make_moe_mesh(4, rank, expert_parallel=2,
                                 tensor_parallel=2)
        assert (mesh.expert_rank, mesh.model_rank) == divmod(rank, 2)
        assert (mesh.batch_rank, mesh.batch_ranks) == (rank // 2, 2)
        part = moe.build_model(args, torch.device("cpu"), mesh.shard(),
                               mesh.tp())
        for name, p in part.named_parameters():
            want = whole[name]
            if moe.is_expert_param(name):
                want = want.chunk(2)[mesh.expert_rank]
            if name in dims:
                want = want.chunk(2, dim=dims[name][0])[mesh.model_rank]
            assert torch.equal(p, want), name
        assert tuple(part.blocks[1].moe.w1.shape) == (2, 32, 64)
        assert tuple(part.blocks[1].moe.w2.shape) == (2, 64, 32)


def test_ep_tp_validates_head_divisibility():
    with pytest.raises(ValueError, match="heads"):
        moe.build(_port_args(heads=3, **EP_TP))
    with pytest.raises(ValueError, match="kv-heads"):
        moe.build(_port_args(heads=4, kv_heads=1, **EP_TP))


def test_ep_tp_checkpoint_round_trip(tmp_path):
    """An EP 2 x TP 2 state saved after 2 steps restores bit-equal into a
    fresh EP 2 x TP 2 build and into EP 1 x TP 1 (--split-qkv on: the
    same param names), and both then take the same third step."""
    def build(over):
        return moe.build(_port_args(split_qkv="on", **over))

    a = build(EP_TP)
    for _ in range(2):
        a.step(torch.from_numpy(next(a.batches)[0]))
    ck = checkpoint.Checkpointer(str(tmp_path), save_every=1)
    ck.save(2, a.state)
    ck.close()
    tokens = next(a.batches)[0]
    ma = a.step(torch.from_numpy(tokens))
    for over in (EP_TP, {}):
        b = build(over)
        state, start = checkpoint.Checkpointer(str(tmp_path)).restore(
            b.state)
        assert start == 2
        for n, p in b.model.named_parameters():
            assert torch.equal(p, state.params[n]), n
        mb = b.step(torch.from_numpy(tokens))
        assert abs(float(ma["loss"]) - float(mb["loss"])) <= 1e-6, over


def test_ep_tp_entry_point_trains_on_the_cpu(monkeypatch):
    """The entry point's ``run`` (what ``python -m
    tpu_operator_torch.payload.moe --device cpu`` calls) at
    ``--expert-parallel 2 --tensor-parallel 2``, small widths, in this
    process: 2 steps through ``train.train_loop``, every metric finite."""
    monkeypatch.delenv("TPU_CHECKPOINT_DIR", raising=False)
    monkeypatch.delenv("TPUJOB_STATUS_URL", raising=False)
    args = moe.parse_args(_argv(steps=2, log_every=1, **EP_TP)
                          + ["--device", "cpu", "--checkpoint-dir", "",
                             "--profile-dir", ""])
    metrics = moe.run(bootstrap.process_info_from_env({}), args)
    assert all(np.isfinite(float(v)) for v in metrics.values())
