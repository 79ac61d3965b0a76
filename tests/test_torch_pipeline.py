"""The port's pipeline-parallel LM payload
(``tpu_operator_torch.payload.pipeline``) against the JAX package's
(``tpu_operator/payload/pipeline.py``) on the CPU.

The reference runs on the conftest's 8-device CPU mesh at S devices
(``make_pipe_mesh(S, pipeline=S)``: data 1, pipe S), its loss-and-grads
functions under ``jax.jit``; the port in one process holding every stage.
Both start from one param tree in the reference's layout: the port's
seeded init exported by ``weights.pipeline_to_flax``, every leaf moved by
seeded numpy noise, then carried into a fresh port model by
``weights.pipeline_from_flax``; the tokens come from numpy with a seed.
f32, dim 32, 2 heads, 4 layers, T 32, batch 8 in 4 microbatches.

Bounds: the loss within 1e-5 and every gradient leaf within 1e-5 of its
largest entry (the two sides compute the same f32 math in other orders;
1.2e-6 and 1.9e-6 were read); after 3 adam steps at lr 1e-2 each loss
within 1e-5 and every parameter within 1e-4 of max(1, its largest entry)
(adam's first steps divide by sqrt(v) ~ |g|, so f32 noise in a small
gradient moves a parameter by up to lr).

Tensor parallelism inside the stages (PP x TP) is held in
test_torch_pipeline_tp.py, a file of its own so that ``--dist loadfile``
runs it on another worker.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_operator.payload import data as jdata
from tpu_operator.payload import optimizers as joptimizers
from tpu_operator.payload import pipeline as jpipe
from tpu_operator.payload import train as jtrain
from tpu_operator_torch.payload import pipeline
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

TINY = dict(batch=8, seq_len=32, dim=32, heads=2, layers=4, microbatches=4,
            dtype="f32", lr=1e-2, seed=0, log_every=0)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
STEP_PARAM_TOL = 1e-4

# (label, flags): every schedule and stash mode, interleaved at V 1 and 2.
SCHEDULES = {
    "gpipe": {"schedule": "gpipe"},
    "1f1b_input": {"schedule": "1f1b"},
    "1f1b_residuals": {"schedule": "1f1b", "stash": "residuals"},
    "interleaved_v1": {"schedule": "1f1b-interleaved", "virtual_stages": 1},
    "interleaved_v2": {"schedule": "1f1b-interleaved", "virtual_stages": 2},
}
# S 4 x V 2 would need 8 layers; the 4-layer model takes S x V <= 4.
CASES = [(label, s) for label in SCHEDULES for s in (1, 2, 4)
         if s * SCHEDULES[label].get("virtual_stages", 1) <= 4]


def _argv(**over):
    base = dict(TINY)
    base.update(over)
    argv = []
    for k, v in base.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return argv


def _port_args(**over):
    return pipeline.parse_args(_argv(**over) + ["--device", "cpu"])


def _tokens(seed=0):
    rng = np.random.default_rng(100 + seed)
    return rng.integers(0, 256, size=(TINY["batch"], TINY["seq_len"]),
                        dtype=np.int32)


def _tree(args, seed=0):
    """A param tree in the reference's layout for ``args``: the port's init
    (another seed) moved by seeded noise, so no leaf is 0 or 1."""
    model = pipeline.build(args).model
    tree = weights.pipeline_to_flax(model)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _close_trees(got, want, tol):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=tol * float(np.abs(w).max()),
                                   err_msg=k)


def _jax_loss_and_grads(flags, s, tree, tokens):
    args = jpipe.parse_args(_argv(pipeline=s, **flags))
    mesh = jpipe.make_pipe_mesh(s, pipeline=s)
    stage = jpipe._stage_module(args)
    (dev,) = jdata.put_global_batch(mesh, tokens)
    params = jax.tree_util.tree_map(jnp.asarray, tree)

    def apply(p, h):
        return stage.apply({"params": p}, h)

    m = args.microbatches
    if args.schedule == "gpipe":
        def fn(p, tok):
            return jax.value_and_grad(lambda q: jtrain.next_token_nll(
                jpipe.forward(args, mesh, stage, q, tok), tok))(p)
    elif args.schedule == "1f1b":
        def fn(p, tok):
            return jpipe.pipeline_1f1b_loss_and_grads(
                mesh, apply, p, tok, m, jnp.float32, stash_mode=args.stash)
    else:
        def fn(p, tok):
            return jpipe.pipeline_1f1b_interleaved_loss_and_grads(
                mesh, apply, p, tok, m, args.virtual_stages, jnp.float32)
    loss, grads = jax.jit(fn)(params, dev)
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def _port_loss_and_grads(flags, s, tree, tokens, **extra):
    built = pipeline.build(_port_args(pipeline=s, **flags, **extra))
    weights.pipeline_from_flax(tree, built.model)
    loss, grads = built.pipeline.loss_and_grads(torch.from_numpy(tokens))
    return float(loss), weights.pipeline_to_flax(built.model, grads)


# --- the schedule tables ------------------------------------------------------


@pytest.mark.parametrize("s,m", [(1, 1), (1, 4), (2, 4), (3, 5), (4, 4),
                                 (4, 8), (8, 16)])
def test_onef1b_table_equals_the_reference(s, m):
    assert pipeline.onef1b_schedule(s, m) == jpipe.onef1b_schedule(s, m)


@pytest.mark.parametrize("s,v,m", [(1, 1, 4), (1, 2, 4), (2, 1, 4),
                                   (2, 2, 4), (2, 3, 6), (4, 2, 8),
                                   (4, 4, 8), (8, 2, 8), (4, 2, 16)])
def test_interleaved_table_equals_the_reference(s, v, m):
    got = pipeline.onef1b_interleaved_schedule(s, v, m)
    want = jpipe.onef1b_interleaved_schedule(s, v, m)
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


def test_interleaved_table_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="divisible"):
        pipeline.onef1b_interleaved_schedule(4, 2, 6)


def test_gpipe_table_runs_every_forward_before_every_backward():
    table = pipeline.gpipe_schedule(3, 4)
    ticks = {(s, op): t for t, row in enumerate(table)
             for s, op in enumerate(row) if op}
    assert len(ticks) == 2 * 3 * 4
    last_f = max(t for (s, op), t in ticks.items() if op[0] == "F")
    assert min(t for (s, op), t in ticks.items() if op[0] == "B") > last_f
    for m in range(4):
        for s in range(2):
            assert ticks[(s + 1, ("F", m))] == ticks[(s, ("F", m))] + 1
            assert ticks[(s, ("B", m))] == ticks[(s + 1, ("B", m))] + 1


# --- loss and gradients against the reference ---------------------------------


@pytest.mark.parametrize("label,s", CASES,
                         ids=[f"{label}_s{s}" for label, s in CASES])
def test_loss_and_gradients_match_the_reference(label, s):
    flags = SCHEDULES[label]
    args = _port_args(pipeline=s, seed=1, **flags)
    tree = _tree(args, seed=s)
    tokens = _tokens(s)
    want_loss, want_grads = _jax_loss_and_grads(flags, s, tree, tokens)
    got_loss, got_grads = _port_loss_and_grads(flags, s, tree, tokens)
    assert abs(got_loss - want_loss) <= LOSS_TOL
    _close_trees(got_grads, want_grads, GRAD_TOL)


def test_gqa_matches_the_reference():
    """4 query heads on 2 K/V heads (split q / k / v), 1f1b at S 2."""
    flags = {"schedule": "1f1b", "heads": 4, "kv_heads": 2}
    tree = _tree(_port_args(pipeline=2, seed=1, **flags), seed=7)
    assert tree["stages"]["block0"]["k"]["kernel"].shape == (2, 32, 16)
    tokens = _tokens(7)
    want_loss, want_grads = _jax_loss_and_grads(flags, 2, tree, tokens)
    got_loss, got_grads = _port_loss_and_grads(flags, 2, tree, tokens)
    assert abs(got_loss - want_loss) <= LOSS_TOL
    _close_trees(got_grads, want_grads, GRAD_TOL)


def test_three_steps_match_the_reference_build_step():
    """The loss trajectory and the params after 3 adam steps, 1f1b at S 2,
    against the reference's jitted step (``make_pipe_train_step``)."""
    flags = {"schedule": "1f1b", "pipeline": 2}
    tree = _tree(_port_args(seed=1, **flags), seed=3)
    args = jpipe.parse_args(_argv(**flags))
    mesh = jpipe.make_pipe_mesh(2, pipeline=2)
    stage = jpipe._stage_module(args)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tx = joptimizers.from_args(args)
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats={}, opt_state=tx.init(params))
    shardings = jpipe.state_shardings(mesh, state)
    state = jtrain.place_state(mesh, state, shardings)
    jstep = jpipe.make_pipe_train_step(args, stage, mesh, state, tx,
                                       shardings)
    built = pipeline.build(_port_args(**flags))
    weights.pipeline_from_flax(tree, built.model)
    for i in range(3):
        tokens = _tokens(20 + i)
        (dev,) = jdata.put_global_batch(mesh, tokens)
        state, jm = jstep(state, dev)
        tm = built.step(torch.from_numpy(tokens))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL, i
    got = dict(_flat(weights.pipeline_to_flax(built.model)))
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, state.params)))
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k], w, rtol=0,
            atol=STEP_PARAM_TOL * max(1.0, float(np.abs(w).max())),
            err_msg=k)


# --- the port alone ------------------------------------------------------------


def _by_layer(tree, args):
    """{(layer, path): leaf} of a tree's stage stacks under ``args``'s
    layout: layer l is block l % blocks of chunk c = l // blocks, at
    ``[c // S, c % S]`` of a ``[V, S, ...]`` leaf or ``[c]`` of ``[S,
    ...]``."""
    s, v = args.pipeline, pipeline.virtual_stages(args)
    blocks = args.layers // (s * max(v, 1))
    out = {}
    for layer in range(args.layers):
        c, i = divmod(layer, blocks)
        index = (c // s, c % s) if v else (c,)
        for path, leaf in _flat(tree["stages"][f"block{i}"]):
            out[(layer, path)] = leaf[index]
    return out


def test_every_layout_and_schedule_computes_one_model():
    """The init does not depend on the layout: gpipe at S 1 and every other
    schedule at S 1, 2 and 4 give the same loss and the same gradient of
    every layer's every param (f32, within summation-order noise of 2e-6
    of each leaf's largest entry)."""
    tokens = torch.from_numpy(_tokens(5))
    base_args = _port_args()
    base = pipeline.build(base_args)
    want_loss, want = base.pipeline.loss_and_grads(tokens)
    want = weights.pipeline_to_flax(base.model, want)
    want_layers = _by_layer(want, base_args)
    for label, s in CASES:
        args = _port_args(pipeline=s, **SCHEDULES[label])
        built = pipeline.build(args)
        loss, grads = built.pipeline.loss_and_grads(tokens)
        assert abs(float(loss) - float(want_loss)) <= 2e-6, (label, s)
        got = weights.pipeline_to_flax(built.model, grads)
        for key, g in _by_layer(got, args).items():
            w = want_layers[key]
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=2e-6 * float(np.abs(w).max()),
                                       err_msg=f"{label} S{s} {key}")
        for name in ("tok_embed", "pos_embed", "head"):
            np.testing.assert_allclose(
                got[name], want[name], rtol=0,
                atol=2e-6 * float(np.abs(want[name]).max()), err_msg=name)


@pytest.mark.parametrize("policy", ["full", "dots_attn"])
def test_remat_is_bit_equal_to_no_remat(policy):
    tokens = torch.from_numpy(_tokens(6))
    runs = []
    for extra in ([], ["--remat", "--remat-policy", policy]):
        built = pipeline.build(pipeline.parse_args(
            _argv(pipeline=2, schedule="1f1b") + ["--device", "cpu"]
            + extra))
        runs.append(built.pipeline.loss_and_grads(tokens))
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


@pytest.mark.parametrize("m", [4, 16])
def test_stash_depth_is_o_stages_not_microbatches(m):
    """1f1b stage s holds at most S - s stashed microbatches whatever M is;
    gpipe holds all M."""
    tokens = torch.from_numpy(np.random.default_rng(m).integers(
        0, 256, size=(m, 32), dtype=np.int32))
    for schedule, want in (("1f1b", {0: 4, 1: 3, 2: 2, 3: 1}),
                           ("gpipe", {s: m for s in range(4)})):
        built = pipeline.build(_port_args(batch=m, microbatches=m,
                                          pipeline=4, schedule=schedule))
        built.pipeline.loss_and_grads(tokens)
        assert built.pipeline.stash_peak == want, schedule


@pytest.mark.parametrize("over,match", [
    (dict(batch=6), "--batch"),
    (dict(layers=6, pipeline=4), "layers"),
    (dict(layers=4, pipeline=2, schedule="1f1b-interleaved",
          virtual_stages=4), "virtual-stages"),
    (dict(schedule="gpipe", stash="residuals"), "residuals"),
    (dict(schedule="1f1b-interleaved", stash="residuals"), "residuals"),
    (dict(schedule="1f1b", grad_accum=2), "grad-accum"),
    (dict(schedule="1f1b-interleaved", grad_accum=2), "grad-accum"),
    (dict(schedule="1f1b-interleaved", pipeline=4, microbatches=2,
          batch=8), "divisible"),
    (dict(schedule="1f1b-interleaved", virtual_stages=0), "virtual"),
], ids=["batch", "layers", "layers_x_virtual", "stash_gpipe",
        "stash_interleaved", "grad_accum_1f1b", "grad_accum_interleaved",
        "interleaved_microbatches", "virtual_0"])
def test_build_refuses_what_the_reference_refuses(over, match):
    with pytest.raises(ValueError, match=match):
        pipeline.build(_port_args(**over))


@pytest.mark.parametrize("flags", [
    {"pipeline": 2, "schedule": "1f1b"},
    {"pipeline": 2, "schedule": "1f1b-interleaved", "virtual_stages": 2}],
    ids=["plain", "interleaved"])
def test_weights_round_trip(flags):
    """A reference-layout tree ([S, ...] or [V, S, ...]) carried into the
    port and back is the same tree, and the chunk modules read it: chunk
    (j, d)'s block i holds layer (j·S + d)·blocks + i."""
    args = _port_args(**flags)
    tree = _tree(args, seed=9)
    built = pipeline.build(args)
    weights.pipeline_from_flax(tree, built.model)
    _close_trees(weights.pipeline_to_flax(built.model), tree, 0.0)
    model = built.model
    for (j, d), stage in model.chunks.items():
        index = (j, d) if model.V else (d,)
        got = stage.block0.mlp_up.weight.detach().numpy()
        want = np.asarray(tree["stages"]["block0"]["mlp_up"]["kernel"])
        np.testing.assert_array_equal(got, want[index].T)
    with pytest.raises(ValueError):
        weights.pipeline_from_flax(
            _tree(_port_args(pipeline=1, schedule="1f1b")), built.model)
