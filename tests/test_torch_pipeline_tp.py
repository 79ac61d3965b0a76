"""Tensor parallelism inside the port's pipeline stages (PP x TP:
``tpu_operator_torch.payload.pipeline --tensor-parallel N --split-qkv
auto|on|off``) against the JAX package's on the CPU, and against PP
alone in the port.

The reference runs on the conftest's 8 devices as (data 2, pipe 2, model
2) (``make_pipe_mesh(8, pipeline=2, tensor_parallel=2)``, as
``tests/test_pipeline.py`` holds it), its loss-and-grads functions under
``jax.jit`` with the params placed by its ``state_shardings``; the port
in one process holding both stages and both shards as units (the gloo
tests split them over processes: test_torch_pipeline_multiprocess.py).
Both start from one param tree in the reference's layout (the port's
seeded init exported by ``weights.pipeline_to_flax``, every leaf moved by
seeded numpy noise, carried back by ``weights.pipeline_from_flax``); the
tokens come from numpy with a seed. Dim 32, 2 heads (one a shard), 4
layers, T 32, batch 8 in 4 microbatches; each comparison states its
tolerance.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_operator.payload import data as jdata
from tpu_operator.payload import optimizers as joptimizers
from tpu_operator.payload import pipeline as jpipe
from tpu_operator.payload import train as jtrain
from tpu_operator_torch.payload import bootstrap
from tpu_operator_torch.payload import pipeline
from tpu_operator_torch.payload import weights

TINY = dict(batch=8, seq_len=32, dim=32, heads=2, layers=4, microbatches=4,
            dtype="f32", lr=1e-2, seed=0, log_every=0)
# test_torch_pipeline.py's f32 bounds: the loss within 1e-5 and every
# gradient leaf within 1e-5 of its largest entry (the same f32 math in
# other orders).
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
SCHEDULES = {
    "gpipe": {"schedule": "gpipe"},
    "1f1b_input": {"schedule": "1f1b"},
    "interleaved_v2": {"schedule": "1f1b-interleaved", "virtual_stages": 2},
}


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
    moved by seeded noise, so no leaf is 0 or 1."""
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


def _port_loss_and_grads(flags, s, tree, tokens):
    built = pipeline.build(_port_args(pipeline=s, **flags))
    weights.pipeline_from_flax(tree, built.model)
    loss, grads = built.pipeline.loss_and_grads(torch.from_numpy(tokens))
    return float(loss), weights.pipeline_to_flax(built.model, grads)


# --- against the reference ------------------------------------------------------

# Every schedule at init is held in f32 to LOSS_TOL and GRAD_TOL (the
# reference's gpipe gradient on its PP x TP mesh in bf16 aborts XLA's CPU
# compiler, so the parity at init is f32). The 3-step trajectory runs in
# bf16, the payload's dtype, where the split reorders the bf16 sums of
# the row-parallel products: each loss within test_torch_tensor_parallel.
# py's 5e-3 (bf16 logits differ by up to 2^-5 between the frameworks; a
# gradient summed over the shards 1/N or N times, or a shard's part
# dropped, moves a step's loss by O(0.1)).
TP_LOSS_TOL = 5e-3
TP_FLAGS = dict(tensor_parallel=2)


def _jax_tp_loss_and_grads(flags, tree, tokens):
    """The reference's loss and gradients under ``flags`` at ``tree`` on
    its PP x TP mesh, the params placed as ``state_shardings`` places
    them (``jpipe.build``'s state, its params replaced)."""
    args = jpipe.parse_args(_argv(pipeline=2, **flags))
    mesh = jpipe.make_pipe_mesh(8, pipeline=2, tensor_parallel=2)
    _m, stage, state, _step, _b = jpipe.build(args, mesh=mesh)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, tree))
    shardings = jpipe.state_shardings(
        mesh, state, virtual_stages=jpipe._virtual_stages(args))
    params = jtrain.place_state(mesh, state, shardings).params
    (dev,) = jdata.put_global_batch(mesh, tokens)

    def apply(p, h):
        return stage.apply({"params": p}, h)

    m = args.microbatches
    dtype = jnp.bfloat16 if args.dtype == "bf16" else jnp.float32
    if args.schedule == "gpipe":
        def fn(p, tok):
            return jax.value_and_grad(lambda q: jtrain.next_token_nll(
                jpipe.forward(args, mesh, stage, q, tok), tok))(p)
    elif args.schedule == "1f1b":
        def fn(p, tok):
            return jpipe.pipeline_1f1b_loss_and_grads(
                mesh, apply, p, tok, m, dtype, stash_mode=args.stash)
    else:
        def fn(p, tok):
            return jpipe.pipeline_1f1b_interleaved_loss_and_grads(
                mesh, apply, p, tok, m, args.virtual_stages, dtype)
    loss, grads = jax.jit(fn)(params, dev)
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("label", list(SCHEDULES))
def test_pp_tp_loss_and_gradients_match_the_reference(label):
    """PP 2 x TP 2 at init under gpipe, 1f1b and interleaved V 2 against
    the reference on its 3-axis mesh, f32: the loss within LOSS_TOL and
    every gradient leaf within GRAD_TOL of its largest entry."""
    flags = {**SCHEDULES[label], **TP_FLAGS}
    tree = _tree(_port_args(pipeline=2, seed=1, **flags), seed=11)
    tokens = _tokens(11)
    want_loss, want_grads = _jax_tp_loss_and_grads(flags, tree, tokens)
    got_loss, got_grads = _port_loss_and_grads(flags, 2, tree, tokens)
    assert abs(got_loss - want_loss) <= LOSS_TOL
    _close_trees(got_grads, want_grads, GRAD_TOL)


def test_pp_tp_three_steps_match_the_reference_build_step():
    """Three adam steps of 1f1b at PP 2 x TP 2 from one tree, the port's
    step against the reference's jitted ``make_pipe_train_step`` on its
    3-axis mesh, in bf16 (the shipped job's dtype): every loss within
    TP_LOSS_TOL."""
    flags = {"schedule": "1f1b", "pipeline": 2, **TP_FLAGS, "dtype": "bf16"}
    tree = _tree(_port_args(seed=1, **flags), seed=13)
    args = jpipe.parse_args(_argv(**flags))
    mesh = jpipe.make_pipe_mesh(8, pipeline=2, tensor_parallel=2)
    _m, stage, state, _step, _b = jpipe.build(args, mesh=mesh)
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
        tokens = _tokens(30 + i)
        (dev,) = jdata.put_global_batch(mesh, tokens)
        state, jm = jstep(state, dev)
        tm = built.step(torch.from_numpy(tokens))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= TP_LOSS_TOL, i


# --- the port alone ---------------------------------------------------------------


def test_pp_tp_computes_what_pp_alone_does():
    """In the port, f32, interleaved V 2: PP 2 x TP 4 (the shards as units
    of one process) against PP 2 at TP 1 with --split-qkv on, one seeded
    init (it does not depend on N): the same params, the loss within 2e-6
    and every gradient leaf within 2e-6 of its largest entry (the
    row-parallel partials summed in another order). The other schedules
    at TP 2 are held against the reference above."""
    tokens = torch.from_numpy(_tokens(8))
    flags = dict(SCHEDULES["interleaved_v2"], pipeline=2, heads=4,
                 split_qkv="on")
    runs = []
    for n in (1, 4):
        built = pipeline.build(_port_args(tensor_parallel=n, **flags))
        loss, grads = built.pipeline.loss_and_grads(tokens)
        runs.append((built.model.params, float(loss), grads))
    (p1, l1, g1), (pn, ln, gn) = runs
    for name in p1:
        assert torch.equal(p1[name], pn[name]), name
    assert abs(l1 - ln) <= 2e-6
    for name in g1:
        np.testing.assert_allclose(
            gn[name].numpy(), g1[name].numpy(), rtol=0,
            atol=2e-6 * float(g1[name].abs().max()), err_msg=name)


def test_pp_tp_weight_split():
    """The counterpart of test_pp_tp_state_shardings: over a model group of
    two processes, q / k / v and mlp_up (and its bias) split by column,
    attn_out and mlp_down by row, one past the stack dim; the LayerNorms,
    mlp_down's bias, the embedding and the head whole (the head is not
    vocab-split). Each process's part is its share of the one-process
    model's seeded init."""
    args = _port_args(pipeline=2, tensor_parallel=2, heads=4, kv_heads=2)
    one = pipeline.build(args).model
    assert one.tp_dims() == {
        **{f"stages.block0.{n}.weight": (1, 1)
           for n in ("q", "k", "v", "mlp_up")},
        "stages.block0.mlp_up.bias": (1, 1),
        "stages.block0.attn_out.weight": (2, 1),
        "stages.block0.mlp_down.weight": (2, 1),
        **{f"stages.block1.{n}.weight": (1, 1)
           for n in ("q", "k", "v", "mlp_up")},
        "stages.block1.mlp_up.bias": (1, 1),
        "stages.block1.attn_out.weight": (2, 1),
        "stages.block1.mlp_down.weight": (2, 1)}
    for rank in range(2):
        mesh = pipeline.make_pipe_mesh(2, rank, pipeline=2,
                                       tensor_parallel=2)
        assert (mesh.procs, mesh.model_procs, mesh.model_rank) == (1, 2,
                                                                   rank)
        part = pipeline.PipelineLM(args, mesh, torch.device("cpu"))
        for name, p in part.params.items():
            whole = one.params[name]
            if name in one.tp_dims():
                dim, _ = one.tp_dims()[name]
                want = whole.chunk(2, dim=dim)[rank]
            else:
                want = whole
            assert torch.equal(p, want), name
        assert part.params["stages.block0.q.weight"].shape == (2, 16, 32)
        assert part.params["stages.block0.k.weight"].shape == (2, 8, 32)
        assert part.params["stages.block0.attn_out.weight"].shape == (2, 32,
                                                                      16)
        assert part.params["stages.block0.mlp_down.bias"].shape == (2, 32)
        assert part.params["head"].shape == (32, 256)


@pytest.mark.parametrize("tp", [1, 2])
def test_split_qkv_flag(tp, caplog):
    """--split-qkv on splits q / k / v at any TP; off keeps the fused qkv
    (under TP with the reference's warning, the fused weight's thirds each
    split by head); auto splits under TP and fuses an MHA stage at TP 1.
    Off and on compute one model: the fused weight's thirds are q, k and
    v (f32, the loss within 2e-6)."""
    tokens = torch.from_numpy(_tokens(9))
    names, losses = {}, {}
    for mode in ("auto", "on", "off"):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            built = pipeline.build(_port_args(
                pipeline=2, schedule="1f1b", tensor_parallel=tp,
                split_qkv=mode))
        warned = any("--split-qkv off" in r.getMessage()
                     for r in caplog.records)
        assert warned == (mode == "off" and tp > 1), mode
        names[mode] = {n.split(".")[2] for n in built.model.params
                       if n.startswith("stages.block0.")}
        if mode == "on":
            on = built
        losses[mode] = built
    assert "qkv" in names["off"] and "q" not in names["off"]
    assert "q" in names["on"] and "qkv" not in names["on"]
    assert names["auto"] == names["on" if tp > 1 else "off"]
    off = losses["off"]
    with torch.no_grad():
        for i in range(on.model.blocks):
            fused = off.model.stacks[f"block{i}.qkv.weight"]
            fused.copy_(torch.cat([on.model.stacks[f"block{i}.{n}.weight"]
                                   for n in "qkv"], dim=-2))
    l_on, _ = on.pipeline.loss_and_grads(tokens)
    l_off, g_off = off.pipeline.loss_and_grads(tokens)
    assert abs(float(l_on) - float(l_off)) <= 2e-6
    assert torch.isfinite(g_off["stages.block0.qkv.weight"]).all()


@pytest.mark.parametrize("over", [dict(heads=3), dict(heads=4, kv_heads=1)],
                         ids=["heads", "kv_heads"])
def test_pp_tp_validates_divisibility(over):
    with pytest.raises(ValueError, match="tensor-parallel"):
        pipeline.build(_port_args(pipeline=2, tensor_parallel=2, **over))


def test_pp_tp_weights_round_trip():
    """A reference-layout tree carried into a PP 2 x TP 2 model and back is
    the same tree, in one process (whole weights) and, part by part, in
    each of a model pair's processes (``pipeline_from_flax`` keeps the
    process's part; ``pipeline_to_flax`` gives that part back)."""
    args = _port_args(pipeline=2, schedule="1f1b", tensor_parallel=2)
    tree = _tree(args, seed=10)
    built = pipeline.build(args)
    weights.pipeline_from_flax(tree, built.model)
    _close_trees(weights.pipeline_to_flax(built.model), tree, 0.0)
    flat = dict(_flat(tree))
    for rank in range(2):
        mesh = pipeline.make_pipe_mesh(2, rank, pipeline=2,
                                       tensor_parallel=2)
        part = pipeline.PipelineLM(args, mesh, torch.device("cpu"))
        weights.pipeline_from_flax(tree, part)
        got = dict(_flat(weights.pipeline_to_flax(part)))
        q = got["/stages/block0/q/kernel"]
        np.testing.assert_array_equal(
            q, np.split(flat["/stages/block0/q/kernel"], 2, axis=-1)[rank])
        down = got["/stages/block0/mlp_down/kernel"]
        np.testing.assert_array_equal(
            down, np.split(flat["/stages/block0/mlp_down/kernel"], 2,
                           axis=-2)[rank])
        np.testing.assert_array_equal(got["/head"], flat["/head"])


@pytest.mark.parametrize("split", ["on", "off"])
def test_pp_tp_entry_point_trains_on_the_cpu(split, monkeypatch):
    """The entry point's ``run`` (what ``python -m
    tpu_operator_torch.payload.pipeline --device cpu`` calls) at
    ``--pipeline 2 --tensor-parallel 2 --split-qkv on|off --zero1``, small
    widths, in this process: 2 steps through ``train.train_loop`` to a
    finite loss."""
    monkeypatch.delenv("TPU_CHECKPOINT_DIR", raising=False)
    monkeypatch.delenv("TPUJOB_STATUS_URL", raising=False)
    args = pipeline.parse_args(
        _argv(steps=2, pipeline=2, tensor_parallel=2, split_qkv=split,
              schedule="1f1b", log_every=1)
        + ["--zero1", "--device", "cpu", "--checkpoint-dir", "",
           "--profile-dir", ""])
    metrics = pipeline.run(bootstrap.process_info_from_env({}), args)
    assert np.isfinite(float(metrics["loss"]))
