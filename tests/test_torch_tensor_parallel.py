"""The port's Megatron-style tensor parallelism (``--tensor-parallel``,
``--split-qkv``; ``models.DecoderBlock._forward_tp``) against the JAX
package's transformer under ``lm_tp_shardings`` on its 8-device CPU mesh,
case for case as ``tests/test_tensor_parallel.py`` holds the reference:
the column / row split of each weight, the TP loss against the JAX TP
loss and against TP 1, descent, SP x TP against the JAX 3-axis mesh,
Ulysses refusing TP, GQA under TP and its validation, ``--split-qkv off``
(its warning, and the fused ``qkv`` split by head), and ``--loss-chunk``
with TP (refused). The port runs every shard in one process as units (the
gloo tests run them over processes: test_torch_tp_multiprocess.py); the
weights come from the JAX init through ``weights.from_flax``, the batches
from the same seeded stream, and each comparison states its tolerance.
"""

import logging

import numpy as np
import pytest
import torch

import jax

from tpu_operator.payload import data as jdata
from tpu_operator.payload import train as jtrain
from tpu_operator.payload import transformer as jtransformer
from tpu_operator_torch.payload import collectives
from tpu_operator_torch.payload import data as tdata
from tpu_operator_torch.payload import models
from tpu_operator_torch.payload import optimizers
from tpu_operator_torch.payload import transformer
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

# bf16 logits differ by up to 2^-5 between the frameworks (the bound of
# tests/test_torch_train.py and test_torch_sp_train.py): a step's loss
# within 5e-3. A wrong split (a head's columns in the wrong shard, a
# partial product dropped or counted twice, the bias added per shard)
# moves it by O(0.1) or more.
LOSS_TOL = 5e-3
# Gradients at init, against the JAX gradient at the same params and
# batch: the bf16 products of the two frameworks leave each parameter's
# gradient within ~1.7% of its norm, the whole within ~1.2% (dim 64, 2
# layers). Each parameter is held to 2^-4 of its norm and the whole to
# 2^-5: a gradient summed over the shards by 1/N or N times, a
# row-parallel gradient counted twice or a shard's part dropped is off by
# 50% or more.
GRAD_REL_TOL = 2.0 ** -4
GRAD_WHOLE_TOL = 2.0 ** -5


def _argv(extra=()):
    return ["--batch", "8", "--seq-len", "64", "--dim", "64", "--heads", "4",
            "--layers", "2", "--log-every", "0", "--checkpoint-dir", "",
            "--profile-dir", "", *extra]


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def _against_jax(argv, jmesh, steps=3, tp=None, seq=1):
    """(port losses, JAX losses) of ``steps`` steps of the flags ``argv``
    from the JAX init: the JAX step on ``jmesh``, the port's in one process
    holding every shard."""
    args = jtransformer.parse_args(argv)
    _m, _model, state, jstep, jbatches = jtransformer.build(args, mesh=jmesh)
    targs = transformer.parse_args(argv)
    model = weights.from_flax(_np_tree(state.params), heads=targs.heads,
                              param_dtype=torch.float32,
                              tensor_parallel=tp or targs.tensor_parallel)
    model.requires_grad_(True)
    optimizer = optimizers.from_args(targs)
    tstep = transformer.make_lm_train_step(
        model, optimizer, optimizer.init(list(model.parameters())),
        mesh=transformer.make_lm_mesh(1, 0, seq, tp or targs.tensor_parallel))
    spec = jtransformer.lm_token_spec(jmesh)
    jl, tl = [], []
    for _ in range(steps):
        (jb,) = next(jbatches)
        state, metrics = jstep(state, *jdata.put_global_batch(jmesh, jb,
                                                              spec=spec))
        jl.append(float(jax.device_get(metrics["loss"])))
        tl.append(float(tstep(torch.from_numpy(jb))["loss"]))
    return tl, jl


def _grad_tree(model):
    """{flax path: gradient} of ``model``'s params as f32 numpy."""
    import copy

    twin = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(twin.parameters(), model.parameters()):
            p.copy_(q.grad)
    return _flat(weights.to_flax(twin))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _port_loss_and_grads(model, targs, tp, seq):
    """(loss, {flax path: gradient}) of one microbatch through the port's
    loss on one process holding every shard."""
    mesh = transformer.make_lm_mesh(1, 0, seq, tp)
    loss_fn = transformer.make_lm_loss(model, mesh, targs.sp_layout,
                                       sp_mode=targs.sp_mode)

    def run(tokens):
        loss, _ = loss_fn(torch.from_numpy(tokens))
        loss.backward()
        return float(loss.detach()), _grad_tree(model)

    return run


def _grads_against_jax(argv, jmesh, tp, seq=1):
    """(port (loss, grads), JAX (loss, grads)) at init, on the first batch:
    jax.grad of the reference's loss (``make_lm_train_step``'s
    ``loss_fn``) with the params and tokens placed on ``jmesh`` under the
    TP shardings, and the port's loss and gradients at the same params."""
    args = jtransformer.parse_args(argv)
    jm, jmodel, state, _step, jbatches = jtransformer.build(args,
                                                            mesh=jmesh)
    (tokens,) = next(jbatches)

    def loss_fn(params, tok):
        return jtrain.next_token_nll(jmodel.apply({"params": params}, tok),
                                     tok)

    placed = jdata.put_global_batch(jm, tokens,
                                    spec=jtransformer.lm_token_spec(jm))
    placed = placed[0] if isinstance(placed, (tuple, list)) else placed
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(state.params,
                                                         placed)
    want = (float(jax.device_get(jloss)), _flat(_np_tree(jgrads)))
    targs = transformer.parse_args(argv)
    model = weights.from_flax(_np_tree(state.params), heads=targs.heads,
                              param_dtype=torch.float32, tensor_parallel=tp)
    model.requires_grad_(True)
    return _port_loss_and_grads(model, targs, tp, seq)(tokens), want


def _grad_gaps(got, want):
    """Each parameter's gradient difference norm over its reference norm,
    and the whole gradient's."""
    gaps, diff_sq, ref_sq = {}, 0.0, 0.0
    assert set(got) == set(want)
    for name, ref in want.items():
        diff, norm = np.linalg.norm(got[name] - ref), np.linalg.norm(ref)
        gaps[name] = diff / max(norm, 1e-30)
        diff_sq, ref_sq = diff_sq + diff ** 2, ref_sq + norm ** 2
    return gaps, (diff_sq / ref_sq) ** 0.5


@pytest.fixture(scope="module")
def tp_mesh():
    return jtransformer.make_lm_mesh(8, tensor_parallel=2)  # (data 4, model 2)


def test_tp_weights_split_col_and_row():
    """q/k/v, mlp_up (with its bias) and lm_head split along their output
    rows, attn_out and mlp_down along their input columns; LayerNorms,
    embeddings and mlp_down's bias whole. A process holding 2 of 4 shards
    holds exactly its rows / columns of the one-process model (the same
    seeded draw)."""
    args = transformer.parse_args(_argv(["--tensor-parallel", "4",
                                         "--heads", "8", "--kv-heads", "4",
                                         "--device", "cpu"]))
    whole = transformer.build_model(args, torch.device("cpu"))
    dims = whole.tp_dims()
    assert dims["blocks.0.q.weight"] == (0, 1)
    assert dims["blocks.0.k.weight"] == (0, 1)
    assert dims["blocks.0.v.weight"] == (0, 1)
    assert dims["blocks.0.mlp_up.weight"] == (0, 1)
    assert dims["blocks.0.mlp_up.bias"] == (0, 1)
    assert dims["lm_head.weight"] == (0, 1)
    assert dims["blocks.0.attn_out.weight"] == (1, 1)
    assert dims["blocks.0.mlp_down.weight"] == (1, 1)
    assert not any("ln_" in n or "embed" in n or "mlp_down.bias" in n
                   for n in dims)
    full = dict(whole.named_parameters())
    for index in (0, 1):
        tp = collectives.TPShards(4, 2, index)
        part = transformer.build_model(args, torch.device("cpu"), tp)
        for name, p in part.named_parameters():
            want = full[name]
            if name in dims:
                dim = dims[name][0]
                want = want.chunk(2, dim=dim)[index]
            assert p.shape == want.shape, name
            assert torch.equal(p, want), name


def test_tp_matches_jax_tp(tp_mesh):
    """--tensor-parallel 2: the port's two shards against the JAX step on
    its (data 4, model 2) mesh, 3 steps from the same params."""
    tl, jl = _against_jax(_argv(["--tensor-parallel", "2"]), tp_mesh)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_TOL)


def test_tp_matches_tp1():
    """The port at --tensor-parallel 4 and 1 (both --split-qkv on, so the
    param trees and the seeded draws are identical): the row-parallel
    partial products rounded to bf16 a shard and summed, against one
    product; the reference's test holds its TP 4 to TP 1 within 5e-3 on
    step 2, so do these."""
    losses = {}
    for tp in (1, 4):
        built = transformer.build(transformer.parse_args(_argv([
            "--tensor-parallel", str(tp), "--split-qkv", "on",
            "--device", "cpu"])))
        (tokens,) = next(built.batches)
        built.step(torch.from_numpy(tokens))
        losses[tp] = float(built.step(torch.from_numpy(tokens))["loss"])
    assert abs(losses[1] - losses[4]) < LOSS_TOL, losses


GRAD_CASES = {
    "tp2": (_argv(["--tensor-parallel", "2"]), 1, 2),
    "tp2_fused_qkv": (_argv(["--tensor-parallel", "2", "--split-qkv",
                             "off"]), 1, 2),
    "tp2_gqa": (_argv(["--tensor-parallel", "2", "--kv-heads", "2",
                       "--dim", "32", "--seq-len", "32"]), 1, 2),
    "sp2_tp2": (["--batch", "4", "--seq-len", "64", "--dim", "64", "--heads",
                 "4", "--layers", "2", "--seq-parallel", "2",
                 "--tensor-parallel", "2", "--log-every", "0",
                 "--checkpoint-dir", "", "--profile-dir", ""], 2, 2),
}


def _assert_grads_close(got, want):
    (got_loss, got_g), (want_loss, want_g) = got, want
    assert abs(got_loss - want_loss) < LOSS_TOL, (got_loss, want_loss)
    gaps, whole = _grad_gaps(got_g, want_g)
    worst = max(gaps, key=gaps.get)
    assert whole <= GRAD_WHOLE_TOL, whole
    assert gaps[worst] <= GRAD_REL_TOL, (worst, gaps[worst])


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_tp_loss_and_every_gradient_match_jax(case):
    """The loss and every parameter's gradient at init against jax.grad of
    the reference's loss under ``lm_tp_shardings``: on the (data 4, model
    2) mesh (split and fused qkv, MHA and GQA) and on the (data 2, seq 2,
    model 2) mesh; the port in one process holding every shard. Adam's
    update hardly moves when a gradient is scaled, so the step losses of
    the tests above cannot see a gradient summed wrongly over the shards;
    this can (GRAD_REL_TOL)."""
    argv, seq, tp = GRAD_CASES[case]
    jmesh = jtransformer.make_lm_mesh(8, seq_parallel=seq,
                                      tensor_parallel=tp)
    got, want = _grads_against_jax(argv, jmesh, tp, seq)
    _assert_grads_close(got, want)


@pytest.mark.parametrize("seq", [1, 2])
def test_tp_gradients_match_tp1(seq):
    """The port's loss and every gradient at init, --tensor-parallel 4
    against 1 (both --split-qkv on: the same seeded params), alone and
    under --seq-parallel 2, to the tolerances of the JAX comparison."""
    sides = []
    for tp in (4, 1):
        targs = transformer.parse_args(_argv([
            "--tensor-parallel", str(tp), "--split-qkv", "on",
            "--seq-parallel", str(seq), "--heads", "4", "--device", "cpu"]))
        model = transformer.build_model(
            targs, torch.device("cpu"),
            transformer.make_lm_mesh(1, 0, seq, tp).tp()).requires_grad_(True)
        sides.append((model, targs, tp))
    for a, b in zip(sides[0][0].parameters(), sides[1][0].parameters()):
        assert torch.equal(a, b)
    (tokens,) = next(tdata.synthetic_lm(0, 8, 64, vocab=256))
    got, want = (_port_loss_and_grads(model, targs, tp, seq)(tokens)
                 for model, targs, tp in sides)
    _assert_grads_close(got, want)


def test_tp_loss_descends():
    built = transformer.build(transformer.parse_args(_argv([
        "--tensor-parallel", "4", "--lr", "1e-2", "--device", "cpu"])))
    losses = []
    for _ in range(30):
        (tokens,) = next(built.batches)
        losses.append(float(built.step(torch.from_numpy(tokens))["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.7, losses[::5]


def test_tp_and_sp_compose_into_3axis_mesh():
    """The mesh: model innermost, then seq, then data; each degree must
    lay out over the processes."""
    mesh = transformer.make_lm_mesh(8, 5, seq_parallel=2, tensor_parallel=2)
    assert (mesh.data, mesh.seq_procs, mesh.model_procs) == (2, 2, 2)
    assert (mesh.data_rank, mesh.seq_rank, mesh.model_rank) == (1, 0, 1)
    assert list(mesh.seq_ranks()) == [5, 7]
    assert mesh.ring().ranks == (5, 7) and mesh.ring().index == 0
    assert mesh.tp() == collectives.TPShards(2, 2, 1, None)
    one = transformer.make_lm_mesh(1, 0, 4, 2)
    assert (one.seq_procs, one.model_procs, one.tp().local) == (1, 1, 2)
    with pytest.raises(ValueError, match="seq-parallel"):
        transformer.make_lm_mesh(8, 0, seq_parallel=3, tensor_parallel=4)
    with pytest.raises(ValueError, match="tensor-parallel"):
        transformer.make_lm_mesh(6, 0, tensor_parallel=4)


def test_sp_tp_matches_jax_3axis():
    """--seq-parallel 2 --tensor-parallel 2: each TP shard runs its own
    ring over its heads. The port in one process against the JAX step on
    the (data 2, seq 2, model 2) mesh, 3 steps."""
    jmesh = jtransformer.make_lm_mesh(8, seq_parallel=2, tensor_parallel=2)
    tl, jl = _against_jax(
        ["--batch", "4", "--seq-len", "64", "--dim", "64", "--heads", "4",
         "--layers", "2", "--seq-parallel", "2", "--tensor-parallel", "2",
         "--log-every", "0", "--checkpoint-dir", "", "--profile-dir", ""],
        jmesh, seq=2)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_TOL)


def test_ulysses_rejects_tensor_parallel():
    args = transformer.parse_args(
        ["--batch", "4", "--seq-len", "32", "--dim", "32", "--heads", "4",
         "--layers", "1", "--seq-parallel", "2", "--tensor-parallel", "2",
         "--sp-mode", "ulysses", "--device", "cpu"])
    with pytest.raises(ValueError, match="ulysses"):
        transformer.build(args)


def test_tp_rejects_fsdp():
    args = transformer.parse_args(_argv(["--tensor-parallel", "2", "--fsdp",
                                         "--device", "cpu"]))
    with pytest.raises(ValueError, match="exclusive"):
        transformer.build(args)


def test_gqa_composes_with_tensor_parallel():
    """4 / 2 heads over TP 2: each shard holds 2 query heads and their one
    K/V head. Against the JAX GQA TP step on its (data 4,
    model 2) mesh."""
    jmesh = jtransformer.make_lm_mesh(8, tensor_parallel=2)
    tl, jl = _against_jax(
        ["--batch", "8", "--seq-len", "32", "--dim", "32", "--heads", "4",
         "--kv-heads", "2", "--layers", "2", "--tensor-parallel", "2",
         "--log-every", "0", "--checkpoint-dir", "", "--profile-dir", ""],
        jmesh)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_TOL)


def test_gqa_validates_divisibility():
    cpu = ["--device", "cpu"]
    for flags in (["--heads", "4", "--kv-heads", "3"],
                  ["--heads", "4", "--kv-heads", "-1"],
                  ["--heads", "4", "--kv-heads", "1", "--tensor-parallel",
                   "2", "--dim", "32"]):
        with pytest.raises(ValueError, match="kv-heads"):
            transformer.build(transformer.parse_args(flags + cpu))
    with pytest.raises(ValueError, match="--heads 6 must divide"):
        transformer.build(transformer.parse_args(
            ["--heads", "6", "--dim", "60", "--tensor-parallel", "4"] + cpu))


def test_split_qkv_off_under_tp_warns(caplog):
    with caplog.at_level(logging.WARNING):
        transformer.build(transformer.parse_args(
            ["--batch", "8", "--heads", "4", "--dim", "32", "--seq-len",
             "32", "--tensor-parallel", "2", "--split-qkv", "off",
             "--device", "cpu"]))
    assert any("split-qkv off" in r.message for r in caplog.records)
    assert models.resolve_split_qkv("auto", 2, logging.getLogger()) is True
    assert models.resolve_split_qkv("auto", 1, logging.getLogger()) is False


def test_tp_fused_qkv_matches_jax(tp_mesh):
    """--split-qkv off under TP 2: the fused [3d, d] qkv, each shard taking
    its heads' rows of each third, against the JAX step whose fused kernel
    shards over the model axis (its reshard is layout, not math)."""
    tl, jl = _against_jax(_argv(["--tensor-parallel", "2", "--split-qkv",
                                 "off"]), tp_mesh)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_TOL)


def test_loss_chunk_with_tp_is_refused():
    """The reference accepts --loss-chunk with TP silently (ADVICE.md);
    the port refuses it: the chunked head runs on the whole lm_head."""
    with pytest.raises(ValueError, match="--loss-chunk requires "
                                         "--tensor-parallel 1"):
        transformer.build(transformer.parse_args(_argv(
            ["--tensor-parallel", "2", "--loss-chunk", "16", "--device",
             "cpu"])))
