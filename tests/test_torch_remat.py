"""Remat in the port (models.remat_policy / remat_block, compute.lm_block,
the ``tpu_operator_torch::flash_fwd`` op) on the CPU: under every
``--remat-policy`` the loss and every gradient are bit-equal to the run
without remat, the backward re-runs exactly the ops the policy does not
save, and the ``--remat --remat-policy dots_attn`` step follows the JAX
transformer's, with and without ``--seq-parallel 4``.
"""

import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax

from tpu_operator.payload import data as jdata
from tpu_operator.payload import models as jmodels
from tpu_operator.payload import transformer as jtransformer
from tpu_operator_torch.payload import compute
from tpu_operator_torch.payload import flash_attention as fa
from tpu_operator_torch.payload import models
from tpu_operator_torch.payload import optimizers
from tpu_operator_torch.payload import transformer
from tpu_operator_torch.payload import weights

TINY = ["--dim", "64", "--layers", "2", "--heads", "4", "--kv-heads", "2",
        "--vocab", "256", "--seq-len", "64", "--batch", "4",
        "--grad-accum", "2", "--log-every", "0", "--seed", "0",
        "--checkpoint-dir", "", "--profile-dir", ""]
LAYERS = 2

# Ops the backward re-runs per layer, by policy: the products of the
# dense layers (aten.mm), the attention forward (the flash_fwd op) and the
# gelu. PyTorch replays a checkpointed forward up to the last value the
# backward needs, so mlp_down's product (whose output no backward reads)
# is never replayed: "full" re-runs 5 of the block's 6 products.
RECOMPUTED = {
    "full": {"mm": 5, "flash_fwd": 1, "gelu": 1},
    "dots": {"mm": 0, "flash_fwd": 1, "gelu": 1},
    "dots_attn": {"mm": 0, "flash_fwd": 0, "gelu": 1},
    "dots_attn_gelu": {"mm": 0, "flash_fwd": 0, "gelu": 0},
    "attn": {"mm": 5, "flash_fwd": 0, "gelu": 1},
    "attn_block": {"mm": 1, "flash_fwd": 0, "gelu": 1},
}
OPS = {"mm": torch.ops.aten.mm.default, "flash_fwd": fa.FLASH_FWD,
       "gelu": torch.ops.aten.gelu.default}


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


def _model(block=None):
    model = models.TransformerLM(256, 64, 4, LAYERS, 64, kv_heads=2,
                                 param_dtype=torch.float32, block=block)
    gen = torch.Generator()
    gen.manual_seed(0)
    return model.init_weights(gen).requires_grad_(True)


def _loss_and_grads(model, tokens, seq_parallel=1, layout="contiguous"):
    """One backward of the port's loss; returns (loss, grads, op counts
    of the backward, merge_kv_block calls in the backward)."""
    mesh = transformer.make_lm_mesh(1, 0, seq_parallel)
    loss_fn = transformer.make_lm_loss(model, mesh, layout)
    loss, _ = loss_fn(tokens)
    merges = []
    real_merge = fa.merge_kv_block

    def counting_merge(*a, **k):
        merges.append(1)
        return real_merge(*a, **k)

    counter = _CountOps()
    fa.merge_kv_block = counting_merge
    try:
        with counter:
            loss.backward()
    finally:
        fa.merge_kv_block = real_merge
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return loss.detach(), grads, counter.counts, len(merges)


def _tokens():
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, 256, size=(2, 64)).astype(
        np.int32))


@pytest.fixture(scope="module")
def plain():
    return {sp: _loss_and_grads(_model(), _tokens(), sp, "striped"
                                if sp > 1 else "contiguous")
            for sp in (1, 4)}


@pytest.mark.parametrize("sp", [1, 4], ids=["one_shard", "ring4_striped"])
@pytest.mark.parametrize("mode", models.REMAT_POLICIES)
def test_remat_is_bit_equal_to_no_remat(plain, mode, sp):
    """The recompute repeats the same ops on the same values, so the loss
    and every gradient are bit-equal to no remat, on the flash path and
    on the ring."""
    loss0, grads0, _c, _m = plain[sp]
    loss, grads, _c, _m = _loss_and_grads(
        _model(models.remat_block(mode)), _tokens(), sp,
        "striped" if sp > 1 else "contiguous")
    assert torch.equal(loss, loss0)
    assert grads.keys() == grads0.keys()
    for name, g in grads.items():
        assert torch.equal(g, grads0[name]), name


@pytest.mark.parametrize("mode", models.REMAT_POLICIES)
def test_backward_recomputes_what_the_policy_does_not_save(plain, mode):
    """A dispatch mode over the backward counts each op; the ops the
    backward itself needs (the gradients' products, gelu_backward) are
    the same with and without remat, so the difference is the recompute:
    the RECOMPUTED table per layer."""
    _l, _g, counts0, _m = plain[1]
    _l, _g, counts, _m = _loss_and_grads(_model(models.remat_block(mode)),
                                         _tokens())
    got = {name: counts[op] - counts0[op] for name, op in OPS.items()}
    assert got == {k: v * LAYERS for k, v in RECOMPUTED[mode].items()}


@pytest.mark.parametrize("mode", ["full", "dots_attn", "attn"])
def test_ring_forward_reruns_under_every_policy(plain, mode):
    """The ring is an autograd.Function whose outputs no policy names (the
    reference's ring is a custom VJP with unnamed residuals), so under
    every policy the backward re-runs the whole forward ring: N^2 merges
    per layer, where no remat runs none."""
    _l, _g, _c, merges0 = plain[4]
    _l, _g, _c, merges = _loss_and_grads(_model(models.remat_block(mode)),
                                         _tokens(), 4, "striped")
    assert merges0 == 0
    assert merges == LAYERS * 4 * 4


def test_policies_save_what_the_reference_names():
    """Every reference policy has a counterpart; unknown names raise; full
    saves nothing (no selective policy at all)."""
    assert models.REMAT_POLICIES == jmodels.REMAT_POLICIES
    assert models.remat_policy("full") is None
    with pytest.raises(ValueError):
        models.remat_policy("bogus")
    args = transformer.parse_args(TINY + ["--remat", "--remat-policy",
                                          "attn"])
    assert compute.lm_block(args) is models.remat_block("attn")
    assert compute.lm_block(transformer.parse_args(TINY)) \
        is models.DecoderBlock


def test_checkpoint_names_nest_and_the_remat_block_keeps_the_params():
    """A name is a thread-local set on entry and restored on exit (no op,
    no copy), and the remat block holds the plain block's params under
    the same names, so checkpoints and weights carry across."""
    plain_model = _model()
    remat_model = _model(models.remat_block("attn_block"))
    assert [n for n, _ in plain_model.named_parameters()] == \
        [n for n, _ in remat_model.named_parameters()]
    with models.checkpoint_name("attn_q"):
        assert models.current_names() == frozenset({"attn_q"})
        with models.checkpoint_name("mlp_gelu"):
            assert models.current_names() == frozenset({"mlp_gelu"})
        assert models.current_names() == frozenset({"attn_q"})
    assert models.current_names() == frozenset()


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


@pytest.mark.parametrize("sp", [1, 4], ids=["one_shard", "ring4_striped"])
def test_remat_dots_attn_step_matches_jax(sp):
    """Three steps of the JAX transformer step and the port's with
    ``--remat --remat-policy dots_attn`` from the same f32 params on the
    same batches; with ``--seq-parallel 4 --sp-layout striped`` the JAX
    step runs on its (data 2, seq 4) CPU mesh and the port holds the
    whole ring in one process. Losses within 5e-3 per step, the bound of
    tests/test_torch_train.py::test_train_step_matches_jax, for its
    reasons (bf16 logits differ by up to 2^-5 between the frameworks)."""
    extra = ["--remat", "--remat-policy", "dots_attn"]
    if sp > 1:
        extra += ["--seq-parallel", str(sp), "--sp-layout", "striped"]
    args = jtransformer.parse_args(TINY + extra)
    mesh = (jtransformer.make_lm_mesh(8, seq_parallel=sp) if sp > 1
            else jtransformer.make_lm_mesh(num_devices=1))
    mesh, _model_j, state, jstep, jbatches = jtransformer.build(args,
                                                                 mesh=mesh)
    targs = transformer.parse_args(TINY + extra)
    model = weights.from_flax(_np_tree(state.params), heads=4,
                              param_dtype=torch.float32,
                              block=compute.lm_block(targs))
    model.requires_grad_(True)
    opt = optimizers.from_args(targs)
    tstep = transformer.make_lm_train_step(
        model, opt, opt.init(list(model.parameters())),
        grad_accum=targs.grad_accum,
        mesh=transformer.make_lm_mesh(1, 0, sp), sp_layout=targs.sp_layout)
    spec = jtransformer.lm_token_spec(mesh)
    jl, tl = [], []
    for _ in range(3):
        (jb,) = next(jbatches)
        state, m = jstep(state, *jdata.put_global_batch(mesh, jb, spec=spec))
        jl.append(float(jax.device_get(m["loss"])))
        tl.append(float(tstep(torch.from_numpy(jb))["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=5e-3)
    assert tl[-1] < tl[0]


def test_flash_ops_fake_shapes_and_no_count_off_the_card():
    """The two custom ops on meta tensors (their fake implementations) and
    under a FakeTensorMode give each output's exact shape and dtype (L is
    [B, H, T, 1] f32; dk/dv at K/V size), and neither they nor a CPU call
    (the plain versions) count a kernel launch. torch.library's own
    checks (schema, fake, autograd registration) pass on the CPU."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fa.reset_launch_counts()
    q = torch.empty(2, 8, 4, 128, device="meta", dtype=torch.bfloat16)
    k = torch.empty(2, 8, 2, 128, device="meta", dtype=torch.bfloat16)
    out, lse = torch.ops.tpu_operator_torch.flash_fwd(q, k, k, True)
    assert (out.shape, out.dtype) == (q.shape, torch.bfloat16)
    assert (lse.shape, lse.dtype) == ((2, 4, 8, 1), torch.float32)
    with FakeTensorMode():
        qf = torch.empty(2, 8, 4, 128, dtype=torch.bfloat16)
        kf = torch.empty(2, 8, 2, 128, dtype=torch.bfloat16)
        of, lf = torch.ops.tpu_operator_torch.flash_fwd(qf, kf, kf, True)
        grads = torch.ops.tpu_operator_torch.flash_bwd(qf, kf, kf, of, lf,
                                                       of, True)
        assert [g.shape for g in grads] == [qf.shape, kf.shape, kf.shape]
    rng = np.random.default_rng(1)
    qc, kc, vc = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  .requires_grad_(True)
                  for s in ((1, 16, 4, 8), (1, 16, 2, 8), (1, 16, 2, 8)))
    fa.flash_attention(qc, kc, vc, causal=True).sum().backward()
    assert fa.launch_counts() == dict.fromkeys(fa.LAUNCHES, 0)
    torch.library.opcheck(fa.flash_fwd_op, (qc.detach(), kc.detach(),
                                            vc.detach(), True))
