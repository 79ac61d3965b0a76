"""The port's ``--fsdp`` rule and step against the JAX package's, on the
CPU (tests/test_torch_fsdp_multiprocess.py runs it across processes).

- ``train.fsdp_dims`` names the flax leaves that the reference's
  ``train.fsdp_shardings`` shards on the conftest's 8-device mesh, at
  data 2 and 8, at tests/test_fsdp.py's widths and at a GQA width whose
  odd vocab and 1-D leaves reach every branch of the rule;
- under ``--optimizer adam8`` every part is a whole number of adam8's
  blocks;
- the gather runs outside every named region, where no ``--remat-policy``
  saves its ops, so a rematerialized block gathers again;
- three steps of the port's ``--fsdp`` step (one process: data 1, the
  same hooks and gathers) against the JAX ``transformer.build(--fsdp)``
  on the 8-device mesh (data 8), from one tree carried across with
  ``weights.from_flax``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from tpu_operator.payload import data as jdata
from tpu_operator.payload import train as jtrain
from tpu_operator.payload import transformer as jtransformer
from tpu_operator_torch.payload import collectives
from tpu_operator_torch.payload import data
from tpu_operator_torch.payload import models
from tpu_operator_torch.payload import optimizers
from tpu_operator_torch.payload import train
from tpu_operator_torch.payload import transformer
from tpu_operator_torch.payload import weights

# tests/test_fsdp.py's widths, and a GQA / split-qkv one: vocab 260 does
# not divide by 8 (the token table stays whole at data 8, lm_head is cut
# along its columns there), mlp_up's bias has 1024 elements (a 1-D leaf
# that shards), the LayerNorms 256 (whole).
WIDTHS = {
    "test_fsdp": ["--batch", "8", "--seq-len", "64", "--dim", "64",
                  "--heads", "2", "--layers", "2"],
    "gqa_split": ["--batch", "8", "--seq-len", "72", "--dim", "256",
                  "--heads", "8", "--kv-heads", "2", "--layers", "1",
                  "--vocab", "260", "--split-qkv", "on"],
}
# The conftest mesh's data axis at 2 and 8 (seq takes the rest).
SEQ_FOR_DATA = {2: 4, 8: 1}


@functools.lru_cache(maxsize=None)
def _reference_state(width: str):
    """The reference's --fsdp state at ``width`` on the 8-device mesh."""
    args = jtransformer.parse_args(WIDTHS[width] + ["--fsdp"])
    mesh = jtransformer.make_lm_mesh(8, seq_parallel=1)
    return jtransformer.build(args, mesh=mesh)[2]


def _reference_sharded(width: str, data: int):
    """The flax paths whose leaves the reference's ``fsdp_shardings``
    shards over ``data`` on the 8-device mesh (data x seq = 8), and every
    path of the tree."""
    mesh = jtransformer.make_lm_mesh(8, seq_parallel=SEQ_FOR_DATA[data])
    assert mesh.shape["data"] == data
    state = _reference_state(width)
    specs = jtrain.fsdp_shardings(mesh, state).params
    sharded, every = set(), set()
    for path, sharding in jax.tree_util.tree_flatten_with_path(specs)[0]:
        keys = tuple(k.key for k in path)
        every.add(keys)
        if sharding.spec and sharding.spec[0] == "data":
            sharded.add(keys)
    return sharded, every


def _port_model(argv, optimizer="adam"):
    args = transformer.parse_args(argv + ["--device", "cpu", "--optimizer",
                                          optimizer])
    return transformer.build_model(args, "cpu")


@pytest.mark.parametrize("data", [2, 8])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_fsdp_dims_name_the_references_sharded_leaves(width, data):
    """The set of flax leaves the port shards equals the reference's,
    leaf for leaf, and the port's name map covers the whole tree; each
    cut divides its dim. Some leaf stays whole at each width (the
    LayerNorms), and at the GQA width the 1-D bias shards and lm_head is
    cut along columns at data 8."""
    want, every = _reference_sharded(width, data)
    model = _port_model(WIDTHS[width])
    paths = weights.lm_leaf_paths(model)
    assert {p for p, _t in paths.values()} == every
    dims = train.fsdp_dims(model, data)
    assert {paths[n][0] for n in dims} == want
    assert want != every
    for name, dim in dims.items():
        assert model.get_parameter(name).shape[dim] % data == 0, name
    if width == "gqa_split":
        assert dims["blocks.0.mlp_up.bias"] == 0
        assert dims["lm_head.weight"] == (1 if data == 8 else 0)
        assert ("tok_embed.weight" in dims) == (data == 2)


@pytest.mark.parametrize("data", [2, 8])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_adam8_dims_keep_every_block_whole(width, data):
    """Under adam8 each leaf's parts, blocked as adam8 blocks them (along
    the last dim, padded to 256), joined along the cut are the whole
    leaf's blocks: no block straddles two processes. The leaves that
    adam8 leaves whole are exactly those adam cuts along the last dim
    into parts that are not whole blocks."""
    model = _port_model(WIDTHS[width], "adam8")
    adam = train.fsdp_dims(model, data)
    dims = train.fsdp_dims(model, data, "adam8")
    gen = torch.Generator().manual_seed(0)
    for name, dim in dims.items():
        assert adam[name] == dim
        whole = torch.randn(model.get_parameter(name).shape, generator=gen)
        parts = [optimizers._to_blocks(c) for c in whole.chunk(data, dim)]
        torch.testing.assert_close(torch.cat(parts, dim),
                                   optimizers._to_blocks(whole), rtol=0,
                                   atol=0)
    for name in adam.keys() - dims.keys():
        shape = model.get_parameter(name).shape
        assert adam[name] == len(shape) - 1, name
        assert shape[-1] // data % optimizers.BLOCK, name


@pytest.mark.parametrize("mode", models.REMAT_POLICIES)
def test_no_remat_policy_saves_the_gather(mode, monkeypatch):
    """Inside a named region (the q / k / v projections, which attn_block
    saves by name) a sharded weight is gathered with no name current, and
    every policy recomputes the gather's ops there (the collective, the
    join): the recompute gathers again and no whole weight waits in the
    policy's cache for the backward."""
    seen = []
    gather = collectives.FSDPShard.gather

    def spy(spec, shard):
        seen.append(models.current_names())
        return gather(spec, shard)

    monkeypatch.setattr(collectives.FSDPShard, "gather", spy)
    p = torch.nn.Parameter(torch.randn(8, 4))
    p.fsdp = collectives.FSDPShard(0)
    with models.checkpoint_name("attn_q", "attn_k", "attn_v"):
        whole = models.gathered(p, torch.bfloat16)
        assert models.current_names() == {"attn_q", "attn_k", "attn_v"}
    assert seen == [frozenset()] and whole.dtype == torch.bfloat16
    policy = models.remat_policy(mode)
    if policy is not None:
        for op in (torch.ops.c10d.allgather_.default,
                   torch.ops.aten.cat.default,
                   torch.ops.aten.empty_like.default):
            assert policy(None, op) \
                == torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def test_fsdp_step_matches_the_references_fsdp_step():
    """Three steps of the JAX --fsdp step on the 8-device mesh (data 8:
    each leaf gathered by GSPMD) and of the port's --fsdp step in one
    process (data 1), from the same f32 params on the same batches, with
    tests/test_torch_train.py's bound: 5e-3 absolute on each loss (bf16
    logits that differ by up to 2^-5, averaged; a wrong gradient moves a
    step's loss by 0.1-0.2)."""
    argv = ["--batch", "8", "--seq-len", "64", "--dim", "64", "--heads",
            "4", "--kv-heads", "2", "--layers", "2", "--vocab", "256",
            "--grad-accum", "2", "--seed", "0", "--log-every", "0",
            "--checkpoint-dir", "", "--profile-dir", ""]
    mesh = jtransformer.make_lm_mesh(8, seq_parallel=1)
    jargs = jtransformer.parse_args(argv + ["--fsdp"])
    mesh, _model, state, jstep, jbatches = jtransformer.build(jargs,
                                                             mesh=mesh)
    params0 = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                     state.params)
    args = transformer.parse_args(argv + ["--fsdp", "--device", "cpu"])
    model = weights.from_flax(params0, heads=4, param_dtype=torch.float32)
    model.requires_grad_(True)
    lm_mesh = transformer.make_lm_mesh(1, 0)
    dims = transformer.shard_fsdp(model, lm_mesh)
    assert dims and model.fsdp
    optimizer = optimizers.from_args(args)
    opt_state = optimizer.init(list(model.parameters()))
    step = transformer.make_lm_train_step(model, optimizer, opt_state,
                                          grad_accum=2, mesh=lm_mesh)
    tbatches = data.lm_batches(args)
    spec = jtransformer.lm_token_spec(mesh)
    jlosses, tlosses = [], []
    for _ in range(3):
        (jb,), (tb,) = next(jbatches), next(tbatches)
        assert jb.tobytes() == tb.tobytes()
        state, metrics = jstep(state, *jdata.put_global_batch(
            mesh, jb, spec=spec))
        jlosses.append(float(jax.device_get(metrics["loss"])))
        tlosses.append(float(step(torch.from_numpy(tb))["loss"]))
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=5e-3)
    assert tlosses[-1] < tlosses[0]
