"""Multi-slice layouts of the port's meshes, against the reference's.

A multi-slice job (``MEGASCALE_NUM_SLICES`` in the operator's env
contract) must keep each inner group (the processes of one model, seq,
pipe or expert group, whose collectives run per op) inside one slice;
only the data axis spans slices, and a world that does not divide into
the slices is refused. The reference holds the rule in
``train._mesh_device_layout`` (``tests/test_hybrid_mesh.py``); each of the
port's four mesh builders (``transformer.make_lm_mesh``,
``moe.make_moe_mesh``, ``pipeline.make_pipe_mesh``,
``cifar.make_cifar_mesh``) must accept and refuse exactly the layouts the
reference's builder for the same payload does on the same numbers (a
world of W processes against W devices, one shard a process), and each
payload's ``run`` must hand the builder ``info.num_slices``.
"""

import jax
import pytest

from tpu_operator.payload import moe as jmoe
from tpu_operator.payload import pipeline as jpipeline
from tpu_operator.payload import train as jtrain
from tpu_operator.payload import transformer as jtransformer
from tpu_operator_torch.payload import bootstrap
from tpu_operator_torch.payload import cifar
from tpu_operator_torch.payload import moe
from tpu_operator_torch.payload import pipeline
from tpu_operator_torch.payload import transformer

# builder -> (the port's mesh of (world, rank, outer, inner, num_slices),
# the reference's of (devices, outer, inner, num_slices)); "outer" is the
# seq / expert / pipe degree and "inner" the model degree (the cifar mesh
# has the model axis only: its outer is always 1).
BUILDERS = {
    "lm": (lambda w, r, a, b, s: transformer.make_lm_mesh(
               w, r, seq_parallel=a, tensor_parallel=b, num_slices=s),
           lambda d, a, b, s: jtransformer.make_lm_mesh(
               len(d), seq_parallel=a, devices=d, num_slices=s,
               tensor_parallel=b)),
    "moe": (lambda w, r, a, b, s: moe.make_moe_mesh(
                w, r, expert_parallel=a, tensor_parallel=b, num_slices=s),
            lambda d, a, b, s: jmoe.make_moe_mesh(
                len(d), expert_parallel=a, devices=d, num_slices=s,
                tensor_parallel=b)),
    "pipe": (lambda w, r, a, b, s: pipeline.make_pipe_mesh(
                 w, r, pipeline=a, tensor_parallel=b, num_slices=s),
             lambda d, a, b, s: jpipeline.make_pipe_mesh(
                 len(d), pipeline=a, devices=d, num_slices=s,
                 tensor_parallel=b)),
    "cifar": (lambda w, r, a, b, s: cifar.make_cifar_mesh(
                  w, r, model_parallel=b, num_slices=s),
              lambda d, a, b, s: jtrain.make_mesh(
                  len(d), model_parallel=b, devices=d, num_slices=s)),
}

# (world, outer, inner, num_slices) from tests/test_hybrid_mesh.py (the
# inner group of 2 in two slices of 4 is accepted; 8 across two slices
# of 4, and 6 processes in 4 slices, are refused), each inner group as
# the model axis and, for the 3-axis builders, as the outer axis and as
# both (2 x 2 in a slice of 4, accepted; 4 x 2, refused).
CASES = [(8, 1, 2, 2), (8, 1, 8, 2), (6, 1, 1, 4), (8, 2, 1, 2),
         (8, 8, 1, 2), (8, 2, 2, 2), (8, 4, 2, 2)]


def _cases():
    for name in BUILDERS:
        for world, outer, inner, slices in CASES:
            if name == "cifar" and outer > 1:
                continue
            yield pytest.param(name, world, outer, inner, slices,
                               id=f"{name}-w{world}-{outer}x{inner}"
                                  f"-s{slices}")


def _reference_accepts(name, world, outer, inner, slices) -> bool:
    try:
        BUILDERS[name][1](jax.devices()[:world], outer, inner, slices)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("name,world,outer,inner,slices", _cases())
def test_builder_accepts_what_the_reference_accepts(name, world, outer,
                                                    inner, slices):
    """The port's builder raises ValueError exactly where the reference's
    does; an accepted layout puts each inner group (the ranks of one data
    rank) inside one slice, and each inner position's data ranks across
    every slice."""
    port = BUILDERS[name][0]
    want = _reference_accepts(name, world, outer, inner, slices)
    if not want:
        with pytest.raises(ValueError):
            port(world, 0, outer, inner, slices)
        return
    meshes = [port(world, r, outer, inner, slices) for r in range(world)]
    per_slice = world // slices
    slice_of = [r // per_slice for r in range(world)]
    groups = {}
    for r, mesh in enumerate(meshes):
        groups.setdefault(mesh.data_rank, []).append(r)
    assert len(groups) == meshes[0].data == world // (outer * inner)
    for ranks in groups.values():
        assert len({slice_of[r] for r in ranks}) == 1, ranks
    size = outer * inner
    for position in range(size):
        column = [r for r in range(world) if r % size == position]
        assert {slice_of[r] for r in column} == set(range(slices))


@pytest.mark.parametrize("name,world,outer,inner,slices", _cases())
def test_the_guard_only_refuses(name, world, outer, inner, slices):
    """One slice accepts every layout the builder lays out (the reference
    accepts each of these on one slice too), and a multi-slice layout
    that is accepted is the one-slice layout, rank for rank: the guard
    never moves a rank."""
    port = BUILDERS[name][0]
    assert _reference_accepts(name, world, outer, inner, 1)
    for r in range(world):
        one = port(world, r, outer, inner, 1)
        try:
            many = port(world, r, outer, inner, slices)
        except ValueError:
            continue
        assert many == one


def _info(slices: int) -> bootstrap.ProcessInfo:
    return bootstrap.ProcessInfo(coordinator_address="", process_id=0,
                                 num_processes=1, worker_id=0,
                                 worker_hostnames=(), num_slices=slices)


RUNS = {
    "transformer": (transformer, ["--steps", "1", "--batch", "2",
                                  "--seq-len", "16", "--dim", "16",
                                  "--heads", "2", "--layers", "1",
                                  "--vocab", "32"]),
    "moe": (moe, ["--steps", "1", "--batch", "2", "--seq-len", "16",
                  "--dim", "16", "--heads", "2", "--layers", "2",
                  "--experts", "2", "--vocab", "32"]),
    "pipeline": (pipeline, ["--steps", "1", "--batch", "4", "--seq-len",
                            "16", "--dim", "16", "--heads", "2", "--layers",
                            "2", "--microbatches", "2", "--vocab", "32"]),
    "cifar": (cifar, ["--steps", "1", "--batch", "4", "--blocks", "1",
                      "--widths", "4", "4", "4"]),
}


@pytest.mark.parametrize("payload", list(RUNS))
def test_run_passes_the_slice_count(payload):
    """``run(info)`` builds its mesh with ``info.num_slices``: one process
    cannot split into two slices, so a two-slice ``info`` is refused
    before the first step, as the reference's ``run`` refuses it."""
    mod, argv = RUNS[payload]
    args = mod.parse_args(argv + ["--device", "cpu", "--log-every", "0",
                                  "--checkpoint-dir", "", "--profile-dir",
                                  ""])
    with pytest.raises(ValueError, match="num_slices=2"):
        mod.run(_info(2), args)
