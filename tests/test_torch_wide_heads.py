"""Head dims above 128 (the kernels' wide path), on the CPU.

Above 128 every kernel runs at the next multiple of its column block
(``flash_attention.kernel_head_dim``, ``WIDE_BLOCKS``): a grid axis over
blocks of the output, 256 columns for K1, dq and K4, 128 for dkv and K3
(the backward pair pads to dq's 256);
every wide kernel computes each score tile once per thread-block cluster
of blocks, whose size (``flash_attention.wide_cluster_size``) is the
largest divisor of the block count up to 8; the backward kernels take
D = rowsum(dO O) given, since it spans every block. The kernels cannot
run here, so:

- the port's plain attention (its forward and its autograd through the
  plain backward) at head dims 192, 256, 384, 1024 and 1536 (dkv's
  clusters of 2, 2, 3, 8 and two of 6) is held to the JAX
  ``flash_attention`` (its Pallas kernels in interpret mode, 64 x 64
  blocks) at 2e-5 of the largest value, the bound of
  ``tests/test_torch_flash_attention.py``;
- the CUDA wrappers' own routing (``_flash_fwd_cuda``, ``_flash_bwd_cuda``,
  ``_flash_merge_cuda``, ``_flash_decode_cuda``) runs on CPU tensors with
  the launch swapped for the plain version and the device check for a
  no-op: each launch must see the padded head dim (a multiple of 128 for
  K3; of 256 for K1, the backward pair and K4), the
  true head dim's scale and, for the backward, D given; its result must
  be the plain version's at the true head dim within 1e-5 of the largest
  value (f32 arithmetic from bf16 inputs; only the summation order moves:
  a wrong scale moves O by O(10%), a dropped column block by O(1)), and
  a bf16 output also within one bf16 ulp, 2^-7 of its value; the routes
  run at head dims whose clusters hold 1 to 8 blocks, padded or not;
- K4's plain version is held to the JAX ``_merge_pallas`` in interpret
  mode at head dims 384 and 1024, into a live carry, at 2e-5, and K3's at
  one query row (MHA, Tq 1) to the JAX ``flash_decode`` the same way.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_operator.payload import flash_attention as jfa
from tpu_operator_torch.payload import flash_attention as tfa

WIDE_DIMS = (192, 256, 384, 1024, 1536)
JAX_TOL = 2e-5
ROUTE_TOL = 1e-5


def _inputs(seed, b, tq, h, kvh, d, tk=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    tk = tq if tk is None else tk
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(dtype))
                 for shape in ((b, tq, h, d), (b, tk, kvh, d),
                               (b, tk, kvh, d), (b, tq, h, d)))


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _close_bf16(got, want):
    """bf16 outputs: two roundings of f32 values that differ by summation
    order can land one bf16 ulp apart, up to 2^-7 of the value; on top of
    ROUTE_TOL."""
    got, want = got.float().numpy(), want.float().numpy()
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7,
                               atol=ROUTE_TOL * scale)


def _t(x):
    """[B,T,H,D] <-> [B,H,T,D]."""
    return x.permute(0, 2, 1, 3)


@pytest.mark.parametrize("d", WIDE_DIMS)
def test_plain_attention_matches_jax_at_wide_head_dim(monkeypatch, d):
    """O, L and the q / k / v gradients of sum(O * w), GQA group 2, T 128
    over 64 x 64 blocks, against the JAX flash_attention in interpret
    mode."""
    monkeypatch.setenv("TPU_OPERATOR_FWD_BLOCKS", "64,64")
    q, k, v, w = _inputs(500 + d, 1, 128, 4, 2, d)
    jq, jk, jv, jw = (jnp.asarray(x.numpy()) for x in (q, k, v, w))
    want = jfa.flash_attention(jq, jk, jv, causal=True, use_pallas=True)

    def jloss(a, b, c):
        return jnp.sum(jfa.flash_attention(a, b, c, causal=True,
                                           use_pallas=True) * jw)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (x.clone().requires_grad_(True) for x in (q, k, v))
    got, lse = tfa.flash_attention_with_lse(tq, tk, tv, causal=True)
    _close(got.detach(), want, JAX_TOL)
    qt, kt, vt = (jnp.einsum("bthd->bhtd", x) for x in (jq, jk, jv))
    _want_o, want_l = jfa._attn_impl(True, True, qt, kt, vt)
    _close(lse.detach(), want_l, JAX_TOL)
    (got * w).sum().backward()
    for x, jg in zip((tq, tk, tv), jgrads):
        _close(x.grad, jg, JAX_TOL)


@pytest.mark.parametrize("d,fwd,dq,bwd,merge,decode", [
    (129, 1, 1, 2, 1, 2), (256, 1, 1, 2, 1, 2), (300, 2, 2, 4, 2, 3),
    (384, 2, 2, 4, 2, 3), (640, 3, 3, 6, 3, 5), (1000, 4, 4, 8, 4, 8),
    (1024, 4, 4, 8, 4, 8), (1408, 6, 6, 6, 6, 1), (1536, 6, 6, 6, 6, 6),
    (2048, 8, 8, 8, 8, 8), (2304, 3, 3, 6, 3, 6), (2816, 1, 1, 2, 1, 2)])
def test_wide_cluster_size(d, fwd, dq, bwd, merge, decode):
    """The largest divisor, at most 8, of the column-block count: K1's,
    dq's and K4's blocks are 256 columns, dkv's 128 at the backward pair's
    head dim, which is padded to dq's 256, K3's 128 (a prime count above 8
    gets clusters of one)."""
    for name, size in (("flash_fwd", fwd), ("flash_bwd_dq", dq),
                       ("flash_bwd", bwd), ("flash_merge", merge),
                       ("flash_decode", decode)):
        padded = tfa.kernel_head_dim(tfa.CLUSTER_KERNELS[name], d)
        nb = padded // tfa.WIDE_BLOCKS[name]
        assert tfa.wide_cluster_size(name, d) == size
        assert padded % tfa.WIDE_BLOCKS[name] == 0
        assert nb % size == 0 and size <= 8


@pytest.mark.parametrize("name,d", [("flash_fwd", 128), ("flash_bwd", 64),
                                    ("flash_merge", 128),
                                    ("flash_decode", 128)])
def test_wide_cluster_size_refuses_what_runs_no_cluster(name, d):
    with pytest.raises(ValueError):
        tfa.wide_cluster_size(name, d)


@pytest.fixture
def plain_launches(monkeypatch):
    """The CUDA wrappers on CPU tensors: the device check a no-op, each
    launch the plain version in the launch's argument layout, recording
    (kernel, head dim it ran at, scale, D given)."""
    seen = []
    monkeypatch.setattr(tfa, "_check_kernel_inputs", lambda *a: None)

    def fwd(q, k, v, causal, *, scale):
        seen.append(("flash_fwd", q.shape[-1], scale, None))
        out, lse = tfa._attn_ref(_t(q), _t(k), _t(v), causal, scale)
        return _t(out).contiguous(), lse

    def bwd(q, k, v, g, out, L, D, offsets, causal, grad_dtype, *, scale):
        seen.append(("flash_bwd", q.shape[-1], scale, D is not None))
        if D is None:
            D = tfa.row_dot(g, out)
        grads = tfa._bwd_ref(_t(q), _t(k), _t(v), _t(g), L, D, offsets,
                             causal, scale)
        return tuple(_t(x).to(grad_dtype).contiguous() for x in grads)

    def merge(q, k, v, o, l, m, offsets, causal, *, scale):
        seen.append(("flash_merge", q.shape[-1], scale, None))
        return tfa._merge_ref(_t(q), _t(k), _t(v), o, l, m, offsets, causal,
                              scale)

    def decode(q, k, v, lengths, *, scale):
        seen.append(("flash_decode", q.shape[-1], scale, None))
        return tfa._decode_ref(q, k, v, lengths, scale)

    monkeypatch.setattr(tfa, "_fwd_launch", fwd)
    monkeypatch.setattr(tfa, "_bwd_launch", bwd)
    monkeypatch.setattr(tfa, "_merge_launch", merge)
    monkeypatch.setattr(tfa, "_decode_launch", decode)
    return seen


def _bf16(*xs):
    return tuple(x.bfloat16() for x in xs)


ROUTE_DIMS = (192, 256, 384, 1000, 1500)
# The head dim K1's wide kernel runs at: the next multiple of its 256-column
# block.
FWD_SIZES = {192: 256, 256: 256, 384: 512, 1000: 1024, 1500: 1536}
# The backward pair's: dq's 256-column block is the coarser of the two.
BWD_SIZES = {192: 256, 256: 256, 384: 512, 1000: 1024, 1500: 1536}


@pytest.mark.parametrize("d", ROUTE_DIMS)
def test_forward_route_pads_to_a_multiple_of_128(plain_launches, d):
    q, k, v, _g = _bf16(*_inputs(600 + d, 2, 24, 4, 2, d))
    out, lse = tfa._flash_fwd_cuda(q, k, v, True)
    assert plain_launches == [("flash_fwd", FWD_SIZES[d], d ** -0.5, None)]
    want, want_l = tfa._attn_ref(_t(q), _t(k), _t(v), True)
    assert out.shape == q.shape
    _close_bf16(out, _t(want))
    _close(lse, want_l, ROUTE_TOL)


@pytest.mark.parametrize("d", ROUTE_DIMS)
@pytest.mark.parametrize("fused", [True, False], ids=["fused_d", "given_d"])
def test_backward_route_takes_d_given(plain_launches, d, fused):
    """Fused D requested or not, the wide launch gets D = rowsum(dO O) of
    the true head dim, given; GQA group 2, offsets with a stride."""
    q, k, v, g = _bf16(*_inputs(700 + d, 2, 24, 4, 2, d, tk=40))
    out = torch.from_numpy(np.random.default_rng(d).normal(
        size=q.shape).astype(np.float32)).bfloat16()
    L = torch.from_numpy(np.random.default_rng(d + 1).normal(
        size=(2, 4, 24, 1)).astype(np.float32)) + 3.0
    D = tfa.row_dot(g, out)
    offsets = (16, 0, 2)
    got = tfa._flash_bwd_cuda(q, k, v, g, L, out if fused else None,
                              None if fused else D, offsets, True,
                              torch.float32)
    assert plain_launches == [("flash_bwd", BWD_SIZES[d], d ** -0.5, True)]
    want = tfa._bwd_ref(_t(q), _t(k), _t(v), _t(g), L, D, offsets, True)
    for a, b in zip(got, want):
        _close(a, _t(b), ROUTE_TOL)


@pytest.mark.parametrize("d", (192, 256, 384))
def test_merge_and_decode_routes(plain_launches, d):
    """K4 folding a block into a live carry, K3 over a cache with ragged
    lengths (0 included), both at the padded head dim: the next multiple
    of each one's column block (K4 at D 384 runs at 512)."""
    q, k, v, _g = _bf16(*_inputs(800 + d, 1, 32, 4, 2, d))
    carry = tfa._merge_ref(_t(q), _t(k), _t(v), *tfa.init_carry(1, 4, 32, d),
                           (32, 0, 1), True)
    got = tfa._flash_merge_cuda(q, k, v, carry, (32, 32, 1), True)
    want = tfa._merge_ref(_t(q), _t(k), _t(v), *carry, (32, 32, 1), True)
    for a, b in zip(got, want):
        _close(a, b, ROUTE_TOL)
    q, k, v, _g = _bf16(*_inputs(900 + d, 3, 2, 8, 2, d, tk=48))
    lengths = torch.tensor([0, 17, 48], dtype=torch.int32)
    out = tfa._flash_decode_cuda(q, k, v, lengths)
    _close_bf16(out, tfa._decode_ref(q, k, v, lengths))
    merge_size, decode_size = (-(-d // tfa.WIDE_BLOCKS[name])
                               * tfa.WIDE_BLOCKS[name]
                               for name in ("flash_merge", "flash_decode"))
    assert [x[:3] for x in plain_launches] == [
        ("flash_merge", merge_size, d ** -0.5),
        ("flash_decode", decode_size, d ** -0.5)]


@pytest.mark.parametrize("d,cluster", [(384, 3), (1024, 8)])
def test_decode_at_one_query_row_matches_jax_kernel(plain_launches, d,
                                                    cluster):
    """K3 wide at R = group x Tq = 1 (MHA, 4 / 4 heads, Tq 1), the shape
    the serve_wide phase decodes the tensor-parallel job's model at (D
    1024, a cluster of 8), and at D 384 (a cluster of 3). The port's
    decode on its CPU path against the JAX ``flash_decode`` with its
    Pallas kernel in interpret mode and against its ``_decode_ref`` at
    2e-5 of the largest value, ragged lengths (0, 1, inside a tile,
    full); then the CUDA wrapper's routing on bf16 inputs: one launch at
    D itself with the true scale, its result the plain version's."""
    b, s, h = 4, 96, 4
    q, k, v, _g = _inputs(1100 + d, b, 1, h, h, d, tk=s)
    lengths = torch.tensor([0, 1, 50, 96], dtype=torch.int32)
    jargs = [jnp.asarray(x.numpy()) for x in (q, k, v, lengths)]
    got = tfa.flash_decode(q, k, v, lengths)
    _close(got, jfa.flash_decode(*jargs, use_pallas=True), JAX_TOL)
    _close(got, jfa._decode_ref(*jargs), JAX_TOL)
    assert not bool(got[0].any())
    assert tfa.wide_cluster_size("flash_decode", d) == cluster
    qb, kb, vb = _bf16(q, k, v)
    out = tfa._flash_decode_cuda(qb, kb, vb, lengths)
    assert plain_launches == [("flash_decode", d, d ** -0.5, None)]
    _close_bf16(out, tfa._decode_ref(qb, kb, vb, lengths))


@pytest.mark.parametrize("d", (384, 1024))
def test_plain_merge_matches_jax_kernel_at_wide_head_dim(d):
    """The port's ``_merge_ref`` (K4's plain version, its CPU path and its
    yardstick on the card) against the JAX ``_merge_pallas`` in interpret
    mode, folding a striped block at (1, 0, 4) into a live carry from a
    merge at (1, 2, 4) (whose row 0 has seen no key), GQA group 2, f32
    inputs, at 2e-5 of the largest value. As in
    ``tests/test_torch_flash_merge.py`` the Pallas kernel skips tiles wholly
    in a row's future, so o and l are compared on the rows that have seen
    a key, and those rows must be the same."""
    rng = np.random.default_rng(1000 + d)
    b, t, h, kvh = 1, 64, 4, 2

    def block(heads):
        return torch.from_numpy(rng.normal(size=(b, heads, t, d))
                                .astype(np.float32))

    q, k0, v0, k1, v1 = (block(x) for x in (h, kvh, kvh, kvh, kvh))
    carry = tfa._merge_ref(q, k0, v0, *tfa.init_carry(b, h, t, d),
                           (1, 2, 4), True)
    assert not bool((carry[2] > tfa.NEG_INF / 2).all())
    got = tfa._merge_ref(q, k1, v1, *carry, (1, 0, 4), True)
    jq, jk, jv, *jcarry = (jnp.asarray(x.numpy())
                           for x in (q, k1, v1, *carry))
    want = jfa._merge_pallas(jq, jk, jv, *jcarry,
                             jfa._normalize_offsets(
                                 jnp.asarray((1, 0, 4), jnp.int32)),
                             True, interpret=True)
    seen = np.asarray(want[2]) > jfa.NEG_INF / 2
    np.testing.assert_array_equal(got[2].numpy() > tfa.NEG_INF / 2, seen)
    for mine, theirs in zip(got, want):
        _close(np.where(seen, mine.numpy(), 0.0),
               np.where(seen, np.asarray(theirs), 0.0), JAX_TOL)
