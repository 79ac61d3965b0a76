"""Parity of the port's flash backward (tpu_operator_torch.payload.
flash_attention: ``attention_block_grads``, ``FlashAttention``) with the
JAX package's, on the CPU.

The port's CPU path is the plain PyTorch version of the backward kernels
(``_bwd_ref``); the JAX side runs ``_bwd_pallas`` in interpret mode
(``use_pallas=True``), as tests/test_flash_attention.py does. The same
numpy inputs (from a seed) feed both. Inputs are f32, so the kernels'
bf16 roundings of P and dS are no-ops and both sides compute the same
f32 math in a different summation order: tolerance 2e-4, the one
tests/test_flash_attention.py holds the Pallas backward to against its
own reference (gradients reach ~10 in magnitude at T 256, so this is a
few f32 ulps of a sum over 256 terms, well above order noise and far
below any masking or offset error, which moves a gradient by O(1)).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_operator.payload import flash_attention as jfa
from tpu_operator_torch.payload import flash_attention as tfa

TOL = 2e-4


def _inputs(seed, b, t, h, kvh, d=64, tk=None):
    """q/dO [B,T,H,D], k/v [B,Tk,KVH,D] f32 from a seed."""
    rng = np.random.default_rng(seed)
    tk = t if tk is None else tk
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    k = rng.normal(size=(b, tk, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, tk, kvh, d)).astype(np.float32)
    g = rng.normal(size=(b, t, h, d)).astype(np.float32)
    return q, k, v, g


def _forward_stats(q, k, v, offsets, causal):
    """(out, L) of one block on the JAX side, from its plain merge, in
    [B,H,T,D] / [B,H,T,1]: the global row statistics a backward takes."""
    qt, kt, vt = (jnp.einsum("bthd->bhtd", x) for x in (q, k, v))
    b, h, t, d = qt.shape
    carry = jfa.init_carry(b, h, t, d)
    offs = jnp.asarray(offsets, jnp.int32)
    o, l, m = jfa._merge_ref(qt, kt, vt, *carry, jfa._normalize_offsets(offs),
                             causal)
    return jfa.finalize((o, l, m), jnp.float32), jfa._logsumexp_rows(l, m)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


OFFSETS = {
    "aligned": (0, 0, 1),
    "queries_after_keys": (128, 0, 1),
    "keys_after_queries": (0, 128, 1),
    "striped": (1, 0, 2),
}


# Offsets matter only under the causal mask; the non-causal case runs once.
CASES = [(c, o) for c in (True,) for o in OFFSETS] + [(False, "aligned")]


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("causal,offsets", CASES,
                         ids=[f"{'causal' if c else 'full'}-{o}"
                              for c, o in CASES])
def test_block_grads_match_jax_bwd_pallas(group, causal, offsets):
    """The port's attention_block_grads (fused D, f32 grads) against the
    JAX one with its Pallas backward in interpret mode, [B,T,H,D] in the
    port and [B,H,T,D] in the reference. At T 256 with a 128 offset, half
    the rows see part of the other block, in either direction."""
    offs = OFFSETS[offsets]
    kvh = 2
    q, k, v, g = _inputs(group, 1, 256, kvh * group, kvh)
    out, L = _forward_stats(q, k, v, offs, causal)
    gt = jnp.einsum("bthd->bhtd", g)
    want = jfa.attention_block_grads(
        *(jnp.einsum("bthd->bhtd", x) for x in (q, k, v)), gt, L, out,
        jnp.asarray(offs, jnp.int32), causal=causal, use_pallas=True)
    got = tfa.attention_block_grads(
        *(torch.from_numpy(x) for x in (q, k, v, g)),
        torch.from_numpy(np.array(L)),
        torch.from_numpy(np.array(jnp.einsum("bhtd->bthd", out))),
        offs, causal=causal)
    for name, gg, ww in zip(("dq", "dk", "dv"), got, want):
        assert gg.dtype == torch.float32, name
        _close(gg.numpy(), jnp.einsum("bhtd->bthd", ww))


@pytest.mark.parametrize("grad_dtype", ["f32", "bf16"])
def test_precomputed_d_and_grad_dtype_match_jax(grad_dtype):
    """A given D (the ring's path) and both gradient dtypes, at T 256,
    group 4, the striped causal layout. bf16 grads are compared after both
    sides round their f32 sums once: one bf16 ulp (at most 2^-7 of the
    value) apart at most."""
    offs = (0, 1, 2)
    q, k, v, g = _inputs(11, 1, 256, 8, 2)
    out, L = _forward_stats(q, k, v, offs, True)
    gt = jnp.einsum("bthd->bhtd", g)
    D = jnp.sum(gt * out, axis=-1, keepdims=True)
    jdtype = jnp.float32 if grad_dtype == "f32" else jnp.bfloat16
    tdtype = torch.float32 if grad_dtype == "f32" else torch.bfloat16
    want = jfa.attention_block_grads(
        *(jnp.einsum("bthd->bhtd", x) for x in (q, k, v)), gt, L, out,
        jnp.asarray(offs, jnp.int32), causal=True, use_pallas=True,
        grad_dtype=jdtype, D=D)
    got = tfa.attention_block_grads(
        *(torch.from_numpy(x) for x in (q, k, v, g)),
        torch.from_numpy(np.array(L)), None, offs, causal=True,
        grad_dtype=tdtype, D=torch.from_numpy(np.array(D)))
    for name, gg, ww in zip(("dq", "dk", "dv"), got, want):
        assert gg.dtype == tdtype, name
        ww = np.asarray(jnp.einsum("bhtd->bthd", ww).astype(jnp.float32))
        if grad_dtype == "f32":
            _close(gg.numpy(), ww)
        else:
            np.testing.assert_allclose(gg.float().numpy(), ww,
                                       rtol=2.0 ** -7, atol=TOL)


def test_rows_that_see_no_key_get_no_gradient():
    """Every query before every key (causal): L = 0, O = 0, and all three
    gradients are exactly 0 (P = exp(NEG_INF - 0) = 0, not NaN)."""
    q, k, v, g = _inputs(3, 1, 128, 4, 2)
    L = torch.zeros(1, 4, 128, 1)
    out = torch.zeros(q.shape)
    grads = tfa.attention_block_grads(
        *(torch.from_numpy(x) for x in (q, k, v, g)), L, out, (0, 10_000),
        causal=True)
    for grad in grads:
        assert torch.equal(grad, torch.zeros_like(grad))


def test_offsets_are_validated():
    with pytest.raises(ValueError):
        tfa._normalize_offsets((0, 0, 0))
    with pytest.raises(ValueError):
        tfa._normalize_offsets((0,))
    assert tfa._normalize_offsets((3, 4)) == (3, 4, 1)


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_grads_match_jax_grad(group, causal):
    """Gradients of the port's flash_attention (FlashAttention's plain
    backward on the CPU) against jax.grad of the JAX flash_attention with
    its Pallas kernels in interpret mode, and against torch autograd
    through the port's reference_attention, for a random cotangent."""
    kvh = 2
    q, k, v, g = _inputs(20 + group, 2, 128, kvh * group, kvh)

    def jloss(q_, k_, v_):
        o = jfa.flash_attention(q_, k_, v_, causal=causal, use_pallas=True)
        return jnp.sum(o * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    def grads_of(fn):
        ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        out = fn(*ts)
        out.backward(torch.from_numpy(g))
        return [t.grad for t in ts]

    got = grads_of(lambda *ts: tfa.flash_attention(*ts, causal=causal))
    plain = grads_of(lambda *ts: tfa.reference_attention(*ts,
                                                         causal=causal))
    for name, gg, ww, pp in zip(("dq", "dk", "dv"), got, want, plain):
        assert gg.shape == pp.shape, name
        _close(gg.numpy(), ww)
        _close(gg.numpy(), pp.numpy())


def test_flash_attention_backward_takes_a_non_contiguous_cotangent():
    """The cotangent may arrive as a strided view (here from a transpose
    downstream); the backward makes it contiguous and keeps [B,T,H,D]."""
    q, k, v, _g = _inputs(5, 1, 64, 4, 2)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = tfa.flash_attention(*ts, causal=True)
    out.transpose(1, 2).sum().backward()
    ref = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    tfa.reference_attention(*ref, causal=True).sum().backward()
    for t, r in zip(ts, ref):
        _close(t.grad.numpy(), r.grad.numpy())


def _kernel_args(**over):
    """Arguments the backward kernels take (bf16, head dim 128, group 4,
    contiguous) except for ``over``; on the CPU, so the wrapper must
    refuse them before any launch whatever else is right."""
    b, t, h, kvh, d = 1, 64, 8, 2, 128
    args = {"q": torch.zeros(b, t, h, d, dtype=torch.bfloat16),
            "k": torch.zeros(b, t, kvh, d, dtype=torch.bfloat16),
            "v": torch.zeros(b, t, kvh, d, dtype=torch.bfloat16),
            "g": torch.zeros(b, t, h, d, dtype=torch.bfloat16),
            "L": torch.zeros(b, h, t, 1), "out": None,
            "D": torch.zeros(b, h, t, 1), "offsets": (0, 0, 1),
            "causal": True, "grad_dtype": torch.bfloat16}
    args.update(over)
    return args


@pytest.mark.parametrize("over,why", [
    ({}, "not CUDA"),  # right in every way but the device
    ({"q": torch.zeros(1, 64, 8, 128)}, "bfloat16"),
    ({"L": torch.zeros(1, 8, 64)}, "L must be"),
    ({"D": torch.zeros(1, 8, 64, 1, dtype=torch.bfloat16)}, "D must be"),
    ({"grad_dtype": torch.float16}, "grad_dtype"),
    ({"k": torch.zeros(1, 64, 3, 128, dtype=torch.bfloat16),
      "v": torch.zeros(1, 64, 3, 128, dtype=torch.bfloat16)}, "multiple"),
    ({"q": torch.zeros(1, 64, 48, 128, dtype=torch.bfloat16),
      "g": torch.zeros(1, 64, 48, 128, dtype=torch.bfloat16),
      "L": torch.zeros(1, 48, 64, 1), "D": torch.zeros(1, 48, 64, 1)},
     "divide 64"),  # group 24
], ids=["cpu", "f32", "L_shape", "D_dtype", "fp16_grads", "kv_heads",
        "group_24"])
def test_backward_kernel_wrapper_refuses_what_the_kernel_cannot_take(over,
                                                                    why):
    tfa.reset_launch_counts()
    with pytest.raises(ValueError, match=why):
        tfa._flash_bwd_cuda(**_kernel_args(**over))
    assert tfa.launch_counts()["flash_bwd_dq"] == 0
