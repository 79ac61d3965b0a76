"""The port's sequence-chunked lm_head + loss (train.chunked_next_token_nll,
``--loss-chunk``) against its dense loss and against the JAX package's
chunked loss, on the CPU, and the flag's errors. Inputs come from numpy
with a seed; each comparison states its tolerance."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from tpu_operator.payload import train as jtrain
from tpu_operator_torch.payload import train
from tpu_operator_torch.payload import transformer


def _case(b=2, t=64, d=32, v=96, seed=0):
    """bf16 hidden [B, T, d], an f32 head weight in the port's layout
    [vocab, d] (the reference's kernel is its transpose), tokens."""
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((b, t, d)).astype(np.float32)
    w = (rng.standard_normal((v, d)) * 0.1).astype(np.float32)
    tokens = rng.integers(0, v, size=(b, t)).astype(np.int32)
    return hidden, w, tokens


def _torch(hidden, w, tokens):
    h = torch.from_numpy(hidden).bfloat16().requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    return h, wt, torch.from_numpy(tokens)


def _dense(h, w, tokens):
    return train.next_token_nll(F.linear(h, w.to(h.dtype)), tokens)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_chunked_loss_and_grads_match_dense(chunk):
    """The same bf16 head product and the same f32 logsumexp per position,
    summed per chunk: the loss equals the dense loss to 1e-5 relative (f32
    summation order). The head-weight gradient sums one f32 gradient per
    chunk, the dense one a single bf16 product, so they agree to bf16
    rounding: 2^-7 of the largest element; the hidden gradient is one
    bf16 product per chunk either way: held the same."""
    hidden, w, tokens = _case()
    h1, w1, t = _torch(hidden, w, tokens)
    dense = _dense(h1, w1, t)
    dense.backward()
    h2, w2, _t = _torch(hidden, w, tokens)
    chunked = train.chunked_next_token_nll(h2, w2, t, chunk)
    chunked.backward()
    assert float(chunked.detach()) == pytest.approx(float(dense.detach()),
                                                rel=1e-5)
    for got, want in ((h2.grad, h1.grad), (w2.grad, w1.grad)):
        assert got.dtype == want.dtype
        gap = (got.float() - want.float()).abs().max()
        assert float(gap) <= 2 ** -7 * float(want.float().abs().max())


def test_chunked_loss_matches_jax():
    """Loss and both gradients against the reference's
    chunked_next_token_nll (chunk 16) on the same inputs: the loss to
    1e-5 relative; the gradients to the reference's own chunked-vs-dense
    bound (rtol 2e-2, atol 3e-4)."""
    hidden, w, tokens = _case(seed=1)
    jh = jnp.asarray(hidden, jnp.bfloat16)
    jw = jnp.asarray(w.T)
    jt = jnp.asarray(tokens)
    want = jtrain.chunked_next_token_nll(jh, jw, jt, 16)
    gh, gw = jax.grad(jtrain.chunked_next_token_nll, argnums=(0, 1))(
        jh, jw, jt, 16)
    h, wt, t = _torch(hidden, w, tokens)
    got = train.chunked_next_token_nll(h, wt, t, 16)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(h.grad.float().numpy(),
                               np.asarray(gh, np.float32), rtol=2e-2,
                               atol=3e-4)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw).T,
                               rtol=2e-2, atol=3e-4)


def test_chunked_masked_matches_dense_masked():
    hidden, w, tokens = _case()
    b, t = tokens.shape
    rng = np.random.default_rng(7)
    targets = torch.from_numpy(rng.integers(0, w.shape[0], (b, t)))
    mask = torch.from_numpy(rng.integers(0, 2, (b, t)).astype(bool))
    h, wt, _t = _torch(hidden, w, tokens)
    dense = train.next_token_nll_masked(F.linear(h, wt.to(h.dtype)),
                                        targets, mask)
    chunked = train.chunked_next_token_nll_masked(h, wt, targets, mask, 16)
    assert float(chunked.detach()) == pytest.approx(float(dense.detach()),
                                                rel=1e-5)


def test_chunk_must_divide_t():
    h, w, t = _torch(*_case(t=64))
    with pytest.raises(ValueError, match="divide"):
        train.chunked_next_token_nll(h, w, t, 24)
    with pytest.raises(ValueError, match="positive"):
        train.chunked_next_token_nll(h, w, t, 0)


def _lm_args(extra):
    return transformer.parse_args(
        ["--dim", "64", "--layers", "2", "--heads", "2", "--batch", "8",
         "--seq-len", "128", "--vocab", "256", "--steps", "1",
         "--log-every", "0", "--device", "cpu", "--checkpoint-dir", "",
         "--profile-dir", ""] + extra)


def test_transformer_step_with_loss_chunk_matches_unchunked():
    """Same seed, same batch: the --loss-chunk step's loss equals the
    unchunked step's to 1e-4 relative (the reference's bound,
    tests/test_loss_chunk.py:81), and the params after the update agree
    to adam's +-lr envelope (a near-zero gradient element whose sign the
    chunked head gradient flips moves by 2 lr)."""
    losses, params = {}, {}
    for extra in ([], ["--loss-chunk", "32"]):
        built = transformer.build(_lm_args(extra))
        (tokens,) = next(built.batches)
        losses[bool(extra)] = float(built.step(torch.from_numpy(tokens))
                                    ["loss"])
        params[bool(extra)] = [p.detach().clone()
                               for p in built.model.parameters()]
    assert losses[True] == pytest.approx(losses[False], rel=1e-4)
    for a, b in zip(params[True], params[False]):
        assert float((a - b).abs().max()) <= 2 * 3e-3 + 1e-6


def test_loss_chunk_trains_with_remat_attn_and_adam8():
    """The long-context row's flags together (--loss-chunk, --remat
    --remat-policy attn, --optimizer adam8) on the CPU: the loss
    descends below ln 256 within 20 steps, as in the reference's test."""
    from tpu_operator_torch.payload import bootstrap

    args = _lm_args(["--loss-chunk", "32", "--remat", "--remat-policy",
                     "attn", "--optimizer", "adam8", "--steps", "20"])
    metrics = transformer.run(bootstrap.process_info_from_env({}), args)
    assert np.isfinite(metrics["loss"])
    assert metrics["loss"] < 5.6


@pytest.mark.parametrize("extra,match", [
    (["--loss-chunk", "32", "--seq-parallel", "2"], "seq-parallel"),
    (["--loss-chunk", "48"], "divide"),
], ids=["with_sequence_parallel", "not_dividing_seq_len"])
def test_loss_chunk_errors(extra, match):
    with pytest.raises(ValueError, match=match):
        transformer.build(_lm_args(extra))
