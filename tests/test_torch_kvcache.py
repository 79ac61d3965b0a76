"""The port's paged KV cache and decode engine
(tpu_operator_torch.payload.kvcache) on the CPU.

Two oracles, as in tests/test_kvcache.py:
- the port's own dense re-forward: greedy decode through the paged cache
  must reproduce, token for token, re-running the whole growing context
  through the model every token;
- the JAX DecodeEngine on the same converted weights: both engines' first
  tokens and the logits behind them agree within the bf16 tolerance of
  tests/test_torch_models.py, and their greedy tokens agree wherever the
  reference's top-1 margin exceeds twice that tolerance.
"""

import argparse

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tpu_operator.payload import kvcache as jkv
from tpu_operator.payload import models as jmodels
from tpu_operator.payload import ring_attention as jring
from tpu_operator.payload import train
from tpu_operator.payload import transformer
from tpu_operator_torch.payload import flash_attention as tfa
from tpu_operator_torch.payload import kvcache
from tpu_operator_torch.payload import weights

WINDOW, NEW, VOCAB, DIM, HEADS = 16, 4, 32, 16, 2
LOGIT_TOL = 2.0 ** -4  # bf16, see tests/test_torch_models.py


def jax_params(kv_heads=1, layers=2, seed=0, dim=DIM):
    shim = argparse.Namespace(
        vocab=VOCAB, dim=dim, heads=HEADS, kv_heads=kv_heads, layers=layers,
        seq_len=WINDOW + NEW, seq_parallel=1, tensor_parallel=1,
        split_qkv="auto", sp_mode="ring", sp_layout="contiguous",
        remat=False)
    mesh = train.make_mesh(axis_names=("data", "model"))
    model = transformer._build_model(shim, mesh)
    sample = jnp.zeros((2, WINDOW), jnp.int32)
    state = train.create_train_state(model, jax.random.key(seed), sample,
                                     optax.adam(1e-3))
    return jax.tree_util.tree_map(np.asarray, state.params)


def port_model(kv_heads=1, seed=0):
    return weights.from_flax(jax_params(kv_heads, seed=seed), heads=HEADS)


def spec_of(kv_heads=1, layers=2, dim=DIM):
    return dict(vocab=VOCAB, dim=dim, heads=HEADS, layers=layers,
                max_seq=WINDOW + NEW, kv_heads=kv_heads)


def make_engine(kv_heads=1, slots=2, page_size=4, num_pages=0, dim=DIM):
    return kvcache.DecodeEngine(
        kvcache.ModelSpec(**spec_of(kv_heads, dim=dim)), slots=slots,
        prompt_pad=WINDOW, max_new=NEW, page_size=page_size,
        num_pages=num_pages, device="cpu")


def greedy_reforward(model, prompt, n):
    """The dense oracle: re-forward the whole growing context per token."""
    ctx = [int(t) for t in prompt]
    out = []
    for _ in range(n):
        tokens = torch.tensor([ctx], dtype=torch.long)
        with torch.inference_mode():
            logits = model(tokens, None, lambda _i: lambda q, k, v:
                           tfa.flash_attention(q, k, v, causal=True))
        nxt = int(torch.argmax(logits[0, -1].float()))
        out.append(nxt)
        ctx.append(nxt)
    return out


def prompt_of(seed, length=WINDOW):
    return (np.arange(length) * 3 + seed + 1).astype(np.int32) % VOCAB


# --- page allocator invariants ------------------------------------------------


@pytest.mark.parametrize("allocator", [kvcache.PageAllocator,
                                       jkv.PageAllocator])
def test_allocator_alloc_free_reuse(allocator):
    """The port's allocator and the reference's pass the same cases."""
    a = allocator(4)
    assert a.free_pages == 4 and a.held_pages == 0
    first = a.alloc(3)
    assert sorted(first) == [0, 1, 2]
    assert a.utilization() == pytest.approx(0.75)
    assert a.alloc(2) is None  # all-or-nothing
    assert a.free_pages == 1
    a.free(first)
    assert a.free_pages == 4 and a.held_pages == 0
    assert sorted(a.alloc(4)) == [0, 1, 2, 3]


def test_allocator_double_and_foreign_free_raise():
    a = kvcache.PageAllocator(2)
    pages = a.alloc(1)
    a.free(pages)
    with pytest.raises(ValueError):
        a.free(pages)  # double free
    with pytest.raises(ValueError):
        a.free([7])  # never allocated from this pool
    with pytest.raises(ValueError):
        a.alloc(0)
    with pytest.raises(ValueError):
        kvcache.PageAllocator(0)


def test_allocators_agree_under_churn():
    """Same alloc/free sequence, same page ids from both allocators."""
    ours, ref = kvcache.PageAllocator(9), jkv.PageAllocator(9)
    rng = np.random.default_rng(0)
    held_ours, held_ref = [], []
    for _ in range(40):
        if held_ours and rng.random() < 0.4:
            i = int(rng.integers(len(held_ours)))
            ours.free(held_ours.pop(i))
            ref.free(held_ref.pop(i))
        else:
            n = int(rng.integers(1, 4))
            a, b = ours.alloc(n), ref.alloc(n)
            assert a == b
            if a is not None:
                held_ours.append(a)
                held_ref.append(b)


# --- paged incremental decode vs the dense re-forward -------------------------


@pytest.mark.parametrize("kv_heads", [0, 1])
def test_incremental_decode_matches_reforward(kv_heads):
    """Greedy decode through the paged cache == greedy re-forward of the
    whole growing context, token for token, at MHA and GQA."""
    model = port_model(kv_heads)
    eng = make_engine(kv_heads=kv_heads)
    prompt = prompt_of(0)
    toks = [eng.admit(0, prompt, NEW, model)]
    for _ in range(NEW - 1):
        out = eng.step(model, np.array([True, False]))
        toks.append(int(out[0]))
    assert toks == greedy_reforward(model, prompt, NEW)
    assert (eng.prefills, eng.decode_steps) == (1, NEW - 1)


def test_short_prompt_and_concurrent_slots_match_reforward():
    """Short (padded) prompts and two slots decoding concurrently: neither
    the padded prompt tail nor the neighbour's pages leak in."""
    model = port_model()
    eng = make_engine()
    p0, p1 = prompt_of(0, length=5), prompt_of(9, length=11)
    toks0 = [eng.admit(0, p0, NEW, model)]
    toks1 = [eng.admit(1, p1, NEW, model)]
    for _ in range(NEW - 1):
        out = eng.step(model, np.array([True, True]))
        toks0.append(int(out[0]))
        toks1.append(int(out[1]))
    assert toks0 == greedy_reforward(model, p0, NEW)
    assert toks1 == greedy_reforward(model, p1, NEW)


def test_page_reuse_after_release_is_transparent():
    """A released slot's pages serve the next admission at once, and
    decode through the scrambled (non-contiguous) table still equals the
    dense reference; a full pool refuses instead of corrupting."""
    model = port_model()
    eng = make_engine(slots=2)
    eng.admit(0, prompt_of(3), NEW, model)
    eng.admit(1, prompt_of(4), NEW, model)
    held0 = eng.slot_pages(0)
    assert eng.utilization() == pytest.approx(1.0)
    assert not eng.can_admit(WINDOW, NEW)
    with pytest.raises(ValueError):
        eng.admit(0, prompt_of(2), NEW, model)  # occupied slot
    eng.release(0)
    assert eng.utilization() == pytest.approx(0.5)
    prompt = prompt_of(7)
    toks = [eng.admit(0, prompt, NEW, model)]
    assert set(eng.slot_pages(0)) == set(held0)
    for _ in range(NEW - 1):
        toks.append(int(eng.step(model, np.array([True, False]))[0]))
    assert toks == greedy_reforward(model, prompt, NEW)
    eng.release(1)
    with pytest.raises(ValueError):
        eng.release(1)
    with pytest.raises(ValueError):
        eng.step(model, np.array([True, True]))  # slot 1 unoccupied
    eng.release(0)
    eng.admit(1, prompt_of(4), 1, model)
    with pytest.raises(ValueError):
        eng.step(model, np.array([False, True]))  # past its budget


def test_oversubscribed_pool_backpressures():
    model = port_model()
    eng = make_engine(slots=2, num_pages=5)  # one request's worth
    assert eng.admit(0, prompt_of(0), NEW, model) is not None
    assert eng.admit(1, prompt_of(1), NEW, model) is None  # queued
    assert eng.slot_pages(1) is None
    eng.release(0)
    assert eng.admit(1, prompt_of(1), NEW, model) is not None


# --- the port's engine vs the reference's -------------------------------------


@pytest.mark.parametrize("kv_heads", [0, 1])
def test_decode_engine_matches_jax_engine(kv_heads):
    """Same converted weights, same prompts: the two engines' prefill
    logits agree within the bf16 tolerance, and their greedy tokens agree
    wherever the reference's top-1 margin exceeds twice it."""
    engines_agree(kv_heads, DIM)


@pytest.mark.parametrize("kv_heads", [0, 1])
def test_decode_engine_matches_jax_engine_at_wide_head_dim(kv_heads):
    """As above at head dim 256 (dim 512, 2 heads), MHA and GQA: the
    port's prefill and decode take their wide path there (K1 and K3 on
    the card), the reference its own kernels."""
    engines_agree(kv_heads, 512)


def engines_agree(kv_heads, dim):
    params = jax_params(kv_heads, dim=dim)
    model = weights.from_flax(params, heads=HEADS)
    spec = spec_of(kv_heads, dim=dim)
    ours = make_engine(kv_heads=kv_heads, dim=dim)
    ref = jkv.DecodeEngine(jkv.ModelSpec(**spec), slots=2, prompt_pad=WINDOW,
                           max_new=NEW, page_size=4)
    prompts = [prompt_of(0, length=9), prompt_of(5)]
    ours_toks = [[ours.admit(s, p, NEW, model)] for s, p in enumerate(prompts)]
    ref_toks = [[ref.admit(s, p, NEW, params)] for s, p in enumerate(prompts)]
    for _ in range(NEW - 1):
        o = ours.step(model, np.array([True, True]))
        r = ref.step(params, np.array([True, True]))
        for s in range(2):
            ours_toks[s].append(int(o[s]))
            ref_toks[s].append(int(r[s]))
    for s, prompt in enumerate(prompts):
        # Logits of every position the engines decoded, from the full
        # context the reference engine produced.
        ctx = np.concatenate([prompt, ref_toks[s][:-1]]).astype(np.int32)
        pos = np.arange(len(ctx), dtype=np.int32)[None]
        want = np.asarray(jmodels.lm_decode_apply(
            params, jnp.asarray(ctx[None]), jnp.asarray(pos),
            lambda _i: lambda q, k, v: jring.reference_attention(q, k, v),
            **spec).astype(jnp.float32))[0, len(prompt) - 1:]
        with torch.inference_mode():
            got = model(torch.from_numpy(ctx[None]).long(),
                        torch.from_numpy(pos).long(),
                        lambda _i: lambda q, k, v:
                        tfa.flash_attention(q, k, v)).float().numpy()[
                            0, len(prompt) - 1:]
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * LOGIT_TOL
        # Tokens agree up to the first step whose margin is unclear (after
        # it the two contexts may legitimately diverge).
        for i in range(NEW):
            if not clear[i]:
                break
            assert ours_toks[s][i] == ref_toks[s][i], (s, i)


def test_decode_engine_matches_jax_engine_at_head_dim_1024():
    """As above at the tensor-parallel job's head dim (dim 2048, 2 heads,
    MHA, 2 layers): whether the bf16 gap between the port and the
    reference grows with the head dim (the card's serve_wide reads it at
    1024)."""
    engines_agree(0, 2048)
