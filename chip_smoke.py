#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an H100 (it needs one
card). It imports nothing of JAX and nothing of the JAX package. Phases,
one JSON line each:

1. ``device``: the card's name, count and power limit.
2. ``build``: compiles every ``tpu_operator_torch/kernels/csrc/*.cu`` for
   sm_90a (one nvcc per source, in parallel) and prints ptxas's register
   and spill report, each figure under its entry function. ``sass``: the
   HGMMA count of every kernel in ``cuobjdump --dump-sass`` of the library
   and the registers and spills by kernel; the wgmma kernels (K1, K2's dq
   and dkv, and K4) must run on wgmma and spill nothing.
3. ``kernels``: each kernel's wrapper on tensors on the card at the serve
   and training paths' shapes, held against its plain PyTorch version on the same
   inputs with the stated bf16 tolerance (per element; the forward kernel
   also against a zeroed-V-tile negative control that must fail), and timed (CUDA events, warm,
   median) beside the plain version and one PyTorch library call
   (``scaled_dot_product_attention``, a yardstick only; the port never
   calls it). The decode kernel (K3) runs at Tq 1 (ragged and full
   lengths), Tq 4 (16 query rows; lengths 0, under Tq and inside a
   chunk) and Tq 5 (20 query rows: two launches of the wrapper's
   panels) and must be bit-equal across NaN-poisoned tails, a paged
   gather, a cache of twice the capacity padded with NaN, and a second
   launch; it and SDPA are timed as device time (torch.profiler) beside
   the CUDA-event time, which includes host launch overhead.
4. ``kernels`` (merge): the ring merge kernel (K4) at the long-context
   ring shape (B 2, Tq = Tk = 2048, H 16, KVH 4) and a ragged Tq != Tk,
   against the plain merge per element on the rows that have seen a key:
   a home block from a fresh carry, a second merge into that live carry,
   a wholly future block (the carry must come back bit-equal), striped
   offsets, non-causal, group 1; two negative controls (a fresh carry on
   the plain side, a zeroed V tile) must fail. Timed on CUDA events and
   as device time (torch.profiler) beside the plain merge and the bound;
   no PyTorch call folds a carry, so no yardstick.
5. ``kernels`` (backward): the two backward kernels at the training
   shape against the plain backward with a per-element tolerance set from
   the kernels' bf16 roundings, at two ragged cases with offsets, a
   stride, precomputed D and f32 grads, and at the SP ring's shape (B 2,
   Tq = Tk = 2048, striped (1, 0, 4), given D, f32 grads), a zeroed-D
   negative control that must fail, and bit-equality checks of two
   launches (of the pair, and of the dq kernel alone: dQ and the fused D
   it writes, D also held to rowsum(dO O)); timed at the training and
   ring shapes beside the bound, and
   at the training shape beside the plain version and SDPA's backward (a
   yardstick only).
   ``autograd``: flash_attention's gradients against torch autograd
   through the plain reference attention.
6. ``ring``: ring attention with 4 shards in one process (K4 forward, K2
   backward ring), contiguous and striped, B 1, T 4096: output and
   gradients against K1 + K2 on the whole sequence and against the plain
   reference; each kernel launched 16 times per pass.
7. ``serve``: a full-width ServeLoop (the flagship GQA LM: dim 2048,
   8 layers, 16 heads / 4 K/V heads, vocab 32768; seeded init; batch 8,
   window 1920, 128 decode tokens, page size 16) under ``--load 8:1`` and
   one HTTP ``POST /v1/decode``. Launch counters are zeroed just before
   the run and read just after: the prefill kernel must have run 8 times
   per admission and the decode kernel 8 times per decode step. One
   request's first-token logits are recomputed on the plain path and
   compared with the kernel path.
8. ``profile``: one full-width admission and ten 8-slot decode steps
   under torch.profiler: device time by kernel, device-busy time and the
   idle share beside the host clock.
9. ``train``: the same LM trained at full width for 6 steps (global batch
   32 x 2048 tokens as 4 microbatches, adam with a bf16 first moment)
   through ``transformer.build`` and ``train.train_loop``. Launch counters
   are zeroed just before the loop and read just after: every kernel of
   the step must have run layers x microbatches x steps times. Every loss
   finite, the first within [ln V, ln V + 2]; the loss trajectory, a smoke
   tokens/s and the peak memory are printed. Before the loop (seeded
   init) and after it (trained weights), one 2-row microbatch's loss and
   every parameter's gradient through the kernels are held against plain
   attention under autograd (the gradients at init only) and against K1's
   forward with the plain backward (both times); a plain side with D from
   the bf16 O shows how much of the gap to autograd that alone makes.
   ``profile_train``: one training step and one adam update under
   torch.profiler.
10. ``train_sp``: the long-context flagship (bench.py:661, dim 2048,
    8 layers, 16 / 4 heads, vocab 32768, global batch 8 x 8192 as 4
    microbatches) with ``--seq-parallel 4 --sp-layout striped``, the whole
    ring in this process, 4 steps through ``transformer.build`` and
    ``train.train_loop``: K4, dq and dkv each launched layers x
    microbatches x steps x 16 times and K1 never; before the loop one
    row's loss and gradients on the ring are held against the single-shard
    kernel path. ``profile_train_sp``: one such step under torch.profiler.

Then one JSON line of per-kernel numbers, the ``nvidia-smi`` name/power
line, and, last, ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero. Without a CUDA device, or outside a checkout, it exits 1 or 2
and prints no result.
"""

from __future__ import annotations

import json
import os
import socket
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
BF16_TC_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores
F32_FLOPS = 67e12             # H100 SXM f32 outside the tensor cores

# Tolerances, each with its reason:
# - forward output (per element, against the plain version in f32): the
#   kernel rounds P to bf16 before P@V, as the TPU kernel does, and O once
#   more to bf16 (its row sum l adds the f32 P). A rounding to bf16 moves
#   a value by at most 2^-8 of it, so an element may differ by 2^-8 of |O|
#   plus 2^-8 of A = sum_j P_j |V_j|, the sum of absolute terms of its P@V;
#   the tolerance is twice that bound. The floor, 2^-16 of the tensor's
#   largest |ref|, covers f32 summation-order noise where O cancels to ~0.
#   Each element is held to its own limit, so a late row (|O| ~0.02, A
#   ~0.8) is held to ~0.006 where an early row may move more: one key tile
#   dropped from the last 64 rows alone fails it (the zeroed-V-tile
#   control below must fail);
FWD_REL_TOL = 2.0 ** -7
FWD_ABS_FLOOR = 2.0 ** -16
# - forward logsumexp (absolute): f32 on both sides from the same bf16
#   inputs; only the summation order differs;
L_TOL = 1e-3
# - decode output (per element): the kernel and the plain version both
#   accumulate in f32 and round once to bf16, so each element may differ
#   by one bf16 ulp of its value and no more. 2^-7 * |ref| is between one
#   and two ulps; the floor covers f32 summation-order noise near 0. At the
#   decode shape |O| is ~0.04 (a softmax over ~750 keys), so one key
#   dropped or counted twice (~1e-3) or bf16 accumulation fails it;
DECODE_REL_TOL = 2.0 ** -7
DECODE_ABS_FLOOR = 1e-5
# - first-token logits (2^-6 of the largest |logit|, one to two bf16 ulps
#   there): the logits are bf16, and the kernel path differs from the plain
#   path only in the attention's rounding (above). 0.031 at |logit| ~4,
#   about half of this, was measured on an H100.
LOGIT_REL_TOL = 2.0 ** -6
# - backward grads (per element): the kernels round P and dS to bf16 before
#   their products and the bf16 grads once more; a rounding to bf16 (8
#   significant bits) moves a value by at most 2^-8 of it. The plain
#   version keeps f32. So an element may differ by 2^-8 of its value plus
#   2^-8 of A, the sum of absolute terms of its product (scale |dS||K| for
#   dq, scale |dS|^T|Q| for dk, |P|^T|dO| for dv); the tolerance is twice
#   that bound. The floor, 2^-16 of the tensor's largest |ref|, covers
#   f32 noise where dS = P (dP - D) cancels to ~0 (a row that sees one
#   key has dP = D exactly in real arithmetic; each side keeps ~1e-6 of
#   f32 rounding there, 1.3e-6 seen); a dropped or doubled term moves an
#   element by 1e-3 of the largest or more;
BWD_REL_TOL = 2.0 ** -7
BWD_ABS_FLOOR = 2.0 ** -16
# - attention gradients through autograd (max abs, per tensor): K1's bf16
#   P and O and K2's roundings against f32 plain attention with bf16
#   grads; about 4 bf16 ulps at the largest gradient. A wrong layout, a
#   dropped group sum or a missing tile moves errors to O(max |ref|);
AUTOGRAD_REL_TOL = 2.0 ** -6
# - full-width cross-check, kernels vs plain attention under autograd on
#   the same weights (2 rows), through 8 layers of bf16 backward in which
#   only the attention's internal roundings differ: the loss (absolute;
#   ln 32768 ~ 10.4, bf16 logits, 4094 targets); the whole gradient (norm
#   of the difference over the norm, all parameters together) to 2^-6; and
#   each parameter's gradient to 2^-3. The per-parameter bound is loose
#   because a q or k weight's gradient at init is small, a sum over 4094
#   positions that mostly cancels, while the per-position bf16 noise of P
#   and dS (up to 2^-8 each) does not cancel with it: 3.6% was seen there.
#   A wiring fault (a layout, a GQA group, a missing layer) is off by
#   O(100%). The plain side under autograd takes D = rowsum(dO O), in
#   effect, from the f32 O, where the kernels (and the reference's custom
#   VJP) take it from the bf16 O: the ``plain_bf16_d`` side shows how much
#   of the gap that alone makes;
TRAIN_LOSS_TOL = 1e-2
TRAIN_GRAD_GLOBAL_TOL = 2.0 ** -6
TRAIN_GRAD_REL_TOL = 2.0 ** -3
# - the same cross-check against K1's forward with the plain backward
#   (``_bwd_ref``, f32) and D from K1's bf16 O, at init and on the trained
#   weights: each parameter's gradient to 2^-5 of its norm. Forward, D and
#   everything outside attention are then the same on both sides; only
#   K2's roundings of P and dS (2^-8 of each value) and of its bf16 grads
#   differ, and they do not cancel coherently over 4094 positions. Where
#   the attention has saturated, dS = P (dP - D) leaves mostly D's bf16
#   noise, which both sides share here; a kernel fault confined to such
#   rows would not be shared;
TRAIN_K2_GRAD_REL_TOL = 2.0 ** -5
# - merge kernel (K4) carry, on the rows that have seen a key (m > NEG_INF/2
#   on the plain side; a row that has seen none carries weight-1 sums of
#   the masked keys it met, and the kernel, which never loads a future
#   tile, meets fewer of them; finalize discards both): o per element like
#   K1's output, 2^-7 (|ref| + A) + 2^-16 max |ref|, A = sum_j P_j |V_j|
#   over the visiting block, twice what rounding P to bf16 before P@V can
#   move (o itself stays f32); l per element to 2^-12 of itself: f32 on
#   both sides from the f32 P, apart only through scores that differ by
#   f32 summation order (a relative 1e-5 at most here); m: the rows that
#   have seen a key must be exactly the plain side's rows, and there m is
#   held to 4 D 2^-24 scale |q| max|k|, four times the f32 error bound of
#   a 128-term dot product of bf16 values summed in another order (the
#   tensor cores may truncate). A wholly future block returns the carry
#   bit-equal;
MERGE_REL_TOL = 2.0 ** -7
MERGE_ABS_FLOOR = 2.0 ** -16
MERGE_L_REL_TOL = 2.0 ** -12
MERGE_M_ULPS = 4
# - ring attention (N = 4 shards in one process; K4 forward, K2 backward
#   with precomputed D and f32 grads): the output per element against the
#   plain reference like K1's, 2^-7 (|ref| + A) + 2^-16 max |ref| with A
#   over the whole sequence (each merge rounds P to bf16 against its
#   running max, which rescales exactly), and against K1 to twice that
#   (both sides within it of the plain one); gradients per tensor to
#   AUTOGRAD_REL_TOL of the largest, against autograd through the plain
#   reference and against K1 + K2;
RING_REL_TOL = 2.0 ** -7
RING_ABS_FLOOR = 2.0 ** -16
# - long-context cross-check, the SP path (ring: K4 + K2 with given D and
#   f32 grads) against the single-shard kernel path (K1 + K2 with fused D
#   and bf16 grads), same weights, one row of 8192 tokens, at init: the
#   loss (absolute), the whole gradient and each parameter's gradient, as
#   TRAIN_LOSS_TOL, TRAIN_GRAD_GLOBAL_TOL and TRAIN_GRAD_REL_TOL state for
#   kernels against plain attention. The two sides round P against other
#   running maxima, take D from differently rounded bf16 outputs and round
#   the q/k/v gradients at other points: the same kind and size of noise as
#   kernels against plain attention (3.65% of the worst parameter's norm
#   at init on an H100, the train phase's cross-check). A wrong shard
#   order, offset or stride moves a q/k gradient by O(100%).
SP_LOSS_TOL = TRAIN_LOSS_TOL
SP_GRAD_GLOBAL_TOL = TRAIN_GRAD_GLOBAL_TOL
SP_GRAD_REL_TOL = TRAIN_GRAD_REL_TOL

ROOT = os.path.dirname(os.path.abspath(__file__))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def time_ms(torch, fn, reps: int = 30, warm: int = 3) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, flops: float, flop_rate: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def decode_excess(torch, got, want) -> float:
    """Largest per-element error over its decode tolerance; <= 1 passes."""
    want = want.float()
    limit = DECODE_REL_TOL * want.abs() + DECODE_ABS_FLOOR
    return float(((got.float() - want).abs() / limit).max())


# --- phase: build -------------------------------------------------------------

# The redesigned kernels: wgmma (HGMMA in their SASS) and no spill.
HOPPER_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                  "flash_bwd_dkv_kernel", "flash_merge_kernel")


def ptxas_report(log: str):
    """(the build log's ptxas lines, {kernel: registers, stack and spill
    bytes}) from the ``-Xptxas -v`` report, each figure under the entry
    function it belongs to."""
    import re

    lines, per, cur = [], {}, None
    for ln in log.splitlines():
        ln = ln.strip()
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = m.group(1)
            per[cur] = {}
        if m or any(x in ln for x in ("Function properties for", "registers",
                                      "spill", "error", "warning")):
            lines.append(ln)
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            per[cur].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            per[cur]["registers"] = int(m.group(1))
    return lines, per


def sass_hgmma(lib_path) -> dict:
    """{kernel: count of HGMMA instructions} from ``cuobjdump --dump-sass``
    of the built library."""
    import re
    import shutil

    from tpu_operator_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump") or tool
    sass = subprocess.run([tool, "--dump-sass", str(lib_path)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=300).stdout
    counts, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur is not None and "HGMMA" in ln:
            counts[cur] += 1
    return counts


def check_hopper_build(per_kernel: dict, hgmma: dict) -> None:
    """Every instantiation of a redesigned kernel runs on wgmma and spills
    nothing."""
    for name in HOPPER_KERNELS:
        built = [k for k in per_kernel if name in k]
        require(built, f"build: no ptxas report for {name}")
        for k in built:
            spill = per_kernel[k].get("spill_stores", 0) \
                + per_kernel[k].get("spill_loads", 0)
            require(spill == 0, f"build: {k} spills ({per_kernel[k]})")
        sass = {k: n for k, n in hgmma.items() if name in k}
        require(sass and all(n > 0 for n in sass.values()),
                f"build: {name} has no HGMMA in its SASS ({sass})")


# --- phase: kernels ------------------------------------------------------------


def fwd_plain_terms(torch, fa, qt, kt, vt, causal):
    """The plain forward on [B,H,T,D] blocks (``_merge_ref``), f32: (O, L
    [B,H,T,1], A), A = sum_j P_j |V_j| the sum of absolute terms of each
    element's P@V, the product whose operand the kernel rounds to bf16."""
    b, h, t, d = qt.shape
    carry = fa.init_carry(b, h, t, d, device=qt.device)
    o, l, m = fa._merge_ref(qt, kt, vt, *carry, (0, 0, 1), causal)
    ref_o = fa.finalize((o, l, m), torch.float32)
    ref_l = fa._logsumexp_rows(l, m)
    del o, l, m
    hkv = kt.shape[1]
    qg = qt.reshape(b, hkv, h // hkv, t, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kt.float()) * d ** -0.5
    if causal:
        pos = torch.arange(t, device=qt.device)
        s = torch.where(pos[:, None] >= pos[None, :], s,
                        torch.full((), fa.NEG_INF, device=qt.device))
    p = torch.exp(s - ref_l.reshape(b, hkv, h // hkv, t, 1))
    del s
    terms = torch.einsum("bhgqk,bhkd->bhgqd", p, vt.float().abs())
    return ref_o, ref_l, terms.reshape(b, h, t, d)


def fwd_excess(torch, got, want, terms) -> float:
    """Largest per-element error over its K1 tolerance; <= 1 passes."""
    limit = FWD_REL_TOL * (want.abs() + terms) \
        + FWD_ABS_FLOOR * float(want.abs().max())
    return float(((got.float() - want).abs() / limit).max())


def check_flash_fwd(torch, fa, F, gen):
    """The forward kernel at the serve prefill shape and the training shape
    (causal GQA) and at a non-causal MHA shape with a ragged T, per element
    against the plain version in f32. At the training shape, a negative
    control: the plain side with V's last key tile zeroed (a fault that
    leaves L intact and touches only the last 64 rows) must fail."""
    dev = "cuda"
    results = {}
    for label, (b, t, h, kvh, causal) in {
            "prefill_causal_gqa": (1, 1920, 16, 4, True),
            "train_causal_gqa": (8, 2048, 16, 4, True),
            "noncausal_mha_ragged": (2, 1000, 16, 16, False)}.items():
        d = 128
        q = torch.randn(b, t, h, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(b, t, kvh, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, t, kvh, d, generator=gen, device=dev).bfloat16()
        out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        qt, kt, vt = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))
        ref_o, ref_l, terms = fwd_plain_terms(torch, fa, qt, kt, vt, causal)
        got = out.permute(0, 2, 1, 3)
        err_o = max_err(torch, got, ref_o)
        excess = fwd_excess(torch, got, ref_o, terms)
        err_l = max_err(torch, lse, ref_l)
        require(bool(torch.isfinite(out.float()).all()),
                f"flash_fwd {label}: non-finite output")
        require(excess <= 1.0, f"flash_fwd {label}: O error {err_o}, "
                               f"{excess} x its per-element tolerance")
        require(err_l <= L_TOL, f"flash_fwd {label}: L error {err_l}")
        control = {}
        if label == "train_causal_gqa":
            vc = vt.clone()
            vc[:, :, -64:] = 0
            ctrl_o, _, _ = fwd_plain_terms(torch, fa, qt, kt, vc, causal)
            control = {
                "zeroed_last_v_tile_control_worst_err_over_tol":
                    fwd_excess(torch, got, ctrl_o, terms),
                "zeroed_last_v_tile_control_max_abs_err":
                    max_err(torch, got, ctrl_o)}
            require(control["zeroed_last_v_tile_control_worst_err_over_tol"]
                    > 1.0, f"flash_fwd: the zeroed-V-tile control passed "
                           f"({control})")
            del vc, ctrl_o
        max_ref = float(ref_o.abs().max())
        del ref_o, terms
        ms = time_ms(torch, lambda: fa.flash_attention_with_lse(
            q, k, v, causal=causal))
        plain_ms = time_ms(torch, lambda: fa._attn_ref(qt, kt, vt, causal),
                           reps=10)
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=kvh != h))
        pairs = t * (t + 1) // 2 if causal else t * t
        flops = 4.0 * b * h * d * pairs
        nbytes = 2.0 * (2 * b * t * h * d + 2 * b * t * kvh * d) \
            + 4.0 * b * h * t
        bound_ms, bound_by = bound(nbytes, flops, BF16_TC_FLOPS)
        results[label] = {
            "shape": {"B": b, "T": t, "H": h, "KVH": kvh, "D": d,
                      "causal": causal},
            "max_abs_err_O": err_o, "max_abs_ref_O": max_ref,
            "tol_O": f"per element {FWD_REL_TOL} * (|ref| + A) + "
                     f"{FWD_ABS_FLOOR} * max |ref|, A = sum_j P_j |V_j|",
            "worst_err_over_tol_O": excess, **control,
            "max_abs_err_L": err_l, "tol_L": L_TOL,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_us": bound_ms * 1e3,
            "bound_by": bound_by,
            "tflops": flops / (ms * 1e-3) / 1e12,
            "share_of_bound": bound_ms / ms,
        }
    return results


def check_flash_decode(torch, fa, F, gen):
    """The decode kernel at the serve decode shape (B 8, S 2048, group 4):
    Tq 1 with ragged and full lengths, Tq 4 (16 query rows, one launch)
    and Tq 5 (20 query rows: the wrapper launches the kernel once per
    panel of 4 query slots) with ragged lengths that include 0, a length
    under Tq and lengths that end inside a chunk and a tile. Each case per
    element against the plain version, and bit-equal across: NaN-poisoned
    tails, a paged gather of the same keys, the same keys in a cache of
    capacity 4096 padded with NaN, and a second launch. Tq 1 timed on
    CUDA events and as device time (torch.profiler) beside the plain
    version and SDPA with a length mask."""
    dev = "cuda"
    b, h, kvh, s, d, page = 8, 16, 4, 2048, 128, 16
    out = {}
    ragged = torch.tensor([1, 17, 1920, 2048, 1000, 513, 64, 2047],
                          dtype=torch.int32, device=dev)
    full = torch.full((b,), s, dtype=torch.int32, device=dev)
    ragged_tq4 = torch.tensor([0, 3, 300, 2048, 1000, 513, 64, 2047],
                              dtype=torch.int32, device=dev)
    for label, tq, lengths in (("ragged", 1, ragged), ("full", 1, full),
                               ("tq4_ragged", 4, ragged_tq4),
                               ("tq5_ragged", 5, ragged_tq4)):
        q = torch.randn(b, tq, h, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(b, s, kvh, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, s, kvh, d, generator=gen, device=dev).bfloat16()
        valid = (torch.arange(s, device=dev)[None, :]
                 < lengths[:, None])[:, :, None, None]
        k = torch.where(valid, k, torch.zeros((), dtype=k.dtype, device=dev))
        v = torch.where(valid, v, torch.zeros((), dtype=v.dtype, device=dev))
        before = fa.launch_counts()["flash_decode"]
        got = fa.flash_decode(q, k, v, lengths)
        launches = fa.launch_counts()["flash_decode"] - before
        panels = len(fa._decode_panels(tq, h // kvh))
        require(launches == panels, f"flash_decode {label}: {launches} "
                                    f"launches, wanted {panels}")
        want = fa._decode_ref(q, k, v, lengths)
        err = max_err(torch, got, want)
        excess = decode_excess(torch, got, want)
        require(excess <= 1.0, f"flash_decode {label}: error {err}, "
                               f"{excess} x its per-element tolerance")
        empty = lengths <= 0
        require(not bool(got[empty].any()),
                f"flash_decode {label}: a row of length 0 is not 0")
        nan = torch.full((), float("nan"), dtype=k.dtype, device=dev)
        k_nan, v_nan = torch.where(valid, k, nan), torch.where(valid, v, nan)
        poisoned = fa.flash_decode(q, k_nan, v_nan, lengths)
        poison_equal = bool(torch.equal(poisoned, got))
        require(poison_equal, f"flash_decode {label}: poisoned tail "
                              f"changed the output")
        # Paged: scatter the valid span into a NaN-filled pool through a
        # shuffled page table, gather it back, attend.
        pages_per_slot = s // page
        pool_pages = b * pages_per_slot
        perm = torch.randperm(pool_pages, generator=gen, device=dev)
        tables = perm.reshape(b, pages_per_slot)
        k_pool = torch.full((pool_pages + 1, page, kvh, d), float("nan"),
                            dtype=k.dtype, device=dev)
        v_pool = k_pool.clone()
        k_pool[tables] = k_nan.reshape(b, pages_per_slot, page, kvh, d)
        v_pool[tables] = v_nan.reshape(b, pages_per_slot, page, kvh, d)
        kd = k_pool[tables].reshape(b, s, kvh, d)
        vd = v_pool[tables].reshape(b, s, kvh, d)
        paged = fa.flash_decode(q, kd, vd, lengths)
        paged_equal = bool(torch.equal(paged, got))
        require(paged_equal, f"flash_decode {label}: paged != dense")
        del k_pool, v_pool, kd, vd
        # Capacity: the same valid keys in a cache twice as long, NaN past
        # each row's length (more chunks in the grid, the same partials).
        k_cap = torch.full((b, 2 * s, kvh, d), float("nan"), dtype=k.dtype,
                           device=dev)
        v_cap = k_cap.clone()
        k_cap[:, :s], v_cap[:, :s] = k_nan, v_nan
        capacity_equal = bool(torch.equal(
            fa.flash_decode(q, k_cap, v_cap, lengths), got))
        require(capacity_equal, f"flash_decode {label}: capacity {2 * s} "
                                f"!= capacity {s}")
        del k_cap, v_cap, k_nan, v_nan
        rerun_equal = bool(torch.equal(fa.flash_decode(q, k, v, lengths),
                                       got))
        require(rerun_equal, f"flash_decode {label}: two launches differ")
        res = {
            "shape": {"B": b, "Tq": tq, "H": h, "KVH": kvh, "S": s, "D": d},
            "lengths": [int(x) for x in lengths.tolist()],
            "launches_per_call": launches,
            "max_abs_err": err, "max_abs_ref": float(want.float().abs().max()),
            "tol": f"per element {DECODE_REL_TOL} * |ref| + "
                   f"{DECODE_ABS_FLOOR}",
            "worst_err_over_tol": excess,
            "poisoned_tail_bit_equal": poison_equal,
            "paged_vs_dense_bit_equal": paged_equal,
            "capacity_4096_vs_2048_bit_equal": capacity_equal,
            "two_launches_bit_equal": rerun_equal,
        }
        out[label] = res
        if tq != 1:
            continue
        qt = q.permute(0, 2, 1, 3).contiguous()
        kt, vt = (x.permute(0, 2, 1, 3).contiguous() for x in (k, v))
        mask = valid[:, None, None, :, 0, 0]           # [B,1,1,S]

        def kernel():
            fa.flash_decode(q, k, v, lengths)

        def library():
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                           enable_gqa=True)

        res["event_ms"] = time_ms(torch, kernel, reps=100)
        res["ms"] = kernel_device_ms(torch, kernel, 50,
                                     ("flash_decode_kernel",))[
            "flash_decode_kernel"]
        res["plain_ms"] = time_ms(torch, lambda: fa._decode_ref(
            q, k, v, lengths))
        res["library_event_ms"] = time_ms(torch, library, reps=100)
        res["library_ms"] = kernel_device_ms(torch, library, 50, ())["all"]
        res["ms_is"] = "device time (torch.profiler), 50 calls"
        res["library_ms_is"] = ("F.scaled_dot_product_attention with a "
                                "length mask: device time of every kernel "
                                "it launches, 50 calls")
        keys = float(torch.clamp(lengths, 0, s).sum())
        nbytes = 2.0 * (2 * b * tq * h * d) + 4.0 * b \
            + 2.0 * 2 * keys * kvh * d
        flops = 4.0 * keys * h * d * tq
        res["bound_ms"], res["bound_by"] = bound(nbytes, flops, F32_FLOPS)
        res["bound_us"] = res["bound_ms"] * 1e3
        if isinstance(res["ms"], float):
            res["gb_per_s"] = nbytes / (res["ms"] * 1e-3) / 1e9
            res["share_of_bound"] = res["bound_ms"] / res["ms"]
    return out


def bwd_plain_terms(torch, fa, q, k, v, g, L, D, offsets, causal):
    """The plain backward on [B,T,H,D] blocks, f32: ((dq, dk, dv), (A_dq,
    A_dk, A_dv)), where A are the sums of absolute terms of the three
    products whose operand the kernel rounds to bf16: scale |dS| |K|,
    scale |dS|^T |Q| and |P|^T |dO|."""
    qt, kt, vt, gt = (x.permute(0, 2, 1, 3) for x in (q, k, v, g))
    grads = fa._bwd_ref(qt, kt, vt, gt, L, D, offsets, causal)
    b, hq, tq, d = qt.shape
    hkv, tk = kt.shape[1], kt.shape[2]
    group = hq // hkv
    scale = d ** -0.5
    qg = qt.reshape(b, hkv, group, tq, d).float()
    gg = gt.reshape(b, hkv, group, tq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kt.float()) * scale
    if causal:
        q_off, k_off, stride = fa._normalize_offsets(offsets)
        q_pos = q_off + stride * torch.arange(tq, device=q.device)
        k_pos = k_off + stride * torch.arange(tk, device=q.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                        torch.full((), fa.NEG_INF, device=q.device))
    p = torch.exp(s - L.reshape(b, hkv, group, tq, 1))
    del s
    dp = torch.einsum("bhgqd,bhkd->bhgqk", gg, vt.float())
    ds = (p * (dp - D.reshape(b, hkv, group, tq, 1))).abs_()
    del dp
    a_dv = torch.einsum("bhgqk,bhgqd->bhkd", p, gg.abs())
    del p
    a_dq = scale * torch.einsum("bhgqk,bhkd->bhgqd", ds, kt.float().abs())
    a_dk = scale * torch.einsum("bhgqk,bhgqd->bhkd", ds, qg.abs())
    terms = (a_dq.reshape(b, hq, tq, d), a_dk, a_dv)
    return (tuple(x.permute(0, 2, 1, 3) for x in grads),
            tuple(x.permute(0, 2, 1, 3) for x in terms))


def bwd_excess(torch, got, want, terms) -> float:
    """Largest per-element error over its K2 tolerance; <= 1 passes."""
    limit = BWD_REL_TOL * (want.abs() + terms) \
        + BWD_ABS_FLOOR * float(want.abs().max())
    return float(((got.float() - want).abs() / limit).max())


def bwd_case(torch, fa, gen, b, t, h, kvh, causal, offsets, fused,
             grad_dtype):
    """Inputs of one K2 case: q/k/v/dO bf16 from ``gen``; O and L from K1
    for the aligned causal case (what the training backward sees), else
    from the plain forward at the case's offsets; D = rowsum(dO O) f32."""
    dev, d = "cuda", 128
    q = torch.randn(b, t, h, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(b, t, kvh, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(b, t, kvh, d, generator=gen, device=dev).bfloat16()
    g = torch.randn(b, t, h, d, generator=gen, device=dev).bfloat16()
    if causal and tuple(offsets) == (0, 0, 1):
        out, L = fa.flash_attention_with_lse(q, k, v, causal=True)
    else:
        qt, kt, vt = (x.permute(0, 2, 1, 3) for x in (q, k, v))
        carry = fa.init_carry(b, h, t, d, device=dev)
        o, l, m = fa._merge_ref(qt, kt, vt, *carry, offsets, causal)
        out = fa.finalize((o, l, m), torch.bfloat16).permute(
            0, 2, 1, 3).contiguous()
        L = fa._logsumexp_rows(l, m).contiguous()
    D = (g.float() * out.float()).sum(-1).permute(0, 2, 1)[..., None] \
        .contiguous()

    def run():
        return fa.attention_block_grads(
            q, k, v, g, L, out if fused else None, offsets, causal=causal,
            grad_dtype=grad_dtype, D=None if fused else D)

    return (q, k, v, g, L, out, D), run


def kernel_device_ms(torch, fn, calls: int, names):
    """Device ms per call of each named kernel, and of every kernel
    together under "all", from torch.profiler over ``calls`` calls of
    ``fn`` (one launch of each kernel splits the time a CUDA-event pair
    around both would lump together, and leaves out host launch time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = _device_rows(torch, prof, calls)
    res = {name: sum(ms for key, ms, _n in rows if name in key) or
           "not measured" for name in names}
    res["all"] = sum(ms for _key, ms, _n in rows) or "not measured"
    return res


def check_dq_twice(torch, inputs, offsets, causal, grad_dtype):
    """Two direct launches of the dq kernel with fused D on the same
    inputs: dQ and the D it writes for dkv must be bit-equal, and D must
    match rowsum(dO O) in f32 to within 2^-16 of sum |dO O| (twice the
    f32 error bound of a 128-term sum taken in another order)."""
    from tpu_operator_torch.kernels import build

    q, k, v, g, L, out, D = inputs
    b, tq, h, d = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    lib = build.library()
    runs = []
    for _ in range(2):
        dq = torch.empty(q.shape, dtype=grad_dtype, device=q.device)
        d_out = torch.empty(b, h, tq, 1, dtype=torch.float32, device=q.device)
        rc = lib.flash_bwd_dq_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            L.data_ptr(), out.data_ptr(), None, d_out.data_ptr(),
            dq.data_ptr(), b, tq, tk, h, kvh, d, int(causal), *offsets,
            d ** -0.5, int(grad_dtype == torch.float32),
            torch.cuda.current_stream().cuda_stream)
        build.check(rc, "flash_bwd_dq")
        runs.append((dq, d_out))
    torch.cuda.synchronize()
    (dq0, d0), (dq1, d1) = runs
    equal = bool(torch.equal(dq0, dq1)) and bool(torch.equal(d0, d1))
    require(equal, "flash_bwd: two dq launches differ in dQ or D")
    terms = (g.float() * out.float()).abs().sum(-1).permute(0, 2, 1)[..., None]
    d_excess = float(((d0 - D).abs() / (2.0 ** -16 * terms + 1e-30)).max())
    require(d_excess <= 1.0, f"flash_bwd: fused D {d_excess} x its tolerance")
    return {"two_launches_bit_equal_dq_and_d": equal,
            "d_max_abs_err": max_err(torch, d0, D),
            "d_worst_err_over_tol": d_excess,
            "d_tol": "2^-16 * sum |dO O| per row"}


def bwd_bounds(torch, b, tq, tk, h, kvh, causal, offsets, fused, grad_bytes):
    """Bound (ms, by) of dq, dkv and the pair for one K2 call, counting the
    (query, key) pairs these offsets leave unmasked: dq runs three
    [pairs]-by-D products (S, dP, dQ), dkv four (S, dP, dK, dV). Each reads
    its inputs once and writes its outputs once: dq reads q, k, v, dO, L
    and O (fused D, then also writes D) or D; dkv reads q, k, v, dO, L, D."""
    d = 128
    if causal:
        q_off, k_off, stride = offsets
        q_pos = q_off + stride * torch.arange(tq, device="cuda")
        k_pos = k_off + stride * torch.arange(tk, device="cuda")
        pairs = int((q_pos[:, None] >= k_pos[None, :]).sum())
    else:
        pairs = tq * tk
    mac = 2.0 * d * pairs * b * h  # one [pairs]-by-D product
    q_bytes = 2.0 * b * tq * h * d
    kv_bytes = 2.0 * b * tk * kvh * d
    row_bytes = 4.0 * b * h * tq
    common = 2 * q_bytes + 2 * kv_bytes + row_bytes  # q, dO, k, v, L
    d_in = q_bytes if fused else row_bytes           # O, or D
    dq_out = grad_bytes / 2 * q_bytes + (row_bytes if fused else 0)
    dkv_out = grad_bytes * kv_bytes
    res = {"pairs": pairs}
    for name, products, nbytes in (
            ("dq", 3, common + d_in + dq_out),
            ("dkv", 4, common + row_bytes + dkv_out),
            ("pair", 5, common + d_in + grad_bytes / 2 * q_bytes + dkv_out)):
        res[f"bound_ms_{name}"], res[f"bound_by_{name}"] = bound(
            nbytes, products * mac, BF16_TC_FLOPS)
        res[f"flops_{name}"] = products * mac
    return res


def check_flash_bwd(torch, fa, F, gen):
    """The backward kernels (K2) against the plain backward: at the
    training shape (B 8, T 2048, H 16, KVH 4, causal, O and L from K1,
    fused D, bf16 grads), at two ragged T 1000 cases with offsets (group 4
    with a stride and precomputed D; group 1), f32 grads, and at the SP
    ring's shape (B 2, Tq = Tk = 2048, striped offsets (1, 0, 4), given D,
    f32 grads). A negative control (the plain side with D zeroed) must
    fail the tolerance, and two launches must be bit-equal. The training
    and ring shapes are timed beside the bound; the training shape also
    beside the plain version and SDPA's backward (a yardstick only)."""
    cases = {
        "train_causal_gqa": (8, 2048, 16, 4, True, (0, 0, 1), True,
                             torch.bfloat16),
        "offsets_stride_g4_precomputed_d_ragged": (
            2, 1000, 16, 4, True, (0, 3, 2), False, torch.float32),
        "offsets_g1_ragged": (2, 1000, 8, 8, True, (128, 0, 1), True,
                              torch.float32),
        "sp_ring_striped_given_d": (2, 2048, 16, 4, True, (1, 0, 4), False,
                                    torch.float32),
    }
    timed = ("train_causal_gqa", "sp_ring_striped_given_d")
    out = {}
    for label, (b, t, h, kvh, causal, offs, fused, gd) in cases.items():
        inputs, run = bwd_case(torch, fa, gen, b, t, h, kvh, causal, offs,
                               fused, gd)
        q, k, v, g, L, o, D = inputs
        got = run()
        torch.cuda.synchronize()
        want, terms = bwd_plain_terms(torch, fa, q, k, v, g, L, D, offs,
                                      causal)
        res = {"shape": {"B": b, "T": t, "H": h, "KVH": kvh, "D": 128,
                         "causal": causal},
               "offsets": list(offs), "fused_d": fused,
               "grad_dtype": str(gd).replace("torch.", ""),
               "tol": f"per element {BWD_REL_TOL} * (|ref| + A) + "
                      f"{BWD_ABS_FLOOR} * max |ref|, A the sum of absolute "
                      f"terms"}
        for name, gg, ww, aa in zip(("dq", "dk", "dv"), got, want, terms):
            require(gg.dtype == gd, f"flash_bwd {label}: {name} dtype")
            require(bool(torch.isfinite(gg.float()).all()),
                    f"flash_bwd {label}: non-finite {name}")
            excess = bwd_excess(torch, gg, ww, aa)
            res[name] = {"max_abs_err": max_err(torch, gg, ww),
                         "max_abs_ref": float(ww.abs().max()),
                         "worst_err_over_tol": excess}
            require(excess <= 1.0, f"flash_bwd {label}: {name} error "
                                   f"{excess} x its tolerance")
        out[label] = res
        if label == "train_causal_gqa":
            # Negative control: the plain side with D = 0 must fail.
            zero_want, _ = bwd_plain_terms(torch, fa, q, k, v, g, L,
                                           torch.zeros_like(D), offs, causal)
            control = max(bwd_excess(torch, gg, ww, aa) for gg, ww, aa
                          in zip(got, zero_want, terms))
            require(control > 1.0, f"flash_bwd: the zeroed-D control "
                                   f"passed ({control} x the tolerance)")
            res["zeroed_d_control_worst_err_over_tol"] = control
            del zero_want
            again = run()
            equal = all(bool(torch.equal(x, y)) for x, y in zip(got, again))
            require(equal, "flash_bwd: two launches differ")
            res["two_launches_bit_equal"] = equal
            del again
            res["dq_fused_d"] = check_dq_twice(torch, inputs, offs, causal, gd)
        del want, terms, got
        if label not in timed:
            del inputs
            continue
        res.update(bwd_bounds(torch, b, t, t, h, kvh, causal, offs, fused,
                              4 if gd == torch.float32 else 2))
        res["ms_pair"] = time_ms(torch, run, reps=20)
        per_kernel = kernel_device_ms(
            torch, run, 10, ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"))
        res["ms_dq"] = per_kernel["flash_bwd_dq_kernel"]
        res["ms_dkv"] = per_kernel["flash_bwd_dkv_kernel"]
        for name in ("dq", "dkv"):
            ms = res[f"ms_{name}"]
            if isinstance(ms, float):
                res[f"tflops_{name}"] = res[f"flops_{name}"] / ms / 1e9
                res[f"share_of_bound_{name}"] = res[f"bound_ms_{name}"] / ms
        if label != "train_causal_gqa":
            del inputs
            continue
        qt, kt, vt, gt = (x.permute(0, 2, 1, 3) for x in (q, k, v, g))
        res["plain_ms"] = time_ms(
            torch, lambda: fa._bwd_ref(qt, kt, vt, gt, L, D, offs, causal),
            reps=5)
        # Yardstick: SDPA's backward, timed as forward+backward minus
        # forward on the same inputs ([B,H,T,D] copies); never called by
        # the port.
        ql, kl, vl = (x.detach().contiguous().requires_grad_(True)
                      for x in (qt, kt, vt))
        gl = gt.contiguous()

        def sdpa_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                               enable_gqa=True)

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(
                ql, kl, vl, is_causal=True, enable_gqa=True).backward(gl)

        res["library_fwd_bwd_ms"] = time_ms(torch, sdpa_fwd_bwd, reps=20)
        res["library_fwd_ms"] = time_ms(torch, sdpa_fwd, reps=20)
        res["library_ms"] = res["library_fwd_bwd_ms"] - res["library_fwd_ms"]
        res["library_ms_is"] = ("F.scaled_dot_product_attention backward: "
                                "forward+backward minus forward")
        del inputs, ql, kl, vl, gl
    return out


def check_attention_autograd(torch, fa):
    """flash_attention's gradients on the card (K1 forward, K2 backward
    through FlashAttention) against torch autograd through the plain
    reference_attention, B 2, T 512, causal GQA, bf16, a random
    cotangent."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    b, t, h, kvh, d = 2, 512, 16, 4, 128
    shapes = ((b, t, h, d), (b, t, kvh, d), (b, t, kvh, d))
    xs = [torch.randn(s, generator=gen, device="cuda").bfloat16()
          for s in shapes]
    cot = torch.randn(b, t, h, d, generator=gen, device="cuda").bfloat16()

    def grads(fn):
        ts = [x.clone().requires_grad_(True) for x in xs]
        fn(*ts).backward(cot)
        return [x.grad for x in ts]

    before = fa.launch_counts()
    got = grads(lambda q, k, v: fa.flash_attention(q, k, v, causal=True))
    after = fa.launch_counts()
    want = grads(lambda q, k, v: fa.reference_attention(q, k, v, True))
    res = {"shape": {"B": b, "T": t, "H": h, "KVH": kvh, "D": d},
           "tol": f"max abs error <= {AUTOGRAD_REL_TOL} * max |ref| per "
                  f"tensor"}
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        require(after[name] == before[name] + 1,
                f"autograd: {name} launched {after[name] - before[name]} "
                f"times, wanted 1")
    for name, gg, ww in zip(("dq", "dk", "dv"), got, want):
        require(gg.shape == ww.shape and gg.dtype == ww.dtype,
                f"autograd: {name} shape/dtype")
        err, ref = max_err(torch, gg, ww), float(ww.float().abs().max())
        res[name] = {"max_abs_err": err, "max_abs_ref": ref}
        require(err <= AUTOGRAD_REL_TOL * ref,
                f"autograd: {name} error {err} > {AUTOGRAD_REL_TOL} x {ref}")
    return res


def merge_plain_terms(torch, fa, q, k, v, carry, offsets, causal):
    """The plain merge (``_merge_ref``, f32) of one block on the port's
    layouts: (carry, A), A [B,H,Tq,D] = sum_j P_j |V_j| over the block, the
    sum of absolute terms of each element's P@V."""
    qt, kt, vt = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    offs = fa._normalize_offsets(offsets)
    o, l, m = fa._merge_ref(qt, kt, vt, *carry, offs, causal)
    b, h, tq, d = qt.shape
    hkv, tk = kt.shape[1], kt.shape[2]
    qg = qt.reshape(b, hkv, h // hkv, tq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kt.float()) * d ** -0.5
    if causal:
        q_pos = offs[0] + offs[2] * torch.arange(tq, device=q.device)
        k_pos = offs[1] + offs[2] * torch.arange(tk, device=q.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                        torch.full((), fa.NEG_INF, device=q.device))
    p = torch.exp(s - m.reshape(b, hkv, h // hkv, tq, 1))
    del s
    terms = torch.einsum("bhgqk,bhkd->bhgqd", p, vt.float().abs())
    return (o, l, m), terms.reshape(b, h, tq, d)


def merge_excess(torch, fa, q, k, got, want, terms):
    """(worst o error over its tolerance, worst l error over its tolerance,
    worst m error over its bound, rows seen agree) of kernel carry ``got``
    against plain carry ``want``, on the plain side's rows that have seen
    a key."""
    (go, gl, gm), (wo, wl, wm) = got, want
    seen = wm > fa.NEG_INF / 2
    rows_agree = bool(torch.equal(seen, gm > fa.NEG_INF / 2))
    o_lim = MERGE_REL_TOL * (wo.abs() + terms) \
        + MERGE_ABS_FLOOR * float(torch.where(seen, wo.abs(), 0).max())
    o_exc = torch.where(seen, (go - wo).abs() / o_lim, 0)
    l_exc = torch.where(seen, (gl - wl).abs() / (MERGE_L_REL_TOL * wl.abs()),
                        0)
    d = q.shape[-1]
    q_norm = q.float().norm(dim=-1).permute(0, 2, 1)[..., None]  # [B,H,Tq,1]
    m_lim = MERGE_M_ULPS * d * 2.0 ** -24 * d ** -0.5 * q_norm \
        * float(k.float().norm(dim=-1).max())
    m_exc = torch.where(seen, (gm - wm).abs() / m_lim, 0)
    return (float(o_exc.max()), float(l_exc.max()), float(m_exc.max()),
            rows_agree)


def check_flash_merge(torch, fa, gen):
    """The merge kernel (K4) against the plain merge on the same inputs, at
    the long-context ring shape (B 2, Tq = Tk = 2048, H 16, KVH 4) and a
    ragged Tq != Tk: a home block from a fresh carry, a second merge of an
    earlier block into that live carry, a wholly future block (the carry
    comes back bit-equal), striped offsets (r, kv, 4) with r < kv and
    r > kv, non-causal, and group 1. Two negative controls must fail: the
    plain merge of the second block into a fresh carry (the kernel must
    seed from the live one), and the home block's plain side with the last
    V tile zeroed. Timed at the striped r > kv case, the training path's
    merge, on CUDA events around each call and as device time
    (torch.profiler), beside the plain merge and the bound; no single
    PyTorch call folds a carry, so there is no library yardstick."""
    dev, d, c = "cuda", 128, 2048

    def qkv(b, tq, tk, h, kvh):
        return (torch.randn(b, tq, h, d, generator=gen,
                            device=dev).bfloat16(),
                torch.randn(b, tk, kvh, d, generator=gen,
                            device=dev).bfloat16(),
                torch.randn(b, tk, kvh, d, generator=gen,
                            device=dev).bfloat16())

    def fresh(b, h, tq):
        return fa.init_carry(b, h, tq, d, device=dev)

    # label: (B, Tq, Tk, H, KVH, offsets, causal, carry from: None = fresh,
    # else the label whose kernel output it is; reuse that case's q)
    cases = {
        "home_from_init": (2, c, c, 16, 4, (c, c, 1), True, None),
        "second_merge_earlier_block": (2, c, c, 16, 4, (c, 0, 1), True,
                                       "home_from_init"),
        "wholly_future_block": (2, c, c, 16, 4, (c, 2 * c, 1), True,
                                "second_merge_earlier_block"),
        "striped_r_lt_kv": (2, c, c, 16, 4, (1, 2, 4), True, None),
        "striped_r_gt_kv": (2, c, c, 16, 4, (1, 0, 4), True,
                            "striped_r_lt_kv"),
        "noncausal": (2, c, c, 16, 4, (0, 0, 1), False, "striped_r_gt_kv"),
        "group1": (2, c, c, 8, 8, (0, 0, 1), True, None),
        "ragged_tq1000_tk1500": (2, 1000, 1500, 16, 4, (0, 300, 1), True,
                                 None),
    }
    out, kept = {}, {}
    for label, (b, tq, tk, h, kvh, offs, causal, src) in cases.items():
        q, k, v = qkv(b, tq, tk, h, kvh)
        if src is not None:
            q = kept[src][0]
            carry = kept[src][1]
        else:
            carry = fresh(b, h, tq)
        got = fa.merge_kv_block(q, k, v, carry, offs, causal=causal)
        torch.cuda.synchronize()
        require(all(x.dtype == torch.float32 for x in got),
                f"flash_merge {label}: carry dtype")
        want, terms = merge_plain_terms(torch, fa, q, k, v, carry, offs,
                                        causal)
        o_exc, l_exc, m_exc, rows_agree = merge_excess(
            torch, fa, q, k, got, want, terms)
        seen = want[2] > fa.NEG_INF / 2
        res = {"shape": {"B": b, "Tq": tq, "Tk": tk, "H": h, "KVH": kvh,
                         "D": d, "causal": causal},
               "offsets": list(offs), "carry": src or "init_carry",
               "rows_seen": int(seen.sum()), "rows": int(seen.numel()),
               "max_abs_err_o": float(torch.where(
                   seen, (got[0] - want[0]).abs(), 0).max()),
               "max_abs_ref_o": float(torch.where(
                   seen, want[0].abs(), 0).max()),
               "worst_err_over_tol_o": o_exc,
               "worst_err_over_tol_l": l_exc,
               "worst_err_over_bound_m": m_exc,
               "rows_seen_agree": rows_agree}
        require(rows_agree, f"flash_merge {label}: the rows that saw a key "
                            f"differ from the plain side's")
        require(o_exc <= 1.0, f"flash_merge {label}: o {o_exc} x its "
                              f"tolerance")
        require(l_exc <= 1.0, f"flash_merge {label}: l {l_exc} x its "
                              f"tolerance")
        require(m_exc <= 1.0, f"flash_merge {label}: m {m_exc} x its bound")
        if label == "wholly_future_block":
            equal = all(bool(torch.equal(x, y)) for x, y in zip(got, carry))
            require(equal, "flash_merge: a wholly future block changed the "
                           "carry")
            res["carry_bit_equal"] = equal
        if label == "second_merge_earlier_block":
            ctrl, _ = merge_plain_terms(torch, fa, q, k, v, fresh(b, h, tq),
                                        offs, causal)
            res["fresh_carry_control_worst_err_over_tol_o"] = merge_excess(
                torch, fa, q, k, got, ctrl, terms)[0]
            require(res["fresh_carry_control_worst_err_over_tol_o"] > 1.0,
                    f"flash_merge: the fresh-carry control passed ({res})")
        if label == "home_from_init":
            vc = v.clone()
            vc[:, -64:] = 0
            ctrl, _ = merge_plain_terms(torch, fa, q, k, vc, carry, offs,
                                        causal)
            res["zeroed_last_v_tile_control_worst_err_over_tol_o"] = \
                merge_excess(torch, fa, q, k, got, ctrl, terms)[0]
            require(res["zeroed_last_v_tile_control_worst_err_over_tol_o"]
                    > 1.0, f"flash_merge: the zeroed-V-tile control passed "
                           f"({res})")
        res["tol"] = (f"seen rows: o per element {MERGE_REL_TOL} * (|ref| + "
                      f"A) + {MERGE_ABS_FLOOR} * max |ref|; l "
                      f"{MERGE_L_REL_TOL} * |ref|; m {MERGE_M_ULPS} * D * "
                      f"2^-24 * scale * |q| * max |k|; seen rows exact")
        out[label] = res
        kept[label] = (q, got)
        del want, terms
        if label == "striped_r_gt_kv":
            def kernel():
                fa.merge_kv_block(q, k, v, carry, offs, causal=causal)

            res["ms"] = time_ms(torch, kernel, reps=50)
            res["ms_is"] = "CUDA events around each call, median of 50"
            res["device_ms"] = kernel_device_ms(
                torch, kernel, 50, ("flash_merge_kernel",))[
                "flash_merge_kernel"]
            res["device_ms_is"] = "device time (torch.profiler), 50 calls"
            res["plain_ms"] = time_ms(torch, lambda: fa._merge_ref(
                *(x.permute(0, 2, 1, 3) for x in (q, k, v)), *carry,
                fa._normalize_offsets(offs), causal), reps=10)
            q_pos = offs[0] + offs[2] * torch.arange(tq, device=dev)
            k_pos = offs[1] + offs[2] * torch.arange(tk, device=dev)
            pairs = int((q_pos[:, None] >= k_pos[None, :]).sum())
            flops = 4.0 * b * h * d * pairs
            nbytes = 2.0 * (b * tq * h * d + 2 * b * tk * kvh * d) \
                + 2 * 4.0 * b * h * tq * (d + 2)
            res["bound_ms"], res["bound_by"] = bound(nbytes, flops,
                                                     BF16_TC_FLOPS)
            res["library_ms"] = None
            res["library"] = "none: no single PyTorch call folds a carry"
            res["pairs"] = pairs
            res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
            res["share_of_bound"] = res["bound_ms"] / res["ms"]
            if isinstance(res["device_ms"], float):
                res["device_tflops"] = flops / (res["device_ms"] * 1e-3) \
                    / 1e12
                res["device_share_of_bound"] = (res["bound_ms"]
                                                / res["device_ms"])
    return out


def ring_plain_terms(torch, fa, q, k, v):
    """Causal plain attention on [B,T,H,D] in f32 and A [B,T,H,D] = sum_j
    P_j |V_j| over the whole sequence."""
    group = q.shape[2] // k.shape[2]
    kr, vr = (x.repeat_interleave(group, dim=2).float() for x in (k, v))
    t = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * q.shape[-1] ** -0.5
    mask = torch.tril(torch.ones(t, t, dtype=torch.bool, device=q.device))
    s = torch.where(mask[None, None], s,
                    torch.full((), fa.NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    del s
    out = torch.einsum("bhqk,bkhd->bqhd", p, vr)
    terms = torch.einsum("bhqk,bkhd->bqhd", p, vr.abs())
    return out, terms


def check_ring(torch, fa, ring_mod, gen):
    """Ring attention with N = 4 shards in one process (the merge kernel
    forward, the backward kernels in the backward ring), contiguous and
    striped, B 1, T 4096, H 16, KVH 4: the output and the q/k/v gradients
    of a random cotangent against K1 + K2 (``flash_attention``) on the
    whole sequence and against the plain reference attention."""
    import numpy as np

    dev, b, t, h, kvh, d, n = "cuda", 1, 4096, 16, 4, 128, 4
    xs = [torch.randn(b, t, hh, d, generator=gen, device=dev).bfloat16()
          for hh in (h, kvh, kvh)]
    cot = torch.randn(b, t, h, d, generator=gen, device=dev).bfloat16()

    def run(fn):
        ts = [x.clone().requires_grad_(True) for x in xs]
        out = fn(*ts)
        out.backward(cot)
        return out.detach(), [x.grad for x in ts]

    want_o, terms = ring_plain_terms(torch, fa, *xs)
    floor = RING_ABS_FLOOR * float(want_o.abs().max())
    plain_lim = RING_REL_TOL * (want_o.abs() + terms) + floor
    del terms
    ref_o, ref_g = run(lambda q, k, v: fa.reference_attention(q, k, v, True))
    k_o, k_g = run(lambda q, k, v: fa.flash_attention(q, k, v, causal=True))
    out = {"shape": {"B": b, "T": t, "H": h, "KVH": kvh, "D": d,
                     "shards": n},
           "tol": f"output per element {RING_REL_TOL} * (|ref| + A) + "
                  f"{RING_ABS_FLOOR} * max |ref| against plain, twice that "
                  f"against K1; gradients {AUTOGRAD_REL_TOL} * max |ref| "
                  f"per tensor"}
    for layout in ("contiguous", "striped"):
        stripe = layout == "striped"
        if stripe:
            perm, inv = ring_mod.stripe_permutation(t, n)
        else:
            perm = inv = np.arange(t)
        perm_t = torch.from_numpy(perm).to(dev)
        inv_t = torch.from_numpy(inv).to(dev)
        ring = ring_mod.SeqRing(n)
        before = fa.launch_counts()
        r_o, r_g = run(lambda q, k, v: ring_mod.ring_attention(
            q[:, perm_t], k[:, perm_t], v[:, perm_t], ring, causal=True,
            stripe=stripe)[:, inv_t])
        after = fa.launch_counts()
        launches = {name: after[name] - before[name] for name in after}
        for name in ("flash_merge", "flash_bwd_dq", "flash_bwd_dkv"):
            require(launches[name] == n * n, f"ring {layout}: {name} "
                                             f"launched {launches[name]} "
                                             f"times, wanted {n * n}")
        require(launches["flash_fwd"] == 0, f"ring {layout}: K1 launched")
        exc_plain = float(((r_o.float() - want_o).abs() / plain_lim).max())
        exc_k1 = float(((r_o.float() - k_o.float()).abs()
                        / (2 * plain_lim)).max())
        res = {"launches": launches,
               "out_worst_err_over_tol_vs_plain": exc_plain,
               "out_worst_err_over_tol_vs_k1": exc_k1,
               "out_max_abs_err_vs_plain": max_err(torch, r_o, want_o),
               "out_max_abs_err_vs_k1": max_err(torch, r_o, k_o)}
        require(exc_plain <= 1.0, f"ring {layout}: output {exc_plain} x "
                                  f"its tolerance against plain")
        require(exc_k1 <= 1.0, f"ring {layout}: output {exc_k1} x its "
                               f"tolerance against K1")
        for side, grads in (("plain", ref_g), ("k1_k2", k_g)):
            for name, gg, ww in zip(("dq", "dk", "dv"), r_g, grads):
                err, ref = max_err(torch, gg, ww), float(
                    ww.float().abs().max())
                res[f"{name}_vs_{side}"] = {"max_abs_err": err,
                                            "max_abs_ref": ref}
                require(err <= AUTOGRAD_REL_TOL * ref,
                        f"ring {layout}: {name} against {side} {err} > "
                        f"{AUTOGRAD_REL_TOL} x {ref}")
        out[layout] = res
    return out


# --- phase: serve --------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def post_decode(port: int, prompt, max_tokens: int, result: dict,
                timeout: float = 600.0) -> None:
    """POST /v1/decode once the listener is up (it binds after warm-up)."""
    body = json.dumps({"prompt": prompt, "maxTokens": max_tokens}).encode()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/decode", data=body,
                headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                result["status"] = resp.status
                result["body"] = json.loads(resp.read())
            return
        except urllib.error.HTTPError as e:
            result["status"] = e.code
            result["body"] = e.read().decode(errors="replace")
            return
        except (ConnectionError, urllib.error.URLError):
            time.sleep(0.02)
    result["status"] = "timeout"


def run_serve(torch, fa, serve, bootstrap):
    import numpy as np

    port = free_port()
    argv = ["--batch", "8", "--window", "1920", "--decode-tokens", "128",
            "--page-size", "16", "--vocab", "32768", "--dim", "2048",
            "--heads", "16", "--kv-heads", "4", "--layers", "8",
            "--load", "8:1", "--queue-deadline", "600", "--seed", "0",
            "--http-port", str(port), "--device", "cuda",
            "--checkpoint-dir", ""]
    args = serve.parse_args(argv)
    info = bootstrap.process_info_from_env({})
    loop = serve.ServeLoop(args, info, heartbeat=None, recorder=None)
    rng = np.random.default_rng(7)
    http_prompt = [int(x) for x in rng.integers(0, args.vocab, 1000)]
    http_result: dict = {}
    poster = threading.Thread(
        target=post_decode, args=(port, http_prompt, 128, http_result),
        daemon=True)
    poster.start()
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    summary = loop.run()
    torch.cuda.synchronize()
    counts = fa.launch_counts()
    poster.join(timeout=60)
    cache = loop.engine.cache
    require(http_result.get("status") == 200,
            f"HTTP decode failed: {http_result}")
    http_tokens = http_result["body"]["tokens"]
    require(len(http_tokens) == 128, f"HTTP returned {len(http_tokens)} "
                                     f"tokens, wanted 128")
    require(all(0 <= t < args.vocab for t in http_tokens),
            "HTTP tokens out of vocab range")
    require(summary["completed"] == summary["arrivals"] + 1,
            f"completed {summary['completed']} != arrivals "
            f"{summary['arrivals']} + 1 HTTP")
    require(summary["arrivals"] >= 1, "no synthetic arrivals")
    require(summary["shed"] == 0, f"shed {summary['shed']}")
    require(summary["failedSteps"] == 0,
            f"failed steps {summary['failedSteps']}")
    layers = args.layers
    require(counts["flash_fwd"] == layers * cache.prefills > 0,
            f"flash_fwd launches {counts['flash_fwd']} != {layers} x "
            f"{cache.prefills} prefills")
    require(counts["flash_decode"] == layers * cache.decode_steps > 0,
            f"flash_decode launches {counts['flash_decode']} != {layers} x "
            f"{cache.decode_steps} decode steps")

    # First-token logits of the HTTP request: the kernel path against a
    # plain-path recompute on the card.
    model = loop.model
    n = len(http_prompt)
    padded = torch.zeros(1, args.window, dtype=torch.long, device="cuda")
    padded[0, :n] = torch.tensor(http_prompt, device="cuda")
    positions = torch.arange(args.window, device="cuda")[None, :]

    def plain_attend(_i):
        def attend(q, k, v):
            out, _ = fa._attn_ref(q.permute(0, 2, 1, 3),
                                  k.permute(0, 2, 1, 3),
                                  v.permute(0, 2, 1, 3), True)
            return out.permute(0, 2, 1, 3)
        return attend

    with torch.inference_mode():
        kern = model(padded, positions, serve._causal_attend)[0, n - 1]
        plain = model(padded, positions, plain_attend)[0, n - 1]
    kern, plain = kern.float(), plain.float()
    logit_err = float((kern - plain).abs().max())
    require(bool(torch.isfinite(kern).all()), "non-finite logits")
    logit_tol = LOGIT_REL_TOL * float(plain.abs().max())
    require(logit_err <= logit_tol,
            f"first-token logits error {logit_err} > {logit_tol}")
    kern_tok = int(torch.argmax(kern))
    require(kern_tok == http_tokens[0],
            f"served first token {http_tokens[0]} != kernel-path argmax "
            f"{kern_tok}")
    # Where the plain path's top-1 leads by more than both paths can move,
    # the two paths must pick the same token.
    top2 = torch.topk(plain, 2).values
    margin = float(top2[0] - top2[1])
    argmax_checked = margin > 2 * logit_tol
    if argmax_checked:
        require(int(torch.argmax(plain)) == kern_tok,
                "plain-path first token differs at a clear margin")
    return {
        "summary": summary,
        "launches": counts,
        "prefills": cache.prefills,
        "decode_steps": cache.decode_steps,
        "http_tokens": len(http_tokens),
        "first_token_logit_max_abs_err": logit_err,
        "logit_tol": logit_tol,
        "plain_top1_margin": margin,
        "plain_argmax_checked": argmax_checked,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }, loop


def _device_rows(torch, prof, per: int):
    """(kernel, device ms per profiled unit, launches per unit), largest
    first, from a torch.profiler run over ``per`` units. Only device-side
    events count: the host ops that launched them carry the same time."""
    def dev_us(evt):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(evt, attr):
                return float(getattr(evt, attr))
        return 0.0

    cuda = torch.autograd.DeviceType.CUDA
    rows = [(evt.key[:80], dev_us(evt) / 1e3 / per, evt.count / per)
            for evt in prof.key_averages()
            if getattr(evt, "device_type", None) == cuda and dev_us(evt) > 0]
    return sorted(rows, key=lambda r: -r[1])


def _breakdown(rows, wall_ms: float):
    busy = sum(r[1] for r in rows)
    return {
        "wall_ms_median": wall_ms,
        "device_busy_ms": busy if rows else "not measured",
        "device_idle_share": (1 - busy / wall_ms) if rows
        else "not measured",
        "top_device_ops": [{"op": k, "ms": ms, "calls": n}
                           for k, ms, n in rows[:12]],
    }


def profile_engine(torch, loop, steps: int = 10):
    """Where full-width prefill and decode time goes: one admission, then
    (all 8 slots admitted) ``steps`` decode steps, each under
    torch.profiler (device time by kernel) beside the host clock around
    the synchronised call."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    eng, model, args = loop.engine, loop.model, loop.args
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def prompt(slot):
        return ((np.arange(args.window) + 100 + slot)
                % args.vocab).astype(np.int32)

    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.admit(0, prompt(0), args.decode_tokens, model)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill = _breakdown(_device_rows(torch, prof, 1), prefill_ms)
    for slot in range(1, args.batch):
        eng.admit(slot, prompt(slot), args.decode_tokens, model)
    active = np.ones(args.batch, bool)
    eng.step(model, active)  # one unprofiled step
    torch.cuda.synchronize()
    wall = []
    with profile(activities=acts) as prof:
        for _ in range(steps):
            t0 = time.perf_counter()
            eng.step(model, active)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
    context = int(eng.cache._lengths.max())
    for slot in range(args.batch):
        eng.release(slot)
    decode = _breakdown(_device_rows(torch, prof, steps), statistics.median(wall))
    return {"prefill": {"prompt_tokens": args.window, **prefill},
            "decode_step": {"slots": args.batch, "context_tokens": context,
                            "steps": steps, **decode}}


# --- phase: train --------------------------------------------------------------


TRAIN_ARGV = ["--steps", "6", "--batch", "32", "--seq-len", "2048",
              "--grad-accum", "4", "--adam-mu-dtype", "bf16",
              "--vocab", "32768", "--dim", "2048", "--heads", "16",
              "--kv-heads", "4", "--layers", "8", "--seed", "0",
              "--log-every", "0", "--device", "cuda",
              "--checkpoint-dir", "", "--profile-dir", ""]


def drive_train(torch, fa, train, built, args, label, wanted):
    """``args.steps`` steps of ``built`` through train.train_loop, launch
    counters zeroed just before the loop and read just after; every kernel
    in ``wanted`` must have run exactly that many times. Every loss finite,
    the first within [ln V, ln V + 2]. Returns the loop's readings."""
    import math

    losses, starts = [], []

    def step(batch):
        starts.append(time.perf_counter())
        metrics = built.step(batch)
        losses.append(metrics["loss"])  # stays on the card until the end
        return metrics

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    last = train.train_loop(step, built.batches, args.steps,
                            device=built.device)
    torch.cuda.synchronize()
    end = time.perf_counter()
    counts = fa.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    trajectory = [float(x) for x in losses]
    require(len(trajectory) == args.steps, f"{label}: wrong number of steps")
    require(all(math.isfinite(x) for x in trajectory),
            f"{label}: non-finite loss {trajectory}")
    require(trajectory[-1] == last["loss"], f"{label}: loop result")
    ln_v = math.log(args.vocab)
    require(ln_v <= trajectory[0] <= ln_v + 2,
            f"{label}: step-0 loss {trajectory[0]} outside [ln V, ln V + 2] "
            f"= [{ln_v}, {ln_v + 2}]")
    for name, want in wanted.items():
        require(counts[name] == want,
                f"{label}: {name} launched {counts[name]} times, wanted "
                f"{want}")
    return {"launches": counts, "loss_trajectory": trajectory,
            "loop_seconds": end - t0,
            "step_seconds": [b - a for a, b in zip(starts,
                                                    starts[1:] + [end])],
            "peak_memory_gb": peak}


def run_train(torch, fa, transformer, train, data):
    """The flagship GQA LM at full width (bench.py:636, without remat),
    6 steps of global batch 32 x 2048 as 4 microbatches of 8, through
    transformer.build and train.train_loop. The plain cross-check runs
    before the loop, on the seeded init, and after it, on the trained
    weights (see gate_train_plain for what each gates). Launch counters
    are zeroed just before the loop and read just after: K1 and K2 once
    per layer per microbatch, the merge kernel never."""
    args = transformer.parse_args(TRAIN_ARGV)
    built = transformer.build(args)
    # Two rows from another seed, so the training stream is untouched.
    (rows,) = next(data.synthetic_lm(args.seed + 1, 2, args.seq_len,
                                     vocab=args.vocab))
    tokens = torch.from_numpy(rows).to(built.device)
    at_init = check_train_plain(torch, fa, transformer, train, built.model,
                                tokens)
    gate_train_plain(at_init, at_init=True)
    per_path = args.layers * args.grad_accum * args.steps
    loop = drive_train(torch, fa, train, built, args, "train",
                       {"flash_fwd": per_path, "flash_bwd_dq": per_path,
                        "flash_bwd_dkv": per_path, "flash_merge": 0})
    trained = check_train_plain(torch, fa, transformer, train, built.model,
                                tokens)
    gate_train_plain(trained, at_init=False)
    return {
        "model": "lm_flagship_gqa_kv4 (bench.py:636), no remat",
        "argv": TRAIN_ARGV,
        "params": sum(p.numel() for p in built.model.parameters()),
        **loop,
        "smoke_tokens_per_s_median_steps_2_to_5":
            args.batch * args.seq_len
            / statistics.median(loop["step_seconds"][2:6]),
        "smoke_reading": "6 steps from a cold start; not a throughput "
                         "measurement",
        "crosscheck_at_init": at_init,
        "crosscheck_trained": trained,
    }, built


SP_TRAIN_ARGV = ["--steps", "4", "--batch", "8", "--seq-len", "8192",
                 "--grad-accum", "4", "--adam-mu-dtype", "bf16",
                 "--vocab", "32768", "--dim", "2048", "--heads", "16",
                 "--kv-heads", "4", "--layers", "8", "--seq-parallel", "4",
                 "--sp-layout", "striped", "--seed", "0", "--log-every", "0",
                 "--device", "cuda", "--checkpoint-dir", "",
                 "--profile-dir", ""]


def check_sp_vs_single(torch, transformer, model, tokens, mesh, layout):
    """One microbatch (``tokens``) on the same weights: the loss and every
    parameter's gradient of the sequence-parallel path (the ring: K4, K2
    with given D and f32 grads) against the single-shard kernel path (K1,
    K2 with fused D and bf16 grads), gated at SP_LOSS_TOL,
    SP_GRAD_GLOBAL_TOL and SP_GRAD_REL_TOL."""
    def loss_and_grads(loss_fn):
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(tokens)
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return float(loss.detach()), grads

    sp = loss_and_grads(transformer.make_lm_loss(model, mesh, layout))
    single = loss_and_grads(transformer.make_lm_loss(model))
    res = compare_grads(sp, single)
    del res["_ratios"], sp, single
    res["rows"] = int(tokens.shape[0])
    res["tol"] = (f"loss {SP_LOSS_TOL}; the whole gradient "
                  f"{SP_GRAD_GLOBAL_TOL} and each parameter "
                  f"{SP_GRAD_REL_TOL} of the single-shard norm")
    require(res["loss_abs_err"] <= SP_LOSS_TOL,
            f"train_sp cross-check: loss gap {res['loss_abs_err']}")
    require(res["grad_rel_err_all"] <= SP_GRAD_GLOBAL_TOL,
            f"train_sp cross-check: the whole gradient off by "
            f"{res['grad_rel_err_all']} of its norm")
    name, worst = res["worst_grad_rel_err"][0]
    require(worst <= SP_GRAD_REL_TOL,
            f"train_sp cross-check: {name} gradient off by {worst} of its "
            f"norm")
    return res


def run_train_sp(torch, fa, transformer, train, data):
    """The long-context flagship (bench.py:661 lm_longctx_T8192_gqa,
    without remat) with --seq-parallel 4 --sp-layout striped: 4 steps of
    global batch 8 x 8192 as 4 microbatches of 2, the whole ring of 4
    shards in this one process, through transformer.build and
    train.train_loop. Before the loop, one row's loss and gradients on the
    ring are held against the single-shard kernel path. Launch counters
    are zeroed just before the loop and read just after: the merge kernel
    and both backward kernels N^2 = 16 times per layer per microbatch, K1
    never."""
    args = transformer.parse_args(SP_TRAIN_ARGV)
    built = transformer.build(args)
    mesh = transformer.make_lm_mesh(seq_parallel=args.seq_parallel)
    (rows,) = next(data.synthetic_lm(args.seed + 1, 1, args.seq_len,
                                     vocab=args.vocab))
    tokens = torch.from_numpy(rows).to(built.device)
    cross = check_sp_vs_single(torch, transformer, built.model, tokens, mesh,
                               args.sp_layout)
    n = args.seq_parallel
    per_path = args.layers * args.grad_accum * args.steps * n * n
    loop = drive_train(torch, fa, train, built, args, "train_sp",
                       {"flash_merge": per_path, "flash_bwd_dq": per_path,
                        "flash_bwd_dkv": per_path, "flash_fwd": 0})
    return {
        "model": "lm_longctx_T8192_gqa (bench.py:661), no remat",
        "argv": SP_TRAIN_ARGV,
        "mesh": {"world": mesh.world, "seq_procs": mesh.seq_procs,
                 "seq_shards": mesh.seq_shards, "data": mesh.data},
        "params": sum(p.numel() for p in built.model.parameters()),
        **loop,
        "smoke_tokens_per_s_median_steps_1_to_3":
            args.batch * args.seq_len
            / statistics.median(loop["step_seconds"][1:]),
        "smoke_reading": "4 steps from a cold start, 4 ring shards sharing "
                         "one card; not a throughput measurement",
        "crosscheck_sp_vs_single_shard_at_init": cross,
    }, built


def plain_backward_attend(torch, fa, kernel_forward: bool):
    """An attend (per layer) whose backward is the plain ``_bwd_ref`` in
    f32 with D = rowsum(dO O) from the bf16 O its forward returned, the D
    the kernels take, grads in the input dtype: what
    ``attention_block_grads`` does on the CPU, run on the card. The
    forward is K1 (``kernel_forward``) or the plain ``_attn_ref``."""

    class PlainBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            if kernel_forward:
                out, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
            else:
                o, lse = fa._attn_ref(*(x.permute(0, 2, 1, 3)
                                        for x in (q, k, v)), True)
                out = o.permute(0, 2, 1, 3)
            ctx.save_for_backward(q, k, v, out, lse)
            return out

        @staticmethod
        def backward(ctx, g):
            q, k, v, out, lse = ctx.saved_tensors
            D = (g.float() * out.float()).sum(-1).permute(0, 2, 1)[..., None]
            grads = fa._bwd_ref(*(x.permute(0, 2, 1, 3) for x in (q, k, v, g)),
                                lse, D, (0, 0, 1), True)
            return tuple(x.permute(0, 2, 1, 3).to(q.dtype) for x in grads)

    return lambda _i: PlainBackward.apply


def compare_grads(got, want):
    """Loss gap and gradient gaps of side ``got`` against side ``want``,
    each a (loss, {name: grad}) pair: the whole gradient's and each
    parameter's difference norm over ``want``'s norm."""
    (got_loss, got_g), (want_loss, want_g) = got, want
    ratios, diff_sq, ref_sq = {}, 0.0, 0.0
    for name, g in got_g.items():
        ref = want_g[name]
        diff, norm = float((g - ref).norm()), float(ref.norm())
        diff_sq, ref_sq = diff_sq + diff ** 2, ref_sq + norm ** 2
        ratios[name] = (diff / max(norm, 1e-30), norm)
    worst = sorted(ratios.items(), key=lambda kv: -kv[1][0])
    return {"loss_abs_err": abs(got_loss - want_loss),
            "grad_rel_err_all": (diff_sq / ref_sq) ** 0.5,
            "worst_grad_rel_err": [(n, r) for n, (r, _) in worst[:5]],
            "worst_grad_norm_ref": [(n, g) for n, (_, g) in worst[:5]],
            "median_grad_norm_ref": statistics.median(
                norm for _r, norm in ratios.values()),
            "_ratios": ratios}


def check_train_plain(torch, fa, transformer, train, model, tokens):
    """One microbatch (``tokens``, 2 rows), on the card: the loss and every
    parameter's gradient of four sides on the same weights:
    - ``kernels``: K1 forward, K2 backward (the training path);
    - ``plain``: plain attention (``_attn_ref``) under autograd;
    - ``plain_bf16_d``: the plain forward and the plain backward with D
      from its bf16 O: against ``plain``, the part of the gap that comes
      from taking D from the bf16 O, in plain arithmetic;
    - ``k1_plain_bwd``: K1's forward and the plain backward with D from
      K1's bf16 O: against ``kernels``, K2's own roundings alone."""

    def plain_attend(_i):
        def attend(q, k, v):
            out, _ = fa._attn_ref(q.permute(0, 2, 1, 3),
                                  k.permute(0, 2, 1, 3),
                                  v.permute(0, 2, 1, 3), True)
            return out.permute(0, 2, 1, 3)
        return attend

    def loss_and_grads(attend_for_layer):
        model.zero_grad(set_to_none=True)
        loss = train.next_token_nll(model(tokens, None, attend_for_layer),
                                    tokens)
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return float(loss.detach()), grads

    sides = {"kernels": transformer._causal_attend, "plain": plain_attend,
             "plain_bf16_d": plain_backward_attend(torch, fa, False),
             "k1_plain_bwd": plain_backward_attend(torch, fa, True)}
    runs = {name: loss_and_grads(attend) for name, attend in sides.items()}
    pairs = {"kernels_vs_plain": ("kernels", "plain"),
             "plain_bf16_d_vs_plain": ("plain_bf16_d", "plain"),
             "k1_plain_bwd_vs_plain": ("k1_plain_bwd", "plain"),
             "kernels_vs_k1_plain_bwd": ("kernels", "k1_plain_bwd")}
    out = {"rows": int(tokens.shape[0]),
           "loss": {name: run[0] for name, run in runs.items()}}
    for label, (a, b) in pairs.items():
        out[label] = compare_grads(runs[a], runs[b])
    del runs
    # The parameters the kernels miss most against autograd, on each side.
    out["worst_of_kernels_vs_plain_by_side"] = {
        name: {label: out[label]["_ratios"][name][0] for label in pairs}
        for name, _r in out["kernels_vs_plain"]["worst_grad_rel_err"]}
    for label in pairs:
        del out[label]["_ratios"]
    out["tol"] = (f"kernels vs plain: loss {TRAIN_LOSS_TOL}; at init the "
                  f"whole gradient {TRAIN_GRAD_GLOBAL_TOL} and each "
                  f"parameter {TRAIN_GRAD_REL_TOL} of the plain norm; "
                  f"kernels vs k1_plain_bwd: each parameter "
                  f"{TRAIN_K2_GRAD_REL_TOL}")
    return out


def gate_train_plain(check, *, at_init: bool) -> None:
    """The cross-check's gates: the loss against plain attention; at init
    the gradients against plain attention; always each parameter's
    gradient against K1 + the plain backward."""
    kp, k2 = check["kernels_vs_plain"], check["kernels_vs_k1_plain_bwd"]
    when = "at init" if at_init else "trained"
    require(kp["loss_abs_err"] <= TRAIN_LOSS_TOL,
            f"train cross-check {when}: loss {check['loss']}")
    if at_init:
        require(kp["grad_rel_err_all"] <= TRAIN_GRAD_GLOBAL_TOL,
                f"train cross-check {when}: the whole gradient off by "
                f"{kp['grad_rel_err_all']} of its norm")
        name, worst = kp["worst_grad_rel_err"][0]
        require(worst <= TRAIN_GRAD_REL_TOL,
                f"train cross-check {when}: {name} gradient off by {worst} "
                f"of its norm")
    name, worst = k2["worst_grad_rel_err"][0]
    require(worst <= TRAIN_K2_GRAD_REL_TOL,
            f"train cross-check {when}: {name} gradient off by {worst} of "
            f"its norm against K1 + the plain backward")


def _classify(op: str) -> str:
    if "flash_merge" in op:
        return "K4 flash_merge"
    if "flash_fwd" in op:
        return "K1 flash_fwd"
    if "flash_bwd" in op:
        return "K2 flash_bwd"
    if any(s in op for s in ("gemm", "nvjet", "cutlass", "xmma", "sm90_")):
        return "cuBLAS"
    return "other (elementwise, reductions, copies)"


def profile_train(torch, built):
    """One full training step (4 microbatches + the adam update) under
    torch.profiler, and the adam update alone, beside the host clock."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    (host,) = next(built.batches)
    tokens = torch.from_numpy(host).to(built.device)
    built.step(tokens)  # one unprofiled step
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        built.step(tokens)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(torch, prof, 1)
    groups: dict = {}
    for key, ms, _n in rows:
        groups[_classify(key)] = groups.get(_classify(key), 0.0) + ms
    params = [p for p in built.model.parameters() if p.requires_grad]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        built.optimizer.step(params, built.opt_state)
        torch.cuda.synchronize()
        opt_wall = (time.perf_counter() - t0) * 1e3
    opt_rows = _device_rows(torch, prof, 1)
    return {"train_step": {**_breakdown(rows, wall), "by_group_ms": groups},
            "adam_update": _breakdown(opt_rows, opt_wall)}


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import torch.nn.functional as F

        from tpu_operator_torch.kernels import build
        from tpu_operator_torch.payload import bootstrap
        from tpu_operator_torch.payload import data
        from tpu_operator_torch.payload import flash_attention as fa
        from tpu_operator_torch.payload import ring_attention as ring_mod
        from tpu_operator_torch.payload import serve
        from tpu_operator_torch.payload import train
        from tpu_operator_torch.payload import transformer
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    try:
        emit({"phase": "device", **device, "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda})
        t0 = time.monotonic()
        lib_path = build.build()
        build.library()
        lines, per_kernel = ptxas_report(
            (build.BUILD_DIR / "build.log").read_text())
        emit({"phase": "build", "seconds": time.monotonic() - t0,
              "ptxas": lines})
        hgmma = sass_hgmma(lib_path)
        emit({"phase": "sass", "hgmma_by_kernel": hgmma,
              "ptxas_by_kernel": per_kernel})
        check_hopper_build(per_kernel, hgmma)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        with torch.inference_mode():
            fwd = check_flash_fwd(torch, fa, F, gen)
            emit({"phase": "kernels", "kernel": "flash_fwd", **fwd})
            dec = check_flash_decode(torch, fa, F, gen)
            emit({"phase": "kernels", "kernel": "flash_decode", **dec})
            mrg = check_flash_merge(torch, fa, gen)
            emit({"phase": "kernels", "kernel": "flash_merge", **mrg})
        bwd = check_flash_bwd(torch, fa, F, gen)
        emit({"phase": "kernels", "kernel": "flash_bwd", **bwd})
        emit({"phase": "autograd", **check_attention_autograd(torch, fa)})
        rng = check_ring(torch, fa, ring_mod, gen)
        emit({"phase": "ring", **rng})
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sv, loop = run_serve(torch, fa, serve, bootstrap)
        emit({"phase": "serve", **sv})
        emit({"phase": "profile", **profile_engine(torch, loop)})
        del loop
        torch.cuda.empty_cache()
        tr, built = run_train(torch, fa, transformer, train, data)
        emit({"phase": "train", **tr})
        emit({"phase": "profile_train", **profile_train(torch, built)})
        del built
        torch.cuda.empty_cache()
        sp, built = run_train_sp(torch, fa, transformer, train, data)
        emit({"phase": "train_sp", **sp})
        emit({"phase": "profile_train_sp", **profile_train(torch, built)})
        del built
    except SmokeFailure as e:
        emit({"phase": "failed", "error": str(e)})
        return 1
    serve_fwd, train_fwd = fwd["prefill_causal_gqa"], fwd["train_causal_gqa"]
    main_dec, main_bwd = dec["full"], bwd["train_causal_gqa"]
    ring_bwd = bwd["sp_ring_striped_given_d"]
    bwd_err = {name: max(r[n]["max_abs_err"] for r in bwd.values()
                         for n in names)
               for name, names in (("dq", ("dq",)), ("dkv", ("dk", "dv")))}
    bwd_excess_of = {
        name: max(r[n]["worst_err_over_tol"] for r in bwd.values()
                  for n in names)
        for name, names in (("dq", ("dq",)), ("dkv", ("dk", "dv")))}
    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "tpu_operator_torch/kernels/csrc/flash_fwd.cu",
         "replaces": "tpu_operator/payload/flash_attention.py:462",
         "launches": tr["launches"]["flash_fwd"],
         "launches_by_path": {"train": tr["launches"]["flash_fwd"],
                              "serve": sv["launches"]["flash_fwd"]},
         "max_abs_err": max(r["max_abs_err_O"] for r in fwd.values()),
         "worst_err_over_tol": max(r["worst_err_over_tol_O"]
                                   for r in fwd.values()),
         "ms": train_fwd["ms"], "plain_ms": train_fwd["plain_ms"],
         "bound_ms": train_fwd["bound_ms"],
         "bound_by": train_fwd["bound_by"],
         "library_ms": train_fwd["library_ms"],
         "tflops": train_fwd["tflops"],
         "share_of_bound": train_fwd["share_of_bound"],
         "shape": "train B8 T2048", "serve_prefill_ms": serve_fwd["ms"],
         "serve_prefill_bound_ms": serve_fwd["bound_ms"],
         "serve_prefill_library_ms": serve_fwd["library_ms"],
         "serve_prefill_tflops": serve_fwd["tflops"],
         "serve_prefill_share_of_bound": serve_fwd["share_of_bound"]},
        {"name": "flash_decode", "route": "cuda",
         "source": "tpu_operator_torch/kernels/csrc/flash_decode.cu",
         "replaces": "tpu_operator/payload/flash_attention.py:990",
         "launches": sv["launches"]["flash_decode"],
         "max_abs_err": max(r["max_abs_err"] for r in dec.values()),
         "worst_err_over_tol": max(r["worst_err_over_tol"]
                                   for r in dec.values()),
         "ms": main_dec["ms"], "plain_ms": main_dec["plain_ms"],
         "bound_ms": main_dec["bound_ms"],
         "bound_by": main_dec["bound_by"],
         "library_ms": main_dec["library_ms"],
         "share_of_bound": main_dec.get("share_of_bound"),
         "shape": "serve decode B8 Tq1 S2048, full length",
         "ms_is": main_dec["ms_is"], "library_ms_is": main_dec["library_ms_is"],
         "event_ms": main_dec["event_ms"],
         "library_event_ms": main_dec["library_event_ms"],
         "ptxas": {k: v for k, v in per_kernel.items()
                   if "flash_decode_kernel" in k}},
    ]
    for name, line in (("dq", 629), ("dkv", 665)):
        kernels.append({
            "name": f"flash_bwd_{name}", "route": "cuda",
            "source": "tpu_operator_torch/kernels/csrc/flash_bwd.cu",
            "replaces": f"tpu_operator/payload/flash_attention.py:{line}",
            "launches": sp["launches"][f"flash_bwd_{name}"],
            "launches_by_path": {
                "train_sp": sp["launches"][f"flash_bwd_{name}"],
                "train": tr["launches"][f"flash_bwd_{name}"],
                "ring_check": rng["striped"]["launches"][f"flash_bwd_{name}"]},
            "max_abs_err": bwd_err[name],
            "worst_err_over_tol": bwd_excess_of[name],
            "ms": main_bwd[f"ms_{name}"],
            "plain_ms": main_bwd["plain_ms"],
            "bound_ms": main_bwd[f"bound_ms_{name}"],
            "bound_by": main_bwd[f"bound_by_{name}"],
            "library_ms": main_bwd["library_ms"],
            "tflops": main_bwd.get(f"tflops_{name}"),
            "share_of_bound": main_bwd.get(f"share_of_bound_{name}"),
            "shape": "train B8 T2048",
            "plain_ms_is": "_bwd_ref: dq, dk and dv together",
            "library_ms_is": main_bwd["library_ms_is"],
            "pair_ms": main_bwd["ms_pair"],
            "pair_bound_ms": main_bwd["bound_ms_pair"],
            "sp_ring_shape": "B2 Tq=Tk=2048 H16 KVH4, striped (1, 0, 4), "
                             "given D, f32 grads",
            "sp_ring_ms": ring_bwd[f"ms_{name}"],
            "sp_ring_bound_ms": ring_bwd[f"bound_ms_{name}"],
            "sp_ring_tflops": ring_bwd.get(f"tflops_{name}"),
            "sp_ring_share_of_bound": ring_bwd.get(f"share_of_bound_{name}"),
            "ptxas": {k: v for k, v in per_kernel.items()
                      if f"flash_bwd_{name}_kernel" in k}})
    main_mrg = mrg["striped_r_gt_kv"]
    kernels.append({
        "name": "flash_merge", "route": "cuda",
        "source": "tpu_operator_torch/kernels/csrc/flash_merge.cu",
        "replaces": "tpu_operator/payload/flash_attention.py:287",
        "launches": sp["launches"]["flash_merge"],
        "launches_by_path": {
            "train_sp": sp["launches"]["flash_merge"],
            "train": tr["launches"]["flash_merge"],
            "ring_check": rng["striped"]["launches"]["flash_merge"]},
        "max_abs_err": max(r["max_abs_err_o"] for r in mrg.values()),
        "worst_err_over_tol": max(r["worst_err_over_tol_o"]
                                  for r in mrg.values()),
        "ms": main_mrg["ms"], "plain_ms": main_mrg["plain_ms"],
        "bound_ms": main_mrg["bound_ms"], "bound_by": main_mrg["bound_by"],
        "library_ms": None, "library": main_mrg["library"],
        "tflops": main_mrg["tflops"],
        "share_of_bound": main_mrg["share_of_bound"],
        "ms_is": main_mrg["ms_is"], "device_ms": main_mrg["device_ms"],
        "device_ms_is": main_mrg["device_ms_is"],
        "device_tflops": main_mrg.get("device_tflops"),
        "device_share_of_bound": main_mrg.get("device_share_of_bound"),
        "shape": "train_sp ring B2 Tq=Tk=2048 H16 KVH4, striped (1, 0, 4), "
                 "live carry",
        "ptxas": {k: v for k, v in per_kernel.items()
                  if "flash_merge_kernel" in k}})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
