#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an H100 (it needs one
card). It imports nothing of JAX and nothing of the JAX package. Phases,
one JSON line each:

1. ``device``: the card's name, count and power limit.
2. ``build``: compiles every ``tpu_operator_torch/kernels/csrc/*.cu`` for
   sm_90a (one nvcc per source, in parallel) and prints ptxas's register
   and spill report.
3. ``kernels``: each kernel's wrapper on tensors on the card at the serve
   path's shapes, held against its plain PyTorch version on the same
   inputs with the stated bf16 tolerance, and timed (CUDA events, warm,
   median) beside the plain version and one PyTorch library call
   (``scaled_dot_product_attention``, a yardstick only; the port never
   calls it). The decode kernel is also run on poisoned (NaN) tails and
   on a paged gather, which must be bit-equal to the clean dense cache.
4. ``serve``: a full-width ServeLoop (the flagship GQA LM: dim 2048,
   8 layers, 16 heads / 4 K/V heads, vocab 32768; seeded init; batch 8,
   window 1920, 128 decode tokens, page size 16) under ``--load 8:1`` and
   one HTTP ``POST /v1/decode``. Launch counters are zeroed just before
   the run and read just after: the prefill kernel must have run 8 times
   per admission and the decode kernel 8 times per decode step. One
   request's first-token logits are recomputed on the plain path and
   compared with the kernel path.
5. ``profile``: one full-width admission and ten 8-slot decode steps
   under torch.profiler: device time by kernel, device-busy time and the
   idle share beside the host clock.

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
# - prefill output (absolute): O is bf16 with |O| up to ~4 at the prefill
#   shape (early rows see few keys), and the kernel rounds P to bf16 before
#   P@V, as the TPU kernel does, where the plain version keeps P in f32.
#   About twice the 0.0156 measured on an H100;
O_TOL = 3e-2
# - prefill logsumexp (absolute): f32 on both sides from the same bf16
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


# --- phase: kernels ------------------------------------------------------------


def check_flash_fwd(torch, fa, F, gen):
    """The prefill kernel at the serve prefill shape (causal GQA) and at a
    non-causal MHA shape with a ragged T."""
    dev = "cuda"
    results = {}
    for label, (b, t, h, kvh, causal) in {
            "prefill_causal_gqa": (1, 1920, 16, 4, True),
            "noncausal_mha_ragged": (2, 1000, 16, 16, False)}.items():
        d = 128
        q = torch.randn(b, t, h, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(b, t, kvh, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, t, kvh, d, generator=gen, device=dev).bfloat16()
        out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        qt, kt, vt = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))
        ref_o, ref_l = fa._attn_ref(qt, kt, vt, causal)
        err_o = max_err(torch, out.permute(0, 2, 1, 3), ref_o)
        err_l = max_err(torch, lse, ref_l)
        require(bool(torch.isfinite(out.float()).all()),
                f"flash_fwd {label}: non-finite output")
        require(err_o <= O_TOL, f"flash_fwd {label}: O error {err_o}")
        require(err_l <= L_TOL, f"flash_fwd {label}: L error {err_l}")
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
            "max_abs_err_O": err_o, "tol_O": O_TOL,
            "max_abs_err_L": err_l, "tol_L": L_TOL,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_us": bound_ms * 1e3,
            "bound_by": bound_by,
            "tflops": flops / (ms * 1e-3) / 1e12,
        }
    return results


def check_flash_decode(torch, fa, F, gen):
    """The decode kernel at the serve decode shape: ragged lengths with
    NaN-poisoned tails (bit-equal to the clean cache), a paged gather
    (bit-equal to the dense cache), and full-length timing."""
    dev = "cuda"
    b, tq, h, kvh, s, d, page = 8, 1, 16, 4, 2048, 128, 16
    q = torch.randn(b, tq, h, d, generator=gen, device=dev).bfloat16()
    out = {}
    ragged = torch.tensor([1, 17, 1920, 2048, 1000, 513, 64, 2047],
                          dtype=torch.int32, device=dev)
    full = torch.full((b,), s, dtype=torch.int32, device=dev)
    for label, lengths in (("ragged", ragged), ("full", full)):
        k = torch.randn(b, s, kvh, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, s, kvh, d, generator=gen, device=dev).bfloat16()
        valid = (torch.arange(s, device=dev)[None, :]
                 < lengths[:, None])[:, :, None, None]
        k = torch.where(valid, k, torch.zeros((), dtype=k.dtype, device=dev))
        v = torch.where(valid, v, torch.zeros((), dtype=v.dtype, device=dev))
        got = fa.flash_decode(q, k, v, lengths)
        want = fa._decode_ref(q, k, v, lengths)
        err = max_err(torch, got, want)
        excess = decode_excess(torch, got, want)
        require(excess <= 1.0, f"flash_decode {label}: error {err}, "
                               f"{excess} x its per-element tolerance")
        nan = torch.full((), float("nan"), dtype=k.dtype, device=dev)
        poisoned = fa.flash_decode(q, torch.where(valid, k, nan),
                                   torch.where(valid, v, nan), lengths)
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
        k_pool[tables] = torch.where(valid, k, nan).reshape(
            b, pages_per_slot, page, kvh, d)
        v_pool[tables] = torch.where(valid, v, nan).reshape(
            b, pages_per_slot, page, kvh, d)
        kd = k_pool[tables].reshape(b, s, kvh, d)
        vd = v_pool[tables].reshape(b, s, kvh, d)
        paged = fa.flash_decode(q, kd, vd, lengths)
        paged_equal = bool(torch.equal(paged, got))
        require(paged_equal, f"flash_decode {label}: paged != dense")
        ms = time_ms(torch, lambda: fa.flash_decode(q, k, v, lengths),
                     reps=100)
        plain_ms = time_ms(torch, lambda: fa._decode_ref(q, k, v, lengths))
        qt = q.permute(0, 2, 1, 3).contiguous()
        kt, vt = (x.permute(0, 2, 1, 3).contiguous() for x in (k, v))
        mask = valid[:, None, None, :, 0, 0]           # [B,1,1,S]
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), reps=100)
        keys = float(torch.clamp(lengths, 0, s).sum())
        nbytes = 2.0 * (2 * b * tq * h * d) + 4.0 * b \
            + 2.0 * 2 * keys * kvh * d
        flops = 4.0 * keys * h * d * tq
        bound_ms, bound_by = bound(nbytes, flops, F32_FLOPS)
        out[label] = {
            "shape": {"B": b, "Tq": tq, "H": h, "KVH": kvh, "S": s, "D": d},
            "lengths": [int(x) for x in lengths.tolist()],
            "max_abs_err": err, "max_abs_ref": float(want.float().abs().max()),
            "tol": f"per element {DECODE_REL_TOL} * |ref| + "
                   f"{DECODE_ABS_FLOOR}",
            "worst_err_over_tol": excess,
            "poisoned_tail_bit_equal": poison_equal,
            "paged_vs_dense_bit_equal": paged_equal,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_us": bound_ms * 1e3,
            "bound_by": bound_by,
            "gb_per_s": nbytes / (ms * 1e-3) / 1e9,
        }
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
        from tpu_operator_torch.payload import flash_attention as fa
        from tpu_operator_torch.payload import serve
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
        build.library()
        log = (build.BUILD_DIR / "build.log").read_text()
        emit({"phase": "build", "seconds": time.monotonic() - t0,
              "ptxas": [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln
                        or "error" in ln.lower()]})
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        with torch.inference_mode():
            fwd = check_flash_fwd(torch, fa, F, gen)
            emit({"phase": "kernels", "kernel": "flash_fwd", **fwd})
            dec = check_flash_decode(torch, fa, F, gen)
            emit({"phase": "kernels", "kernel": "flash_decode", **dec})
        torch.cuda.reset_peak_memory_stats()
        sv, loop = run_serve(torch, fa, serve, bootstrap)
        emit({"phase": "serve", **sv})
        emit({"phase": "profile", **profile_engine(torch, loop)})
    except SmokeFailure as e:
        emit({"phase": "failed", "error": str(e)})
        return 1
    main_fwd, main_dec = fwd["prefill_causal_gqa"], dec["full"]
    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "tpu_operator_torch/kernels/csrc/flash_fwd.cu",
         "replaces": "tpu_operator/payload/flash_attention.py:462",
         "launches": sv["launches"]["flash_fwd"],
         "max_abs_err": max(r["max_abs_err_O"] for r in fwd.values()),
         "ms": main_fwd["ms"], "plain_ms": main_fwd["plain_ms"],
         "bound_ms": main_fwd["bound_ms"],
         "bound_by": main_fwd["bound_by"],
         "library_ms": main_fwd["library_ms"]},
        {"name": "flash_decode", "route": "cuda",
         "source": "tpu_operator_torch/kernels/csrc/flash_decode.cu",
         "replaces": "tpu_operator/payload/flash_attention.py:990",
         "launches": sv["launches"]["flash_decode"],
         "max_abs_err": max(r["max_abs_err"] for r in dec.values()),
         "ms": main_dec["ms"], "plain_ms": main_dec["plain_ms"],
         "bound_ms": main_dec["bound_ms"],
         "bound_by": main_dec["bound_by"],
         "library_ms": main_dec["library_ms"]},
    ]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
