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
   and dkv, and K4, and the wide-head kernels of each) must run on wgmma
   and spill nothing.
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
   the CUDA-event time, which includes host launch overhead. K1 and K2
   also run at the pipeline row's shape (B 4, T 2048, 16 heads, head dim
   64: their D 64 build), timed beside the bound, the plain version and
   SDPA, and at head dim 32, which the wrappers zero-pad to 64; K3 and K4
   at head dim 64, which theirs pad to 128 (``padded_decode_merge``).
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
5a. ``wide_heads``: every kernel's wide path (head dims above 128: a
   grid axis over column blocks of the output, 256 columns for K1, dq and
   K4 and 128 for dkv and K3; every wide kernel computes each score tile
   once per thread-block cluster of blocks, whose sizes and fitting
   counts the phase prints) per element against its
   plain version with the narrow cases' tolerances: K1, dq and dkv at the
   tensor-parallel job's shard shape (B 16, T 2048, 1 / 1 head, D 1024)
   and at (B 4, T 2048, 8 / 2 heads, D 256), at D 192 (padded to 256)
   with a ragged T (K2 with offsets, a stride, given D, f32 grads), at D
   384 (ragged T) and D 1536 (K2 with given D), and K1 at D 2304 (the
   cluster sizes 2, 3 and 6); K3 at ``WIDE_DECODE_CASES``: (a) B 8, Tq
   1 and 4, S 2048, 8 / 2 heads, D 256, ragged lengths with 0, (b) one
   layer's serve_wide decode step (B 8, Tq 1, S 2048 full, 4 / 4 heads,
   D 1024: one query row, a cluster of 8), (c) (a) at full lengths, and
   clusters of 3, 4, 6 and 1 (D 384, 512, 1536, 1408; the last two
   stream 2 and 11 blocks of K a rank), each bit-equal across NaN tails,
   a paged gather, a doubled capacity and a rerun, with its cluster size
   and the clusters that fit; K4 into a live carry at the ring shape
   with D 256 (striped), at
   D 384 with a ragged T (padded to 512, a cluster of 2) and at D 1024
   (a cluster of 4, stride 2). Negative controls (one 128-column block of
   V zeroed on the plain side, in the last cluster where there are
   several) must fail for K1, K2, K3 and K4. Each timed beside its bound
   (counted from the work the case needs), the plain version and the
   first SDPA backend that takes the head dim.
5b. ``parallel_shapes``: K1, dq, dkv and K4 per element against their
   plain versions at the shapes the ulysses and sp_tp phases give them:
   the Ulysses slab (B 2, T 8192, 16 / 4 heads; K1, then K2 with fused D
   and bf16 grads) and one TP shard's ring chunk (B 8, 4096-token chunks,
   8 / 8 heads; K4 into a live carry, K2 at the home and an earlier
   block with D given and f32 grads). Negative controls (V's first 1024
   keys zeroed on the plain side) must fail for every case. Each timed
   beside its bound and the plain version.
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
8a. ``serve_pod``: serving across a pod's cards. (b) ``ServeLoop(devices=
   [cuda:0, cuda:0])`` at the serve cell's flags with ``--batch 16``: two
   card engines of 8 slots on this card (the loop stepping both in turn,
   the page pool split with the slots, one ingress) under a
   burst of 16 requests, the cell's load and two HTTP requests: nothing
   shed or failed, both engines served, each engine's K1 / K3 launches
   (counted by its launch scope, zeroed just before the run) layers x
   its admissions / decode steps, and every request's tokens bit-equal
   to the serve phase's one-engine, 8-slot server's for its prompt. (a),
   in a subprocess started first and running beside (b): the pod
   launcher as the container's entry point, ``python -m
   tpu_operator_torch.payload.launch -- serve`` with the serve cell's
   flags at 8 slots a card (``--batch 8`` on one card) on every card
   this machine has, and the serve phase's HTTP prompt: exit 0, the 128
   tokens bit-equal to the serve phase's answer, and each card's K1 / K3
   counts, logged by the serve process at its exit, layers x its
   admissions / decode steps.
8b. ``serve_wide``: the serve phase's load, HTTP request and gates at
   the tensor-parallel job's widths (examples/tpujob-tensor-parallel.yml:
   dim 4096, 16 layers, 4 heads, ``--kv-heads 0``, vocab 256; head dim
   1024, 3.2B params, bf16, whole on one card): K1 wide 16 times per
   admission and K3 wide 16 times per decode step (one query row a
   launch); then ``profile``'s admission and ten decode steps: the
   step's wall and device time by kernel, the idle share, K3 wide's
   share of the device time, and the phase's peak memory.
9. ``train``: the same LM trained at full width for 6 steps as its bench
   row is written (bench.py:636: global batch 32 x 2048 tokens as 4
   microbatches, adam with a bf16 first moment, ``--remat --remat-policy
   dots_attn``) through ``transformer.build`` and ``train.train_loop``.
   Launch counters are zeroed just before the loop and read just after:
   every kernel of the step must have run layers x microbatches x steps
   times (dots_attn saves K1's outputs, so the backward does not re-run
   it). Every loss finite, the first within [ln V, ln V + 2]; the loss
   trajectory, a smoke tokens/s and the peak memory are printed. Before
   the loop (seeded init) and after it (trained weights), one 2-row
   microbatch's loss and every parameter's gradient through the kernels
   are held against plain attention under autograd (the gradients at
   init only) and against K1's forward with the plain backward (both
   times); a plain side with D from the bf16 O shows how much of the gap
   to autograd that alone makes. ``profile_train``: one training step and
   one adam update under torch.profiler.
9a. ``fsdp``: the train cell with ``--fsdp`` in this one process (data
   1: every leaf an FSDP shard of one part), 6 steps: the gathers, the
   saved-tensor hooks that gather again in the backward, the recompute's
   gathers under dots_attn and the reduce-scatter seam at full width.
   The loss trajectory must be bit-equal to the train phase's, K1, dq and
   dkv launched as often, and the peak memory's rise above the loop's
   start within 1.5 GB of the train phase's; the step ms and the peak
   are printed on lines of their own.
9b. ``launch``: the train cell through the pod launcher (``python -m
   tpu_operator_torch.payload.launch --cards 1 -- transformer ...``, one
   pod of one card) with a checkpoint dir, SIGTERM to the launcher once
   card 0 logs step 4: exit 143, the card drained and saved at one step
   k; the first 3 losses bit-equal to the train phase's, K1, dq and dkv
   layers x microbatches x k in the card process's own count (this
   slice's path); the time to first step through the launcher beside
   the payload run directly for one step.
10. ``checkpoint``: the training phase's flagship at full width and
    depth, checkpointed and resumed through ``checkpoint.Checkpointer``
    in a ``tempfile.mkdtemp()`` directory (it fails with fewer than 3 x
    4.9 GB free there): an unbroken 6-step run; run A, 3 steps ending
    with step 3 verified; run B, a fresh build at attempt 1 that
    restores step 3 (bit-equal to A's state), trains steps 4-6 (K1, dq
    and dkv layers x microbatches x 3 times, K4 never) and saves step 6,
    its losses and final params bit-equal to the unbroken run's; a
    ServeLoop over the directory that loads step 6's params (bit-equal
    to B's in its storage dtype) and answers an HTTP decode with nothing
    shed or failed; last, one flipped byte in step 6's params, which the
    next restore quarantines, falling back to step 3. Prints each file's
    bytes, the step loop's CHECKPOINT laps, the background write and
    hash rates, the restore's and the server's load times.
11. ``train_sp``: the long-context flagship as its bench row is written
    (bench.py:661, dim 2048, 8 layers, 16 / 4 heads, vocab 32768, global
    batch 8 x 8192 as 4 microbatches, remat under dots_attn) with
    ``--seq-parallel 4 --sp-layout striped``, the whole ring in this
    process, 4 steps through ``transformer.build`` and
    ``train.train_loop``: dq and dkv each launched layers x microbatches
    x steps x 16 times, K4 twice that (no policy names the ring's
    outputs, so the backward re-runs the forward ring) and K1 never;
    before the loop one row's loss and gradients on the ring are held
    against the single-shard kernel path. ``profile_train_sp``: one such
    step under torch.profiler.
12. ``remat``: lm_flagship_gqa_kv4 for 2 steps without remat and under
    each of the six ``--remat-policy`` values, each a fresh build from
    the same seeded init: losses and the params after step 2 bit-equal
    to no remat under every policy; K1 launched twice per layer and
    microbatch under ``full`` and ``dots``, once under the others; the
    peak memory and step time of each (``full`` must peak below no
    remat).
13. ``adam8``: lm_flagship_gqa_kv4_adam8 as written (bench.py:647), 6
    steps: losses finite and within the reference's drop-in bound (rtol
    5e-2, atol 5e-3) of an f32 adam run from the same init and batches;
    the optimizer state's bytes beside f32 adam's; a save at step 3 and a
    restore through ``checkpoint.Checkpointer`` resume bit-equal.
14. ``longctx``: lm_longctx_T32768_gqa as written (bench.py:675: B 2 x
    T 32768 as 2 microbatches of one row, remat under attn, adam8,
    ``--loss-chunk 2048``), full width and depth, 3 steps; on one row the
    chunked loss within 1e-4 of the unchunked loss (forward only); K1
    and K2 once per layer and microbatch; the step time, tokens/s and
    peak memory. ``profile_longctx``: one such step under torch.profiler.
14a. ``moe``: moe_e8_top2_single_chip as written (bench.py:730: dim 1024,
    8 layers, 8 / 4 heads, 8 experts top-2 in every odd layer, batch
    8 x 2048, capacity factor 1.25, bf16, adam, einsum dispatch) through
    ``moe.build`` and ``train.train_loop``, 6 steps: at init the loss and
    gradients through K1 + K2 against plain attention (the train phase's
    gates at init); block 1's MoE layer in both dispatch modes (the same
    routing, outputs within a stated bf16 tolerance); K1, dq and dkv
    layers x steps each in the loop; every loss finite, drop_frac in
    [0, 1], aux in (0, E], router_z finite; a save at step 3 resumed to
    step 6 bit-equal to the unbroken run. Printed: step ms, tokens/s,
    peak memory and one step's device time by group (K1, K2, cuBLAS with
    the dispatch / combine einsums apart, the rest). The kernels phases
    check K1 and K2 at this row's 8 / 4 heads too.
14b. ``pipeline``: the pipeline bench row as written (bench.py:840-905:
    dim 1024, 8 layers, 16 heads, head dim 64, batch 16 x 2048 as 4
    microbatches, vocab 32768, bf16, adam) through ``pipeline.build`` and
    ``train.train_loop``: at init K1 + K2 against plain attention (the
    train phase's gates) and every schedule's loss and gradients against
    gpipe at S 1; 4 steps each of gpipe, 1f1b with either stash and
    interleaved V 2 at ``--pipeline 1``, and 1f1b and interleaved V 2 at
    ``--pipeline 4`` in this process, with launch counts (dq and dkv
    layers x microbatches x steps, K1 once that or twice under ``--stash
    input``), the stash peaks, peak memory and the fenced step time
    beside the dense transformer's at the same shape (a smoke
    overhead_vs_dense); a save at step 2 resumed to step 4 bit-equal.
14c. ``defaults``: ``python -m tpu_operator_torch.payload.transformer``,
    ``.pipeline`` and ``.moe`` at their default flags with ``--steps 3``
    in fresh processes, all three at once, and ``serve`` at its defaults
    under a short load:
    head dims 64, 64, 32 and 16, the last two through the wrappers' zero
    padding; exit codes and launch counts gated.
14d. ``tensor_parallel``: examples/tpujob-tensor-parallel.yml's payload
    as written (``--tensor-parallel 4 --dim 4096 --layers 16 --batch 16
    --remat``; 4 heads: head dim 1024, the wide kernels; 3.2B params),
    the four shards as units in this process, 4 steps through
    ``transformer.build`` and ``train.train_loop``: K1 2 x layers x
    shards x steps (full remat re-runs the forward), dq and dkv once
    that; before the loop, on a 2-layer copy at the same width, TP 4's
    loss and every gradient at init against TP 1's (``--split-qkv on``,
    the same params). The step time and peak memory are printed. Then
    the same 4 steps at ``--tensor-parallel 1`` (launches gated, kept
    apart from the slice's): the two loss trajectories side by side.
14e. ``sp_tp``: examples/tpujob-3d-parallel.yml's payload as written (T
    16384, ``--seq-parallel 4 --tensor-parallel 2``, dim 2048, 16 heads,
    12 layers, ``--remat``, batch 8), 2 steps: each TP shard runs its own
    4-shard ring on its 8 heads; K4 2 x 16 per layer, shard and step,
    dq and dkv 16, K1 never; the gate against ``--tensor-parallel 1`` at
    the same ``--seq-parallel 4``.
14f. ``ulysses``: the SP bench row (bench.py:661) with ``--seq-parallel
    4 --sp-mode ulysses`` in place of the striped ring, 4 steps: K1, dq
    and dkv once per layer, microbatch and step (one call over the heads
    of the four shards this process holds), K4 never;
    the gate against the ring at the same weights; the step time beside
    train_sp's.
14g. ``pipeline_tp``: examples/tpujob-pipeline-tp.yml's payload as
    written (32 layers, ``--pipeline 4 --tensor-parallel 4``, 1f1b over
    16 microbatches of 4 x 256, ``--zero1``; dim 256, head dim 64, one
    head a shard), 4 steps with the 4 stages and 4 shards as units in
    this process through ``pipeline.build`` and ``train.train_loop``: K1
    2 x layers x microbatches x shards x steps (the input stash's
    recompute), dq and dkv once that; before the loop, on a
    2-layer-a-stage copy, the loss and every gradient at init against
    ``--tensor-parallel 1 --split-qkv on`` (the same params); then the
    same 4 steps at TP 1, the step times, peak memory and loss
    trajectories side by side.
14h. ``moe_tp``: examples/tpujob-moe-tp.yml's payload as written (8
    experts, ``--expert-parallel 4 --tensor-parallel 2``, dim 1024, 16
    heads, batch 32 x 256, capacity factor 1.25), the same way: K1, dq
    and dkv once per layer, shard and step; the gate at init pins the
    routes (``RoutePin``) for the gradients and compares the loss
    routing its own way too; drop_frac, aux and z beside TP 1's. K1 and
    K2 are also checked per element at both phases' shard shapes in the
    kernels phases (``TP_SLICE_SHAPES``).
15. ``classifier``: ``payload.cifar`` at its defaults (ResNet-20, batch
    1024, sgd 0.1 / 0.9) for 20 steps (the loss descends; the first 5
    losses against a CPU run of the same port from the same weights and
    batches within 2e-2; images/s); a kill and resume through
    ``checkpoint.Checkpointer``, bit-equal; ``python -m
    tpu_operator_torch.payload.linear --steps 200`` in a subprocess on
    the card, beside the CPU run and the resume, exits 0.
    ``profile_classifier``: one cifar step under torch.profiler.
15a. ``classifier_tp``: the classifier cell with ``--model-parallel 2``,
    both shards as units on the card (stage-2 convs 32 of 64 channels a
    shard, the head 5 of 10 classes): at init the loss and every gradient
    against ``--model-parallel 1`` from the same seed on the same batch
    (within the bf16 tolerances it states), 20 steps (finite, descending;
    images/s beside the classifier phase's; peak memory), a kill and
    resume at model 2 bit-equal, and the resumed run's step restored at
    model 1 bit-equal.

16. ``warm_restart`` (after ``checkpoint``): the train cell as two
    attempts of ``python -m tpu_operator_torch.payload.transformer`` with
    the operator's store, cache and heartbeat env and a local status
    server. Attempt 0 (empty cache dir, ``localfs`` store) builds the
    kernel library with nvcc, saves steps 1 and 3 and ships them and the
    library through the write-behind uploader. Attempt 1 on a fresh node
    (empty checkpoint and cache dirs, ``NVCC`` a failing command) must
    prefetch step 3 and the library during the rendezvous, report
    ``cacheHit`` and ``prefetchHit`` true, resume at step 3 and train to
    6, its beats' losses and its step-6 params and optimizer state
    bit-equal to the checkpoint phase's unbroken run; K1 and K2 layers x
    microbatches x 3 in each attempt (from its log). Both startup
    breakdowns are printed.
17. ``serve_reload``: a ServeLoop at the serve cell's flags with
    ``TPUJOB_SERVE`` and that store, starting on step 3, under a steady
    load; step 6 is uploaded mid-run. One reload to step 6, nothing shed
    or failed, every request completed, the live KV pages untouched by
    the swap, K1 and K3 launched; the greedy tokens of a fixed prompt
    equal a fresh server's at step 6. The readiness gap is printed.
18. ``autotune``: ``payload.cifar`` at its defaults, 20 steps with the
    autotune env (a window of 8: two windows), beside a static run: the
    losses bit-equal, every ``dataPlane`` body acceptable to the
    reference's sanitizer; adjustments and images/s of both printed.
19. ``profile_directive``: the train cell for 9 steps with a
    ``--profile-dir`` window over steps 2-3 and a local status server
    answering with a profile directive of 4 steps: the artifact holds 4
    laps merged with the recorder's rows, the next beat carries the
    result, and both torch.profiler traces name the port's flash_fwd
    and flash_bwd kernels.

Then the total wall time, one JSON line of per-kernel numbers, the
``nvidia-smi`` name/power line, and, last, ``{"ok": true, "device":
{...}}``. Any failed check exits
non-zero. Without a CUDA device, or outside a checkout, it exits 1 or 2
and prints no result.

    python3 chip_smoke.py --fsdp-cards 4

is a separate measurement on a machine with four cards (no phase above
runs): examples/tpujob-tensor-parallel.yml's payload with ``--fsdp`` in
place of ``--tensor-parallel 4`` (dim 4096, 16 layers, 4 heads, batch
16, ``--remat``; 3.2B params) as four NCCL processes, one a card (data
4), 4 steps: each card's peak memory (after the build, and over the
steps), the fenced step ms and the losses; then one card at the same
flags without ``--fsdp``, its losses beside them. One JSON line each,
the last ``{"ok": true, ...}``.

    python3 chip_smoke.py --launch-cards 4

is another (four cards): examples/torch/gpujob-tensor-parallel.yml's
payload line as written (``-- transformer --tensor-parallel 4 --dim 4096
--layers 16 --batch 16 --remat``) through the pod launcher as one pod of
four cards, 4 steps (TP 4 over NCCL): each card's losses, model group,
peak memory and step ms from its log; then one card holding the four
shards as units at the same flags, gated as LAUNCH_CARDS_STEP1_RTOL
says.

    python3 chip_smoke.py --serve-cards 4

is a third (four cards): examples/torch/gpujob-serve.yml's payload line
(``-- serve --load 200:0 --batch 8 --kv-heads 2``) through the pod
launcher as one pod of four cards, with its ``--load 200:0`` (held
forever) replaced by ``SERVE_CARDS_LOAD``; then the serve cell at
flagship widths with ``--batch 32`` (8 slots a card) over the four cards
in this process, and at ``--batch 8`` on one card, each under a burst
that fills its slots, the cell's load and 4 HTTP requests a card: every
request answered, nothing shed or failed, each card's K1 / K3 counts,
and every request of the pod bit-equal to the one card's tokens for its
prompt. It prints the pod's tokens/s beside the one card's, each card's
decode-step wall and peak memory.
"""

from __future__ import annotations

import gc
import json
import os
import re
import signal
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


_STARTED = time.monotonic()


def emit(obj) -> None:
    """One JSON line; a phase's line carries the script's elapsed seconds."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.monotonic() - _STARTED}
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


# --- phase: build ------------------------------------------------------------

# The redesigned kernels: wgmma (HGMMA in their SASS) and no spill.
HOPPER_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                  "flash_bwd_dkv_kernel", "flash_merge_kernel",
                  "flash_fwd_wide_kernel", "flash_bwd_dq_wide_kernel",
                  "flash_bwd_dkv_wide_kernel", "flash_merge_wide_kernel")
# Kernels on CUDA cores that must spill nothing all the same.
NO_SPILL_KERNELS = ("flash_decode_wide_kernel",)


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
    """Every instantiation of a redesigned kernel spills nothing, and
    those of :data:`HOPPER_KERNELS` run on wgmma."""
    for name in (*HOPPER_KERNELS, *NO_SPILL_KERNELS):
        built = [k for k in per_kernel if name in k]
        require(built, f"build: no ptxas report for {name}")
        for k in built:
            spill = per_kernel[k].get("spill_stores", 0) \
                + per_kernel[k].get("spill_loads", 0)
            require(spill == 0, f"build: {k} spills ({per_kernel[k]})")
        if name in NO_SPILL_KERNELS:
            continue
        sass = {k: n for k, n in hgmma.items() if name in k}
        require(sass and all(n > 0 for n in sass.values()),
                f"build: {name} has no HGMMA in its SASS ({sass})")


# --- phase: kernels ----------------------------------------------------------


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


def moe_generator(torch):
    """The MoE row's kernel cases draw from a generator of their own, so
    the earlier cases see the inputs they saw before those were added."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    return gen


def head_dim_generator(torch):
    """The same for the cases at head dims other than 128 (the pipeline
    row's D 64, and the padded D 32 / D 64 cases)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    return gen


def tp_slice_generator(torch):
    """The cases at the pipeline_tp and moe_tp phases' shard shapes draw
    from a generator of their own too."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    return gen


# The shapes the pipeline_tp and moe_tp phases give K1 and K2: one TP
# shard's attention, head dim 64. pipeline_tp: a 4-row microbatch of
# tpujob-pipeline-tp.yml (64 rows / 16), T 256, 4 heads / TP 4; moe_tp:
# tpujob-moe-tp.yml's 32 rows, T 256, 16 heads / TP 2.
TP_SLICE_SHAPES = {"pipeline_tp_shard_d64": (4, 256, 1, 1),
                   "moe_tp_shard_d64": (32, 256, 8, 8)}


def check_flash_fwd(torch, fa, F, gen):
    """The forward kernel at the serve prefill shape, the training shape,
    the MoE row's (8 / 4 heads; causal GQA), the pipeline row's (B 4, 16
    heads, head dim 64: the kernel's D 64 build) and at a non-causal MHA
    shape with a ragged T, at head dim 32 (zero-padded to 64 by the
    wrapper), and at the pipeline_tp and moe_tp shard shapes
    (``TP_SLICE_SHAPES``), per element against the plain version in f32
    at the true head dim. At the training shape, a negative control: the plain side
    with V's last key tile zeroed (a fault that leaves L intact and
    touches only the last 64 rows) must fail."""
    dev = "cuda"
    results = {}
    head_dims = head_dim_generator(torch)
    for label, (b, t, h, kvh, causal, d) in {
            "prefill_causal_gqa": (1, 1920, 16, 4, True, 128),
            "train_causal_gqa": (8, 2048, 16, 4, True, 128),
            "noncausal_mha_ragged": (2, 1000, 16, 16, False, 128),
            "moe_causal_gqa": (8, 2048, 8, 4, True, 128),
            "pipeline_causal_mha_d64": (4, 2048, 16, 16, True, 64),
            "padded_d32_causal_gqa": (2, 1000, 8, 4, True, 32),
            **{label: (*shape, True, 64)
               for label, shape in TP_SLICE_SHAPES.items()}}.items():
        g = tp_slice_generator(torch) if label in TP_SLICE_SHAPES else \
            moe_generator(torch) if label.startswith("moe") else \
            head_dims if d != 128 else gen
        q = torch.randn(b, t, h, d, generator=g, device=dev).bfloat16()
        k = torch.randn(b, t, kvh, d, generator=g, device=dev).bfloat16()
        v = torch.randn(b, t, kvh, d, generator=g, device=dev).bfloat16()
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
            "kernel_head_dim": fa.kernel_head_dim("flash_fwd", d),
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


def decode_invariants(torch, fa, gen, q, k, v, lengths, got, label: str,
                      page: int = 16) -> dict:
    """The decode kernel's output ``got`` for (q, k, v, lengths) must come
    back bit-equal from: NaN-poisoned tails (every key at or past a row's
    length), a paged gather of the same keys (scattered into a NaN-filled
    pool through a shuffled page table drawn from ``gen``, gathered back),
    the same keys in a cache of twice the capacity padded with NaN (more
    chunks in the grid, the same partials), and a second launch."""
    dev = q.device
    b, s, kvh, d = k.shape
    valid = (torch.arange(s, device=dev)[None, :]
             < lengths[:, None])[:, :, None, None]
    nan = torch.full((), float("nan"), dtype=k.dtype, device=dev)
    k_nan, v_nan = torch.where(valid, k, nan), torch.where(valid, v, nan)
    poison_equal = bool(torch.equal(fa.flash_decode(q, k_nan, v_nan, lengths),
                                    got))
    require(poison_equal, f"{label}: poisoned tail changed the output")
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
    del k_pool, v_pool
    paged_equal = bool(torch.equal(fa.flash_decode(q, kd, vd, lengths), got))
    require(paged_equal, f"{label}: paged != dense")
    del kd, vd
    k_cap = torch.full((b, 2 * s, kvh, d), float("nan"), dtype=k.dtype,
                       device=dev)
    v_cap = k_cap.clone()
    k_cap[:, :s], v_cap[:, :s] = k_nan, v_nan
    del k_nan, v_nan
    capacity_equal = bool(torch.equal(
        fa.flash_decode(q, k_cap, v_cap, lengths), got))
    require(capacity_equal, f"{label}: capacity {2 * s} != capacity {s}")
    del k_cap, v_cap
    rerun_equal = bool(torch.equal(fa.flash_decode(q, k, v, lengths), got))
    require(rerun_equal, f"{label}: two launches differ")
    return {"poisoned_tail_bit_equal": poison_equal,
            "paged_vs_dense_bit_equal": paged_equal,
            f"capacity_{2 * s}_vs_{s}_bit_equal": capacity_equal,
            "two_launches_bit_equal": rerun_equal}


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
        same = decode_invariants(torch, fa, gen, q, k, v, lengths, got,
                                 f"flash_decode {label}", page)
        res = {
            "shape": {"B": b, "Tq": tq, "H": h, "KVH": kvh, "S": s, "D": d},
            "lengths": [int(x) for x in lengths.tolist()],
            "launches_per_call": launches,
            "max_abs_err": err, "max_abs_ref": float(want.float().abs().max()),
            "tol": f"per element {DECODE_REL_TOL} * |ref| + "
                   f"{DECODE_ABS_FLOOR}",
            "worst_err_over_tol": excess,
            **same,
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
             grad_dtype, d=128):
    """Inputs of one K2 case at head dim ``d``: q/k/v/dO bf16 from
    ``gen``; O and L from K1 for the aligned causal case (what the
    training backward sees), else from the plain forward at the case's
    offsets; D = rowsum(dO O) f32."""
    dev = "cuda"
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
    D = fa.row_dot(g, out)

    def run():
        return fa.attention_block_grads(
            q, k, v, g, L, out if fused else None, offsets, causal=causal,
            grad_dtype=grad_dtype, D=None if fused else D)

    return (q, k, v, g, L, out, D), run


def kernel_device_ms(torch, fn, calls: int, names):
    """Device ms of one launch of each named kernel (each launched once a
    call), and of every kernel of a call together under "all", from
    torch.profiler over ``calls`` calls of ``fn`` (one launch of each
    kernel splits the time a CUDA-event pair around both would lump
    together, and leaves out host launch time). A named kernel's time is
    its device total over the launches the profiler recorded: late in a
    long run the profiler has been seen to keep 3 of 10 launches, and a
    total over the calls made then reads 0.3 of the time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = _device_rows(torch, prof, calls)
    res = {}
    for name in names:
        ms = sum(ms for key, ms, _n in rows if name in key)
        launches = sum(n for key, _ms, n in rows if name in key)
        res[name] = ms / launches if launches else "not measured"
        res[f"{name}_recorded_launches"] = launches * calls
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


def bwd_bounds(torch, b, tq, tk, h, kvh, causal, offsets, fused, grad_bytes,
               d=128):
    """Bound (ms, by) of dq, dkv and the pair for one K2 call at head dim
    ``d``, counting the (query, key) pairs these offsets leave unmasked:
    dq runs three [pairs]-by-D products (S, dP, dQ), dkv four (S, dP, dK,
    dV). Each reads its inputs once and writes its outputs once: dq reads
    q, k, v, dO, L and O (fused D, then also writes D) or D; dkv reads q,
    k, v, dO, L, D."""
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
    fused D, bf16 grads), the MoE row's (H 8, KVH 4) and the pipeline
    row's (B 4, H = KVH = 16, head dim 64: the kernels' D 64 build), at
    two ragged T 1000 cases with offsets (group 4 with a stride and
    precomputed D; group 1), f32 grads, at head dim 32 (zero-padded to 64
    by the wrapper; offsets with a stride, given D, f32 grads), at the
    SP ring's shape (B 2, Tq = Tk = 2048, striped offsets (1, 0, 4), given
    D, f32 grads) and at the pipeline_tp and moe_tp shard shapes (fused D,
    bf16 grads, as their training runs them). A negative control (the plain side with D zeroed) must
    fail the tolerance, and two launches must be bit-equal. The training,
    pipeline and ring shapes are timed beside the bound, and beside the
    plain version and SDPA's backward (a yardstick only; at the ring
    block the causal mask, which equals striped (1, 0, 4)'s)."""
    cases = {
        "train_causal_gqa": (8, 2048, 16, 4, True, (0, 0, 1), True,
                             torch.bfloat16, 128),
        "offsets_stride_g4_precomputed_d_ragged": (
            2, 1000, 16, 4, True, (0, 3, 2), False, torch.float32, 128),
        "offsets_g1_ragged": (2, 1000, 8, 8, True, (128, 0, 1), True,
                              torch.float32, 128),
        "sp_ring_striped_given_d": (2, 2048, 16, 4, True, (1, 0, 4), False,
                                    torch.float32, 128),
        "moe_causal_gqa": (8, 2048, 8, 4, True, (0, 0, 1), True,
                           torch.bfloat16, 128),
        "pipeline_causal_mha_d64": (4, 2048, 16, 16, True, (0, 0, 1), True,
                                    torch.bfloat16, 64),
        "padded_d32_offsets_stride_given_d": (
            2, 1000, 8, 4, True, (0, 3, 2), False, torch.float32, 32),
        **{label: (*shape, True, (0, 0, 1), True, torch.bfloat16, 64)
           for label, shape in TP_SLICE_SHAPES.items()},
    }
    timed = ("train_causal_gqa", "moe_causal_gqa", "sp_ring_striped_given_d",
             "pipeline_causal_mha_d64", *TP_SLICE_SHAPES)
    beside_plain = ("train_causal_gqa", "moe_causal_gqa",
                    "sp_ring_striped_given_d", "pipeline_causal_mha_d64",
                    *TP_SLICE_SHAPES)
    out = {}
    head_dims = head_dim_generator(torch)
    for label, (b, t, h, kvh, causal, offs, fused, gd, d) in cases.items():
        inputs, run = bwd_case(
            torch, fa, tp_slice_generator(torch) if label in TP_SLICE_SHAPES
            else moe_generator(torch) if label.startswith("moe")
            else head_dims if d != 128 else gen, b, t, h, kvh, causal, offs,
            fused, gd, d)
        q, k, v, g, L, o, D = inputs
        got = run()
        torch.cuda.synchronize()
        want, terms = bwd_plain_terms(torch, fa, q, k, v, g, L, D, offs,
                                      causal)
        res = {"shape": {"B": b, "T": t, "H": h, "KVH": kvh, "D": d,
                         "causal": causal},
               "kernel_head_dim": fa.kernel_head_dim("flash_bwd", d),
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
                              4 if gd == torch.float32 else 2, d))
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
        if label not in beside_plain:
            del inputs
            continue
        qt, kt, vt, gt = (x.permute(0, 2, 1, 3) for x in (q, k, v, g))
        res["plain_ms"] = time_ms(
            torch, lambda: fa._bwd_ref(qt, kt, vt, gt, L, D, offs, causal),
            reps=5)
        res.update(sdpa_backward_ms(torch, F, qt, kt, vt, gt,
                                    sdpa_is_causal(offs, t)))
        del inputs
    return out


def sdpa_is_causal(offsets, t: int) -> bool:
    """The SDPA mask that equals K2's at these offsets on a Tq = Tk = t
    block: causal where the query and key positions step alike from one
    start (the key at or before the query: the home block, and striped
    (1, 0, s), where key j <= query i), none where every key precedes
    every query (an earlier ring block); anything else has no SDPA
    counterpart."""
    q_off, k_off, stride = offsets
    if k_off + stride * (t - 1) <= q_off:
        return False
    if q_off - k_off in range(stride):
        return True
    raise ValueError(f"no SDPA mask for offsets {offsets}")


def sdpa_backward_ms(torch, F, qt, kt, vt, gt, causal: bool,
                     reps: int = 20) -> dict:
    """Yardstick: SDPA's backward on [B,H,T,D] copies of the inputs, with
    ``is_causal`` as given (:func:`sdpa_is_causal`), timed as
    forward+backward minus forward; never called by the port."""
    ql, kl, vl = (x.detach().contiguous().requires_grad_(True)
                  for x in (qt, kt, vt))
    gl = gt.contiguous()
    gqa = kl.shape[1] != ql.shape[1]

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal,
                                           enable_gqa=gqa)

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(
            ql, kl, vl, is_causal=causal, enable_gqa=gqa).backward(gl)

    res = {"library_fwd_bwd_ms": time_ms(torch, sdpa_fwd_bwd, reps=reps),
           "library_fwd_ms": time_ms(torch, sdpa_fwd, reps=reps),
           "library_causal": causal,
           "library_ms_is": "F.scaled_dot_product_attention backward: "
                            "forward+backward minus forward"}
    res["library_ms"] = res["library_fwd_bwd_ms"] - res["library_fwd_ms"]
    del ql, kl, vl, gl
    return res


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


def check_padded_decode_merge(torch, fa):
    """K3 and K4 at head dim 64, which each runs at 128 through the
    wrapper's zero padding (``flash_attention.at_kernel_head_dim``), per
    element against the plain version at head dim 64 with its scale: K3
    at the serve decode shape (B 8, Tq 1, S 2048, 16 / 4 heads) with
    ragged lengths (the decode tolerance), K4 at the ring shape (B 2, Tq =
    Tk = 2048, 16 / 4 heads) folding a striped block (1, 0, 4) into a live
    carry (the merge tolerances). Returns one entry for each in the form
    of ``check_flash_decode``'s and ``check_flash_merge``'s."""
    dev, d = "cuda", 64
    gen = head_dim_generator(torch)
    b, h, kvh, s = 8, 16, 4, 2048
    lengths = torch.tensor([1, 17, 1920, 2048, 1000, 513, 64, 0],
                           dtype=torch.int32, device=dev)
    q = torch.randn(b, 1, h, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(b, s, kvh, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(b, s, kvh, d, generator=gen, device=dev).bfloat16()
    before = fa.launch_counts()["flash_decode"]
    got = fa.flash_decode(q, k, v, lengths)
    torch.cuda.synchronize()
    launches = fa.launch_counts()["flash_decode"] - before
    want = fa._decode_ref(q, k, v, lengths)
    excess = decode_excess(torch, got, want)
    require(launches == 1, f"flash_decode padded_d64: {launches} launches")
    require(excess <= 1.0, f"flash_decode padded_d64: {excess} x its "
                           f"per-element tolerance")
    require(not bool(got[lengths <= 0].any()),
            "flash_decode padded_d64: a row of length 0 is not 0")
    dec = {"shape": {"B": b, "Tq": 1, "H": h, "KVH": kvh, "S": s, "D": d},
           "kernel_head_dim": fa.kernel_head_dim("flash_decode", d),
           "lengths": [int(x) for x in lengths.tolist()],
           "launches_per_call": launches,
           "max_abs_err": max_err(torch, got, want),
           "max_abs_ref": float(want.float().abs().max()),
           "tol": f"per element {DECODE_REL_TOL} * |ref| + "
                  f"{DECODE_ABS_FLOOR}",
           "worst_err_over_tol": excess}
    del q, k, v, got, want
    b, c = 2, 2048
    q, k0, v0, k1, v1 = (
        torch.randn(b, c, heads, d, generator=gen, device=dev).bfloat16()
        for heads in (h, kvh, kvh, kvh, kvh))
    carry = fa.merge_kv_block(q, k0, v0, fa.init_carry(b, h, c, d, device=dev),
                              (1, 2, 4), causal=True)
    got = fa.merge_kv_block(q, k1, v1, carry, (1, 0, 4), causal=True)
    torch.cuda.synchronize()
    want, terms = merge_plain_terms(torch, fa, q, k1, v1, carry, (1, 0, 4),
                                    True)
    o_exc, l_exc, m_exc, rows_agree = merge_excess(torch, fa, q, k1, got,
                                                   want, terms)
    seen = want[2] > fa.NEG_INF / 2
    require(rows_agree and max(o_exc, l_exc, m_exc) <= 1.0,
            f"flash_merge padded_d64: o {o_exc}, l {l_exc}, m {m_exc} x "
            f"their tolerances, rows seen agree {rows_agree}")
    mrg = {"shape": {"B": b, "Tq": c, "Tk": c, "H": h, "KVH": kvh, "D": d,
                     "causal": True},
           "kernel_head_dim": fa.kernel_head_dim("flash_merge", d),
           "offsets": [1, 0, 4], "carry": "a striped (1, 2, 4) merge",
           "max_abs_err_o": float(torch.where(
               seen, (got[0] - want[0]).abs(), 0).max()),
           "max_abs_ref_o": float(torch.where(seen, want[0].abs(), 0).max()),
           "worst_err_over_tol_o": o_exc, "worst_err_over_tol_l": l_exc,
           "worst_err_over_bound_m": m_exc, "rows_seen_agree": rows_agree}
    return dec, mrg


def wide_generator(torch):
    """The wide-head cases (head dims above 128) draw from their own
    generator too."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    return gen


# SDPA's backends in the order tried as the wide-head yardstick: the first
# that accepts a case's head dim is timed.
SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION",
                 "MATH")


def sdpa_yardstick(torch, F, fn_of_sdpa):
    """(ms, backend name, {backend: outcome}) of ``fn_of_sdpa(sdpa)`` under
    the first of :data:`SDPA_BACKENDS` that runs it, timed on CUDA events;
    (None, "none", ...) when none does. A yardstick only: the port never
    calls SDPA."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    outcomes = {}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            outcomes[name] = "not in this torch"
            continue
        try:
            with sdpa_kernel(backend):
                fn_of_sdpa(F.scaled_dot_product_attention)
                torch.cuda.synchronize()
        except RuntimeError as e:
            outcomes[name] = f"refused: {str(e).splitlines()[0][:120]}"
            continue
        with sdpa_kernel(backend):
            ms = time_ms(torch, lambda: fn_of_sdpa(
                F.scaled_dot_product_attention), reps=10)
        outcomes[name] = "timed"
        return ms, name, outcomes
    return None, "none", outcomes


def _zero_block(x, block: int, width: int = 128):
    """``x`` with head-dim columns [block * width, (block + 1) * width)
    zeroed (a copy)."""
    y = x.clone()
    y[..., block * width:(block + 1) * width] = 0
    return y


def wide_clusters(fa, dims):
    """{kernel: {head dim: cluster size, the most clusters the card holds
    at once}} of the four cluster kernels (K1, dq, dkv and K4 wide), from
    their C entry points; each size must be ``fa.wide_cluster_size``'s and
    at least one cluster must fit."""
    import ctypes

    from tpu_operator_torch.kernels import build

    lib = build.library()
    res = {}
    for kernel, name, entry in (
            ("flash_fwd_wide_kernel", "flash_fwd", lib.flash_fwd_wide_cluster),
            ("flash_bwd_dq_wide_kernel", "flash_bwd_dq",
             lib.flash_bwd_dq_wide_cluster),
            ("flash_bwd_dkv_wide_kernel", "flash_bwd",
             lib.flash_bwd_dkv_wide_cluster),
            ("flash_merge_wide_kernel", "flash_merge",
             lib.flash_merge_wide_cluster)):
        res[kernel] = {}
        for d in dims:
            size, active = ctypes.c_int(0), ctypes.c_int(0)
            build.check(entry(fa.kernel_head_dim(fa.CLUSTER_KERNELS[name], d),
                              ctypes.addressof(size),
                              ctypes.addressof(active)), kernel)
            want = fa.wide_cluster_size(name, d)
            require(size.value == want,
                    f"{kernel} at D {d}: cluster of {size.value}, the "
                    f"wrapper expects {want}")
            require(active.value > 0, f"{kernel} at D {d}: no cluster of "
                                      f"{size.value} fits on the card")
            res[kernel][str(d)] = {"cluster_size": size.value,
                                   "max_active_clusters": active.value}
    return res


# K3 wide's cases: (B, Tq, H, KVH, S, D, lengths; None = every row full).
# "a" is the ragged GQA case (at Tq 1 and 4), "b" one layer's
# decode step of the tensor-parallel job's model served on one card (the
# serve_wide phase: MHA, R = group x Tq = 1), "c" the full-length D 256
# case; the rest reach the other cluster sizes (128-column blocks:
# cs = wide_cluster_size(D / 128)), 8 / 1 heads for R = 8, Tq 2 for R = 2,
# and at D 1536 and 1408 more column blocks than a cluster holds (each
# rank streams 2 and 11 blocks of K).
RAGGED_A = [1, 17, 1920, 2048, 1000, 513, 64, 0]
WIDE_DECODE_CASES = {
    "a_d256_ragged_tq1": (8, 1, 8, 2, 2048, 256, RAGGED_A),
    "a_d256_ragged_tq4": (8, 4, 8, 2, 2048, 256, RAGGED_A),
    "b_serve_tp_d1024": (8, 1, 4, 4, 2048, 1024, None),
    "c_d256_full": (8, 1, 8, 2, 2048, 256, None),
    "cluster3_d384": (4, 1, 8, 1, 1024, 384, [1000, 0, 700, 1024]),
    "cluster4_d512_tq2": (4, 2, 4, 4, 1024, 512, [1, 255, 1024, 640]),
    "cluster6_d1536": (2, 1, 4, 2, 1024, 1536, [777, 1024]),
    "cluster1_d1408": (2, 1, 2, 1, 512, 1408, [300, 512]),
}


def decode_cluster(fa, d: int, rows: int):
    """(cluster size, the most such clusters the card holds at once) of K3
    wide at head dim ``d`` and ``rows`` query rows, from its C entry; the
    size must be ``fa.wide_cluster_size``'s and one cluster must fit."""
    import ctypes

    from tpu_operator_torch.kernels import build

    size, active = ctypes.c_int(0), ctypes.c_int(0)
    build.check(build.library().flash_decode_wide_cluster(
        fa.kernel_head_dim("flash_decode", d), rows, ctypes.addressof(size),
        ctypes.addressof(active)), "flash_decode_wide_cluster")
    want = fa.wide_cluster_size("flash_decode", d)
    require(size.value == want, f"flash_decode_wide_kernel at D {d}: "
                                f"cluster of {size.value}, the wrapper "
                                f"expects {want}")
    require(active.value > 0, f"flash_decode_wide_kernel at D {d}: no "
                              f"cluster of {size.value} fits on the card")
    return size.value, active.value


def check_wide_decode(torch, fa, F, gen):
    """K3 wide at :data:`WIDE_DECODE_CASES`: each case per element against
    the plain version with the decode tolerance, a row of length 0 at 0,
    bit-equal across NaN tails, a paged gather, a doubled capacity and a
    rerun (``decode_invariants``), and a negative control that must fail
    (the plain side with V's last 128-column block zeroed: the last
    cluster's last rank). Each timed as device time (torch.profiler) and
    on CUDA events beside its bound (the keys its lengths need), the plain
    version and the first SDPA backend that takes the head dim (with a
    length mask)."""
    dev = "cuda"
    out = {}
    for label, (b, tq, h, kvh, s, d, lens) in WIDE_DECODE_CASES.items():
        lengths = torch.tensor(lens if lens is not None else [s] * b,
                               dtype=torch.int32, device=dev)
        q = torch.randn(b, tq, h, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(b, s, kvh, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, s, kvh, d, generator=gen, device=dev).bfloat16()
        rows = (h // kvh) * tq
        cluster, fits = decode_cluster(fa, d, rows)
        before = fa.launch_counts()["flash_decode"]
        got = fa.flash_decode(q, k, v, lengths)
        torch.cuda.synchronize()
        launches = fa.launch_counts()["flash_decode"] - before
        want = fa._decode_ref(q, k, v, lengths)
        excess = decode_excess(torch, got, want)
        require(launches == 1, f"wide decode {label}: {launches} launches")
        require(excess <= 1.0, f"wide decode {label}: {excess} x its "
                               f"per-element tolerance")
        require(not bool(got[lengths <= 0].any()),
                f"wide decode {label}: a row of length 0 is not 0")
        blk = fa.kernel_head_dim("flash_decode", d) // 128 - 1
        control = decode_excess(torch, got, fa._decode_ref(
            q, k, _zero_block(v, blk), lengths))
        require(control > 1.0, f"wide decode {label}: the zeroed V column "
                               f"block control passed ({control})")
        r = {"shape": {"B": b, "Tq": tq, "H": h, "KVH": kvh, "S": s, "D": d},
             "rows": rows,
             "kernel_head_dim": fa.kernel_head_dim("flash_decode", d),
             "cluster_size": cluster, "max_active_clusters": fits,
             "lengths": [int(x) for x in lengths.tolist()],
             "max_abs_err": max_err(torch, got, want),
             "max_abs_ref": float(want.float().abs().max()),
             "worst_err_over_tol": excess,
             "zeroed_v_column_block": blk,
             "zeroed_v_column_block_control_worst_err_over_tol": control,
             **decode_invariants(torch, fa, gen, q, k, v, lengths, got,
                                 f"wide decode {label}")}
        del want
        keys = int(lengths.clamp(0, s).sum())
        nbytes = 2.0 * (2 * keys * kvh * d + 2 * b * tq * h * d) + 4.0 * b
        flops = 4.0 * keys * tq * h * d
        r["bound_ms"], r["bound_by"] = bound(nbytes, flops, F32_FLOPS)

        def kernel():
            fa.flash_decode(q, k, v, lengths)

        r["event_ms"] = time_ms(torch, kernel, reps=30)
        r["ms"] = kernel_device_ms(torch, kernel, 20, (
            "flash_decode_wide_kernel",))["flash_decode_wide_kernel"]
        r["ms_is"] = "device time (torch.profiler), 20 calls"
        if isinstance(r["ms"], float):
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
        r["plain_ms"] = time_ms(torch, lambda: fa._decode_ref(q, k, v,
                                                              lengths),
                                reps=3)
        qd, kd, vd = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))
        pos = torch.arange(s, device=dev)
        qpos = lengths[:, None] - tq + torch.arange(tq, device=dev)[None]
        mask = (pos[None, None, :] <= qpos[:, :, None]) \
            & (pos[None, None, :] < lengths[:, None, None])
        mask = mask[:, None]  # [B, 1, Tq, S]
        r["library_ms"], r["library"], r["library_backends"] = \
            sdpa_yardstick(torch, F, lambda sdpa: sdpa(
                qd, kd, vd, attn_mask=mask, enable_gqa=kvh != h))
        out[label] = r
        del q, k, v, got, qd, kd, vd
    return out


def check_wide_heads(torch, fa, F):
    """Every kernel at head dims above 128 (the wide path: a grid axis over
    column blocks, 256 columns for K1, dq and K4 and 128 for dkv and K3;
    every wide kernel computes each score tile once per thread-block
    cluster of blocks), per element against its plain
    version with the tolerances of the narrow cases: K1, dq and dkv at the
    tensor-parallel job's shard shape (B 16, T 2048, 1 / 1 head, D 1024,
    causal: clusters of 4 in K1 and dq, 8 in dkv) and at (B 4, T 2048,
    8 / 2 heads, D 256: K1 and dq a cluster of 1), at D 192 (zero-padded
    to 256) with a ragged T (K2 with offsets, a stride, given D and f32
    grads), and at other cluster sizes: D 384 (padded to 512: K1 and dq a
    cluster of 2, dkv of 4) with a ragged T and D 1536 (K1 and dq one
    cluster of 6, dkv two, its K / V streamed), K2 with given D, and K1 at
    D 2304 (three clusters of 3, Q streamed); K3 at
    :data:`WIDE_DECODE_CASES` (:func:`check_wide_decode`); K4 into a live
    carry
    at the ring shape (B 2, Tq = Tk = 2048, 16 / 4 heads, D 256, a
    cluster of 1) folding a striped block, at D 384 with a ragged T 1000
    (padded to 512, a cluster of 2) folding an earlier block at (Tq, 0, 1),
    and at D 1024 (B 1, T 1024, a cluster of 4) folding a stride-2 block.
    Negative controls: the plain side with one 128-column block of V
    zeroed must fail for K1, K2, K3 and K4 (block 1, or for K3 and the
    D 384, 1024 K4, 1536 and 2304 cases the last 128-column block: in the
    last cluster). Each kernel is timed beside its bound, counted from the
    work the case needs, and beside the first SDPA backend that accepts
    the head dim."""
    gen = wide_generator(torch)
    dev = "cuda"
    res = {"fwd": {}, "bwd": {}, "decode": {}, "merge": {},
           "clusters": wide_clusters(fa, (192, 256, 384, 1024, 1536, 2304))}
    for label, (b, t, h, kvh, d, blk) in {
            "tp_shard_d1024": (16, 2048, 1, 1, 1024, 1),
            "gqa_d256": (4, 2048, 8, 2, 256, 1),
            "padded_d192_ragged": (2, 1000, 8, 4, 192, 1),
            "d384_ragged": (2, 1000, 4, 2, 384, 2),
            "two_clusters_d1536": (1, 1024, 2, 1, 1536, 11),
            "three_clusters_d2304": (1, 512, 2, 1, 2304, 17)}.items():
        q = torch.randn(b, t, h, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(b, t, kvh, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, t, kvh, d, generator=gen, device=dev).bfloat16()
        before = fa.launch_counts()["flash_fwd"]
        out, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
        torch.cuda.synchronize()
        launches = fa.launch_counts()["flash_fwd"] - before
        qt, kt, vt = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))
        ref_o, ref_l, terms = fwd_plain_terms(torch, fa, qt, kt, vt, True)
        got = out.permute(0, 2, 1, 3)
        excess = fwd_excess(torch, got, ref_o, terms)
        err_l = max_err(torch, lse, ref_l)
        require(launches == 1, f"wide fwd {label}: {launches} launches")
        require(bool(torch.isfinite(out.float()).all()),
                 f"wide fwd {label}: non-finite output")
        require(excess <= 1.0, f"wide fwd {label}: O {excess} x its "
                               f"per-element tolerance")
        require(err_l <= L_TOL, f"wide fwd {label}: L error {err_l}")
        r = {"shape": {"B": b, "T": t, "H": h, "KVH": kvh, "D": d,
                       "causal": True},
             "kernel_head_dim": fa.kernel_head_dim("flash_fwd", d),
             "cluster_size": fa.wide_cluster_size("flash_fwd", d),
             "max_abs_err_O": max_err(torch, got, ref_o),
             "worst_err_over_tol_O": excess, "max_abs_err_L": err_l}
        if d > 128:
            r["zeroed_v_column_block"] = blk
            ctrl, _, _ = fwd_plain_terms(torch, fa, qt, kt,
                                         _zero_block(vt, blk), True)
            r["zeroed_v_column_block_control_worst_err_over_tol"] = \
                fwd_excess(torch, got, ctrl, terms)
            require(r["zeroed_v_column_block_control_worst_err_over_tol"]
                    > 1.0, f"wide fwd {label}: the zeroed V column block "
                           f"control passed ({r})")
            del ctrl
        del ref_o, terms
        pairs = t * (t + 1) // 2
        flops = 4.0 * b * h * d * pairs
        nbytes = 2.0 * (2 * b * t * h * d + 2 * b * t * kvh * d) \
            + 4.0 * b * h * t
        r["bound_ms"], r["bound_by"] = bound(nbytes, flops, BF16_TC_FLOPS)
        r["ms"] = time_ms(torch, lambda: fa.flash_attention_with_lse(
            q, k, v, causal=True), reps=10)
        r["device_ms"] = kernel_device_ms(
            torch, lambda: fa.flash_attention_with_lse(q, k, v, causal=True),
            5, ("flash_fwd_wide_kernel",))["flash_fwd_wide_kernel"]
        r["plain_ms"] = time_ms(torch, lambda: fa._attn_ref(qt, kt, vt, True),
                                reps=3)
        r["library_ms"], r["library"], r["library_backends"] = sdpa_yardstick(
            torch, F, lambda sdpa: sdpa(qt, kt, vt, is_causal=True,
                                        enable_gqa=kvh != h))
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        r["tflops_required"] = flops / (r["ms"] * 1e-3) / 1e12
        res["fwd"][label] = r
        del q, k, v, qt, kt, vt, out, lse, got

    for label, (b, t, h, kvh, offs, fused, gd, d, blk) in {
            "tp_shard_d1024": (16, 2048, 1, 1, (0, 0, 1), True,
                               torch.bfloat16, 1024, 1),
            "gqa_d256": (4, 2048, 8, 2, (0, 0, 1), True, torch.bfloat16, 256,
                         1),
            "padded_d192_offsets_stride_given_d": (
                2, 1000, 8, 4, (0, 3, 2), False, torch.float32, 192, 1),
            "d384_ragged_given_d": (
                2, 1000, 4, 2, (0, 0, 1), False, torch.float32, 384, 2),
            "two_clusters_d1536_given_d": (
                1, 1024, 2, 1, (0, 0, 1), False, torch.bfloat16, 1536,
                11)}.items():
        inputs, run = bwd_case(torch, fa, gen, b, t, h, kvh, True, offs,
                               fused, gd, d)
        q, k, v, g, L, o, D = inputs
        before = fa.launch_counts()
        got = run()
        torch.cuda.synchronize()
        after = fa.launch_counts()
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            require(after[name] == before[name] + 1,
                    f"wide bwd {label}: {name} launched "
                    f"{after[name] - before[name]} times")
        want, terms = bwd_plain_terms(torch, fa, q, k, v, g, L, D, offs, True)
        r = {"shape": {"B": b, "T": t, "H": h, "KVH": kvh, "D": d,
                       "causal": True},
             "kernel_head_dim": fa.kernel_head_dim("flash_bwd", d),
             "cluster_size_dq": fa.wide_cluster_size("flash_bwd_dq", d),
             "cluster_size_dkv": fa.wide_cluster_size("flash_bwd", d),
             "offsets": list(offs), "fused_d_requested": fused,
             "grad_dtype": str(gd).replace("torch.", "")}
        for name, gg, ww, aa in zip(("dq", "dk", "dv"), got, want, terms):
            require(gg.dtype == gd and bool(torch.isfinite(gg.float()).all()),
                    f"wide bwd {label}: {name} dtype or non-finite")
            excess = bwd_excess(torch, gg, ww, aa)
            r[name] = {"max_abs_err": max_err(torch, gg, ww),
                       "max_abs_ref": float(ww.abs().max()),
                       "worst_err_over_tol": excess}
            require(excess <= 1.0, f"wide bwd {label}: {name} {excess} x "
                                   f"its tolerance")
        del want, terms
        if d > 128:
            r["zeroed_v_column_block"] = blk
            ctrl, cterms = bwd_plain_terms(torch, fa, q, k,
                                           _zero_block(v, blk), g, L, D,
                                           offs, True)
            r["zeroed_v_column_block_control_worst_err_over_tol"] = max(
                bwd_excess(torch, gg, ww, aa)
                for gg, ww, aa in zip(got, ctrl, cterms))
            require(r["zeroed_v_column_block_control_worst_err_over_tol"]
                    > 1.0, f"wide bwd {label}: the zeroed V column block "
                           f"control passed ({r})")
            del ctrl, cterms
        del got
        r.update(bwd_bounds(torch, b, t, t, h, kvh, True, offs, fused,
                            4 if gd == torch.float32 else 2, d))
        r["ms_pair"] = time_ms(torch, run, reps=5)
        per = kernel_device_ms(torch, run, 3, ("flash_bwd_dq_wide_kernel",
                                               "flash_bwd_dkv_wide_kernel"))
        r["ms_dq"] = per["flash_bwd_dq_wide_kernel"]
        r["ms_dkv"] = per["flash_bwd_dkv_wide_kernel"]  # one launch a call
        for name in ("dq", "dkv"):
            if isinstance(r[f"ms_{name}"], float):
                r[f"share_of_bound_{name}"] = r[f"bound_ms_{name}"] \
                    / r[f"ms_{name}"]
        qt, kt, vt, gt = (x.permute(0, 2, 1, 3) for x in (q, k, v, g))
        r["plain_ms"] = time_ms(
            torch, lambda: fa._bwd_ref(qt, kt, vt, gt, L, D, offs, True),
            reps=3)
        if offs == (0, 0, 1):
            ql, kl, vl = (x.detach().contiguous().requires_grad_(True)
                          for x in (qt, kt, vt))
            gl = gt.contiguous()

            def fwd_bwd(sdpa):
                sdpa(ql, kl, vl, is_causal=True,
                     enable_gqa=kvh != h).backward(gl)

            def fwd_only(sdpa):
                with torch.no_grad():
                    sdpa(ql, kl, vl, is_causal=True, enable_gqa=kvh != h)

            fb, backend, outcomes = sdpa_yardstick(torch, F, fwd_bwd)
            r["library_backends"] = outcomes
            r["library"] = backend
            if fb is not None:
                from torch.nn.attention import SDPBackend, sdpa_kernel

                with sdpa_kernel(getattr(SDPBackend, backend)):
                    fo = time_ms(torch, lambda: fwd_only(
                        F.scaled_dot_product_attention), reps=10)
                r["library_ms"] = fb - fo
            else:
                r["library_ms"] = None
            r["library_ms_is"] = ("SDPA backward: forward+backward minus "
                                  "forward, the first backend that runs")
            del ql, kl, vl, gl
        res["bwd"][label] = r
        del inputs, q, k, v, g, L, o, D, qt, kt, vt, gt

    res["decode"] = check_wide_decode(torch, fa, F, gen)

    for label, (b, tq, tk, h, kvh, d, home, offs, blk, reps) in {
            "ring_d256": (2, 2048, 2048, 16, 4, 256, (1, 2, 4), (1, 0, 4), 1,
                          20),
            "cluster2_d384_ragged": (2, 1000, 1000, 4, 2, 384,
                                     (1000, 1000, 1), (1000, 0, 1), 2, 5),
            "cluster4_d1024_stride2": (1, 1024, 1024, 2, 1, 1024, (1, 1, 2),
                                       (1, 0, 2), 7, 5)}.items():
        q = torch.randn(b, tq, h, d, generator=gen, device=dev).bfloat16()
        k0, v0, k1, v1 = (
            torch.randn(b, tk, kvh, d, generator=gen, device=dev).bfloat16()
            for _ in range(4))
        carry = fa.merge_kv_block(q, k0, v0,
                                  fa.init_carry(b, h, tq, d, device=dev),
                                  home, causal=True)
        before = fa.launch_counts()["flash_merge"]
        got = fa.merge_kv_block(q, k1, v1, carry, offs, causal=True)
        torch.cuda.synchronize()
        launches = fa.launch_counts()["flash_merge"] - before
        want, terms = merge_plain_terms(torch, fa, q, k1, v1, carry, offs,
                                        True)
        o_exc, l_exc, m_exc, rows_agree = merge_excess(torch, fa, q, k1, got,
                                                       want, terms)
        require(launches == 1, f"wide merge {label}: {launches} launches")
        require(rows_agree and max(o_exc, l_exc, m_exc) <= 1.0,
                f"wide merge {label}: o {o_exc}, l {l_exc}, m {m_exc} x "
                f"their tolerances, rows seen agree {rows_agree}")
        ctrl, _ = merge_plain_terms(torch, fa, q, k1, _zero_block(v1, blk),
                                    carry, offs, True)
        control = merge_excess(torch, fa, q, k1, got, ctrl, terms)[0]
        require(control > 1.0, f"wide merge {label}: the zeroed V column "
                               f"block control passed ({control})")
        seen = want[2] > fa.NEG_INF / 2
        r = {"shape": {"B": b, "Tq": tq, "Tk": tk, "H": h, "KVH": kvh,
                       "D": d},
             "kernel_head_dim": fa.kernel_head_dim("flash_merge", d),
             "cluster_size": fa.wide_cluster_size("flash_merge", d),
             "offsets": list(offs), "carry": f"a causal merge at {home}",
             "max_abs_err_o": float(torch.where(
                 seen, (got[0] - want[0]).abs(), 0).max()),
             "worst_err_over_tol_o": o_exc, "worst_err_over_tol_l": l_exc,
             "worst_err_over_bound_m": m_exc, "rows_seen_agree": rows_agree,
             "zeroed_v_column_block": blk,
             "zeroed_v_column_block_control_worst_err_over_tol_o": control}
        del ctrl, want, terms, got

        def merge():
            fa.merge_kv_block(q, k1, v1, carry, offs, causal=True)

        q_pos = offs[0] + offs[2] * torch.arange(tq, device=dev)
        k_pos = offs[1] + offs[2] * torch.arange(tk, device=dev)
        pairs = int((q_pos[:, None] >= k_pos[None, :]).sum())
        flops = 4.0 * b * h * d * pairs
        nbytes = 2.0 * (b * tq * h * d + 2 * b * tk * kvh * d) \
            + 2 * 4.0 * b * h * tq * (d + 2)
        r["bound_ms"], r["bound_by"] = bound(nbytes, flops, BF16_TC_FLOPS)
        r["ms"] = time_ms(torch, merge, reps=reps)
        r["device_ms"] = kernel_device_ms(torch, merge, 10 if reps > 5 else 3,
                                          ("flash_merge_wide_kernel",)
                                          )["flash_merge_wide_kernel"]
        r["plain_ms"] = time_ms(torch, lambda: fa._merge_ref(
            *(x.permute(0, 2, 1, 3) for x in (q, k1, v1)), *carry, offs,
            True), reps=5 if reps > 5 else 2)
        r["library_ms"] = None
        r["library"] = "none: no single PyTorch call folds a carry"
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        res["merge"][label] = r
        del q, k0, v0, k1, v1, carry
    return res


def parallel_generator(torch):
    """The cases at the Ulysses and SP x TP phases' shapes draw from their
    own generator too."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    return gen


def _zero_keys(x, keys: int = 1024):
    """``x`` [B, T, H, D] with its first ``keys`` key positions zeroed (a
    copy): the negative control of the parallel-shape cases."""
    y = x.clone()
    y[:, :keys] = 0
    return y


def _head_slices(b: int, h: int, kvh: int, tq: int, tk: int):
    """(batch row, query heads, K/V heads) slices small enough that the
    plain side's [heads, Tq, Tk] f32 scores stay under 1 GiB: one batch row
    and as many whole GQA groups as fit."""
    group = h // kvh
    per = kvh
    while per > 1 and (kvh % per or group * per * tq * tk * 4 > 2 ** 30):
        per -= 1
    for i in range(b):
        for j in range(0, kvh, per):
            yield (slice(i, i + 1), slice(j * group, (j + per) * group),
                   slice(j, j + per))


def check_parallel_shapes(torch, fa, F):
    """K1, dq, dkv and K4 per element against their plain versions at the
    shapes the ulysses and sp_tp phases give them, each case with a
    negative control (the plain side with V's first 1024 keys zeroed must
    fail):

    - ulysses: one process holds all four shards of the SP bench row, so
      the exchange hands the kernels the slab (B 2, T 8192, 16 / 4 heads,
      D 128, causal): K1, then dq / dkv with fused D and bf16 grads as
      ``flash_attention``'s backward runs them;
    - sp_tp: each TP shard's ring over 4096-token chunks (B 8, 8 / 8
      heads, D 128, contiguous layout): K4 folding shard 0's block into
      shard 1's live carry (offsets (4096, 0, 1) after the home block at
      (4096, 4096, 1)), and dq / dkv at the same two offsets with D given
      and f32 grads, as the backward ring runs them.

    The plain side runs a batch row and a few GQA groups at a time (the
    scores of the whole slab would take tens of GB). Each case is timed
    beside its bound and the plain version; K1 at the Ulysses slab and K2
    at every case also beside SDPA (a yardstick only; the earlier SP x TP
    block with no mask, as every key precedes every query)."""
    gen = parallel_generator(torch)
    dev = "cuda"
    res = {}

    def fwd_worst(got, qt, kt, vt, causal):
        """(worst O excess, worst L error, largest O error) of K1's (O, L)
        over the slices."""
        out, lse = got
        b, h, t, _d = qt.shape
        worst_o = worst_l = err_o = 0.0
        for bs, hs, ks in _head_slices(b, h, kt.shape[1], t, t):
            ref_o, ref_l, terms = fwd_plain_terms(
                torch, fa, qt[bs, hs], kt[bs, ks], vt[bs, ks], causal)
            mine = out[bs, :, hs].permute(0, 2, 1, 3)
            worst_o = max(worst_o, fwd_excess(torch, mine, ref_o, terms))
            worst_l = max(worst_l, max_err(torch, lse[bs, hs], ref_l))
            err_o = max(err_o, max_err(torch, mine, ref_o))
            del ref_o, ref_l, terms
        return worst_o, worst_l, err_o

    # Ulysses: K1 on the slab.
    b, t, h, kvh, d = 2, 8192, 16, 4, 128
    q = torch.randn(b, t, h, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(b, t, kvh, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(b, t, kvh, d, generator=gen, device=dev).bfloat16()
    before = fa.launch_counts()["flash_fwd"]
    got = fa.flash_attention_with_lse(q, k, v, causal=True)
    torch.cuda.synchronize()
    require(fa.launch_counts()["flash_fwd"] - before == 1,
            "ulysses fwd: not one launch")
    require(bool(torch.isfinite(got[0].float()).all()),
            "ulysses fwd: non-finite output")
    qt, kt, vt = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    o_exc, l_err, o_err = fwd_worst(got, qt, kt, vt, True)
    require(o_exc <= 1.0, f"ulysses fwd: O {o_exc} x its tolerance")
    require(l_err <= L_TOL, f"ulysses fwd: L error {l_err}")
    ctrl = fwd_worst(got, qt, kt, _zero_keys(v).permute(0, 2, 1, 3),
                     True)[0]
    require(ctrl > 1.0, f"ulysses fwd: the zeroed-keys control passed "
                        f"({ctrl})")
    pairs = t * (t + 1) // 2
    flops = 4.0 * b * h * d * pairs
    nbytes = 2.0 * (2 * b * t * h * d + 2 * b * t * kvh * d) + 4.0 * b * h * t
    r = {"shape": {"B": b, "T": t, "H": h, "KVH": kvh, "D": d,
                   "causal": True},
         "max_abs_err_O": o_err, "worst_err_over_tol_O": o_exc,
         "max_abs_err_L": l_err,
         "zeroed_keys_control_worst_err_over_tol": ctrl}
    r["bound_ms"], r["bound_by"] = bound(nbytes, flops, BF16_TC_FLOPS)
    r["ms"] = time_ms(torch, lambda: fa.flash_attention_with_lse(
        q, k, v, causal=True), reps=10)
    qc, kc, vc = (x.contiguous() for x in (qt, kt, vt))
    r["plain_ms"] = time_ms(torch, lambda: fa._attn_ref(qc, kc, vc, True),
                            reps=3)
    r["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qc, kc, vc, is_causal=True, enable_gqa=True), reps=10)
    r["share_of_bound"] = r["bound_ms"] / r["ms"]
    res["ulysses_fwd"] = r
    del q, k, v, qt, kt, vt, qc, kc, vc, got

    def bwd_worst(got, q, k, v, g, L, D, offs):
        """(worst excess, largest error) of each of (dq, dk, dv) over the
        slices."""
        b, tq, h, _d = q.shape
        kvh, tk = k.shape[2], k.shape[1]
        worst, errs = [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]
        for bs, hs, ks in _head_slices(b, h, kvh, tq, tk):
            want, terms = bwd_plain_terms(
                torch, fa, q[bs, :, hs], k[bs, :, ks], v[bs, :, ks],
                g[bs, :, hs], L[bs, hs], D[bs, hs], offs, True)
            mine = (got[0][bs, :, hs], got[1][bs, :, ks], got[2][bs, :, ks])
            for i, (gg, ww, aa) in enumerate(zip(mine, want, terms)):
                worst[i] = max(worst[i], bwd_excess(torch, gg, ww, aa))
                errs[i] = max(errs[i], max_err(torch, gg, ww))
            del want, terms
        return worst, errs

    def bwd_check(label, b, t, h, kvh, offs, fused, gd):
        inputs, run = bwd_case(torch, fa, gen, b, t, h, kvh, True, offs,
                               fused, gd)
        q, k, v, g, L, o, D = inputs
        before = fa.launch_counts()
        got = run()
        torch.cuda.synchronize()
        after = fa.launch_counts()
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            require(after[name] == before[name] + 1,
                    f"{label}: {name} launched {after[name] - before[name]} "
                    f"times")
        for name, x in zip(("dq", "dk", "dv"), got):
            require(x.dtype == gd and bool(torch.isfinite(x.float()).all()),
                    f"{label}: {name} dtype or non-finite")
        worst, errs = bwd_worst(got, q, k, v, g, L, D, offs)
        for name, x in zip(("dq", "dk", "dv"), worst):
            require(x <= 1.0, f"{label}: {name} {x} x its tolerance")
        ctrl = max(bwd_worst(got, q, k, _zero_keys(v), g, L, D, offs)[0])
        require(ctrl > 1.0, f"{label}: the zeroed-keys control passed "
                            f"({ctrl})")
        r = {"shape": {"B": b, "T": t, "H": h, "KVH": kvh, "D": 128,
                       "causal": True},
             "offsets": list(offs), "fused_d": fused,
             "grad_dtype": str(gd).replace("torch.", ""),
             **{f"worst_err_over_tol_{n}": x
                for n, x in zip(("dq", "dk", "dv"), worst)},
             **{f"max_abs_err_{n}": x
                for n, x in zip(("dq", "dk", "dv"), errs)},
             "zeroed_keys_control_worst_err_over_tol": ctrl}
        r.update(bwd_bounds(torch, b, t, t, h, kvh, True, offs, fused,
                            4 if gd == torch.float32 else 2))
        r["ms_pair"] = time_ms(torch, run, reps=5)
        per = kernel_device_ms(torch, run, 3, ("flash_bwd_dq_kernel",
                                               "flash_bwd_dkv_kernel"))
        for name in ("dq", "dkv"):
            ms = per[f"flash_bwd_{name}_kernel"]
            r[f"ms_{name}"] = ms
            if isinstance(ms, float):
                r[f"share_of_bound_{name}"] = r[f"bound_ms_{name}"] / ms
        qt, kt, vt, gt = (x.permute(0, 2, 1, 3) for x in (q, k, v, g))
        r["plain_ms"] = time_ms(
            torch, lambda: fa._bwd_ref(qt, kt, vt, gt, L, D, offs, True),
            reps=3)
        r.update(sdpa_backward_ms(torch, F, qt, kt, vt, gt,
                                  sdpa_is_causal(offs, t), reps=5))
        del got, inputs, q, k, v, g, L, o, D, qt, kt, vt, gt
        return r

    res["ulysses_bwd"] = bwd_check("ulysses bwd", 2, 8192, 16, 4,
                                   (0, 0, 1), True, torch.bfloat16)
    # SP x TP: one TP shard's ring over 4096-token chunks; shard 1's
    # queries against its home block and against shard 0's.
    b, c, h, kvh = 8, 4096, 8, 8
    for label, offs in (("sp_tp_bwd_home", (c, c, 1)),
                        ("sp_tp_bwd_earlier", (c, 0, 1))):
        res[label] = bwd_check(label.replace("_", " "), b, c, h, kvh, offs,
                               False, torch.float32)

    q, k0, v0, k1, v1 = (
        torch.randn(b, c, heads, d, generator=gen, device=dev).bfloat16()
        for heads in (h, kvh, kvh, kvh, kvh))
    carry = fa.merge_kv_block(q, k1, v1, fa.init_carry(b, h, c, d, device=dev),
                              (c, c, 1), causal=True)
    before = fa.launch_counts()["flash_merge"]
    got = fa.merge_kv_block(q, k0, v0, carry, (c, 0, 1), causal=True)
    torch.cuda.synchronize()
    require(fa.launch_counts()["flash_merge"] - before == 1,
            "sp_tp merge: not one launch")

    def merge_worst(vv):
        """(worst o / l / m excess, largest o error on the rows seen, the
        rows seen agree) over the slices."""
        worst, err_o = [0.0, 0.0, 0.0], 0.0
        agree = True
        for bs, hs, ks in _head_slices(b, h, kvh, c, c):
            part = tuple(x[bs, hs] for x in carry)
            want, terms = merge_plain_terms(torch, fa, q[bs, :, hs],
                                            k0[bs, :, ks], vv[bs, :, ks],
                                            part, (c, 0, 1), True)
            mine = tuple(x[bs, hs] for x in got)
            *exc, rows = merge_excess(torch, fa, q[bs, :, hs], k0[bs, :, ks],
                                      mine, want, terms)
            worst = [max(a, e) for a, e in zip(worst, exc)]
            agree = agree and rows
            seen = want[2] > fa.NEG_INF / 2
            err_o = max(err_o, float(torch.where(
                seen, (mine[0] - want[0]).abs(), 0).max()))
            del want, terms
        return worst, err_o, agree

    (o_exc, l_exc, m_exc), o_err, agree = merge_worst(v0)
    require(agree and max(o_exc, l_exc, m_exc) <= 1.0,
            f"sp_tp merge: o {o_exc}, l {l_exc}, m {m_exc} x their "
            f"tolerances, rows seen agree {agree}")
    ctrl = merge_worst(_zero_keys(v0))[0][0]
    require(ctrl > 1.0, f"sp_tp merge: the zeroed-keys control passed "
                        f"({ctrl})")
    r = {"shape": {"B": b, "Tq": c, "Tk": c, "H": h, "KVH": kvh, "D": d},
         "offsets": [c, 0, 1], "carry": f"the home block at ({c}, {c}, 1)",
         "max_abs_err_o": o_err,
         "worst_err_over_tol_o": o_exc, "worst_err_over_tol_l": l_exc,
         "worst_err_over_bound_m": m_exc, "rows_seen_agree": agree,
         "zeroed_keys_control_worst_err_over_tol_o": ctrl}
    flops = 4.0 * b * h * d * c * c
    nbytes = 2.0 * (b * c * h * d + 2 * b * c * kvh * d) \
        + 2 * 4.0 * b * h * c * (d + 2)
    r["bound_ms"], r["bound_by"] = bound(nbytes, flops, BF16_TC_FLOPS)
    r["ms"] = time_ms(torch, lambda: fa.merge_kv_block(
        q, k0, v0, carry, (c, 0, 1), causal=True), reps=10)
    r["plain_ms"] = time_ms(torch, lambda: fa._merge_ref(
        *(x.permute(0, 2, 1, 3) for x in (q, k0, v0)), *carry, (c, 0, 1),
        True), reps=3)
    r["share_of_bound"] = r["bound_ms"] / r["ms"]
    res["sp_tp_merge"] = r
    del q, k0, v0, k1, v1, carry, got
    torch.cuda.empty_cache()
    return res


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


# --- phase: serve ------------------------------------------------------------


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


# The serve cells' flags: the flagship GQA LM (serve), and the
# tensor-parallel job's model (examples/tpujob-tensor-parallel.yml's
# widths: dim 4096, 16 layers, 4 heads, MHA, vocab 256; head dim 1024)
# served whole on one card (serve_wide).
SERVE_CELL_COMMON = ["--batch", "8", "--window", "1920", "--decode-tokens",
                     "128", "--page-size", "16", "--load", "8:1",
                     "--queue-deadline", "600", "--seed", "0", "--device",
                     "cuda", "--checkpoint-dir", ""]
SERVE_FLAGSHIP = ["--vocab", "32768", "--dim", "2048", "--heads", "16",
                  "--kv-heads", "4", "--layers", "8"]
SERVE_WIDE = ["--dim", "4096", "--layers", "16", "--heads", "4",
              "--kv-heads", "0", "--vocab", "256"]


def run_serve(torch, fa, serve, bootstrap, widths=SERVE_FLAGSHIP):
    """A full-width ServeLoop at ``widths`` under the serve cells' load and
    one HTTP request: launch counts, nothing shed or failed, first-token
    logits against the plain path."""
    port = free_port()
    argv = [*SERVE_CELL_COMMON, *widths, "--http-port", str(port)]
    args = serve.parse_args(argv)
    info = bootstrap.process_info_from_env({})
    loop = serve.ServeLoop(args, info, heartbeat=None, recorder=None)
    http_prompt = serve_http_prompt(args.vocab)
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
        "argv": argv,
        "summary": summary,
        "launches": counts,
        "prefills": cache.prefills,
        "decode_steps": cache.decode_steps,
        "http_tokens": len(http_tokens),
        "http_answer": http_tokens,
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


def profile_engine(torch, loop, steps: int = 10, names=()):
    """Where full-width prefill and decode time goes: one admission, then
    (all 8 slots admitted) ``steps`` decode steps, each under
    torch.profiler (device time by kernel) beside the host clock around
    the synchronised call; for each of ``names``, a decode step's device
    ms and launches of the kernels whose name holds it."""
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
    rows = _device_rows(torch, prof, steps)
    decode = _breakdown(rows, statistics.median(wall))
    if names:
        decode["by_name"] = {
            name: {"ms": sum(ms for key, ms, _n in rows if name in key),
                   "calls": sum(n for key, _ms, n in rows if name in key)}
            for name in names}
    return {"prefill": {"prompt_tokens": args.window, **prefill},
            "decode_step": {"slots": args.batch, "context_tokens": context,
                            "steps": steps, **decode}}


def run_serve_wide(torch, fa, serve, bootstrap):
    """serve_wide: the tensor-parallel job's model (head dim 1024, 3.2B
    params) served on one card at the serve cell's load: the prefill runs
    K1 wide and every decode step K3 wide, once a layer (run_serve's
    gates), R = 1 (MHA, Tq 1). Then profile_engine's admission and ten
    decode steps under torch.profiler: the step's wall and device time by
    kernel, the idle share and K3 wide's share of the device time. The
    peak memory is the phase's (the caller resets it before)."""
    res, loop = run_serve(torch, fa, serve, bootstrap, SERVE_WIDE)
    args = loop.args
    require(args.dim // args.heads > 128 and args.kv_heads == 0,
            f"serve_wide: head dim {args.dim // args.heads}, kv heads "
            f"{args.kv_heads}: not the wide MHA path")
    prof = profile_engine(torch, loop, names=("flash_decode_wide_kernel",))
    step = prof["decode_step"]
    k3 = step["by_name"]["flash_decode_wide_kernel"]
    require(k3["calls"] > 0, f"serve_wide: the profiled decode steps "
                             f"recorded no K3 wide ({step})")
    # The profiler may keep fewer launches than ran (PERF.md): one launch's
    # time over the launches it recorded, times the layers.
    k3_ms = k3["ms"] / k3["calls"] * args.layers
    busy = step["device_busy_ms"]
    res["profile"] = prof
    res["decode_step_wall_ms"] = step["wall_ms_median"]
    res["decode_step_device_ms"] = busy
    res["decode_step_idle_share"] = step["device_idle_share"]
    res["k3_wide_ms_per_step"] = k3_ms
    res["k3_wide_share_of_device"] = (k3_ms / busy
                                      if isinstance(busy, float) else None)
    res["k3_wide_ms_per_launch"] = k3_ms / args.layers
    res["k3_wide_launches_recorded_per_step"] = k3["calls"]
    del loop
    return res


# --- phase: serve_pod --------------------------------------------------------


def serve_http_prompt(vocab: int) -> list:
    """The serve phase's HTTP prompt: 1000 tokens from a seeded draw."""
    import numpy as np

    rng = np.random.default_rng(7)
    return [int(x) for x in rng.integers(0, vocab, 1000)]


def recorded_requests(loop) -> list:
    """Every request ``loop`` queues (HTTP, synthetic or direct)."""
    reqs = []
    real = loop.submit

    def submit(*a, **kw):
        req = real(*a, **kw)
        if req is not None:
            reqs.append(req)
        return req

    loop.submit = submit
    return reqs


def replay_greedy(loop, prompts_and_budgets) -> list:
    """Each (prompt, budget)'s greedy tokens through ``loop``'s card 0
    engine (idle), up to its slot count at a time in slots 0.. (a
    one-card server's decode of those requests)."""
    import numpy as np

    eng, model, slots = loop.engine, loop.model, loop.args.batch
    out = []
    for first in range(0, len(prompts_and_budgets), slots):
        group = prompts_and_budgets[first:first + slots]
        toks = []
        for slot, (prompt, budget) in enumerate(group):
            admitted, token = eng.admit(slot, prompt, budget, model)
            require(admitted, "replay: the one-card pool refused a request")
            toks.append([int(token)])
        while True:
            live = [s for s, (_p, n) in enumerate(group) if len(toks[s]) < n]
            if not live:
                break
            active = np.zeros(slots, bool)
            active[live] = True
            step = eng.step(model, active)
            for s in live:
                toks[s].append(int(step[s]))
        for slot in range(len(group)):
            eng.release(slot)
        out.extend(toks)
    return out


def pod_burst(vocab: int, window: int, n: int, seed: int) -> list:
    """``n`` prompts of seeded lengths (half the window to the whole) and
    tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(window // 2, window + 1))
                         ).astype(np.int32) for _ in range(n)]


def gate_pod_counts(label, per_card, layers):
    """Each card's K1 launches = layers x its admissions (prefills) and
    K3 = layers x its decode steps, both non-zero."""
    for c in per_card:
        k1, k3 = c["launches"]["flash_fwd"], c["launches"]["flash_decode"]
        require(k1 == layers * c["prefills"] > 0,
                f"{label}: card {c['card']} launched K1 {k1} times for "
                f"{c['prefills']} admissions x {layers} layers")
        require(k3 == layers * c["decodeSteps"] > 0,
                f"{label}: card {c['card']} launched K3 {k3} times for "
                f"{c['decodeSteps']} decode steps x {layers} layers")


def logged_serve_cards(lines) -> list:
    """The ``serve card c: {...}`` lines a serve process logs at its exit
    (the launcher's ``[card 0]`` prefix on each)."""
    return [json.loads(ln.split("serve card ", 1)[1].split(": ", 1)[1])
            for _t, ln in card_log(lines, 0) if "serve card " in ln]


def logged_serve_summary(lines) -> dict:
    """steps, completed, arrivals, shed and failed steps from a serve
    process's summary line."""
    for _t, ln in card_log(lines, 0):
        m = re.search(r"serve: (\d+) steps, (\d+)/(\d+) requests completed "
                      r"\((\d+) shed\), (\S+) tokens/sec, (\d+) reloads, "
                      r"(\d+) failed steps", ln)
        if m:
            keys = ("steps", "completed", "arrivals", "shed",
                    "tokensPerSecond", "reloads", "failedSteps")
            return {k: float(v) if k == "tokensPerSecond" else int(v)
                    for k, v in zip(keys, m.groups())}
    raise SmokeFailure("no serve summary line in the log")


def run_serve_pod_launcher(torch, answer) -> dict:
    """serve_pod (a): the pod launcher as the container's entry point,
    ``python -m tpu_operator_torch.payload.launch -- serve`` with the serve
    cell's flags at 8 slots a card (``--batch 8 x C``: on one card the
    cell's own flags) on every card this machine has, one HTTP request
    with the serve phase's prompt: exit 0, its 128 tokens bit-equal to
    the serve phase's ``answer``, nothing shed or failed, and each card's
    K1 / K3 counts (logged by the serve process at its exit) layers x its
    admissions / decode steps."""
    cards = torch.cuda.device_count()
    port = free_port()
    payload = ["serve", *with_flag(SERVE_CELL_COMMON, "--batch",
                                   str(8 * cards)),
               *SERVE_FLAGSHIP, "--http-port", str(port)]
    http = {}
    poster = threading.Thread(
        target=post_decode, daemon=True,
        args=(port, serve_http_prompt(int(_flag(SERVE_FLAGSHIP, "--vocab"))),
              128, http))
    poster.start()
    t0 = time.perf_counter()
    code, lines = _streamed([sys.executable, "-m", LAUNCH_MODULE, "--",
                             *payload],
                            {**_launch_env(), "TPUJOB_SERVE": "1"},
                            timeout=600)
    wall = time.perf_counter() - t0
    poster.join(timeout=60)
    tail = "\n".join(ln for _t, ln in lines[-30:])
    require(code == 0, f"serve_pod: the launcher exited {code}\n{tail}")
    require(http.get("status") == 200,
            f"serve_pod: HTTP decode through the launcher failed: {http}")
    require(http["body"]["tokens"] == answer,
            "serve_pod: the launcher's pod answered the serve phase's "
            "prompt with other tokens")
    summary = logged_serve_summary(lines)
    require(summary["shed"] == 0 and summary["failedSteps"] == 0
            and summary["completed"] == summary["arrivals"] + 1,
            f"serve_pod: the launcher's pod {summary}")
    per_card = logged_serve_cards(lines)
    require([c["card"] for c in per_card] == list(range(cards)),
            f"serve_pod: {len(per_card)} card lines for {cards} cards")
    gate_pod_counts("serve_pod launcher",
                    per_card, int(_flag(SERVE_FLAGSHIP, "--layers")))
    return {"payload": payload, "cards": cards, "exit": code,
            "wall_s": wall, "summary": summary, "per_card": per_card,
            "launches": _logged_launches("\n".join(
                ln for _t, ln in card_log(lines, 0))),
            "http_tokens_bit_equal_to_serve": True,
            "spawned_at_s": _seconds_to(lines, "card process(es)"),
            "ready_at_s": _seconds_to(lines, "HTTP ingress on port")}


SERVE_POD_HTTP = 2


def run_serve_pod_engines(torch, fa, serve, bootstrap, one_card, answer):
    """serve_pod (b): ``ServeLoop(devices=[cuda:0, cuda:0])`` at the serve
    cell's flags with ``--batch 16``: two card engines of 8 slots on this
    card, stepped in turn by the loop, the pool split with the slots, one
    ingress. A burst of 16 requests (every slot), the cell's
    load and two HTTP requests (one the serve phase's prompt). Launch
    counts zeroed just before the run and read just after. Gates: nothing
    shed or failed, both engines served, each engine's K1 / K3 launches
    (by its launch scope) layers x its admissions / decode steps, and
    every request's tokens bit-equal to the serve phase's one-engine,
    8-slot server's (``one_card``) for the same prompt."""
    dev = torch.device("cuda", 0)
    port = free_port()
    argv = [*with_flag(SERVE_CELL_COMMON, "--batch", "16"), *SERVE_FLAGSHIP,
            "--http-port", str(port)]
    args = serve.parse_args(argv)
    loop = serve.ServeLoop(args, bootstrap.process_info_from_env({}),
                           heartbeat=None, recorder=None, store=None,
                           devices=[dev, dev])
    reqs = recorded_requests(loop)
    burst = [loop.submit(p, args.decode_tokens)
             for p in pod_burst(args.vocab, args.window, 16, seed=11)]
    prompts = [serve_http_prompt(args.vocab),
               [int(x) for x in pod_burst(args.vocab, args.window, 1,
                                          seed=12)[0]]]
    http = [{} for _ in range(SERVE_POD_HTTP)]
    posters = [threading.Thread(target=post_decode, daemon=True,
                                args=(port, p, 128, r))
               for p, r in zip(prompts, http)]
    for t in posters:
        t.start()
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    summary = loop.run()
    torch.cuda.synchronize()
    counts = fa.launch_counts()
    per_card = [{**c, "launches": fa.launch_counts(scope=c["card"])}
                for c in summary["cards"]]
    for t in posters:
        t.join(timeout=60)
    require(all(r.get("status") == 200 for r in http),
            f"serve_pod engines: HTTP decode failed: {http}")
    require(http[0]["body"]["tokens"] == answer,
            "serve_pod engines: the serve phase's prompt got other tokens")
    require(summary["shed"] == 0 and summary["failedSteps"] == 0,
            f"serve_pod engines: shed {summary['shed']}, failed "
            f"{summary['failedSteps']}")
    require(summary["completed"] == summary["arrivals"] + len(burst)
            + len(http) == len(reqs),
            f"serve_pod engines: completed {summary['completed']} of "
            f"{len(reqs)}")
    require([c["slots"] for c in per_card] == [8, 8]
            and all(c["completed"] > 0 for c in per_card),
            f"serve_pod engines: {per_card}")
    gate_pod_counts("serve_pod engines", per_card, args.layers)
    require(counts["flash_fwd"] == sum(c["launches"]["flash_fwd"]
                                       for c in per_card)
            and counts["flash_decode"] == sum(
                c["launches"]["flash_decode"] for c in per_card),
            f"serve_pod engines: {counts} launched outside the engines")
    t0 = time.perf_counter()
    want = replay_greedy(one_card, [(r.prompt, r.max_tokens) for r in reqs])
    replay_s = time.perf_counter() - t0
    differ = [i for i, (r, w) in enumerate(zip(reqs, want))
              if r.tokens != w]
    require(not differ, f"serve_pod engines: {len(differ)} of {len(reqs)} "
                        f"requests' tokens differ from the one-engine "
                        f"server's (first: request {differ[:1]})")
    del loop
    gc.collect()  # the loop's HTTP server holds cycles to it
    return {"argv": argv, "summary": summary, "launches": counts,
            "per_card": per_card, "requests": len(reqs),
            "tokens_bit_equal_to_one_engine": True,
            "replay_s": replay_s}


def run_serve_pod(torch, fa, serve, bootstrap, one_card, answer):
    """serve_pod: (a) the launcher's pod on every card, in a subprocess
    started first, and while it starts (b) two engines on this card in
    this process (the launcher's readings include that overlap)."""
    t0 = time.perf_counter()
    launched = {}

    def launcher():
        try:
            launched["result"] = run_serve_pod_launcher(torch, answer)
        except BaseException as e:  # noqa: BLE001 — raised below
            launched["error"] = e

    thread = threading.Thread(target=launcher, daemon=True)
    thread.start()
    engines = run_serve_pod_engines(torch, fa, serve, bootstrap, one_card,
                                    answer)
    thread.join(timeout=900)
    if "error" in launched:
        raise launched["error"]
    require("result" in launched, "serve_pod: the launcher did not end")
    return {"engines": engines, "launcher": launched["result"],
            "launches": engines["launches"],
            "wall_s": time.perf_counter() - t0,
            "nvidia_smi": nvidia_smi_line()}


# examples/torch/gpujob-serve.yml's payload line as written, and the finite
# schedule ``--serve-cards`` runs in place of its ``--load 200:0`` (200
# requests/s held forever: the run must end).
GPUJOB_SERVE_PAYLOAD = ["serve", "--load", "200:0", "--batch", "8",
                        "--kv-heads", "2"]
SERVE_CARDS_LOAD = "100:2"


def serve_cards_payload() -> list:
    return with_flag(GPUJOB_SERVE_PAYLOAD, "--load", SERVE_CARDS_LOAD)


def timed_steps(loop) -> dict:
    """Wrap each card's engine.step with the host clock (the step ends in
    the argmax's copy to the host, so it is fenced): card -> [ms]."""
    walls = {}
    for card in loop.cards:
        real, ms = card.engine.step, walls.setdefault(card.index, [])

        def step(*a, _real=real, _ms=ms, **kw):
            t0 = time.perf_counter()
            out = _real(*a, **kw)
            _ms.append(1e3 * (time.perf_counter() - t0))
            return out

        card.engine.step = step
    return walls


def serve_cell_on(torch, fa, serve, bootstrap, cards: int) -> dict:
    """The serve cell at flagship widths on ``cards`` cards with 8 slots
    a card: a burst of 8 x cards requests (every slot), the cell's load and
    4 x cards concurrent HTTP requests. Returns the summary, the requests,
    the per-card launch counts (by launch scope), each card's decode-step
    walls, the pod steps' walls and each card's peak memory."""
    torch.cuda.init()
    devices = [torch.device("cuda", c) for c in range(cards)]
    port = free_port()
    argv = [*with_flag(SERVE_CELL_COMMON, "--batch", str(8 * cards)),
            *SERVE_FLAGSHIP, "--http-port", str(port)]
    args = serve.parse_args(argv)
    for d in devices:
        torch.cuda.reset_peak_memory_stats(d)
    loop = serve.ServeLoop(args, bootstrap.process_info_from_env({}),
                           heartbeat=None, recorder=None, store=None,
                           devices=devices)
    reqs = recorded_requests(loop)
    walls = timed_steps(loop)
    burst = [loop.submit(p, args.decode_tokens)
             for p in pod_burst(args.vocab, args.window, 8 * cards,
                                seed=21)]
    prompts = pod_burst(args.vocab, args.window, 4 * cards, seed=22)
    http = [{} for _ in prompts]
    posters = [threading.Thread(target=post_decode, daemon=True,
                                args=(port, [int(x) for x in p], 128, r))
               for p, r in zip(prompts, http)]
    for t in posters:
        t.start()
    for d in devices:
        torch.cuda.synchronize(d)
    fa.reset_launch_counts()
    summary = loop.run()
    for d in devices:
        torch.cuda.synchronize(d)
    per_card = [{**c, "launches": fa.launch_counts(scope=c["card"])}
                for c in summary["cards"]]
    for t in posters:
        t.join(timeout=60)
    require(all(r.get("status") == 200 for r in http),
            f"serve cell on {cards} cards: HTTP decode failed")
    require(summary["shed"] == 0 and summary["failedSteps"] == 0
            and summary["completed"] == summary["arrivals"] + len(burst)
            + len(http) == len(reqs),
            f"serve cell on {cards} cards: {summary}")
    require(all(c["completed"] > 0 for c in per_card),
            f"serve cell on {cards} cards: a card served nothing")
    gate_pod_counts(f"serve cell on {cards} cards", per_card, args.layers)
    return {"loop": loop, "summary": summary, "requests": reqs,
            "per_card": per_card,
            "step_ms_median": [statistics.median(walls[c.index])
                               for c in loop.cards],
            "peak_gb": [torch.cuda.max_memory_allocated(d) / 1e9
                        for d in devices]}


def serve_cards(world: int) -> int:
    """``--serve-cards N``: (a) examples/torch/gpujob-serve.yml's payload
    line through the pod launcher as one pod of N cards, its ``--load
    200:0`` (held forever) replaced by ``SERVE_CARDS_LOAD``: exit 0,
    nothing shed or failed, an engine on every card, each card's K1 / K3
    counts (card 0 admits at each arrival, so a light load may leave the
    others their warm-up alone).
    (b) The serve cell at flagship widths with ``--batch 8N`` on the N
    cards in this process, then on one card with ``--batch 8`` (the
    burst, load and HTTP requests scaled with the slots): the gates of
    ``serve_cell_on``, and every request of the pod bit-equal to the
    one-card server's tokens for its prompt. Readings: the pod's
    tokens/s beside the one card's, each card's decode-step wall and
    peak memory."""
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"chip_smoke: --serve-cards {world} needs {world} CUDA "
              f"cards", file=sys.stderr)
        return 1
    from tpu_operator_torch.payload import bootstrap
    from tpu_operator_torch.payload import flash_attention as fa
    from tpu_operator_torch.payload import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__})
    payload = serve_cards_payload()
    t0 = time.perf_counter()
    code, lines = _streamed(
        [sys.executable, "-m", LAUNCH_MODULE, "--cards", str(world), "--",
         *payload], {**_launch_env(), "TPUJOB_SERVE": "1"}, timeout=900)
    wall = time.perf_counter() - t0
    if code != 0:
        emit({"phase": "failed", "error": f"launcher exit {code}",
              "tail": [ln for _t, ln in lines[-40:]]})
        return 1
    summary = logged_serve_summary(lines)
    per_card = logged_serve_cards(lines)
    args = serve.parse_args(payload[1:])
    emit({"phase": "serve_cards_example", "payload": payload,
          "load_replaced": {"written": "200:0", "ran": SERVE_CARDS_LOAD},
          "launcher_wall_s": wall, "summary": summary,
          "per_card": per_card})
    require(summary["shed"] == 0 and summary["failedSteps"] == 0
            and summary["completed"] == summary["arrivals"] > 0,
            f"the example's pod: {summary}")
    require([c["card"] for c in per_card] == list(range(world)),
            f"the example's pod: {per_card}")
    gate_pod_counts("the example's pod", per_card, args.layers)
    pod = serve_cell_on(torch, fa, serve, bootstrap, world)
    del pod["loop"]
    gc.collect()  # the loop's HTTP server holds cycles to it
    torch.cuda.empty_cache()
    one = serve_cell_on(torch, fa, serve, bootstrap, 1)
    reqs = pod.pop("requests")
    t1 = time.perf_counter()
    want = replay_greedy(one["loop"], [(r.prompt, r.max_tokens)
                                       for r in reqs])
    differ = [i for i, (r, w) in enumerate(zip(reqs, want))
              if r.tokens != w]
    one.pop("loop")
    one.pop("requests")
    emit({"phase": "serve_cards", "cards": world,
          "pod_tokens_per_s": pod["summary"]["tokensPerSecond"],
          "one_card_tokens_per_s": one["summary"]["tokensPerSecond"],
          "speedup": pod["summary"]["tokensPerSecond"]
          / one["summary"]["tokensPerSecond"],
          "pod_step_ms_median_by_card": pod["step_ms_median"],
          "one_card_step_ms_median": one["step_ms_median"][0],
          "pod_peak_gb_by_card": pod["peak_gb"],
          "one_card_peak_gb": one["peak_gb"][0],
          "pod": pod, "one_card": one,
          "requests_checked": len(reqs), "requests_differing": len(differ),
          "replay_s": time.perf_counter() - t1, "nvidia_smi": smi})
    require(not differ, f"{len(differ)} of {len(reqs)} requests' tokens "
                        f"differ from one card's")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# --- phase: train ------------------------------------------------------------


# The flagship GQA LM's widths and batch (bench.py:636-647), full depth.
FLAGSHIP_ARGV = ["--batch", "32", "--seq-len", "2048", "--grad-accum", "4",
                 "--vocab", "32768", "--dim", "2048", "--heads", "16",
                 "--kv-heads", "4", "--layers", "8", "--seed", "0",
                 "--log-every", "0", "--device", "cuda",
                 "--checkpoint-dir", "", "--profile-dir", ""]
# bench.py:636 lm_flagship_gqa_kv4 as written.
TRAIN_ARGV = ["--steps", "6", *FLAGSHIP_ARGV, "--remat", "--remat-policy",
              "dots_attn", "--adam-mu-dtype", "bf16"]


def drive_train(torch, fa, train, built, args, label, wanted):
    """``args.steps`` steps of ``built`` through train.train_loop, launch
    counters zeroed just before the loop and read just after; every kernel
    in ``wanted`` must have run exactly that many times. Every loss finite,
    the first within [ln V, ln V + 2]. Returns the loop's readings."""
    import math

    kept, starts = [], []

    def step(batch):
        starts.append(time.perf_counter())
        metrics = built.step(batch)
        kept.append(metrics)  # stays on the card until the end
        return metrics

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    start_memory = torch.cuda.memory_allocated() / 1e9
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    last = train.train_loop(step, built.batches, args.steps,
                            device=built.device)
    torch.cuda.synchronize()
    end = time.perf_counter()
    counts = fa.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    trajectory = [float(m["loss"]) for m in kept]
    others = {k: [float(m[k]) for m in kept] for k in kept[0]
              if k != "loss"} if kept else {}
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
            **({"metric_trajectories": others} if others else {}),
            "loop_seconds": end - t0,
            "step_seconds": [b - a for a, b in zip(starts,
                                                    starts[1:] + [end])],
            "peak_memory_gb": peak, "start_memory_gb": start_memory}


def run_train(torch, fa, transformer, train, data):
    """The flagship GQA LM at full width (bench.py:636 as written: remat
    under dots_attn), 6 steps of global batch 32 x 2048 as 4 microbatches
    of 8, through
    transformer.build and train.train_loop. The plain cross-check runs
    before the loop, on the seeded init, and after it, on the trained
    weights (see gate_train_plain for what each gates). Launch counters
    are zeroed just before the loop and read just after: K1 and K2 once
    per layer per microbatch (dots_attn saves K1's outputs, so the
    backward does not re-run it), the merge kernel never."""
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
        "model": "lm_flagship_gqa_kv4 (bench.py:636), as written",
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


# --- phase: fsdp -------------------------------------------------------------


# The train cell (TRAIN_ARGV) with --fsdp, in one process: data 1.
FSDP_ARGV = [*TRAIN_ARGV, "--fsdp"]
# What the fsdp phase may peak above the train phase: about two blocks'
# gathered f32 weights (a gathered copy that is never freed adds ~2 GB).
FSDP_PEAK_SLACK_GB = 1.5


def run_fsdp(torch, fa, transformer, train, reference):
    """The train cell with ``--fsdp`` (FSDP_ARGV) in one process, data 1:
    every leaf is an FSDP shard of one part, so the gathers (a cast each),
    the saved-tensor hooks that keep a shard in place of a gathered weight
    and gather it again in the backward, the recompute's gathers under
    dots_attn and the per-microbatch reduce-scatter seam all run at full
    width, with K1 and K2 as custom ops and the bf16 first moment. Gated
    against ``reference`` (the train phase's reading): the loss trajectory
    bit-equal (at data 1 every sum keeps its order), K1, dq and dkv
    launched as often, the peak memory within FSDP_PEAK_SLACK_GB of it,
    each peak counted above the memory allocated when its loop starts (the
    model and optimizer state, the same in both; what earlier phases left
    allocated is not the step's)."""
    args = transformer.parse_args(FSDP_ARGV)
    built = transformer.build(args)
    shards = [p for p in built.model.parameters()
              if getattr(p, "fsdp", None) is not None]
    require(len(shards) == len(list(built.model.parameters())),
            f"fsdp: {len(shards)} shards of "
            f"{len(list(built.model.parameters()))} params (every leaf of "
            f"the flagship has >= 1024 elements)")
    per_path = args.layers * args.grad_accum * args.steps
    wanted = {"flash_fwd": per_path, "flash_bwd_dq": per_path,
              "flash_bwd_dkv": per_path, "flash_merge": 0}
    loop = drive_train(torch, fa, train, built, args, "fsdp", wanted)
    for name in wanted:
        require(loop["launches"][name] == reference["launches"][name],
                f"fsdp: {name} launched {loop['launches'][name]} times, the "
                f"train phase {reference['launches'][name]}")
    require(loop["loss_trajectory"] == reference["loss_trajectory"],
            f"fsdp: losses {loop['loss_trajectory']} are not the train "
            f"phase's {reference['loss_trajectory']}")
    extra = (loop["peak_memory_gb"] - loop["start_memory_gb"]) \
        - (reference["peak_memory_gb"] - reference["start_memory_gb"])
    require(extra <= FSDP_PEAK_SLACK_GB,
            f"fsdp: peak {loop['peak_memory_gb']:.2f} GB from "
            f"{loop['start_memory_gb']:.2f} at the loop's start, {extra:.2f} "
            f"GB above the train phase's rise")
    step_ms = 1e3 * statistics.median(loop["step_seconds"][1:4])
    train_ms = 1e3 * statistics.median(reference["step_seconds"][1:4])
    print(f"fsdp step ms (median of steps 1-3): {step_ms:.1f} "
          f"(train {train_ms:.1f})", flush=True)
    print(f"fsdp peak memory GB: {loop['peak_memory_gb']:.3f} from "
          f"{loop['start_memory_gb']:.3f} at the loop's start (train "
          f"{reference['peak_memory_gb']:.3f} from "
          f"{reference['start_memory_gb']:.3f})", flush=True)
    del built
    return {"argv": FSDP_ARGV, "shards": len(shards), **loop,
            "step_ms": step_ms, "train_step_ms": train_ms,
            "rise_above_train_gb": extra,
            "losses_bit_equal_to_train": True}


# --- phase: launch -------------------------------------------------------------


LAUNCH_MODULE = "tpu_operator_torch.payload.launch"


def _streamed(cmd, env, on_line=None, timeout=900):
    """Run ``cmd`` from the checkout, reading its merged output as it
    comes: (exit code, [(seconds since the start, line)]). ``on_line(proc,
    line)`` sees each line as it arrives."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    timer = threading.Timer(timeout, proc.kill)
    timer.start()
    lines = []
    try:
        for line in proc.stdout:
            lines.append((time.perf_counter() - t0, line.rstrip("\n")))
            if on_line is not None:
                on_line(proc, line)
        code = proc.wait()
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return code, lines


def card_log(lines, card):
    """The lines of card ``card``, its ``[card c]`` prefix taken off."""
    prefix = f"[card {card}] "
    return [(t, ln[len(prefix):]) for t, ln in lines
            if ln.startswith(prefix)]


def logged_losses(lines):
    """The loss trajectory from a transformer log (``lines`` of (t,
    line)): after step 1 the loop logs step k with step k - 1's loss (its
    fence), and the last step's as ``final``."""
    steps, final = {}, None
    for _t, ln in lines:
        m = re.search(r" step (\d+) loss (\S+)$", ln)
        if m:
            steps[int(m.group(1))] = float(m.group(2))
        m = re.search(r" final: loss (\S+)$", ln)
        if m:
            final = float(m.group(1))
    require(steps and final is not None, "no logged losses")
    return [steps[1]] + [steps[k] for k in range(3, max(steps) + 1)] \
        + [final]


def _launch_env():
    """A one-pod job's operator env (rank 0 of 1 on a free local port)."""
    return _payload_env({
        "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{free_port()}",
        "JAX_PROCESS_ID": "0", "JAX_NUM_PROCESSES": "1",
        "TPUJOB_ATTEMPT": "0"})


def _seconds_to(lines, text):
    """Seconds from the command's start to its first line holding
    ``text``."""
    for t, ln in lines:
        if text in ln:
            return t
    raise SmokeFailure(f"no {text!r} in the log")


def run_launch(torch, transformer, reference):
    """The train cell through the pod launcher as one pod of one card
    (``python -m tpu_operator_torch.payload.launch --cards 1 --
    transformer ...``, every step logged in full) with a checkpoint dir,
    SIGTERM to the launcher once card 0 logs step 4 (which carries step
    3's loss). Gates: the launcher exits 143, the card drained at one
    step k and saved it; the first 3 losses bit-equal to the train
    phase's (``reference``); K1, dq and dkv launched layers x
    microbatches x k times (the card process's own count, logged at its
    exit). Before it, the payload run directly for one step: the time to
    the first step of each, from the process's start to its first step's
    log line, with the launcher's start of the card process and each
    process's model built (its ``training`` line) beside it."""
    import shutil
    import tempfile

    argv = with_flags(TRAIN_ARGV, steps=100, log_every=1)
    args = transformer.parse_args(argv)
    code, direct_lines = _streamed(
        [sys.executable, "-m", "tpu_operator_torch.payload.transformer",
         *with_flags(argv, steps=1)], _launch_env())
    require(code == 0, f"launch: the direct run exited {code}")
    direct = _seconds_to(direct_lines, " step 1 loss ")
    direct_built = _seconds_to(direct_lines, " training ")
    ck = tempfile.mkdtemp(prefix="launch-ck-")
    sent = []

    def sigterm_after_step_4(proc, line):
        if not sent and line.startswith("[card 0] ") \
                and " step 4 loss " in line:
            proc.send_signal(signal.SIGTERM)
            sent.append(time.perf_counter())

    try:
        code, lines = _streamed(
            [sys.executable, "-m", LAUNCH_MODULE, "--cards", "1", "--",
             "transformer", *with_flags(argv, checkpoint_dir=ck,
                                        checkpoint_every=1000000)],
            _launch_env(), on_line=sigterm_after_step_4)
        log = card_log(lines, 0)
        drained = [ln for _t, ln in log
                   if "drain: checkpointed step " in ln]
        require(sent and code == 143 and drained,
                f"launch: SIGTERM after step 4 gave exit {code}\n"
                + "\n".join(ln for _t, ln in lines[-30:]))
        step = int(drained[0].split("drain: checkpointed step ", 1)[1]
                   .split(",")[0])
        require(os.path.isdir(os.path.join(ck, str(step))),
                f"launch: no checkpoint of the drained step {step} in "
                f"{sorted(os.listdir(ck))}")
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    steps = {int(m.group(1)): float(m.group(2)) for m in (
        re.search(r" step (\d+) loss (\S+)$", ln) for _t, ln in log) if m}
    losses = [steps[1], steps[3], steps[4]]
    require(losses == reference["loss_trajectory"][:3],
            f"launch: losses {losses} are not the train phase's first 3 "
            f"{reference['loss_trajectory'][:3]}")
    counts = _logged_launches("\n".join(ln for _t, ln in log))
    per_path = args.layers * args.grad_accum * step
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        require(counts[name] == per_path,
                f"launch: {name} launched {counts[name]} times in {step} "
                f"steps, wanted {per_path}")
    through = _seconds_to(log, " step 1 loss ")
    spawned = _seconds_to(lines, "card process(es)")
    built = _seconds_to(log, " training ")
    print(f"launch: time to first step {through:.2f} s through the "
          f"launcher (card process started at {spawned:.2f} s, its model "
          f"built at {built:.2f} s), {direct:.2f} s direct (model built "
          f"at {direct_built:.2f} s)", flush=True)
    return {"argv": argv, "launches": counts,
            "loss_trajectory": losses,
            "losses_bit_equal_to_train": True,
            "first_step_s_through_launcher": through,
            "first_step_s_direct": direct,
            "launcher_spawns_card_at_s": spawned,
            "model_built_at_s_through_launcher": built,
            "model_built_at_s_direct": direct_built,
            "first_step_is": "seconds from the process's start to its "
                             "first step's log line (kernel library "
                             "built; warm file cache)",
            "sigterm": {"exit": code, "drained_at_step": step,
                        "checkpoint_of_that_step": True},
            "nvidia_smi": nvidia_smi_line()}


# --- phase: checkpoint -------------------------------------------------------


# One flagship training checkpoint: f32 params (1.96 GB) + bf16 adam mu
# (0.98 GB) + f32 nu (1.96 GB). Three are kept (max_to_keep).
CKPT_BYTES = 4.9e9
CKPT_MIN_FREE = 3 * CKPT_BYTES


def _ckpt_drive(torch, train, steptrace, built, steps, ck):
    """``built`` through train.train_loop to ``steps`` total, with the
    checkpointer ``ck`` (or none) and a flight recorder; returns the
    losses of the steps this run trained (host floats, bit-exact), the
    loop's seconds and the recorder's rows."""
    losses = []

    def step(*batch):
        metrics = built.step(*batch)
        losses.append(metrics["loss"])  # stays on the card until the end
        return metrics

    rec = steptrace.StepRecorder()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train.train_loop(step, built.batches, steps, device=built.device,
                     heartbeat=None, steptrace=rec, checkpointer=ck,
                     state=built.state)
    torch.cuda.synchronize()
    return [float(x) for x in losses], time.perf_counter() - t0, \
        rec.snapshot()


def _state_mismatches(torch, got, want) -> list:
    """Names of the tensors (params, the optimizer state's entries) that
    are not bit-equal between two TrainStates."""
    bad = [n for n, p in want.params.items()
           if not torch.equal(got.params[n], p)]
    mine, theirs = got.opt.state_dict(), want.opt.state_dict()
    bad += [n for n, t in theirs.items()
            if n not in mine or mine[n].dtype != t.dtype
            or not torch.equal(mine[n], t)]
    return bad


def _save_reading(timings: dict) -> dict:
    """One save's stages, with the background write's and hash's rates."""
    out = dict(timings)
    total = sum(out.get("bytes", {}).values())
    if total and out.get("write_s"):
        out["write_gb_per_s"] = total / 1e9 / out["write_s"]
    if total and out.get("manifest_s"):
        out["hash_gb_per_s"] = total / 1e9 / out["manifest_s"]
    return out


def run_checkpoint(torch, fa, transformer, train, serve, bootstrap,
                   checkpoint, steptrace):
    """Checkpoint, resume and serve restore of the flagship at full width
    and depth (TRAIN_ARGV), in a ``tempfile.mkdtemp()`` directory:

    - U, an unbroken 6-step run from the seeded init, no checkpointer;
    - A, a fresh build, 3 steps with a Checkpointer (save_every 3): saves
      1 (the attempt's first) and 3, ends with step 3 verified;
    - B, a fresh build at TPUJOB_ATTEMPT=1 to step 6: restores 3 (gated
      bit-equal to A's state in memory), fast-forwards 3 batches, trains
      4-6 (launch counts zeroed just before and read just after: K1 and
      K2 layers x microbatches x 3, K4 never) and saves 6; its losses and
      final params are gated bit-equal to U's;
    - a ServeLoop over the directory at the serve phase's widths: it must
      load step 6 with params bit-equal to B's (in its bf16 / f32
      storage) and answer one HTTP decode and a short synthetic load with
      nothing shed or failed;
    - last, one byte flipped in step 6's params: the next restore must
      quarantine it (6.corrupt-0), fall back to step 3 and count one
      fallback."""
    import shutil
    import tempfile

    import numpy as np

    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    attempt_env = os.environ.get("TPUJOB_ATTEMPT")
    try:
        free = shutil.disk_usage(ckdir).free
        require(free >= CKPT_MIN_FREE,
                f"checkpoint phase: {free / 1e9:.1f} GB free under "
                f"{os.path.dirname(ckdir)}, needs {CKPT_MIN_FREE / 1e9:.1f} "
                f"GB (three {CKPT_BYTES / 1e9} GB steps); set TMPDIR to a "
                f"larger volume")
        args = transformer.parse_args(TRAIN_ARGV)
        total, first = args.steps, args.steps // 2

        unbroken = transformer.build(args)
        u_losses, u_seconds, _rows = _ckpt_drive(torch, train, steptrace,
                                                 unbroken, total, None)
        u_params = {n: p.detach().clone()
                    for n, p in unbroken.model.named_parameters()}
        # The unbroken run's end state on the host, for warm_restart.
        u_state = {"losses": u_losses,
                   "params": {n: p.cpu() for n, p in u_params.items()},
                   "opt": {n: t.detach().cpu().clone() for n, t in
                           unbroken.opt_state.state_dict().items()}}
        del unbroken
        torch.cuda.empty_cache()

        os.environ["TPUJOB_ATTEMPT"] = "0"
        run_a = transformer.build(args)
        ck_a = checkpoint.Checkpointer(ckdir, save_every=first)
        a_losses, a_seconds, a_rows = _ckpt_drive(torch, train, steptrace,
                                                  run_a, first, ck_a)
        ck_a.close()
        require(ck_a.last_verified_step() == first,
                f"run A: last verified step {ck_a.last_verified_step()}, "
                f"wanted {first}")
        require(a_losses == u_losses[:first],
                f"run A's losses {a_losses} != the unbroken run's "
                f"{u_losses[:first]}")
        run_a.model.zero_grad(set_to_none=True)

        os.environ["TPUJOB_ATTEMPT"] = "1"
        run_b = transformer.build(args)
        ck_b = checkpoint.Checkpointer(ckdir, save_every=first)
        restored = {}
        real_restore = ck_b.restore

        def restore_and_compare(state):
            state, start = real_restore(state)
            torch.cuda.synchronize()
            restored["start"] = start
            restored["mismatches"] = _state_mismatches(torch, state,
                                                       run_a.state)
            return state, start

        ck_b.restore = restore_and_compare
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        b_losses, b_seconds, b_rows = _ckpt_drive(torch, train, steptrace,
                                                  run_b, total, ck_b)
        counts = fa.launch_counts()
        ck_b.close()
        require(restored.get("start") == first,
                f"run B restored step {restored.get('start')}, wanted "
                f"{first}")
        require(not restored["mismatches"],
                f"run B's restored state differs from run A's at step "
                f"{first}: {restored['mismatches'][:8]}")
        require(ck_b.last_verified_step() == total,
                f"run B: last verified step {ck_b.last_verified_step()}")
        require(b_losses == u_losses[first:],
                f"resumed losses {b_losses} != the unbroken run's "
                f"{u_losses[first:]} (bit-equal gate)")
        params_off = [n for n, p in run_b.model.named_parameters()
                      if not torch.equal(p, u_params[n])]
        require(not params_off,
                f"resumed final params differ from the unbroken run's: "
                f"{params_off[:8]}")
        per_path = args.layers * args.grad_accum * (total - first)
        for name, want in (("flash_fwd", per_path),
                           ("flash_bwd_dq", per_path),
                           ("flash_bwd_dkv", per_path),
                           ("flash_merge", 0)):
            require(counts[name] == want,
                    f"run B: {name} launched {counts[name]} times, wanted "
                    f"{want}")
        del run_a, u_params
        torch.cuda.empty_cache()

        # The server reads step 6's params, at the serve phase's widths
        # (its position table, window + decode tokens, is the trainer's
        # sequence).
        port = free_port()
        sargs = serve.parse_args([
            "--batch", "8", "--window", "1920", "--decode-tokens", "128",
            "--page-size", "16", "--vocab", "32768", "--dim", "2048",
            "--heads", "16", "--kv-heads", "4", "--layers", "8",
            "--load", "2:1", "--queue-deadline", "600", "--seed", "0",
            "--http-port", str(port), "--device", "cuda",
            "--checkpoint-dir", ckdir])
        loop = serve.ServeLoop(sargs, bootstrap.process_info_from_env({}),
                               heartbeat=None, recorder=None)
        serve_restore = {}
        real_weights = loop._restore_weights

        def timed_restore_weights():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step = real_weights()
            torch.cuda.synchronize()
            serve_restore["seconds"] = time.perf_counter() - t0
            return step

        loop._restore_weights = timed_restore_weights
        rng = np.random.default_rng(11)
        http_prompt = [int(x) for x in rng.integers(
            0, sargs.vocab, min(500, sargs.window))]
        http_new = min(16, sargs.decode_tokens)
        http_result: dict = {}
        poster = threading.Thread(
            target=post_decode,
            args=(port, http_prompt, http_new, http_result), daemon=True)
        poster.start()
        summary = loop.run()
        poster.join(timeout=60)
        require(summary["loadedStep"] == total
                and loop.serving_wire()["loadedStep"] == total,
                f"server loaded step {summary['loadedStep']}, wanted "
                f"{total}")
        require(http_result.get("status") == 200
                and len(http_result["body"]["tokens"]) == http_new,
                f"HTTP decode from the restored server failed: "
                f"{http_result}")
        require(summary["shed"] == 0 and summary["failedSteps"] == 0,
                f"server shed {summary['shed']}, failed steps "
                f"{summary['failedSteps']}")
        trained = dict(run_b.model.named_parameters())
        served_off = [n for n, p in loop.model.named_parameters()
                      if not torch.equal(p, trained[n].detach().to(p.dtype))]
        require(not served_off,
                f"served params differ from run B's: {served_off[:8]}")
        served_dtypes = sorted({str(p.dtype) for p in
                                loop.model.parameters()})
        del loop
        torch.cuda.empty_cache()

        # Negative control, last: one flipped byte in step 6's params.
        victim = os.path.join(ckdir, str(total), checkpoint.PARAMS_FILE)
        with open(victim, "r+b") as f:
            f.seek(os.path.getsize(victim) // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0xFF]))
        ck_n = checkpoint.Checkpointer(ckdir)
        _state, back = ck_n.restore(run_b.state)
        require(back == first and ck_n.restore_fallbacks == 1
                and os.path.isdir(os.path.join(
                    ckdir, f"{total}{checkpoint.QUARANTINE_SUFFIX}-0")),
                f"corrupted step {total}: restore came back at {back} with "
                f"{ck_n.restore_fallbacks} fallbacks")
        left = sorted(os.listdir(ckdir))
        del run_b
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
        if attempt_env is None:
            os.environ.pop("TPUJOB_ATTEMPT", None)
        else:
            os.environ["TPUJOB_ATTEMPT"] = attempt_env

    def stalls(rows):
        return {r["step"] + 1: r["checkpoint"] * 1e3 for r in rows
                if "checkpoint" in r}

    return {
        "model": "lm_flagship_gqa_kv4 (bench.py:636), as written",
        "argv": TRAIN_ARGV,
        "dir_free_gb_before": free / 1e9,
        "loss_trajectory_unbroken": u_losses,
        "loss_trajectory_resumed": b_losses,
        "losses_and_params_bit_equal": True,
        "restored_state_bit_equal": True,
        "launches_run_b": counts,
        "saves": {"run_a": [_save_reading(t) for t in ck_a.save_timings],
                  "run_b": [_save_reading(t) for t in ck_b.save_timings]},
        "step_loop_checkpoint_lap_ms": {"run_a": stalls(a_rows),
                                        "run_b": stalls(b_rows)},
        "loop_seconds": {"unbroken_6": u_seconds, "run_a_3": a_seconds,
                         "run_b_4_to_6": b_seconds},
        "restore_run_b": ck_b.restore_timings,
        "serve": {"loaded_step": summary["loadedStep"],
                  "params_only_load_s": serve_restore.get("seconds"),
                  "param_dtypes": served_dtypes,
                  "completed": summary["completed"],
                  "arrivals": summary["arrivals"], "shed": summary["shed"],
                  "failed_steps": summary["failedSteps"],
                  "http_tokens": len(http_result["body"]["tokens"])},
        "negative_control": {"restored_step": back,
                             "restore_fallbacks": ck_n.restore_fallbacks,
                             "dir_after": left,
                             "restore": ck_n.restore_timings},
        "nvidia_smi": nvidia_smi_line(),
    }, u_state


# bench.py:661 lm_longctx_T8192_gqa as written, plus the ring.
SP_TRAIN_ARGV = ["--steps", "4", "--batch", "8", "--seq-len", "8192",
                 "--grad-accum", "4", "--adam-mu-dtype", "bf16",
                 "--remat", "--remat-policy", "dots_attn",
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
    as written, remat under dots_attn) with --seq-parallel 4 --sp-layout
    striped: 4 steps of global batch 8 x 8192 as 4 microbatches of 2, the
    whole ring of 4 shards in this one process, through transformer.build
    and train.train_loop. Before the loop, one row's loss and gradients on
    the ring are held against the single-shard kernel path. Launch
    counters are zeroed just before the loop and read just after: both
    backward kernels N^2 = 16 times per layer per microbatch, the merge
    kernel twice that (no policy names the ring's outputs, so the
    backward re-runs the forward ring, as the reference's does), K1
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
                       {"flash_merge": 2 * per_path,
                        "flash_bwd_dq": per_path,
                        "flash_bwd_dkv": per_path, "flash_fwd": 0})
    return {
        "model": "lm_longctx_T8192_gqa (bench.py:661), as written",
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
            D = fa.row_dot(g, out)
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


def plain_attend(fa):
    """Per-layer plain attention (``_attn_ref``) on [B,T,H,D] tensors."""
    def attend(q, k, v):
        out, _ = fa._attn_ref(q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3),
                              v.permute(0, 2, 1, 3), True)
        return out.permute(0, 2, 1, 3)

    return lambda _i: attend


def check_train_plain(torch, fa, transformer, train, model, tokens,
                      pin=None):
    """One microbatch (``tokens``, 2 rows), on the card: the loss and every
    parameter's gradient of four sides on the same weights:
    - ``kernels``: K1 forward, K2 backward (the training path);
    - ``plain``: plain attention (``_attn_ref``) under autograd;
    - ``plain_bf16_d``: the plain forward and the plain backward with D
      from its bf16 O: against ``plain``, the part of the gap that comes
      from taking D from the bf16 O, in plain arithmetic;
    - ``k1_plain_bwd``: K1's forward and the plain backward with D from
      K1's bf16 O: against ``kernels``, K2's own roundings alone.
    ``pin(side)``, when given, is a context each side runs in (the MoE
    phase's :class:`RoutePin`: the first side's routes for all four)."""
    import contextlib

    def loss_and_grads(name, attend_for_layer):
        model.zero_grad(set_to_none=True)
        with pin(name) if pin else contextlib.nullcontext():
            loss = train.next_token_nll(
                model(tokens, None, attend_for_layer), tokens)
            loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return float(loss.detach()), grads

    sides = {"kernels": transformer._causal_attend,
             "plain": plain_attend(fa),
             "plain_bf16_d": plain_backward_attend(torch, fa, False),
             "k1_plain_bwd": plain_backward_attend(torch, fa, True)}
    runs = {name: loss_and_grads(name, attend)
            for name, attend in sides.items()}
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


# --- phase: remat ------------------------------------------------------------


# How many times each policy runs K1 per layer and microbatch: the forward,
# and again in the backward unless the policy saves the flash_fwd op's
# outputs.
REMAT_K1_RUNS = {None: 1, "full": 2, "dots": 2, "dots_attn": 1,
                 "dots_attn_gelu": 1, "attn": 1, "attn_block": 1}


def run_remat(torch, fa, transformer, train, models):
    """lm_flagship_gqa_kv4 as written (bench.py:636) but for its policy,
    2 steps without remat and under each of the six --remat-policy
    values, each a fresh transformer.build from the same seeded init, on
    the same batches, through train.train_loop with the counters zeroed
    just before each loop and read just after. Gates: the losses and the
    params after step 2 bit-equal to the no-remat run's under every
    policy; K1 launched REMAT_K1_RUNS x layers x microbatches x steps
    times, K2 once per layer and microbatch; ``full`` peaks lower than no
    remat. Prints each run's peak memory and step time."""
    steps = 2
    runs, ref_params = {}, None
    for policy in (None,) + models.REMAT_POLICIES:
        argv = ["--steps", str(steps), *FLAGSHIP_ARGV, "--adam-mu-dtype",
                "bf16"]
        if policy is not None:
            argv += ["--remat", "--remat-policy", policy]
        args = transformer.parse_args(argv)
        built = transformer.build(args)
        per = args.layers * args.grad_accum * steps
        label = f"remat {policy or 'off'}"
        loop = drive_train(torch, fa, train, built, args, label,
                           {"flash_fwd": REMAT_K1_RUNS[policy] * per,
                            "flash_bwd_dq": per, "flash_bwd_dkv": per,
                            "flash_merge": 0})
        flat = torch.cat([p.detach().reshape(-1)
                          for p in built.model.parameters()])
        if policy is None:
            ref_params, ref_losses = flat, loop["loss_trajectory"]
        else:
            require(loop["loss_trajectory"] == ref_losses,
                    f"{label}: losses {loop['loss_trajectory']} are not "
                    f"bit-equal to no remat's {ref_losses}")
            require(torch.equal(flat, ref_params),
                    f"{label}: params after step {steps} are not bit-equal "
                    f"to no remat's ({int((flat != ref_params).sum())} "
                    f"elements differ)")
            del flat
        runs[policy or "off"] = {
            "launches": loop["launches"],
            "loss_trajectory": loop["loss_trajectory"],
            "peak_memory_gb": loop["peak_memory_gb"],
            "step_seconds": loop["step_seconds"]}
        del built
        torch.cuda.empty_cache()
    require(runs["full"]["peak_memory_gb"] < runs["off"]["peak_memory_gb"],
            f"remat full peaks at {runs['full']['peak_memory_gb']} GB, not "
            f"below no remat's {runs['off']['peak_memory_gb']} GB")
    return {"model": "lm_flagship_gqa_kv4 (bench.py:636), by policy",
            "argv": FLAGSHIP_ARGV + ["--steps", str(steps),
                                     "--adam-mu-dtype", "bf16"],
            "runs": runs, "bit_equal_to_no_remat": True,
            "smoke_reading": "2 steps of a fresh build each; the second "
                             "step's host time, not a throughput "
                             "measurement",
            "nvidia_smi": nvidia_smi_line()}


# --- phase: adam8 ------------------------------------------------------------


# bench.py:647 lm_flagship_gqa_kv4_adam8 as written.
ADAM8_ARGV = ["--steps", "6", *FLAGSHIP_ARGV, "--remat", "--remat-policy",
              "dots_attn", "--optimizer", "adam8"]
# tests/test_optimizers.py:100, the reference's drop-in bound.
ADAM8_RTOL, ADAM8_ATOL = 5e-2, 5e-3


def _opt_bytes(state) -> int:
    return sum(t.numel() * t.element_size()
               for t in state.state_dict().values() if t.dim())


def run_adam8(torch, fa, transformer, train, checkpoint, steptrace):
    """lm_flagship_gqa_kv4_adam8 as written (bench.py:647), 6 steps, with
    the counters zeroed just before the loop and read just after (K1 and
    K2 once per layer and microbatch): every loss finite and within the
    reference's drop-in bound (rtol 5e-2, atol 5e-3) of an f32 adam run
    from the same init on the same batches. Then a save and restore
    through checkpoint.Checkpointer in a ``tempfile.mkdtemp()`` directory:
    run A trains 3 steps and saves step 3; run B, a fresh build, restores
    it (bit-equal to A's state) and trains 4-6: its losses and final
    params and int8 moments bit-equal to the unbroken run's. Prints the
    optimizer state's bytes beside f32 adam's."""
    import shutil
    import tempfile

    args = transformer.parse_args(ADAM8_ARGV)
    per = args.layers * args.grad_accum * args.steps
    built = transformer.build(args)
    loop = drive_train(torch, fa, train, built, args, "adam8",
                       {"flash_fwd": per, "flash_bwd_dq": per,
                        "flash_bwd_dkv": per, "flash_merge": 0})
    bytes8 = _opt_bytes(built.opt_state)
    u_params = {n: p.detach().clone()
                for n, p in built.model.named_parameters()}
    u_opt = {n: t.clone() for n, t in built.opt_state.state_dict().items()}
    del built
    torch.cuda.empty_cache()

    adam_args = transformer.parse_args(
        [a if a != "adam8" else "adam" for a in ADAM8_ARGV])
    adam = transformer.build(adam_args)
    adam_loop = drive_train(torch, fa, train, adam, adam_args, "adam",
                            {"flash_fwd": per, "flash_bwd_dq": per,
                             "flash_bwd_dkv": per, "flash_merge": 0})
    bytes_adam = _opt_bytes(adam.opt_state)
    del adam
    torch.cuda.empty_cache()
    got, want = loop["loss_trajectory"], adam_loop["loss_trajectory"]
    worst = max(abs(a - b) - ADAM8_RTOL * abs(b) for a, b in zip(got, want))
    require(worst <= ADAM8_ATOL,
            f"adam8 losses {got} leave the drop-in bound (rtol "
            f"{ADAM8_RTOL}, atol {ADAM8_ATOL}) of adam's {want}")

    ckdir = tempfile.mkdtemp(prefix="chip_smoke_adam8_")
    first = args.steps // 2
    try:
        run_a = transformer.build(args)
        ck_a = checkpoint.Checkpointer(ckdir, save_every=first)
        a_losses, _s, _rows = _ckpt_drive(torch, train, steptrace, run_a,
                                          first, ck_a)
        ck_a.close()
        require(ck_a.last_verified_step() == first
                and a_losses == got[:first],
                f"adam8 run A: verified {ck_a.last_verified_step()}, losses "
                f"{a_losses} against {got[:first]}")
        run_b = transformer.build(args)
        ck_b = checkpoint.Checkpointer(ckdir, save_every=first)
        state_b, start = ck_b.restore(run_b.state)
        mismatches = _state_mismatches(torch, state_b, run_a.state)
        require(start == first and not mismatches,
                f"adam8 run B restored step {start}, differing from run A "
                f"in {mismatches[:8]}")
        del run_a
        torch.cuda.empty_cache()
        b_losses, _s, _rows = _ckpt_drive(torch, train, steptrace, run_b,
                                          args.steps, ck_b)
        ck_b.close()
        require(b_losses == got[first:],
                f"adam8 resumed losses {b_losses} != the unbroken run's "
                f"{got[first:]} (bit-equal gate)")
        off = [n for n, p in run_b.model.named_parameters()
               if not torch.equal(p, u_params[n])]
        off += [n for n, t in run_b.opt_state.state_dict().items()
                if not torch.equal(t, u_opt[n])]
        require(not off, f"adam8 resumed state differs from the unbroken "
                         f"run's: {off[:8]}")
        saved_bytes = ck_b.save_timings[-1].get("bytes", {}) \
            if ck_b.save_timings else {}
        del run_b, u_params, u_opt
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    return {"model": "lm_flagship_gqa_kv4_adam8 (bench.py:647), as written",
            "argv": ADAM8_ARGV, **loop,
            "adam_loss_trajectory": want,
            "bound": f"every step within rtol {ADAM8_RTOL}, atol "
                     f"{ADAM8_ATOL} of adam (tests/test_optimizers.py:100)",
            "worst_excess_over_rtol": worst,
            "optimizer_state_bytes": {"adam8": bytes8, "adam_f32": bytes_adam},
            "resume_from_step": first, "resumed_losses": b_losses,
            "resume_bit_equal": True, "saved_file_bytes": saved_bytes,
            "nvidia_smi": nvidia_smi_line()}


# --- phase: longctx ----------------------------------------------------------


# bench.py:675 lm_longctx_T32768_gqa as written (3 steps).
LONGCTX_ARGV = ["--steps", "3", "--batch", "2", "--seq-len", "32768",
                "--grad-accum", "2", "--vocab", "32768", "--dim", "2048",
                "--heads", "16", "--kv-heads", "4", "--layers", "8",
                "--remat", "--remat-policy", "attn", "--optimizer", "adam8",
                "--loss-chunk", "2048", "--seed", "0", "--log-every", "0",
                "--device", "cuda", "--checkpoint-dir", "",
                "--profile-dir", ""]
# tests/test_loss_chunk.py:81: the chunked loss against the unchunked.
CHUNK_REL_TOL = 1e-4


def longctx_kernel_times(torch, fa, t: int, h: int, kvh: int,
                         d: int) -> dict:
    """K1 and K2 at the long-context row's attention shape (one row of
    ``t`` tokens, ``h`` / ``kvh`` heads, causal, fused D, bf16 grads; K1
    on CUDA events, dq and dkv as profiler device time) beside SDPA's
    forward and backward at the same shape and mask (a yardstick only).
    No plain version: its scores would take tens of GB."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(32)
    inputs, run = bwd_case(torch, fa, gen, 1, t, h, kvh, True, (0, 0, 1),
                           True, torch.bfloat16, d)
    q, k, v, g, _L, _o, _D = inputs
    res = {"ms_fwd": time_ms(torch, lambda: fa.flash_attention_with_lse(
        q, k, v, causal=True), reps=5)}
    per = kernel_device_ms(torch, run, 3, ("flash_bwd_dq_kernel",
                                           "flash_bwd_dkv_kernel"))
    res["ms_dq"] = per["flash_bwd_dq_kernel"]
    res["ms_dkv"] = per["flash_bwd_dkv_kernel"]
    res["ms_pair"] = time_ms(torch, run, reps=5)
    qt, kt, vt, gt = (x.permute(0, 2, 1, 3) for x in (q, k, v, g))
    lib = sdpa_backward_ms(torch, torch.nn.functional, qt, kt, vt, gt, True,
                           reps=5)
    res.update({"library_fwd_ms": lib["library_fwd_ms"],
                "library_bwd_ms": lib["library_ms"],
                "library_fwd_bwd_ms": lib["library_fwd_bwd_ms"],
                "library": "F.scaled_dot_product_attention (causal, GQA)"})
    del inputs, q, k, v, g, qt, kt, vt, gt
    torch.cuda.empty_cache()
    return res


def run_longctx(torch, fa, transformer, train, data):
    """lm_longctx_T32768_gqa as written (bench.py:675: B 2 x T 32768 as 2
    microbatches of one row, remat under attn, adam8, --loss-chunk 2048),
    full width and depth, 3 steps through transformer.build and
    train.train_loop, the counters zeroed just before the loop and read
    just after: K1 and K2 once per layer and microbatch (attn saves K1's
    outputs). Before the loop, on one row from another seed, the chunked
    loss (forward only) against the unchunked loss of the same model,
    within CHUNK_REL_TOL. Every loss finite; prints the step time,
    tokens/s and the peak memory. Before the build, K1 and K2 at the
    row's attention shape beside SDPA (:func:`longctx_kernel_times`).
    Returns the readings and the build (for its profile)."""
    args = transformer.parse_args(LONGCTX_ARGV)
    # The kernels' bounds at this row's attention shape (one row of 32768
    # tokens a microbatch, 16 / 4 heads, D 128, causal, fused D, bf16).
    t, h, kvh = args.seq_len, args.heads, args.kv_heads
    d = args.dim // h
    pairs = t * (t + 1) // 2
    k1_ms, k1_by = bound(2.0 * (2 * t * h * d + 2 * t * kvh * d) + 4.0 * h * t,
                         4.0 * h * d * pairs, BF16_TC_FLOPS)
    bounds = {"shape": {"B": 1, "T": t, "H": h, "KVH": kvh, "D": d,
                        "causal": True},
              "bound_ms_fwd": k1_ms, "bound_by_fwd": k1_by,
              **{k: v for k, v in bwd_bounds(
                  torch, 1, t, t, h, kvh, True, (0, 0, 1), True, 2,
                  d).items() if k.startswith("bound")},
              **longctx_kernel_times(torch, fa, t, h, kvh, d)}
    built = transformer.build(args)
    (rows,) = next(data.synthetic_lm(args.seed + 1, 1, args.seq_len,
                                     vocab=args.vocab))
    tokens = torch.from_numpy(rows).to(built.device)
    with torch.no_grad():
        chunked = float(transformer.make_lm_loss(
            built.model, loss_chunk=args.loss_chunk)(tokens)[0])
        dense = float(transformer.make_lm_loss(built.model)(tokens)[0])
    rel = abs(chunked - dense) / abs(dense)
    require(rel <= CHUNK_REL_TOL,
            f"longctx: chunked loss {chunked} vs unchunked {dense}, rel "
            f"{rel} > {CHUNK_REL_TOL}")
    del tokens
    torch.cuda.empty_cache()
    per = args.layers * args.grad_accum * args.steps
    loop = drive_train(torch, fa, train, built, args, "longctx",
                       {"flash_fwd": per, "flash_bwd_dq": per,
                        "flash_bwd_dkv": per, "flash_merge": 0})
    step_s = statistics.median(loop["step_seconds"][1:])
    out = {"model": "lm_longctx_T32768_gqa (bench.py:675), as written",
           "argv": LONGCTX_ARGV,
           "params": sum(p.numel() for p in built.model.parameters()),
           **loop, "smoke_step_seconds_median_steps_2_to_3": step_s,
           "smoke_tokens_per_s": args.batch * args.seq_len / step_s,
           "chunked_vs_unchunked_loss": {"chunked": chunked,
                                         "unchunked": dense, "rel": rel,
                                         "tol": CHUNK_REL_TOL},
           "optimizer_state_bytes": _opt_bytes(built.opt_state),
           "kernel_bounds": bounds,
           "smoke_reading": "3 steps from a cold start; not a throughput "
                            "measurement",
           "nvidia_smi": nvidia_smi_line()}
    return out, built


# --- phase: moe --------------------------------------------------------------


# bench.py:730 moe_e8_top2_single_chip as written (bf16, adam, einsum
# dispatch, no gradient accumulation), 6 steps.
MOE_ARGV = ["--steps", "6", "--dim", "1024", "--layers", "8", "--heads",
            "8", "--kv-heads", "4", "--experts", "8", "--batch", "8",
            "--seq-len", "2048", "--vocab", "32768", "--capacity-factor",
            "1.25", "--seed", "0", "--log-every", "0", "--device", "cuda",
            "--checkpoint-dir", "", "--profile-dir", ""]
# One MoE training checkpoint: f32 params (~1.6 GB) and f32 adam mu and nu
# (~3.2 GB); run A keeps 2, run B adds one.
MOE_CKPT_BYTES = 4.8e9
# - gather against einsum dispatch on one MoE layer (bf16, the same weights
#   and input): both read one routing and put the same bf16 values into the
#   expert slots (a one-hot product sums one nonzero term, exactly), so the
#   expert products are equal; only the combine differs: the einsum sums
#   g1 y1 + g2 y2 in f32 and rounds once, the gather path rounds each gated
#   product and then their sum. Each rounding moves a value by at most 2^-8
#   of it, so an element may differ by 2^-8 (A + |out|), A = g1 |y1| +
#   g2 |y2| the sum of its absolute terms; the tolerance is twice that,
#   with a floor of 2^-16 of the largest |out| where the terms cancel. A
#   token in a wrong slot or with a lost gate moves its element by O(A).
MOE_DISPATCH_REL_TOL = 2.0 ** -7
MOE_DISPATCH_ABS_FLOOR = 2.0 ** -16


class RoutePin:
    """The MoE layers' discrete routing held fixed across the sides of a
    cross-check. bf16 rounds the residual stream differently on each side
    (K1 and the plain attention round P and O apart), so a router logit
    near a tie can pick another expert, and one such token shifts the
    slots of every later token of its expert and moves the capacity cut:
    at init on the MoE row, on an H100, 13-92 first choices a layer
    differed and the gradients parted by 10% of their norm (a sum over
    4096 positions that mostly cancels, against the changed terms of ~100
    tokens). So the
    gradient gates compare sides that route alike: ``side("kernels")``
    records each ``moe.top2_routing`` call's decisions (experts, slots,
    keeps, drop_frac) and every other side replays them in call order,
    with gates, aux and z-loss from its own logits. The losses are also
    compared unpinned (``free()``), which is what the loss gate holds."""

    DISCRETE = ("idx1", "idx2", "slot1", "slot2", "keep1", "keep2",
                "kept1", "kept2", "pos1", "pos2", "drop_frac")

    def __init__(self, torch, F, moe):
        self.torch, self.F, self.moe = torch, F, moe
        self.real = moe.top2_routing
        self.calls: list = []

    def _record(self, logits, capacity):
        r = self.real(logits, capacity)
        self.calls.append({k: r[k].detach().clone() for k in self.DISCRETE})
        return r

    def _replay(self, at):
        torch, F = self.torch, self.F

        def routing(logits, _capacity):
            rec = self.calls[at[0]]
            at[0] += 1
            logits = logits.float()
            probs = torch.softmax(logits, dim=-1)
            e = probs.shape[-1]
            mask1 = F.one_hot(rec["idx1"], e).float()
            z = torch.logsumexp(logits, dim=-1)
            gate1 = (probs * rec["keep1"]).sum(dim=-1)
            gate2 = (probs * rec["keep2"]).sum(dim=-1)
            denom = torch.clamp(gate1 + gate2, min=1e-9)
            return {**rec, "gate1": gate1 / denom, "gate2": gate2 / denom,
                    "aux": e * (mask1.mean(dim=1) * probs.mean(dim=1))
                    .sum(dim=-1).mean(),
                    "z_loss": (z * z).mean()}

        return routing

    def side(self, name):
        import contextlib

        @contextlib.contextmanager
        def ctx():
            at = [0]
            if name == "kernels":
                self.calls = []
                self.moe.top2_routing = self._record
            else:
                self.moe.top2_routing = self._replay(at)
            try:
                yield
            finally:
                self.moe.top2_routing = self.real
            require(name == "kernels" or at[0] == len(self.calls),
                    f"route pin: side {name} routed {at[0]} times, the "
                    f"kernels side {len(self.calls)}")

        return ctx()

    def free(self, fn):
        """``fn()`` with routing of its own; returns (its result, the
        count of first choices that differ from the recorded side's, by
        layer)."""
        mine: list = []

        def routing(logits, capacity):
            r = self.real(logits, capacity)
            mine.append(r["idx1"].detach())
            return r

        self.moe.top2_routing = routing
        try:
            out = fn()
        finally:
            self.moe.top2_routing = self.real
        return out, [int((a != b["idx1"]).sum())
                     for a, b in zip(mine, self.calls)]


def check_moe_dispatch(torch, F, moe, built, args, tokens):
    """Block 1's MoE layer at full width, in both dispatch modes, on its
    own input (the ``ln_mlp`` output of a full batch of ``tokens`` through
    the model at init, so routes crowd and some drop): the routing's
    scalars (drop_frac, aux) equal, the outputs per element within
    MOE_DISPATCH_REL_TOL, each mode's forward timed (CUDA events, warm,
    median)."""
    from tpu_operator_torch.payload import transformer

    layer, dev = built.model.blocks[1].moe, built.device
    seen = []
    hook = layer.register_forward_pre_hook(
        lambda _m, inp: seen.append(inp[0].detach()))
    try:
        with torch.no_grad():
            built.model(tokens, None, transformer._causal_attend)
    finally:
        hook.remove()
    x = seen[0]
    twin = moe.MoEMLP(args.dim, args.experts, args.capacity_factor,
                      dispatch="gather", compute_dtype=torch.bfloat16,
                      device=dev)
    twin.load_state_dict(layer.state_dict())
    dt = torch.bfloat16
    with torch.no_grad():
        with moe.sown() as sown_e:
            out_e = layer(x)
        with moe.sown() as sown_g:
            out_g = twin(x)
        # The einsum layer's pieces again, for each element's A.
        cap = moe.capacity_of(args.seq_len, args.experts,
                              args.capacity_factor)
        r = moe.top2_routing(F.linear(x, layer.router.weight), cap)
        disp, comb, _aux, _drop = moe.onehot_tensors(r, cap)
        xin = torch.einsum("gnec,gnd->egcd", disp.to(dt), x.to(dt))
        del disp
        y = torch.einsum("egcf,efd->egcd", F.gelu(torch.einsum(
            "egcd,edf->egcf", xin, layer.w1.to(dt)), approximate="tanh"),
            layer.w2.to(dt))
        terms = torch.einsum("gnec,egcd->gnd", comb.to(dt).float(),
                             y.float().abs())
        del comb, xin, y
        diff = (out_g.float() - out_e.float()).abs()
        ref = out_e.float().abs()
        limit = MOE_DISPATCH_REL_TOL * (terms + ref) \
            + MOE_DISPATCH_ABS_FLOOR * float(ref.max())
        excess = float((diff / limit).max())
        drop_e, drop_g = float(sown_e[0][2]), float(sown_g[0][2])
        aux_e, aux_g = float(sown_e[0][0]), float(sown_g[0][0])
        res = {"shape": list(x.shape), "capacity": cap,
               "drop_frac": {"einsum": drop_e, "gather": drop_g},
               "aux": {"einsum": aux_e, "gather": aux_g},
               "max_abs_err": float(diff.max()),
               "max_abs_ref": float(ref.max()),
               "worst_err_over_tol": excess,
               "tol": f"per element {MOE_DISPATCH_REL_TOL} * (A + |ref|) + "
                      f"{MOE_DISPATCH_ABS_FLOOR} * max |ref|, A = g1 |y1| "
                      f"+ g2 |y2|",
               "einsum_fwd_ms": time_ms(torch, lambda: layer(x), reps=10),
               "gather_fwd_ms": time_ms(torch, lambda: twin(x), reps=10)}
        del diff, ref, limit, terms, out_e, out_g
    require(drop_e == drop_g and aux_e == aux_g,
            f"moe dispatch: the modes routed apart ({res})")
    require(excess <= 1.0, f"moe dispatch: gather against einsum {excess} "
                           f"x the tolerance ({res})")
    return res


def _bmm_device_ms(torch, prof, dim: int):
    """(device ms, calls) of the ``aten::bmm`` calls with ``dim`` among
    their operands' sizes, from a profile recorded with shapes."""
    ms, calls = 0.0, 0
    for evt in prof.key_averages(group_by_input_shape=True):
        if evt.key != "aten::bmm":
            continue
        shapes = [tuple(sh) for sh in (evt.input_shapes or []) if sh]
        if not any(dim in sh for sh in shapes):
            continue
        for attr in ("device_time_total", "cuda_time_total"):
            if hasattr(evt, attr):
                ms += float(getattr(evt, attr)) / 1e3
                break
        calls += evt.count
    return ms, calls


def profile_moe(torch, built, args):
    """One MoE training step under torch.profiler (shapes recorded): device
    time by group (K1, K2, cuBLAS, the rest) beside the host clock, with
    cuBLAS split into the dispatch / combine einsums (the ``aten::bmm``
    calls with the sequence length among their operands' sizes: the
    one-hot products contract or keep n; the expert products' operands
    are [E, G C, D] by [E, D, 4D] and their transposes) and the rest."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    batch = torch.from_numpy(next(built.batches)[0]).to(built.device)
    built.step(batch)  # one unprofiled step
    torch.cuda.synchronize()
    with profile(activities=acts, record_shapes=True) as prof:
        t0 = time.perf_counter()
        built.step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(torch, prof, 1)
    groups: dict = {}
    for key, ms, _n in rows:
        groups[_classify(key)] = groups.get(_classify(key), 0.0) + ms
    einsum_ms, einsum_calls = _bmm_device_ms(torch, prof, args.seq_len)
    if "cuBLAS" in groups:
        groups["cuBLAS"] -= einsum_ms
    groups["cuBLAS dispatch/combine einsums"] = einsum_ms
    return {**_breakdown(rows, wall), "by_group_ms": groups,
            "dispatch_combine_bmm_calls": einsum_calls}


def run_moe(torch, F, fa, moe, transformer, train, checkpoint, steptrace,
            data):
    """moe_e8_top2_single_chip as written (bench.py:730: dim 1024, 8
    layers, 8 / 4 heads, 8 experts top-2 in every odd layer, batch 8 x
    2048, capacity factor 1.25, bf16, adam, einsum dispatch) through
    moe.build and train.train_loop:

    - at init, one 2-row microbatch's loss through K1 and K2 against
      plain attention, each side routing its own way (TRAIN_LOSS_TOL), and
      its loss and every parameter's gradient with the routes pinned
      (``RoutePin``; ``check_train_plain``, gated as the train phase gates
      its own at init);
    - block 1's MoE layer in both dispatch modes (``check_moe_dispatch``);
    - 6 steps, launch counters zeroed just before the loop and read just
      after: K1, dq and dkv each layers x microbatches x steps, K3 and K4
      never; every loss finite, the first within [ln V, ln V + 2];
      drop_frac in [0, 1], aux_loss in (0, E] (E times a sum of dispatch
      fractions times mean probabilities), router_z finite;
    - ``profile_moe``: one more step's device time by group;
    - a save at step 3 and a resume to step 6 through
      ``checkpoint.Checkpointer`` in a ``tempfile.mkdtemp()`` directory
      (as the adam8 phase does): the resumed losses, params and adam state
      bit-equal to the unbroken run's.
    Printed: the step times, tokens/s and peak memory of the loop (cold
    smoke readings), the breakdown and the nvidia-smi line."""
    import math
    import shutil
    import tempfile

    args = moe.parse_args(MOE_ARGV)
    built = moe.build(args)
    (rows,) = next(data.synthetic_lm(args.seed + 1, 2, args.seq_len,
                                     vocab=args.vocab))
    tokens = torch.from_numpy(rows).to(built.device)
    pin = RoutePin(torch, F, moe)
    at_init = check_train_plain(torch, fa, transformer, train, built.model,
                                tokens, pin=pin.side)
    with torch.no_grad():
        plain_loss, flips = pin.free(lambda: float(train.next_token_nll(
            built.model(tokens, None, plain_attend(fa)), tokens)))
    at_init["unpinned"] = {
        "loss_plain": plain_loss,
        "loss_abs_err": abs(at_init["loss"]["kernels"] - plain_loss),
        "first_choices_apart_by_moe_layer": flips,
        "tokens_a_layer": int(tokens.numel())}
    require(at_init["unpinned"]["loss_abs_err"] <= TRAIN_LOSS_TOL,
            f"moe cross-check at init: the loss with K1/K2 against plain "
            f"attention, each routing its own way: {at_init['unpinned']}")
    gate_train_plain(at_init, at_init=True)
    (batch,) = next(data.synthetic_lm(args.seed + 1, args.batch,
                                      args.seq_len, vocab=args.vocab))
    dispatch = check_moe_dispatch(torch, F, moe, built, args,
                                  torch.from_numpy(batch).to(built.device))
    per = args.layers * args.grad_accum * args.steps
    loop = drive_train(torch, fa, train, built, args, "moe",
                       {"flash_fwd": per, "flash_bwd_dq": per,
                        "flash_bwd_dkv": per, "flash_merge": 0,
                        "flash_decode": 0})
    mt = loop["metric_trajectories"]
    require(all(0.0 <= d <= 1.0 for d in mt["drop_frac"]),
            f"moe: drop_frac outside [0, 1]: {mt['drop_frac']}")
    require(all(0.0 < a <= args.experts for a in mt["aux_loss"]),
            f"moe: aux_loss outside (0, {args.experts}]: {mt['aux_loss']}")
    require(all(math.isfinite(z) for z in mt["router_z"]),
            f"moe: router_z not finite: {mt['router_z']}")
    u_losses = loop["loss_trajectory"]
    u_params = {n: p.detach().clone()
                for n, p in built.model.named_parameters()}
    u_opt = {n: t.clone() for n, t in built.opt_state.state_dict().items()}
    prof = profile_moe(torch, built, args)
    n_params = sum(p.numel() for p in built.model.parameters())
    del built
    torch.cuda.empty_cache()

    ckdir = tempfile.mkdtemp(prefix="chip_smoke_moe_")
    first = args.steps // 2
    try:
        free = shutil.disk_usage(ckdir).free
        require(free >= 3 * MOE_CKPT_BYTES,
                f"moe phase: {free / 1e9:.1f} GB free under "
                f"{os.path.dirname(ckdir)}, needs "
                f"{3 * MOE_CKPT_BYTES / 1e9:.1f} GB; set TMPDIR to a larger "
                f"volume")
        run_a = moe.build(args)
        ck_a = checkpoint.Checkpointer(ckdir, save_every=first)
        a_losses, _s, _rows = _ckpt_drive(torch, train, steptrace, run_a,
                                          first, ck_a)
        ck_a.close()
        require(ck_a.last_verified_step() == first
                and a_losses == u_losses[:first],
                f"moe run A: verified {ck_a.last_verified_step()}, losses "
                f"{a_losses} against {u_losses[:first]}")
        run_b = moe.build(args)
        ck_b = checkpoint.Checkpointer(ckdir, save_every=first)
        state_b, start = ck_b.restore(run_b.state)
        mismatches = _state_mismatches(torch, state_b, run_a.state)
        require(start == first and not mismatches,
                f"moe run B restored step {start}, differing from run A in "
                f"{mismatches[:8]}")
        del run_a
        torch.cuda.empty_cache()
        b_losses, _s, _rows = _ckpt_drive(torch, train, steptrace, run_b,
                                          args.steps, ck_b)
        ck_b.close()
        require(b_losses == u_losses[first:],
                f"moe resumed losses {b_losses} != the unbroken run's "
                f"{u_losses[first:]} (bit-equal gate)")
        off = [n for n, p in run_b.model.named_parameters()
               if not torch.equal(p, u_params[n])]
        off += [n for n, t in run_b.opt_state.state_dict().items()
                if not torch.equal(t, u_opt[n])]
        require(not off, f"moe resumed state differs from the unbroken "
                         f"run's: {off[:8]}")
        with open(os.path.join(ckdir, str(args.steps), "meta.json")) as f:
            meta_model = json.load(f).get("model")
        require(meta_model == {"name": "moe", "experts": args.experts},
                f"moe meta.json names {meta_model}")
        del run_b, u_params, u_opt
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    steps = loop["step_seconds"]
    return {
        "model": "moe_e8_top2_single_chip (bench.py:730), as written",
        "argv": MOE_ARGV, "params": n_params,
        **loop,
        "smoke_step_ms_median_steps_2_to_5":
            1e3 * statistics.median(steps[2:6]),
        "smoke_tokens_per_s_median_steps_2_to_5":
            args.batch * args.seq_len / statistics.median(steps[2:6]),
        "smoke_reading": "6 steps from a cold start; not a throughput "
                         "measurement",
        "crosscheck_at_init": at_init,
        "dispatch_modes": dispatch,
        "profile_step": prof,
        "resume_from_step": first, "resumed_losses": b_losses,
        "resume_bit_equal": True,
        "nvidia_smi": nvidia_smi_line(),
    }


# --- phase: pipeline ----------------------------------------------------------


# bench.py:840-905 bench_pipeline_overhead's shape (the dense transformer
# runs it too), as written: bf16, adam at lr 3e-3.
PIPE_SHAPE = ["--dim", "1024", "--layers", "8", "--heads", "16",
              "--batch", "16", "--seq-len", "2048", "--vocab", "32768"]
PIPE_COMMON = ["--seed", "0", "--log-every", "0", "--device", "cuda",
               "--checkpoint-dir", "", "--profile-dir", ""]
PIPE_ARGV = [*PIPE_SHAPE, "--microbatches", "4", *PIPE_COMMON]
# label -> (flags, K1 launches a layer and microbatch: the forward, and
# the backward's recompute from the stash under --stash input).
PIPE_RUNS = {
    "gpipe_s1": (["--schedule", "gpipe"], 1),
    "1f1b_input_s1": (["--schedule", "1f1b"], 2),
    "1f1b_residuals_s1": (["--schedule", "1f1b", "--stash", "residuals"], 1),
    "interleaved_v2_s1": (["--schedule", "1f1b-interleaved",
                           "--virtual-stages", "2"], 2),
    "1f1b_input_s4": (["--schedule", "1f1b", "--pipeline", "4"], 2),
    "interleaved_v2_s4": (["--schedule", "1f1b-interleaved",
                           "--virtual-stages", "2", "--pipeline", "4"], 2),
}
PIPE_STEPS = 4
# Tolerances of the schedules against gpipe at S 1 on one batch at init
# (the same seeded weights: the init does not depend on the layout).
# Every side runs the same kernels on the same microbatches; they differ
# in the order f32 gradients add over microbatches and in the head: gpipe
# takes one loss over the whole batch, 1f1b one per microbatch, each
# [rows, 1024] x [1024, 32768] bf16 product and its f32 logsumexp at
# another size (cuBLAS may split the bf16 sums otherwise). The loss to
# 1e-3 (0.01% of ln 32768); the whole gradient to 2^-8 and each
# parameter's to 2^-6 of its norm (a bf16 rounding moves a value by up to
# 2^-8 of it; a schedule fault, a microbatch dropped or a stage skipped,
# moves a gradient by O(10%) or more).
PIPE_LOSS_TOL = 1e-3
PIPE_GRAD_GLOBAL_TOL = 2.0 ** -8
PIPE_GRAD_REL_TOL = 2.0 ** -6
# One checkpoint of the row: f32 params (0.68 GB) and adam's f32 mu and nu.
PIPE_CKPT_BYTES = 2.1e9


def per_layer(model, tensors):
    """{name: tensor} of a ``pipeline.PipelineLM``'s params (or their
    gradients) by layer: the stage stacks' entries as ``layer<l>.<param>``
    (layer l = (j S + d) blocks + i for block i of chunk (j, d)), whatever
    the layout; the embedding and head as they are."""
    out = {n: t for n, t in tensors.items() if not n.startswith("stages.")}
    for (j, d), _stage in model.chunks.items():
        c = j * model.S + d
        for name in model.stage_names:
            block, rest = name.split(".", 1)
            layer = c * model.blocks + int(block[len("block"):])
            out[f"layer{layer}.{rest}"] = model.stack_slot(
                tensors[f"stages.{name}"], j, d)
    return out


def run_pipeline(torch, fa, pipeline, transformer, train, checkpoint,
                 steptrace, data):
    """The pipeline bench row as written (bench.py:840-905: dim 1024, 8
    layers, 16 heads, head dim 64, batch 16 x 2048 as 4 microbatches,
    vocab 32768, bf16, adam) through ``pipeline.build`` and
    ``train.train_loop``:

    - at init, one 4-row batch's loss and every parameter's gradient
      under gpipe through K1 + K2 against plain attention (the train
      phase's gates at init), and the row's 16-row batch under every
      schedule of ``PIPE_RUNS`` (gpipe, 1f1b with either stash and
      interleaved V 2 at S 1; 1f1b and interleaved V 2 at S 4 in this
      process, 2 layers a stage) against gpipe at S 1 (PIPE_*_TOL);
    - each schedule for PIPE_STEPS steps, launch counters zeroed just
      before the loop and read just after: dq and dkv layers x
      microbatches x steps, K1 once or twice that (the recompute under
      --stash input), K3 and K4 never; the fenced step time beside the
      dense transformer's at the same shape (the row's overhead_vs_dense,
      a smoke reading) and the peak memory of each;
    - a save at step 2 of 1f1b at S 1 and a fresh build's resume to step
      4, its losses, params and adam state bit-equal to the unbroken
      run's, meta.json naming the layout."""
    import math
    import shutil
    import tempfile

    def args_for(flags):
        return pipeline.parse_args(PIPE_ARGV + flags
                                   + ["--steps", str(PIPE_STEPS)])

    ref_args = args_for(PIPE_RUNS["gpipe_s1"][0])
    (rows,) = next(data.synthetic_lm(ref_args.seed + 1, ref_args.batch,
                                     ref_args.seq_len, vocab=ref_args.vocab))
    tokens = torch.from_numpy(rows).to(ref_args.device)
    built = pipeline.build(ref_args)
    ref_loss, ref_grads = built.pipeline.loss_and_grads(tokens)
    ref = (float(ref_loss), per_layer(built.model, ref_grads))
    n_params = sum(p.numel() for p in built.model.params.values())
    del built, ref_grads
    torch.cuda.empty_cache()
    # Kernels against plain attention on 4 rows (one a microbatch), under
    # 1f1b so that one microbatch's plain scores are alive at a time.
    built = pipeline.build(args_for(PIPE_RUNS["1f1b_input_s1"][0]))
    small = tokens[:4]
    kernels = built.pipeline.loss_and_grads(small)
    built.pipeline.attend = plain_attend(fa)(0)
    plain = built.pipeline.loss_and_grads(small)
    kp = compare_grads(*((float(loss), per_layer(built.model, g))
                         for loss, g in (kernels, plain)))
    del kp["_ratios"], kernels, plain, built
    torch.cuda.empty_cache()
    name, worst = kp["worst_grad_rel_err"][0]
    require(kp["loss_abs_err"] <= TRAIN_LOSS_TOL
            and kp["grad_rel_err_all"] <= TRAIN_GRAD_GLOBAL_TOL
            and worst <= TRAIN_GRAD_REL_TOL,
            f"pipeline at init, K1 + K2 against plain attention: {kp}")

    runs, gates = {}, {}
    unbroken = None
    for label, (flags, k1_runs) in PIPE_RUNS.items():
        args = args_for(flags)
        built = pipeline.build(args)
        loss, grads = built.pipeline.loss_and_grads(tokens)
        gap = compare_grads((float(loss), per_layer(built.model, grads)), ref)
        del gap["_ratios"], grads
        name, worst = gap["worst_grad_rel_err"][0]
        require(gap["loss_abs_err"] <= PIPE_LOSS_TOL
                and gap["grad_rel_err_all"] <= PIPE_GRAD_GLOBAL_TOL
                and worst <= PIPE_GRAD_REL_TOL,
                f"pipeline {label} against gpipe at S 1 at init: {gap}")
        gates[label] = gap
        per = args.layers * args.microbatches * args.steps
        loop = drive_train(torch, fa, train, built, args, f"pipeline {label}",
                           {"flash_fwd": k1_runs * per, "flash_bwd_dq": per,
                            "flash_bwd_dkv": per, "flash_merge": 0,
                            "flash_decode": 0})
        loop["smoke_step_ms_median_steps_1_to_3"] = 1e3 * statistics.median(
            loop["step_seconds"][1:])
        loop["stash_peak"] = dict(built.pipeline.stash_peak)
        runs[label] = loop
        if label == "1f1b_input_s1":
            unbroken = (loop["loss_trajectory"],
                        {n: p.clone() for n, p in built.model.params.items()},
                        {n: t.clone() for n, t
                         in built.opt_state.state_dict().items()})
            loop["profile_step"] = profile_step(torch, built)
        del built
        torch.cuda.empty_cache()

    dense_args = transformer.parse_args(PIPE_SHAPE + PIPE_COMMON
                                        + ["--steps", str(PIPE_STEPS)])
    built = transformer.build(dense_args)
    per = dense_args.layers * dense_args.steps
    dense = drive_train(torch, fa, train, built, dense_args,
                        "pipeline dense", {"flash_fwd": per,
                                           "flash_bwd_dq": per,
                                           "flash_bwd_dkv": per})
    dense_ms = 1e3 * statistics.median(dense["step_seconds"][1:])
    dense["profile_step"] = profile_step(torch, built)
    del built
    torch.cuda.empty_cache()
    for loop in runs.values():
        loop["smoke_overhead_vs_dense_pct"] = 100.0 * (
            loop["smoke_step_ms_median_steps_1_to_3"] / dense_ms - 1.0)

    args = args_for(PIPE_RUNS["1f1b_input_s1"][0])
    u_losses, u_params, u_opt = unbroken
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_pipe_")
    first = args.steps // 2
    try:
        free = shutil.disk_usage(ckdir).free
        require(free >= 3 * PIPE_CKPT_BYTES,
                f"pipeline phase: {free / 1e9:.1f} GB free under "
                f"{os.path.dirname(ckdir)}, needs "
                f"{3 * PIPE_CKPT_BYTES / 1e9:.1f} GB; set TMPDIR to a larger "
                f"volume")
        run_a = pipeline.build(args)
        ck_a = checkpoint.Checkpointer(ckdir, save_every=first)
        a_losses, _s, _rows = _ckpt_drive(torch, train, steptrace, run_a,
                                          first, ck_a)
        ck_a.close()
        require(ck_a.last_verified_step() == first
                and a_losses == u_losses[:first],
                f"pipeline run A: verified {ck_a.last_verified_step()}, "
                f"losses {a_losses} against {u_losses[:first]}")
        run_b = pipeline.build(args)
        ck_b = checkpoint.Checkpointer(ckdir, save_every=first)
        state_b, start = ck_b.restore(run_b.state)
        mismatches = _state_mismatches(torch, state_b, run_a.state)
        require(start == first and not mismatches,
                f"pipeline run B restored step {start}, differing from run "
                f"A in {mismatches[:8]}")
        del run_a
        torch.cuda.empty_cache()
        b_losses, _s, _rows = _ckpt_drive(torch, train, steptrace, run_b,
                                          args.steps, ck_b)
        ck_b.close()
        require(b_losses == u_losses[first:],
                f"pipeline resumed losses {b_losses} != the unbroken run's "
                f"{u_losses[first:]} (bit-equal gate)")
        off = [n for n, p in run_b.model.params.items()
               if not torch.equal(p, u_params[n])]
        off += [n for n, t in run_b.opt_state.state_dict().items()
                if not torch.equal(t, u_opt[n])]
        require(not off, f"pipeline resumed state differs from the "
                         f"unbroken run's: {off[:8]}")
        with open(os.path.join(ckdir, str(args.steps), "meta.json")) as f:
            meta_model = json.load(f).get("model")
        want_meta = {"name": "pipeline", "pipeline": 1, "virtualStages": 0,
                     "zero1": False}
        require(meta_model == want_meta,
                f"pipeline meta.json names {meta_model}")
        del run_b, u_params, u_opt
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    require(all(math.isfinite(x) for r in runs.values()
                for x in r["loss_trajectory"]), "pipeline: a loss not finite")
    return {
        "model": "bench_pipeline_overhead (bench.py:840-905), as written",
        "argv": PIPE_ARGV, "params": n_params,
        "head_dim": 1024 // 16,
        "runs": {label: {"flags": PIPE_RUNS[label][0], **loop}
                 for label, loop in runs.items()},
        "dense": {"argv": PIPE_SHAPE, **dense,
                  "smoke_step_ms_median_steps_1_to_3": dense_ms},
        "gates_at_init_vs_gpipe_s1": gates,
        "tol": f"vs gpipe at S 1: loss {PIPE_LOSS_TOL}, whole gradient "
               f"{PIPE_GRAD_GLOBAL_TOL} and each parameter "
               f"{PIPE_GRAD_REL_TOL} of the reference norm",
        "kernels_vs_plain_at_init": kp,
        "smoke_reading": f"{PIPE_STEPS} steps from a cold start; the "
                         f"overhead is a smoke reading, not the bench "
                         f"row's measurement",
        "resume_from_step": first, "resumed_losses": b_losses,
        "resume_bit_equal": True,
        "meta_model": meta_model,
        "nvidia_smi": nvidia_smi_line(),
    }


# --- phases: tensor_parallel, sp_tp, ulysses ------------------------------------

COMMON_ARGV = ["--seed", "0", "--log-every", "0", "--device", "cuda",
               "--checkpoint-dir", "", "--profile-dir", ""]
# examples/tpujob-tensor-parallel.yml's payload as written; every other
# flag at its default (heads 4: head dim 1024; seq-len 2048; vocab 256;
# adam).
TP_ARGV = ["--steps", "4", "--tensor-parallel", "4", "--dim", "4096",
           "--layers", "16", "--batch", "16", "--remat", *COMMON_ARGV]
# examples/tpujob-3d-parallel.yml's payload as written.
SP_TP_ARGV = ["--steps", "2", "--seq-len", "16384", "--seq-parallel", "4",
              "--tensor-parallel", "2", "--dim", "2048", "--heads", "16",
              "--layers", "12", "--remat", "--batch", "8", *COMMON_ARGV]
# The SP bench row (bench.py:661, SP_TRAIN_ARGV) with Ulysses in place of
# the striped ring.
ULYSSES_ARGV = [a for a in SP_TRAIN_ARGV if a not in ("--sp-layout",
                                                      "striped")] \
    + ["--sp-mode", "ulysses"]
# The parity gates' copies: 2 layers at the same widths.
GATE_LAYERS = 2


def with_flags(argv, **flags):
    """``argv`` with each ``--flag value`` set (appended when absent)."""
    out = list(argv)
    for name, value in flags.items():
        out = with_flag(out, "--" + name.replace("_", "-"), str(value))
    return out


def gate_parity(torch, transformer, label, argv, other_argv, rows):
    """At init, on ``GATE_LAYERS``-layer copies of ``argv`` and
    ``other_argv`` at the same widths from the same seed (both resident,
    the same params: the two differ only in how the work is split), one
    microbatch of ``rows`` rows: the loss and every parameter's gradient
    of ``argv`` against ``other_argv``, gated at SP_LOSS_TOL,
    SP_GRAD_GLOBAL_TOL and SP_GRAD_REL_TOL (the noise of two kernel paths
    that round their partial results at other points, as the train_sp
    cross-check states)."""
    from tpu_operator_torch.payload import data as data_mod

    sides = []
    for flags in (argv, other_argv):
        args = transformer.parse_args(with_flags(flags, layers=GATE_LAYERS))
        mesh = transformer.make_lm_mesh(1, 0, args.seq_parallel,
                                        args.tensor_parallel)
        model = transformer.build_model(args, torch.device(args.device),
                                        mesh.tp()).requires_grad_(True)
        sides.append((model, transformer.make_lm_loss(
            model, mesh, args.sp_layout, sp_mode=args.sp_mode)))
    names = [[n for n, _ in m.named_parameters()] for m, _ in sides]
    require(names[0] == names[1], f"{label} gate: the two param trees differ")
    require(all(torch.equal(a, b) for a, b in zip(
        sides[0][0].parameters(), sides[1][0].parameters())),
        f"{label} gate: the two seeded inits differ")
    (tok,) = next(data_mod.synthetic_lm(1, rows, args.seq_len,
                                        vocab=args.vocab))
    tokens = torch.from_numpy(tok).to(args.device)

    def loss_and_grads(model, loss_fn):
        loss, _ = loss_fn(tokens)
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        return float(loss.detach()), grads

    got, want = (loss_and_grads(*side) for side in sides)
    res = compare_grads(got, want)
    del res["_ratios"], got, want, sides
    res.update(rows=rows, layers=GATE_LAYERS,
               tol=f"loss {SP_LOSS_TOL}; the whole gradient "
                   f"{SP_GRAD_GLOBAL_TOL} and each parameter "
                   f"{SP_GRAD_REL_TOL} of the reference side's norm")
    require(res["loss_abs_err"] <= SP_LOSS_TOL,
            f"{label} gate: loss gap {res['loss_abs_err']}")
    require(res["grad_rel_err_all"] <= SP_GRAD_GLOBAL_TOL,
            f"{label} gate: the whole gradient off by "
            f"{res['grad_rel_err_all']} of its norm")
    name, worst = res["worst_grad_rel_err"][0]
    require(worst <= SP_GRAD_REL_TOL,
            f"{label} gate: {name} gradient off by {worst} of its norm")
    torch.cuda.empty_cache()
    return res


def run_parallel_cell(torch, fa, transformer, train, label, argv, wanted,
                      gate):
    """``argv`` through ``transformer.build`` and ``train.train_loop`` in
    this one process (every shard a unit), after ``gate`` (the parity
    gate at init); launch counts gated at ``wanted(args)``. Prints the
    fenced step seconds and the peak memory."""
    gate_res = gate()
    args = transformer.parse_args(argv)
    built = transformer.build(args)
    loop = drive_train(torch, fa, train, built, args, label, wanted(args))
    res = {"argv": argv,
           "params": sum(p.numel() for p in built.model.parameters()),
           **loop,
           "step_ms_median_steps_1_on": 1e3 * statistics.median(
               loop["step_seconds"][1:]),
           "tokens_per_s_median_steps_1_on": args.batch * args.seq_len
           / statistics.median(loop["step_seconds"][1:]),
           "smoke_reading": f"{args.steps} steps from a cold start, every "
                            f"shard in one process on one card; not a "
                            f"throughput measurement",
           "gate_at_init": gate_res,
           "nvidia_smi": nvidia_smi_line()}
    del built
    torch.cuda.empty_cache()
    return res


def run_tensor_parallel(torch, fa, transformer, train):
    """examples/tpujob-tensor-parallel.yml's payload as written
    (--tensor-parallel 4 --dim 4096 --layers 16 --batch 16 --remat; heads
    4: head dim 1024, the wide kernels), 4 steps with the four shards as
    units in this process. Gate: at init on a 2-layer copy, TP 4 against
    TP 1 (--split-qkv on, the same params). Launches: K1 twice per layer,
    shard and step (full remat re-runs the forward), dq and dkv once.
    Then the same 4 steps at --tensor-parallel 1 (a comparison, not this
    slice's path: its launches are gated but kept apart), so the two loss
    trajectories stand side by side."""
    one = with_flags(TP_ARGV, tensor_parallel=1, split_qkv="on")

    def wanted(args):
        per = args.layers * args.tensor_parallel * args.steps
        return {"flash_fwd": 2 * per, "flash_bwd_dq": per,
                "flash_bwd_dkv": per, "flash_merge": 0, "flash_decode": 0}

    res = run_parallel_cell(
        torch, fa, transformer, train, "tensor_parallel", TP_ARGV, wanted,
        lambda: gate_parity(torch, transformer, "tensor_parallel", TP_ARGV,
                            one, 2))
    args = transformer.parse_args(one)
    built = transformer.build(args)
    tp1 = drive_train(torch, fa, train, built, args, "tensor_parallel TP 1",
                      wanted(args))
    del built
    torch.cuda.empty_cache()
    res["tp1_same_flags"] = {
        "argv": one, "launches": tp1["launches"],
        "loss_trajectory": tp1["loss_trajectory"],
        "step_ms_median_steps_1_on": 1e3 * statistics.median(
            tp1["step_seconds"][1:]),
        "peak_memory_gb": tp1["peak_memory_gb"]}
    res["loss_gap_tp4_minus_tp1"] = [
        a - b for a, b in zip(res["loss_trajectory"],
                              tp1["loss_trajectory"])]
    return res


def run_sp_tp(torch, fa, transformer, train):
    """examples/tpujob-3d-parallel.yml's payload as written (T 16384,
    --seq-parallel 4 --tensor-parallel 2, dim 2048, 16 heads, 12 layers,
    --remat, batch 8), 2 steps: each TP shard runs its own 4-shard ring
    on its 8 heads, all in this process. Gate: at init on a 2-layer copy,
    against --tensor-parallel 1 (--split-qkv on) at the same
    --seq-parallel 4. Launches: K4 2 x 16 per layer, TP shard and step
    (the ring's N^2 merges; full remat re-runs the forward ring), dq and
    dkv 16, K1 never."""
    one = with_flags(SP_TP_ARGV, tensor_parallel=1, split_qkv="on")

    def wanted(args):
        per = args.layers * args.tensor_parallel * args.steps \
            * args.seq_parallel ** 2
        return {"flash_merge": 2 * per, "flash_bwd_dq": per,
                "flash_bwd_dkv": per, "flash_fwd": 0, "flash_decode": 0}

    return run_parallel_cell(
        torch, fa, transformer, train, "sp_tp", SP_TP_ARGV, wanted,
        lambda: gate_parity(torch, transformer, "sp_tp", SP_TP_ARGV, one, 1))


def run_ulysses(torch, fa, transformer, train, ring_step_ms):
    """The SP bench row (bench.py:661, lm_longctx_T8192_gqa) with
    --seq-parallel 4 --sp-mode ulysses in place of the striped ring, 4
    steps as train_sp runs it. Gate: at init on a 2-layer copy, against
    the ring (contiguous) at the same weights. Launches: K1, dq and dkv
    once per layer, microbatch and step (one call over the heads of all
    four shards; dots_attn saves K1's outputs), K4 never.
    ``ring_step_ms``: train_sp's median step."""
    ring = [a for a in ULYSSES_ARGV if a not in ("--sp-mode", "ulysses")]

    def wanted(args):
        per = args.layers * args.grad_accum * args.steps
        return {"flash_fwd": per, "flash_bwd_dq": per, "flash_bwd_dkv": per,
                "flash_merge": 0, "flash_decode": 0}

    res = run_parallel_cell(
        torch, fa, transformer, train, "ulysses", ULYSSES_ARGV, wanted,
        lambda: gate_parity(torch, transformer, "ulysses", ULYSSES_ARGV,
                            ring, 1))
    res["ring_step_ms_median_steps_1_on"] = ring_step_ms
    return res


# --- phases: pipeline_tp, moe_tp ------------------------------------------------

# examples/tpujob-pipeline-tp.yml's payload as written; every other flag at
# its default (dim 256, 4 heads: head dim 64 and one head a TP shard; T
# 256; vocab 256; adam).
PIPE_TP_ARGV = ["--steps", "4", "--layers", "32", "--pipeline", "4",
                "--tensor-parallel", "4", "--schedule", "1f1b",
                "--microbatches", "16", "--batch", "64", "--zero1",
                *COMMON_ARGV]
# examples/tpujob-moe-tp.yml's payload as written (4 layers, T 256, vocab
# 256, MHA: head dim 64, 8 heads a TP shard; einsum dispatch; adam).
MOE_TP_ARGV = ["--steps", "4", "--experts", "8", "--expert-parallel", "4",
               "--tensor-parallel", "2", "--capacity-factor", "1.25",
               "--dim", "1024", "--heads", "16", "--batch", "32",
               *COMMON_ARGV]


def gate_report(label, res) -> dict:
    """``res`` (:func:`compare_grads`) held to SP_LOSS_TOL,
    SP_GRAD_GLOBAL_TOL and SP_GRAD_REL_TOL, as :func:`gate_parity` holds
    its sides."""
    res.pop("_ratios", None)
    res["tol"] = (f"loss {SP_LOSS_TOL}; the whole gradient "
                  f"{SP_GRAD_GLOBAL_TOL} and each parameter "
                  f"{SP_GRAD_REL_TOL} of the reference side's norm")
    require(res["loss_abs_err"] <= SP_LOSS_TOL,
            f"{label} gate: loss gap {res['loss_abs_err']}")
    require(res["grad_rel_err_all"] <= SP_GRAD_GLOBAL_TOL,
            f"{label} gate: the whole gradient off by "
            f"{res['grad_rel_err_all']} of its norm")
    name, worst = res["worst_grad_rel_err"][0]
    require(worst <= SP_GRAD_REL_TOL,
            f"{label} gate: {name} gradient off by {worst} of its norm")
    return res


def gate_pipeline_tp(torch, pipeline, argv, other_argv):
    """At init, on copies of ``argv`` and ``other_argv`` with 2 layers a
    stage, from the same seed (the init depends on neither the stages nor
    the shards: the same params), one batch of the job's rows through
    ``Pipeline.loss_and_grads``: the loss and every parameter's gradient
    of ``argv`` against ``other_argv`` (:func:`gate_report`)."""
    from tpu_operator_torch.payload import data as data_mod

    sides = []
    for flags in (argv, other_argv):
        args = pipeline.parse_args(flags)
        args = pipeline.parse_args(with_flags(
            flags, layers=GATE_LAYERS * args.pipeline))
        sides.append(pipeline.build(args))
    a, b = (side.model.params for side in sides)
    require(list(a) == list(b), "pipeline_tp gate: the param trees differ")
    require(all(torch.equal(a[n], b[n]) for n in a),
            "pipeline_tp gate: the two seeded inits differ")
    (tok,) = next(data_mod.synthetic_lm(1, args.batch, args.seq_len,
                                        vocab=args.vocab))
    tokens = torch.from_numpy(tok).to(args.device)
    got, want = ((float(loss), grads) for loss, grads in (
        side.pipeline.loss_and_grads(tokens) for side in sides))
    res = gate_report("pipeline_tp", compare_grads(got, want))
    res.update(rows=int(tokens.shape[0]), layers=args.layers)
    del sides, got, want
    torch.cuda.empty_cache()
    return res


def gate_moe_tp(torch, F, moe, argv, other_argv):
    """At init, on ``GATE_LAYERS``-layer copies of ``argv`` and
    ``other_argv`` (block 1 MoE) from the same seed, one batch of the
    job's rows through ``moe.make_moe_loss``: the total loss and every
    parameter's gradient with the routes pinned (``RoutePin``: the
    ``other_argv`` side records each layer's choices and ``argv``'s
    replays them; the split reorders the bf16 sums of the row-parallel
    products, which can flip a choice near a tie), gated by
    :func:`gate_report`; then ``argv``'s loss routing its own way, its
    gap and its first choices apart by layer beside them, the loss gap
    gated at SP_LOSS_TOL too. drop_frac, aux and z of both sides."""
    from tpu_operator_torch.payload import data as data_mod

    models = []
    for flags in (argv, other_argv):
        args = moe.parse_args(with_flags(flags, layers=GATE_LAYERS))
        models.append(moe.build(args).model)
    names = [[n for n, _ in m.named_parameters()] for m in models]
    require(names[0] == names[1], "moe_tp gate: the param trees differ")
    require(all(torch.equal(x, y) for x, y in zip(
        models[0].parameters(), models[1].parameters())),
        "moe_tp gate: the two seeded inits differ")
    (tok,) = next(data_mod.synthetic_lm(1, args.batch, args.seq_len,
                                        vocab=args.vocab))
    tokens = torch.from_numpy(tok).to(args.device)
    pin = RoutePin(torch, F, moe)

    def run(model, side):
        with pin.side(side):
            total, metrics = moe.make_moe_loss(model, args)(tokens)
            total.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        return (float(total.detach()), grads), {
            k: float(v) for k, v in metrics.items()}

    want, want_m = run(models[1], "kernels")
    got, got_m = run(models[0], "tp")
    res = gate_report("moe_tp", compare_grads(got, want))
    def free_run():
        total, metrics = moe.make_moe_loss(models[0], args)(tokens)
        return float(total), {k: float(v) for k, v in metrics.items()}

    with torch.no_grad():
        (free, free_m), flips = pin.free(free_run)
    res.update(rows=int(tokens.shape[0]), layers=GATE_LAYERS,
               metrics_pinned={"tp": got_m, "tp1": want_m},
               unpinned={"total_loss": free, "metrics": free_m,
                         "total_loss_abs_err": abs(free - want[0]),
                         "first_choices_apart_by_moe_layer": flips,
                         "tokens_a_layer": int(tokens.numel())})
    require(res["unpinned"]["total_loss_abs_err"] <= SP_LOSS_TOL,
            f"moe_tp gate: the loss routing its own way, "
            f"{res['unpinned']}")
    del models, got, want
    torch.cuda.empty_cache()
    return res


def run_tp_job(torch, fa, train, mod, label, argv, wanted, gate_res):
    """``argv`` (an example job's payload) through ``mod.build`` and
    ``train.train_loop`` with every shard a unit of this one process,
    launches gated at ``wanted(args)``; then the same steps at
    ``--tensor-parallel 1 --split-qkv on`` (a comparison, not this
    slice's path: its launches are gated but kept apart), so the step
    times, peak memory and loss trajectories stand side by side."""
    res = {"argv": argv, "gate_at_init": gate_res}
    for side, flags in (("tp", argv),
                        ("tp1", with_flags(argv, tensor_parallel=1,
                                           split_qkv="on"))):
        args = mod.parse_args(flags)
        built = mod.build(args)
        params = sum(t.numel() for t in built.state.params.values())
        loop = drive_train(torch, fa, train, built, args,
                           f"{label} {side}", wanted(args))
        del built
        torch.cuda.empty_cache()
        loop.update(params=params, step_ms_median_steps_1_on=1e3
                    * statistics.median(loop["step_seconds"][1:]))
        if side == "tp":
            res.update(loop)
        else:
            res["tp1_same_flags"] = {"argv": flags, **loop}
    res["loss_gap_tp_minus_tp1"] = [
        a - b for a, b in zip(res["loss_trajectory"],
                              res["tp1_same_flags"]["loss_trajectory"])]
    res["smoke_reading"] = (f"{len(res['loss_trajectory'])} steps from a "
                            f"cold start, every shard in one process on one "
                            f"card; not a throughput measurement")
    res["nvidia_smi"] = nvidia_smi_line()
    return res


def run_pipeline_tp(torch, fa, pipeline, train):
    """examples/tpujob-pipeline-tp.yml's payload as written (32 layers,
    --pipeline 4 --tensor-parallel 4, 1f1b over 16 microbatches of 4 rows,
    --zero1; head dim 64, one head a shard), 4 steps with the 4 stages and
    4 shards as units in this process. Gate: at init on a 2-layer-a-stage
    copy, against --tensor-parallel 1 --split-qkv on. Launches: K1 twice
    per layer, microbatch, shard and step (1f1b's input stash: the
    backward re-runs the forward), dq and dkv once."""
    one = with_flags(PIPE_TP_ARGV, tensor_parallel=1, split_qkv="on")

    def wanted(args):
        per = args.layers * args.microbatches * args.tensor_parallel \
            * args.steps
        return {"flash_fwd": 2 * per, "flash_bwd_dq": per,
                "flash_bwd_dkv": per, "flash_merge": 0, "flash_decode": 0}

    return run_tp_job(torch, fa, train, pipeline, "pipeline_tp",
                      PIPE_TP_ARGV, wanted,
                      gate_pipeline_tp(torch, pipeline, PIPE_TP_ARGV, one))


def run_moe_tp(torch, F, fa, moe, train):
    """examples/tpujob-moe-tp.yml's payload as written (8 experts over
    --expert-parallel 4 --tensor-parallel 2, dim 1024, 16 heads, batch 32
    x 256, capacity factor 1.25; head dim 64, 8 heads a shard), 4 steps
    with every expert and shard in this process. Gate: at init on a
    2-layer copy against --tensor-parallel 1 --split-qkv on, routes
    pinned (:func:`gate_moe_tp`). Launches: K1, dq and dkv once per
    layer, shard and step. drop_frac, aux and z of every step printed
    beside TP 1's."""
    one = with_flags(MOE_TP_ARGV, tensor_parallel=1, split_qkv="on")

    def wanted(args):
        per = args.layers * args.grad_accum * args.tensor_parallel \
            * args.steps
        return {"flash_fwd": per, "flash_bwd_dq": per, "flash_bwd_dkv": per,
                "flash_merge": 0, "flash_decode": 0}

    res = run_tp_job(torch, fa, train, moe, "moe_tp", MOE_TP_ARGV, wanted,
                     gate_moe_tp(torch, F, moe, MOE_TP_ARGV, one))
    for side in (res, res["tp1_same_flags"]):
        mt = side["metric_trajectories"]
        require(all(0.0 <= d <= 1.0 for d in mt["drop_frac"]),
                f"moe_tp: drop_frac outside [0, 1]: {mt['drop_frac']}")
        require(all(0.0 < a <= 8 for a in mt["aux_loss"]),
                f"moe_tp: aux_loss outside (0, E]: {mt['aux_loss']}")
    return res


# --- phase: defaults ----------------------------------------------------------


def run_defaults(torch, fa, transformer, pipeline, moe, serve, bootstrap):
    """Each LM entry point at its default flags on the card:
    ``python -m tpu_operator_torch.payload.transformer``, ``.pipeline``
    and ``.moe`` with ``--steps 3`` in fresh processes (exit 0; the
    launches each logs at its end: K1, dq and dkv layers x microbatches x
    steps; the three processes run at once, so each one's seconds are
    its wall beside the others), and the server at its defaults under a
    short load in this process (K1 and K3 launched, every request
    completed). Head dims 64, 64, 32 and 16: K1 / K2's own D 64 for the
    first two, the wrappers' zero padding for the others."""
    out = {}
    mods = (("transformer", transformer), ("pipeline", pipeline),
            ("moe", moe))
    argv = ["--steps", "3", "--log-every", "1", "--checkpoint-dir", "",
            "--profile-dir", ""]
    runs = _attempts_together([(argv, _payload_env({}), name)
                               for name, _mod in mods], timeout=300)
    for (name, mod), (code, seconds, log) in zip(mods, runs):
        args = mod.parse_args(argv)
        require(code == 0, f"defaults {name}: exit {code}\n{log[-3000:]}")
        counts = _logged_launches(log)
        micro = args.microbatches if name == "pipeline" else args.grad_accum
        per = args.layers * micro * args.steps
        for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            require(counts[kernel] == per,
                    f"defaults {name}: {kernel} launched {counts[kernel]} "
                    f"times, wanted {per}")
        final = [ln for ln in log.splitlines() if "final: loss" in ln]
        out[name] = {"head_dim": args.dim // args.heads,
                     "kernel_head_dim": fa.kernel_head_dim(
                         "flash_fwd", args.dim // args.heads),
                     "launches": counts, "seconds": seconds,
                     "final": final[-1].split("final: ", 1)[1]
                     if final else None}
    args = serve.parse_args(["--load", "2:1", "--device", "cuda",
                             "--http-port", "0", "--checkpoint-dir", ""])
    loop = serve.ServeLoop(args, bootstrap.process_info_from_env({}),
                           heartbeat=None, recorder=None)
    fa.reset_launch_counts()
    summary = loop.run()
    torch.cuda.synchronize()
    counts = fa.launch_counts()
    require(counts["flash_fwd"] > 0 and counts["flash_decode"] > 0
            and summary["completed"] == summary["arrivals"] > 0
            and not summary["failedSteps"],
            f"defaults serve: launches {counts}, summary {summary}")
    out["serve"] = {"head_dim": args.dim // args.heads,
                    "kernel_head_dims": {
                        k: fa.kernel_head_dim(k, args.dim // args.heads)
                        for k in ("flash_fwd", "flash_decode")},
                    "launches": counts,
                    "completed": summary["completed"]}
    return out


# --- phase: classifier -------------------------------------------------------


# cifar at its defaults (ResNet-20, widths 16/32/64, batch 1024, sgd 0.1 /
# 0.9), 20 steps.
CIFAR_ARGV = ["--steps", "20", "--log-every", "0", "--seed", "0",
              "--device", "cuda", "--checkpoint-dir", "",
              "--profile-dir", ""]
CIFAR_CPU_STEPS = 5
# Card against CPU, the same port from the same weights on the same
# batches: bf16 convolutions round apart (cuDNN and oneDNN), and sgd at lr
# 0.1 carries it on; the CPU tests see 1.3e-3 over 5 steps between the
# port and the reference.
CIFAR_CPU_LOSS_TOL = 2e-2


def run_classifier(torch, cifar, train, checkpoint, steptrace):
    """The classifier payloads on the card:

    - ``cifar`` at its defaults, 20 steps through cifar.build and
      train.train_loop: every loss finite, the last below the first; the
      first CIFAR_CPU_STEPS losses against a CPU run of the same port from
      the same weights on the same batches, within CIFAR_CPU_LOSS_TOL;
      images/s over steps 6-20;
    - a kill and resume through checkpoint.Checkpointer (6 steps unbroken;
      run A 3 steps, saved; run B restores 3 and trains 4-6): B's losses,
      params, BatchNorm statistics and sgd trace bit-equal to the unbroken
      run's;
    - ``python -m tpu_operator_torch.payload.linear --steps 200`` in a
      subprocess on the card exits 0 (it runs beside the CPU check and
      the resume, after the timed steps).

    Returns the readings and the 20-step build (for its profile)."""
    import shutil
    import tempfile

    args = cifar.parse_args(CIFAR_ARGV)
    built = cifar.build(args)
    init = {k: v.detach().cpu().clone()
            for k, v in built.model.state_dict().items()}
    losses, seconds, _rows = _ckpt_drive(torch, train, steptrace, built,
                                         args.steps, None)
    require(all(x == x and abs(x) < float("inf") for x in losses)
            and losses[-1] < losses[0],
            f"cifar: losses {losses} are not finite or do not descend")
    step_times = _fenced_step_seconds(torch, built)
    env = {k: v for k, v in os.environ.items() if k != "TPUJOB_STATUS_URL"}
    t0 = time.perf_counter()
    lin = subprocess.Popen(
        [sys.executable, "-m", "tpu_operator_torch.payload.linear",
         "--steps", "200"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)

    cpu = cifar.build(cifar.parse_args(
        [a if a != "cuda" else "cpu" for a in CIFAR_ARGV]))
    cpu.model.load_state_dict(init)
    cpu_losses, cpu_seconds, _rows = _ckpt_drive(torch, train, steptrace,
                                                 cpu, CIFAR_CPU_STEPS, None)
    gaps = [abs(a - b) for a, b in zip(losses, cpu_losses)]
    require(max(gaps) <= CIFAR_CPU_LOSS_TOL,
            f"cifar: card losses {losses[:CIFAR_CPU_STEPS]} vs CPU "
            f"{cpu_losses}: gap {max(gaps)} > {CIFAR_CPU_LOSS_TOL}")
    del cpu

    resume_argv = ["--steps", "6", *CIFAR_ARGV[2:]]
    rargs = cifar.parse_args(resume_argv)
    whole = cifar.build(rargs)
    w_losses, _s, _rows = _ckpt_drive(torch, train, steptrace, whole,
                                      rargs.steps, None)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_cifar_")
    try:
        run_a = cifar.build(rargs)
        ck_a = checkpoint.Checkpointer(ckdir, save_every=3)
        a_losses, _s, _rows = _ckpt_drive(torch, train, steptrace, run_a, 3,
                                          ck_a)
        ck_a.close()
        run_b = cifar.build(rargs)
        ck_b = checkpoint.Checkpointer(ckdir, save_every=3)
        b_losses, _s, _rows = _ckpt_drive(torch, train, steptrace, run_b,
                                          rargs.steps, ck_b)
        ck_b.close()
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    require(a_losses == w_losses[:3] and b_losses == w_losses[3:],
            f"cifar resume: losses A {a_losses} B {b_losses} vs unbroken "
            f"{w_losses}")
    def tensors(state):
        return {**state.params, **state.batch_stats,
                **state.opt.state_dict()}

    want, got = tensors(whole.state), tensors(run_b.state)
    off = [n for n, t in want.items() if not torch.equal(t, got[n])]
    require(not off, f"cifar resume: state differs from the unbroken "
                     f"run's: {off[:8]}")
    del whole, run_a, run_b
    torch.cuda.empty_cache()

    try:
        _out, lin_err = lin.communicate(timeout=300)
    finally:
        if lin.poll() is None:
            lin.kill()
            lin.wait()
    lin_s = time.perf_counter() - t0
    final = [ln for ln in lin_err.splitlines() if "final loss" in ln]
    require(lin.returncode == 0,
            f"linear exited {lin.returncode}: {lin_err[-2000:]}")
    median = statistics.median(step_times)
    return {"model": "cifar ResNet-20 (payload.cifar defaults), 20 steps",
            "argv": CIFAR_ARGV, "loss_trajectory": losses,
            "loop_seconds": seconds,
            "fenced_step_seconds": step_times,
            "images_per_s": args.batch / median,
            "cpu_check": {"steps": CIFAR_CPU_STEPS, "cpu_losses": cpu_losses,
                          "gaps": gaps, "tol": CIFAR_CPU_LOSS_TOL,
                          "cpu_seconds": cpu_seconds},
            "resume": {"unbroken": w_losses, "run_a": a_losses,
                       "run_b": b_losses, "bit_equal": True},
            "linear": {"exit_code": lin.returncode, "seconds": lin_s,
                       "final": final[-1] if final else ""},
            "nvidia_smi": nvidia_smi_line()}, built


# --- phase: classifier_tp ----------------------------------------------------


# The classifier cell with --model-parallel 2: both shards as units on the
# card (stage-2 convs 32 of 64 channels a shard, the head 5 of 10 classes).
CIFAR_TP_ARGV = [*CIFAR_ARGV, "--model-parallel", "2"]
# The gate at init (--model-parallel 2 against 1, the same params, one
# batch). The forward is the same function: each unit's conv is the whole
# conv's channel slice, so the logits agree up to cuDNN choosing another
# algorithm for the half-width conv (a bf16 rounding of an activation,
# 2^-8 of it, that BatchNorm and the pool average down): the loss to
# 1e-3 of ln 10. The backward differs by construction: each unit's input
# gradient is a bf16 product of its own channels, summed in f32 across the
# units, where one conv rounds the sum once; the CPU tests see 1.3e-2 of
# a BatchNorm bias's gradient (which BatchNorm nearly cancels) and 1.6e-6
# with f32 convs. So the whole gradient to 2^-7 of its norm and each
# param's to 2^-5 of its own (tests/test_torch_classifier_tp.py's bound);
# a missing sum over the units or a wrong channel slice is off by O(1).
CIFAR_TP_LOSS_TOL = 1e-3
CIFAR_TP_GRAD_GLOBAL_TOL = 2.0 ** -7
CIFAR_TP_GRAD_REL_TOL = 2.0 ** -5


def _fenced_step_seconds(torch, built, reps: int = 5) -> list:
    """``reps`` steps on one batch, each fenced by a synchronize."""
    x, y = (torch.from_numpy(a).to(built.device)
            for a in next(built.batches))
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        built.step(x, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def gate_classifier_tp(torch, cifar):
    """At init, ``--model-parallel 2`` (both shards as units) against 1
    from the same seed on the same batch: the params equal, then the loss
    and every gradient, gated at CIFAR_TP_LOSS_TOL,
    CIFAR_TP_GRAD_GLOBAL_TOL and CIFAR_TP_GRAD_REL_TOL."""
    sides = []
    for argv in (CIFAR_TP_ARGV, CIFAR_ARGV):
        built = cifar.build(cifar.parse_args(argv))
        sides.append(built)
    names = [[n for n, _ in b.model.named_parameters()] for b in sides]
    require(names[0] == names[1], "classifier_tp gate: the param trees differ")
    require(all(torch.equal(a, b) for a, b in zip(
        sides[0].model.parameters(), sides[1].model.parameters())),
        "classifier_tp gate: the two seeded inits differ")
    x, y = (torch.from_numpy(a).to(sides[0].device)
            for a in next(sides[0].batches))
    out = []
    for built in sides:
        logits, _stats = built.model(x)
        loss = torch.nn.functional.cross_entropy(logits, y.long())
        loss.backward()
        out.append((float(loss.detach()),
                    {n: p.grad for n, p in built.model.named_parameters()},
                    logits.detach()))
    (got_loss, got, got_logits), (want_loss, want, want_logits) = out
    num = sum(float((got[n] - g).float().norm() ** 2) for n, g in want.items())
    den = sum(float(g.float().norm() ** 2) for g in want.values())
    rel = sorted(((float((got[n] - g).norm() / g.norm()), n)
                  for n, g in want.items()), reverse=True)
    res = {"loss": got_loss, "loss_model_1": want_loss,
           "loss_abs_err": abs(got_loss - want_loss),
           "logits_max_abs_err": float((got_logits - want_logits).abs().max()),
           "logits_bit_equal": bool(torch.equal(got_logits, want_logits)),
           "grad_rel_err_all": (num / den) ** 0.5,
           "worst_grad_rel_err": [[n, r] for r, n in rel[:4]],
           "rows": int(x.shape[0]),
           "tol": f"loss {CIFAR_TP_LOSS_TOL}; the whole gradient "
                  f"{CIFAR_TP_GRAD_GLOBAL_TOL} and each parameter "
                  f"{CIFAR_TP_GRAD_REL_TOL} of model 1's norm"}
    del sides, out, got, want
    torch.cuda.empty_cache()
    require(res["loss_abs_err"] <= CIFAR_TP_LOSS_TOL,
            f"classifier_tp gate: loss gap {res['loss_abs_err']}")
    require(res["grad_rel_err_all"] <= CIFAR_TP_GRAD_GLOBAL_TOL,
            f"classifier_tp gate: the whole gradient off by "
            f"{res['grad_rel_err_all']} of its norm")
    require(rel[0][0] <= CIFAR_TP_GRAD_REL_TOL,
            f"classifier_tp gate: {rel[0][1]} gradient off by {rel[0][0]} "
            f"of its norm")
    return res


def run_classifier_tp(torch, cifar, train, checkpoint, steptrace, cls):
    """``payload.cifar`` at its defaults with ``--model-parallel 2``
    (CIFAR_TP_ARGV), both shards as units on the card:

    - the gate at init against ``--model-parallel 1``
      (:func:`gate_classifier_tp`);
    - 20 steps through cifar.build and train.train_loop: every loss
      finite, the last below the first; images/s over five fenced steps
      beside the ``classifier`` phase's (``cls``), and the peak memory;
    - a kill and resume through checkpoint.Checkpointer at model 2 (6
      steps unbroken; run A 3 steps, saved; run B restores 3 and trains
      4-6): B's losses, params, BatchNorm statistics and sgd trace
      bit-equal to the unbroken run's; then B's last step restored into a
      ``--model-parallel 1`` build: every param, statistic and trace
      bit-equal to B's (one process holds both shards, so its tensors are
      the whole arrays the checkpoint holds)."""
    import shutil
    import tempfile

    gate = gate_classifier_tp(torch, cifar)
    torch.cuda.reset_peak_memory_stats()
    args = cifar.parse_args(CIFAR_TP_ARGV)
    built = cifar.build(args)
    losses, seconds, _rows = _ckpt_drive(torch, train, steptrace, built,
                                         args.steps, None)
    require(all(x == x and abs(x) < float("inf") for x in losses)
            and losses[-1] < losses[0],
            f"classifier_tp: losses {losses} are not finite or do not "
            f"descend")
    step_times = _fenced_step_seconds(torch, built)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del built
    torch.cuda.empty_cache()

    resume_argv = ["--steps", "6", *CIFAR_TP_ARGV[2:]]
    rargs = cifar.parse_args(resume_argv)
    whole = cifar.build(rargs)
    w_losses, _s, _rows = _ckpt_drive(torch, train, steptrace, whole,
                                      rargs.steps, None)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_cifar_tp_")
    try:
        run_a = cifar.build(rargs)
        ck_a = checkpoint.Checkpointer(ckdir, save_every=3)
        a_losses, _s, _rows = _ckpt_drive(torch, train, steptrace, run_a, 3,
                                          ck_a)
        ck_a.close()
        run_b = cifar.build(rargs)
        ck_b = checkpoint.Checkpointer(ckdir, save_every=3)
        b_losses, _s, _rows = _ckpt_drive(torch, train, steptrace, run_b,
                                          rargs.steps, ck_b)
        ck_b.close()
        one = cifar.build(cifar.parse_args(
            with_flag(resume_argv, "--model-parallel", "1")))
        ck_one = checkpoint.Checkpointer(ckdir)
        try:
            _state, one_step = ck_one.restore(one.state)
        finally:
            ck_one.close()
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    require(a_losses == w_losses[:3] and b_losses == w_losses[3:],
            f"classifier_tp resume: losses A {a_losses} B {b_losses} vs "
            f"unbroken {w_losses}")

    def tensors(state):
        return {**state.params, **state.batch_stats,
                **state.opt.state_dict()}

    want, got = tensors(whole.state), tensors(run_b.state)
    off = [n for n, t in want.items() if not torch.equal(t, got[n])]
    require(not off, f"classifier_tp resume: state differs from the "
                     f"unbroken run's: {off[:8]}")
    require(one_step == rargs.steps,
            f"classifier_tp: the model-1 restore found step {one_step}")
    mine = tensors(one.state)
    off = [n for n, t in got.items() if not torch.equal(t, mine[n])]
    require(not off, f"classifier_tp: restored at model 1, {off[:8]} "
                     f"differ from the model-2 run's")
    del whole, run_a, run_b, one
    torch.cuda.empty_cache()
    median = statistics.median(step_times)
    cls_median = statistics.median(cls["fenced_step_seconds"])
    return {"model": "cifar ResNet-20 (payload.cifar defaults) with "
                     "--model-parallel 2, both shards as units on one card",
            "argv": CIFAR_TP_ARGV, "loss_trajectory": losses,
            "loop_seconds": seconds, "fenced_step_seconds": step_times,
            "images_per_s": args.batch / median,
            "classifier_images_per_s": args.batch / cls_median,
            "step_ms_over_classifier": median / cls_median,
            "peak_memory_gb": peak_gb,
            "gate_at_init": gate,
            "resume": {"unbroken": w_losses, "run_a": a_losses,
                       "run_b": b_losses, "bit_equal": True,
                       "restored_at_model_1_step": one_step,
                       "model_1_bit_equal": True},
            "nvidia_smi": nvidia_smi_line()}


# --- the warm-restart and operator-runtime phases ----------------------------


class HeartbeatListener:
    """A local status server: collects every ``POST /api/heartbeat`` body
    and answers with ``respond(body)`` (a JSON object)."""

    def __init__(self, respond=None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.bodies = []
        self._lock = threading.Lock()
        self._respond = respond or (lambda _body: {})
        listener = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 — http.server API
                length = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(length) or b"{}")
                with listener._lock:
                    listener.bodies.append(body)
                    ack = listener._respond(body)
                data = json.dumps(ack).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *_args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def beats(self):
        with self._lock:
            return list(self.bodies)

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self._thread.join(timeout=10)


def _flag(argv, flag):
    return argv[argv.index(flag) + 1]


def with_flag(argv, flag, value):
    """``argv`` with ``flag``'s value replaced (appended when absent)."""
    out = list(argv)
    if flag in out:
        out[out.index(flag) + 1] = value
    else:
        out += [flag, value]
    return out


# One flagship step holds 4.9 GB; the warm-restart phase keeps at most two
# per directory and two in the store at once.
WARM_MIN_FREE = 4 * CKPT_BYTES
WARM_JOB = {"TPUJOB_NAMESPACE": "smoke", "TPUJOB_NAME": "warm"}


def _attempt(argv, env, timeout=900, payload="transformer"):
    """One attempt of a payload (default the transformer) in a fresh
    process: exit code, wall seconds and its log."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"tpu_operator_torch.payload.{payload}",
         *argv], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=timeout)
    return proc.returncode, time.perf_counter() - t0, \
        proc.stdout + proc.stderr


def _attempts_together(runs, timeout=900):
    """``_attempt`` of each (argv, env, payload) in ``runs``, all started
    at once: [(exit code, wall seconds, log)] in order."""
    import tempfile

    procs = []
    t0 = time.perf_counter()
    for argv, env, payload in runs:
        out = tempfile.TemporaryFile(mode="w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", f"tpu_operator_torch.payload.{payload}",
             *argv], cwd=ROOT, env=env, stdout=out,
            stderr=subprocess.STDOUT, text=True), out))
    results = []
    for proc, out in procs:
        try:
            code = proc.wait(timeout=max(1.0, timeout - (
                time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            code = proc.wait()
        seconds = time.perf_counter() - t0
        out.seek(0)
        results.append((code, seconds, out.read()))
        out.close()
    return results


def _logged_launches(log: str) -> dict:
    lines = [ln for ln in log.splitlines() if "kernel launches: " in ln]
    require(lines, "the attempt logged no kernel launch counts")
    return json.loads(lines[-1].split("kernel launches: ", 1)[1])


def _payload_env(extra: dict) -> dict:
    """The caller's environment without any operator variable, plus
    ``extra``."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPUJOB_", "TPU_", "JAX_"))}
    env.update(extra)
    return env


def run_warm_restart(torch, build, checkpoint, store_mod, unbroken):
    """Attempt 0 and attempt 1 of the train cell (TRAIN_ARGV) as
    ``python -m tpu_operator_torch.payload.transformer`` processes, with
    the operator's store, cache and heartbeat env, a local listener as
    the status server:

    - attempt 0: an empty cache dir and a ``localfs`` store; 3 steps,
      saves 1 and 3 (the write-behind uploader ships them and the kernel
      library it built with nvcc), exits 0;
    - a fresh node: attempt 1 (TPUJOB_ATTEMPT=1) with an empty local
      checkpoint dir, an empty cache dir and ``NVCC`` pointed at a command
      that fails: it must prefetch step 3 and the library during the
      rendezvous, report ``cacheHit`` true (no nvcc: a build would have
      failed the attempt), resume at step 3, train 4-6 and exit 0; the
      losses its beats carry and its final params and optimizer state
      (step 6 on disk) bit-equal to the checkpoint phase's unbroken run.

    Prints both attempts' startup breakdowns. Returns the readings and
    the phase's directory (the serve_reload phase reads its store)."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_warm_")
    free = shutil.disk_usage(root).free
    require(free >= WARM_MIN_FREE,
            f"warm_restart: {free / 1e9:.1f} GB free under "
            f"{os.path.dirname(root)}, needs {WARM_MIN_FREE / 1e9:.1f} GB; "
            f"set TMPDIR to a larger volume")
    store_uri = os.path.join(root, "store")
    listener = HeartbeatListener()
    failing_nvcc = shutil.which("false") or "/bin/false"
    readings = {}
    try:
        for attempt, steps in ((0, 3), (1, 6)):
            ckdir = os.path.join(root, f"ckpt{attempt}")
            cache = os.path.join(root, f"cache{attempt}")
            os.makedirs(ckdir)
            os.makedirs(cache)
            extra = {**WARM_JOB, "TPUJOB_STORE_URI": store_uri,
                     "TPUJOB_STORE_KEEP": "1",
                     "TPUJOB_STORE_PARALLELISM": "8",
                     "TPUJOB_STATUS_URL": listener.url,
                     # Every step's beat is due (a step takes ~0.55 s),
                     # while the startup ticker posts at 5 Hz, not 100.
                     "TPUJOB_HEARTBEAT_INTERVAL": "0.2",
                     "TPUJOB_ATTEMPT": str(attempt),
                     "TPU_CHECKPOINT_DIR": ckdir,
                     "JAX_COMPILATION_CACHE_DIR": cache}
            if attempt == 1:
                extra["NVCC"] = failing_nvcc
            argv = with_flag(with_flag(
                with_flag(TRAIN_ARGV, "--steps", str(steps)),
                "--checkpoint-dir", ckdir), "--checkpoint-every", "3")
            seen = len(listener.beats())
            torch.cuda.empty_cache()
            code, wall, log = _attempt(argv, _payload_env(extra))
            require(code == 0, f"warm_restart attempt {attempt} exited "
                               f"{code}: {log[-4000:]}")
            beats = [b for b in listener.beats()[seen:]
                     if b.get("attempt") == attempt]
            breakdowns = [b["startup"] for b in beats if "startup" in b]
            require(len(breakdowns) == 1,
                    f"attempt {attempt}: {len(breakdowns)} startup "
                    f"breakdowns on its beats")
            readings[f"attempt{attempt}"] = {
                "wall_s": wall, "startup": breakdowns[0],
                "startup_stages_posted": sorted(
                    {b["startupStage"] for b in beats
                     if "startupStage" in b}),
                "launches": _logged_launches(log),
                "restored": [ln.split(" - ")[-1] for ln in log.splitlines()
                             if "restored checkpoint step" in ln],
                "beats": [{k: b[k] for k in ("step", "loss") if k in b}
                          for b in beats if "step" in b],
            }
            if attempt == 0:
                store = store_mod.WarmStartStore(
                    store_mod.blob.from_uri(store_uri), prefix="smoke/warm")
                require(store.last_uploaded_step() == 3,
                        f"attempt 0 left step {store.last_uploaded_step()} "
                        f"in the store, wanted 3")
                libs = [k for k in store.backend.list("smoke/warm/cache/")
                        if k.endswith(build.lib_name(build.source_digest()))]
                require(libs, "attempt 0 shipped no kernel library")
                readings["store_after_attempt0"] = store.summary()
                # A fresh node: nothing of attempt 0 stays local.
                shutil.rmtree(ckdir)
                shutil.rmtree(cache)
        first, second = readings["attempt0"], readings["attempt1"]
        require(first["startup"].get("cacheHit") is False,
                f"attempt 0 startup {first['startup']}: wanted a cold "
                f"build (cacheHit false)")
        require(second["startup"].get("cacheHit") is True
                and second["startup"].get("prefetchHit") is True,
                f"attempt 1 startup {second['startup']}: wanted cacheHit "
                f"and prefetchHit true")
        require(any("step 3" in r for r in second["restored"]),
                f"attempt 1 did not restore step 3: {second['restored']}")
        per_path = (int(_flag(TRAIN_ARGV, "--layers"))
                    * int(_flag(TRAIN_ARGV, "--grad-accum")) * 3)
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            for key in ("attempt0", "attempt1"):
                require(readings[key]["launches"][name] == per_path,
                        f"warm_restart {key}: {name} launched "
                        f"{readings[key]['launches'][name]} times, wanted "
                        f"{per_path}")
        # A beat at step s carries the newest fenced loss: step s - 1's,
        # the first step's own on the first beat (the loop's fence).
        start, mismatched = 3, []
        for b in second["beats"]:
            index = start if b["step"] == start + 1 else b["step"] - 2
            if "loss" in b and b["loss"] != unbroken["losses"][index]:
                mismatched.append((b["step"], b["loss"],
                                   unbroken["losses"][index]))
        require(len(second["beats"]) >= 3 and not mismatched,
                f"attempt 1 losses differ from the unbroken run's: "
                f"{mismatched}")
        step6 = os.path.join(root, "ckpt1", "6")
        params = torch.load(os.path.join(step6, checkpoint.PARAMS_FILE),
                            weights_only=True)
        opt = torch.load(os.path.join(step6, checkpoint.OPT_FILE),
                         weights_only=True)
        off = [n for n, t in unbroken["params"].items()
               if not torch.equal(params[n], t)]
        off += [n for n, t in unbroken["opt"].items()
                if n not in opt or not torch.equal(opt[n], t)]
        require(not off, f"attempt 1's step 6 differs from the unbroken "
                         f"run's state: {off[:8]}")
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise
    finally:
        listener.close()
    for key in ("attempt0", "attempt1"):
        readings[key].pop("beats")
    return {
        "model": "lm_flagship_gqa_kv4 (bench.py:636), as written",
        "argv": TRAIN_ARGV, "env": sorted(WARM_JOB) + [
            "TPUJOB_STORE_URI (localfs)", "TPUJOB_STORE_KEEP=1",
            "JAX_COMPILATION_CACHE_DIR", "TPU_CHECKPOINT_DIR",
            "TPUJOB_STATUS_URL"],
        **readings,
        "resumed_bit_equal": True,
        "nvidia_smi": nvidia_smi_line(),
    }, root


# The serve cell's flags (the serve phase's), under a steady load.
SERVE_ARGV = ["--batch", "8", "--window", "1920", "--decode-tokens", "128",
              "--page-size", "16", "--vocab", "32768", "--dim", "2048",
              "--heads", "16", "--kv-heads", "4", "--layers", "8",
              "--queue-deadline", "600", "--seed", "0", "--device", "cuda",
              "--reload-poll", "0.5", "--reload-stagger", "0"]
RELOAD_LOAD = "2:40"
GREEDY_TOKENS = 16


def greedy(loop, prompt, new_tokens):
    """The replica's greedy tokens for ``prompt`` decoded alone in slot 0
    (the loop must be idle)."""
    import numpy as np

    admitted, token = loop.engine.admit(0, prompt, new_tokens, loop.model)
    require(admitted, "greedy: the engine refused the prompt")
    out = [int(token)]
    active = np.zeros(loop.args.batch, bool)
    active[0] = True
    while len(out) < new_tokens:
        out.append(int(loop.engine.step(loop.model, active)[0]))
    loop.engine.release(0)
    return out


def run_serve_reload(torch, fa, serve, bootstrap, store_mod, root):
    """A ServeLoop at the serve cell's flags with ``TPUJOB_SERVE`` set and
    the warm_restart phase's store (its ``localfs`` root, the serving
    job's prefix), under a steady load (RELOAD_LOAD): it starts on step
    3 in its local dir; once it has served a few steps, attempt 1's
    verified step 6 is uploaded to the store. Gates: one reload, loaded
    step 6, nothing shed or failed, every request completed, the live KV
    pages of in-flight requests untouched by the swap, K1 and K3
    launched; then the greedy tokens of a fixed prompt equal a fresh
    server's loaded at step 6. Prints the readiness gap."""
    import shutil

    import numpy as np

    local = os.path.join(root, "replica")
    os.makedirs(local)
    os.rename(os.path.join(root, "ckpt1", "3"), os.path.join(local, "3"))
    step6 = os.path.join(root, "ckpt1", "6")
    env = {"TPUJOB_SERVE": "1",
           "TPUJOB_STORE_URI": os.path.join(root, "store"),
           "TPUJOB_NAMESPACE": "smoke", "TPUJOB_NAME": "warm-serve"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        args = serve.parse_args(SERVE_ARGV + ["--load", RELOAD_LOAD,
                                              "--checkpoint-dir", local])
        loop = serve.ServeLoop(args, bootstrap.process_info_from_env({}),
                               heartbeat=None, recorder=None)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    require(loop.store is not None and loop.store.prefix
            == "smoke/warm-serve", "serve_reload: no store from the env")
    swaps = []
    real_reload = loop._maybe_reload

    def watched_reload():
        before = {s: loop.engine.cache.slot_pages(s)
                  for s in range(args.batch)}
        if all(p is None for p in before.values()):
            # Hold the armed target for a boundary with requests in
            # flight: those are the pages the swap must leave alone.
            return False
        ran = real_reload()
        if ran:
            swaps.append((before, {s: loop.engine.cache.slot_pages(s)
                                   for s in range(args.batch)}))
        return ran

    loop._maybe_reload = watched_reload
    uploaded = {}

    def upload_mid_run():
        while loop.steps < 50:
            time.sleep(0.05)
        t0 = time.perf_counter()
        store_mod.WarmStartStore(
            store_mod.blob.from_uri(env["TPUJOB_STORE_URI"]),
            prefix="smoke/warm-serve", upload_parallelism=8
        ).upload_checkpoint(step6, 6)
        uploaded["seconds"] = time.perf_counter() - t0
        uploaded["at_step"] = loop.steps

    uploader = threading.Thread(target=upload_mid_run, daemon=True)
    uploader.start()
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    summary = loop.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fa.launch_counts()
    uploader.join(timeout=600)
    require(summary["reloads"] == 1 and summary["loadedStep"] == 6,
            f"serve_reload: {summary['reloads']} reloads, loaded step "
            f"{summary['loadedStep']} (wanted 1 reload to step 6; upload "
            f"{uploaded})")
    require(summary["shed"] == 0 and summary["failedSteps"] == 0
            and summary["completed"] == summary["arrivals"] > 0,
            f"serve_reload: {summary['completed']}/{summary['arrivals']} "
            f"completed, {summary['shed']} shed, {summary['failedSteps']} "
            f"failed steps")
    require(len(summary["reloadGapSeconds"]) == 1,
            f"serve_reload: {len(summary['reloadGapSeconds'])} readiness "
            f"drops for one newer step")
    require(len(swaps) == 1 and swaps[0][0] == swaps[0][1]
            and any(p is not None for p in swaps[0][0].values()),
            "serve_reload: the swap changed live KV pages (or ran with "
            "no request in flight)")
    require(counts["flash_fwd"] > 0 and counts["flash_decode"] > 0,
            f"serve_reload: kernel launches {counts}")
    rng = np.random.default_rng(23)
    prompt = rng.integers(0, args.vocab, min(700, args.window)).astype(
        np.int32)
    with torch.inference_mode():
        after = greedy(loop, prompt, GREEDY_TOKENS)
    del loop
    torch.cuda.empty_cache()
    fresh = serve.ServeLoop(
        serve.parse_args(SERVE_ARGV + ["--load", "0:0", "--checkpoint-dir",
                                       local]),
        bootstrap.process_info_from_env({}), heartbeat=None, recorder=None,
        store=None)
    require(fresh._restore_weights() == 6,
            "serve_reload: the fresh server did not load step 6")
    with torch.inference_mode():
        want = greedy(fresh, prompt, GREEDY_TOKENS)
    del fresh
    torch.cuda.empty_cache()
    require(after == want, f"serve_reload: tokens after the reload {after} "
                           f"!= a fresh server's at step 6 {want}")
    shutil.rmtree(root, ignore_errors=True)
    return {"argv": SERVE_ARGV, "load": RELOAD_LOAD,
            "reloads": summary["reloads"],
            "loaded_step": summary["loadedStep"],
            "readiness_gap_s": summary["reloadGapSeconds"],
            "upload_s": uploaded.get("seconds"),
            "upload_at_decode_step": uploaded.get("at_step"),
            "completed": summary["completed"],
            "arrivals": summary["arrivals"], "shed": summary["shed"],
            "failed_steps": summary["failedSteps"], "wall_s": wall,
            "tokens_per_s": summary["tokensPerSecond"],
            "launches": counts, "greedy_tokens": after,
            "greedy_equal_to_fresh_server": True,
            "nvidia_smi": nvidia_smi_line()}


# cifar at its defaults with autotune on: two windows of 8 steps close.
AUTOTUNE_STEPS = 20
AUTOTUNE_ENV = {"TPUJOB_DATAPLANE_PREFETCH_DEPTH": "0",
                "TPUJOB_DATAPLANE_AUTOTUNE": "1",
                "TPUJOB_DATAPLANE_WINDOW_STEPS": "8"}


def dataplane_problems(dp, adjustment_keys) -> list:
    """What the reference's status server (``_sanitize_dataplane``) would
    refuse or drop in a ``dataPlane`` body: unknown keys, non-integer or
    negative knobs, a non-boolean hostAsync, unknown adjustment keys."""
    bad = []
    if not isinstance(dp, dict):
        return ["not an object"]
    for key, value in dp.items():
        if key in ("prefetchDepth", "hostDropped", "checkpointIntervalSteps"):
            floor = 1 if key == "checkpointIntervalSteps" else 0
            if isinstance(value, bool) or not isinstance(value, int) \
                    or value < floor:
                bad.append(f"{key}={value!r}")
        elif key == "hostAsync":
            if not isinstance(value, bool):
                bad.append(f"hostAsync={value!r}")
        elif key == "adjustments":
            for k, v in value.items():
                if k not in adjustment_keys or isinstance(v, bool) \
                        or not isinstance(v, int) or v < 0:
                    bad.append(f"adjustments.{k}={v!r}")
        else:
            bad.append(f"unknown key {key}")
    return bad


def run_autotune(torch, cifar, train, autotune, heartbeat, steptrace, fa):
    """``payload.cifar`` at its defaults, AUTOTUNE_STEPS steps with the
    operator's autotune env (a window of 8 steps: two windows close) and,
    beside it, a static run from the same seeded init: the losses
    bit-equal (the knobs move timing only), every ``dataPlane`` body the
    run posted acceptable to the reference's sanitizer; the adjustments
    and images/s of both runs printed (no gate on speed)."""
    listener = HeartbeatListener()
    runs = {}
    try:
        for name in ("static", "autotune"):
            args = cifar.parse_args(with_flag(CIFAR_ARGV, "--steps",
                                              str(AUTOTUNE_STEPS)))
            built = cifar.build(args)
            runtime = None
            if name == "autotune":
                runtime = autotune.from_env(prefetch=2, env=AUTOTUNE_ENV)
            rep = heartbeat.HeartbeatReporter(
                listener.url, "smoke-autotune", interval=0.0)
            losses, starts = [], []

            def step(images, labels, built=built):
                starts.append(time.perf_counter())
                metrics = built.step(images, labels)
                losses.append(metrics["loss"])
                return metrics

            seen = len(listener.beats())
            torch.cuda.synchronize()
            fa.reset_launch_counts()
            train.train_loop(step, built.batches, AUTOTUNE_STEPS,
                             device=built.device, heartbeat=rep,
                             steptrace=steptrace.StepRecorder(),
                             dataplane=runtime)
            torch.cuda.synchronize()
            end = time.perf_counter()
            sent = [b["dataPlane"] for b in listener.beats()[seen:]
                    if "dataPlane" in b]
            steady = starts[8:] + [end]
            runs[name] = {
                "losses": [float(x) for x in losses],
                "images_per_s": args.batch * (len(steady) - 1)
                / (steady[-1] - steady[0]),
                "dataplane_beats": len(sent),
                "last_dataplane": sent[-1] if sent else None,
                "launches": fa.launch_counts(),
                "windows": (runtime.controller.windows_evaluated
                            if runtime is not None else 0)}
            problems = [p for dp in sent
                        for p in dataplane_problems(
                            dp, autotune.ADJUSTMENT_KEYS)]
            require(not problems, f"autotune: dataPlane bodies the "
                                  f"reference would refuse: {problems}")
            del built
            torch.cuda.empty_cache()
    finally:
        listener.close()
    require(runs["autotune"]["losses"] == runs["static"]["losses"],
            "autotune: losses differ from the static run's")
    require(runs["autotune"]["windows"] == 2
            and runs["autotune"]["dataplane_beats"] == AUTOTUNE_STEPS
            and runs["static"]["dataplane_beats"] == 0,
            f"autotune: windows {runs['autotune']['windows']}, dataPlane "
            f"beats {runs['autotune']['dataplane_beats']} / static "
            f"{runs['static']['dataplane_beats']}")
    for r in runs.values():
        r["loss_first_last"] = [r["losses"][0], r["losses"][-1]]
        r.pop("losses")
    return {"model": "cifar ResNet-20 (payload.cifar defaults)",
            "steps": AUTOTUNE_STEPS, "env": AUTOTUNE_ENV, **runs,
            "losses_bit_equal": True, "nvidia_smi": nvidia_smi_line()}


PROFILE_STEPS = 9
PROFILE_WINDOW = (1, 3)
PROFILE_DIRECTIVE = {"id": "smoke-profile", "steps": 4}


def _trace_kernels(path: str) -> dict:
    """Device kernel names in a Chrome trace, counted by K1 / K2."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [e.get("name", "") for e in events
               if e.get("cat") == "kernel"]
    return {"kernel_events": len(kernels),
            "flash_fwd": sum("flash_fwd" in k for k in kernels),
            "flash_bwd": sum("flash_bwd" in k for k in kernels)}


def run_profile(torch, fa, transformer, train, heartbeat, steptrace,
                profile):
    """The train cell (TRAIN_ARGV) for PROFILE_STEPS steps with the loop's
    own ``--profile-dir`` window over steps 2-3, and a local status server
    that answers the beats after step 4 with a profile directive of 4
    steps (the window is closed by then, so the capture may trace). Gates:
    the window's trace and the capture's trace name the port's flash_fwd
    and flash_bwd kernels; the artifact holds 4 laps merged with the
    recorder's rows; the next beat carries the result; K1 and K2 launched
    layers x microbatches x steps times."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    listener = HeartbeatListener(
        lambda body: {"profile": PROFILE_DIRECTIVE}
        if body.get("step", 0) >= 4 else {})
    saved = os.environ.get("TPU_CHECKPOINT_DIR")
    os.environ["TPU_CHECKPOINT_DIR"] = os.path.join(root, "artifacts")
    try:
        args = transformer.parse_args(with_flag(TRAIN_ARGV, "--steps",
                                                str(PROFILE_STEPS)))
        built = transformer.build(args)
        rep = heartbeat.HeartbeatReporter(listener.url, "smoke-profile",
                                          interval=0.0)
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        train.train_loop(built.step, built.batches, PROFILE_STEPS,
                         device=built.device, heartbeat=rep,
                         steptrace=steptrace.StepRecorder(),
                         profile_dir=os.path.join(root, "window"),
                         profile_range=PROFILE_WINDOW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = fa.launch_counts()
        del built
        torch.cuda.empty_cache()
        beats = listener.beats()
        results = [(b["step"], b["profile"]) for b in beats
                   if "profile" in b]
        artifact_path = os.path.join(root, "artifacts",
                                     "profile-smoke-profile.json")
        require(os.path.isfile(artifact_path),
                "profile: no artifact written")
        with open(artifact_path) as f:
            artifact = json.load(f)
        laps = artifact["steps"]
        require(len(laps) == 4 and all(
            {"wallSeconds", "dataWait", "compute", "stepSeconds"} <= set(r)
            for r in laps), f"profile: the artifact's laps {laps}")
        require(len(results) == 1 and results[0][1] == {
            "id": PROFILE_DIRECTIVE["id"], "capturedSteps": 4}
            and results[0][0] == laps[-1]["step"] + 1,
            f"profile: results on the beats {results}")
        (window_trace,) = os.listdir(os.path.join(root, "window"))
        window = _trace_kernels(os.path.join(root, "window", window_trace))
        capture = _trace_kernels(os.path.join(
            artifact["jaxTraceDir"], profile.TRACE_FILE))
        for name, seen in (("window", window), ("capture", capture)):
            require(seen["flash_fwd"] > 0 and seen["flash_bwd"] > 0,
                    f"profile: the {name} trace names no flash kernel: "
                    f"{seen}")
        per_path = args.layers * args.grad_accum * PROFILE_STEPS
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            require(counts[name] == per_path,
                    f"profile: {name} launched {counts[name]} times, "
                    f"wanted {per_path}")
        trace_bytes = os.path.getsize(os.path.join(
            artifact["jaxTraceDir"], profile.TRACE_FILE))
    finally:
        listener.close()
        if saved is None:
            os.environ.pop("TPU_CHECKPOINT_DIR", None)
        else:
            os.environ["TPU_CHECKPOINT_DIR"] = saved
        shutil.rmtree(root, ignore_errors=True)
    return {"argv": with_flag(TRAIN_ARGV, "--steps", str(PROFILE_STEPS)),
            "profile_range": list(PROFILE_WINDOW),
            "directive": PROFILE_DIRECTIVE, "result_beat": results[0],
            "laps": [{k: r[k] for k in ("step", "wallSeconds", "compute")}
                     for r in laps],
            "window_trace": window, "capture_trace": capture,
            "capture_trace_mb": trace_bytes / 1e6, "loop_s": wall,
            "launches": counts, "nvidia_smi": nvidia_smi_line()}


def _classify(op: str) -> str:
    if "flash_merge" in op:
        return "K4 flash_merge"
    if "flash_fwd" in op:
        return "K1 flash_fwd"
    if "flash_bwd" in op:
        return "K2 flash_bwd"
    if any(s in op for s in ("fprop", "dgrad", "wgrad", "conv", "cudnn")):
        return "cuDNN convolutions"
    if any(s in op for s in ("gemm", "nvjet", "cutlass", "xmma", "sm90_")):
        return "cuBLAS"
    return "other (elementwise, reductions, copies)"


def profile_step(torch, built):
    """One full training step of ``built`` (its microbatches + the
    optimizer update) under torch.profiler beside the host clock, after
    one unprofiled step: the breakdown and the device ms by group."""
    from torch.profiler import ProfilerActivity, profile

    batch = [torch.from_numpy(a).to(built.device)
             for a in next(built.batches)]
    built.step(*batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        built.step(*batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(torch, prof, 1)
    groups: dict = {}
    for key, ms, _n in rows:
        groups[_classify(key)] = groups.get(_classify(key), 0.0) + ms
    return {**_breakdown(rows, wall), "by_group_ms": groups}


def profile_train(torch, built):
    """One full training step (:func:`profile_step`), and the optimizer
    update alone, beside the host clock."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    step = profile_step(torch, built)
    params = [p for p in built.model.parameters() if p.requires_grad]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        built.optimizer.step(params, built.opt_state)
        torch.cuda.synchronize()
        opt_wall = (time.perf_counter() - t0) * 1e3
    opt_rows = _device_rows(torch, prof, 1)
    return {"train_step": step,
            "adam_update": _breakdown(opt_rows, opt_wall)}


# --- four cards: the TP job's model under --fsdp -----------------------------


# examples/tpujob-tensor-parallel.yml's payload with --fsdp in place of
# --tensor-parallel 4.
FSDP_CARDS_ARGV = ["--steps", "4", "--fsdp", "--dim", "4096", "--layers",
                   "16", "--batch", "16", "--remat", "--seed", "0",
                   "--log-every", "0", "--device", "cuda",
                   "--checkpoint-dir", "", "--profile-dir", ""]


def fsdp_card_steps(torch, transformer, argv) -> dict:
    """Build ``argv`` on this process's card and train its steps, each
    fenced (synchronized before and after): the losses, the step ms, the
    peak memory after the build and over the steps, and the shards."""
    torch.cuda.reset_peak_memory_stats()
    args = transformer.parse_args(argv)
    built = transformer.build(args)
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(args.steps):
        (tokens,) = next(built.batches)
        tokens = torch.from_numpy(tokens).to(built.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(built.step(tokens)["loss"]))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return {"losses": losses, "step_ms": ms,
            "build_peak_gb": build_peak,
            "steps_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "params_here": sum(p.numel() for p in built.model.parameters()),
            "shards": sum(getattr(p, "fsdp", None) is not None
                          for p in built.model.parameters())}


def fsdp_card_worker(rank: int, world: int, port: int, out: str) -> int:
    """One process of the four-card run: an NCCL group over
    ``127.0.0.1:port``, card ``rank``; writes its reading to ``out``."""
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from tpu_operator_torch.payload import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        res = fsdp_card_steps(torch, transformer, FSDP_CARDS_ARGV)
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump({"rank": rank, **res}, f)
    return 0


def fsdp_cards(world: int) -> int:
    """``--fsdp-cards N``: the TP job's model under --fsdp over N cards,
    then one card at the same flags without it."""
    sys.path.insert(0, ROOT)
    import tempfile

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"chip_smoke: --fsdp-cards {world} needs {world} CUDA cards",
              file=sys.stderr)
        return 1
    from tpu_operator_torch.kernels import build
    from tpu_operator_torch.payload import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__})
    build.library()  # once, before the workers load it
    port = free_port()
    tmp = tempfile.mkdtemp()
    outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--fsdp-worker",
         str(r), str(world), str(port), outs[r]]) for r in range(world)]
    try:
        codes = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(codes):
        emit({"phase": "failed", "error": f"worker exit codes {codes}"})
        return 1
    ranks = [json.load(open(o)) for o in outs]
    for r in ranks:
        emit({"phase": "fsdp_cards", **r})
    require(all(r["losses"] == ranks[0]["losses"] for r in ranks),
            "the ranks logged different losses")
    one = fsdp_card_steps(torch, transformer, [
        a for a in FSDP_CARDS_ARGV if a != "--fsdp"])
    emit({"phase": "fsdp_cards_one_card", **one})
    emit({"phase": "fsdp_cards_summary", "cards": world,
          "losses": ranks[0]["losses"], "one_card_losses": one["losses"],
          "step_ms": [statistics.median(r["step_ms"][1:]) for r in ranks],
          "one_card_step_ms": statistics.median(one["step_ms"][1:]),
          "peak_gb": [max(r["build_peak_gb"], r["steps_peak_gb"])
                      for r in ranks],
          "one_card_peak_gb": max(one["build_peak_gb"],
                                  one["steps_peak_gb"])})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# examples/torch/gpujob-tensor-parallel.yml's payload line as written
# (tests/test_torch_launch.py holds it to the file), and the steps and
# logging the gate reads: the tensor_parallel phase's 4 steps.
GPUJOB_TP_PAYLOAD = ["transformer", "--tensor-parallel", "4", "--dim",
                     "4096", "--layers", "16", "--batch", "16", "--remat"]
LAUNCH_CARDS_EXTRA = ["--steps", "4", "--seed", "0", "--log-every", "1",
                      "--checkpoint-dir", "", "--profile-dir", ""]


def launch_card_reading(lines, card: int) -> dict:
    """One card's losses, model group, peak memory and step ms from its
    log (the ms are the host clock between its logged steps 2 to the end:
    the loop logs a step once the one before it is fenced)."""
    log = card_log(lines, card)
    times = [t for t, ln in log if re.search(r" step \d+ loss ", ln)
             or " final: loss " in ln]
    mesh = [ln for _t, ln in log if "mesh: process " in ln]
    peak = [float(ln.split("peak memory: ", 1)[1].split(" GB")[0])
            for _t, ln in log if "peak memory: " in ln]
    require(mesh and peak, f"card {card}: no mesh or peak memory line")
    return {"card": card, "losses": logged_losses(log),
            "mesh": mesh[0].split("mesh: ", 1)[1],
            "peak_gb": peak[0],
            "step_ms_host_between_logged_steps": [
                1e3 * (b - a) for a, b in zip(times[1:], times[2:])]}


# TP 4 over NCCL against one card holding the four shards as units. The
# row-parallel partials and the gradients entering a shard are summed in
# shard order on one card, but by NCCL's ring all-reduce over four cards,
# which adds the four terms in a rank-rotated order per chunk: f32
# reassociation, so the losses are not bit-equal (TP 2 is: two terms
# commute). Step 1 within 1e-5 relative (measured 1.3e-6); step 2, after
# an adam step from gradients summed in another order, within 5e-3 (the
# CPU tests' bound for the steps after the first); from step 3 on the
# TP job's lr-3e-3 spike (a loss of ~24) amplifies any difference, so
# those steps are printed, not gated.
LAUNCH_CARDS_STEP1_RTOL = 1e-5
LAUNCH_CARDS_STEP2_ATOL = 5e-3


def launch_cards(world: int) -> int:
    """``--launch-cards N``: examples/torch/gpujob-tensor-parallel.yml's
    payload line as written through the pod launcher as one pod of N
    cards (TP 4 over NCCL at N 4), 4 steps; then one card holding the
    four shards as units at the same flags (the tensor_parallel phase's
    run). Gates: every card logs the same losses; against one card, steps
    1 and 2 within LAUNCH_CARDS_STEP1_RTOL / LAUNCH_CARDS_STEP2_ATOL (see
    there why not bit-equal)."""
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"chip_smoke: --launch-cards {world} needs {world} CUDA "
              f"cards", file=sys.stderr)
        return 1
    from tpu_operator_torch.payload import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__})
    t0 = time.perf_counter()
    code, lines = _streamed(
        [sys.executable, "-m", LAUNCH_MODULE, "--cards", str(world), "--",
         *GPUJOB_TP_PAYLOAD, *LAUNCH_CARDS_EXTRA], _launch_env(),
        timeout=1500)
    wall = time.perf_counter() - t0
    if code != 0:
        emit({"phase": "failed", "error": f"launcher exit {code}",
              "tail": [ln for _t, ln in lines[-40:]]})
        return 1
    cards = [launch_card_reading(lines, c) for c in range(world)]
    for r in cards:
        emit({"phase": "launch_cards", **r})
    require(all(r["losses"] == cards[0]["losses"] for r in cards),
            "the cards logged different losses")
    one = fsdp_card_steps(torch, transformer, TP_ARGV)
    gap = [a - b for a, b in zip(cards[0]["losses"], one["losses"])]
    emit({"phase": "launch_cards_summary", "cards": world,
          "launcher_wall_s": wall, "losses": cards[0]["losses"],
          "one_card_losses": one["losses"], "loss_gap": gap,
          "loss_gap_step1_relative": gap[0] / one["losses"][0],
          "step_ms": [statistics.median(r[
              "step_ms_host_between_logged_steps"]) for r in cards],
          "peak_gb": [r["peak_gb"] for r in cards],
          "one_card_step_ms": statistics.median(one["step_ms"][1:]),
          "one_card_peak_gb": max(one["build_peak_gb"],
                                  one["steps_peak_gb"]),
          "one_card_params": one["params_here"]})
    require(abs(gap[0]) <= LAUNCH_CARDS_STEP1_RTOL * abs(one["losses"][0])
            and abs(gap[1]) <= LAUNCH_CARDS_STEP2_ATOL,
            f"TP {world} over NCCL parts from one card holding the shards "
            f"as units by {gap}")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def timed_case(case: dict) -> dict:
    """A decode case's numbers, its ``ms`` the CUDA-event time where the
    profiler recorded no device time for it (late in a run it keeps
    only some launches, or none)."""
    out = dict(case)
    if not isinstance(out.get("ms"), float):
        out["ms"] = out["event_ms"]
        out["ms_is"] = "CUDA events: the profiler recorded no device time"
        out["share_of_bound"] = out["bound_ms"] / out["ms"]
    return out


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import torch.nn.functional as F

        from tpu_operator_torch.kernels import build
        from tpu_operator_torch.payload import autotune
        from tpu_operator_torch.payload import bootstrap
        from tpu_operator_torch.payload import checkpoint
        from tpu_operator_torch.payload import cifar
        from tpu_operator_torch.payload import data
        from tpu_operator_torch.payload import flash_attention as fa
        from tpu_operator_torch.payload import heartbeat
        from tpu_operator_torch.payload import models
        from tpu_operator_torch.payload import moe
        from tpu_operator_torch.payload import pipeline
        from tpu_operator_torch.payload import profile
        from tpu_operator_torch.payload import ring_attention as ring_mod
        from tpu_operator_torch.payload import serve
        from tpu_operator_torch.payload import steptrace
        from tpu_operator_torch.payload import store as store_mod
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
    started = time.monotonic()
    try:
        emit({"phase": "device", **device, "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda})
        t0 = time.monotonic()
        lib_path = build.build()
        build.library()
        lines, per_kernel = ptxas_report(
            build.log_path(build.BUILD_DIR).read_text())
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
            dec["padded_d64"], mrg["padded_d64"] = check_padded_decode_merge(
                torch, fa)
            emit({"phase": "kernels", "kernel": "padded_decode_merge",
                  "flash_decode": dec["padded_d64"],
                  "flash_merge": mrg["padded_d64"]})
        bwd = check_flash_bwd(torch, fa, F, gen)
        emit({"phase": "kernels", "kernel": "flash_bwd", **bwd})
        wide = check_wide_heads(torch, fa, F)
        emit({"phase": "wide_heads", **wide})
        par = check_parallel_shapes(torch, fa, F)
        emit({"phase": "parallel_shapes", **par})
        emit({"phase": "autograd", **check_attention_autograd(torch, fa)})
        rng = check_ring(torch, fa, ring_mod, gen)
        emit({"phase": "ring", **rng})
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sv, loop = run_serve(torch, fa, serve, bootstrap)
        emit({"phase": "serve", **sv})
        emit({"phase": "profile", **profile_engine(torch, loop)})
        torch.cuda.reset_peak_memory_stats()
        spod = run_serve_pod(torch, fa, serve, bootstrap, loop,
                             sv["http_answer"])
        emit({"phase": "serve_pod", **spod})
        del loop
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        svw = run_serve_wide(torch, fa, serve, bootstrap)
        emit({"phase": "serve_wide", **svw})
        torch.cuda.empty_cache()
        tr, built = run_train(torch, fa, transformer, train, data)
        emit({"phase": "train", **tr})
        emit({"phase": "profile_train", **profile_train(torch, built)})
        del built
        torch.cuda.empty_cache()
        fs = run_fsdp(torch, fa, transformer, train, tr)
        emit({"phase": "fsdp", **fs})
        torch.cuda.empty_cache()
        lch = run_launch(torch, transformer, tr)
        emit({"phase": "launch", **lch})
        ckp, unbroken = run_checkpoint(torch, fa, transformer, train, serve,
                                       bootstrap, checkpoint, steptrace)
        emit({"phase": "checkpoint", **ckp})
        torch.cuda.empty_cache()
        warm, warm_root = run_warm_restart(torch, build, checkpoint,
                                           store_mod, unbroken)
        del unbroken
        emit({"phase": "warm_restart", **warm})
        rld = run_serve_reload(torch, fa, serve, bootstrap, store_mod,
                               warm_root)
        emit({"phase": "serve_reload", **rld})
        torch.cuda.empty_cache()
        sp, built = run_train_sp(torch, fa, transformer, train, data)
        emit({"phase": "train_sp", **sp})
        emit({"phase": "profile_train_sp", **profile_train(torch, built)})
        del built
        torch.cuda.empty_cache()
        rmt = run_remat(torch, fa, transformer, train, models)
        emit({"phase": "remat", **rmt})
        a8 = run_adam8(torch, fa, transformer, train, checkpoint, steptrace)
        emit({"phase": "adam8", **a8})
        lc, built = run_longctx(torch, fa, transformer, train, data)
        emit({"phase": "longctx", **lc})
        emit({"phase": "profile_longctx", **profile_train(torch, built)})
        del built
        torch.cuda.empty_cache()
        mo = run_moe(torch, F, fa, moe, transformer, train, checkpoint,
                     steptrace, data)
        emit({"phase": "moe", **mo})
        torch.cuda.empty_cache()
        pp = run_pipeline(torch, fa, pipeline, transformer, train,
                          checkpoint, steptrace, data)
        emit({"phase": "pipeline", **pp})
        torch.cuda.empty_cache()
        dft = run_defaults(torch, fa, transformer, pipeline, moe, serve,
                           bootstrap)
        emit({"phase": "defaults", **dft})
        torch.cuda.empty_cache()
        tpr = run_tensor_parallel(torch, fa, transformer, train)
        emit({"phase": "tensor_parallel", **tpr})
        sptp = run_sp_tp(torch, fa, transformer, train)
        emit({"phase": "sp_tp", **sptp})
        uly = run_ulysses(torch, fa, transformer, train, 1e3 * statistics.median(
            sp["step_seconds"][1:]))
        emit({"phase": "ulysses", **uly})
        pptp = run_pipeline_tp(torch, fa, pipeline, train)
        emit({"phase": "pipeline_tp", **pptp})
        motp = run_moe_tp(torch, F, fa, moe, train)
        emit({"phase": "moe_tp", **motp})
        cls, built = run_classifier(torch, cifar, train, checkpoint,
                                    steptrace)
        emit({"phase": "classifier", **cls})
        emit({"phase": "profile_classifier", **profile_train(torch, built)})
        del built
        torch.cuda.empty_cache()
        ctp = run_classifier_tp(torch, cifar, train, checkpoint, steptrace,
                                cls)
        emit({"phase": "classifier_tp", **ctp})
        atn = run_autotune(torch, cifar, train, autotune, heartbeat,
                           steptrace, fa)
        emit({"phase": "autotune", **atn})
        prf = run_profile(torch, fa, transformer, train, heartbeat,
                          steptrace, profile)
        emit({"phase": "profile_directive", **prf})
    except SmokeFailure as e:
        emit({"phase": "failed", "error": str(e)})
        return 1
    serve_fwd, train_fwd = fwd["prefill_causal_gqa"], fwd["train_causal_gqa"]
    moe_fwd, moe_bwd = fwd["moe_causal_gqa"], bwd["moe_causal_gqa"]
    main_dec, main_bwd = timed_case(dec["full"]), bwd["train_causal_gqa"]
    wide_dec = timed_case(wide["decode"]["b_serve_tp_d1024"])
    ring_bwd = bwd["sp_ring_striped_given_d"]
    pipe_fwd, pipe_bwd = (x["pipeline_causal_mha_d64"] for x in (fwd, bwd))
    # This slice's path (serve_pod: the serve cell's K1 at the prefill
    # shape and K3 at the decode step's, on two engines of one card; the
    # launcher's pod counted by its serve process) leads K1's and K3's
    # lines; the earlier slices' paths (launch and fsdp: K1 and K2 at the
    # train shape; tensor_parallel, sp_tp, ulysses: K1 and K2 at the TP
    # job's shard shape, D 1024, K4 on sp_tp's ring; pipeline_tp and
    # moe_tp at their shard shapes) stay beside it.
    tp_fwd, tp_bwd = (wide[x]["tp_shard_d1024"] for x in ("fwd", "bwd"))
    pptp_fwd, pptp_bwd = (x["pipeline_tp_shard_d64"] for x in (fwd, bwd))
    motp_fwd, motp_bwd = (x["moe_tp_shard_d64"] for x in (fwd, bwd))
    tp_runs = {"tensor_parallel": tpr, "sp_tp": sptp, "ulysses": uly}
    slice_runs = {"pipeline_tp": pptp, "moe_tp": motp}
    tp_launches = {k: sum(r["launches"][k] for r in tp_runs.values())
                   for k in fa.LAUNCHES}
    slice_by_path = {k: {name: r["launches"][k]
                         for name, r in {**tp_runs, **slice_runs}.items()}
                     for k in fa.LAUNCHES}
    pipe_launches = {k: sum(r["launches"][k] for r in pp["runs"].values())
                     for k in fa.LAUNCHES}
    pipe_by_path = {k: {f"pipeline_{label}": r["launches"][k]
                        for label, r in pp["runs"].items()}
                    for k in fa.LAUNCHES}
    for k in pipe_by_path:
        pipe_by_path[k]["pipeline_dense"] = pp["dense"]["launches"][k]
        pipe_by_path[k].update({f"defaults_{name}": r["launches"][k]
                                for name, r in dft.items()})
    par_bwd = ("ulysses_bwd", "sp_tp_bwd_home", "sp_tp_bwd_earlier")
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
         "launches": spod["launches"]["flash_fwd"],
         "launches_by_path": {"serve_pod": spod["launches"]["flash_fwd"],
                              "serve_pod_launcher":
                                  spod["launcher"]["launches"]["flash_fwd"],
                              "launch": lch["launches"]["flash_fwd"],
                              "fsdp": fs["launches"]["flash_fwd"],
                              **slice_by_path["flash_fwd"],
                              **pipe_by_path["flash_fwd"],
                              "train": tr["launches"]["flash_fwd"],
                              "serve": sv["launches"]["flash_fwd"],
                              "serve_wide": svw["launches"]["flash_fwd"],
                              "checkpoint_resume":
                                  ckp["launches_run_b"]["flash_fwd"],
                              "adam8": a8["launches"]["flash_fwd"],
                              "longctx": lc["launches"]["flash_fwd"],
                              "moe": mo["launches"]["flash_fwd"],
                              "warm_restart_attempt1":
                                  warm["attempt1"]["launches"]["flash_fwd"],
                              "serve_reload": rld["launches"]["flash_fwd"],
                              "profile_directive":
                                  prf["launches"]["flash_fwd"],
                              **{f"remat_{k}": r["launches"]["flash_fwd"]
                                 for k, r in rmt["runs"].items()}},
         "max_abs_err": max(r["max_abs_err_O"] for r in
                            (*fwd.values(), *wide["fwd"].values(),
                             par["ulysses_fwd"])),
         "worst_err_over_tol": max(r["worst_err_over_tol_O"] for r in
                                   (*fwd.values(), *wide["fwd"].values(),
                                    par["ulysses_fwd"])),
         "longctx_shape": "longctx B1 T32768 H16 KVH4 D128 causal",
         **{f"longctx_{k}": lc["kernel_bounds"][k2] for k, k2 in (
             ("ms", "ms_fwd"), ("library_ms", "library_fwd_ms"),
             ("bound_ms", "bound_ms_fwd"), ("bound_by", "bound_by_fwd"))},
         "ulysses_slab_shape": "ulysses slab B2 T8192 H16 KVH4 causal",
         **{f"ulysses_slab_{k}": par["ulysses_fwd"][k] for k in (
             "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "share_of_bound")},
         # This slice's path (serve_pod) runs K1 at the prefill shape.
         "ms": serve_fwd["ms"], "plain_ms": serve_fwd["plain_ms"],
         "bound_ms": serve_fwd["bound_ms"],
         "bound_by": serve_fwd["bound_by"],
         "library_ms": serve_fwd["library_ms"],
         "library": "F.scaled_dot_product_attention",
         "share_of_bound": serve_fwd["share_of_bound"],
         "shape": "serve_pod / serve prefill B1 T1920 H16 KVH4 D128 causal",
         "pipeline_tp_shape": "pipeline_tp shard B4 T256 H1 D64 causal",
         **{f"pipeline_tp_{k}": pptp_fwd[k] for k in (
             "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "share_of_bound")},
         "moe_tp_shape": "moe_tp shard B32 T256 H8 KVH8 D64 causal",
         **{f"moe_tp_{k}": motp_fwd[k] for k in (
             "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "share_of_bound")},
         "tensor_parallel_shape": "tensor_parallel shard B16 T2048 H1 "
                                  "D1024 causal (wide path)",
         **{f"tensor_parallel_{k}": tp_fwd[k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "library", "device_ms", "share_of_bound")},
         "wide_gqa_d256": {k: wide["fwd"]["gqa_d256"][k] for k in (
             "ms", "plain_ms", "library_ms", "library", "bound_ms",
             "share_of_bound")},
         "train_shape": "launch / fsdp / train B8 T2048",
         "train_ms": train_fwd["ms"],
         "train_plain_ms": train_fwd["plain_ms"],
         "train_bound_ms": train_fwd["bound_ms"],
         "train_library_ms": train_fwd["library_ms"],
         "train_tflops": train_fwd["tflops"],
         "train_share_of_bound": train_fwd["share_of_bound"],
         "serve_prefill_ms": serve_fwd["ms"],
         "serve_prefill_bound_ms": serve_fwd["bound_ms"],
         "serve_prefill_library_ms": serve_fwd["library_ms"],
         "serve_prefill_tflops": serve_fwd["tflops"],
         "serve_prefill_share_of_bound": serve_fwd["share_of_bound"],
         "moe_shape": "moe B8 T2048 H8 KVH4",
         **{f"moe_{k}": moe_fwd[k] for k in (
             "ms", "plain_ms", "library_ms", "bound_ms", "tflops",
             "share_of_bound")},
         "pipeline_shape": "pipeline B4 T2048 H16 KVH16 D64 causal",
         **{f"pipeline_{k}": pipe_fwd[k] for k in (
             "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "tflops", "share_of_bound")},
         "padded_d32_worst_err_over_tol":
             fwd["padded_d32_causal_gqa"]["worst_err_over_tol_O"]},
        {"name": "flash_decode", "route": "cuda",
         "source": "tpu_operator_torch/kernels/csrc/flash_decode.cu",
         "replaces": "tpu_operator/payload/flash_attention.py:990",
         "launches": spod["launches"]["flash_decode"],
         "launches_by_path": {"serve_pod":
                                  spod["launches"]["flash_decode"],
                              "serve_pod_launcher": spod["launcher"][
                                  "launches"]["flash_decode"],
                              "serve_wide": svw["launches"]["flash_decode"],
                              "serve": sv["launches"]["flash_decode"],
                              "serve_reload":
                                  rld["launches"]["flash_decode"],
                              "defaults_serve":
                                  dft["serve"]["launches"]["flash_decode"]},
         "padded_d64_worst_err_over_tol":
             dec["padded_d64"]["worst_err_over_tol"],
         "max_abs_err": max(r["max_abs_err"] for r in
                            (*dec.values(), *wide["decode"].values())),
         "worst_err_over_tol": max(r["worst_err_over_tol"] for r in
                                   (*dec.values(), *wide["decode"].values())),
         **{f"wide_{label}": {k: wide["decode"][label].get(k) for k in (
             "ms", "event_ms", "plain_ms", "library_ms", "library",
             "bound_ms", "share_of_bound", "cluster_size",
             "max_active_clusters")}
            for label in ("a_d256_ragged_tq1", "c_d256_full")},
         # This slice's path (serve_pod) runs K3 at the serve decode
         # step's shape; serve_wide's K3 wide case (b) beside it.
         **{k: main_dec.get(k) for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "share_of_bound", "ms_is", "event_ms")},
         "library": "F.scaled_dot_product_attention",
         "shape": "serve_pod / serve decode B8 Tq1 S2048 H16 KVH4 D128, "
                  "full length",
         "serve_wide_shape": "serve_wide decode B8 Tq1 S2048 H4 KVH4 "
                             "D1024, full length (wide path, a cluster "
                             "of 8)",
         **{f"serve_wide_{k}": wide_dec.get(k) for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "library", "share_of_bound", "ms_is", "event_ms",
             "cluster_size", "max_active_clusters")},
         "serve_wide_k3_ms_per_launch_profiled":
             svw["k3_wide_ms_per_launch"],
         "serve_shape": "serve decode B8 Tq1 S2048 H16 KVH4 D128, full "
                        "length",
         **{f"serve_{k}": main_dec.get(k) for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "share_of_bound", "ms_is", "library_ms_is", "event_ms",
             "library_event_ms")},
         "ptxas": {k: v for k, v in per_kernel.items()
                   if "flash_decode" in k}},
    ]
    for name, line in (("dq", 629), ("dkv", 665)):
        kernels.append({
            "name": f"flash_bwd_{name}", "route": "cuda",
            "source": "tpu_operator_torch/kernels/csrc/flash_bwd.cu",
            "replaces": f"tpu_operator/payload/flash_attention.py:{line}",
            "launches": lch["launches"][f"flash_bwd_{name}"],
            "launches_by_path": {
                "serve_pod": spod["launches"][f"flash_bwd_{name}"],
                "serve_pod_launcher":
                    spod["launcher"]["launches"][f"flash_bwd_{name}"],
                "launch": lch["launches"][f"flash_bwd_{name}"],
                "fsdp": fs["launches"][f"flash_bwd_{name}"],
                **slice_by_path[f"flash_bwd_{name}"],
                **pipe_by_path[f"flash_bwd_{name}"],
                "train_sp": sp["launches"][f"flash_bwd_{name}"],
                "train": tr["launches"][f"flash_bwd_{name}"],
                "checkpoint_resume":
                    ckp["launches_run_b"][f"flash_bwd_{name}"],
                "ring_check": rng["striped"]["launches"][f"flash_bwd_{name}"],
                "adam8": a8["launches"][f"flash_bwd_{name}"],
                "longctx": lc["launches"][f"flash_bwd_{name}"],
                "moe": mo["launches"][f"flash_bwd_{name}"],
                "warm_restart_attempt1":
                    warm["attempt1"]["launches"][f"flash_bwd_{name}"],
                "profile_directive": prf["launches"][f"flash_bwd_{name}"],
                **{f"remat_{k}": r["launches"][f"flash_bwd_{name}"]
                   for k, r in rmt["runs"].items()}},
            "max_abs_err": max(bwd_err[name], *(
                r[n]["max_abs_err"] for r in wide["bwd"].values()
                for n in (("dq",) if name == "dq" else ("dk", "dv"))), *(
                par[c][f"max_abs_err_{n}"] for c in par_bwd
                for n in (("dq",) if name == "dq" else ("dk", "dv")))),
            "worst_err_over_tol": max(bwd_excess_of[name], *(
                r[n]["worst_err_over_tol"] for r in wide["bwd"].values()
                for n in (("dq",) if name == "dq" else ("dk", "dv"))), *(
                par[c][f"worst_err_over_tol_{n}"] for c in par_bwd
                for n in (("dq",) if name == "dq" else ("dk", "dv")))),
            **{f"{c}_{k}": par[c][k] for c in par_bwd for k in (
                f"ms_{name}", f"bound_ms_{name}", f"bound_by_{name}",
                "plain_ms", "library_ms")},
            "longctx_shape": "longctx B1 T32768 H16 KVH4 D128 causal, fused "
                             "D, bf16 grads",
            **{f"longctx_{k}": lc["kernel_bounds"][k2] for k, k2 in (
                ("ms", f"ms_{name}"), ("library_ms", "library_bwd_ms"),
                ("bound_ms", f"bound_ms_{name}"),
                ("bound_by", f"bound_by_{name}"))},
            "ulysses_bwd_shape": "ulysses slab B2 T8192 H16 KVH4 causal, "
                                 "fused D, bf16 grads",
            "sp_tp_bwd_shape": "sp_tp chunk B8 Tq=Tk=4096 H8 KVH8, "
                               "(4096, 4096, 1) home and (4096, 0, 1) "
                               "earlier, given D, f32 grads",
            # Not on this slice's path: the launch path's K2 at the train
            # shape.
            "ms": main_bwd[f"ms_{name}"],
            "plain_ms": main_bwd["plain_ms"],
            "bound_ms": main_bwd[f"bound_ms_{name}"],
            "bound_by": main_bwd[f"bound_by_{name}"],
            "library_ms": main_bwd["library_ms"],
            "library": "F.scaled_dot_product_attention",
            "share_of_bound": main_bwd.get(f"share_of_bound_{name}"),
            "shape": "launch / fsdp / train B8 T2048 H16 KVH4 D128 causal, "
                     "fused D, bf16 grads",
            "plain_ms_is": "_bwd_ref: dq, dk and dv together",
            "library_ms_is": main_bwd.get("library_ms_is"),
            "pair_ms": main_bwd["ms_pair"],
            "pair_bound_ms": main_bwd.get("bound_ms_pair"),
            "pipeline_tp_shape": "pipeline_tp shard B4 T256 H1 D64 causal, "
                                 "fused D, bf16 grads",
            **{f"pipeline_tp_{k}": pptp_bwd.get(k) for k in (
                f"ms_{name}", f"bound_ms_{name}", f"bound_by_{name}",
                f"share_of_bound_{name}", "plain_ms", "library_ms",
                "ms_pair")},
            "moe_tp_shape": "moe_tp shard B32 T256 H8 KVH8 D64 causal, "
                            "fused D, bf16 grads",
            **{f"moe_tp_{k}": motp_bwd.get(k) for k in (
                f"ms_{name}", f"bound_ms_{name}", f"bound_by_{name}",
                f"share_of_bound_{name}", "plain_ms", "library_ms",
                "ms_pair")},
            "tensor_parallel_shape": "tensor_parallel shard B16 T2048 H1 "
                                     "D1024 causal (wide path; dkv's one "
                                     "cluster kernel)",
            **{f"tensor_parallel_{k}": tp_bwd.get(k) for k in (
                f"ms_{name}", "plain_ms", f"bound_ms_{name}",
                f"bound_by_{name}", "library_ms", "library",
                f"share_of_bound_{name}", "ms_pair", "bound_ms_pair")},
            "wide_gqa_d256": {k: wide["bwd"]["gqa_d256"][k] for k in (
                f"ms_{name}", f"bound_ms_{name}", "plain_ms", "library_ms",
                "library")},
            "train_shape": "train B8 T2048",
            "train_ms": main_bwd[f"ms_{name}"],
            "train_plain_ms": main_bwd["plain_ms"],
            "train_bound_ms": main_bwd[f"bound_ms_{name}"],
            "train_library_ms": main_bwd["library_ms"],
            "train_tflops": main_bwd.get(f"tflops_{name}"),
            "train_share_of_bound": main_bwd.get(f"share_of_bound_{name}"),
            "train_pair_ms": main_bwd["ms_pair"],
            "sp_ring_shape": "B2 Tq=Tk=2048 H16 KVH4, striped (1, 0, 4), "
                             "given D, f32 grads",
            "sp_ring_ms": ring_bwd[f"ms_{name}"],
            "sp_ring_bound_ms": ring_bwd[f"bound_ms_{name}"],
            "sp_ring_tflops": ring_bwd.get(f"tflops_{name}"),
            "sp_ring_share_of_bound": ring_bwd.get(f"share_of_bound_{name}"),
            "sp_ring_plain_ms": ring_bwd["plain_ms"],
            "sp_ring_library_ms": ring_bwd["library_ms"],
            "moe_shape": "moe B8 T2048 H8 KVH4",
            "moe_ms": moe_bwd[f"ms_{name}"],
            "moe_bound_ms": moe_bwd[f"bound_ms_{name}"],
            "moe_share_of_bound": moe_bwd.get(f"share_of_bound_{name}"),
            "moe_plain_ms": moe_bwd["plain_ms"],
            "moe_library_ms": moe_bwd["library_ms"],
            "pipeline_shape": "pipeline B4 T2048 H16 KVH16 D64 causal",
            "pipeline_ms": pipe_bwd[f"ms_{name}"],
            "pipeline_bound_ms": pipe_bwd[f"bound_ms_{name}"],
            "pipeline_bound_by": pipe_bwd[f"bound_by_{name}"],
            "pipeline_share_of_bound": pipe_bwd.get(
                f"share_of_bound_{name}"),
            "pipeline_tflops": pipe_bwd.get(f"tflops_{name}"),
            "pipeline_plain_ms": pipe_bwd["plain_ms"],
            "pipeline_library_ms": pipe_bwd["library_ms"],
            "padded_d32_worst_err_over_tol": max(
                bwd["padded_d32_offsets_stride_given_d"][n][
                    "worst_err_over_tol"]
                for n in (("dq",) if name == "dq" else ("dk", "dv"))),
            "ptxas": {k: v for k, v in per_kernel.items()
                      if f"flash_bwd_{name}_kernel" in k}})
    main_mrg = mrg["striped_r_gt_kv"]
    kernels.append({
        "name": "flash_merge", "route": "cuda",
        "source": "tpu_operator_torch/kernels/csrc/flash_merge.cu",
        "replaces": "tpu_operator/payload/flash_attention.py:287",
        # Not on this slice's path: the earlier slice's (sp_tp's ring).
        "launches": tp_launches["flash_merge"],
        "launches_by_path": {
            "serve_pod": spod["launches"]["flash_merge"],
            "serve_pod_launcher": spod["launcher"]["launches"]["flash_merge"],
            "launch": lch["launches"]["flash_merge"],
            "fsdp": fs["launches"]["flash_merge"],
            **slice_by_path["flash_merge"],
            "train_sp": sp["launches"]["flash_merge"],
            "train": tr["launches"]["flash_merge"],
            "ring_check": rng["striped"]["launches"]["flash_merge"]},
        "max_abs_err": max(r["max_abs_err_o"] for r in
                           (*mrg.values(), *wide["merge"].values(),
                            par["sp_tp_merge"])),
        "worst_err_over_tol": max(r["worst_err_over_tol_o"] for r in
                                  (*mrg.values(), *wide["merge"].values(),
                                   par["sp_tp_merge"])),
        "sp_tp_shape": "sp_tp chunk B8 Tq=Tk=4096 H8 KVH8, (4096, 0, 1) "
                       "into a live carry",
        **{f"sp_tp_{k}": par["sp_tp_merge"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound")},
        "wide_ring_d256": {k: wide["merge"]["ring_d256"][k] for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "share_of_bound")},
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
        "padded_d64_worst_err_over_tol":
            mrg["padded_d64"]["worst_err_over_tol_o"],
        "ptxas": {k: v for k, v in per_kernel.items()
                  if "flash_merge_kernel" in k}})
    emit({"phase": "total", "wall_s": time.monotonic() - started})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fsdp-worker"]:
        sys.exit(fsdp_card_worker(int(sys.argv[2]), int(sys.argv[3]),
                                  int(sys.argv[4]), sys.argv[5]))
    for flag, run in (("--fsdp-cards", fsdp_cards),
                      ("--launch-cards", launch_cards),
                      ("--serve-cards", serve_cards)):
        if sys.argv[1:2] == [flag]:
            try:
                sys.exit(run(int(sys.argv[2])))
            except SmokeFailure as e:
                emit({"phase": "failed", "error": str(e)})
                sys.exit(1)
    sys.exit(main())
