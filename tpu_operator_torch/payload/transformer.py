"""Transformer LM training payload on one CUDA card (counterpart of
``tpu_operator/payload/transformer.py``).

    python -m tpu_operator_torch.payload.transformer --steps 6 --batch 32 \\
        --seq-len 2048 --grad-accum 4 --adam-mu-dtype bf16 --vocab 32768 \\
        --dim 2048 --heads 16 --kv-heads 4 --layers 8

trains the flagship GQA LM (``bench.py:636`` ``lm_flagship_gqa_kv4``) on
the synthetic recurrence; ``--device cpu`` with small widths runs the
plain PyTorch path. The numerics follow the reference: f32 master params,
bf16 compute (``models.py``), the differentiable flash attention (the
forward and backward kernels on the card), the f32 next-token loss, and
adam with an optional bf16 first moment (``optimizers.py``).

One process, one device. The flags of the reference that need more
(sequence and tensor parallelism, FSDP) or that are not ported yet
(remat, chunked loss, checkpoints, profiling, adam8) parse with the
reference's defaults and raise NotImplementedError when set away from
them; ROADMAP Queue A lists them.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Callable, Iterator, NamedTuple, Tuple

import torch

from tpu_operator_torch.device import resolve_device
from tpu_operator_torch.payload import bootstrap
from tpu_operator_torch.payload import compute
from tpu_operator_torch.payload import data as data_mod
from tpu_operator_torch.payload import flash_attention as fa
from tpu_operator_torch.payload import optimizers
from tpu_operator_torch.payload import train
from tpu_operator_torch.payload.models import TransformerLM

log = logging.getLogger(__name__)

ENV_PREFETCH_DEPTH = "TPUJOB_DATAPLANE_PREFETCH_DEPTH"
DEFAULT_PREFETCH_DEPTH = 2


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=8, help="global batch size")
    p.add_argument("--seq-len", type=int, default=2048,
                   help="global sequence length")
    p.add_argument("--seq-parallel", type=int, default=1,
                   help="sequence-parallel shards (not ported: must be 1)")
    p.add_argument("--tensor-parallel", type=int, default=1,
                   help="tensor-parallel shards (not ported: must be 1)")
    p.add_argument("--split-qkv", choices=("auto", "on", "off"),
                   default="auto",
                   help="q/k/v projection layout (not ported: auto, which "
                        "splits under GQA and fuses otherwise)")
    p.add_argument("--sp-mode", choices=("ring", "ulysses"), default="ring",
                   help="sequence-parallel strategy (not ported)")
    p.add_argument("--sp-layout", choices=("contiguous", "striped"),
                   default="contiguous",
                   help="sequence-parallel layout (not ported)")
    compute.add_lm_compute_flags(p)
    p.add_argument("--grad-accum", type=int, default=1,
                   help="accumulate gradients over K sequential "
                        "microbatches (activation-memory knob; the "
                        "optimizer sees the full-batch gradient)")
    p.add_argument("--loss-chunk", type=int, default=0,
                   help="sequence-chunked lm_head + loss (not ported: 0)")
    p.add_argument("--fsdp", action="store_true",
                   help="param and optimizer sharding (not ported)")
    p.add_argument("--adam-mu-dtype", choices=("f32", "bf16"), default="f32",
                   help="dtype of adam's first moment")
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--kv-heads", type=int, default=0,
                   help="grouped-query attention K/V heads (0 = MHA)")
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--data", default=os.environ.get("TPU_DATA_PATH", ""),
                   help="mounted .npy token file (1-D int array); empty = "
                        "synthetic recurrence")
    p.add_argument("--checkpoint-dir",
                   default=os.environ.get("TPU_CHECKPOINT_DIR", ""),
                   help="checkpoint/resume dir (not ported: a non-empty "
                        "value raises)")
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.add_argument("--profile-dir",
                   default=os.environ.get("TPU_PROFILE_DIR", ""),
                   help="profiler trace dir (not ported: a non-empty value "
                        "raises)")
    p.add_argument("--prefetch-depth", type=int,
                   default=_env_int(ENV_PREFETCH_DEPTH, 0),
                   help="batches in flight to the device ahead of the step "
                        "(0 = auto, the default depth "
                        f"{DEFAULT_PREFETCH_DEPTH})")
    p.add_argument("--device", default="",
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    return p.parse_args(argv)


def _env_int(var: str, default: int) -> int:
    try:
        return int(os.environ.get(var) or default)
    except ValueError:
        log.warning("ignoring malformed %s=%r", var, os.environ.get(var))
        return default


# flag -> (its default, the ROADMAP Queue A item that ports it)
_NOT_PORTED = {
    "seq_parallel": (1, "7 (ring attention: 6)"),
    "tensor_parallel": (1, "7"),
    "sp_mode": ("ring", "6-7"),
    "sp_layout": ("contiguous", "6"),
    "split_qkv": ("auto", "7"),
    "fsdp": (False, "7"),
    "loss_chunk": (0, "1"),
    "checkpoint_dir": ("", "2"),
    "profile_dir": ("", "9"),
}


def check_ported(args) -> None:
    """Raise NotImplementedError for a flag set away from the reference's
    default that the port cannot honour yet."""
    for name, (default, item) in _NOT_PORTED.items():
        if getattr(args, name, default) != default:
            raise NotImplementedError(
                f"--{name.replace('_', '-')} {getattr(args, name)!r} is not "
                f"ported to the PyTorch payload yet (ROADMAP Queue A "
                f"{item}); leave it at {default!r}")


def prefetch_depth(args) -> int:
    """The prefetch depth: > 0 as given, 0 = auto (the default depth)."""
    depth = int(args.prefetch_depth)
    if depth < 0:
        raise ValueError(f"prefetch depth must be >= 0 (0 = auto), "
                         f"got {depth}")
    return depth or DEFAULT_PREFETCH_DEPTH


def _causal_attend(_i):
    return lambda q, k, v: fa.flash_attention(q, k, v, causal=True)


class Built(NamedTuple):
    model: TransformerLM
    optimizer: optimizers.Adam
    opt_state: optimizers.AdamState
    step: Callable[[torch.Tensor], train.Metrics]
    batches: Iterator[Tuple]
    device: torch.device


def build_model(args, device) -> TransformerLM:
    """The LM at the flags' widths with f32 master params, from a seeded
    init on ``device``."""
    model = TransformerLM(args.vocab, args.dim, args.heads, args.layers,
                          args.seq_len, kv_heads=args.kv_heads,
                          param_dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(args.seed))
    return model.init_weights(gen)


def make_lm_train_step(model: TransformerLM, optimizer, opt_state,
                       grad_accum: int = 1):
    """Next-token cross-entropy step over ``model``'s trainable params
    (the ones ``opt_state`` was initialised on)."""
    def loss_fn(tokens):
        loss = train.next_token_nll(model(tokens, None, _causal_attend),
                                    tokens)
        return loss, {"loss": loss.detach()}

    params = [p for p in model.parameters() if p.requires_grad]
    return train.make_loss_train_step(loss_fn, params, optimizer, opt_state,
                                      grad_accum=grad_accum)


def build(args, device=None) -> Built:
    """Model (seeded init, gradients on), optimizer and its state, step
    and host batches for the flags. ``device`` defaults to ``--device``
    (CUDA unless it says ``cpu``)."""
    check_ported(args)
    compute.lm_block(args)  # the plain DecoderBlock; raises under --remat
    if args.grad_accum < 1 or args.batch % args.grad_accum:
        raise ValueError(f"--batch {args.batch} must divide by "
                         f"--grad-accum {args.grad_accum} >= 1")
    dev = resolve_device(device if device is not None
                         else (args.device or None))
    optimizer = optimizers.from_args(args)
    model = build_model(args, dev).requires_grad_(True)
    opt_state = optimizer.init(list(model.parameters()))
    step = make_lm_train_step(model, optimizer, opt_state,
                              grad_accum=args.grad_accum)
    return Built(model, optimizer, opt_state, step,
                 data_mod.lm_batches(args), dev)


def run(info: bootstrap.ProcessInfo, args=None) -> dict:
    args = args or parse_args([])
    built = build(args)
    n_params = sum(p.numel() for p in built.model.parameters())
    log.info("training %d params on %s; batch %d seq %d grad-accum %d",
             n_params, built.device, args.batch, args.seq_len,
             args.grad_accum)
    metrics = train.train_loop(
        built.step, built.batches, args.steps, device=built.device,
        log_every=args.log_every,
        log_fn=lambda i, m: log.info("step %d loss %.4f", i, m["loss"]),
        prefetch=prefetch_depth(args))
    log.info("final: loss %.4f", metrics.get("loss", float("nan")))
    return metrics


def main() -> None:
    args = parse_args()
    bootstrap.main_wrapper(lambda info: run(info, args))


if __name__ == "__main__":
    main()
