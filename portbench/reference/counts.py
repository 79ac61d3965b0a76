"""The yardstick's arithmetic: the chip's peaks, the least time of a piece
of work on it, and the operations and bytes of the model's steps and of the
attention ops, all worked out from shapes.

The peaks and :func:`bound` are frozen copies of the arithmetic in the
repository's ``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``BF16_TC_FLOPS``,
``bound``), and :func:`flash_bwd_work` counts as its ``bwd_bounds`` does
for one causal call with D fused (the "pair"); the model FLOPs follow
``bench.py``'s ``lm_model_flops_per_step`` (6 N T plus causal attention,
recompute not counted), rewritten against the H100's bf16 peak. Nothing
here imports the program.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12


def bound(flops: float, nbytes: float) -> float:
    """The least seconds of a piece of work on the card: the larger of its
    operations over the bf16 peak and its bytes over the memory's peak."""
    return max(flops / BF16_TC_FLOPS, nbytes / HBM_BYTES_PER_S)


def flash_fwd_work(b: int, t: int, h: int, kvh: int, d: int,
                   causal: bool = True) -> Tuple[float, float]:
    """(flops, bytes) of one forward attention op: two [pairs]-by-D
    products a head; reads q, k, v, writes O (bf16) and L (f32)."""
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 4.0 * b * h * d * pairs
    nbytes = 2.0 * (2 * b * t * h * d + 2 * b * t * kvh * d) + 4.0 * b * h * t
    return flops, nbytes


def flash_bwd_work(b: int, t: int, h: int, kvh: int, d: int,
                   causal: bool = True, grad_bytes: int = 2
                   ) -> Tuple[float, float]:
    """(flops, bytes) of one backward attention op (dq and dkv together,
    D fused into dq): five [pairs]-by-D products a head; reads q, k, v,
    dO, L and O once, writes dq, dk, dv once (``grad_bytes`` a value)."""
    pairs = t * (t + 1) // 2 if causal else t * t
    mac = 2.0 * d * pairs * b * h
    q_bytes = 2.0 * b * t * h * d
    kv_bytes = 2.0 * b * t * kvh * d
    row_bytes = 4.0 * b * h * t
    common = 2 * q_bytes + 2 * kv_bytes + row_bytes  # q, dO, k, v, L
    nbytes = common + q_bytes + grad_bytes / 2 * q_bytes \
        + grad_bytes * kv_bytes
    return 5 * mac, nbytes


def flash_decode_work(lengths: Sequence[int], tq: int, h: int, kvh: int,
                      d: int) -> Tuple[float, float]:
    """(flops, bytes) of one decode attention call: row r attends its
    first ``lengths[r]`` keys; reads those keys and values (bf16) and q,
    writes o."""
    keys = float(sum(int(n) for n in lengths))
    rows = len(lengths)
    flops = 4.0 * keys * tq * h * d
    nbytes = 2.0 * 2 * keys * kvh * d + 2.0 * 2 * rows * tq * h * d
    return flops, nbytes


def matmul_params(cfg: Dict) -> int:
    """The model's parameters that enter a matrix product (every block's
    projections and MLP, with their biases and LayerNorms, and the output
    head); the embedding tables are gathers and do not count."""
    d = cfg["hidden_size"]
    heads, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    ffn = cfg["intermediate_size"]
    kv_dim = kvh * (d // heads)
    block = (d * d + 2 * d * kv_dim + d * d      # q, k, v, attn_out
             + d * ffn + ffn + ffn * d + d       # mlp_up, mlp_down
             + 4 * d)                            # two LayerNorms
    return cfg["num_hidden_layers"] * block + 2 * d + d * cfg["vocab_size"]


def train_step_flops(cfg: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 N T for the products and, per
    layer, 6 B T^2 d for causal attention forward and backward (half the
    square); recompute is not counted."""
    tokens = batch * seq
    return (6.0 * matmul_params(cfg) * tokens
            + 6.0 * cfg["num_hidden_layers"] * batch * seq * seq
            * cfg["hidden_size"])


def decode_flops(cfg: Dict, tokens: int, keys: int) -> float:
    """Forward FLOPs of ``tokens`` single-token rows that attend ``keys``
    keys between them: 2 N a token for the products, 4 d per key and layer
    for the two attention products."""
    return (2.0 * matmul_params(cfg) * tokens
            + 4.0 * cfg["hidden_size"] * cfg["num_hidden_layers"] * keys)


def prefill_flops(cfg: Dict, prompt_len: int) -> float:
    """Forward FLOPs of a prompt of ``prompt_len`` tokens, no padding:
    position i attends i + 1 keys."""
    d, layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    n = matmul_params(cfg)
    keys = prompt_len * (prompt_len + 1) / 2.0
    return 2.0 * n * prompt_len + 4.0 * d * layers * keys
