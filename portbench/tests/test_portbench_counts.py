"""The yardstick's counts against counts made by hand."""

import json

import pytest

from portbench.reference import counts
from portbench.tests import tiny

FLAGSHIP = json.loads(
    (tiny.ROOT / "portbench" / "configs" / "flagship-gqa.json").read_text())


def test_flagship_matmul_params_by_hand():
    d, ffn, kv, vocab = 2048, 8192, 512, 32768
    block = (d * d + kv * d + kv * d + d * d + ffn * d + ffn + d * ffn + d
             + 4 * d)
    assert counts.matmul_params(FLAGSHIP) == 8 * block + 2 * d + vocab * d
    assert counts.matmul_params(FLAGSHIP) == 419_581_952


def test_train_step_flops_by_hand():
    # 6 N T + 6 L B T^2 d: 1.78e14 at the flagship's 32 x 2048.
    flops = counts.train_step_flops(FLAGSHIP, 32, 2048)
    assert flops == 6 * 419_581_952 * 65536 + 6 * 8 * 32 * 2048 ** 2 * 2048
    assert flops == pytest.approx(1.7818e14, rel=1e-4)


def test_attention_work_by_hand():
    # Forward at one head, T 2: 3 pairs, 2 products of D 4 each.
    flops, nbytes = counts.flash_fwd_work(1, 2, 1, 1, 4)
    assert flops == 2 * 2 * 4 * 3
    assert nbytes == 2 * (2 * 8 + 2 * 8) + 4 * 2
    flops, nbytes = counts.flash_bwd_work(1, 2, 1, 1, 4)
    assert flops == 5 * 2 * 4 * 3
    # q, dO, k, v, L read; O read; dq, dk, dv written (bf16).
    assert nbytes == 2 * 16 + 2 * 16 + 8 + 16 + 16 + 2 * 16
    flops, nbytes = counts.flash_decode_work([3, 1], 1, 4, 2, 8)
    assert flops == 4 * 4 * 4 * 8
    assert nbytes == 2 * 2 * 4 * 2 * 8 + 2 * 2 * 2 * 4 * 8


def test_bound_takes_the_larger_time():
    assert counts.bound(1.0, counts.HBM_BYTES_PER_S) == 1.0
    assert counts.bound(2 * counts.BF16_TC_FLOPS, 1.0) == 2.0


def test_serve_flops_by_hand():
    n = counts.matmul_params(FLAGSHIP)
    d, layers = 2048, 8
    assert counts.prefill_flops(FLAGSHIP, 3) == 2 * n * 3 \
        + 4 * d * layers * 6
    assert counts.decode_flops(FLAGSHIP, 2, 5) \
        == 2 * n * 2 + 4 * d * layers * 5
