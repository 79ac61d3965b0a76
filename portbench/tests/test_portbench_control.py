"""The control: the reference with its dense products in 8-bit floats,
put in the program's place. At the cells' sizes on the card it has to
fail one of each cell's limits (``cuda``, the readings that set them); on
the CPU at a tiny size it reads well above the program."""

import pytest
import torch

from portbench import calibrate, harness
from portbench.tests import tiny


def readings(c, seed):
    fn = calibrate.train_readings if c.traffic["driver"] == "train" \
        else calibrate.serve_readings
    rows = {r["side"]: r for r in fn(c, seed, True)}
    numbers = [k for k in c.limits if k in rows["control_fp8"]]
    return rows, numbers


@pytest.mark.parametrize("name", ["train.flagship-gqa",
                                  "serve.flagship-gqa.chat"])
def test_control_reads_above_the_program_on_the_cpu(name):
    torch.set_num_threads(2)
    c = tiny.cell(name, 0, False)
    worst = 0.0
    for seed in (11, 2 ** 31 + 3):
        rows, numbers = readings(c, seed)
        worst = max(worst, max(
            rows["control_fp8"][k] / max(rows["program"][k], 1e-9)
            for k in numbers))
    assert worst >= 3.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["train.flagship-gqa",
                                  "serve.flagship-gqa.chat"])
def test_control_fails_the_limits_at_the_cell_size(card, name):
    c = harness.cell(tiny.ROOT, name, 0, 8.0, False, "cuda",
                     tiny.CLOCK_START)
    rows, numbers = readings(c, 2 ** 31 + 101)
    assert all(rows["program"][k] <= c.limits[k] for k in numbers)
    assert any(rows["control_fp8"][k] > c.limits[k] for k in numbers)
