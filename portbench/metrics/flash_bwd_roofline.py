"""``flash_bwd_roofline``: the least time of every traced call of the
``tpu_operator_torch::flash_bwd`` op (dq and dkv together, from the shapes
it was called with, causal, bf16 gradients; ``reference/counts.py``) over
the card time of the kernels launched inside those calls, in %. A call
that launched nothing counts on neither side."""

from portbench import profiling
from portbench.reference import counts

OP = "tpu_operator_torch::flash_bwd"


def read(run):
    bound = spent = 0.0
    for call in profiling.op_calls(run.trace, OP):
        if call["device_s"] <= 0:
            continue  # a remat replay of a saved output: no work
        (b, t, h, d), (_, _, kvh, _) = call["shapes"][0], call["shapes"][1]
        bound += counts.bound(*counts.flash_bwd_work(b, t, h, kvh, d))
        spent += call["device_s"]
    return 100.0 * bound / spent if spent > 0 else None
