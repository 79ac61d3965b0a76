"""``flash_fwd_roofline``: the least time of every traced call of the
``tpu_operator_torch::flash_fwd`` op that launched work, worked out from
the shapes it was called with (causal; ``reference/counts.py``), over the
card time of the kernels launched inside those calls, in %. Under the
remat policy a recompute replays the saved output through the op without
launching anything; such a call did no work and counts on neither side."""

from portbench import profiling
from portbench.reference import counts

OP = "tpu_operator_torch::flash_fwd"


def read(run):
    bound = spent = 0.0
    for call in profiling.op_calls(run.trace, OP):
        if call["device_s"] <= 0:
            continue  # a remat replay of a saved output: no work
        (b, t, h, d), (_, _, kvh, _) = call["shapes"][0], call["shapes"][1]
        bound += counts.bound(*counts.flash_fwd_work(b, t, h, kvh, d))
        spent += call["device_s"]
    return 100.0 * bound / spent if spent > 0 else None
