"""``mfu.train``: the model FLOPs of the window's steps (6 N T plus causal
attention, recompute not counted; ``reference/counts.py``) over the
window's time x the cards' bf16 peak, in %."""

from portbench.reference import counts


def read(run):
    d = run.data
    if not d.get("steps") or "flops_per_step" not in d:
        return None
    return 100.0 * d["flops_per_step"] * d["steps"] / (
        d["window_s"] * counts.BF16_TC_FLOPS * d["cards"])
