"""``mfu.serve``: the model FLOPs of the window's prefills (at each
prompt's own length, no padding) and decode tokens (each at the context
it attends), over the wall time of the engine's ``admit`` and ``step``
calls x the card's bf16 peak, in %."""

from portbench.reference import counts


def read(run):
    cfg = run.data.get("config")
    admits = run.data.get("admits") or []
    steps = run.data.get("steps") or []
    wall = sum(t1 - t0 for _due, t0, t1, _n in admits) \
        + sum(t1 - t0 for t0, t1, _n, _k in steps)
    if cfg is None or wall <= 0:
        return None
    flops = sum(counts.prefill_flops(cfg, n) for _d, _a, _b, n in admits)
    flops += sum(counts.decode_flops(cfg, n, k) for _a, _b, n, k in steps)
    return 100.0 * flops / (wall * counts.BF16_TC_FLOPS)
