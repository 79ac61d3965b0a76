"""``serve.decode_step_ms``: the mean wall time of the engine's ``step``
calls (one token for every slot: embed, cache write, page gather, decode
attention, head; the call ends in a host read), in ms."""


def read(run):
    steps = run.data.get("steps") or []
    if not steps:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1, _n, _k in steps) / len(steps)
