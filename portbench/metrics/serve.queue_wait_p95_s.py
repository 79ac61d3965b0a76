"""``serve.queue_wait_p95_s``: the 95th percentile, over the admitted
requests, of the time from a request's due time to the start of its
``engine.admit`` call (the serve loop's queue and admission), in s."""

import math


def read(run):
    waits = sorted(t0 - due for due, t0, _t1, _n in run.data.get("admits",
                                                                   []))
    if not waits:
        return None
    return waits[math.ceil(0.95 * len(waits)) - 1]
