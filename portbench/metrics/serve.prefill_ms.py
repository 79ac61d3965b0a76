"""``serve.prefill_ms``: the mean wall time of the engine's ``admit``
calls (``kvcache.DecodeEngine`` prefill at the padded window; the call
ends in a host read of the first token, so it includes the card), in ms."""


def read(run):
    admits = run.data.get("admits") or []
    if not admits:
        return None
    return 1e3 * sum(t1 - t0 for _due, t0, t1, _n in admits) / len(admits)
