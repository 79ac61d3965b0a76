"""``flash_decode_roofline``: the least time of the traced decode
attention calls (every row's keys up to its attended length, q and o;
``reference/counts.py``) over the card time inside the calls'
``flash_decode`` ranges, in %. One call a layer of each traced step."""

from portbench import profiling
from portbench.reference import counts


def read(run):
    calls = profiling.op_calls(run.trace, "flash_decode")
    cfg = run.data.get("config")
    traced = run.data.get("traced_lengths") or []
    spent = sum(c["device_s"] for c in calls)
    if cfg is None or spent <= 0 \
            or len(calls) != len(traced) * cfg["num_hidden_layers"]:
        return None
    h, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = cfg["hidden_size"] // h
    bound = 0.0
    for lengths in traced:
        bound += cfg["num_hidden_layers"] * counts.bound(
            *counts.flash_decode_work(lengths, 1, h, kvh, d))
    return 100.0 * bound / spent
