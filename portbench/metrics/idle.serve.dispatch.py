"""``idle.serve.dispatch``: the share of the device window's wall time in
which the card is idle while the serve loop's thread launches a decode
step's or a prefill's work (``kvcache.decode`` and ``kvcache.prefill``,
from each span's start to its ``read_ns`` mark, where its token read
begins), in %: the card waiting on the host's launches."""

from portbench import profiling, spans


def read(run):
    t = run.trace
    if t is None or t["window_s"] <= 0 or not t["busy"]:
        return None
    found = [s for s in spans.in_device_window(
        run, {"kvcache.decode", "kvcache.prefill"}) if "read" in s]
    if not found:
        return None
    launching = profiling.merge((s["t0"], s["read"]) for s in found)
    idle = sum((b - a) - profiling.covered(t["busy"], (a, b))
               for a, b in launching)
    return 100.0 * idle / t["window_s"]
