"""``serve.decode_dispatch_ms``: the host time of each decode step of the
device window from its entry to its token read (``kvcache.decode``'s
``t0`` to its ``read_ns`` mark: the host's launches of every layer),
averaged over the steps, in ms. Read inside the device window, it holds
that window's cost on each launch, so it reads high by an amount that
grows with the launches a step makes."""

from portbench import spans


def read(run):
    found = [s for s in spans.in_device_window(run, {"kvcache.decode"})
             if "read" in s]
    if not found:
        return None
    return 1e3 * sum(s["read"] - s["t0"] for s in found) / len(found)
