"""``serve.prefill_device_ms``: the card's busy time inside each prefill
of the device window (``kvcache.prefill``: the forward at the padded
window, the argmax, the K/V scatter and the token read; the device
trace's busy intervals that the span covers), averaged over the
prefills, in ms."""

from portbench import spans


def read(run):
    return spans.mean_busy_ms(run, "kvcache.prefill")
