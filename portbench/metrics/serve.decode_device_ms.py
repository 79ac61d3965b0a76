"""``serve.decode_device_ms``: the card's busy time inside each decode
step of the device window (``kvcache.decode``, entry to the end of its
token read, so all of the step's card work; the device trace's busy
intervals that the span covers), averaged over the steps, in ms."""

from portbench import spans


def read(run):
    return spans.mean_busy_ms(run, "kvcache.decode")
