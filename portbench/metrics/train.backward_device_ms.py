"""``train.backward_device_ms``: the card time of each microbatch's
backward (``train.backward``, the remat policy's recompute included),
summed over a training step and averaged over the whole steps inside the
device window (CUDA events at each span's edges), in ms."""

from portbench import spans


def read(run):
    return spans.per_step_device_ms(run, "train.backward")
