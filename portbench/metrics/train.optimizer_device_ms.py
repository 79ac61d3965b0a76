"""``train.optimizer_device_ms``: the card time of a training step's
update (``train.optimizer``: ``optimizer.step``), averaged over the whole
steps inside the device window (CUDA events at the span's edges), in
ms."""

from portbench import spans


def read(run):
    return spans.per_step_device_ms(run, "train.optimizer")
