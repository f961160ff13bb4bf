"""Device milliseconds per profiled step of the operations launched inside
the step's ``train.update`` span and outside its ``gossip.apply``: the
update tail's own time (scalars, the stage kernels, the write-back;
``bench/spans.py``)."""

from bench import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, "train.update", ("gossip.apply",))
