"""Device milliseconds per profiled step of the operations launched inside
the step's ``gossip.apply`` spans: the gossip rounds of the update tail,
inside the step (``bench/spans.py``)."""

from bench import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, "gossip.apply")
