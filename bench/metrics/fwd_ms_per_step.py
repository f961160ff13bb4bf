"""Device milliseconds per profiled step of the operations launched inside
the step's ``train.forward`` spans (each node's and microbatch's forward,
the MoE spans within; ``bench/spans.py``)."""

from bench import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, "train.forward")
