"""Device milliseconds per profiled step of the operations launched inside
the step's ``train.backward`` spans (each node's and microbatch's backward,
launched from autograd's device thread while the step waits in the span,
and the gradient's copy into its plane; ``bench/spans.py``)."""

from bench import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, "train.backward")
