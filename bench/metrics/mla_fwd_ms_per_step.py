"""Device milliseconds per profiled step of the operations launched inside
the latent-attention layers' forward span ``mla`` (its ``mla_latent`` and
``mla_core`` within; ``bench/spans.py``, any thread).  The backward runs
outside it.  Nothing where the program has no such span."""

from bench import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, "mla")
