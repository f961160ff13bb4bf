"""Device milliseconds per profiled step of the operations launched inside
the MoE layers' shared-expert forward span ``moe_shared`` (``bench/spans.py``,
any thread).  Nothing where the program has no such span."""

from bench import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, "moe_shared")
