"""Device milliseconds per profiled step of the operations launched inside
the ``gossip.codec`` spans: each node's encode and decode of a compressed
gossip payload (``bench/spans.py``)."""

from bench import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, "gossip.codec")
