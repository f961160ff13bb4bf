"""The median milliseconds of one round of the cell's own gossip channel
(``channel.apply``) on the cell's parameter planes, run alone after the
window and timed with CUDA events."""

import statistics


def read(ctx):
    times = ctx.gossip_round_ms()
    return statistics.median(times) if times else None
