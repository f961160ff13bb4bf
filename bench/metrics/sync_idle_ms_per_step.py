"""Device idle milliseconds per profiled step in the gaps that open while
the host is in a sync inside ``bench.step``, from its first wait for the
device on, and close after that wait returns: the device drained its queue
at a host sync and waits for the host's next launches (``bench/spans.py``);
nothing without a device trace."""

from bench import spans


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return spans.of(ctx.trace).sync_idle_ns() / 1e6 / ctx.profiled_steps
