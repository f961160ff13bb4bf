"""Host syncs per profiled step: the host's calls that wait for the device
inside ``bench.step``, those of one ``aten::`` op counted once, whether or
not the program names them with a ``sync.*`` span (``bench/spans.py``);
nothing without a device trace."""

from bench import spans


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return len(spans.of(ctx.trace).syncs()) / ctx.profiled_steps
