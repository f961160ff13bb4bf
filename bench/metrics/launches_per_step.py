"""Device operations (kernels, copies, fills) launched per profiled step."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return len(ctx.trace.device) / ctx.profiled_steps
