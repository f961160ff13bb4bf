"""Device milliseconds per profiled step of the matrix products: the
operations whose names hold a pattern of ``bench/patterns/gemm.txt``."""


def read(ctx):
    if ctx.trace is None:
        return None
    ns = ctx.trace.matching_ns(ctx.patterns("gemm"))
    return ns / 1e6 / ctx.profiled_steps if ns else None
