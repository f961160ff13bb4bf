"""Device milliseconds per profiled step of the operations launched inside
the MoE layer's forward spans (``moe_router``, ``moe_dispatch``,
``moe_experts``, ``moe_combine``; the backward runs outside them)."""

SPANS = ("moe_router", "moe_dispatch", "moe_experts", "moe_combine")


def read(ctx):
    if ctx.trace is None:
        return None
    spans, ns = ctx.trace.span_ns(SPANS)
    return ns / 1e6 / ctx.profiled_steps if spans and ns else None
