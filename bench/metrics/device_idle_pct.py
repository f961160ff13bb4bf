"""The device's idle share of a step: one less the device-busy time per
profiled step (the union of the operations' intervals) over the mean step
time of the window's unprofiled steps (the profiler stretches a step)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or not ctx.window_steps:
        return None
    busy_ms = ctx.trace.busy_ns() / 1e6 / ctx.profiled_steps
    step_ms = ctx.window_s * 1e3 / ctx.window_steps
    return 100.0 * (1.0 - busy_ms / step_ms)
