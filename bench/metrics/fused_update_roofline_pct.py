"""The update tail's share of its bytes bound: the bytes the tail's stages
must move on the state's planes (``bench/yardstick.py:tail_bytes``, each
input read once and each output written once, for the stage launches the
program counted over the profiled steps) at 3.35 TB/s, over the device time
of the operations named in ``bench/patterns/fused_update.txt``."""

from bench import yardstick


def read(ctx):
    if ctx.trace is None:
        return None
    ns = ctx.trace.matching_ns(ctx.patterns("fused_update"))
    ops = ctx.stage_launches
    if not ns or not ops or any(op not in yardstick.STAGE_PLANES for op in ops):
        return None
    bound_s = yardstick.tail_bytes(ctx.program.plane_elems, ops) / yardstick.HBM_BYTES_PER_S
    return 100.0 * bound_s / (ns / 1e9)
