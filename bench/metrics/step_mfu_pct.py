"""The whole step's share of the card's float32-accurate peak: the model
FLOPs of the window's unprofiled steps (``bench/yardstick.py:step_flops``)
over the window's seconds, against 3xTF32's 164.9 TFLOP/s.  (Plain float32
FFMA peaks at 67 TFLOP/s; a 3xTF32 product path computes at float32
accuracy, so the share is of the faster of the two.)"""

from bench import yardstick


def read(ctx):
    if not ctx.window_steps or ctx.window_s <= 0:
        return None
    rate = ctx.step_flops * ctx.window_steps / ctx.window_s
    return 100.0 * rate / yardstick.F32_ACCURATE_FLOP_PER_S
