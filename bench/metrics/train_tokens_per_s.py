"""All nodes' tokens of the window's steps over the window's host seconds
(the first step's call to the sync after the last)."""


def read(ctx):
    if not ctx.window_steps or ctx.window_s <= 0:
        return None
    return ctx.window_steps * ctx.program.tokens_per_step / ctx.window_s
