"""Host seconds from the process's start to the first timed step: imports,
the trainer, weights, the traffic pool and the checked first steps (which
warm every shape the window uses)."""


def read(ctx):
    return ctx.setup_s
