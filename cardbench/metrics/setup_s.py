"""Set-up: process start to the first timed call, build, inputs, engine
and warm-up included."""


def read(ctx):
    return ctx.setup_s
