"""The device extent of a tail firing (``_tail_step_xt``, once every
``ratio`` live blocks): the program's CUDA events at the span's entry and
exit, ms a firing over the firings of the traced slice."""

from cardbench.core.spans import device_ms_per_call


def read(ctx):
    return device_ms_per_call(ctx, "nonuniform.tail_step")
