"""The host's time inside ``process_small_block``, ms a live block over
the blocks of the traced slice (the program's span, its children
included)."""

from cardbench.core.spans import host_ms_per_call


def read(ctx):
    return host_ms_per_call(ctx, "nonuniform.small_block")
