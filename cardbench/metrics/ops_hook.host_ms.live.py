"""The host's time in ``ops_hook``'s dispatch functions (every
``ops_hook.<kernel>`` span: checks, ctypes launch, counters), ms a live
block over the ``process_small_block`` calls of the traced slice."""

from cardbench.core.spans import host_ms_per_unit_of


def read(ctx):
    return host_ms_per_unit_of(ctx, "ops_hook.", "nonuniform.small_block")
