"""The host's time inside ``process``, ms a render call over the calls of
the traced slice (the program's span, its children included): how much
of a call's device time the host needs to enqueue it."""

from cardbench.core.spans import host_ms_per_call


def read(ctx):
    return host_ms_per_call(ctx, "nonuniform.process")
