"""Helpers around the engines: the native format engine, profiling, and
state files (``load_state`` / ``save_state``).

The names are those the JAX package's ``utils`` exports.  The state-file
functions load on first use: ``checkpoint`` imports the engines' state
types, and the engines import ``utils.precision``, which runs this file
first."""

from . import native
from .native import native_available
from .profiling import Timer, named_scope, trace

__all__ = [
    "native",
    "native_available",
    "Timer",
    "named_scope",
    "trace",
    "load_state",
    "save_state",
]


def __getattr__(name: str):
    if name in ("load_state", "save_state"):
        from . import checkpoint

        return getattr(checkpoint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
