"""Buffering: the circular buffer the delay lines stand on."""

from .ring import Ring, ring_advance, ring_init, ring_read_delayed, ring_write

__all__ = ["Ring", "ring_advance", "ring_init", "ring_read_delayed",
           "ring_write"]
