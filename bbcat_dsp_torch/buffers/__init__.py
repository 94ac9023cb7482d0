"""Buffering: the circular buffer, delay and FIFO buffers on it, and the
multilayer buffer that mixes producers of different block sizes."""

from .delay import SoundDelayBuffer, SoundRingBuffer
from .multilayer import MultilayerBuffer
from .ring import Ring, ring_advance, ring_init, ring_read_delayed, ring_write

__all__ = ["Ring", "ring_advance", "ring_init", "ring_read_delayed",
           "ring_write", "SoundDelayBuffer", "SoundRingBuffer",
           "MultilayerBuffer"]
