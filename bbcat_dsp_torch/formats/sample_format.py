"""Sample format taxonomy, with the reference enum's integer values.

On the device every integer format is carried as MSB-aligned int32 and
every float format as float32; this module holds what the device-side
conversions need.
"""

from __future__ import annotations

import enum

__all__ = ["SampleFormat", "is_sample_integer"]


class SampleFormat(enum.IntEnum):
    """Audio sample formats."""

    UNKNOWN = 0
    INT16 = 1
    INT24 = 2
    INT32 = 3
    FLOAT = 4
    DOUBLE = 5


def is_sample_integer(fmt: SampleFormat) -> bool:
    return SampleFormat.INT16 <= fmt <= SampleFormat.INT32
