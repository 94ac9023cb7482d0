"""Sample formats and their conversions on the device."""

from .device import float_to_int32, int32_to_float
from .sample_format import SampleFormat, is_sample_integer

__all__ = ["SampleFormat", "is_sample_integer", "float_to_int32",
           "int32_to_float"]
