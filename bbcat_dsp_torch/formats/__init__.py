"""Sample formats: the taxonomy, byte-level conversion and dither on the
host, and the normalized conversions on the device."""

from . import device, host
from .device import (
    convert,
    deinterleave,
    float_to_int32,
    int32_to_float,
    interleave,
    quantize,
    transfer_window,
)
from .dither import Ditherer, ShapedDitherer, TPDFDitherer
from .host import transfer_samples, transfer_samples_linear, transfer_samples_typed
from .sample_format import (
    SAMPLE_FORMAT_COUNT,
    SampleFormat,
    block_transfer_sanity_checks,
    get_bits_per_sample,
    get_bytes_per_sample,
    is_sample_float,
    is_sample_integer,
    sample_format_of,
)

__all__ = ["SampleFormat", "SAMPLE_FORMAT_COUNT",
           "block_transfer_sanity_checks", "get_bits_per_sample",
           "get_bytes_per_sample", "is_sample_float", "is_sample_integer",
           "sample_format_of", "Ditherer", "ShapedDitherer", "TPDFDitherer",
           "host", "device", "convert", "deinterleave", "float_to_int32",
           "int32_to_float", "interleave", "quantize", "transfer_window",
           "transfer_samples", "transfer_samples_linear",
           "transfer_samples_typed"]
