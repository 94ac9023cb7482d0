"""WAV file input and output through the host format layer.

The counterpart of the JAX package's ``tools/wav.py``: PCM 16, 24 and 32
bits and float 32 and 64, through the same byte-level conversion engine
(native C++ or numpy), so both packages write the same bytes and read the
same samples.  Audio is ``[channels, time]`` float32 on the host.  Only
format tags 1 (PCM) and 3 (float) are read: a WAVE_FORMAT_EXTENSIBLE file
is refused, as in the JAX package.
"""

from __future__ import annotations

import struct

import numpy as np

from ..formats.dither import Ditherer
from ..formats.host import transfer_samples
from ..formats.sample_format import SampleFormat, get_bytes_per_sample

__all__ = ["read_wav", "write_wav"]

_FMT_PCM = 1
_FMT_FLOAT = 3
_FORMATS = {(_FMT_PCM, 16): SampleFormat.INT16,
            (_FMT_PCM, 24): SampleFormat.INT24,
            (_FMT_PCM, 32): SampleFormat.INT32,
            (_FMT_FLOAT, 32): SampleFormat.FLOAT,
            (_FMT_FLOAT, 64): SampleFormat.DOUBLE}


def read_wav(path: str):
    """A WAV file -> ``(audio [C, T] float32, fs)``."""
    with open(path, "rb") as fp:
        data = fp.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos, fmt, raw = 12, None, None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    wformat, nch, fs, _, _, bits = fmt
    sfmt = _FORMATS.get((wformat, bits))
    if sfmt is None:
        raise ValueError(f"{path}: unsupported format {wformat}/{bits}bit")
    bps = get_bytes_per_sample(sfmt)
    nframes = len(raw) // (bps * nch)
    out = np.zeros(nframes * nch * 4, np.uint8)
    transfer_samples(
        np.frombuffer(raw[:nframes * nch * bps], np.uint8), sfmt, False,
        0, nch, out, SampleFormat.FLOAT, False, 0, nch, nch, nframes)
    return out.view(np.float32).reshape(nframes, nch).T.copy(), float(fs)


def write_wav(path: str, audio: np.ndarray, fs: float,
              fmt: SampleFormat = SampleFormat.INT16,
              ditherer: Ditherer | None = None) -> None:
    """Write float audio ``[C, T]`` (or ``[T]``) as a WAV file of ``fmt``,
    optionally dithered."""
    audio = np.atleast_2d(np.asarray(audio, np.float32))
    nch, nframes = audio.shape
    bps = get_bytes_per_sample(fmt)
    inter = np.ascontiguousarray(audio.T).reshape(-1)
    raw = np.zeros(nframes * nch * bps, np.uint8)
    transfer_samples(inter.view(np.uint8), SampleFormat.FLOAT, False, 0, nch,
                     raw, fmt, False, 0, nch, nch, nframes, ditherer)
    wformat = _FMT_FLOAT if fmt in (SampleFormat.FLOAT,
                                    SampleFormat.DOUBLE) else _FMT_PCM
    hdr = b"RIFF" + struct.pack("<I", 36 + len(raw)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, wformat, nch, int(fs),
                                 int(fs) * nch * bps, nch * bps, bps * 8)
    hdr += b"data" + struct.pack("<I", len(raw))
    with open(path, "wb") as fp:
        fp.write(hdr + raw.tobytes())
