"""Doppler: a source closing on the listener, through the fractional delay.

    python -m bbcat_dsp_torch.examples.doppler [out.wav]

The port of the JAX package's ``examples/doppler.py``.  A circular buffer
read at a smoothly varying fractional delay (the reference's
FractionalSample, 14 taps x 128 phases) renders a 1 kHz tone from a source
approaching at 20 m/s, and the received tone must be shifted by the
Doppler factor ``1 + v/c``.  The same shift comes from the resampler at
ratio ``1 + v/c``: a time-varying delay and asynchronous resampling are
one operation on the same polyphase core.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from ..filters.fractional import FractionalDelayLine
from ..filters.resample import resample
from ..tools._device import cli_device
from ..tools.wav import write_wav

__all__ = ["main", "peak_freq"]

FS = 48000.0
C_SOUND = 343.0  # m/s
F0 = 1000.0      # emitted tone (Hz)
V = 20.0         # closing speed (m/s) -> expected shift factor 1 + v/c
D0 = 90.0        # initial distance (m)


def peak_freq(y: np.ndarray, fs: float) -> float:
    """FFT peak with quadratic (parabolic) bin interpolation."""
    w = np.hanning(y.size)
    s = np.abs(np.fft.rfft(y * w))
    k = int(np.argmax(s))
    if 0 < k < s.size - 1:
        a, b, c = np.log(s[k - 1]), np.log(s[k]), np.log(s[k + 1])
        k = k + 0.5 * (a - c) / (a - 2 * b + c)
    return k * fs / y.size


def main(out_path: str | None = None, *, seconds: float = 2.0,
         block: int = 512, device="cuda", log=print) -> dict:
    """Render the approaching tone block by block, check both shifts
    within 0.5 % of theory (raises otherwise) and write the render as a
    stereo WAV file; ``{"f_theory", "f_delay", "f_asrc", "path"}``."""
    dev = cli_device(device, "doppler")
    if out_path is None:
        out_path = os.path.join(tempfile.gettempdir(), "doppler.wav")
    nblocks = int(seconds * FS) // block
    T = nblocks * block
    t = np.arange(T) / FS
    src = (0.5 * np.sin(2 * np.pi * F0 * t)).astype(np.float32)[None, :]
    src_d = torch.from_numpy(src).to(dev)

    # distance shrinks linearly; delay(t) = d(t) / c in frames
    delay_frames = (D0 - V * t) / C_SOUND * FS
    max_delay = float(delay_frames.max())

    line = FractionalDelayLine(1, 1 << 15, device=dev)
    k = np.arange(block)
    outs = []
    for b in range(nblocks):
        sl = slice(b * block, (b + 1) * block)
        line.write(src_d[:, sl])
        # output sample k of this block was emitted delay_k frames ago,
        # counted from the head after the write
        d = ((block - k) + delay_frames[sl]).astype(np.float32)
        outs.append(line.read(torch.from_numpy(d[None, :]).to(dev)))
    out = torch.cat(outs, -1).cpu().numpy()

    # the fill-in transient lasts until the longest delay has history
    settle = int(max_delay) + 64
    f_meas = peak_freq(out[0, settle:], FS)
    f_theory = F0 * (1.0 + V / C_SOUND)
    ratio = 1.0 + V / C_SOUND
    y_asrc = resample(src_d, 1.0 / ratio).cpu().numpy()
    f_asrc = peak_freq(y_asrc[0, settle:], FS)

    err_meas = abs(f_meas - f_theory) / f_theory
    err_asrc = abs(f_asrc - f_theory) / f_theory
    log(f"emitted                 : {F0:8.2f} Hz")
    log(f"theory  (1 + v/c) * f0  : {f_theory:8.2f} Hz")
    log(f"fractional-delay render : {f_meas:8.2f} Hz ({err_meas * 100:.3f}% off)")
    log(f"ASRC at ratio {ratio:.4f}  : {f_asrc:8.2f} Hz ({err_asrc * 100:.3f}% off)")
    if not err_meas < 0.005:
        raise AssertionError(f"doppler shift wrong: {f_meas:.2f} Hz")
    if not err_asrc < 0.005:
        raise AssertionError(f"ASRC shift wrong: {f_asrc:.2f} Hz")

    stereo = np.concatenate([out, out], axis=0)
    write_wav(out_path, stereo / max(1e-9, np.abs(stereo).max()) * 0.5, FS)
    log(f"wrote {out_path}")
    return {"f_theory": f_theory, "f_delay": f_meas, "f_asrc": f_asrc,
            "path": out_path}


if __name__ == "__main__":
    main(*sys.argv[1:])
