"""Streaming multi-band EQ with a live, click-free retarget mid-stream.

    python -m bbcat_dsp_torch.examples.streaming_eq [out.wav]

The port of the JAX package's ``examples/streaming_eq.py``.  A three-stage
bank (a 60 Hz high-pass, a presence peak at 3 kHz, a high shelf at 9 kHz)
runs block by block over a noisy program with a 120 Hz hum; half-way
through, the presence peak swings from +4 dB to -6 dB over 50 ms through
``set_filter(..., interp_time=0.05)``.  The example checks that the ramp
is click-free (no step across the retarget larger than the program's own
slew) and holds the whole output to a float64 model of the bank, sample
by sample through the ramp, at >= 90 dB.

The JAX package's ``set_filter`` does not retarget a bank that has
already run a block (its modal branch keeps the old stage), so its
example's output after the retarget differs from this one by design: the
port's ramps as the interpolation contract says.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch
from scipy.signal import lfilter

from ..filters.bank import BiQuadFilterBank
from ..filters.biquad import FilterType, biquad_coeffs
from ..formats.sample_format import SampleFormat
from ..loudness import integrated_loudness
from ..tools._device import cli_device
from ..tools.wav import write_wav

__all__ = ["main", "STAGES", "RETARGET", "reference64"]

FS = 48000.0
RAMP_S = 0.05
# (type, frequency, gain) of the three stages, and stage 1's new target
STAGES = ((FilterType.HPF12, 60.0, 0.0), (FilterType.PEQ, 3000.0, 4.0),
          (FilterType.HSH, 9000.0, -2.0))
RETARGET = (1, FilterType.PEQ, 3000.0, -6.0)


def _design(ftype, freq, gain):
    return biquad_coeffs(ftype, freq, FS, gain=gain)


def _ramp64(x, c_from, c_to, dec, w):
    """The float64 per-sample DF2T with the bank's interpolation contract:
    sample ``n`` runs on ``c_to - mul (c_to - c_from)``, ``mul`` starting
    at 1 and stepping down by ``dec`` after each sample, not below 0.
    ``x [C, T]``, ``w [C, 2]``: ``(y, w')``."""
    y = np.empty_like(x)
    w0, w1 = w[:, 0].copy(), w[:, 1].copy()
    mul, diff = 1.0, c_to - c_from
    for n in range(x.shape[-1]):
        b0, b1, b2, a1, a2 = c_to - mul * diff
        yn = b0 * x[:, n] + w0
        w0 = b1 * x[:, n] - a1 * yn + w1
        w1 = b2 * x[:, n] - a2 * yn
        y[:, n] = yn
        mul = max(mul - dec, 0.0)
    return y, np.stack([w0, w1], -1)


def reference64(x: np.ndarray, at: int) -> np.ndarray:
    """The bank's output on ``x [C, T]`` in float64, stage 1 retargeted
    at sample ``at``: fixed stages through ``lfilter``, the ramp sample by
    sample until it has landed."""
    y = np.asarray(x, np.float64)
    for i, design in enumerate(STAGES):
        c = _design(*design)
        if i != RETARGET[0]:
            y = lfilter(c[:3], np.r_[1.0, c[3:]], y, axis=-1)
            continue
        tgt = _design(*RETARGET[1:])
        head, w = lfilter(c[:3], np.r_[1.0, c[3:]], y[:, :at], axis=-1,
                          zi=np.zeros((y.shape[0], 2)))
        n_ramp = min(y.shape[-1] - at, int(RAMP_S * FS) + 2)
        dec = float(np.float32(1.0 / (RAMP_S * FS)))
        ramp, w = _ramp64(y[:, at:at + n_ramp], c, tgt, dec, w)
        rest, _ = lfilter(tgt[:3], np.r_[1.0, tgt[3:]], y[:, at + n_ramp:],
                          axis=-1, zi=w)
        y = np.concatenate([head, ramp, rest], -1)
    return y


def main(out_path: str | None = None, *, block: int = 512,
         nblocks: int = 94, channels: int = 2, device="cuda",
         log=print) -> dict:
    """Run the bank over ``nblocks`` blocks with the retarget before block
    ``nblocks // 2``; raise on a click or on < 90 dB against
    :func:`reference64`; write the output as INT24.  ``{"y", "x", "snr_db",
    "ramp_slew", "program_slew", "lkfs_in", "lkfs_out", "path"}``."""
    dev = cli_device(device, "streaming_eq")
    if out_path is None:
        out_path = os.path.join(tempfile.gettempdir(), "streaming_eq.wav")
    rng = np.random.default_rng(7)
    # program: pink-ish noise + a 120 Hz hum to give the HPF work to do
    t = np.arange(nblocks * block) / FS
    x = rng.standard_normal((channels, t.size)).astype(np.float32)
    x = np.cumsum(x, axis=-1)
    x = 0.05 * x / np.abs(x).max() + 0.2 * np.sin(2 * np.pi * 120.0 * t)
    x = x.astype(np.float32)
    xd = torch.from_numpy(x).to(dev)

    bank = BiQuadFilterBank(len(STAGES), channels, fs=FS, device=dev)
    for i, (ftype, freq, gain) in enumerate(STAGES):
        bank.set_filter(i, ftype, freq, gain=gain)
    blocks = []
    for b in range(nblocks):
        if b == nblocks // 2:
            # live retarget: the +4 dB presence peak swings to -6 dB
            stage, ftype, freq, gain = RETARGET
            bank.set_filter(stage, ftype, freq, gain=gain, interp_time=RAMP_S)
        blocks.append(bank.process(xd[:, b * block:(b + 1) * block]))
    yd = torch.cat(blocks, -1)
    y = yd.cpu().numpy()

    # click check: the largest sample-to-sample step across the retarget
    # window stays within the program material's own slew rate
    mid = nblocks // 2 * block
    d_ramp = float(np.abs(np.diff(y[:, mid - 256:mid + 4096], axis=-1)).max())
    d_prog = float(np.abs(np.diff(y, axis=-1)).max())
    if not d_ramp <= d_prog + 1e-6:
        raise AssertionError(f"a click at the retarget: {d_ramp} > {d_prog}")
    ref = reference64(x, mid)
    noise = float(np.sum((ref - y) ** 2))
    snr = float("inf") if noise == 0 else float(
        10 * np.log10(np.sum(ref ** 2) / noise))
    if not snr >= 90.0:
        raise AssertionError(f"{snr:.2f} dB against the float64 bank, < 90")

    lk_in = float(integrated_loudness(xd, FS))
    lk_out = float(integrated_loudness(yd, FS))
    log(f"integrated loudness: in {lk_in:+.2f} LKFS -> out {lk_out:+.2f} LKFS")
    log(f"ramp slew {d_ramp:.4f} vs program slew {d_prog:.4f} (click-free); "
        f"{snr:.2f} dB against the float64 bank")
    write_wav(out_path, y, int(FS), SampleFormat.INT24)
    log(f"wrote {out_path}")
    return {"y": y, "x": x, "snr_db": snr, "ramp_slew": d_ramp,
            "program_slew": d_prog, "lkfs_in": lk_in, "lkfs_out": lk_out,
            "path": out_path}


if __name__ == "__main__":
    main(*sys.argv[1:])
