"""CLI: offline convolution and binaural rendering of audio files, on the
card.

    # convolve with an IR (multi-channel: per-channel IRs)
    python -m bbcat_dsp_torch.tools.convolve_cli input.wav ir.wav out.wav

    # binaural: render N-channel input through a SOFA HRTF set (azimuths
    # spread evenly around the listener)
    python -m bbcat_dsp_torch.tools.convolve_cli input.wav hrtf.sofa out.wav
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..convolve import NonUniformConvolver
from ..formats.sample_format import SampleFormat
from ..models import BinauralRenderer
from ..sofa import SOFAFile
from ._device import cli_device
from .wav import read_wav, write_wav

_BLOCK = 512


def _pad_to(x: np.ndarray, mult: int) -> np.ndarray:
    pad = (-x.shape[-1]) % mult
    return np.pad(x, [(0, 0), (0, pad)]) if pad else x


def main(argv=None, *, device="cuda", timings: dict | None = None) -> int:
    """The JAX package's tool, same arguments, branches, padding and
    normalisation, with the engines on ``device`` (for callers in Python;
    the command line always takes the card).  ``timings``, where given,
    receives the seconds spent ``read`` (the input and the IRs), ``render``
    (the engine's set-up, its run and the copy back) and ``write``."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        print(__doc__)
        return 2
    dev = cli_device(device, "convolve_cli")
    inp, irp, outp = argv
    t0 = time.perf_counter()
    audio, fs = read_wav(inp)
    T = audio.shape[-1]

    if irp.lower().endswith(".sofa"):
        s = SOFAFile.open(irp)
        C = audio.shape[0]
        hrtf = s.hrtf_matrix([(360.0 * i / C, 0.0) for i in range(C)])
        t1 = time.perf_counter()
        r = BinauralRenderer(hrtf, block=_BLOCK, fs=fs, device=dev)
        x = torch.from_numpy(_pad_to(audio, _BLOCK)).to(dev)
        outs = [r.process_block(x[:, i * _BLOCK:(i + 1) * _BLOCK])
                for i in range(x.shape[-1] // _BLOCK)]
        y = torch.cat(outs, -1)[:, :T].cpu().numpy()
        note = f"binaural: {C} ch -> 2 ch via {irp}; {r.loudness()}"
    else:
        ir, _ = read_wav(irp)
        if ir.shape[0] == 1 and audio.shape[0] > 1:
            ir = np.broadcast_to(ir, (audio.shape[0], ir.shape[1]))
        t1 = time.perf_counter()
        conv = NonUniformConvolver(ir, block=_BLOCK, nchannels=audio.shape[0],
                                   device=dev)
        x = torch.from_numpy(_pad_to(audio, conv.super_block)).to(dev)
        y = conv.process(x)[:, :T].cpu().numpy()
        note = f"convolved {audio.shape[0]} ch with {ir.shape[-1]}-tap IR"
    t2 = time.perf_counter()
    print(note)

    peak = np.abs(y).max()
    if peak > 1.0:
        y = y / peak * 0.999
        print(f"normalised by {peak:.3f} to avoid clipping")
    write_wav(outp, y, fs, SampleFormat.INT24)
    if timings is not None:
        timings.update(read=t1 - t0, render=t2 - t1,
                       write=time.perf_counter() - t2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
