"""A multichannel scene rendered binaurally through a SOFA HRTF set,
metered and written as a WAV file.

    python -m bbcat_dsp_torch.examples.binaural_demo [out.wav]

The port of the JAX package's ``examples/binaural_demo.py``.  It writes
its toy HRTF set (12 directions, a direction-dependent interaural delay
and a little shadowing) as a classic netCDF-3 SOFA file through
``scipy.io.netcdf_file``, which needs no ``h5py``, reads it back with
:class:`~bbcat_dsp_torch.sofa.SOFAFile`, and renders three sources (a
front tone, a left noise-burst train, a right chirp) through
:class:`~bbcat_dsp_torch.models.BinauralRenderer` with a 60 Hz high-pass
on every input.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch
from scipy.io import netcdf_file

from ..filters.biquad import FilterType, biquad_coeffs
from ..formats.sample_format import SampleFormat
from ..models.binaural import BinauralRenderer
from ..sofa import SOFAFile
from ..tools._device import cli_device
from ..tools.wav import write_wav

__all__ = ["main", "synth_hrtf", "write_sofa_nc3"]

DIRECTIONS = [(0.0, 0.0), (90.0, 0.0), (270.0, 0.0)]


def write_sofa_nc3(path: str, ir: np.ndarray, fs: float,
                   positions: np.ndarray) -> None:
    """A SimpleFreeFieldHRIR SOFA file ``ir [M, R, N]`` as classic
    netCDF-3."""
    M, R, N = ir.shape
    with netcdf_file(path, "w") as f:
        for name, n in (("M", M), ("R", R), ("N", N), ("I", 1), ("C", 3)):
            f.createDimension(name, n)
        f.createVariable("Data.IR", "d", ("M", "R", "N"))[:] = ir
        f.createVariable("Data.SamplingRate", "d", ("I",))[:] = [fs]
        f.createVariable("SourcePosition", "d", ("M", "C"))[:] = positions
        f.SOFAConventions = "SimpleFreeFieldHRIR"


def synth_hrtf(path: str, fs: float = 48000.0):
    """The toy HRTF set, written to ``path``: ``(ir [12, 2, 256],
    positions [12, 3])``."""
    rng = np.random.default_rng(0)
    M, N = 12, 256
    az = np.linspace(0, 330, M)
    ir = np.zeros((M, 2, N))
    for m, a in enumerate(np.radians(az)):
        itd = 0.0007 * np.sin(a) * fs  # +-0.7 ms interaural delay
        for ear, sign in ((0, +1), (1, -1)):
            d = int(round(20 + sign * itd / 2))
            ir[m, ear, d] = 1.0
            ir[m, ear] += rng.standard_normal(N) * 0.02 * np.exp(
                -np.arange(N) / 40.0)
    positions = np.stack([az, np.zeros(M), np.ones(M)], -1)
    write_sofa_nc3(path, ir, fs, positions)
    return ir, positions


def main(out_path: str | None = None, *, seconds: float = 3.0,
         block: int = 512, sofa_path: str | None = None, device="cuda",
         log=print) -> dict:
    """Render ``seconds`` of the scene; ``{"y", "loudness", "hrtf",
    "path", "sofa_path"}``: the output ``[2, T]``, the meter's readings,
    the HRTFs read back from the file for the three directions."""
    dev = cli_device(device, "binaural_demo")
    tmp = tempfile.gettempdir()
    out_path = out_path or os.path.join(tmp, "binaural_demo.wav")
    sofa_path = sofa_path or os.path.join(tmp, "demo_hrtf.sofa")
    fs = 48000.0
    synth_hrtf(sofa_path, fs)
    hrtf = SOFAFile.open(sofa_path).hrtf_matrix(DIRECTIONS)

    T = int(fs * seconds)
    t = np.arange(T) / fs
    x = np.zeros((3, T), np.float32)
    x[0] = 0.2 * np.sin(2 * np.pi * 440 * t)
    burst = (np.arange(T) % int(fs * 0.5)) < int(fs * 0.05)
    x[1] = 0.3 * np.random.default_rng(1).standard_normal(T) * burst
    x[2] = 0.2 * np.sin(2 * np.pi * (200 + 400 * t) * t)
    xd = torch.from_numpy(x).to(dev)

    eq = [biquad_coeffs(FilterType.HPF12, 60.0, fs)]
    r = BinauralRenderer(hrtf, block=block, eq_stages=eq, fs=fs, device=dev)
    outs = [r.process_block(xd[:, i * block:(i + 1) * block])
            for i in range(T // block)]
    y = torch.cat(outs, -1).cpu().numpy()
    loud = r.loudness()
    log("loudness:", loud)
    write_wav(out_path, y / max(1.0, np.abs(y).max()), fs, SampleFormat.INT24)
    log("wrote", out_path)
    return {"y": y, "loudness": loud, "hrtf": hrtf, "path": out_path,
            "sofa_path": sofa_path}


if __name__ == "__main__":
    main(*sys.argv[1:])
