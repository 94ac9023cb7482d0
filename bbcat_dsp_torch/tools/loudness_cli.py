"""CLI: BS.1770 integrated loudness and true peak of audio files, on the
card.

    python -m bbcat_dsp_torch.tools.loudness_cli input.wav [input2.wav ...]
"""

from __future__ import annotations

import sys

import torch

from ..loudness import integrated_loudness, true_peak_db
from ._device import cli_device
from .wav import read_wav


def main(argv=None, *, device="cuda") -> int:
    """Print one line a file, as the JAX package's tool does; ``device``
    is for callers in Python (the command line always takes the card)."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 2
    dev = cli_device(device, "loudness_cli")
    for path in argv:
        audio, fs = read_wav(path)
        x = torch.from_numpy(audio).to(dev)
        L = float(integrated_loudness(x, fs))
        tp = float(true_peak_db(x).max())
        print(f"{path}: integrated {L:+.1f} LKFS, true peak {tp:+.1f} dBTP "
              f"({audio.shape[0]} ch, {audio.shape[1] / fs:.1f} s @ "
              f"{fs:.0f} Hz)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
