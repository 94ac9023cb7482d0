"""Command-line tools on the port (offline convolution and binaural
rendering, loudness and true peak) and the WAV input and output they use."""

from .wav import read_wav, write_wav

__all__ = ["read_wav", "write_wav"]
