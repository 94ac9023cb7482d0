"""A test's plain reference for a matrix engine, in float64 by FFT:
``y[o, t] = sum_i sum_{n < N} h[i, o, n] x[i, t - n]``; on an exchange
block ``(1 - r) y_before + r y_after``, ``r[k] = (k + 1) / n_out``, each
over the whole history.  Nothing here imports the program."""

import torch

from cardbench.core import signals
from cardbench.reference.nonuniform import tf32

__all__ = ["EXCHANGE_LAW", "filters", "memory", "outputs"]

EXCHANGE_LAW = True


def filters(cfg, gen, device):
    """``[inputs, outputs, ir_taps]`` decaying noise, each pair of unit
    energy."""
    ci, co, n = cfg["inputs"], cfg["outputs"], cfg["ir_taps"]
    return signals.room_irs(ci * co, n, cfg["ir_rt60_s"], cfg["sample_rate"],
                            gen, device).view(ci, co, n)


def memory(cfg):
    return int(cfg["ir_taps"]) - 1


def _mix(history, h, n_out, precision):
    x, h = history, h.to(history.device)
    if precision == "tf32":
        x, h = tf32(x), tf32(h)
    L, N = x.shape[1], h.shape[2]
    nfft = 1 << (L + N - 2).bit_length()
    X = torch.fft.rfft(x.to(torch.float64), n=nfft)
    H = torch.fft.rfft(h.to(torch.float64), n=nfft)
    y = torch.fft.irfft(torch.einsum("if,iof->of", X, H), n=nfft)
    return y[:, L - n_out:L]


def outputs(history, filters, n_out, *, before=None, precision="float64"):
    if precision not in ("float64", "tf32"):
        raise ValueError(f"precision {precision!r}")
    y = _mix(history, filters, n_out, precision)
    if before is not None:
        r = torch.arange(1, n_out + 1, dtype=torch.float64,
                         device=y.device) / n_out
        y = (1 - r) * _mix(history, before, n_out, precision) + r * y
    return y
