"""The two-level engine's plain reference: the linear convolution it
computes, ``y[c, t] = sum_{n < N} ir[c, n] x[c, t - n]``, in float64 by
FFT, in blocks of channels on the tensors' own device.

It takes the IRs and the input stream that the benchmark made and handed
to the program, and nothing the program derived from them.  With
``precision="tf32"`` it is the control: the same arithmetic on inputs
rounded to TF32 (10 bits of mantissa, to nearest), the step below the
configuration's float32 that a later change might be tempted to take.

It states no exchange law (``EXCHANGE_LAW``): the two-level engine fades
its head and its tail at different steps, so a cell whose mix exchanges
is refused at set-up, and an exchange block here.
"""

from __future__ import annotations

import torch

from cardbench.core import signals

__all__ = ["EXCHANGE_LAW", "filters", "memory", "outputs", "tf32"]

EXCHANGE_LAW = False


def filters(cfg: dict, gen: torch.Generator, device) -> torch.Tensor:
    """The IRs ``[channels, ir_taps]`` the engine adapter takes, made on
    ``device`` from ``gen``."""
    return signals.room_irs(cfg["channels"], cfg["ir_taps"], cfg["ir_rt60_s"],
                            cfg["sample_rate"], gen, device)


def memory(cfg: dict) -> int:
    """How many past input samples one output depends on."""
    return int(cfg["ir_taps"]) - 1


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32, to nearest (ties away), as float32."""
    bits = x.contiguous().float().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _fft_len(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def outputs(history: torch.Tensor, ir: torch.Tensor, n_out: int, *,
            before=None, precision: str = "float64",
            block: int = 64) -> torch.Tensor:
    """``[C, n_out]`` float64: the convolution's last ``n_out`` outputs
    over ``history [C, L]`` (zeros before its first sample) with ``ir [C,
    N]``; exact for every output when ``L >= N - 1 + n_out``.  ``before``,
    the IRs of an exchange block's outgoing set, is refused."""
    if before is not None:
        raise ValueError("the two-level engine has no stated exchange law: "
                         "its head and tail fade at different steps")
    if precision not in ("float64", "tf32"):
        raise ValueError(f"precision {precision!r}")
    C, L = history.shape
    N = ir.shape[1]
    nfft = _fft_len(L + N - 1)
    out = torch.empty((C, n_out), dtype=torch.float64, device=history.device)
    for c0 in range(0, C, block):
        x = history[c0:c0 + block]
        h = ir[c0:c0 + block].to(history.device)
        if precision == "tf32":
            x, h = tf32(x), tf32(h)
        X = torch.fft.rfft(x.to(torch.float64), n=nfft)
        X *= torch.fft.rfft(h.to(torch.float64), n=nfft)
        out[c0:c0 + block] = torch.fft.irfft(X, n=nfft)[:, L - n_out:L]
    return out
