"""Differentiable DSP: recover a room impulse response from (input, output)
recordings by gradient descent through the convolver.

    python -m bbcat_dsp_torch.examples.fit_ir

The port of the JAX package's ``examples/fit_ir.py``, with
``torch.optim.Adam`` in place of optax's (the same defaults: betas 0.9 and
0.999, eps 1e-8).  The loss runs through the uniform engine's functions:
the time-domain IR's spectra through K3 (:func:`ir_spectra`), the render
through K3, K7 and K4, and the backward pass through the plain versions'
vjp (:mod:`~bbcat_dsp_torch.ops.autograd`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..convolve import convolver_init, convolver_render, ir_spectra, partition_ir
from ..tools._device import cli_device

__all__ = ["main"]


def main(block: int = 64, n_taps: int = 256, n_blocks: int = 32,
         steps: int = 300, lr: float = 3e-2, seed: int = 0, *,
         device="cuda", log=print) -> dict:
    """Fit an ``n_taps`` IR from ``block * n_blocks`` samples in ``steps``
    Adam steps; ``{"snr_db", "rel_loss", "seconds", "steps"}``: the
    recovered IR's SNR against the true one, the final loss over the
    target's power, and the seconds the steps took."""
    dev = cli_device(device, "fit_ir")
    rng = np.random.default_rng(seed)
    B, N, T = block, n_taps, block * n_blocks
    true_ir = rng.standard_normal(N) * np.exp(-np.arange(N) / 60.0)
    x = torch.from_numpy(rng.standard_normal((1, T)).astype(np.float32)).to(dev)
    H = partition_ir(true_ir, B, device=dev)
    P = H.shape[1]
    _, y_target = convolver_render(convolver_init(1, B, P, device=dev), H, x, B)

    def loss_of(ir):
        _, y = convolver_render(convolver_init(1, B, P, device=dev),
                                ir_spectra(ir[None], B), x, B)
        return torch.mean((y - y_target) ** 2)

    ir = torch.zeros(P * B, device=dev, requires_grad=True)
    opt = torch.optim.Adam([ir], lr=lr)
    t0 = time.perf_counter()
    for i in range(steps):
        opt.zero_grad()
        loss = loss_of(ir)
        loss.backward()
        opt.step()
        if i % 50 == 0:
            log(f"step {i}: loss {loss.item():.3e}")
    with torch.no_grad():
        rel = float(loss_of(ir) / torch.mean(y_target ** 2))
    seconds = time.perf_counter() - t0
    err = ir.detach().cpu().numpy()[:N] - true_ir
    snr = float(10 * np.log10(np.sum(true_ir ** 2) / np.sum(err ** 2)))
    log(f"recovered IR SNR: {snr:.1f} dB ({steps} steps in {seconds:.3f} s "
        f"on {dev})")
    return {"snr_db": snr, "rel_loss": rel, "seconds": seconds,
            "steps": steps}


if __name__ == "__main__":
    main()
