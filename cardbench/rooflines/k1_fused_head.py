"""K1, the fused head: ``fused_head(x [C, R*B], xcarry, prev, H)``.

Bytes: x and y, H and both carries (in and out), both half spectra;
operations: the 2 C R transforms and the MAC.  Frozen from
``chip_smoke.py::k1_cost``.
"""

from cardbench.core.costs import fft_flops

COUNTER = "fused_head"       # the program's launch count of one call


def cost(C: int, P: int, B: int, R: int) -> tuple[float, float]:
    F = B + 1
    return (4.0 * (2 * C * R * B + 3 * 2 * P * C * F + 2 * 2 * C * F),
            2 * fft_flops(C * R, B) + 8.0 * P * C * R * F)
