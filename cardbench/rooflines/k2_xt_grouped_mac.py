"""K2, the tail's grouped MAC: ``xt_grouped_mac(queue, xt, H, slot0)``.

Bytes: queue, xt and H in, the spectra out; operations: P x P complex
MACs and 2P - 1 window sums a bin.  Frozen from ``chip_smoke.py::k2_cost``.
"""

COUNTER = "xt_grouped_mac"


def cost(P: int, C: int, F: int) -> tuple[float, float]:
    return 4 * 8.0 * P * C * F, (8.0 * P * P + 4.0 * (2 * P - 1)) * C * F
