"""The comparison that decides ``correct``.

The number compared is the worst relative error over every compared output
and every channel: ``||y_c - ref_c|| / ||ref_c||`` over the output's
samples, ``ref`` the float64 reference on the same inputs.  Its limit is
the configuration's stated SNR, ``10 ** (-snr_db_min / 20)``.
"""

from __future__ import annotations

import math

import torch

__all__ = ["rel_err", "limit", "Checks"]


def rel_err(y: torch.Tensor, ref: torch.Tensor) -> float:
    """Worst channel's ``||y - ref|| / ||ref||`` of ``[C, n]`` outputs."""
    y = y.to(device=ref.device, dtype=torch.float64)
    num = (y - ref).norm(dim=-1)
    den = ref.norm(dim=-1)
    return float((num / den).max())


def limit(cfg: dict) -> float:
    return 10.0 ** (-float(cfg["snr_db_min"]) / 20.0)


class Checks:
    """Each number compared, beside its limit; ``correct`` if all hold."""

    def __init__(self):
        self.items = {}

    def at_most(self, name: str, value, lim) -> None:
        ok = value is not None and math.isfinite(value) and value <= lim
        self.items[name] = {"value": value, "limit": lim, "ok": ok}

    def at_least(self, name: str, value, lim) -> None:
        ok = value is not None and math.isfinite(value) and value >= lim
        self.items[name] = {"value": value, "limit": lim, "ok": ok}

    @property
    def correct(self) -> bool:
        return all(c["ok"] for c in self.items.values())

    def lines(self) -> list[str]:
        cmp = {True: "ok", False: "FAILS"}
        return [f"check {k}: {c['value']!r} against the limit {c['limit']!r} "
                f"({cmp[c['ok']]})" for k, c in self.items.items()]

    def as_json(self) -> dict:
        return {k: {"value": c["value"], "limit": c["limit"]}
                for k, c in self.items.items()}
