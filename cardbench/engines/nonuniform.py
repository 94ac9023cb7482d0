"""Adapter for the two-level engine, ``bbcat_dsp_torch.convolve.
NonUniformConvolver``: the program under test.

``render`` is ``process`` on one render group (``Pt`` super-blocks),
``live`` is ``process_small_block`` on one block.  The constructor takes
the IRs as host NumPy, so the IRs made on the card go to the host once,
in set-up.
"""

from __future__ import annotations

import torch

from bbcat_dsp_torch import ops_hook
from bbcat_dsp_torch.convolve.nonuniform import NonUniformConvolver

__all__ = ["Engine"]


class Engine:
    def __init__(self, cfg: dict, filters: torch.Tensor, device):
        self.conv = NonUniformConvolver(filters.cpu().numpy(), cfg["block"],
                                        cfg["ratio"], device=device)
        self.channels = self.conv.nchannels
        self.block = self.conv.block
        self.cycle_blocks = self.conv.ratio   # one tail firing a cycle
        self.head_parts = self.conv.head_parts
        self.tail_parts = self.conv.tail_parts
        self.group_samples = self.tail_parts * self.conv.super_block

    def render(self, x: torch.Tensor) -> torch.Tensor:
        """One render group ``[C, Pt * ratio * block]`` in and out."""
        return self.conv.process(x)

    def live(self, x) -> torch.Tensor:
        """One small block ``[C, block]`` (host or device) in, on the
        device out."""
        return self.conv.process_small_block(x)

    def shapes(self, entry: str) -> dict:
        """The shapes one call of ``entry`` gives each function that has a
        roofline (``rooflines/<function>.py``)."""
        if entry != "render":
            return {}
        C, B = self.channels, self.block
        return {"k1_fused_head": {"C": C, "P": self.head_parts, "B": B,
                                  "R": self.group_samples // B},
                "k2_xt_grouped_mac": {"P": self.tail_parts, "C": C,
                                      "F": self.conv.super_block + 1}}

    @staticmethod
    def counts() -> dict:
        """The program's launch and plain-call counters."""
        return ops_hook.counts()
