"""The device a command-line tool runs on."""

from __future__ import annotations

import torch


def cli_device(device, tool: str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device where there is none
    ends the tool with an error, so a run without a card never carries on
    on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device (torch.cuda.is_available() "
                         "is False); this tool runs on the card")
    return dev
