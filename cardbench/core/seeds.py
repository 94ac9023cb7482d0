"""Every random draw of a run derives from ``--seed`` and a tag."""

from __future__ import annotations

import hashlib
import random

import torch

__all__ = ["derive", "generator", "host_rng"]


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for ``tag``, the same for the same ``seed`` on every
    machine; any whole ``seed``, 32 bits or more."""
    digest = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded for ``tag``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, tag))
    return gen


def host_rng(seed: int, tag: str) -> random.Random:
    return random.Random(derive(seed, tag))
