"""FilterManager: named biquad cascades assigned to the channels of a
stream: the counterpart of the JAX package's ``filters/manager.py``.

A registry of named cascades (given as stage specs, or loaded from JSON),
each assigned to any of a stream's channels; ``process`` runs every
cascade over its channels as one batch.
"""

from __future__ import annotations

import json
from typing import Mapping, Sequence

import numpy as np
import torch

from .biquad import FilterType, biquad_coeffs, cascade_response
from .iir import cascade_apply, modal_params

__all__ = ["FilterManager"]


class FilterManager:
    """Named filter cascades, their assignment to channels, and the batch
    that applies them, on ``device``."""

    def __init__(self, fs: float = 48000.0, dtype=torch.float32,
                 engine: str = "auto", *, device):
        self.fs = fs
        self.dtype = dtype
        self.engine = engine
        self.device = torch.device(device)
        self._configs: dict[str, np.ndarray] = {}
        self._stages: dict = {}             # name -> what cascade_apply takes
        self._assignment: dict[int, str] = {}
        self._states: dict = {}
        self._groups = None                 # (channels, name -> index tensor)

    # -- the registry --------------------------------------------------------
    def define(self, name: str, stages: Sequence) -> None:
        """Register a cascade under ``name`` from stage specs ``(type,
        freq[, gain[, bandwidth]])``, or dicts with those keys."""
        rows = []
        for spec in stages:
            if isinstance(spec, Mapping):
                ftype = spec["type"]
                if isinstance(ftype, str):
                    ftype = FilterType[ftype]
                rows.append(biquad_coeffs(
                    ftype, spec["freq"], self.fs, spec.get("gain", 0.0),
                    spec.get("bandwidth", 1.0)))
            else:
                ftype, freq, *rest = spec
                rows.append(biquad_coeffs(ftype, freq, self.fs, *rest[:2]))
        coeffs = np.stack(rows)
        self._configs[name] = coeffs
        # the float64 design, factored once; [S, 1, 5]: one channel axis
        # to broadcast over
        c = coeffs[:, None, :]
        self._stages[name] = (
            modal_params(c, device=self.device, dtype=self.dtype)
            if self.engine in ("auto", "modal") else c)
        self._states.pop(name, None)

    def define_from_json(self, text: str) -> None:
        """Load ``{"name": {"fs": ..., "stages": [{...}, ...]}, ...}`` or a
        flat ``{"name": [stage, ...]}``."""
        for name, cfg in json.loads(text).items():
            self.define(name, cfg["stages"] if isinstance(cfg, Mapping)
                        else cfg)

    def names(self) -> list[str]:
        return sorted(self._configs)

    def response(self, name: str, f) -> np.ndarray:
        return cascade_response(self._configs[name], f, self.fs)

    # -- assignment ----------------------------------------------------------
    def assign(self, channel: int, name: str) -> None:
        """Give ``channel`` the cascade ``name``.  The cascade's set of
        channels changes, and so does that of the cascade the channel had
        before: both start again from silence."""
        if name not in self._configs:
            raise KeyError(f"unknown filter config {name!r}")
        self._states.pop(self._assignment.get(channel), None)
        self._assignment[channel] = name
        self._states.pop(name, None)
        self._groups = None

    def assign_range(self, channels: Sequence[int], name: str) -> None:
        for c in channels:
            self.assign(c, name)

    # -- processing ----------------------------------------------------------
    def _channel_groups(self, nchannels: int) -> dict:
        """Each cascade's channels below ``nchannels`` as an index tensor
        on the device, made once per assignment."""
        if self._groups is None or self._groups[0] != nchannels:
            groups: dict[str, list[int]] = {}
            for ch, name in self._assignment.items():
                if ch < nchannels:
                    groups.setdefault(name, []).append(ch)
            self._groups = (nchannels, {
                name: torch.tensor(sorted(chans), device=self.device)
                for name, chans in sorted(groups.items())})
        return self._groups[1]

    def process(self, x) -> torch.Tensor:
        """Each channel of ``x [C, T]`` through its cascade; a channel
        with none passes through untouched."""
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        y = x.clone()
        for name, idx in self._channel_groups(x.shape[0]).items():
            out, self._states[name] = cascade_apply(
                x.index_select(0, idx), self._stages[name],
                self._states.get(name), engine=self.engine)
            y.index_copy_(0, idx, out)
        return y

    def reset(self) -> None:
        self._states.clear()
