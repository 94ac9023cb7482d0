"""Filter bank, cascade and block classes over the IIR engines: the
counterparts of the JAX package's ``filters/bank.py``.

A functional core (:class:`BankState` and plain functions) and thin
stateful classes for a host's streaming loop.  A bank is S stages over C
channels, each stage's coefficients shared by the channels; a stage is
retargeted click-free by ramping all five coefficients on one controller
``mul`` that falls from 1 to 0 in steps of ``dec`` a sample.

The designs are float64 on the host, and the state keeps ``targets`` and
``origins`` in float64 on the device, so a ramp interpolates float64
coefficients sample by sample as the float64 per-sample DF2T contract
does.  ``mul`` and ``dec`` are float32 values: ``dec = 1 / interp_samples``
is rounded to float32, and the sample on which a ramp lands depends on it;
``mul - dec n`` is then exact in float64.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .biquad import FilterType, biquad_coeffs, cascade_response
from .iir import (
    biquad_apply,
    cascade_apply,
    modal_apply,
    modal_from_df2t,
    modal_params,
    parallel_cascade_params,
)

__all__ = ["BankState", "bank_init", "bank_set_stage", "bank_process",
           "BiQuadFilterBank", "BiQuadCascade", "BiQuadBlock"]


class BankState(NamedTuple):
    """The state of an S-stage, C-channel bank: what a stream needs to
    resume (the DF2T registers of every stage and channel, and every
    stage's interpolation controller)."""

    targets: torch.Tensor  # [S, 5] float64 target coefficients
    origins: torch.Tensor  # [S, 5] float64 coefficients when the target was set
    mul: torch.Tensor      # [S] float32 controller (1 -> 0)
    dec: torch.Tensor      # [S] float32 decrement a sample
    w: torch.Tensor        # [S, C, 2] DF2T registers


def bank_init(nstages: int, nchannels: int, dtype=torch.float32, *,
              device) -> BankState:
    """Every stage flat (``b0 = 1``), no ramp, silence."""
    flat = torch.tensor([1.0, 0.0, 0.0, 0.0, 0.0], dtype=torch.float64,
                        device=device).repeat(nstages, 1)
    return BankState(
        targets=flat, origins=flat.clone(),
        mul=torch.zeros(nstages, device=device),
        dec=torch.zeros(nstages, device=device),
        w=torch.zeros((nstages, nchannels, 2), dtype=dtype, device=device))


def bank_set_stage(state: BankState, stage: int, coeffs,
                   interp_samples: float = 0.0) -> BankState:
    """Retarget one stage, at once or over ``interp_samples`` samples.

    A ramp starts from the stage's coefficients in effect now, ``targets
    - mul (targets - origins)``, so a retarget in the middle of a ramp is
    seamless."""
    new = torch.from_numpy(np.array(coeffs, np.float64)).to(
        state.targets.device)
    t, o = state.targets[stage], state.origins[stage]
    current = t - state.mul[stage].double() * (t - o)
    if interp_samples > 0:
        mul, dec, origin = 1.0, 1.0 / float(interp_samples), current
    else:
        mul, dec, origin = 0.0, 0.0, new

    def put(a, v):
        a = a.clone()
        a[stage] = v
        return a

    return state._replace(targets=put(state.targets, new),
                          origins=put(state.origins, origin),
                          mul=put(state.mul, mul), dec=put(state.dec, dec))


def _bank_trajectories(state: BankState, nframes: int):
    """Every stage's coefficients at every sample of a block, ``[S, T, 5]``
    float64, and ``mul`` after it.  ``mul_n = max(mul - dec n, 0)`` is
    exact in float64 (two float32 values and ``n < 2^24``); ``mul`` after
    the block is float32 arithmetic, as the JAX package carries it."""
    diffs = state.targets - state.origins
    n = torch.arange(nframes, dtype=torch.float64, device=diffs.device)
    muls = torch.clamp(state.mul.double()[:, None]
                       - state.dec.double()[:, None] * n, min=0.0)
    coeffs = state.targets[:, None, :] - muls[..., None] * diffs[:, None, :]
    new_mul = torch.clamp(state.mul - state.dec * nframes, min=0.0)
    return coeffs, new_mul


def bank_process(state: BankState, x: torch.Tensor, engine: str = "scan"):
    """``x [C, T]`` through all stages, one after the other, every channel
    at once, the coefficients interpolated sample by sample: ``(state',
    y)``.  ``engine`` is a companion engine of
    :func:`~bbcat_dsp_torch.filters.iir.biquad_apply`; ``"assoc_dw"`` runs
    the float64 trajectory through the float64 scan."""
    coeffs, new_mul = _bank_trajectories(state, x.shape[-1])
    y, new_w = x, []
    for s in range(state.targets.shape[0]):
        # [1, T, 5]: the stage's coefficients, the same for every channel
        y, w = biquad_apply(y, coeffs[s][None], state.w[s], engine=engine)
        new_w.append(w)
    return state._replace(mul=new_mul, w=torch.stack(new_w)), y


class BiQuadFilterBank:
    """S stages over C channels on ``device``, each stage's coefficients
    shared by the channels.

    While a ramp runs the bank takes the companion scan ``engine`` (by
    default ``"assoc_dw"``: float64) over the interpolated coefficients;
    once every ramp has landed the DF2T registers are converted exactly
    into the modal realization (:func:`~bbcat_dsp_torch.filters.iir.
    modal_from_df2t`) and steady blocks run the modal engine.

    Two things the state does not hold: how many samples of ramp remain
    and, on steady blocks, the modal engine's state (``state.w`` is then
    stale).  :meth:`snapshot` folds the modal state back into ``w``, and
    :meth:`restore` derives the remaining ramp from ``mul`` and ``dec``:
    use them around a state file."""

    def __init__(self, nstages: int, nchannels: int, engine: str = "assoc_dw",
                 dtype=torch.float32, fs: float = 48000.0, *, device):
        self.fs = fs
        self.engine = engine   # the engine used while a ramp runs
        self.device = torch.device(device)
        self.state = bank_init(nstages, nchannels, dtype, device=self.device)
        self._ramp_remaining = 0
        self._modal = None     # (params, states) a stage, on steady blocks

    def set_filter(self, stage: int, ftype: FilterType, freq: float,
                   gain: float = 0.0, bandwidth: float = 1.0,
                   interp_time: float = 0.0) -> None:
        """Design a stage and retarget it, over ``interp_time`` seconds."""
        self.set_coeffs(stage, biquad_coeffs(ftype, freq, self.fs, gain,
                                             bandwidth), interp_time * self.fs)

    def set_coeffs(self, stage: int, coeffs, interp_samples: float = 0.0) -> None:
        if self._modal is not None:
            # back to DF2T registers, so the ramp starts from the audio
            # state as it is now
            self.state = self.state._replace(w=self._modal_to_w())
            self._modal = None
        self.state = bank_set_stage(self.state, stage, coeffs, interp_samples)
        # a fractional length lands on the next whole sample
        self._ramp_remaining = max(self._ramp_remaining,
                                   math.ceil(interp_samples))

    def _modal_to_w(self) -> torch.Tensor:
        """The DF2T registers of the modal states: ``w0`` is the next
        zero-input output, ``w1`` the one after it plus ``a1 w0``; what is
        left of the FIR history is part of the free evolution."""
        ws = []
        for p, s in zip(*self._modal):
            p1 = torch.complex(p.p1r, p.p1i)
            p2 = torch.complex(p.p2r, p.p2i)
            w_c = torch.complex(s.wr, s.wi)
            t_c = torch.complex(s.tr, s.ti)
            v0 = p.d1 * s.x1 + p.d2 * s.x2
            v1 = p.d2 * s.x1
            t_n0 = p1 * t_c + v0
            w_n0 = p2 * w_c + t_n0
            w_n1 = p2 * w_n0 + p1 * t_n0 + v1
            y0, y1 = w_n0.real, w_n1.real
            a1 = -(p1 + p2).real
            ws.append(torch.stack([y0, y1 + a1 * y0], -1))
        return torch.stack(ws).to(self.state.w.dtype)

    def process(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=self.state.w.dtype, device=self.device)
        if self._ramp_remaining > 0 or self._modal is None:
            self.state, y = bank_process(self.state, x, engine=self.engine)
            self._ramp_remaining = max(0, self._ramp_remaining - x.shape[-1])
            if self._ramp_remaining == 0:
                # every ramp has landed: over to the modal engine
                targets = self.state.targets.cpu().numpy()
                params = [modal_params(c, device=self.device,
                                       dtype=self.state.w.dtype)
                          for c in targets]
                states = [modal_from_df2t(p, self.state.w[s])
                          for s, p in enumerate(params)]
                self._modal = (params, states)
            return y
        params, states = self._modal
        y, new_states = x, []
        for p, s in zip(params, states):
            y, s = modal_apply(y, p, s)
            new_states.append(s)
        self._modal = (params, new_states)
        return y

    def snapshot(self) -> BankState:
        """The state with the audio state in ``w`` whatever engine ran the
        last block: what to save."""
        if self._modal is None:
            return self.state
        return self.state._replace(w=self._modal_to_w())

    def restore(self, state: BankState) -> None:
        """Continue from ``state`` (of :meth:`snapshot`, or read from a
        file): the ramp engine runs until the slowest controller has
        landed, ``ceil(mul / dec)`` samples on."""
        self.state = state
        self._modal = None
        mul, dec = state.mul.cpu().numpy(), state.dec.cpu().numpy()
        left = [math.ceil(float(m) / float(d)) for m, d in zip(mul, dec)
                if m > 0 and d > 0]
        self._ramp_remaining = max(left, default=0)

    def calc_response(self, f, usetargets: bool = True) -> np.ndarray:
        """The cascade's response at frequencies ``f``: the product of the
        stages', at the targets or at the coefficients in effect."""
        t = self.state.targets.cpu().numpy()
        if not usetargets:
            t = t - self.state.mul.cpu().numpy().astype(np.float64)[:, None] \
                * (t - self.state.origins.cpu().numpy())
        return cascade_response(t, f, self.fs)

    def copy_audio_state(self, other: "BiQuadFilterBank") -> None:
        self.state = self.state._replace(w=other.state.w)


def _stages(coeffs: np.ndarray, engine: str, device, dtype):
    """A static cascade ``[S, 5]`` factored once on the host for its
    engine: the parallel form, ``ModalParams`` with S leading, or (the
    companion engines) the float64 coefficients as they are."""
    if engine == "parallel":
        return parallel_cascade_params(coeffs, device=device)
    if engine in ("auto", "modal"):
        return modal_params(coeffs, device=device, dtype=dtype)
    return coeffs


class BiQuadCascade:
    """A fixed cascade of stages over ``x [..., T]`` on ``device``.

    ``systolic=True`` is the serial cascade with one sample of delay
    between stages, ``nstages - 1`` samples late."""

    def __init__(self, coeffs, systolic: bool = False, engine: str = "auto",
                 dtype=torch.float32, fs: float = 48000.0, *, device):
        self.coeffs_host = np.atleast_2d(np.asarray(coeffs, np.float64))
        self.device = torch.device(device)
        self.dtype = dtype
        self.systolic = systolic
        self.engine = engine
        self.fs = fs
        self.states = None
        self._stages = _stages(self.coeffs_host, engine, self.device, dtype)

    @classmethod
    def from_interleaved(cls, coefficients, **kw) -> "BiQuadCascade":
        """From the interleaved vector ``(g, b1[0], b2[0], a1[0], a2[0],
        b1[1], ...)`` of length ``4 nstages + 1``; the global gain ``g``
        goes into stage 0's numerator."""
        v = np.asarray(coefficients, np.float64).reshape(-1)
        if (v.size - 1) % 4:
            raise ValueError("expected 4*nstages + 1 coefficients")
        return cls.from_split(v[0], *v[1:].reshape(-1, 4).T, **kw)

    @classmethod
    def from_split(cls, g, b1, b2, a1, a2, **kw) -> "BiQuadCascade":
        """From a global gain and four arrays of one value a stage."""
        b1, b2, a1, a2 = (np.asarray(a, np.float64).reshape(-1)
                          for a in (b1, b2, a1, a2))
        b0 = np.ones_like(b1)
        b0[0] = float(g)
        return cls(np.stack([b0, b0 * b1, b0 * b2, a1, a2], -1), **kw)

    def process(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        y, self.states = cascade_apply(x, self._stages, self.states,
                                       engine=self.engine,
                                       systolic=self.systolic)
        return y

    def reset(self) -> None:
        self.states = None

    def calc_response(self, f) -> np.ndarray:
        return cascade_response(self.coeffs_host, f, self.fs)


class BiQuadBlock:
    """A cascade over ``nchannels`` channels in blocks of ``block_size``
    on ``device``."""

    def __init__(self, coeffs, nchannels: int, block_size: int,
                 engine: str = "auto", dtype=torch.float32, *, device):
        self.coeffs_host = np.atleast_2d(np.asarray(coeffs, np.float64))
        self.nchannels = nchannels
        self.block_size = block_size
        self.engine = engine
        self.device = torch.device(device)
        self.dtype = dtype
        self.states = None
        self._stages = _stages(self.coeffs_host, engine, self.device, dtype)

    def process_block(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        if x.shape[-1] != self.block_size:
            raise ValueError(f"block of {x.shape[-1]} samples, expected "
                             f"{self.block_size}")
        y, self.states = cascade_apply(x, self._stages, self.states,
                                       engine=self.engine)
        return y
