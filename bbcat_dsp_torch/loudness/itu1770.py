"""ITU-R BS.1770-4 multichannel loudness: K-weighting, gating blocks,
gated integrated loudness and the streaming meter.

The counterpart of the JAX package's ``loudness/itu1770.py``, with the
K-weighting design and gating constants of its ``golden/loudness.py``
re-derived here (the port does not import that package):

* K-weighting is the two standard biquads (high shelf, RLB high-pass)
  through the modal IIR engine, batched over channels, designed on the
  host in float64.
* Gating blocks of 400 ms with 75 % overlap come from a difference of
  cumulative sums of squares.
* :class:`LoudnessMeter` keeps the filter states, the squared tail of the
  last partial gating block, a ring of the last 3 s of block powers and
  per-0.1-LU ``(count, sum)`` histograms, so the two-stage gate runs over
  unbounded streams.  Everything but the readouts stays on the device;
  the readouts pull the histograms to the host, the meter's only sync.

On a CUDA card the histograms add with atomics, so ``hist_sum`` and
``st_sum`` sum in an order that changes from run to run (the counts are
exact), and the cumulative sums run as parallel scans that round
differently from the CPU's sequential sums.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..filters.iir import ModalState, modal_apply, modal_init, modal_params

__all__ = [
    "CHANNEL_WEIGHTS_5_1",
    "ABSOLUTE_GATE_LKFS",
    "RELATIVE_GATE_LU",
    "k_weighting_coeffs",
    "default_channel_weights",
    "k_weight_params",
    "k_weight",
    "block_powers",
    "integrated_loudness",
    "MeterState",
    "LoudnessMeter",
]

# channel weights G_i of BS.1770-4 Table 3: L, R, C, Ls, Rs (LFE excluded)
CHANNEL_WEIGHTS_5_1 = np.array([1.0, 1.0, 1.0, 1.41, 1.41], np.float64)
ABSOLUTE_GATE_LKFS = -70.0
RELATIVE_GATE_LU = -10.0
_OFFSET = -0.691  # BS.1770-4 eq. (2)


def _shelf_coeffs(fs: float) -> np.ndarray:
    """Stage 1, the spherical-head high shelf (BS.1770-4 Annex 1), by the
    pre-warped bilinear transform of its analogue prototype."""
    f0 = 1681.974450955533
    G = 3.999843853973347
    Q = 0.7071752369554196
    K = math.tan(math.pi * f0 / fs)
    Vh = 10.0 ** (G / 20.0)
    Vb = Vh ** 0.4996667741545416
    a0 = 1.0 + K / Q + K * K
    b0 = (Vh + Vb * K / Q + K * K) / a0
    b1 = 2.0 * (K * K - Vh) / a0
    b2 = (Vh - Vb * K / Q + K * K) / a0
    a1 = 2.0 * (K * K - 1.0) / a0
    a2 = (1.0 - K / Q + K * K) / a0
    return np.array([b0, b1, b2, a1, a2], np.float64)


def _rlb_coeffs(fs: float) -> np.ndarray:
    """Stage 2, the RLB high-pass (BS.1770-4 Annex 1)."""
    f0 = 38.13547087602444
    Q = 0.5003270373238773
    K = math.tan(math.pi * f0 / fs)
    a0 = 1.0 + K / Q + K * K
    a1 = 2.0 * (K * K - 1.0) / a0
    a2 = (1.0 - K / Q + K * K) / a0
    return np.array([1.0, -2.0, 1.0, a1, a2], np.float64)


def k_weighting_coeffs(fs: float) -> np.ndarray:
    """Both K-weighting biquads, ``[2, 5]`` float64 (shelf, RLB); at 48 kHz
    the values of the BS.1770-4 Annex 1 tables."""
    return np.stack([_shelf_coeffs(fs), _rlb_coeffs(fs)])


def default_channel_weights(nchannels: int) -> np.ndarray:
    """BS.1770-4 Table 3 weights for up to 5 channels (L R C Ls Rs), unity
    beyond."""
    if nchannels <= 5:
        return np.asarray(CHANNEL_WEIGHTS_5_1[:nchannels])
    return np.ones(nchannels, np.float64)


def k_weight_params(fs: float, *, device):
    """The two K-weighting biquads as ModalParams (shelf, RLB)."""
    shelf, rlb = k_weighting_coeffs(fs)
    return (modal_params(shelf, device=device),
            modal_params(rlb, device=device))


def k_weight(x: torch.Tensor, fs: float, states=None):
    """K-weight ``x [..., T]``: ``(y, (shelf_state, rlb_state))``."""
    p_shelf, p_rlb = k_weight_params(fs, device=x.device)
    if states is None:
        states = (modal_init(p_shelf, x.shape[:-1]),
                  modal_init(p_rlb, x.shape[:-1]))
    y, s1 = modal_apply(x, p_shelf, states[0])
    y, s2 = modal_apply(y, p_rlb, states[1])
    return y, (s1, s2)


def _window_means(sq: torch.Tensor, blk: int, step: int) -> torch.Tensor:
    """Mean of ``sq [C, T]`` over windows of ``blk`` samples every ``step``,
    by a difference of cumulative sums: ``[C, nblocks]``."""
    cs = torch.cumsum(sq, dim=-1)
    cs = torch.cat([torch.zeros_like(cs[..., :1]), cs], dim=-1)
    nblocks = (sq.shape[-1] - blk) // step + 1
    starts = torch.arange(nblocks, device=sq.device) * step
    return (cs[..., starts + blk] - cs[..., starts]) / blk


def _block_mean_squares(y: torch.Tensor, blk: int, step: int) -> torch.Tensor:
    """Per-channel mean square over the sliding gating blocks: ``y [C, T]``
    -> ``[C, nblocks]``."""
    return _window_means(torch.square(y), blk, step)


def _gates(fs: float) -> tuple[int, int]:
    """Gating-block length and hop in samples: 400 ms and 100 ms."""
    return int(round(0.400 * fs)), int(round(0.100 * fs))


def block_powers(x: torch.Tensor, fs: float, weights=None, states=None):
    """Weighted gating-block powers ``z_j`` over ``x [C, T]``: ``(z
    [nblocks], states)``; the block loudness is ``-0.691 + 10 log10 z_j``."""
    if weights is None:
        weights = default_channel_weights(x.shape[0])
    w = torch.as_tensor(np.asarray(weights, np.float32), device=x.device)
    y, states = k_weight(x, fs, states)
    blk, step = _gates(fs)
    ms = _block_mean_squares(y, blk, step)        # [C, nblocks]
    return torch.sum(w[:, None] * ms, dim=0), states


def _lkfs(z: torch.Tensor) -> torch.Tensor:
    return _OFFSET + 10.0 * torch.log10(torch.clamp(z, min=1e-30))


def _gated_mean(z: torch.Tensor) -> torch.Tensor:
    """The BS.1770-4 two-stage gated mean of block powers, with masks of
    fixed shape."""
    l = _lkfs(z)
    abs_mask = l > ABSOLUTE_GATE_LKFS
    n_abs = torch.clamp(abs_mask.sum(), min=1)
    z_abs = torch.where(abs_mask, z, 0.0).sum() / n_abs
    rel_thresh = _lkfs(z_abs) + RELATIVE_GATE_LU
    mask = abs_mask & (l > rel_thresh)
    n = torch.clamp(mask.sum(), min=1)
    zg = torch.where(mask, z, 0.0).sum() / n
    return torch.where(mask.any(), _lkfs(zg), -math.inf)


def integrated_loudness(x: torch.Tensor, fs: float,
                        weights=None) -> torch.Tensor:
    """One-shot gated integrated loudness (LKFS) of ``x [C, T]``, a 0-d
    tensor on ``x``'s device."""
    z, _ = block_powers(x, fs, weights)
    return _gated_mean(z)


class MeterState(NamedTuple):
    """Streaming loudness state."""

    shelf: ModalState
    rlb: ModalState
    sq_tail: torch.Tensor      # [C, blk - step] trailing K-weighted squares
    hist_count: torch.Tensor   # [nbins] int32 gating blocks per 0.1 LU bin
    hist_sum: torch.Tensor     # [nbins] sum of z per bin
    momentary_z: torch.Tensor  # [] last gating-block power
    short_ring: torch.Tensor   # [30] last 3 s of 100 ms block powers
    st_count: torch.Tensor     # [nbins] int32 short-term loudness histogram
    st_sum: torch.Tensor       # [nbins] short-term power sums (LRA gating)
    nblocks: int               # gating blocks completed


class LoudnessMeter:
    """Streaming BS.1770-4 meter: momentary (400 ms), short-term (3 s) and
    gated integrated loudness, and the loudness range, over unbounded
    streams on ``device``.

    Integrated gating uses per-0.1-LU ``(count, sum)`` histograms, the
    streaming-exact form of the two-stage gate (the bin width only decides
    which blocks sit at the threshold's edge)."""

    HIST_MIN, HIST_MAX, HIST_STEP = -90.0, 10.0, 0.1

    def __init__(self, nchannels: int, fs: float = 48000.0, weights=None, *,
                 device):
        self.device = torch.device(device)
        self.fs = fs
        self.nchannels = nchannels
        self.blk, self.step = _gates(fs)
        self.weights = torch.as_tensor(np.asarray(
            weights if weights is not None
            else default_channel_weights(nchannels), np.float32),
            device=self.device)
        self._params = k_weight_params(fs, device=self.device)
        self.nbins = int(round((self.HIST_MAX - self.HIST_MIN)
                               / self.HIST_STEP))
        self.reset()

    def _ingest(self, state: MeterState, x: torch.Tensor) -> MeterState:
        blk, step, nbins = self.blk, self.step, self.nbins
        p_shelf, p_rlb = self._params
        y, s1 = modal_apply(x, p_shelf, state.shelf)
        y, s2 = modal_apply(y, p_rlb, state.rlb)
        ext = torch.cat([state.sq_tail, torch.square(y)], -1)
        ncomplete = (ext.shape[-1] - blk) // step + 1
        z = torch.sum(self.weights[:, None]
                      * _window_means(ext, blk, step), dim=0)        # [n]
        # the first blk/step - 1 gating blocks of the stream span the
        # silence before it: they stay out of the histograms
        gidx = torch.arange(state.nblocks, state.nblocks + ncomplete,
                            device=x.device)
        keep = (_lkfs(z) > ABSOLUTE_GATE_LKFS) & (gidx >= blk // step - 1)
        bins = self._bins(_lkfs(z))
        cnt = state.hist_count.index_add(0, bins, keep.to(torch.int32))
        sm = state.hist_sum.index_add(0, bins, torch.where(keep, z, 0.0))
        # short-term (3 s) power per new block, a sliding mean over the
        # block-power history; it feeds the loudness-range histogram
        zcs = torch.cumsum(torch.cat([state.short_ring, z]), dim=0)
        zcs = torch.cat([torch.zeros_like(zcs[:1]), zcs])
        ends = 30 + torch.arange(ncomplete, device=x.device) + 1
        st_z = (zcs[ends] - zcs[ends - 30]) / 30.0
        st_l = _lkfs(st_z)
        st_keep = (gidx >= 32) & (st_l > ABSOLUTE_GATE_LKFS)
        st_bins = self._bins(st_l)
        st_cnt = state.st_count.index_add(0, st_bins, st_keep.to(torch.int32))
        st_sm = state.st_sum.index_add(0, st_bins,
                                       torch.where(st_keep, st_z, 0.0))
        consumed = ncomplete * step
        return MeterState(
            shelf=s1, rlb=s2,
            sq_tail=ext[:, consumed:consumed + blk - step].contiguous(),
            hist_count=cnt, hist_sum=sm,
            momentary_z=z[-1].clone(),
            short_ring=torch.cat([state.short_ring, z])[-30:].contiguous(),
            st_count=st_cnt, st_sum=st_sm,
            nblocks=state.nblocks + ncomplete,
        )

    def _bins(self, l: torch.Tensor) -> torch.Tensor:
        return torch.clamp(((l - self.HIST_MIN) / self.HIST_STEP)
                           .to(torch.int32), 0, self.nbins - 1)

    # -- feeding ---------------------------------------------------------
    def process(self, x: torch.Tensor) -> None:
        """Ingest ``x [C, T]``; T is a positive multiple of the 100 ms
        step, so the gating blocks stay aligned across calls."""
        T = x.shape[-1]
        if T == 0 or T % self.step:
            raise ValueError(f"feed a positive multiple of {self.step} "
                             f"samples (100 ms), got {T}")
        self.state = self._ingest(self.state, x)

    def process_buffered(self, buf: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
        """Ingest every whole 100 ms of ``[buf | x]`` (``[C, n]`` each) and
        return the rest, the caller's next ``buf``: a stream of blocks of
        any length meters without a host sync."""
        buf = torch.cat([buf, x], dim=-1)
        n = (buf.shape[-1] // self.step) * self.step
        if n:
            self.process(buf[:, :n])
            buf = buf[:, n:].contiguous()
        return buf

    # -- readouts --------------------------------------------------------
    def momentary(self) -> float:
        """Loudness of the last 400 ms gating block (LKFS)."""
        z = float(self.state.momentary_z)
        return _OFFSET + 10.0 * np.log10(max(z, 1e-30))

    def short_term(self) -> float:
        """Loudness over the last 3 s (LKFS)."""
        z = self.state.short_ring.cpu().numpy().mean()
        return _OFFSET + 10.0 * np.log10(max(z, 1e-30))

    def _centers(self) -> np.ndarray:
        return self.HIST_MIN + (np.arange(self.nbins) + 0.5) * self.HIST_STEP

    def integrated(self) -> float:
        """Gated integrated loudness since the last reset (LKFS)."""
        cnt = self.state.hist_count.cpu().numpy().astype(np.float64)
        sm = self.state.hist_sum.cpu().numpy().astype(np.float64)
        n_abs = cnt.sum()
        if n_abs == 0:
            return -np.inf
        z_abs = sm.sum() / n_abs
        rel = _OFFSET + 10.0 * np.log10(max(z_abs, 1e-30)) + RELATIVE_GATE_LU
        mask = self._centers() > rel
        n = cnt[mask].sum()
        if n == 0:
            return -np.inf
        return _OFFSET + 10.0 * np.log10(max(sm[mask].sum() / n, 1e-30))

    def loudness_range(self) -> float:
        """LRA in LU (EBU R128 / Tech 3342): the 95th less the 10th
        percentile of the gated short-term loudness distribution (absolute
        gate -70 LUFS, relative gate 20 LU below the power mean)."""
        cnt = self.state.st_count.cpu().numpy().astype(np.float64)
        sm = self.state.st_sum.cpu().numpy().astype(np.float64)
        n = cnt.sum()
        if n < 2:
            return 0.0
        thresh = _OFFSET + 10.0 * np.log10(max(sm.sum() / n, 1e-30)) - 20.0
        centers = self._centers()
        gated = np.where(centers > thresh, cnt, 0.0)
        total = gated.sum()
        if total < 2:
            return 0.0
        cum = np.cumsum(gated) / total
        lo = centers[np.searchsorted(cum, 0.10)]
        hi = centers[min(np.searchsorted(cum, 0.95), self.nbins - 1)]
        return float(hi - lo)

    def reset(self) -> None:
        """Back to silence, with empty histograms."""
        p_shelf, p_rlb = self._params
        C, dev = self.nchannels, self.device
        self.state = MeterState(
            shelf=modal_init(p_shelf, (C,)),
            rlb=modal_init(p_rlb, (C,)),
            sq_tail=torch.zeros((C, self.blk - self.step), device=dev),
            hist_count=torch.zeros(self.nbins, dtype=torch.int32, device=dev),
            hist_sum=torch.zeros(self.nbins, device=dev),
            momentary_z=torch.zeros((), device=dev),
            short_ring=torch.zeros(30, device=dev),
            st_count=torch.zeros(self.nbins, dtype=torch.int32, device=dev),
            st_sum=torch.zeros(self.nbins, device=dev),
            nblocks=0,
        )
