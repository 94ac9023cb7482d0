#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which exits nonzero on failure:

1. the card (``nvidia-smi`` name and power limit) and the PyTorch version;
   no CUDA device means exit 1 before anything else;
2. build the CUDA kernels from ``bbcat_dsp_torch/csrc`` with nvcc,
   one compiler per source, all at once;
3. each kernel against its plain PyTorch version on the card, at the
   shapes its paths give it and at small and odd ones (for K1 and K7 also
   across their output tiles' edges; K3 and K4 at every size they serve,
   32 to 8192, and at row counts that leave a CTA partly empty; K2 at
   every partition count of its register kernel, on its vector and its
   one-element path, and at counts of its general one, at every queue
   cursor; K9 also over a bfloat16 and a float16 queue, each a kernel of its own in the JSON line, on both its
   vector and its one-bin path, and timed warm and with a cold L2 beside
   a launch that does next to nothing and ``torch.sum`` over the same
   bytes; K3, K4, K7
   and K9 at BASELINE config #1's shapes, C = 1; K2s at config #5's tail,
   P = 14, C = 1024, F = 4097, over each queue type at three slots, its
   queue after the slot write equal to the plain version's), with
   times (CUDA events, median of 20 launches) at the main paths' shapes
   (four each for K3, K4 and K7), each beside its bound: the
   larger of the bytes the function must move over 3.35 TB/s and its
   operations over 67 TFLOP/s (float32), and for K3, K4 and K5 beside the
   one PyTorch call that computes the same (``torch.fft.rfft``, ``irfft``
   and a slice, ``permute().contiguous()``), which the port never calls;
4. the headline engine (64 channels x 32768-tap IRs, block 512, ratio 8)
   over a stream of distinct signals that takes all three render
   branches, held against a float64 ``scipy.signal.fftconvolve`` at
   >= 90 dB, with every render kernel launched and no plain version run;
5. throughput, ``rtf_64ch_32ktap_48kHz_1chip``: audio seconds over
   device time per render, over 24 distinct signals; and the same render
   with the plain versions in place of the kernels, for comparison;
6. streaming with click-free IR exchange: the headline two-level engine
   through ``process_small_block``, an exchange of every channel's IR,
   ``process_block``, an exchange of one channel's IR, and ``process``;
   then the uniform ``BlockConvolver`` (64 channels x 32768 taps, block
   512) through ``process_block`` with an exchange, and ``process``.  Each
   stream is held on channels 0, 31 and 63 against float64 convolutions
   of the right IRs (before the exchange, after it has settled, and as a
   whole against the crossfade model), passes the click check, and
   launches its path's kernels with no plain version run;
7. per-block latency of both streaming paths against the block's
   deadline (block / 48 kHz), back to back and device-only, with the
   kernels and with the plain versions, and the BlockConvolver render's
   real-time factor;
8. the binaural renderer (BASELINE config #3: 64 inputs x 2 ears, block
   512, 1024-tap HRTFs, a PEQ stage on every input) over 48 blocks with an
   HRTF exchange, held on both ears against float64 ``lfilter`` and
   ``fftconvolve`` (before the exchange, after it has settled, and against
   the crossfade model) with the click check, and its meter against a
   float64 gating of the same output; a ``MatrixConvolver`` exchange of
   one input's IRs; the matrix render's real-time factor over 128 blocks
   and the worst ``process_block`` of both back to back against the
   deadline (the median of three runs' worst blocks); then the render, an
   exchange and the latency again with 32768-tap binaural room IRs
   (P = 64);
9. BS.1770 loudness and mixdown (BASELINE config #4: 128 channels, 1 s at
   48 kHz): K-weighting against float64 ``lfilter`` on both branches of the
   modal engine (T = 48000, Toeplitz; T = 4800, the general scan) and with
   TF32 allowed by either of PyTorch's switches, each against a control
   with the precision helper bypassed that must fall far below 90 dB;
   integrated loudness against a float64 gating; the mixdown
   pipeline with float and int32 formats; EBU Tech 3341 cases 1-6 and Tech
   3342 cases 1-4; true peak of an inter-sample over; and the real-time
   factor of the config #4 step.  Phase 8 ends with the kernel launches
   of one call of each entry point, phase 9 with a profile of the headline
   render, a binaural block and a config #4 step (device time by kernel);
10. the EQ and delay pipeline (BASELINE config #2: 8 channels, 8 PEQ
   stages, block 4096, delays of 20 to 200 samples) over 16 distinct
   blocks on both delay paths (one delay a channel; a slow sinusoidal
   glide, one delay a sample) and through the modal fallback (a cascade
   with a repeated stage), each against float64 ``lfilter`` and a float64
   reading of the same ring positions at >= 90 dB; ``resample`` of a sine
   against the closed form; the step's real-time factor (median of three
   turns) with its device-only time and a profile.  This path runs no
   kernel of the port, and the counts show it.

11. the live-EQ path and what sits on the same scans, none of which runs
   a kernel of the port (the counts show it): ``BiQuadFilterBank`` at 64
   channels x 8 stages, block 512, over 200 distinct blocks, stage 3
   retargeted through ``set_filter(..., interp_time=0.05)`` before block
   100 and again in the middle of that ramp, held on channels 0, 31 and 63
   against a float64 per-sample DF2T with the interpolation contract at >=
   90 dB, the ramp window click-free; ``FilterManager`` with four named
   cascades of 2 to 8 stages over 56 of 64 channels against float64
   ``lfilter``; ``SchroederReverb`` at 2 and at 64 channels over 100 blocks
   against float64 comb and all-pass recurrences; ``offline_convolve`` of
   64 channels x 32768 taps x 10.24 s against ``fftconvolve`` (>= 90 dB)
   and the streamed two-level engine (>= 110 dB).  Each path's ms a block
   back to back (median of three turns), device-only time, real-time
   factor and profile; the bank's ramp block and steady block apart; one
   stage's scan in float32 and float64, flat and in two levels;
12. state files: the headline two-level engine, a ``BlockConvolver``, the
   binaural renderer with its meter, a 128-channel meter, the config #2
   pipeline and the bank in the middle of a ramp, each stopped half-way,
   written with ``save_state``, read into a fresh engine with
   ``load_state`` and continued through the path's kernels: >= 110 dB
   against the uninterrupted stream, readouts equal.  Then a file that the
   JAX package wrote (``tests/data/jax_state_v4.pkl``), read here without
   JAX, continued against that package's own output (>= 110 dB);
13. the command line and the host edge: 64-channel WAV files of phase
   11's 10.24 s signal and the headline IRs written with ``write_wav``;
   ``tools.convolve_cli`` in the process (IR branch: the render kernels,
   no plain version, every channel of its INT24 output >= 90 dB against
   float64 ``fftconvolve`` normalised as the CLI normalises; its seconds
   reading, rendering and writing, and its real-time factor), then ``python
   -m bbcat_dsp_torch.tools.convolve_cli`` as a process of its own on the
   same files (exit 0, the same output); the SOFA branch through a
   netCDF-3 file of 72 directions x 2 ears x 1024 taps (the matrix
   kernels, both ears >= 90 dB against the float64 sum over the directions
   the CLI picks), and an HDF5 file refused with an ``ImportError`` naming
   ``h5py`` where it is not installed; ``tools.loudness_cli`` on the
   64-channel file and a 2-channel one, within the printed 0.1 of a
   float64 gating and a float64 true peak; then the small ops at full
   width: a ``MultilayerBuffer`` mixing two ``BlockConvolver`` s (block
   128 with 4096 taps, block 512 with 32768 taps) over 2.048 s (the block
   kernels, >= 90 dB against float64), ``SoundDelayBuffer`` and
   ``SoundRingBuffer`` exact (INT24 packed round trips, delayed reads,
   a FIFO), ``mix_samples_ramped`` against a float64 loop,
   ``convolve2d`` with TF32 allowed by either cuDNN switch (>= 90 dB
   against scipy, the control without the precision helper far below),
   ``RunningAverage`` and ``Histogram`` against numpy, with no kernel
   count moved by the small ops; and whether the native format engine was
   built and used;
14. training through the kernels: the headline engine at full width (64
   IRs of 32768 taps through ``nonuniform_spectra``, so their transform
   is K3's, then two render groups from silence, 49152 samples),
   differentiated in reverse mode (a loss ``sum(g y)``: the gradients in
   the IRs and the signal against float64 correlations of the cotangent
   with the signal and with the IRs; in ``H_head`` and ``H_tail`` against
   autograd through the plain versions) and in forward mode
   (``torch.func.jvp`` in the IRs and the signal, against float64
   ``dx * h + x * dh``); the counts show K1-K6 launched forward and on the
   tangents and only the plain versions' adjoints backward.  Then the
   training step (a squared error against another IR set's output,
   ``backward()``, ``torch.optim.Adam``): its ms back to back and
   device-only, its launches and adjoint calls, its peak memory and a
   profile.  The same checks for ``convolver_render`` (K3, K7, K4) and a
   chain of ``convolver_step`` (K3, K9, K4) at the IR fit's sizes; then
   the four examples of ``bbcat_dsp_torch.examples`` with their checks
   (the fit's SNR, both Doppler shifts, the EQ's click check and float64
   model, the binaural scene's meter against a float64 gating and its
   INT24 file read back);
15. the sharded paths (``bbcat_dsp_torch.parallel``) and BASELINE config
   #5.  Phase 3 first holds the paths' new shapes against the plain
   versions and times them beside their bounds: K7 at P = 6 and 14, R =
   2, F = 4097 (the time-sharded render's pending MAC), K3/K4 over the
   halo's 16 x 64 tail rows (n = 8192) and 17 x 64 head rows (n = 1024),
   and the config #5 render's K1 (1024 channels, R = 112), K2 (P = 14, its
   register kernel), K3/K4 (14 x 1024 rows), K5 and K6.  Then (a) config #5
   in one process at full width, 1024 channels x 65536-tap IRs (block
   512, ratio 8, Pt = 14, one render group of 57344 samples), held on
   channels 0, 511 and 1023 against float64 ``fftconvolve`` (>= 90 dB),
   its real-time factor back to back and device-only over 8 distinct
   signals, its peak memory and a profile; (b) the same render
   channel-sharded (``channel_sharded_nonuniform_render``) over gloo
   worlds of 2 and 4 ranks that share the card, gathered on rank 0 and
   held against (a) (>= 110 dB, bit-exact or not), each rank's render
   time (contention on one card, not scaling); (c) its
   ``sharded_integrated_loudness``, one all-reduce, within 1e-4 LU of the
   unsharded meter and 0.01 of a float64 gating; (d)
   ``time_sharded_nonuniform_render`` at config #5's IRs (the first 64),
   4 ranks x 2 render groups (458752 samples) and then a (ch, t) = (2, 2)
   mesh, against the sequential stream (>= 110 dB) and float64 on three
   channels (>= 90 dB), each rank's halo bytes (16.8 MB on the 1-D mesh),
   what was staged through the host and the exchange's seconds; (e) the
   uniform engine at the headline geometry (64 x 32768 taps, block 512):
   ``channel_sharded_step`` over 8 blocks, ``channel_sharded_render`` and
   ``time_sharded_render`` (4 ranks x 49152 samples), each against one
   process (>= 110 dB); (f) an NCCL world of one rank: the group, an
   ``all_reduce_sum`` and a time-sharded render with no exchange, against
   one process; (g) ``examples.pod_render`` with its own checks; (h) the
   communication model's projection at (a)'s measured real-time factor,
   with the data sheets' H100 link bandwidths (assumed).  Every rank of
   every world launches its path's kernels and runs no plain version,
   and no rank compiles the kernels again; their launches join the
   kernels' counts below;
16. (a) BASELINE config #1 at its own geometry, uncut: a mono
   ``BlockConvolver``, block 512, one 4096-tap IR (P = 8), renders of
   T = 32768 samples: ``process`` and 64 ``process_block`` calls against
   float64 ``fftconvolve`` (>= 90 dB), each launching exactly K3, K7, K4
   once a render and K3, K9, K4 once a block; the render's real-time
   factor back to back over 8 distinct signals and device-only; the worst
   block back to back (the median of three runs' worst) against the
   deadline, and device-only; a profile of each; (b) the narrow queue
   (``dtype`` bfloat16 and float16) at the headline's 64 ch x 32768 taps,
   64 blocks with an exchange: the kernels against the plain versions at
   the same dtype (>= 110 dB), the distance from the float32 engine and
   from float64 printed, K9's narrow variant launched and the float32 one
   not, K9's time per dtype beside its bound; (c) ``irfft_planes`` on the
   card against the CPU (>= 110 dB) with nonzero DC and Nyquist imaginary
   parts, and the same spectra through ``torch.fft.irfft``, which must
   read lower at some shape for the zeroing to show.
17. the dtype surface at full width, each part at bfloat16 and float16
   beside float32, each SNR against float64 held to ``NARROW_BARS`` (the
   JAX package's own narrow output on the same inputs less 1 dB,
   ``tests/narrow_bars.py``): (a) the headline two-level engine with a
   narrow tail queue through ``process_block``, 16 super-blocks with an
   exchange of every IR and of channel 31's, channels 0, 31 and 63 against
   the float64 crossfade model with the click check, exactly the float32
   path's launches (K1, K3, K7, K4) and no plain version, ``process`` and
   ``process_small_block`` raising, the queue's bytes; (b) config #3
   narrow (``BinauralRenderer``, 48 blocks, an HRTF exchange; both ears
   and the meter against float64); (c) config #2 narrow on both delay
   paths and the modal fallback, the output in the narrow type, then a
   ``FractionalDelayLine``, ``SoundDelayBuffer`` and ``Resampler`` at 64
   channels; (d) config #4 narrow (the meter's integrated loudness against
   a float64 gating, the mixdown); (e) (a)-(c) resumed across state files
   (>= 110 dB). Each with its ms a block back to back and device-only and
   its peak memory.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel with its launches, error, times and bound.
"""

from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

FS = 48000.0
C, N, BLOCK, RATIO = 64, 32768, 512, 8   # bench.py's headline geometry
SB = BLOCK * RATIO
T_RENDER = 6 * SB                        # one render group: Pt = 6
P_UNIFORM = N // BLOCK                   # BlockConvolver partitions: 64
DEADLINE_MS = 1e3 * BLOCK / FS           # one block of audio: 10.667 ms
CHECKED = (0, C // 2 - 1, C - 1)         # channels 0, 31, 63
SEED = 0
HBM_BYTES_PER_S = 3.35e12                # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12                  # float32 outside the tensor cores

# the kernels each path must launch
RENDER_KERNELS = {"fused_head", "rfft_half", "xt_grouped_mac", "irfft_tail",
                  "gather_supers", "delayed_add"}
STREAM_KERNELS = RENDER_KERNELS | {"head_mac"}
# the two-level engine's super-blocks and renders: the tail steps in K2s
SUPER_STEP_KERNELS = RENDER_KERNELS | {"xt_step_mac"}
BLOCK_KERNELS = {"rfft_half", "rotated_mac", "irfft_tail", "head_mac"}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def tpu_kernel(func: str) -> str:
    """``file:line`` of the Pallas kernel ``func`` in the JAX package of
    this checkout, read as text (the port never imports that package)."""
    root = Path(__file__).resolve().parent
    for path in sorted(root.glob("*/ops/pallas/*.py")):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if line.startswith(f"def {func}("):
                return f"{path.relative_to(root)}:{i}"
    fail(f"Pallas kernel {func} not found in this checkout")


def exp_irs(rng, rows: int, n: int) -> np.ndarray:
    return rng.standard_normal((rows, n)) * np.exp(-np.arange(n) / 4000.0)


def fade(a, b, start: int, n: int):
    """``a`` before ``start``, a linear fade ``r[k] = (k + 1) / n`` to
    ``b`` over ``[start, start + n)``, ``b`` after: the engines' crossfade
    contract."""
    r = np.clip((np.arange(a.size) - start + 1) / n, 0.0, 1.0)
    return (1.0 - r) * a + r * b


def click_free(y) -> bool:
    """The click check of ``tests/test_nonuniform.py``."""
    return float(np.abs(np.diff(y)).max()) < 20 * float(
        np.median(np.abs(y) + 1e-9))


def snr_db(ref, test) -> float:
    ref = np.asarray(ref, np.float64)
    noise = ref - np.asarray(test, np.float64)
    p_noise = float(np.sum(noise ** 2))
    return float("inf") if p_noise == 0 else float(
        10.0 * np.log10(np.sum(ref ** 2) / p_noise))


def correlate_rows64(a, b, n: int):
    """``r[k] = sum_t a[t + k] b[t]`` for ``k < n``, row by row, float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    L = 1 << (a.shape[-1] + b.shape[-1]).bit_length()
    r = np.fft.irfft(np.fft.rfft(a, L) * np.conj(np.fft.rfft(b, L)), L)
    return r[..., :n]


def conv_rows64(a, b):
    """The causal convolution of ``a`` and ``b`` row by row, cut to
    ``a``'s length, float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    L = 1 << (a.shape[-1] + b.shape[-1]).bit_length()
    return np.fft.irfft(np.fft.rfft(a, L) * np.fft.rfft(b, L), L)[
        ..., :a.shape[-1]]


def lfilter64(x, c):
    """The biquad ``c = [b0, b1, b2, a1, a2]`` over the last axis of ``x``,
    in float64."""
    from scipy.signal import lfilter

    return lfilter(c[:3], np.r_[1.0, c[3:]], np.asarray(x, np.float64), axis=-1)


def lkfs(z):
    return -0.691 + 10.0 * np.log10(np.maximum(z, 1e-30))


def gated_lkfs(z) -> float:
    """BS.1770-4 two-stage gated loudness of block powers ``z``, float64."""
    z = np.asarray(z, np.float64)
    keep = lkfs(z) > -70.0
    if not keep.any():
        return -np.inf
    keep &= lkfs(z) > lkfs(z[keep].mean()) - 10.0
    return float(lkfs(z[keep].mean())) if keep.any() else -np.inf


def block_powers64(yk, weights, start: int = 0):
    """Weighted 400 ms block powers (100 ms hop) of K-weighted ``yk [C,
    T]``, float64; a block that begins before the signal (``start`` < 0)
    counts the silence before it."""
    blk, step = int(0.4 * FS), int(0.1 * FS)
    sq = np.concatenate([np.zeros((yk.shape[0], max(0, -start))),
                         np.asarray(yk, np.float64) ** 2], -1)
    n = (sq.shape[-1] - blk) // step + 1
    ms = np.stack([sq[:, j * step:j * step + blk].mean(-1) for j in range(n)],
                  -1)
    return np.asarray(weights, np.float64) @ ms


def cascade64(x, stages):
    """The biquads ``stages [S, 5]`` one after the other, float64."""
    y = np.asarray(x, np.float64)
    for c in stages:
        y = lfilter64(y, c)
    return y


def delayed64(y, delays, L: int, B: int):
    """A float64 reading of the ring positions the EQ and delay pipeline
    reads, block by block of ``B``: the positions in float32 as the
    contract computes them (block start modulo ``L`` in integers, minus
    the delay, plus ``L``, modulo ``L``), phase and base from them, then
    the 14 taps over the float64 samples ``y [C, T]`` that lie at those
    places in a ring of ``L`` written up to the block's end.  ``delays
    [C]`` or ``[C, T]``."""
    from bbcat_dsp_torch.filters.fractional import (
        OVERSAMPLING,
        TAPS,
        polyphase_table,
    )

    table64 = polyphase_table().reshape(TAPS, OVERSAMPLING)   # [tap, phase]
    out = np.zeros_like(y)
    rows = np.arange(y.shape[0])[:, None, None]
    for blk in range(y.shape[-1] // B):
        end = (blk + 1) * B
        d = delays[:, blk * B:end] if delays.ndim > 1 else delays[:, None]
        first = np.float32((end - B) % L)
        # one position a sample, or the block's first alone: the stream
        # read takes phase and base from it for the whole block
        ahead = (np.arange(B, dtype=np.float32) if delays.ndim > 1
                 else np.float32(0.0))
        pos = np.remainder((first + ahead) - d + np.float32(L), np.float32(L))
        phase = OVERSAMPLING - 1 - (np.floor(pos * np.float32(
            OVERSAMPLING)).astype(np.int64) % OVERSAMPLING)
        base = (np.floor(pos).astype(np.int64) + L - TAPS) % L
        if delays.ndim == 1:
            base = base + np.arange(B)
        place = (base[..., None] + np.arange(TAPS)) % L     # [C, B, 14]
        # the newest sample at each place: written at time m <= end - 1
        m = end - 1 - (end - 1 - place) % L
        taps = np.where(m >= 0, y[rows, np.maximum(m, 0)], 0.0)
        out[:, end - B:end] = np.sum(taps * table64.T[phase], -1)
    return out


# phase 17: the dtype surface at full width, on inputs of their own seed
NSUP17, SW_ALL, SW_ONE = 16, 6, 11        # (a): super-blocks, exchanges
CI17, NB17, SW17 = 64, 48, 16             # (b): config #3
C17, B17, NBLK17 = 8, 4096, 16            # (c): config #2
C4_17 = 128                               # (d): config #4, 1 s
# the bars: the JAX package's own narrow output against the same float64
# references on the same inputs, less 1 dB (the lower of its compiled and
# its operation-by-operation run), measured on the CPU by
# tests/narrow_bars.py; for the meter, JAX's integrated loudness error
# plus 0.01 LU
NARROW_BARS = {
    "bfloat16": {"a": 75.73, "b": 46.33, "c stream": 41.12, "c gather": 42.73,
                 "c modal": 34.77, "c line": 48.24, "d mixdown": 53.68},
    "float16": {"a": 93.81, "b": 61.99, "c stream": 58.73, "c gather": 60.38,
                "c modal": 51.02, "c line": 66.49, "d mixdown": 72.59}}
NARROW_LU = {"bfloat16": 0.0301, "float16": 0.0118}


def phase17_inputs(peq) -> dict:
    """Phase 17's inputs, all from one seed; ``peq(f, gain)`` designs a
    PEQ row ``[b0, b1, b2, a1, a2]`` at 48 kHz.  ``tests/narrow_bars.py``
    runs the JAX package on the same inputs for ``NARROW_BARS``."""
    rng = np.random.default_rng(SEED + 17)
    a = {"h1": exp_irs(rng, C, N), "h2": exp_irs(rng, C, N),
         "h3": exp_irs(rng, 1, N)[0],
         "x": rng.standard_normal((C, NSUP17 * SB)).astype(np.float32)}

    def hrtfs():
        h = rng.standard_normal((CI17, 2, 1024)) * np.exp(
            -np.arange(1024) / 200.0)
        return h / np.sqrt(np.sum(h ** 2, axis=-1, keepdims=True))

    b = {"h1": hrtfs(), "h2": hrtfs(), "eq": peq(1000.0, 4.0),
         "x": (rng.standard_normal((CI17, NB17 * BLOCK)) * 0.05).astype(
             np.float32)}
    eq2 = np.stack([peq(100.0 * (i + 1), 3.0 * (-1.0) ** i) for i in range(8)])
    T2 = NBLK17 * B17

    def grid(d):
        """Delays on the 1/128-sample grid, which float32 holds exactly at
        the reference's positions up to 2^17: its float32-position fault
        (ROADMAP queue 3, PR 6) stays out of the bars."""
        return (np.round(d * 128.0) / 128.0).astype(np.float32)

    c = {"eq": eq2, "twice": np.concatenate([eq2[:7], eq2[:1]]),
         "x": rng.standard_normal((C17, T2)).astype(np.float32),
         "steady": grid(np.linspace(20.0, 200.0, C17)),
         "glide": grid(110.0 + 90.0 * np.sin(2 * np.pi * 0.5 * np.arange(T2)
                                             / FS + np.arange(C17)[:, None])),
         "xs": rng.standard_normal((C, 8 * 1024)).astype(np.float32),
         "ds": rng.uniform(1.0, 900.0, (C, 512)).astype(np.float32)}
    levels = 10.0 ** (-rng.uniform(0.0, 20.0, C4_17) / 20.0)
    d = {"x": (rng.standard_normal((C4_17, int(FS))) * 0.1
               * levels[:, None]).astype(np.float32),
         "gains": rng.standard_normal((2, C4_17)) / np.sqrt(C4_17)}
    return {"a": a, "b": b, "c": c, "d": d}


def two_level_model(x, h1, h2, h3, ch: int, k_one: int):
    """Phase 17 (a)'s float64 model of channel ``ch`` through
    ``process_block``: every IR exchanged at super-block ``SW_ALL`` (the
    head fades over its first small block, the tail over its super-step,
    whose output comes two super-blocks later), channel ``k_one``'s IR
    exchanged for ``h3`` at ``SW_ONE``."""
    n1, taps = 2 * RATIO * BLOCK, np.arange(N)
    hc = h3 if ch == k_one else h2[ch]
    head = [conv_rows64(x[ch], np.where(taps < n1, h, 0.0))
            for h in (h1[ch], h2[ch], hc)]
    tail = [conv_rows64(x[ch], np.where(taps < n1, 0.0, h))
            for h in (h1[ch], h2[ch], hc)]
    return (fade(fade(head[0], head[1], SW_ALL * SB, BLOCK), head[2],
                 SW_ONE * SB, BLOCK)
            + fade(fade(tail[0], tail[1], (SW_ALL + 2) * SB, SB), tail[2],
                   (SW_ONE + 2) * SB, SB))


def binaural_model(x, eq, h1, h2):
    """Phase 17 (b)'s float64 model ``[2, T]``: the PEQ on every input,
    each input's convolution with its HRTFs summed, the exchange at block
    ``SW17`` faded over one block."""
    xe = lfilter64(x, eq)[:, None]
    return np.stack([fade(a, b, SW17 * BLOCK, BLOCK) for a, b in zip(
        conv_rows64(xe, h1).sum(0), conv_rows64(xe, h2).sum(0))])


def kweight64(x):
    """BS.1770 K-weighting in float64 (the port's design of the filters)."""
    from bbcat_dsp_torch.loudness import k_weighting_coeffs

    shelf, rlb = k_weighting_coeffs(FS)
    return lfilter64(lfilter64(x, shelf), rlb)


def fractional_reference(xs, ds, L: int, blk: int):
    """Phase 17 (c)'s delay line in float64: a ring of ``L`` written ``blk``
    samples of ``xs [C, T]`` at a time and read at ``ds [C, n]`` samples
    behind the head after each write, the positions in float32 as the line
    computes them: ``[C, n * T / blk]``."""
    import torch

    from bbcat_dsp_torch.filters.fractional import fractional_read

    out, ring = [], np.zeros((xs.shape[0], L))
    for k in range(xs.shape[1] // blk):
        w = (k + 1) * blk
        ring[:, (w - blk) % L:(w - blk) % L + blk] = xs[:, w - blk:w]
        pos = np.remainder(np.float32(w % L) - ds + np.float32(L),
                           np.float32(L))
        out.append(fractional_read(torch.from_numpy(ring),
                                   torch.from_numpy(pos)).numpy())
    return np.concatenate(out, -1)


def meter_reference(x) -> float:
    """The integrated loudness a meter fed ``x [C, T]`` (T whole 100 ms)
    reads, in float64: every gating block over the silence before the
    stream's start but the first three, unit weights."""
    z = block_powers64(kweight64(x), np.ones(x.shape[0]),
                       start=-int(0.3 * FS))
    return gated_lkfs(z[3:])


def sine(db_fs: float, seconds: float, nch: int = 2) -> np.ndarray:
    """``[nch, T]`` 997 Hz sine at ``db_fs`` (peak re full scale), the EBU
    Tech 3341/3342 test tone."""
    t = np.arange(round(seconds * FS)) / FS
    x = 10.0 ** (db_fs / 20.0) * np.sin(2 * np.pi * 997.0 * t)
    return np.broadcast_to(x, (nch, x.size)).astype(np.float32)


def main() -> None:
    import torch

    # ---- 1. the card -------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not card:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from bbcat_dsp_torch import BlockConvolver, NonUniformConvolver, ops_hook
        from bbcat_dsp_torch.ops.kernels import _build
        from bbcat_dsp_torch.ops.kernels import fused_head as k1
        from bbcat_dsp_torch.ops.kernels import half_fft as k34
        from bbcat_dsp_torch.ops.kernels import marshal as k56
        from bbcat_dsp_torch.ops.kernels import spectral_fir as k2
        from bbcat_dsp_torch.ops.kernels import spectral_mac as k79
    except ImportError as e:
        fail(f"the port is not importable here: {e}")
    dev = torch.device("cuda")

    # ---- 2. build ------------------------------------------------------------
    _build.library()
    print(f"build: {_build.BUILD_SECONDS:.1f} s", flush=True)
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    l2_flush = []

    def median_ms(fn, iters: int = 20, cold: bool = False) -> float:
        """Device time of ``fn``'s launches, median over ``iters`` runs.
        A ~2 ms spin on the stream first lets the host enqueue all of
        ``fn`` before the start event fires, so host launch overhead stays
        outside the events.  ``cold``: a read of 256 MB (five times the
        L2) before each run, so ``fn`` finds none of its operands there."""
        fn()
        torch.cuda.synchronize()
        if cold and not l2_flush:
            l2_flush.append(torch.empty(64 << 20, device=dev))
        times = []
        for _ in range(iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(4_000_000)
            if cold:
                l2_flush[0].sum()
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    results = {}

    def bound(nbytes: float, flops: float):
        """The least time the card could take, in ms, and what sets it:
        every input read and every output written once at the memory's
        rate, or the operations at the float32 rate."""
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        t_ops = 1e3 * flops / F32_FLOPS_PER_S
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    def fft_flops(rows: int, h: int) -> float:
        """One complex h-point FFT per row (5 h log2 h) and the packing of
        its h + 1 real-transform bins (~12 each)."""
        return rows * (5.0 * h * np.log2(h) + 12.0 * (h + 1))

    def record(name, source, replaces, err, ms, plain_ms, nbytes, flops,
               library_ms=None):
        bound_ms, bound_by = bound(nbytes, flops)
        results[name] = {"name": name, "route": "cuda",
                         "source": source, "replaces": replaces,
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": library_ms}
        lib = "" if library_ms is None else f"  library call {library_ms:.4f} ms"
        print(f"{name}: max_abs_err {err:.3e}  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms{lib}  bound {bound_ms:.4f} ms "
              f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP; {bound_by}; "
              f"{100 * bound_ms / ms:.0f}% of it)  ({card})", flush=True)

    # ---- 3. each kernel against its plain version ----------------------------
    # K1 fused head: (C, P, B, R); the first is the render's, the second
    # the streaming super-step's; R < P and R >= P both covered, and R = 1,
    # 7, 17 and 48 (with P = 1) across the edges of the kernel's tiles of
    # 4 output blocks (8 at B = 32, 2 at B = 1024); C = 131 and 132 on
    # either side of the card's SM count, R = 7 and 8 on either side of
    # the resident schedule's tile.  Each shape goes through the wrapper,
    # in the schedule fused_head_schedule picks for this card, and, where
    # the resident schedule fits its shared memory, through the schedule it
    # did not pick: both are held against the plain version everywhere.
    def k1_cost(Cc, P, B, R):
        """Bytes x, y, H, both carries and both half spectra; operations
        of 2 CR transforms and the MAC."""
        F = B + 1
        return (4.0 * (2 * Cc * R * B + 3 * 2 * P * Cc * F + 2 * 2 * Cc * F),
                2 * fft_flops(Cc * R, B) + 8.0 * P * Cc * R * F)

    k1_card = k1._card_limits(dev)
    print(f"fused_head's rule on this card: shared memory {k1_card[0]} "
          f"bytes a CTA, {k1_card[1]} SMs", flush=True)
    k1_err, bad, k1_step = None, [], None
    for Cc, P, B, R in ((C, 16, BLOCK, T_RENDER // BLOCK), (C, 16, BLOCK, 8),
                        (1, 1, 32, 1), (5, 6, 32, 4), (8, 6, 32, 16),
                        (5, 1, 512, 3), (8, 16, 512, 24), (3, 4, 1024, 5),
                        (C, 16, BLOCK, 1), (5, 16, 512, 7), (5, 16, 512, 17),
                        (5, 1, 512, 48), (3, 5, 64, 7), (3, 5, 128, 17),
                        (2, 3, 256, 9), (2, 20, 1024, 11), (131, 16, 512, 48),
                        (132, 16, 512, 48), (132, 16, 512, 7),
                        (132, 16, 512, 8), (3, 9, 1024, 6), (7, 3, 64, 1)):
        F = B + 1
        args = (randn(Cc, R * B), randn(2, P, Cc, F), randn(2, Cc, F),
                randn(2, P, Cc, F))
        picked = k1.fused_head_schedule(Cc, P, B, R, *k1_card)
        runs = [(f"{picked}, picked", lambda a=args, b=B:
                 k1.fused_head_cuda(*a, b))]
        other = k1.SCHEDULES[picked == "windowed"]
        if other == "windowed" or k1.resident_smem_bytes(P, B) <= k1_card[0]:
            runs.append((other, lambda a=args, b=B, o=other:
                         k1.fused_head_cuda_as(o, *a, b)))
        want = k1.fused_head_plain(*args, B)
        for tag, run in runs:
            got = run()
            torch.cuda.synchronize()
            snrs = [snr_db(w.cpu().numpy(), g.cpu().numpy())
                    for g, w in zip(got, want)]
            print(f"fused_head C={Cc} P={P} B={B} R={R} ({tag}): y/xcarry/"
                  "prev " + " ".join(f"{s:.1f}" for s in snrs) + " dB",
                  flush=True)
            if not min(snrs) >= 110.0:
                bad.append(f"fused_head C={Cc} P={P} B={B} R={R} ({tag})")
        if k1_err is None:
            got = k1.fused_head_cuda(*args, B)
            k1_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            bench_args = args
        elif k1_step is None:
            k1_step = args
    if bad:
        fail(f"below 110 dB: {bad}")
    record("fused_head", "bbcat_dsp_torch/csrc/fused_head.cu",
           tpu_kernel("fused_head_pallas"), k1_err,
           median_ms(lambda: k1.fused_head_cuda(*bench_args, BLOCK)),
           median_ms(lambda: k1.fused_head_plain(*bench_args, BLOCK)),
           *k1_cost(C, 16, BLOCK, T_RENDER // BLOCK))
    step_bound, _ = bound(*k1_cost(C, 16, BLOCK, 8))
    print(f"fused_head at R = 8 (the streaming super-step): kernel "
          f"{median_ms(lambda: k1.fused_head_cuda(*k1_step, BLOCK)):.4f} ms, "
          f"plain {median_ms(lambda: k1.fused_head_plain(*k1_step, BLOCK)):.4f}"
          f" ms, bound {step_bound:.4f} ms ({card})", flush=True)

    # K3/K4 tail transforms: (row shape, n).  The first four are the paths'
    # shapes, timed: the group render's, the per-super-step branch's, a
    # streamed block's and the BlockConvolver render's.  Then the matrix
    # paths' shapes and small ones; row counts that leave the last CTA of
    # a launch that packs 2, 4 or 8 rows a CTA partly empty; and every size
    # the kernels serve at 1, 5 and 67 rows, large and small sizes in turn
    def fft_cost(rows, h):
        """Rows of h samples against rows of h + 1 complex bins, either
        way; the library calls work on complex tensors, so they move the
        same bytes."""
        return 4.0 * rows * h + 8.0 * rows * (h + 1), fft_flops(rows, h)

    k34_shapes = (((6, C), 2 * SB), ((C,), 2 * SB), ((C,), 2 * BLOCK),
                  ((T_RENDER // BLOCK, C), 2 * BLOCK),
                  ((1,), 64), ((5, 3), 256), ((2,), 16384), ((7,), 2 * BLOCK),
                  ((128, C), 2 * BLOCK), ((128, 2), 2 * BLOCK),
                  ((2,), 2 * BLOCK),
                  ((530,), 2 * BLOCK), ((1061,), 512), ((13,), 64),
                  ((7,), 128), ((1059,), 128), ((3,), 256),
                  *(((r,), 2 * h) for h in (8192, 32, 4096, 64, 2048, 128,
                                            1024, 256, 512)
                    for r in (1, 5, 67)))
    k34_ms, bad = {}, []
    for i, (lead, n) in enumerate(k34_shapes):
        h = n // 2
        x, planes = randn(*lead, h), randn(2, *lead, h + 1)
        got = (k34.rfft_half_cuda(x, n), k34.irfft_tail_cuda(planes, n))
        want = (k34.rfft_half_plain(x, n), k34.irfft_tail_plain(planes, n))
        torch.cuda.synchronize()
        snrs = [snr_db(w.cpu().numpy(), g.cpu().numpy())
                for g, w in zip(got, want)]
        print(f"rfft_half/irfft_tail rows={lead} n={n}: "
              + " ".join(f"{s:.1f}" for s in snrs) + " dB", flush=True)
        if not min(snrs) >= 110.0:
            bad.append(f"tail transforms rows={lead} n={n}")
        if i < 4:   # the main paths' shapes, timed
            spec = torch.complex(planes[0], planes[1])
            rows = int(np.prod(lead))
            k34_ms[i] = {
                "cost": fft_cost(rows, h),
                "err": [float((g - w).abs().max()) for g, w in zip(got, want)],
                "rfft_half": (
                    median_ms(lambda: k34.rfft_half_cuda(x, n)),
                    median_ms(lambda: k34.rfft_half_plain(x, n)),
                    median_ms(lambda: torch.fft.rfft(x, n=n))),
                "irfft_tail": (
                    median_ms(lambda: k34.irfft_tail_cuda(planes, n)),
                    median_ms(lambda: k34.irfft_tail_plain(planes, n)),
                    median_ms(lambda: torch.fft.irfft(
                        spec, n=n)[..., h:].contiguous()))}
            b_ms = bound(*k34_ms[i]["cost"])[0]
            for name in ("rfft_half", "irfft_tail"):
                ms, plain_ms, lib_ms = k34_ms[i][name]
                print(f"  {name} at {rows} rows, n = {n}: kernel {ms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms, library call {lib_ms:.4f} ms, "
                      f"bound {b_ms:.4f} ms ({100 * b_ms / ms:.0f}% of it)  "
                      f"({card})", flush=True)
    if bad:
        fail(f"below 110 dB: {bad}")
    # the JSON line carries the group render's shape, the largest
    for j, (name, func) in enumerate((("rfft_half", "perm_rfft_half_pallas"),
                                      ("irfft_tail",
                                       "perm_irfft_tail_pallas"))):
        ms, plain_ms, lib_ms = k34_ms[0][name]
        record(name, "bbcat_dsp_torch/csrc/half_fft.cu", tpu_kernel(func),
               k34_ms[0]["err"][j], ms, plain_ms, *k34_ms[0]["cost"],
               library_ms=lib_ms)

    # K2 xt-grouped tail MAC: (P, C, F), each at every queue cursor.  The
    # render's shape first (timed), then odd C F, every partition count of
    # the register kernel on its vector path (C F even) and its one-element
    # path (C F odd) and counts of the general one, large shapes before
    # small ones.  Each launch's output lands on memory that held NaN just
    # before, so an element the kernel left out shows.
    def k2_cost(P, Cc, F):
        """Queue, xt and H in and the spectra out; P x P complex MACs
        and 2P - 1 window sums a bin."""
        return 4 * 8.0 * P * Cc * F, (8.0 * P * P + 4.0 * (2 * P - 1)) * Cc * F

    unrolled = _build.library().bbcat_xt_unrolled_parts()
    if unrolled != k2.XT_UNROLLED_PARTS:
        fail(f"xt_grouped_mac: the kernel unrolls P <= {unrolled}, the "
             f"wrapper says {k2.XT_UNROLLED_PARTS}")
    k2_timed, bad = {}, []
    for P, Cc, F in ((6, C, SB + 1), (12, C, SB + 1), (6, 7, SB + 1),
                     (2, 8, SB + 1), (1, 5, SB + 1),
                     *((P, 8, 257) for P in range(1, 18)),
                     *((P, 5, 33) for P in range(1, 18)),
                     (20, 3, 65), (64, 2, 33), (1, 1, 33)):
        path = "unrolled" if P <= unrolled else "general"
        low = None
        for slot0 in range(P):
            args = (randn(2, P, Cc, F), randn(2, P, Cc, F), randn(2, P, Cc, F))
            poison = torch.full_like(args[0], float("nan"))
            del poison            # the launch's output takes this block
            got = k2.xt_grouped_mac_cuda(*args, slot0)
            want = k2.xt_grouped_mac_plain(*args, slot0)
            s = snr_db(want.cpu().numpy(), got.cpu().numpy())
            if not s >= 120.0:    # NaN compares false
                bad.append(f"xt_grouped_mac P={P} C={Cc} F={F} slot0={slot0}")
            low = s if low is None else min(low, s)
        line = (f"xt_grouped_mac P={P} C={Cc} F={F} ({path} kernel), slot0 = "
                f"0 .. {P - 1}: >= {low:.1f} dB")
        if Cc == C:   # the render's shape and P = 12, timed
            k2_timed[P] = (
                float((got - want).abs().max()),
                median_ms(lambda: k2.xt_grouped_mac_cuda(*args, P // 2)),
                median_ms(lambda: k2.xt_grouped_mac_plain(*args, P // 2)))
            b_ms = bound(*k2_cost(P, Cc, F))[0]
            line += (f"; kernel {k2_timed[P][1]:.4f} ms, plain "
                     f"{k2_timed[P][2]:.4f} ms, bound {b_ms:.4f} ms "
                     f"({100 * b_ms / k2_timed[P][1]:.0f}% of it)  ({card})")
        print(line, flush=True)
    if bad:
        fail(f"below 120 dB: {bad}")
    record("xt_grouped_mac", "bbcat_dsp_torch/csrc/xt_grouped_mac.cu",
           tpu_kernel("xt_grouped_mac_pallas"), *k2_timed[6],
           *k2_cost(6, C, SB + 1))

    # K5 gather_supers: (C, nsup, B2); B2 = 33 takes the scalar path
    first = True
    for Cc, nsup, B2 in ((C, 6, SB), (1, 1, 256), (5, 2, 33), (8, 6, 256),
                         (5, 1, SB)):
        x = randn(Cc, nsup * B2)
        got = k56.gather_supers_cuda(x, nsup)
        if not torch.equal(got, k56.gather_supers_plain(x, nsup)):
            fail(f"gather_supers at C={Cc} nsup={nsup} B2={B2} not exact")
        if first:
            first, bench_x = False, x
    record("gather_supers", "bbcat_dsp_torch/csrc/marshal.cu",
           tpu_kernel("gather_supers_pallas"), 0.0,
           median_ms(lambda: k56.gather_supers_cuda(bench_x, 6)),
           median_ms(lambda: k56.gather_supers_plain(bench_x, 6)),
           2 * 4.0 * C * 6 * SB, 0.0,
           library_ms=median_ms(lambda: bench_x.reshape(C, 6, SB).permute(
               1, 0, 2).contiguous()))

    # K6 delayed_add: (C, Pt, B2); B2 = 33 takes the scalar path
    first = True
    for Cc, Pt, B2 in ((C, 6, SB), (1, 1, 256), (5, 2, 33), (8, 2, 256),
                       (5, 1, SB), (8, 6, 256)):
        args = (randn(Cc, Pt * B2), randn(2, Cc, B2), randn(Pt, Cc, B2))
        got = k56.delayed_add_cuda(*args)
        if not torch.equal(got, k56.delayed_add_plain(*args)):
            fail(f"delayed_add at C={Cc} Pt={Pt} B2={B2} not exact")
        if first:
            first, bench_args = False, args
    record("delayed_add", "bbcat_dsp_torch/csrc/marshal.cu",
           tpu_kernel("delayed_add_pallas"), 0.0,
           median_ms(lambda: k56.delayed_add_cuda(*bench_args)),
           median_ms(lambda: k56.delayed_add_plain(*bench_args)),
           4.0 * C * SB * (6 + 2 + 6 + 6), 1.0 * C * 6 * SB)

    # K7 head MAC: (C, P, R, F, extra history slots); the first four are
    # the paths' shapes (small-block head, head crossfade, per-super-step
    # tail, BlockConvolver render), then C = 1, 5, 12 (K8's regime in the
    # JAX package), P = 1, the crossfade's deeper history, and R off the
    # kernel's tiles of 8 and 16 outputs with C * F odd or not a multiple
    # of 4 and P off the 8 partitions loaded ahead
    def k7_cost(Cc, P, R, F):
        """Bytes of the history's first P + R slots, H and the output;
        one complex MAC a partition, output and bin."""
        return 8.0 * Cc * F * (P + R + P + R), 8.0 * P * R * Cc * F

    k7_shapes = ((C, 16, 1, BLOCK + 1, 0), (C, 16, RATIO, BLOCK + 1, 0),
                 (C, 6, 1, SB + 1, 0),
                 (C, P_UNIFORM, T_RENDER // BLOCK, BLOCK + 1, 0),
                 (1, 16, 1, BLOCK + 1, 0), (5, 16, RATIO, BLOCK + 1, 0),
                 (12, 6, 1, SB + 1, 0), (C, 1, 3, BLOCK + 1, 0),
                 (5, 3, 17, 33, 0), (C, 16, 1, BLOCK + 1, RATIO - 1),
                 (5, 7, 19, 33, 3), (3, 64, 33, 17, 0), (5, 20, 5, 33, 0),
                 (7, 9, 9, 9, 0))
    k7_err, bad, k7_ms = None, [], {}
    for i, (Cc, P, R, F, extra) in enumerate(k7_shapes):
        args = (randn(2, P + R + extra, Cc, F), randn(2, P, Cc, F))
        got = k79.head_mac_cuda(*args, R)
        want = k79.head_mac_plain(*args, R)
        s = snr_db(want.cpu().numpy(), got.cpu().numpy())
        if not s >= 120.0:
            bad.append(f"head_mac C={Cc} P={P} R={R} F={F}")
        line = f"head_mac C={Cc} P={P} R={R} F={F} depth={P + R + extra}: " \
               f"{s:.1f} dB"
        if i < 4:   # the main paths' shapes, timed
            k7_ms[(P, R, F)] = (
                median_ms(lambda: k79.head_mac_cuda(*args, R)),
                median_ms(lambda: k79.head_mac_plain(*args, R)))
            line += (f", kernel {k7_ms[(P, R, F)][0]:.4f} ms, plain "
                     f"{k7_ms[(P, R, F)][1]:.4f} ms, bound "
                     f"{bound(*k7_cost(Cc, P, R, F))[0]:.4f} ms ({card})")
            k7_err = max(k7_err or 0.0, float((got - want).abs().max()))
        print(line, flush=True)
    if bad:
        fail(f"below 120 dB: {bad}")
    # the JSON line carries the BlockConvolver render's shape, the largest
    ms, plain_ms = k7_ms[(P_UNIFORM, T_RENDER // BLOCK, BLOCK + 1)]
    record("head_mac", "bbcat_dsp_torch/csrc/spectral_mac.cu",
           tpu_kernel("head_mac_tiled_pallas"), k7_err, ms, plain_ms,
           *k7_cost(C, P_UNIFORM, T_RENDER // BLOCK, BLOCK + 1))

    # K2s single-step tail MAC: config #5's tail (P = 14, C = 1024, F =
    # 4097), a float32, a bfloat16 and a float16 queue, at three slots,
    # with and without the slot write: the output at >= 110 dB against the
    # plain version on the same operands, the queue untouched without the
    # write and equal to the plain version's after it.  Timed in float32
    # with the write, as a tail firing runs it
    def k2s_cost(P, Cc, F):
        """The queue and H read, xt read, the slot and the output
        written; one complex MAC and one complex window sum a partition
        and bin."""
        return (16.0 * P + 24.0) * Cc * F, 12.0 * P * Cc * F

    P5, C5, F5 = 14, 1024, 4097
    bad, k2s_err = [], 0.0
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        H5, xt5 = randn(2, P5, C5, F5), randn(2, C5, F5)
        q5 = randn(2, P5, C5, F5).to(dt)
        for slot in (0, 5, P5 - 1):
            kept = q5.clone()
            want = k79.xt_step_mac_plain(kept, xt5, H5, slot)
            got = k79.xt_step_mac_cuda(q5, xt5, H5, slot)
            s = snr_db(want.cpu().numpy(), got.cpu().numpy())
            untouched = bool(torch.equal(q5, kept))
            k79.xt_step_mac_plain(kept, xt5, H5, slot, True)
            got = k79.xt_step_mac_cuda(q5, xt5, H5, slot, True)
            s = min(s, snr_db(want.cpu().numpy(), got.cpu().numpy()))
            written = bool(torch.equal(q5, kept))
            tag = f"xt_step_mac P={P5} C={C5} F={F5} {dt} slot={slot}"
            print(f"{tag}: {s:.1f} dB, queue untouched without the write "
                  f"{untouched}, equal after it {written}", flush=True)
            if not (s >= 110.0 and untouched and written):
                bad.append(tag)
            if dt == torch.float32:
                k2s_err = max(k2s_err, float((got - want).abs().max()))
            del kept, want, got
        if dt == torch.float32:
            k2s_ms = (median_ms(lambda: k79.xt_step_mac_cuda(
                q5, xt5, H5, 5, True)), median_ms(lambda: k79.xt_step_mac_plain(
                    q5, xt5, H5, 5, True)))
        del H5, xt5, q5
    if bad:
        fail(f"xt_step_mac against its plain version: {bad}")
    record("xt_step_mac", "bbcat_dsp_torch/csrc/xt_step_mac.cu",
           "none: the JAX package's per-super-step tail forms its windows "
           "with XLA ops", k2s_err, *k2s_ms, *k2s_cost(P5, C5, F5))

    # K9 rotated MAC: (P, C, F, slot); the BlockConvolver step's shape at
    # three cursors, BASELINE config #1's block (C F = 513: one bin a
    # thread), small odd shapes, small ones on the vector path (C F a
    # multiple of 4, P below the kernel's row count) and the step's shape
    # with its planes one element off a vector boundary; float32 at 120 dB,
    # a bfloat16 and a float16 queue at 110 dB (each a kernel of its own in
    # the JSON line), each launch onto memory that held NaN just before
    schedule = [_build.library().bbcat_rotated_mac_schedule(i)
                for i in range(4)]
    if schedule != list(k79.ROTATED_MAC_SCHEDULE.values()):
        fail(f"rotated_mac: the kernel's schedule {schedule}, the wrapper "
             f"says {k79.ROTATED_MAC_SCHEDULE}")
    FQ = BLOCK + 1
    K9_NAMES = (("rotated_mac", torch.float32, 120.0),
                ("rotated_mac_bf16", torch.bfloat16, 110.0),
                ("rotated_mac_f16", torch.float16, 110.0))
    K9_SHAPES = ((P_UNIFORM, C, FQ, 37, 0), (P_UNIFORM, C, FQ, 0, 0),
                 (P_UNIFORM, C, FQ, P_UNIFORM - 1, 0), (8, 1, FQ, 5, 0),
                 (5, 3, 17, 4, 0), (1, 1, 9, 0, 0), (7, 5, 33, 6, 0),
                 (5, 4, 17, 2, 0), (3, 8, 33, 1, 0), (P_UNIFORM, C, FQ, 37, 1))

    def k9_operands(dt, P, Cc, F, off):
        """Queue and H at ``[2, P, Cc, F]``, each ``off`` elements into
        its own allocation (a contiguous view)."""
        n = 2 * P * Cc * F
        q = randn(n + off)[off:].to(dt).view(2, P, Cc, F)
        return q, randn(n + off)[off:].view(2, P, Cc, F)

    def k9_cost(P, Cc, F, qbytes_each):
        """The queue in its type, H in float32 and the output; one
        complex MAC a partition and bin."""
        return ((qbytes_each + 8.0) * P * Cc * F + 8.0 * Cc * F,
                8.0 * P * Cc * F)

    k9_bench = {}
    for name, dt, bar in K9_NAMES:
        bad = []
        for P, Cc, F, slot, off in K9_SHAPES:
            args = k9_operands(dt, P, Cc, F, off)
            poison = torch.full((2, Cc, F), float("nan"), device=dev)
            del poison          # the launch's output lands on it
            got = k79.rotated_mac_cuda(*args, slot)
            want = k79.rotated_mac_plain(*args, slot)
            s = snr_db(want.cpu().numpy(), got.cpu().numpy())
            tag = f"{name} P={P} C={Cc} F={F} slot={slot}" + (
                f" off={off}" if off else "")
            if not s >= bar:
                bad.append(tag)
            print(f"{tag}: {s:.1f} dB", flush=True)
            if (P, Cc, slot, off) == (P_UNIFORM, C, 37, 0):
                k9_bench[name] = (float((got - want).abs().max()), args)
            if (P, Cc, F, off) == (8, 1, FQ, 0):
                k9_bench[name + " config #1"] = args
        if bad:
            fail(f"below {bar:.0f} dB: {bad}")

    # K9's times, warm and with a cold L2: the step's shape at slot 37 and
    # config #1's block, in each queue type
    for name, dt, _ in K9_NAMES:
        err, bench_args = k9_bench[name]
        qsize = bench_args[0].element_size()
        rows = []
        for label, (P, Cc, F, slot), ops in (
                (f"P={P_UNIFORM} C={C} F={FQ} slot=37",
                 (P_UNIFORM, C, FQ, 37), bench_args),
                (f"config #1 P=8 C=1 F={FQ} slot=5", (8, 1, FQ, 5),
                 k9_bench[name + " config #1"])):
            new = [median_ms(lambda: k79.rotated_mac_cuda(*ops, slot),
                             cold=cold) for cold in (False, True)]
            b_ms, _ = bound(*k9_cost(P, Cc, F, 2 * qsize))
            rows.append(new)
            print(f"{name} {label}: kernel {new[0]:.4f} ms warm, "
                  f"{new[1]:.4f} ms cold L2 ({100 * b_ms / new[0]:.0f}%, "
                  f"{100 * b_ms / new[1]:.0f}% of the bound "
                  f"{b_ms:.4f} ms)  ({card})", flush=True)
        if dt != torch.float32:
            qbytes = 2.0 * P_UNIFORM * C * FQ * qsize
            print(f"{name}: the queue {qbytes / 1e6:.1f} MB against "
                  f"{qbytes * 2 / 1e6:.1f} MB in float32", flush=True)
        record(name, "bbcat_dsp_torch/csrc/spectral_mac.cu",
               tpu_kernel("rotated_mac_pallas"), err, rows[0][0],
               median_ms(lambda: k79.rotated_mac_plain(*bench_args, 37)),
               *k9_cost(P_UNIFORM, C, FQ, 2 * qsize))
    # what holds K9 back once its loads are in flight: a launch that does
    # next to nothing, and one library read of the step's float32 bytes
    # (timed only, never used by the port)
    tiny = (randn(2, 1, 1, 1), randn(2, 1, 1, 1))
    blob = torch.empty(int(k9_cost(P_UNIFORM, C, FQ, 8)[0]) // 4, device=dev)
    print(f"rotated_mac P=1 C=1 F=1 (a launch that does next to nothing): "
          f"{median_ms(lambda: k79.rotated_mac_cuda(*tiny, 0)):.4f} ms; "
          f"torch.sum over {4 * blob.numel() / 1e6:.1f} MB "
          f"{median_ms(blob.sum):.4f} ms warm, "
          f"{median_ms(blob.sum, cold=True):.4f} ms cold L2  ({card})",
          flush=True)
    del blob

    # the sharded paths' new shapes (phase 15), each against its plain
    # version and timed beside its bound: the time-sharded two-level
    # render's pending MAC (K7 at P = Pt, R = 2, F = 4097) and its halo
    # transforms (K3 over the Pt + 2 tail super-blocks and the Ph + 1 head
    # blocks of 64 channels at config #5's Pt = 14), then the config #5
    # render at 1024 channels: K1 (R = 112), K2 (P = 14, its register
    # kernel), K3/K4 (beside their library calls), K5 and K6
    def hold_shape(label, kernel, plain_fn, args, cost, bar, library=None):
        got, want = kernel(*args), plain_fn(*args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if bar is None:
            ok = all(torch.equal(g, w) for g, w in zip(got, want))
            what = "exact" if ok else "NOT exact"
        else:
            low = min(snr_db(w.cpu().numpy(), g.cpu().numpy())
                      for g, w in zip(got, want))
            ok, what = low >= bar, f"{low:.1f} dB"
        ms = median_ms(lambda: kernel(*args))
        plain_ms = median_ms(lambda: plain_fn(*args), iters=5)
        b_ms, by = bound(*cost)
        lib = ("" if library is None else
               f", library call {median_ms(library):.4f} ms")
        print(f"{label}: {what}; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms{lib}, bound {b_ms:.6f} ms ({by}; {cost[0] / 1e6:.3f} MB, "
              f"{cost[1] / 1e9:.4f} GFLOP; {100 * b_ms / ms:.0f}% of it)  "
              f"({card})", flush=True)
        if not ok:
            fail(f"{label}: {what} against the plain version")

    C5, N5, PT5 = 1024, 65536, 14        # BASELINE config #5
    T5 = PT5 * SB                        # one render group: 57344 samples
    CT5 = 64                             # phase 15's time-sharded channels
    for P in (6, PT5):
        hold_shape(f"head_mac C={CT5} P={P} R=2 F={SB + 1} (the pending MAC)",
                   k79.head_mac_cuda, k79.head_mac_plain,
                   (randn(2, P + 2, CT5, SB + 1), randn(2, P, CT5, SB + 1), 2),
                   k7_cost(CT5, P, 2, SB + 1), 120.0)
    for lead, n in (((PT5 + 2, CT5), 2 * SB), ((2 * RATIO + 1, CT5), 2 * BLOCK),
                    ((PT5, C5), 2 * SB)):
        xr, pr = randn(*lead, n // 2), randn(2, *lead, n // 2 + 1)
        spec = torch.complex(pr[0], pr[1])
        rows = int(np.prod(lead))
        hold_shape(f"rfft_half rows={lead} n={n}", k34.rfft_half_cuda,
                   k34.rfft_half_plain, (xr, n), fft_cost(rows, n // 2), 110.0,
                   library=lambda: torch.fft.rfft(xr, n=n))
        hold_shape(f"irfft_tail rows={lead} n={n}", k34.irfft_tail_cuda,
                   k34.irfft_tail_plain, (pr, n), fft_cost(rows, n // 2),
                   110.0, library=lambda: torch.fft.irfft(
                       spec, n=n)[..., n // 2:].contiguous())
    del xr, pr, spec
    # K1 at config #5 takes the resident schedule; the windowed one is
    # timed beside it on the same operands, in turns
    if k1.fused_head_schedule(C5, 16, BLOCK, T5 // BLOCK,
                              *k1._card_limits(dev)) != "resident":
        fail("fused_head at config #5's shape did not pick the resident "
             "schedule")
    k1_args5 = (randn(C5, T5), randn(2, 16, C5, BLOCK + 1),
                randn(2, C5, BLOCK + 1), randn(2, 16, C5, BLOCK + 1), BLOCK)
    hold_shape(f"fused_head C={C5} P=16 B={BLOCK} R={T5 // BLOCK} (resident, "
               "picked)", k1.fused_head_cuda, k1.fused_head_plain, k1_args5,
               k1_cost(C5, 16, BLOCK, T5 // BLOCK), 110.0)
    k1_turns = {"resident": [], "windowed": []}
    for sched in ("windowed", "resident", "resident", "windowed"):
        k1_turns[sched].append(median_ms(
            lambda: k1.fused_head_cuda_as(sched, *k1_args5)))
    k1_b5, _ = bound(*k1_cost(C5, 16, BLOCK, T5 // BLOCK))
    print(f"fused_head C={C5} P=16 B={BLOCK} R={T5 // BLOCK}, in turns: "
          + ", ".join(f"{k} " + " / ".join(f"{t:.4f}" for t in v) + " ms ("
                      f"{100 * k1_b5 / min(v):.0f}% of its bound)"
                      for k, v in k1_turns.items())
          + f"; bound {k1_b5:.4f} ms  ({card})", flush=True)
    del k1_args5
    hold_shape(f"xt_grouped_mac P={PT5} C={C5} F={SB + 1} (register kernel), "
               f"slot0 = 5", k2.xt_grouped_mac_cuda, k2.xt_grouped_mac_plain,
               (randn(2, PT5, C5, SB + 1), randn(2, PT5, C5, SB + 1),
                randn(2, PT5, C5, SB + 1), 5),
               k2_cost(PT5, C5, SB + 1), 120.0)
    x1024 = randn(C5, T5)
    hold_shape(f"gather_supers C={C5} nsup={PT5} B2={SB}",
               k56.gather_supers_cuda, k56.gather_supers_plain, (x1024, PT5),
               (2 * 4.0 * C5 * T5, 0.0), None,
               library=lambda: x1024.reshape(C5, PT5, SB).permute(
                   1, 0, 2).contiguous())
    hold_shape(f"delayed_add C={C5} Pt={PT5} B2={SB}", k56.delayed_add_cuda,
               k56.delayed_add_plain,
               (x1024, randn(2, C5, SB), randn(PT5, C5, SB)),
               (4.0 * C5 * SB * (3 * PT5 + 2), 1.0 * C5 * T5), None)
    del x1024
    # BASELINE config #1's shapes (phase 16: mono, block 512, 4096 taps,
    # P = 8, renders of 64 blocks): K3/K4 over one block and over the
    # render's 64, K7 at C = 1 R = 64, K9 at C = 1
    P1, R1 = 8, 64
    for lead in ((1,), (R1, 1)):
        xr, pr = randn(*lead, BLOCK), randn(2, *lead, FQ)
        spec = torch.complex(pr[0], pr[1])
        rows = int(np.prod(lead))
        hold_shape(f"rfft_half rows={lead} n={2 * BLOCK} (config #1)",
                   k34.rfft_half_cuda, k34.rfft_half_plain, (xr, 2 * BLOCK),
                   fft_cost(rows, BLOCK), 110.0,
                   library=lambda: torch.fft.rfft(xr, n=2 * BLOCK))
        hold_shape(f"irfft_tail rows={lead} n={2 * BLOCK} (config #1)",
                   k34.irfft_tail_cuda, k34.irfft_tail_plain,
                   (pr, 2 * BLOCK), fft_cost(rows, BLOCK), 110.0,
                   library=lambda: torch.fft.irfft(
                       spec, n=2 * BLOCK)[..., BLOCK:].contiguous())
    hold_shape(f"head_mac C=1 P={P1} R={R1} F={FQ} (config #1 render)",
               k79.head_mac_cuda, k79.head_mac_plain,
               (randn(2, P1 + R1, 1, FQ), randn(2, P1, 1, FQ), R1),
               k7_cost(1, P1, R1, FQ), 120.0)
    hold_shape(f"rotated_mac P={P1} C=1 F={FQ} slot=5 (config #1 block)",
               k79.rotated_mac_cuda, k79.rotated_mac_plain,
               (randn(2, P1, 1, FQ), randn(2, P1, 1, FQ), 5),
               (8.0 * FQ * (2 * P1 + 1), 8.0 * P1 * FQ), 120.0)
    torch.cuda.empty_cache()

    path_launches = []

    def check_path(label: str, counts: dict, must: set) -> None:
        """Fail unless the path launched every kernel in ``must`` and ran
        no plain version.  A count is one call of a kernel's wrapper: the
        fused head's is two launches on the stream (its windows, then its
        MAC and inverses)."""
        print(f"{label}: counts {counts}", flush=True)
        missing = sorted(k for k in must if counts["launches"][k] <= 0)
        if missing:
            fail(f"{label}: kernels {missing} were not launched")
        if any(counts["plain"].values()):
            fail(f"{label}: plain versions ran: {counts['plain']}")
        path_launches.append(counts["launches"])

    # ---- 4. end to end -------------------------------------------------------
    from scipy.signal import fftconvolve

    rng = np.random.default_rng(SEED)
    irs = (rng.standard_normal((C, N))
           * np.exp(-np.arange(N) / 4000.0)).astype(np.float64)
    conv = NonUniformConvolver(irs, block=BLOCK, ratio=RATIO, device=dev)
    # 4 single-group renders, one two-group render, one render of 4
    # super-blocks (not a multiple of Pt = 6: the per-super-step branch)
    lengths = [T_RENDER] * 4 + [2 * T_RENDER, 4 * SB]
    x = rng.standard_normal((C, sum(lengths))).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    torch.cuda.synchronize()
    ops_hook.reset_counts()
    ys, t0 = [], 0
    for n in lengths:
        ys.append(conv.process(xd[:, t0:t0 + n]))
        t0 += n
    torch.cuda.synchronize()
    check_path("end to end", ops_hook.counts(), RENDER_KERNELS)
    y = torch.cat(ys, dim=-1).cpu().numpy()
    if conv.state.tail.step != sum(lengths) // SB:
        fail(f"tail step {conv.state.tail.step} != {sum(lengths) // SB}")
    if y.shape != x.shape or not np.all(np.isfinite(y)):
        fail(f"output shape {y.shape} or non-finite values")
    for ch in CHECKED:
        ref = fftconvolve(x[ch].astype(np.float64), irs[ch])[:x.shape[1]]
        s = snr_db(ref, y[ch])
        print(f"snr_db_vs_golden channel {ch}: {s:.2f} dB", flush=True)
        if not s >= 90.0:
            fail(f"channel {ch}: {s:.2f} dB < 90 against float64")

    # ---- 5. throughput -------------------------------------------------------
    audio_s = T_RENDER / FS
    xs = randn(26, C, T_RENDER)  # 2 warm-up + 24 timed, all distinct

    def render_ms(engine):
        """Per render of ``engine``: back-to-back stream time over 24
        renders (host gaps included, what a streaming caller gets) and the
        median device-only time (``median_ms``)."""
        engine.reset()
        for r in range(2):
            engine.process(xs[r])
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for r in range(24):
            engine.process(xs[2 + r])
        b.record()
        torch.cuda.synchronize()
        it = iter(range(24))
        return a.elapsed_time(b) / 24, median_ms(
            lambda: engine.process(xs[2 + next(it) % 24]), iters=23)

    plain = {"fused_head": k1.fused_head_plain,
             "rfft_half": k34.rfft_half_plain,
             "xt_grouped_mac": k2.xt_grouped_mac_plain,
             "irfft_tail": k34.irfft_tail_plain,
             "gather_supers": k56.gather_supers_plain,
             "delayed_add": k56.delayed_add_plain,
             "head_mac": k79.head_mac_plain,
             "rotated_mac": k79.rotated_mac_plain}
    kern = {name: getattr(ops_hook, name) for name in plain}

    def use(label: str) -> None:
        """Send every dispatch to the kernels or to the plain versions."""
        for name in plain:
            setattr(ops_hook, name, (kern if label == "kernels"
                                     else plain)[name])

    rows = []
    for label in ("kernels", "plain", "plain", "kernels"):
        use(label)
        stream_ms, device_ms = render_ms(conv)
        rows.append((label, stream_ms, device_ms))
        print(f"render ({label}): {stream_ms:.4f} ms/render back to back, "
              f"{device_ms:.4f} ms device-only median, "
              f"{audio_s / (stream_ms / 1e3):.2f} x real time ({card})",
              flush=True)
    use("kernels")
    k_ms = statistics.mean(r[1] for r in rows if r[0] == "kernels")
    p_ms = statistics.mean(r[1] for r in rows if r[0] == "plain")
    rtf = audio_s / (k_ms / 1e3)
    print(f"rtf_64ch_32ktap_48kHz_1chip: {rtf:.2f} (kernels; plain versions "
          f"{audio_s / (p_ms / 1e3):.2f}) on {card}", flush=True)

    # ---- 6. streaming with click-free IR exchange ------------------------------
    def conv64(x, h):
        return fftconvolve(x.astype(np.float64), h)[:x.size]

    def hold(label: str, ref, y, lo: int = 0, hi: int | None = None):
        s = snr_db(ref[lo:hi], y[lo:hi])
        print(f"{label}: {s:.2f} dB", flush=True)
        if not s >= 90.0:
            fail(f"{label}: {s:.2f} dB < 90 against float64")

    # the two-level engine: every channel's IR exchanged mid-way through
    # super-block 3 of small blocks, channel 31's at super-block 7 of
    # whole super-blocks, then one render group
    k_one = C // 2 - 1
    h1, h2 = exp_irs(rng, C, N), exp_irs(rng, C, N)
    h3 = exp_irs(rng, 1, N)[0]
    swap1, swap2, T = 3 * SB + 3 * BLOCK, 7 * SB, 16 * SB
    x = rng.standard_normal((C, T)).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    stream = NonUniformConvolver(h1, block=BLOCK, ratio=RATIO, device=dev)
    torch.cuda.synchronize()
    ops_hook.reset_counts()
    ys = []
    for i in range(4 * RATIO):
        if i * BLOCK == swap1:
            stream.set_filter(h2)
        ys.append(stream.process_small_block(xd[:, i * BLOCK:(i + 1) * BLOCK]))
    for j in range(4, 10):
        if j * SB == swap2:
            stream.set_filter(h3, channel=k_one)
        ys.append(stream.process_block(xd[:, j * SB:(j + 1) * SB]))
    ys.append(stream.process(xd[:, 10 * SB:]))
    torch.cuda.synchronize()
    check_path("streaming two-level", ops_hook.counts(),
               STREAM_KERNELS | SUPER_STEP_KERNELS)
    y = torch.cat(ys, dim=-1).cpu().numpy()
    if y.shape != x.shape or not np.all(np.isfinite(y)):
        fail(f"streaming output shape {y.shape} or non-finite values")
    n1 = 2 * RATIO * BLOCK  # head taps; the tail's output is 2 SB late
    for ch in CHECKED:
        ha, hb = h1[ch], h2[ch]
        hc = h3 if ch == k_one else hb
        head = [conv64(x[ch], np.where(np.arange(N) < n1, h, 0.0))
                for h in (ha, hb, hc)]
        tail = [conv64(x[ch], np.where(np.arange(N) < n1, 0.0, h))
                for h in (ha, hb, hc)]
        # the head fades over the exchange's small block; the tail over
        # its faded step's output, 2 super-blocks after the step
        model = (fade(fade(head[0], head[1], swap1, BLOCK), head[2], swap2,
                      BLOCK)
                 + fade(fade(tail[0], tail[1], 5 * SB, SB), tail[2],
                        9 * SB, SB))
        tag = f"streaming two-level channel {ch}"
        hold(f"{tag}, before the exchange", conv64(x[ch], ha), y[ch],
             hi=swap1)
        hold(f"{tag}, settled on the new IR", conv64(x[ch], hb), y[ch],
             6 * SB, swap2 if ch == k_one else None)
        if ch == k_one:
            hold(f"{tag}, settled on its own new IR", conv64(x[ch], hc),
                 y[ch], 10 * SB)
        hold(f"{tag}, whole stream against the crossfade model", model,
             y[ch])
        if not click_free(y[ch]):
            fail(f"{tag}: a click")

    # the uniform engine: an exchange at block 12 of 24, then renders of
    # 48 blocks (not a multiple of P = 64) and of P blocks
    g1, g2 = exp_irs(rng, C, N), exp_irs(rng, C, N)
    nb, swap_b = 24, 12
    lengths = [T_RENDER, P_UNIFORM * BLOCK]
    T = nb * BLOCK + sum(lengths)
    x = rng.standard_normal((C, T)).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    bconv = BlockConvolver(g1, block=BLOCK, device=dev)
    if bconv.nparts != P_UNIFORM:
        fail(f"BlockConvolver holds {bconv.nparts} partitions")
    torch.cuda.synchronize()
    ops_hook.reset_counts()
    ys = []
    for i in range(nb):
        if i == swap_b:
            bconv.set_filter(g2)
        ys.append(bconv.process_block(xd[:, i * BLOCK:(i + 1) * BLOCK]))
    t0 = nb * BLOCK
    for n in lengths:
        ys.append(bconv.process(xd[:, t0:t0 + n]))
        t0 += n
    torch.cuda.synchronize()
    check_path("streaming BlockConvolver", ops_hook.counts(), BLOCK_KERNELS)
    if bconv.state.step != T // BLOCK:
        fail(f"BlockConvolver step {bconv.state.step} != {T // BLOCK}")
    y = torch.cat(ys, dim=-1).cpu().numpy()
    if y.shape != x.shape or not np.all(np.isfinite(y)):
        fail(f"BlockConvolver output shape {y.shape} or non-finite values")
    swap = swap_b * BLOCK
    for ch in CHECKED:
        old, new = conv64(x[ch], g1[ch]), conv64(x[ch], g2[ch])
        tag = f"streaming BlockConvolver channel {ch}"
        hold(f"{tag}, before the exchange", old, y[ch], hi=swap)
        hold(f"{tag}, settled on the new IR", new, y[ch], swap + BLOCK)
        hold(f"{tag}, whole stream against the crossfade model",
             fade(old, new, swap, BLOCK), y[ch])
        if not click_free(y[ch]):
            fail(f"{tag}: a click")

    # ---- 7. per-block latency against the deadline ------------------------------
    spin_cycles = 30_000_000   # ~15 ms at the card's clock

    def per_block_ms(step, n: int, device_only: bool):
        """Intervals between events recorded around ``n`` consecutive
        calls ``step(i)``.  Back to back, the stream waits on the host as
        a live caller's does.  Device-only, a spin on the stream first
        lets the host enqueue all ``n`` calls ahead; ``None`` when the
        host took longer than the spin (a plain path's many launches fill
        the launch queue, which then blocks the host)."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 2)]
        torch.cuda.synchronize()
        if device_only:
            ev[-1].record()
            torch.cuda._sleep(spin_cycles)
        t0 = time.perf_counter()
        ev[0].record()
        for i in range(n):
            step(i)
            ev[i + 1].record()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[n].synchronize()
        ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(n)]
        if device_only and host_ms >= ev[-1].elapsed_time(ev[0]):
            return None
        return ms

    xl = randn(C, 96 * BLOCK)  # distinct blocks

    def latency(engine, small: bool):
        """(back-to-back, device-only) per-block times over whole
        super-blocks; the two-level engine's slowest block is the one on
        which the tail fires."""
        engine.reset()
        call = engine.process_small_block if small else engine.process_block
        at = iter(range(10 ** 6))

        def step(_):
            i = next(at) % 96
            call(xl[:, i * BLOCK:(i + 1) * BLOCK])

        for i in range(RATIO):
            step(i)
        b2b = per_block_ms(step, 6 * RATIO, False)
        # device-only one block at a time, over two super-blocks
        devo = [per_block_ms(step, 1, True) for _ in range(2 * RATIO)]
        return b2b, (None if None in devo else [t[0] for t in devo])

    lat = {}
    for label in ("kernels", "plain", "plain", "kernels"):
        use(label)
        for name, engine, small in (("process_small_block", stream, True),
                                    ("BlockConvolver.process_block", bconv,
                                     False)):
            b2b, devo = latency(engine, small)
            lat.setdefault((name, label), []).append((b2b, devo))
            dev_txt = ("device-only not resolved (host slower than the "
                       "spin)" if devo is None else
                       f"device-only mean {statistics.mean(devo):.4f} ms, "
                       f"max {max(devo):.4f} ms")
            print(f"latency {name} ({label}): back to back mean "
                  f"{statistics.mean(b2b):.4f} ms, max {max(b2b):.4f} ms; "
                  f"{dev_txt}; deadline {DEADLINE_MS:.4f} ms ({card})",
                  flush=True)
        stream_ms, device_ms = render_ms(bconv)
        rows.append(("block " + label, stream_ms, device_ms))
        print(f"BlockConvolver.process ({label}): {stream_ms:.4f} ms/render "
              f"back to back, {device_ms:.4f} ms device-only median, "
              f"{audio_s / (stream_ms / 1e3):.2f} x real time ({card})",
              flush=True)
    use("kernels")
    for (name, label), runs in lat.items():
        worst = max(max(b2b) for b2b, _ in runs)
        print(f"{name} ({label}): worst block {worst:.4f} ms back to back, "
              f"{DEADLINE_MS / worst:.1f}x inside the {DEADLINE_MS:.4f} ms "
              f"deadline ({card})", flush=True)
    for label in ("kernels", "plain"):
        ms = statistics.mean(r[1] for r in rows if r[0] == "block " + label)
        print(f"BlockConvolver.process real-time factor ({label}), "
              f"T = {T_RENDER}: {audio_s / (ms / 1e3):.2f} on {card}",
              flush=True)

    # ---- 8. binaural renderer and matrix convolver (config #3) -------------------
    from bbcat_dsp_torch import BinauralRenderer, MatrixConvolver
    from bbcat_dsp_torch.filters import FilterType, biquad_coeffs

    MATRIX_KERNELS = {"rfft_half", "irfft_tail"}
    CI, N_HRTF, N_BRIR = 64, 1024, 32768   # scripts/bench_all.py config #3
    eq = biquad_coeffs(FilterType.PEQ, 1000.0, FS, gain=4.0)

    def hrtfs(n: int, decay: float):
        """Decaying noise IRs ``[CI, 2, n]`` of unit energy per input and
        ear, so 64 inputs at 0.05 rms render near -2 LUFS: inside the
        meter's histogram, which ends at +10 LUFS."""
        h = rng.standard_normal((CI, 2, n)) * np.exp(-np.arange(n) / decay)
        return h / np.sqrt(np.sum(h ** 2, axis=-1, keepdims=True))

    def mix64(x, h):
        """Sum over the inputs of each input's float64 convolution: ``[2,
        T]``."""
        T = x.shape[-1]
        return fftconvolve(np.asarray(x, np.float64)[:, None], h,
                           axes=-1)[..., :T].sum(0)

    def run_stream(label, call, swap, nb, exchange):
        """``nb`` blocks of a fresh signal through ``call``, ``exchange()``
        before block ``swap``; launch check; ``(x, y)`` on the host."""
        x = (rng.standard_normal((CI, nb * BLOCK)) * 0.05).astype(np.float32)
        xd = torch.from_numpy(x).to(dev)
        torch.cuda.synchronize()
        ops_hook.reset_counts()
        ys = []
        for i in range(nb):
            if i == swap:
                exchange()
            ys.append(call(xd[:, i * BLOCK:(i + 1) * BLOCK]))
        torch.cuda.synchronize()
        check_path(label, ops_hook.counts(), MATRIX_KERNELS)
        y = torch.cat(ys, dim=-1).cpu().numpy()
        if y.shape != (2, x.shape[1]) or not np.all(np.isfinite(y)):
            fail(f"{label}: output shape {y.shape} or non-finite values")
        return x, y

    def hold_exchange(label, old, new, y, swap):
        s = swap * BLOCK
        for o, ear in enumerate(("left", "right")):
            tag = f"{label}, {ear} ear"
            hold(f"{tag}, before the exchange", old[o], y[o], hi=s)
            hold(f"{tag}, settled on the new IRs", new[o], y[o], s + BLOCK)
            hold(f"{tag}, whole stream against the crossfade model",
                 fade(old[o], new[o], s, BLOCK), y[o])
            if not click_free(y[o]):
                fail(f"{tag}: a click")

    # the renderer: 48 blocks, the HRTF set exchanged at block 16
    h1, h2 = hrtfs(N_HRTF, 200.0), hrtfs(N_HRTF, 200.0)
    rend = BinauralRenderer(h1, block=BLOCK, eq_stages=[eq], fs=FS, device=dev)
    x, y = run_stream("binaural renderer", rend.process_block, 16, 48,
                      lambda: rend.set_hrtf(h2))
    xe = lfilter64(x, eq)
    hold_exchange("binaural", mix64(xe, h1), mix64(xe, h2), y, 16)
    # its meter has had every whole 100 ms of the output: the last gating
    # block is momentary; the stream's first three blocks span the silence
    # before it and stay out of the integrated gate
    fed = (y.shape[1] // rend.meter.step) * rend.meter.step
    z = block_powers64(kweight64(y)[:, :fed], [1.0, 1.0],
                       start=-(rend.meter.blk - rend.meter.step))
    got = rend.loudness()
    for key, want in (("momentary_lkfs", float(lkfs(z[-1]))),
                      ("integrated_lkfs", gated_lkfs(z[3:]))):
        print(f"binaural meter {key}: {got[key]:.4f} against float64 "
              f"{want:.4f}", flush=True)
        if not abs(got[key] - want) <= 0.01:
            fail(f"binaural meter {key}: {got[key]:.4f} != {want:.4f}")

    # a MatrixConvolver exchange of input 7's IRs only, at block 8
    k_in = 7
    mconv = MatrixConvolver(h1, block=BLOCK, device=dev)
    h_new = h1.copy()
    h_new[k_in] = hrtfs(N_HRTF, 200.0)[k_in]
    x, y = run_stream("matrix per-input exchange", mconv.process_block, 8, 24,
                      lambda: mconv.set_filter_matrix(h_new[k_in],
                                                      in_channel=k_in))
    hold_exchange(f"matrix exchange of input {k_in}", mix64(x, h1),
                  mix64(x, h_new), y, 8)

    def device_ms(fn, iters: int) -> str:
        """Median device time of ``fn`` over ``iters`` calls, each behind a
        ~15 ms spin (``per_block_ms``): the host enqueues a whole call
        before the card starts it, so the events see no launch gaps."""
        ts = [per_block_ms(lambda _: fn(), 1, True) for _ in range(iters)]
        if None in ts:
            return "not resolved (host slower than the spin)"
        return f"{statistics.median(t[0] for t in ts):.4f} ms"

    def matrix_timings(label, conv):
        """The render's real-time factor over 128-block renders of distinct
        signals, back to back and device-only."""
        nren, T = 8, 128 * BLOCK
        xs = [randn(CI, T) for _ in range(nren + 2)]
        conv.reset()
        torch.cuda.synchronize()
        ops_hook.reset_counts()
        for r in range(2):
            conv.process(xs[r])
        torch.cuda.synchronize()
        check_path(f"{label} render", ops_hook.counts(), MATRIX_KERNELS)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for r in range(nren):
            conv.process(xs[2 + r])
        b.record()
        torch.cuda.synchronize()
        b2b = a.elapsed_time(b) / nren
        it = iter(range(10 ** 6))
        devo = device_ms(lambda: conv.process(xs[2 + next(it) % nren]), nren)
        print(f"{label} render, 128 blocks: {b2b:.4f} ms back to back, "
              f"{devo} device-only median, "
              f"{T / FS / (b2b / 1e3):.2f} x real time ({card})", flush=True)
        return b2b

    def block_latency(label, call, repeats: int = 3):
        """Blocks of ``call`` back to back, 48 at a time, ``repeats``
        times, and device-only one block per spin over 20.  The median of
        the repeats' worst blocks back to back is held to the deadline:
        that is what a live caller feels, and the median keeps one stall
        of a shared host from deciding the run."""
        xl = randn(CI, 96 * BLOCK)
        at = iter(range(10 ** 6))

        def step(_):
            i = next(at) % 96
            call(xl[:, i * BLOCK:(i + 1) * BLOCK])

        for i in range(8):
            step(i)
        runs = [per_block_ms(step, 48, False) for _ in range(repeats)]
        devo = [per_block_ms(step, 1, True) for _ in range(20)]
        dev_txt = ("device-only not resolved (host slower than the spin)"
                   if None in devo else
                   f"device-only mean {statistics.mean(t[0] for t in devo):.4f}"
                   f" ms, max {max(t[0] for t in devo):.4f} ms")
        worsts = [max(b2b) for b2b in runs]
        worst = statistics.median(worsts)
        print(f"latency {label}: back to back mean "
              f"{statistics.mean(t for b2b in runs for t in b2b):.4f} ms, "
              "worst " + " / ".join(f"{w:.4f}" for w in worsts) + " ms, "
              f"median worst {worst:.4f} ms ({DEADLINE_MS / worst:.1f}x "
              f"inside the {DEADLINE_MS:.4f} ms deadline); {dev_txt} ({card})",
              flush=True)
        if not worst < DEADLINE_MS:
            fail(f"latency {label}: median worst block {worst:.4f} ms misses "
                 f"the {DEADLINE_MS:.4f} ms deadline")

    matrix_timings("MatrixConvolver 64x2, 1024 taps", mconv)
    block_latency("BinauralRenderer.process_block (64x2, 1024 taps, EQ, "
                  "meter)", rend.process_block)
    block_latency("MatrixConvolver.process_block (64x2, 1024 taps)",
                  mconv.process_block)

    # binaural room IRs: 32768 taps, P = 64, H of 33.6 MB
    b1, b2 = hrtfs(N_BRIR, 4000.0), hrtfs(N_BRIR, 4000.0)
    room = MatrixConvolver(b1, block=BLOCK, device=dev)
    if room.nparts != N_BRIR // BLOCK:
        fail(f"room MatrixConvolver holds {room.nparts} partitions")
    print(f"room IRs: H {room.H.numel() * 8 / 1e6:.1f} MB", flush=True)
    x, y = run_stream("room IR exchange", room.process_block, 8, 24,
                      lambda: room.set_filter_matrix(b2))
    hold_exchange("room IR exchange", mix64(x, b1), mix64(x, b2), y, 8)
    matrix_timings("MatrixConvolver 64x2, 32768 taps", room)
    block_latency("MatrixConvolver.process_block (64x2, 32768 taps)",
                  room.process_block)

    # kernel launches of one call of each entry point (wrapper calls; the
    # fused head's is two launches on the stream)
    def launches_of(label, engine, call, warm: int = 0):
        engine.reset()
        for _ in range(warm):
            call()
        torch.cuda.synchronize()
        ops_hook.reset_counts()
        call()
        torch.cuda.synchronize()
        counts = ops_hook.counts()
        if any(counts["plain"].values()):
            fail(f"{label}: plain versions ran: {counts['plain']}")
        per_call[label] = {k: v for k, v in counts["launches"].items() if v}

    per_call = {}
    xb, xsb, xm = xl[:, :BLOCK], xl[:, :SB], randn(CI, 128 * BLOCK)
    launches_of("NonUniformConvolver.process, T = 24576", conv,
                lambda: conv.process(xs[0]))
    launches_of("NonUniformConvolver.process_block", stream,
                lambda: stream.process_block(xsb))
    launches_of("NonUniformConvolver.process_small_block", stream,
                lambda: stream.process_small_block(xb))
    launches_of("NonUniformConvolver.process_small_block, the super-block's "
                "last (the tail fires)", stream,
                lambda: stream.process_small_block(xb), warm=RATIO - 1)
    launches_of("BlockConvolver.process, T = 24576", bconv,
                lambda: bconv.process(xs[0]))
    launches_of("BlockConvolver.process_block", bconv,
                lambda: bconv.process_block(xb))
    launches_of("MatrixConvolver.process_block (64x2)", mconv,
                lambda: mconv.process_block(xb))
    launches_of("MatrixConvolver.process, 128 blocks (64x2)", mconv,
                lambda: mconv.process(xm))
    for label, counts in per_call.items():
        print(f"launches per call, {label}: {counts}", flush=True)

    # ---- 9. loudness and mixdown (config #4) ------------------------------------
    from bbcat_dsp_torch import LoudnessMeter, MixdownPipeline
    from bbcat_dsp_torch.filters import iir
    from bbcat_dsp_torch.formats import SampleFormat, float_to_int32, int32_to_float
    from bbcat_dsp_torch.loudness import integrated_loudness, k_weight, true_peak_db
    from bbcat_dsp_torch.loudness.truepeak import _H as TP_TAPS

    C4, T4, STEP4 = 128, int(FS), int(0.1 * FS)
    levels = 10.0 ** (-rng.uniform(0.0, 20.0, C4) / 20.0)
    x = (rng.standard_normal((C4, T4)) * 0.1 * levels[:, None]).astype(
        np.float32)
    xd = torch.from_numpy(x).to(dev)
    ref = kweight64(x)
    torch.cuda.synchronize()
    ops_hook.reset_counts()

    def hold_channels(label, ref, y):
        """Every channel at >= 90 dB against float64; prints the worst."""
        worst = min(snr_db(r, t) for r, t in zip(ref, y))
        print(f"{label}: worst channel {worst:.2f} dB", flush=True)
        if not worst >= 90.0:
            fail(f"{label}: {worst:.2f} dB < 90 against float64")

    y48, _ = k_weight(xd, FS)                       # one call: Toeplitz
    st, parts = None, []
    for k in range(T4 // STEP4):                    # 4800 a call: the scan
        yk, st = k_weight(xd[:, k * STEP4:(k + 1) * STEP4], FS, st)
        parts.append(yk)
    hold_channels("k_weight T = 48000 (Toeplitz products)", ref,
                  y48.cpu().numpy())
    hold_channels("k_weight 10 calls of T = 4800 (general scan)", ref,
                  torch.cat(parts, -1).cpu().numpy())
    def hold_tf32(label, allow, restore):
        """A caller that allows TF32 globally (``allow()``): the products
        stay full float32.  The control, the same call with the precision
        helper bypassed, must fall far below 90 dB, or the switch no
        longer enables TF32 and the check proves nothing."""
        allow()
        try:
            ytf, _ = k_weight(xd, FS)
            real_f32, iir.full_f32 = iir.full_f32, contextlib.nullcontext
            try:
                ybare, _ = k_weight(xd, FS)
            finally:
                iir.full_f32 = real_f32
        finally:
            restore()
        hold_channels(f"k_weight T = 48000 with {label}", ref,
                      ytf.cpu().numpy())
        bare = min(snr_db(r, t) for r, t in zip(ref, ybare.cpu().numpy()))
        print(f"k_weight T = 48000 with {label} and the precision helper "
              f"bypassed (the control): worst channel {bare:.2f} dB",
              flush=True)
        if not bare < 80.0:
            fail(f"TF32 control with {label}: {bare:.2f} dB, not far below "
                 "90 dB: the switch did not enable TF32")

    matmul = torch.backends.cuda.matmul
    prev_allow = matmul.allow_tf32
    hold_tf32("allow_tf32 = True", lambda: setattr(matmul, "allow_tf32", True),
              lambda: setattr(matmul, "allow_tf32", prev_allow))
    prev_prec = torch.get_float32_matmul_precision()
    hold_tf32('set_float32_matmul_precision("high")',
              lambda: torch.set_float32_matmul_precision("high"),
              lambda: torch.set_float32_matmul_precision(prev_prec))

    L = float(integrated_loudness(xd, FS))
    want = gated_lkfs(block_powers64(ref, np.ones(C4)))
    print(f"integrated_loudness 128 ch, 1 s: {L:.4f} LKFS against float64 "
          f"{want:.4f}", flush=True)
    if not abs(L - want) <= 0.01:
        fail(f"integrated_loudness {L:.4f} != float64 {want:.4f}")

    gains = rng.standard_normal((2, C4)) * 0.05
    mix_ref = gains @ x.astype(np.float64)
    for fin, fout in (("FLOAT", "FLOAT"), ("INT32", "INT32")):
        pipe = MixdownPipeline(gains, FS, in_format=SampleFormat[fin],
                               out_format=SampleFormat[fout], device=dev)
        xin = float_to_int32(xd) if fin == "INT32" else xd
        ys = [pipe.process_block(xin[:, k * STEP4:(k + 1) * STEP4])
              for k in range(T4 // STEP4)]
        y = torch.cat(ys, -1)
        y = (int32_to_float(y) if fout == "INT32" else y).cpu().numpy()
        hold_channels(f"MixdownPipeline {fin} in, {fout} out", mix_ref, y)
        L = pipe.integrated_loudness()
        want = gated_lkfs(block_powers64(kweight64(mix_ref), [1.0, 1.0]))
        print(f"MixdownPipeline {fin}/{fout} integrated loudness {L:.4f} "
              f"LKFS against float64 {want:.4f}", flush=True)
        if not abs(L - want) <= 0.01:
            fail(f"MixdownPipeline {fin}/{fout}: {L:.4f} != {want:.4f}")

    def meter_feed(x, nch=2):
        m = LoudnessMeter(nch, FS, device=dev)
        xd = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        T, chunk = x.shape[-1], int(FS)
        for i in range(0, T - chunk + 1, chunk):
            m.process(xd[:, i:i + chunk])
        rem = (T % chunk) - (T % chunk) % m.step
        if rem:
            m.process(xd[:, T - T % chunk:T - T % chunk + rem])
        return m

    def seq(*segs):
        return np.concatenate([sine(db, s) for db, s in segs], -1)

    # EBU Tech 3341 cases 1-6 (+/- 0.1 LU): (signal, loudness, meter checks)
    ebu3341 = {
        1: (sine(-23.0, 20.0), -23.0, "msi"),
        2: (sine(-33.0, 20.0), -33.0, "msi"),
        3: (seq((-36.0, 10.0), (-23.0, 60.0), (-36.0, 10.0)), -23.0, "i"),
        4: (seq((-72.0, 10.0), (-36.0, 10.0), (-23.0, 60.0), (-36.0, 10.0),
                (-72.0, 10.0)), -23.0, "i"),
        5: (seq((-26.0, 20.0), (-20.0, 20.1), (-26.0, 20.0)), -23.0, "i"),
        6: (np.concatenate([sine(db, 20.0, nch=1) for db in
                            (-28.0, -28.0, -24.0, -30.0, -30.0)]), -23.0, "i"),
    }
    for case, (sig, want, checks) in ebu3341.items():
        m = meter_feed(sig, sig.shape[0])
        got = {"one-shot I": float(integrated_loudness(
            torch.from_numpy(sig).to(dev), FS)), "meter I": m.integrated()}
        if checks == "msi":
            got.update({"M": m.momentary(), "S": m.short_term()})
        print(f"EBU 3341 case {case}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in got.items()) + f" (want {want})",
            flush=True)
        if not all(abs(v - want) <= 0.1 for v in got.values()):
            fail(f"EBU 3341 case {case} outside +/- 0.1 LU")
    for case, segs, want in (
            (1, [(-20.0, 20.0), (-30.0, 20.0)], 10.0),
            (2, [(-15.0, 20.0), (-30.0, 20.0)], 15.0),
            (3, [(-40.0, 20.0), (-20.0, 20.0)], 20.0),
            (4, [(-50.0, 20.0), (-35.0, 20.0), (-20.0, 20.0), (-35.0, 20.0),
                 (-50.0, 20.0)], 15.0)):
        lra = meter_feed(seq(*segs)).loudness_range()
        print(f"EBU 3342 case {case}: LRA {lra:.3f} LU (want {want})",
              flush=True)
        if not abs(lra - want) <= 1.0:
            fail(f"EBU 3342 case {case}: LRA {lra:.3f} outside +/- 1 LU")

    # true peak of the inter-sample over of tests/test_loudness.py, against
    # the same interpolator in float64
    s = np.sin(2 * np.pi * np.arange(4800) / 4 + np.pi / 4)[None].astype(
        np.float32)
    tp = float(true_peak_db(torch.from_numpy(s).to(dev))[0])
    win = np.lib.stride_tricks.sliding_window_view(s[0].astype(np.float64), 12)
    tp64 = 20 * np.log10(max(np.abs(win @ TP_TAPS.T.astype(np.float64)).max(),
                             np.abs(s).max()))
    print(f"true_peak_db inter-sample over: {tp:.5f} dBTP against float64 "
          f"{tp64:.5f}, sample peak {20 * np.log10(np.abs(s).max()):.3f} dB",
          flush=True)
    if not (abs(tp - tp64) <= 1e-3 and abs(tp) < 0.35
            and tp > 20 * np.log10(np.abs(s).max()) + 0.5):
        fail(f"true peak {tp:.5f} dBTP")
    counts = ops_hook.counts()
    if any(counts["plain"].values()):
        fail(f"loudness phase: plain versions ran: {counts['plain']}")

    # the config #4 step: BS.1770 metering of the 128 inputs, and the int32
    # mixdown of the same second to 2 channels with the mix's meter
    meter128 = LoudnessMeter(C4, FS, device=dev)
    mixdown = MixdownPipeline(gains, FS, in_format=SampleFormat.INT32,
                              device=dev)
    xs4 = [float_to_int32(randn(C4, T4) * 0.1) for _ in range(10)]

    def step4(xi):
        meter128.process(int32_to_float(xi))
        mixdown.process_block(xi)

    for xi in xs4[:2]:
        step4(xi)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for xi in xs4[2:]:
        step4(xi)
    b.record()
    torch.cuda.synchronize()
    b2b = a.elapsed_time(b) / 8
    it = iter(range(10 ** 6))
    devo = device_ms(lambda: step4(xs4[2 + next(it) % 8]), 8)
    print(f"config #4 step (128 ch x 1 s: meter + int32 mixdown): {b2b:.4f} "
          f"ms back to back, {devo} device-only median, "
          f"{1e3 / b2b:.2f} x real time ({card})", flush=True)

    # where the device time goes: kernels by name in a profile
    from torch.profiler import ProfilerActivity, profile

    def where_time_goes(label, fn, n: int) -> None:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                fn(i)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        by_name: dict[str, list] = {}
        for ev in events:
            if ev.get("cat") == "kernel":
                by_name.setdefault(ev["name"], []).append(ev["dur"])
        busy = sum(sum(d) for d in by_name.values()) / n
        launches = sum(len(d) for d in by_name.values()) / n
        print(f"profile {label}: {busy:.1f} us device busy per call in "
              f"{launches:.1f} launches, {wall:.4f} ms wall per call "
              f"(profiler on) ({card})", flush=True)
        top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
        for name, durs in top:
            print(f"  {sum(durs) / n:9.1f} us {100 * sum(durs) / n / busy:5.1f}%"
                  f" {len(durs) / n:6.1f}x  {name[:90]}", flush=True)
        return busy, launches

    where_time_goes("NonUniformConvolver.process, T = 24576 (mean of 8 "
                    "renders)", lambda i: conv.process(xs[2 + i]), 8)
    xl = randn(CI, 40 * BLOCK)
    where_time_goes("BinauralRenderer.process_block (mean of 40 blocks)",
                    lambda i: rend.process_block(
                        xl[:, i * BLOCK:(i + 1) * BLOCK]), 40)
    where_time_goes("config #4 step", lambda i: step4(xs4[i % 10]), 4)

    # ---- 10. EQ cascade and fractional delay (config #2) ------------------------
    from bbcat_dsp_torch import EQDelayPipeline
    from bbcat_dsp_torch.filters import resample
    from bbcat_dsp_torch.filters.fractional import ADDITIONAL_DELAY

    C2, B2, NBLK2, MAX_DELAY = 8, 4096, 16, 256.0   # scripts/bench_all.py #2
    eq2 = np.stack([biquad_coeffs(FilterType.PEQ, 100.0 * (i + 1), FS,
                                  gain=3.0 * (-1.0) ** i) for i in range(8)])
    T2 = NBLK2 * B2
    x2 = rng.standard_normal((C2, T2)).astype(np.float32)
    x2d = torch.from_numpy(x2).to(dev)
    steady = np.linspace(20.0, 200.0, C2).astype(np.float32)
    # a slow sinusoidal glide between 20 and 200 samples, 0.5 Hz, each
    # channel at its own phase
    glide = (110.0 + 90.0 * np.sin(2 * np.pi * 0.5 * np.arange(T2) / FS
                                   + np.arange(C2)[:, None])).astype(np.float32)
    torch.cuda.synchronize()
    ops_hook.reset_counts()

    def drive2(label, stages, delays, nblk, parallel: bool):
        """``nblk`` blocks through a fresh pipeline, held against float64."""
        pipe = EQDelayPipeline(stages, C2, B2, MAX_DELAY, FS, device=dev)
        if (pipe.psos is not None) != parallel:
            fail(f"{label}: parallel form {pipe.psos is not None}, expected "
                 f"{parallel}")
        dd = torch.from_numpy(delays).to(dev)
        ys = []
        for i in range(nblk):
            d = dd[:, i * B2:(i + 1) * B2] if dd.dim() > 1 else dd
            ys.append(pipe.process_block(x2d[:, i * B2:(i + 1) * B2], d))
        y = torch.cat(ys, -1).cpu().numpy()
        n = nblk * B2
        if y.shape != (C2, n) or not np.all(np.isfinite(y)):
            fail(f"{label}: output shape {y.shape} or non-finite values")
        if pipe.state.ring.writepos != n:
            fail(f"{label}: write position {pipe.state.ring.writepos} != {n}")
        ref = delayed64(cascade64(x2[:, :n], stages),
                        delays[..., :n] if delays.ndim > 1 else delays,
                        pipe.length, B2)
        hold_channels(f"{label} ({nblk} blocks of {B2}, ring {pipe.length})",
                      ref, y)
        return pipe

    pipe2 = drive2("config #2, one delay a channel (the stream read)", eq2,
                   steady, NBLK2, True)
    pipe2m = drive2("config #2, a delay a sample (the gather read)", eq2,
                    glide, NBLK2, True)
    twice = np.concatenate([eq2[:7], eq2[:1]])   # stage 0 twice: no parallel form
    pipe2f = drive2("config #2, the modal fallback (a stage repeated)", twice,
                    steady, 4, False)

    # resample of a 1 kHz sine against the closed form: output k reads
    # input position k / ratio + 14, and the table's effective group delay
    # is 8 samples (the contract of tests/test_filters.py, > 55 dB)
    tone = np.sin(2 * np.pi * 1000.0 * np.arange(int(FS)) / FS)
    toned = torch.from_numpy(np.broadcast_to(
        tone.astype(np.float32), (C2, tone.size)).copy()).to(dev)
    for ratio in (2.0, 44100.0 / 48000.0):
        y = resample(toned, ratio).cpu().numpy()
        n = y.shape[-1]
        if n != int(np.floor((tone.size - ADDITIONAL_DELAY) * ratio)):
            fail(f"resample x{ratio:.5f}: {n} samples out")
        # the positions as float32, as resample computes them
        at = (np.arange(n, dtype=np.float32) / np.float32(ratio)
              + np.float32(ADDITIONAL_DELAY)).astype(np.float64)
        want = np.sin(2 * np.pi * 1000.0 * (at - 8.0) / FS)
        s = min(snr_db(want[100:-100], row[100:-100]) for row in y)
        print(f"resample x{ratio:.5f} of a 1 kHz sine, {C2} x {tone.size} -> "
              f"{n}: worst channel {s:.2f} dB against the closed form",
              flush=True)
        if not s > 55.0:
            fail(f"resample x{ratio:.5f}: {s:.2f} dB <= 55")

    # the step's real-time factor over the 16 distinct blocks, three turns
    def turn2(pipe, delays) -> float:
        dd = torch.from_numpy(delays).to(dev)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(NBLK2):
            d = dd[:, i * B2:(i + 1) * B2] if dd.dim() > 1 else dd
            pipe.process_block(x2d[:, i * B2:(i + 1) * B2], d)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / NBLK2

    steady_d, glide_d = (torch.from_numpy(a).to(dev) for a in (steady, glide))
    for label, pipe, delays, dd in (
            ("one delay a channel", pipe2, steady, steady_d),
            ("a delay a sample", pipe2m, glide, glide_d[:, :B2]),
            ("the modal fallback", pipe2f, steady, steady_d)):
        turn2(pipe, delays)                                   # warm
        turns = sorted(turn2(pipe, delays) for _ in range(3))
        it = iter(range(10 ** 6))

        def one_block(pipe=pipe, dd=dd):
            i = next(it) % NBLK2
            pipe.process_block(x2d[:, i * B2:(i + 1) * B2], dd)

        devo = device_ms(one_block, 8)
        print(f"config #2 step, {label} ({C2} ch x {len(eq2)} stages, block "
              f"{B2}): {turns[1]:.4f} ms a block back to back (median of "
              f"three turns; {turns[0]:.4f} .. {turns[2]:.4f}), {devo} "
              f"device-only median, {1e3 * B2 / FS / turns[1]:.2f} x real "
              f"time ({card})", flush=True)
        where_time_goes(f"config #2 step, {label} (mean of 16 blocks)",
                        lambda i, f=one_block: f(), NBLK2)
    counts = ops_hook.counts()
    if any(counts["launches"].values()) or any(counts["plain"].values()):
        fail(f"config #2 ran a kernel of the port or a plain version: {counts}")
    print("config #2 runs no kernel of the port: the JAX path reaches no "
          "Pallas kernel either; launches and plain calls stayed zero",
          flush=True)

    # ---- 11. live EQ, named cascades, reverb, offline convolution -----------------
    from scipy.signal import lfilter

    from bbcat_dsp_torch import (
        BiQuadFilterBank,
        FilterManager,
        SchroederReverb,
        offline_convolve,
    )
    from bbcat_dsp_torch.filters import biquad_apply

    torch.cuda.synchronize()
    ops_hook.reset_counts()
    S11, NBLK11, RAMP_AT, RAMP_S = 8, 200, 100, 0.05
    T11 = NBLK11 * BLOCK

    def stage_design(i, gain=None):
        """Stage ``i``'s PEQ: 125 Hz x 2^i, +/- 4 dB alternating."""
        g = 4.0 * (-1.0) ** i if gain is None else gain
        return FilterType.PEQ, 125.0 * 2.0 ** i, g

    def new_bank():
        bank = BiQuadFilterBank(S11, C, fs=FS, device=dev)
        for i in range(S11):
            ftype, freq, g = stage_design(i)
            bank.set_filter(i, ftype, freq, gain=g)
        return bank

    # the retargets of stage 3: a ramp of 2400 samples (4.7 blocks) before
    # block 100, a second target set 1024 samples into it
    retargets = {RAMP_AT: (3, -8.0), RAMP_AT + 2: (3, 6.0)}

    def ramp64(x, c_from, c_to, mul, dec, w):
        """The float64 per-sample DF2T tick with the interpolation
        contract: sample ``n`` runs on ``c_to - mul (c_to - c_from)``, and
        ``mul`` steps down by ``dec`` (a float32 value, as the bank rounds
        it) after each sample, not below 0.  ``x [K, T]``, ``w [K, 2]``:
        ``(y, w', mul')``."""
        y = np.empty_like(x)
        w0, w1 = w[:, 0].copy(), w[:, 1].copy()
        diff = c_to - c_from
        for n in range(x.shape[-1]):
            b0, b1, b2, a1, a2 = c_to - mul * diff
            yn = b0 * x[:, n] + w0
            w0 = b1 * x[:, n] - a1 * yn + w1
            w1 = b2 * x[:, n] - a2 * yn
            y[:, n] = yn
            mul = max(mul - dec, 0.0)
        return y, np.stack([w0, w1], -1), mul

    def bank64(x):
        """The bank's stream in float64 on ``x [K, T]``: fixed stages
        through ``lfilter``, stage 3 sample by sample from its first
        retarget until its last ramp has landed."""
        y = np.asarray(x, np.float64)
        for i in range(S11):
            c = biquad_coeffs(*stage_design(i)[:2], FS, gain=stage_design(i)[2])
            if i != 3:
                y = lfilter64(y, c)
                continue
            t0 = RAMP_AT * BLOCK
            head, zf = lfilter(c[:3], np.r_[1.0, c[3:]], y[:, :t0], axis=-1,
                               zi=np.zeros((y.shape[0], 2)))
            parts, w, cur, mul, dec, tgt = [head], zf, c, 0.0, 0.0, c
            marks = sorted(retargets) + [NBLK11]
            for blk, nxt in zip(marks[:-1], marks[1:]):
                # a new target: the ramp starts from the coefficients in
                # effect now
                cur = tgt - mul * (tgt - cur)
                tgt = biquad_coeffs(*stage_design(3)[:2], FS,
                                    gain=retargets[blk][1])
                mul, dec = 1.0, float(np.float32(1.0 / (RAMP_S * FS)))
                n_ramp = min((nxt - blk) * BLOCK, int(RAMP_S * FS) + 2)
                a = blk * BLOCK
                seg, w, mul = ramp64(y[:, a:a + n_ramp], cur, tgt, mul, dec, w)
                parts.append(seg)
                if a + n_ramp < nxt * BLOCK:      # landed: fixed again
                    seg, w = lfilter(tgt[:3], np.r_[1.0, tgt[3:]],
                                     y[:, a + n_ramp:nxt * BLOCK], axis=-1,
                                     zi=w)
                    parts.append(seg)
            y = np.concatenate(parts, -1)
        return y

    x11 = rng.standard_normal((C, T11)).astype(np.float32)
    x11d = torch.from_numpy(x11).to(dev)
    bank = new_bank()
    ys, engines = [], []
    for k in range(NBLK11):
        if k in retargets:
            stage, g = retargets[k]
            bank.set_filter(stage, *stage_design(stage)[:2], gain=g,
                            interp_time=RAMP_S)
        ys.append(bank.process(x11d[:, k * BLOCK:(k + 1) * BLOCK]))
        engines.append("ramp" if bank._modal is None else "modal")
    y = torch.cat(ys, -1).cpu().numpy()
    if y.shape != x11.shape or not np.all(np.isfinite(y)):
        fail(f"bank: output shape {y.shape} or non-finite values")
    n_ramp_blocks = engines.count("ramp")
    want_ramp = 2 + -(-int(RAMP_S * FS) // BLOCK) - 1      # 6 at block 512
    # blocks 100 .. 106 run the ramp engine (the second ramp lands 3424
    # samples after the first began, inside block 106, which ends on the
    # modal engine); the first block too, and hands over at once
    if engines[0] != "modal" or n_ramp_blocks != want_ramp or \
            set(engines[RAMP_AT:RAMP_AT + want_ramp]) != {"ramp"}:
        fail(f"bank: ramp engine on blocks "
             f"{[k for k, e in enumerate(engines) if e == 'ramp']}")
    ref = bank64(x11[list(CHECKED)])
    for j, ch in enumerate(CHECKED):
        s = snr_db(ref[j], y[ch])
        win = slice(RAMP_AT * BLOCK, (RAMP_AT + 8) * BLOCK)
        s_win = snr_db(ref[j, win], y[ch, win])
        print(f"BiQuadFilterBank {C} ch x {S11} stages, {NBLK11} blocks, "
              f"channel {ch}: {s:.2f} dB against the float64 per-sample "
              f"DF2T, {s_win:.2f} dB over the ramps' 8 blocks", flush=True)
        if not min(s, s_win) >= 90.0:
            fail(f"bank channel {ch}: {min(s, s_win):.2f} dB < 90")
        if not click_free(y[ch, win]):
            fail(f"bank channel {ch}: a click in the ramp window")
    if float(bank.state.mul.abs().max()) != 0.0:
        fail(f"bank: mul {bank.state.mul.tolist()} after the ramps")

    def time_path(label, step, nblk: int, audio_ms: float, prof_blocks: int):
        """``step(i)`` over ``nblk`` blocks: ms a block back to back (the
        median of three turns and their spread), the host's time to
        enqueue a block, device-only, the real-time factor, and a profile
        (launches a block)."""
        for i in range(min(nblk, 4)):
            step(i)
        turns = []
        for _ in range(3):
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for i in range(nblk):
                step(i)
            b.record()
            torch.cuda.synchronize()
            turns.append(a.elapsed_time(b) / nblk)
        turns.sort()
        # the host's share: the time to enqueue a block, the card not
        # waited for
        t0 = time.perf_counter()
        for i in range(nblk):
            step(i)
        host_ms = (time.perf_counter() - t0) * 1e3 / nblk
        torch.cuda.synchronize()
        it = iter(range(10 ** 6))
        devo = device_ms(lambda: step(next(it) % nblk), 8)
        print(f"{label}: {turns[1]:.4f} ms a block back to back (median of "
              f"three turns; {turns[0]:.4f} .. {turns[2]:.4f}), {host_ms:.4f} "
              f"ms of host time to enqueue it, {devo} device-only median, "
              f"{audio_ms / turns[1]:.2f} x real time, deadline "
              f"{audio_ms:.4f} ms ({card})", flush=True)
        where_time_goes(f"{label} (mean of {prof_blocks} blocks)", step,
                        prof_blocks)

    def block11(i):
        return x11d[:, (i % NBLK11) * BLOCK:(i % NBLK11 + 1) * BLOCK]

    time_path(f"BiQuadFilterBank steady block ({C} ch x {S11} stages, modal)",
              lambda i: bank.process(block11(i)), 48, DEADLINE_MS, 16)
    params0, state0 = bank._modal[0][0], bank._modal[1][0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        iir.modal_apply(block11(0), params0, state0)
    host_us = (time.perf_counter() - t0) * 1e6 / 50
    torch.cuda.synchronize()
    print(f"modal_apply, one stage over {C} ch x {BLOCK}: {host_us:.1f} us of "
          f"host time a call ({card})", flush=True)
    # a ramp that outlasts the measurement: every block is a ramp block
    bank.set_filter(3, *stage_design(3)[:2], gain=-8.0, interp_time=60.0)
    time_path(f"BiQuadFilterBank ramp block ({C} ch x {S11} stages, float64 "
              "scan)", lambda i: bank.process(block11(i)), 48, DEADLINE_MS, 16)
    if bank._modal is not None:
        fail("bank: the timed ramp blocks left the ramp engine")

    # one stage's scan alone: float64 against float32, flat against the
    # JAX package's two levels
    traj = bank.state.targets[3].expand(1, BLOCK, 5).contiguous()
    w0 = torch.zeros(C, 2, device=dev)
    xb11 = block11(0)
    for label, dtype, chunk in (("float64 flat (assoc_dw)", torch.float64, None),
                                ("float32 flat (assoc)", torch.float32, None),
                                ("float64 two-level, chunks of 128",
                                 torch.float64, 128),
                                ("float32 two-level, chunks of 128",
                                 torch.float32, 128)):
        ms = median_ms(lambda: iir._apply_assoc(xb11, traj, w0, True, dtype,
                                                  chunk))
        print(f"one stage's companion scan, {C} ch x {BLOCK}, {label}: "
              f"{ms:.4f} ms device-only ({card})", flush=True)
    y64, _ = biquad_apply(xb11, traj, engine="assoc_dw")
    y32, _ = biquad_apply(xb11, traj.float(), engine="assoc")
    print(f"  float32 against float64 scan on that block: "
          f"{snr_db(y64.cpu().numpy(), y32.cpu().numpy()):.2f} dB", flush=True)

    # FilterManager: four named cascades of 2, 4, 6 and 8 stages over 56 of
    # the 64 channels (every eighth is left unassigned), 24 blocks
    fm = FilterManager(fs=FS, device=dev)
    cascades = {name: [(FilterType.PEQ, 150.0 * (i + 1) + 10.0 * n,
                        3.0 * (-1.0) ** (i + n)) for i in range(n)]
                for name, n in (("two", 2), ("four", 4), ("six", 6),
                                ("eight", 8))}
    for name, stages in cascades.items():
        fm.define(name, stages)
    names = list(cascades)
    assigned = {ch: names[(ch // 2) % 4] for ch in range(C) if ch % 8 != 7}
    for ch, name in assigned.items():
        fm.assign(ch, name)
    nb = 24
    y = torch.cat([fm.process(block11(k)) for k in range(nb)], -1).cpu().numpy()
    for ch in (0, 2, 4, 6, 61):
        ref = x11[ch, :nb * BLOCK].astype(np.float64)
        for ftype, freq, g in cascades[assigned[ch]]:
            ref = lfilter64(ref, biquad_coeffs(ftype, freq, FS, gain=g))
        s = snr_db(ref, y[ch])
        print(f"FilterManager channel {ch} ({assigned[ch]}): {s:.2f} dB "
              "against float64 lfilter", flush=True)
        if not s >= 90.0:
            fail(f"FilterManager channel {ch}: {s:.2f} dB < 90")
    for ch in (7, 63):
        if not np.array_equal(y[ch], x11[ch, :nb * BLOCK]):
            fail(f"FilterManager: unassigned channel {ch} was touched")
    time_path(f"FilterManager ({C} ch, cascades of 2/4/6/8 stages)",
              lambda i: fm.process(block11(i)), 24, DEADLINE_MS, 8)

    # SchroederReverb at 2 and at 64 channels, 100 blocks; 2 channels of
    # each against the float64 recurrences
    def lag64(x, d: int, b0: float, bd: float, ad: float):
        """``y[n] = b0 x[n] + bd x[n-d] - ad y[n-d]`` in float64, every
        sample from the samples ``d`` before it (``d`` at a time)."""
        xp, y = np.r_[np.zeros(d), x], np.zeros(x.size + d)
        for a in range(0, x.size, d):
            n = min(d, x.size - a)
            y[d + a:d + a + n] = (b0 * xp[d + a:d + a + n] + bd * xp[a:a + n]
                                  - ad * y[a:a + n])
        return y[d:]

    def reverb64(rev, x, chans):
        """Four combs ``y[n] = x[n] + g y[n-d]`` averaged, three all-passes
        ``y[n] = c x[n] + x[n-d] - c y[n-d]``, the dry and wet mix."""
        out = []
        for c in chans:
            xc = np.asarray(x[c], np.float64)
            wet = sum(lag64(xc, ds[c], 1.0, 0.0, -gs[c]) for ds, gs in
                      zip(rev.comb_delays, rev.comb_gains)) / 4.0
            for ds in rev.ap_delays:
                wet = lag64(wet, ds[c], 0.7, 1.0, 0.7)
            out.append((1.0 - rev.mix) * xc + rev.mix * wet)
        return np.stack(out)

    nb = 100
    for nch, chans in ((2, (0, 1)), (C, (0, C - 1))):
        rev = SchroederReverb(nch, fs=FS, device=dev)
        y = torch.cat([rev.process_block(block11(k)[:nch]) for k in range(nb)],
                      -1).cpu().numpy()
        if y.shape != (nch, nb * BLOCK) or not np.all(np.isfinite(y)):
            fail(f"reverb {nch} ch: output shape {y.shape} or non-finite")
        ref = reverb64(rev, x11[:, :nb * BLOCK], chans)
        for j, ch in enumerate(chans):
            s = snr_db(ref[j], y[ch])
            print(f"SchroederReverb {nch} ch, channel {ch}: {s:.2f} dB "
                  "against float64 recurrences", flush=True)
            if not s >= 90.0:
                fail(f"reverb {nch} ch channel {ch}: {s:.2f} dB < 90")
        time_path(f"SchroederReverb {nch} ch",
                  lambda i, rev=rev, nch=nch: rev.process_block(
                      block11(i)[:nch]), 24 if nch == 2 else 6, DEADLINE_MS,
                  4 if nch == 2 else 2)

    # offline_convolve: the headline IRs over 120 super-blocks (10.24 s)
    T_OFF = 120 * SB
    xo = rng.standard_normal((C, T_OFF)).astype(np.float32)
    xod = torch.from_numpy(xo).to(dev)
    yo = offline_convolve(xod, irs)
    torch.cuda.synchronize()
    if yo.shape != (C, T_OFF) or not bool(torch.isfinite(yo).all()):
        fail(f"offline_convolve: output shape {tuple(yo.shape)} or non-finite")
    yo_h = yo.cpu().numpy()
    for ch in CHECKED:
        s = snr_db(conv64(xo[ch], irs[ch]), yo_h[ch])
        print(f"offline_convolve channel {ch}: {s:.2f} dB against "
              "fftconvolve", flush=True)
        if not s >= 90.0:
            fail(f"offline_convolve channel {ch}: {s:.2f} dB < 90")
    turns = []
    for _ in range(3):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        offline_convolve(xod, irs)
        b.record()
        torch.cuda.synchronize()
        turns.append(a.elapsed_time(b))
    turns.sort()
    print(f"offline_convolve {C} ch x {N} taps x {T_OFF / FS:.2f} s: "
          f"{turns[1]:.4f} ms a call (median of three; {turns[0]:.4f} .. "
          f"{turns[2]:.4f}; the IRs' float64 transform included), "
          f"{1e3 * T_OFF / FS / turns[1]:.2f} x real time ({card})", flush=True)
    where_time_goes("offline_convolve", lambda i: offline_convolve(xod, irs), 1)

    counts = ops_hook.counts()
    if any(counts["launches"].values()) or any(counts["plain"].values()):
        fail(f"phase 11 ran a kernel of the port or a plain version: {counts}")
    print("phase 11 runs no kernel of the port: the JAX paths reach no Pallas "
          "kernel either; launches and plain calls stayed zero", flush=True)
    # and against the streamed two-level engine (its kernels; not a path
    # of this phase, so its launches are not counted)
    conv.reset()
    ys_stream = conv.process(xod).cpu().numpy()
    s = snr_db(ys_stream, yo_h)
    print(f"offline_convolve against NonUniformConvolver.process, all {C} "
          f"channels: {s:.2f} dB", flush=True)
    if not s >= 110.0:
        fail(f"offline_convolve against the streamed engine: {s:.2f} dB < 110")
    del xod, yo, yo_h, ys_stream                # phase 13 reads xo again

    # ---- 12. state files --------------------------------------------------------
    from bbcat_dsp_torch import load_state, save_state

    tmpdir = tempfile.TemporaryDirectory()
    ckpt = str(Path(tmpdir.name) / "state.pkl")

    def resumed(label, make, first, second, must, get=None, put=None,
                readout=None):
        """A stream in two halves ``first(engine)`` and ``second(engine)``
        (each a list of output tensors): once uninterrupted; once with the
        state written to a file after the first half and read into a fresh
        engine, which runs the second half through the path's kernels.  The
        joined output must meet the uninterrupted one at >= 110 dB, and
        ``readout(engine)`` (numbers) must agree to 1e-4."""
        get = get or (lambda e: e.state)
        put = put or (lambda e, s: setattr(e, "state", s))
        whole = make()
        y_ref = torch.cat(first(whole) + second(whole), -1)
        a = make()
        y1 = first(a)
        save_state(ckpt, get(a))
        size = Path(ckpt).stat().st_size
        del a
        b = make()
        put(b, load_state(ckpt, like=get(b)))
        torch.cuda.synchronize()
        ops_hook.reset_counts()
        y2 = second(b)
        torch.cuda.synchronize()
        check_path(f"resumed {label}", ops_hook.counts(), must)
        y = torch.cat(y1 + y2, -1)
        s = snr_db(y_ref.cpu().numpy(), y.cpu().numpy())
        line = (f"resumed {label}: {s:.2f} dB against the uninterrupted "
                f"stream, file {size / 1e6:.2f} MB")
        if y.shape != y_ref.shape or not s >= 110.0:
            fail(f"resumed {label}: {s:.2f} dB < 110")
        if readout is not None:
            want, got = np.asarray(readout(whole)), np.asarray(readout(b))
            line += f", readouts {got.tolist()} against {want.tolist()}"
            if not np.allclose(got, want, atol=1e-4):
                fail(f"resumed {label}: readouts {got} != {want}")
        print(line, flush=True)

    x12 = randn(C, 16 * SB)

    def sb12(j):
        return x12[:, j * SB:(j + 1) * SB]

    # the headline two-level engine: 5 super-blocks (the tail's cursor off
    # 0), then one super-block of small blocks, two whole ones and a render
    def nu_second(e):
        ys = [e.process_small_block(sb12(5)[:, i * BLOCK:(i + 1) * BLOCK])
              for i in range(RATIO)]
        ys += [e.process_block(sb12(j)) for j in (6, 7)]
        return ys + [e.process(x12[:, 8 * SB:14 * SB])]

    def put_two_level(e, s):
        if s.tail.step != 5:
            fail(f"two-level state read with tail step {s.tail.step}")
        e.state = s

    resumed("NonUniformConvolver (64 ch x 32768 taps)",
            lambda: NonUniformConvolver(irs, block=BLOCK, ratio=RATIO,
                                        device=dev),
            lambda e: [e.process_block(sb12(j)) for j in range(5)],
            nu_second, STREAM_KERNELS | SUPER_STEP_KERNELS,
            put=put_two_level)

    def blk12(k):
        return x12[:, k * BLOCK:(k + 1) * BLOCK]

    resumed("BlockConvolver (64 ch x 32768 taps)",
            lambda: BlockConvolver(g1, block=BLOCK, device=dev),
            lambda e: [e.process_block(blk12(k)) for k in range(37)],
            lambda e: [e.process_block(blk12(k)) for k in range(37, 48)]
            + [e.process(x12[:, 48 * BLOCK:96 * BLOCK])], BLOCK_KERNELS)

    # the renderer with its meter, stopped after 75 blocks = 8 x 100 ms,
    # where the meter's buffer of output not yet metered is empty
    xr = randn(CI, 150 * BLOCK) * 0.05

    def rend_first(e):
        ys = [e.process_block(xr[:, k * BLOCK:(k + 1) * BLOCK])
              for k in range(75)]
        if e._meter_buf.shape[-1]:
            fail("binaural: the meter's buffer is not empty at the stop")
        return ys

    def rend_put(e, s):
        e.state, e.meter.state = s["renderer"], s["meter"]

    resumed("BinauralRenderer (64 x 2, 1024 taps, EQ) with its meter",
            lambda: BinauralRenderer(h1, block=BLOCK, eq_stages=[eq], fs=FS,
                                     device=dev),
            rend_first,
            lambda e: [e.process_block(xr[:, k * BLOCK:(k + 1) * BLOCK])
                       for k in range(75, 150)], MATRIX_KERNELS,
            get=lambda e: {"renderer": e.state, "meter": e.meter.state},
            put=rend_put,
            readout=lambda e: [e.loudness()[k] for k in
                               ("momentary_lkfs", "integrated_lkfs")])

    xm12 = [randn(C4, T4) * 0.1 for _ in range(6)]

    def meter_run(lo, hi):
        def go(m):
            for xi in xm12[lo:hi]:
                m.process(xi)
            return [torch.tensor([[m.momentary(), m.short_term(),
                                   m.integrated()]])]
        return go

    resumed("LoudnessMeter (128 ch, 6 s)",
            lambda: LoudnessMeter(C4, FS, device=dev), meter_run(0, 3),
            meter_run(3, 6), set(),
            readout=lambda m: [m.momentary(), m.short_term(), m.integrated()])

    resumed("EQDelayPipeline (config #2)",
            lambda: EQDelayPipeline(eq2, C2, B2, MAX_DELAY, FS, device=dev),
            lambda e: [e.process_block(x2d[:, i * B2:(i + 1) * B2], steady_d)
                       for i in range(8)],
            lambda e: [e.process_block(x2d[:, i * B2:(i + 1) * B2], steady_d)
                       for i in range(8, NBLK2)], set())

    # the bank, stopped 1024 samples into a ramp of 2400 and continued
    # through restore(), which derives the rest of the ramp from mul and dec
    def bank_run(lo, hi):
        def go(b):
            ys = []
            for k in range(lo, hi):
                if k == 6:
                    b.set_filter(3, *stage_design(3)[:2], gain=-8.0,
                                 interp_time=RAMP_S)
                ys.append(b.process(block11(k)))
            return ys
        return go

    resumed(f"BiQuadFilterBank ({C} ch x {S11} stages) in the middle of a "
            "ramp", new_bank, bank_run(0, 8), bank_run(8, 16), set(),
            get=lambda b: b.snapshot(), put=lambda b, s: b.restore(s),
            readout=lambda b: [float(b.state.mul.abs().max()),
                               float(b._modal is not None),
                               float(b.state.targets[3, 0])])

    # a file the JAX package wrote (tests/test_torch_checkpoint.py writes it
    # with that package's save_state): its tree definition and named tuples
    # are never imported here; the streams continue from its leaves and meet
    # the JAX package's own output for the same blocks
    data = Path(__file__).resolve().parent / "tests" / "data"
    io = np.load(data / "jax_state_v4_io.npz")
    fx_conv = NonUniformConvolver(io["ir"], block=int(io["block"]),
                                  ratio=int(io["ratio"]), device=dev)
    fx_bank = BiQuadFilterBank(2, 2, fs=FS, device=dev)
    fx = load_state(str(data / "jax_state_v4.pkl"),
                    like={"bank": fx_bank.state, "conv": fx_conv.state})
    foreign = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
               or (m.startswith("bbcat_dsp_")
                   and not m.startswith("bbcat_dsp_torch"))]
    if foreign:
        fail(f"reading the JAX-written file imported {foreign}")
    fx_conv.state = fx["conv"]
    fx_bank.restore(fx["bank"])
    torch.cuda.synchronize()
    ops_hook.reset_counts()
    y = torch.stack([fx_conv.process_block(torch.from_numpy(xb).to(dev))
                     for xb in io["conv_x"]])
    torch.cuda.synchronize()
    check_path("resumed from the JAX-written file", ops_hook.counts(),
               {"fused_head", "rfft_half", "xt_step_mac", "irfft_tail"})
    s_conv = snr_db(io["conv_y"], y.cpu().numpy())
    y = torch.stack([fx_bank.process(torch.from_numpy(xb).to(dev))
                     for xb in io["bank_x"]])
    s_bank = snr_db(io["bank_y"], y.cpu().numpy())
    print(f"the JAX-written file (format 4, {len(io['conv_x'])} super-blocks "
          f"and {len(io['bank_x'])} bank blocks after it), read without JAX: "
          f"two-level convolver {s_conv:.2f} dB, bank {s_bank:.2f} dB against "
          "the JAX package's own continuation", flush=True)
    if not min(s_conv, s_bank) >= 110.0:
        fail(f"JAX-written file: {min(s_conv, s_bank):.2f} dB < 110")
    tmpdir.cleanup()

    # ---- 13. the command line and the host edge ---------------------------------
    from io import StringIO
    import importlib.util
    from contextlib import redirect_stdout

    from numpy.lib.stride_tricks import sliding_window_view
    from scipy.io import netcdf_file
    from scipy.signal import convolve2d as sp_convolve2d

    from bbcat_dsp_torch.analysis import Histogram, RunningAverage
    from bbcat_dsp_torch.buffers import (MultilayerBuffer, SoundDelayBuffer,
                                         SoundRingBuffer)
    from bbcat_dsp_torch.formats.host import pack
    from bbcat_dsp_torch.loudness.truepeak import _design as tp_design
    from bbcat_dsp_torch.ops import convolve2d, interpolator, mix_samples_ramped
    from bbcat_dsp_torch.sofa import SOFAFile
    from bbcat_dsp_torch.tools import convolve_cli, loudness_cli, read_wav, write_wav
    from bbcat_dsp_torch.utils import native

    work = tempfile.TemporaryDirectory()
    wdir = Path(work.name)
    INT24_STEP = 2.0 ** -23

    def counts_zero(label: str) -> None:
        counts = ops_hook.counts()
        if any(counts["launches"].values()) or any(counts["plain"].values()):
            fail(f"{label} ran a kernel of the port or a plain version: "
                 f"{counts}")

    def normalised64(y):
        """The CLI's normalisation of its output, applied in float64."""
        peak = np.abs(y).max()
        return y / peak * 0.999 if peak > 1.0 else y

    # the 64-channel input: phase 11's 10.24 s of distinct noise at 0.05
    # rms, float32 (a lossless file); the headline IRs as float32
    T13 = xo.shape[-1]
    p_in, p_ir = str(wdir / "in64.wav"), str(wdir / "ir64.wav")
    t0 = time.perf_counter()
    write_wav(p_in, 0.05 * xo, FS, SampleFormat.FLOAT)
    write_secs = time.perf_counter() - t0
    st = native.status()
    if not st["available"]:
        print(f"native format engine NOT available ({st['error']}): numpy "
              "index gathers serve the host edge", flush=True)
    else:
        built = ("reused from an earlier build" if st["build_seconds"] is None
                 else f"built in {st['build_seconds']:.2f} s")
        print(f"native format engine: {built}, used by every transfer below "
              f"({st['path']})", flush=True)
    write_wav(p_ir, irs, FS, SampleFormat.FLOAT)
    x13, fs13 = read_wav(p_in)
    ir13, _ = read_wav(p_ir)
    if fs13 != FS or x13.shape != (C, T13) or \
            not np.array_equal(x13, (0.05 * xo).astype(np.float32)):
        fail("write_wav / read_wav: the FLOAT file did not read back exactly")
    print(f"write_wav {C} ch x {T13 / FS:.2f} s FLOAT: {write_secs:.3f} s "
          "(the engine's build included where it ran)", flush=True)

    # a. the convolve CLI, IR branch, in this process
    p_out = str(wdir / "out64.wav")
    torch.cuda.synchronize()
    ops_hook.reset_counts()
    t13 = {}
    t0 = time.perf_counter()
    cli_out = StringIO()
    with redirect_stdout(cli_out):
        rc = convolve_cli.main([p_in, p_ir, p_out], timings=t13)
    total = time.perf_counter() - t0
    print("convolve_cli printed: " + " | ".join(
        cli_out.getvalue().strip().splitlines()), flush=True)
    if rc != 0:
        fail(f"convolve_cli returned {rc}")
    check_path("convolve_cli, IR branch", ops_hook.counts(), RENDER_KERNELS)
    print(f"convolve_cli {C} ch x {N} taps x {T13 / FS:.2f} s: read "
          f"{t13['read']:.3f} s, render {t13['render']:.3f} s, write "
          f"{t13['write']:.3f} s; {total:.3f} s in all, "
          f"{T13 / FS / total:.2f} x real time ({card})", flush=True)
    y13, _ = read_wav(p_out)
    ref13 = np.stack([fftconvolve(x13[c].astype(np.float64),
                                  ir13[c].astype(np.float64))[:T13]
                      for c in range(C)])
    ref13 = normalised64(ref13)
    snrs = [snr_db(ref13[c], y13[c]) for c in range(C)]
    print(f"convolve_cli, IR branch, INT24 output: worst channel "
          f"{min(snrs):.2f} dB, best {max(snrs):.2f} dB against float64 "
          "fftconvolve (normalised as the CLI does)", flush=True)
    if not min(snrs) >= 90.0:
        fail(f"convolve_cli: channel {int(np.argmin(snrs))} at "
             f"{min(snrs):.2f} dB < 90")
    del ref13

    # where the read's and the write's seconds go: the file, the engine's
    # transfer, the transpose to [C, T] (and back); then the same two
    # transfers on numpy's path, as where no compiler built the engine
    from bbcat_dsp_torch.formats.host import transfer_samples

    def edge_parts(label):
        t0 = time.perf_counter()
        raw = np.frombuffer(Path(p_in).read_bytes()[44:], np.uint8)
        t1 = time.perf_counter()
        flt = np.zeros(raw.size, np.uint8)
        transfer_samples(raw, SampleFormat.FLOAT, False, 0, C, flt,
                         SampleFormat.FLOAT, False, 0, C, C, T13)
        t2 = time.perf_counter()
        planar = flt.view(np.float32).reshape(T13, C).T.copy()
        t3 = time.perf_counter()
        inter = np.ascontiguousarray(planar.T).reshape(-1)
        t4 = time.perf_counter()
        out24 = np.zeros(T13 * C * 3, np.uint8)
        transfer_samples(inter.view(np.uint8), SampleFormat.FLOAT, False, 0,
                         C, out24, SampleFormat.INT24, False, 0, C, C, T13)
        t5 = time.perf_counter()
        print(f"host edge, {label}: file read {t1 - t0:.3f} s, FLOAT -> "
              f"FLOAT transfer {t2 - t1:.3f} s, transpose to [C, T] "
              f"{t3 - t2:.3f} s; transpose back {t4 - t3:.3f} s, FLOAT -> "
              f"INT24 transfer {t5 - t4:.3f} s ({card})", flush=True)
        return flt, out24

    flt_n, out_n = edge_parts("native engine")
    real_rect = native.transfer_rect
    native.transfer_rect = lambda *a, **k: False
    try:
        flt_p, out_p = edge_parts("numpy's index gathers")
    finally:
        native.transfer_rect = real_rect
    if not (np.array_equal(flt_n, flt_p) and np.array_equal(out_n, out_p)):
        fail("the host edge: numpy's bytes differ from the native engine's")
    del flt_n, out_n, flt_p, out_p

    # the same command as a user runs it: a process of its own, no device
    # argument
    p_out2 = str(wdir / "out64_cmd.wav")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        "bbcat_dsp_torch.tools.convolve_cli", p_in, p_ir,
                        p_out2], cwd=str(Path(__file__).resolve().parent),
                       capture_output=True, text=True, timeout=600)
    cmd_secs = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"python -m bbcat_dsp_torch.tools.convolve_cli exited "
             f"{r.returncode}: {r.stderr[-2000:]}")
    a_bytes, b_bytes = Path(p_out).read_bytes(), Path(p_out2).read_bytes()
    if a_bytes == b_bytes:
        same = "the same bytes"
    else:
        steps = np.abs(read_wav(p_out2)[0].astype(np.float64) - y13).max() \
            / INT24_STEP
        if len(a_bytes) != len(b_bytes) or steps > 1.0:
            fail(f"the command's output differs from the in-process one "
                 f"by {steps:.1f} INT24 steps")
        same = f"at most {steps:.0f} INT24 step apart (not the same bytes)"
    print(f"python -m bbcat_dsp_torch.tools.convolve_cli: exit 0 in "
          f"{cmd_secs:.3f} s (start-up included); its output and the "
          f"in-process one are {same}", flush=True)

    # b. the SOFA branch: a SimpleFreeFieldHRIR file of 72 directions x 2
    # ears x 1024 taps as classic netCDF-3, which reads without h5py
    n_dir = 72
    hr = rng.standard_normal((n_dir, 2, N_HRTF)) * np.exp(
        -np.arange(N_HRTF) / 200.0)
    hr /= np.sqrt(np.sum(hr ** 2, axis=-1, keepdims=True))
    pos = np.stack([np.arange(n_dir) * 360.0 / n_dir, np.zeros(n_dir),
                    np.full(n_dir, 1.2)], -1)
    p_sofa = str(wdir / "hrtf72.sofa")
    with netcdf_file(p_sofa, "w") as f:
        for dim, n in (("M", n_dir), ("R", 2), ("N", N_HRTF), ("I", 1),
                       ("C", 3)):
            f.createDimension(dim, n)
        f.createVariable("Data.IR", "d", ("M", "R", "N"))[:] = hr
        f.createVariable("Data.SamplingRate", "d", ("I",))[:] = [FS]
        f.createVariable("SourcePosition", "d", ("M", "C"))[:] = pos
        f.SOFAConventions = "SimpleFreeFieldHRIR"
    p_bin = str(wdir / "bin.wav")
    torch.cuda.synchronize()
    ops_hook.reset_counts()
    tb13 = {}
    t0 = time.perf_counter()
    cli_out = StringIO()
    with redirect_stdout(cli_out):
        rc = convolve_cli.main([p_in, p_sofa, p_bin], timings=tb13)
    total = time.perf_counter() - t0
    if rc != 0:
        fail(f"convolve_cli (SOFA) returned {rc}")
    check_path("convolve_cli, SOFA branch", ops_hook.counts(), MATRIX_KERNELS)
    print(f"convolve_cli SOFA {C} -> 2 ch x {T13 / FS:.2f} s: read "
          f"{tb13['read']:.3f} s, render {tb13['render']:.3f} s, write "
          f"{tb13['write']:.3f} s; {total:.3f} s in all, "
          f"{T13 / FS / total:.2f} x real time ({card})", flush=True)
    # the directions the CLI picks: nearest by great-circle distance, here
    # on the equator
    az_in = 360.0 * np.arange(C) / C
    gap = np.abs((az_in[:, None] - pos[None, :, 0] + 180.0) % 360.0 - 180.0)
    picks = np.argmin(gap, axis=1)
    sofa = SOFAFile.open(p_sofa)
    if [sofa.nearest(a, 0.0) for a in az_in] != picks.tolist():
        fail("SOFAFile.nearest does not pick the nearest directions")
    yb, _ = read_wav(p_bin)
    refb = np.stack([fftconvolve(x13.astype(np.float64), hr[picks, ear],
                                 axes=-1)[:, :T13].sum(0) for ear in (0, 1)])
    refb = normalised64(refb)
    for ear in (0, 1):
        s = snr_db(refb[ear], yb[ear])
        print(f"convolve_cli, SOFA branch, ear {ear}: {s:.2f} dB against the "
              "float64 sum of fftconvolve over the picked directions",
              flush=True)
        if not s >= 90.0:
            fail(f"convolve_cli SOFA ear {ear}: {s:.2f} dB < 90")
    del refb
    p_h5 = wdir / "h5.sofa"
    p_h5.write_bytes(b"\x89HDF\r\n\x1a\n" + bytes(64))
    if importlib.util.find_spec("h5py") is None:
        try:
            SOFAFile.open(str(p_h5))
        except ImportError as e:
            if "h5py" not in str(e):
                fail(f"an HDF5 SOFA file raised an ImportError without "
                     f"naming h5py: {e}")
            print(f"an HDF5 SOFA file without h5py: ImportError: {e}",
                  flush=True)
        else:
            fail("an HDF5 SOFA file opened without h5py")
    else:
        print("h5py is importable: the HDF5 branch is not "
              "refused here", flush=True)

    # c. the loudness CLI on the 64-channel file and on a 2-channel one
    def tp64(x):
        """Float64 true peak (dBTP) of ``x [C, T]``: the 48-tap 4x
        interpolator of ``loudness/truepeak.py`` over the positions whose
        taps lie inside the signal, and the sample peak."""
        taps = tp_design()
        peak = 0.0
        for row in np.asarray(x, np.float64):
            ups = sliding_window_view(row, taps.shape[1]) @ taps.T
            peak = max(peak, np.abs(ups).max(), np.abs(row).max())
        return 20.0 * np.log10(peak)

    t = np.arange(T13) / FS
    x2 = np.stack([0.1 * xo[0], 0.5 * np.sin(2 * np.pi * 997.0 * t + 0.3)]
                  ).astype(np.float32)
    p_st = str(wdir / "stereo.wav")
    write_wav(p_st, x2, FS, SampleFormat.FLOAT)
    torch.cuda.synchronize()
    ops_hook.reset_counts()
    cli_out = StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(cli_out):
        rc = loudness_cli.main([p_in, p_st])
    lsecs = time.perf_counter() - t0
    counts_zero("loudness_cli")
    lines = cli_out.getvalue().strip().splitlines()
    if rc != 0 or len(lines) != 2:
        fail(f"loudness_cli returned {rc} with {lines}")
    for line, xx in zip(lines, (x13, x2)):
        m = re.search(r"integrated ([-+]\S+) LKFS, true peak ([-+]\S+) dBTP",
                      line)
        if m is None:
            fail(f"loudness_cli printed {line!r}")
        L_cli, tp_cli = float(m.group(1)), float(m.group(2))
        # BS.1770-4's weights: L R C Ls Rs for up to 5 channels, 1 beyond
        w = [1.0, 1.0, 1.0, 1.41, 1.41][:len(xx)] if len(xx) <= 5 else \
            np.ones(len(xx))
        L64 = gated_lkfs(block_powers64(kweight64(xx), w))
        tp_ref = tp64(xx)
        print(f"{line}\n  float64: {L64:+.4f} LKFS, {tp_ref:+.4f} dBTP "
              f"(differences {L_cli - L64:+.4f} LU, {tp_cli - tp_ref:+.4f} "
              "dB)", flush=True)
        if not (abs(L_cli - L64) <= 0.1 and abs(tp_cli - tp_ref) <= 0.1):
            fail(f"loudness_cli: {L_cli} / {tp_cli} against float64 "
                 f"{L64:.4f} / {tp_ref:.4f}")
    print(f"loudness_cli, both files: {lsecs:.3f} s ({card})", flush=True)

    # d. the small ops at a deployment's size.  A MultilayerBuffer mixes two
    # 64-channel BlockConvolvers: one at block 128 with 4096-tap IRs, a
    # block a call; one at block 512 with the headline IRs, rendering four
    # blocks a call; 2.048 s, read 512 frames at a time
    T_ML, CH_B = 192 * BLOCK, 4 * BLOCK
    irs_a = (rng.standard_normal((C, 4096)) * np.exp(-np.arange(4096) / 500.0)
             ).astype(np.float32)
    xml = x13[:, :T_ML]
    xmld = torch.from_numpy(xml).to(dev)
    conv_a = BlockConvolver(irs_a, block=128, device=dev)
    conv_b = BlockConvolver(ir13, block=BLOCK, device=dev)
    ml = MultilayerBuffer(2, C, 1024, device=dev)
    torch.cuda.synchronize()
    ops_hook.reset_counts()
    outs = []
    t0 = time.perf_counter()
    for j in range(T_ML // CH_B):
        for k in range(j * CH_B // 128, (j + 1) * CH_B // 128):
            ml.write_layer(0, conv_a.process_block(xmld[:, k * 128:(k + 1) * 128]))
        ml.write_layer(1, conv_b.process(xmld[:, j * CH_B:(j + 1) * CH_B]))
        while ml.readable() >= BLOCK:
            outs.append(ml.read(BLOCK))
    torch.cuda.synchronize()
    ml_secs = time.perf_counter() - t0
    check_path("MultilayerBuffer of two BlockConvolvers", ops_hook.counts(),
               BLOCK_KERNELS)
    ymix = torch.cat(outs, -1).cpu().numpy()
    if ymix.shape != (C, T_ML) or ml.capacity < CH_B:
        fail(f"multilayer: output {ymix.shape}, capacity {ml.capacity}")
    refm = np.stack([fftconvolve(xml[c].astype(np.float64), irs_a[c])[:T_ML]
                     + fftconvolve(xml[c].astype(np.float64), ir13[c])[:T_ML]
                     for c in range(C)])
    worst = min(snr_db(refm[c], ymix[c]) for c in range(C))
    print(f"MultilayerBuffer mixing BlockConvolvers at blocks 128 (4096 taps) "
          f"and 512 ({N} taps, 4 blocks a call), {C} ch x {T_ML / FS:.3f} s: "
          f"worst channel {worst:.2f} dB against float64, the ring grown "
          f"1024 -> {ml.capacity}; {ml_secs:.3f} s "
          f"({T_ML / FS / ml_secs:.2f} x real time, {card})", flush=True)
    if not worst >= 90.0:
        fail(f"multilayer mix: {worst:.2f} dB < 90")
    del refm, xmld

    torch.cuda.synchronize()
    ops_hook.reset_counts()
    # delay and FIFO buffers, 64 channels: packed INT24 values on the grid
    # survive exactly; a delayed read is the input moved, exactly
    grid = rng.integers(-2**23, 2**23, (4800, C)).astype(np.int32) << 8
    raw = pack(grid.reshape(-1), SampleFormat.INT24)
    dbuf = SoundDelayBuffer(C, 8192, device=dev)
    dbuf.write_packed(raw, SampleFormat.INT24, False, 0, C, 4800)
    back = dbuf.read_packed(SampleFormat.INT24, False, 4800, 4800)
    vals = dbuf.read(4800, 4800).cpu().numpy()
    if not np.array_equal(back, raw) or not np.array_equal(
            vals.T, grid.astype(np.float64) * 2.0 ** -31):
        fail("SoundDelayBuffer: the packed INT24 round trip is not exact")
    dbuf = SoundDelayBuffer(C, 8192, device=dev)
    xd13 = torch.from_numpy(x13[:, :48 * BLOCK]).to(dev)
    xpad = np.concatenate([np.zeros((C, 8192), np.float32),
                           x13[:, :48 * BLOCK]], -1)
    for k in range(48):
        dbuf.write(xd13[:, k * BLOCK:(k + 1) * BLOCK])
        for shift in (0, 1, 1000, 7679):
            got = dbuf.read(BLOCK + shift, BLOCK).cpu().numpy()
            a = 8192 + k * BLOCK - shift
            if not np.array_equal(got, xpad[:, a:a + BLOCK]):
                fail(f"SoundDelayBuffer: block {k}, delay {BLOCK + shift} is "
                     "not the input moved")
    fifo = SoundRingBuffer(C, 4096, device=dev)
    got, k = [], 0
    while (k + 1) * 480 <= 48 * BLOCK:
        n = fifo.write(xd13[:, k * 480:(k + 1) * 480])
        if n != 480:
            fail(f"SoundRingBuffer: wrote {n} of 480 frames")
        k += 1
        while fifo.read_frames_available() >= BLOCK:
            got.append(fifo.read(BLOCK))
    got = torch.cat(got, -1).cpu().numpy()
    if not np.array_equal(got, x13[:, :got.shape[-1]]):
        fail("SoundRingBuffer: the frames read are not the frames written")
    print(f"SoundDelayBuffer {C} ch: INT24 packed round trip of 4800 frames "
          f"exact; 48 blocks read at delays 512, 513, 1512 and 8191 equal the "
          f"input moved; SoundRingBuffer: {got.shape[-1]} frames through a "
          "FIFO of 4096 (writes of 480, reads of 512) exact", flush=True)

    # a gain ramp over 50 ms on 64 channels x 100 ms, against a float64
    # frame loop
    T_MIX = 4800
    src = xd13[:, :T_MIX]
    dst0 = torch.from_numpy(x13[:, T_MIX:2 * T_MIX]).to(dev)
    inc = float(np.float32(1.0 / 2400))
    ymr, it = mix_samples_ramped(dst0, src, interpolator(0.0, 1.0, device=dev),
                                 inc)
    g, ref = 0.0, np.asarray(x13[:, T_MIX:2 * T_MIX], np.float64).copy()
    for n in range(T_MIX):
        ref[:, n] += g * x13[:, n]
        g = min(g + inc, 1.0)
    s = snr_db(ref, ymr.cpu().numpy())
    print(f"mix_samples_ramped {C} ch x {T_MIX}, 0 -> 1 over 2400 frames: "
          f"{s:.2f} dB against a float64 frame loop, gain {float(it.current)}",
          flush=True)
    if not s >= 90.0 or float(it.current) != 1.0:
        fail(f"mix_samples_ramped: {s:.2f} dB")

    # convolve2d with TF32 allowed by either switch, against scipy; the
    # control, the same call with the precision helper bypassed, must fall
    # far below
    import bbcat_dsp_torch.ops.conv2d as conv2d_mod

    img = rng.standard_normal((4, 256, 256)).astype(np.float32)
    ker = rng.standard_normal((15, 15)).astype(np.float32)
    ref2 = np.stack([sp_convolve2d(im.astype(np.float64), ker, mode="same")
                     for im in img])
    img_d, ker_d = torch.from_numpy(img).to(dev), torch.from_numpy(ker).to(dev)
    cudnn = torch.backends.cudnn

    def hold_conv_tf32(label, allow, restore):
        allow()
        try:
            y2 = convolve2d(img_d, ker_d).cpu().numpy()
            real_f32, conv2d_mod.full_f32 = (conv2d_mod.full_f32,
                                             contextlib.nullcontext)
            try:
                yb2 = convolve2d(img_d, ker_d).cpu().numpy()
            finally:
                conv2d_mod.full_f32 = real_f32
        finally:
            restore()
        s, sb = snr_db(ref2, y2), snr_db(ref2, yb2)
        print(f"convolve2d 4 x 256 x 256 (*) 15 x 15 with {label}: {s:.2f} dB "
              f"against scipy; the control without the precision helper "
              f"{sb:.2f} dB", flush=True)
        if not s >= 90.0:
            fail(f"convolve2d with {label}: {s:.2f} dB < 90")
        if not sb < 80.0:
            fail(f"convolve2d control with {label}: {sb:.2f} dB, not far "
                 "below 90: the switch did not enable TF32")

    prev_conv = cudnn.conv.fp32_precision
    hold_conv_tf32('cudnn.conv.fp32_precision = "tf32"',
                   lambda: setattr(cudnn.conv, "fp32_precision", "tf32"),
                   lambda: setattr(cudnn.conv, "fp32_precision", prev_conv))
    hold_conv_tf32("cudnn.allow_tf32 = True",
                   lambda: setattr(cudnn, "allow_tf32", True),
                   lambda: setattr(cudnn.conv, "fp32_precision", prev_conv))

    # a running RMS meter (100 ms and 10 ms windows of the power) and a
    # histogram of its levels, 64 channels x 2.048 s in blocks of 512
    ra = RunningAverage(4800, (C,), alt_window=480, device=dev)
    pw = xd13 ** 2
    means, alts = [], []
    for k in range(48):
        means.append(ra.write(pw[:, k * BLOCK:(k + 1) * BLOCK]))
        alts.append(ra._last_alt)
    means = torch.cat(means, -1).cpu().numpy()
    alts = torch.cat(alts, -1).cpu().numpy()
    p64 = np.asarray(x13[:, :48 * BLOCK], np.float64) ** 2
    cs = np.concatenate([np.zeros((C, 1)), np.cumsum(p64, -1)], -1)
    i = np.arange(p64.shape[-1])
    s_ra = []
    for w, got in ((4800, means), (480, alts)):
        lo = np.maximum(i + 1 - w, 0)
        s_ra.append(snr_db((cs[:, i + 1] - cs[:, lo]) / (i + 1 - lo), got))
    levels = 10.0 * np.log10(np.maximum(means, 1e-12)).astype(np.float32)
    hist = Histogram(800, -80.0, 0.0, device=dev)
    hist.write(torch.from_numpy(levels).to(dev))
    lv = levels.reshape(-1)
    f32 = np.float32
    idx = np.clip(((lv - f32(-80.0)) * f32(800) / (f32(0.0) - f32(-80.0)))
                  .astype(np.int32), 0, 799)
    want_counts = np.bincount(idx, minlength=800)
    want_sums = np.bincount(idx, weights=lv.astype(np.float64), minlength=800)
    # a bin's sum is float32, as in the JAX package: a float32 sum of n
    # terms in any order is off by at most g = (n - 1) u / (1 - (n - 1) u),
    # u = 2^-24, of the sum of their magnitudes (all levels here are
    # negative), and ~260,000 levels near -26 dB share a bin of 0.1 dB
    nu = np.maximum(want_counts - 1, 0) * 2.0 ** -24
    err_bound = nu / (1.0 - nu) * np.abs(want_sums)
    sum_err = np.abs(hist.sums().astype(np.float64) - want_sums)
    p50 = hist.percentile_index(0.5)
    want_p50 = int(np.searchsorted(np.cumsum(want_counts), 0.5 * lv.size))
    counts_ok = np.array_equal(hist.counts(), want_counts)
    print(f"RunningAverage {C} ch, windows 4800 and 480, 48 blocks: "
          f"{s_ra[0]:.2f} / {s_ra[1]:.2f} dB against float64; Histogram of "
          f"{lv.size} levels in 800 bins (at most {want_counts.max()} in one): "
          f"counts {'equal' if counts_ok else 'DIFFER'} to numpy's, median "
          f"bin {p50} (numpy {want_p50}), each bin's float32 sum within "
          f"{(sum_err / np.maximum(err_bound, 1e-300)).max():.3f} of its "
          f"bound, mean {hist.mean_data():.4f} dB (float64 "
          f"{lv.astype(np.float64).mean():.4f})", flush=True)
    if not (min(s_ra) >= 90.0 and counts_ok and p50 == want_p50
            and np.all(sum_err <= err_bound)):
        fail("RunningAverage / Histogram against numpy float64")
    torch.cuda.synchronize()
    counts_zero("the small ops")
    print("the small ops (delay and FIFO buffers, mixing, convolve2d, "
          "running average, histogram) launched no kernel of the port and ran "
          "no plain version: the counts stayed zero", flush=True)
    work.cleanup()

    # ---- 14. training through the kernels -----------------------------------------
    from bbcat_dsp_torch.convolve import (
        convolver_init,
        convolver_render,
        convolver_step,
        ir_spectra,
        nonuniform_render,
        nonuniform_spectra,
    )
    from bbcat_dsp_torch.examples import (
        binaural_demo,
        doppler,
        fit_ir,
        streaming_eq,
    )

    rng14 = np.random.default_rng(SEED + 14)
    T14 = 2 * T_RENDER                  # two render groups: 49152 samples
    state14 = NonUniformConvolver(np.zeros((C, N)), block=BLOCK, ratio=RATIO,
                                  device=dev).state
    spectra14 = {}

    def headline(ir, x):
        """The headline engine from silence on the IRs ``[C, N]``: their
        spectra through K3 (``nonuniform_spectra``), then both render
        groups (K1-K6), the state carried across them."""
        Hh, Ht = nonuniform_spectra(ir, BLOCK, RATIO)
        if Hh.requires_grad:
            Hh.retain_grad()
            Ht.retain_grad()
            spectra14["H"] = (Hh, Ht)
        return nonuniform_render(state14, Hh, Ht, x, BLOCK)[1]

    def check_adjoint(label: str, counts: dict, must: set) -> None:
        """Fail unless a backward pass launched no kernel, ran no plain
        version as such, and ran the adjoint of every kernel in ``must``."""
        print(f"{label}: counts {counts}", flush=True)
        if any(counts["launches"].values()) or any(counts["plain"].values()):
            fail(f"{label}: the backward pass launched kernels or ran plain "
                 f"versions: {counts}")
        missing = sorted(k for k in must if counts["adjoint"][k] <= 0)
        if missing:
            fail(f"{label}: no adjoint of {missing} ran")

    def hold_training(label, fn, h, x, must):
        """``y = fn(ir, x)`` from silence, differentiated in both modes on
        the card: reverse mode in the IRs and the signal for a loss ``sum(g
        y)`` against float64 correlations (``dL/dh[n] = sum_t g[t+n]
        x[t]``, ``dL/dx[t] = sum_n g[t+n] h[n]``), forward mode against
        ``dx * h + x * dh`` in float64, each >= 90 dB; the kernels of
        ``must`` launched forward and on the tangents, only their adjoints
        backward.  Returns the leaves and the cotangent."""
        Nh, T = h.shape[-1], x.shape[-1]
        ir = torch.tensor(h, dtype=torch.float32, device=dev,
                          requires_grad=True)
        xs = torch.tensor(x, dtype=torch.float32, device=dev,
                          requires_grad=True)
        g = rng14.standard_normal(x.shape).astype(np.float32)
        gd = torch.from_numpy(g).to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ops_hook.reset_counts()
        y = fn(ir, xs)
        torch.cuda.synchronize()
        check_path(f"{label}, forward", ops_hook.counts(), must)
        ops_hook.reset_counts()
        (y * gd).sum().backward()
        torch.cuda.synchronize()
        check_adjoint(f"{label}, backward", ops_hook.counts(), must)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        s_y = snr_db(conv_rows64(x, h), y.detach().cpu().numpy())
        s_h = snr_db(correlate_rows64(g, x, Nh), ir.grad.cpu().numpy())
        s_x = snr_db(correlate_rows64(g, h, T), xs.grad.cpu().numpy())
        dh = exp_irs(rng14, h.shape[0], Nh)
        dx = rng14.standard_normal(x.shape)
        ops_hook.reset_counts()
        _, tan = torch.func.jvp(
            fn, (ir.detach(), xs.detach()),
            (torch.tensor(dh, dtype=torch.float32, device=dev),
             torch.tensor(dx, dtype=torch.float32, device=dev)))
        torch.cuda.synchronize()
        check_path(f"{label}, jvp", ops_hook.counts(), must)
        s_t = snr_db(conv_rows64(dx, h) + conv_rows64(x, dh),
                     tan.cpu().numpy())
        print(f"{label}: output {s_y:.2f} dB, dL/dh {s_h:.2f} dB, dL/dx "
              f"{s_x:.2f} dB, tangent {s_t:.2f} dB against float64; the "
              f"forward and backward's peak memory {peak:.3f} GiB over what "
              f"was allocated before ({card})",
              flush=True)
        if not min(s_y, s_h, s_x, s_t) >= 90.0:
            fail(f"{label}: below 90 dB against float64")
        return ir, xs, gd

    # the headline engine at full width: 64 channels x 32768 taps, two
    # render groups; gradients in the IRs, H_head, H_tail and x
    h14 = exp_irs(rng14, C, N)
    x14 = rng14.standard_normal((C, T14))
    ir14, xs14, g14 = hold_training(
        f"training, headline engine {C} ch x {N} taps, T = {T14}", headline,
        h14, x14, RENDER_KERNELS)
    Hh_k, Ht_k = (t.grad for t in spectra14["H"])
    # the same gradients by pure autograd through the plain versions
    use("plain")
    ir_p = ir14.detach().clone().requires_grad_()
    x_p = xs14.detach().clone().requires_grad_()
    (headline(ir_p, x_p) * g14).sum().backward()
    use("kernels")
    for what, a, b in (("dH_head", spectra14["H"][0].grad, Hh_k),
                       ("dH_tail", spectra14["H"][1].grad, Ht_k),
                       ("dL/dh", ir_p.grad, ir14.grad),
                       ("dL/dx", x_p.grad, xs14.grad)):
        s = snr_db(a.cpu().numpy(), b.cpu().numpy())
        print(f"training, headline engine: {what} through the kernels' "
              f"Functions against autograd through the plain versions: "
              f"{s:.2f} dB", flush=True)
        if not s >= 80.0:
            fail(f"{what}: {s:.2f} dB < 80 against the plain versions")

    # the training step: the IRs as parameters, a squared error against a
    # target IR set's output, Adam
    yt14 = headline(torch.tensor(exp_irs(rng14, C, N), dtype=torch.float32,
                                 device=dev), xs14.detach())
    ir_step = torch.tensor(h14, dtype=torch.float32, device=dev,
                           requires_grad=True)
    opt = torch.optim.Adam([ir_step], lr=3e-2)
    x_step = xs14.detach()

    def train_step(_=None):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((headline(ir_step, x_step) - yt14) ** 2)
        loss.backward()
        opt.step()
        return loss.detach()

    losses = [train_step() for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops_hook.reset_counts()
    losses.append(train_step())
    torch.cuda.synchronize()
    step_counts = ops_hook.counts()
    step_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(10):
        losses.append(train_step())
    b.record()
    b.synchronize()
    step_b2b = a.elapsed_time(b) / 10
    # device-only: the kernels' summed time in a profile (a spin ahead of
    # the step cannot hide the host: its ~1500 launches fill the launch
    # queue, which then blocks the host until the card drains it)
    busy_us, step_launches = where_time_goes("training step", train_step, 3)
    losses = [float(v) for v in losses]
    print(f"training step ({C} ch x {N} taps, T = {T14}: forward, backward, "
          f"Adam): {step_b2b:.4f} ms back to back (mean of 10), "
          f"{busy_us / 1e3:.4f} ms device-only (the profile's busy time, "
          f"{step_launches:.0f} launches of all kinds); the port's kernels "
          f"{step_counts['launches']}, adjoint calls "
          f"{step_counts['adjoint']}, plain calls "
          f"{sum(step_counts['plain'].values())}; peak memory "
          f"{step_peak:.3f} GiB over what was allocated before; loss "
          f"{losses[0]:.6g} -> {losses[-1]:.6g} over {len(losses)} steps "
          f"({card})", flush=True)
    check_path("training step", step_counts, RENDER_KERNELS)
    if not losses[-1] < losses[0]:
        fail("training step: the loss did not fall")

    # the uniform engine at the IR fit's sizes: one channel, block 64, 256
    # taps, 32 blocks; the render (K3, K7, K4) and a chain of steps (K3,
    # K9, K4)
    B14, N14, n14 = 64, 256, 32
    P14 = N14 // B14

    def uniform_render(ir, x):
        st = convolver_init(1, B14, P14, device=dev)
        return convolver_render(st, ir_spectra(ir, B14), x, B14)[1]

    def uniform_steps(ir, x):
        st, H, ys = convolver_init(1, B14, P14, device=dev), ir_spectra(
            ir, B14), []
        for k in range(n14):
            st, y = convolver_step(st, H, x[:, k * B14:(k + 1) * B14])
            ys.append(y)
        return torch.cat(ys, -1)

    h_fit = exp_irs(rng14, 1, N14)
    x_fit = rng14.standard_normal((1, n14 * B14))
    hold_training("training, convolver_render at the fit's sizes",
                  uniform_render, h_fit, x_fit,
                  {"rfft_half", "head_mac", "irfft_tail"})
    hold_training("training, convolver_step at the fit's sizes",
                  uniform_steps, h_fit, x_fit,
                  {"rfft_half", "rotated_mac", "irfft_tail"})

    # the four examples on the card, each with its own checks
    def log_as(name):
        return lambda *a: print(f"  {name}:", *a, flush=True)

    with tempfile.TemporaryDirectory() as tmp14:
        ops_hook.reset_counts()
        fit = fit_ir.main(device=dev, log=log_as("fit_ir"))
        torch.cuda.synchronize()
        check_path("examples.fit_ir", ops_hook.counts(),
                   {"rfft_half", "head_mac", "irfft_tail"})
        print(f"examples.fit_ir: recovered IR SNR {fit['snr_db']:.2f} dB, "
              f"final loss {fit['rel_loss']:.3e} of the target's power, "
              f"{fit['steps']} steps in {fit['seconds']:.3f} s ({card})",
              flush=True)
        if not (fit["snr_db"] > 30.0 and fit["rel_loss"] < 1e-3):
            fail("examples.fit_ir did not recover the IR")
        try:
            ops_hook.reset_counts()
            dop = doppler.main(str(Path(tmp14) / "doppler.wav"), device=dev,
                               log=log_as("doppler"))
            eqr = streaming_eq.main(str(Path(tmp14) / "eq.wav"), device=dev,
                                    log=log_as("streaming_eq"))
            torch.cuda.synchronize()
            counts_zero("examples.doppler and examples.streaming_eq")
            ops_hook.reset_counts()
            bin_ = binaural_demo.main(
                str(Path(tmp14) / "binaural.wav"), device=dev,
                sofa_path=str(Path(tmp14) / "hrtf.sofa"),
                log=log_as("binaural_demo"))
            torch.cuda.synchronize()
        except AssertionError as e:
            fail(f"an example's check: {e}")
        check_path("examples.binaural_demo", ops_hook.counts(),
                   MATRIX_KERNELS)
        yb = bin_["y"]
        step, blk = int(0.1 * FS), int(0.4 * FS)
        fed = (yb.shape[1] // step) * step
        z = block_powers64(kweight64(yb)[:, :fed], [1.0, 1.0],
                           start=-(blk - step))
        want = gated_lkfs(z[3:])
        got = bin_["loudness"]["integrated_lkfs"]
        back, _ = read_wav(bin_["path"])
        s_wav = snr_db(yb / max(1.0, np.abs(yb).max()), back)
        print(f"examples: doppler {dop['f_delay']:.2f} / {dop['f_asrc']:.2f} "
              f"Hz against {dop['f_theory']:.2f}; streaming_eq "
              f"{eqr['snr_db']:.2f} dB against the float64 bank, ramp slew "
              f"{eqr['ramp_slew']:.4f} <= program {eqr['program_slew']:.4f}; "
              f"binaural_demo integrated {got:.4f} LKFS against float64 "
              f"{want:.4f}, its INT24 file {s_wav:.2f} dB", flush=True)
        if not (abs(got - want) <= 0.01 and s_wav >= 100.0):
            fail("examples.binaural_demo: loudness or file")

    # ---- 15. sharded renders and BASELINE config #5 ------------------------------
    from bbcat_dsp_torch.examples import pod_render
    from bbcat_dsp_torch.loudness import integrated_loudness
    from bbcat_dsp_torch.parallel import (
        CommEnv,
        cases,
        config5_scaling_table,
        halo_bytes,
        run_local_world,
        time_sharded_efficiency,
    )
    from bbcat_dsp_torch.parallel.cases import Seeded

    WORLD_TIMEOUT = 300.0                # each world's, spawn included
    CHECKED5 = (0, C5 // 2 - 1, C5 - 1)     # channels 0, 511, 1023
    irs5 = Seeded(SEED + 15, C5, N5, decay=16000.0)
    x5 = Seeded(SEED + 115, C5, T5)

    # (a) config #5 in one process, at full width: 1024 channels x
    # 65536-tap IRs, block 512, ratio 8, Pt = 14, one render group
    t0 = time.perf_counter()
    h5 = irs5.make()
    conv5 = NonUniformConvolver(h5, block=BLOCK, ratio=RATIO, device=dev)
    x5h = x5.make().astype(np.float32)
    print(f"config #5: IRs and signal made and the engine built in "
          f"{time.perf_counter() - t0:.2f} s on the host; tail partitions "
          f"{conv5.tail_parts}", flush=True)
    if conv5.tail_parts != PT5:
        fail(f"config #5: {conv5.tail_parts} tail partitions, not {PT5}")
    xd5 = torch.from_numpy(x5h).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base5 = torch.cuda.memory_allocated()
    ops_hook.reset_counts()
    y5 = conv5.process(xd5)
    torch.cuda.synchronize()
    check_path("config #5, one process", ops_hook.counts(), RENDER_KERNELS)
    peak5 = (torch.cuda.max_memory_allocated() - base5) / 2 ** 30
    held5 = sum(t.numel() * 4 for t in (
        conv5.H_head, conv5.H_tail, conv5.state.xcarry, conv5.state.prev,
        conv5.state.tail.queue, conv5.state.tail.prev,
        conv5.state.pending)) / 2 ** 30
    y5h = y5.cpu().numpy()
    if y5h.shape != x5h.shape or not np.all(np.isfinite(y5h)):
        fail(f"config #5: output shape {y5h.shape} or non-finite values")
    for ch in CHECKED5:
        s = snr_db(fftconvolve(x5h[ch].astype(np.float64), h5[ch])[:T5],
                   y5h[ch])
        print(f"config #5 channel {ch}: {s:.2f} dB against float64", flush=True)
        if not s >= 90.0:
            fail(f"config #5 channel {ch}: {s:.2f} dB < 90 against float64")
    # the real-time factor over 8 distinct signals, streamed
    xs5 = randn(8, C5, T5)
    conv5.reset()
    conv5.process(xs5[0])
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for r in range(1, 8):
        conv5.process(xs5[r])
    b.record()
    b.synchronize()
    b2b5 = a.elapsed_time(b) / 7
    it5 = iter(range(10 ** 6))
    dev5 = median_ms(lambda: conv5.process(xs5[1 + next(it5) % 7]), iters=13)
    rtf5 = T5 / FS / (b2b5 / 1e3)
    print(f"config #5 render ({C5} ch x {N5} taps, T = {T5}, "
          f"{T5 / FS:.4f} s): {b2b5:.4f} ms back to back (mean of 7), "
          f"{dev5:.4f} ms device-only (median of 13): {rtf5:.2f} x real time "
          f"back to back, {T5 / FS / (dev5 / 1e3):.2f} x device-only; peak "
          f"memory {peak5:.3f} GiB over what was allocated before the render, "
          f"the engine's spectra and state {held5:.3f} GiB ({card})",
          flush=True)
    where_time_goes("config #5 render, one group (mean of 4 renders)",
                    lambda i: conv5.process(xs5[1 + i]), 4)
    del xs5, xd5
    torch.cuda.empty_cache()

    # (b)-(e) in worlds of ranks that share this card under gloo (NCCL
    # takes one rank a card): config #5 channel-sharded (and its
    # loudness, one all-reduce) over 2 and 4 ranks; config #5's IRs (the
    # first 64 of them) time-sharded over 4 ranks and over a (2, 2) mesh,
    # two render groups a span; the uniform engine at the headline
    # geometry, channel-sharded by steps and by render, and time-sharded
    irs_d = irs5._replace(rows=CT5)
    T_D = 4 * 2 * T5                     # 458752 samples, 9.56 s
    x_d = Seeded(SEED + 215, CT5, T_D)
    irs_e = Seeded(SEED + 315, C, N, decay=4000.0)
    x_step = Seeded(SEED + 415, C, 8 * BLOCK)
    x_rend = Seeded(SEED + 515, C, T_RENDER)
    T_E = 4 * 2 * T_RENDER               # 49152 samples a rank
    x_time = Seeded(SEED + 615, C, T_E)
    sharded5 = ("channel_nonuniform", {"irs": irs5, "x": x5, "block": BLOCK,
                                       "ratio": RATIO, "meter_fs": FS})
    world4 = [sharded5,
              ("time_nonuniform", {"irs": irs_d, "x": x_d, "block": BLOCK,
                                   "ratio": RATIO}),
              ("time_nonuniform", {"irs": irs_d,
                                   "x": x_d._replace(n=T_D // 2),
                                   "block": BLOCK, "ratio": RATIO,
                                   "mesh_shape": (2, 2)}),
              ("channel_step", {"irs": irs_e, "x": x_step, "block": BLOCK}),
              ("channel_render", {"irs": irs_e, "x": x_rend, "block": BLOCK}),
              ("time_render", {"irs": irs_e, "x": x_time, "block": BLOCK})]
    worlds = {}
    for n, todo in ((2, [sharded5]), (4, world4)):
        t0 = time.perf_counter()
        try:
            ranks = run_local_world(cases.run, n, args=(todo,),
                                    backend="gloo", device=dev,
                                    timeout=WORLD_TIMEOUT)
        except (RuntimeError, TimeoutError) as e:
            fail(f"gloo world of {n}: {e}")
        worlds[n] = [[r[i] for r in ranks] for i in range(len(todo))]
        print(f"gloo world of {n} ranks on {card}: {len(todo)} cases in "
              f"{time.perf_counter() - t0:.2f} s (spawn and start-up "
              f"included)", flush=True)
        compiled = [i for i, r in enumerate(ranks)
                    if any(c.get("compiled") for c in r)]
        if compiled:
            fail(f"gloo world of {n}: ranks {compiled} compiled the kernels "
                 f"again")

    def hold_ranks(label, rs, must, ref=None, bar=110.0):
        """Every rank launched the path's kernels and ran no plain version;
        rank 0's gathered output against ``ref``."""
        for i, r in enumerate(rs):
            check_path(f"{label}, rank {i}", r["counts"], must)
        secs = ", ".join(f"{r['seconds'] * 1e3:.2f}" for r in rs)
        line = f"{label}: ranks' render ms {secs} (contention on one card, " \
               f"not scaling)"
        if ref is not None:
            got = rs[0]["y"]
            if got is None or got.shape != ref.shape:
                fail(f"{label}: rank 0 gathered "
                     f"{None if got is None else got.shape}, not {ref.shape}")
            s = snr_db(ref, got)
            exact = "bit-exact" if np.array_equal(ref, got) else "not bit-exact"
            line += (f"; gathered on rank 0: {s:.2f} dB against one process, "
                     f"{exact}")
            if not s >= bar:
                fail(f"{label}: {s:.2f} dB < {bar} against one process")
        print(line + f" ({card})", flush=True)

    # (b) config #5 channel-sharded over 2 and 4 ranks
    lkfs_one = float(integrated_loudness(y5, FS, np.ones(C5)))
    lkfs64 = gated_lkfs(block_powers64(kweight64(y5h), np.ones(C5)))
    for n in (2, 4):
        rs = worlds[n][0]
        hold_ranks(f"config #5 channel-sharded over {n} ranks "
                   f"({C5 // n} channels a rank)", rs, RENDER_KERNELS, y5h)
        # (c) its loudness: one all-reduce of the block powers
        got = [r["lkfs"] for r in rs]
        ar = [r["meter_comm"]["all_reduce_sum"] for r in rs]
        print(f"config #5 sharded loudness over {n} ranks: {got[0]:.6f} LKFS "
              f"(ranks {'equal' if len(set(got)) == 1 else got}); unsharded "
              f"{lkfs_one:.6f}, float64 {lkfs64:.6f}; the all-reduce "
              f"{ar[0]['bytes_sent']} bytes a rank, staged "
              f"{ar[0]['staged_bytes']} bytes through the host, "
              f"{max(a['seconds'] for a in ar) * 1e3:.3f} ms at most; meter "
              f"{max(r['meter_seconds'] for r in rs) * 1e3:.2f} ms ({card})",
              flush=True)
        if len(set(got)) != 1 or abs(got[0] - lkfs_one) >= 1e-4 or abs(
                got[0] - lkfs64) > 0.01:
            fail(f"config #5 sharded loudness over {n} ranks: {got} against "
                 f"{lkfs_one} (1e-4 LU) and float64 {lkfs64} (0.01)")

    # (d) time-sharded two-level render at config #5's IRs
    h_d = irs_d.make()
    x_dh = x_d.make().astype(np.float32)
    conv_d = NonUniformConvolver(h_d, block=BLOCK, ratio=RATIO, device=dev)
    xd_d = torch.from_numpy(x_dh).to(dev)
    conv_d.process(xd_d[:, :2 * T5])
    conv_d.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y_seq = conv_d.process(xd_d)
    torch.cuda.synchronize()
    rtf_d = T_D / FS / (time.perf_counter() - t0)
    y_seq = y_seq.cpu().numpy()
    halo_d = halo_bytes(CT5, PT5 + 2, SB)
    for k, (label, ref, c_local) in enumerate((
            ("time-sharded over 4 ranks", y_seq, CT5),
            ("time-sharded over a (ch, t) = (2, 2) mesh",
             y_seq[:, :T_D // 2], CT5 // 2))):
        rs = worlds[4][1 + k]
        hold_ranks(f"config #5 IRs, {CT5} ch, {label}", rs, STREAM_KERNELS,
                   ref)
        for ch in (0, CT5 // 2 - 1, CT5 - 1):
            want = fftconvolve(x_dh[ch, :ref.shape[1]].astype(np.float64),
                               h_d[ch])[:ref.shape[1]]
            s = snr_db(want, rs[0]["y"][ch])
            print(f"  channel {ch}: {s:.2f} dB against float64", flush=True)
            if not s >= 90.0:
                fail(f"{label} channel {ch}: {s:.2f} dB < 90 against float64")
        want_b = halo_bytes(c_local, PT5 + 2, SB)
        for i, r in enumerate(rs):
            hx = r["comm"]["halo_exchange"]
            first = (i % 2 == 0) if k else (i == 0)
            last = (i % 2 == 1) if k else (i == 3)
            print(f"  rank {i}: halo sent {hx['bytes_sent']} B, received "
                  f"{hx['bytes_received']} B, staged {hx['staged_bytes']} B "
                  f"through the host, {hx['seconds'] * 1e3:.3f} ms", flush=True)
            if (hx["bytes_sent"] != (0 if last else want_b)
                    or hx["bytes_received"] != (0 if first else want_b)):
                fail(f"{label} rank {i}: halo bytes {hx}, expected {want_b}")
    print(f"  the halo: {halo_d} bytes a rank ({halo_d / 1e6:.1f} MB) on the "
          f"1-D mesh", flush=True)
    del xd_d, conv_d
    torch.cuda.empty_cache()

    # (e) the uniform engine, 64 ch x 32768 taps, block 512 (P = 64)
    h_e = irs_e.make()
    rs_step, rs_rend, rs_time = worlds[4][3:6]
    conv_e = BlockConvolver(h_e, BLOCK, device=dev)
    xs_e = torch.from_numpy(x_step.make().astype(np.float32)).to(dev)
    ref_e = torch.cat([conv_e.process_block(xs_e[:, k * BLOCK:(k + 1) * BLOCK])
                       for k in range(8)], -1).cpu().numpy()
    hold_ranks("BlockConvolver channel-sharded steps, 8 blocks, 4 ranks",
               rs_step, {"rfft_half", "rotated_mac", "irfft_tail"}, ref_e)
    conv_e.reset()
    ref_e = conv_e.process(x_rend.make().astype(np.float32)).cpu().numpy()
    hold_ranks(f"BlockConvolver channel-sharded render, T = {T_RENDER}, "
               f"4 ranks", rs_rend, {"rfft_half", "head_mac", "irfft_tail"},
               ref_e)
    conv_e.reset()
    ref_e = conv_e.process(x_time.make().astype(np.float32)).cpu().numpy()
    hold_ranks(f"BlockConvolver time-sharded render, 4 ranks x {T_E // 4}",
               rs_time, {"rfft_half", "head_mac", "irfft_tail"}, ref_e)
    hx = [r["comm"]["halo_exchange"] for r in rs_time]
    print(f"  its halo: {hx[0]['bytes_sent']} bytes a rank "
          f"(= {halo_bytes(C, P_UNIFORM, BLOCK)}), "
          f"{max(h['seconds'] for h in hx) * 1e3:.3f} ms at most", flush=True)

    # (f) an NCCL world of one: the collectives on the card itself
    x_f = Seeded(SEED + 715, C, T_E // 4)
    try:
        r1 = run_local_world(
            cases.run, 1, args=([("all_reduce", {"values": [1.0, -2.5]}),
                                 ("time_render", {"irs": irs_e, "x": x_f,
                                                  "block": BLOCK})],),
            backend="nccl", device=dev, timeout=WORLD_TIMEOUT)[0]
    except (RuntimeError, TimeoutError) as e:
        fail(f"NCCL world of 1: {e}")
    if not np.array_equal(r1[0]["sum"], np.float32([1.0, -2.5])):
        fail(f"NCCL world of 1: all_reduce_sum gave {r1[0]['sum']}")
    conv_e.reset()
    ref_f = conv_e.process(x_f.make().astype(np.float32)).cpu().numpy()
    hold_ranks("NCCL world of 1: init, all_reduce_sum, time-sharded render "
               "(n = 1, no exchange)", [r1[1]],
               {"rfft_half", "head_mac", "irfft_tail"}, ref_f)
    ar1, hx1 = (r1[0]["comm"]["all_reduce_sum"],
                r1[1]["comm"]["halo_exchange"])
    print(f"  NCCL all_reduce_sum: staged {ar1['staged_bytes']} bytes through "
          f"the host; the halo exchange's calls {hx1['calls']}, bytes "
          f"{hx1['bytes_sent']}", flush=True)
    del conv_e
    torch.cuda.empty_cache()

    # (g) the pod_render example, its own world of 4 and its own checks
    try:
        pod = pod_render.main(device=dev, log=log_as("pod_render"))
    except AssertionError as e:
        fail(f"examples.pod_render's check: {e}")
    except (RuntimeError, TimeoutError) as e:
        fail(f"examples.pod_render's world: {e}")
    for i, r in enumerate(pod["ranks"]):
        check_path(f"examples.pod_render, rank {i}", r["counts"],
                   RENDER_KERNELS)
    print(f"examples.pod_render: {pod['snr_db']:.2f} dB against one process, "
          f"{pod['lkfs']:.6f} LKFS against {pod['lkfs_ref']:.6f} unsharded, "
          f"the one-process render {pod['rtf']:.2f} x real time, scalar "
          f"all-reduce round trip {pod['round_trip'] * 1e6:.1f} us ({card})",
          flush=True)

    # (h) the communication model at (a)'s real-time factor
    env = CommEnv(nvlink_lat=pod["round_trip"], ib_lat=pod["round_trip"])
    print(f"comms model at config #5's measured {rtf5:.2f} x real time on one "
          f"card ({card}); bandwidths assumed from the data sheets (NVLink 4 "
          f"{env.nvlink_bw / 1e9:.0f} GB/s a direction, NDR InfiniBand "
          f"{env.ib_bw / 1e9:.0f} GB/s); latency {pod['round_trip'] * 1e6:.1f} "
          f"us, the scalar all-reduce round trip measured above (gloo, one "
          f"host), for want of a link figure:", flush=True)
    free = config5_scaling_table(rtf5, env=CommEnv(nvlink_lat=0.0,
                                                   ib_lat=0.0))
    for row, row0 in zip(config5_scaling_table(rtf5, env=env), free):
        print(f"  {row['chips']:2d} cards on {row['hosts']} host(s): "
              f"{row['aggregate_rtf']:10.1f} x real time at "
              f"{100 * row['efficiency']:6.2f}% efficiency ("
              f"{100 * row0['efficiency']:.4f}% with no latency), input "
              f"ceiling {row['input_bound_rtf']:.1f} x", flush=True)
    eff, eff0 = (time_sharded_efficiency(rtf_d, T_D / 4 / FS, CT5, PT5 + 2,
                                         SB, 4, env=e)
                 for e in (env, CommEnv(nvlink_lat=0.0, ib_lat=0.0)))
    print(f"  time-sharded (d) at its one-process {rtf_d:.2f} x real time: "
          f"halo {eff['halo_bytes']} bytes, {eff['comm_s'] * 1e6:.1f} us over "
          f"NVLink ({eff0['comm_s'] * 1e6:.1f} us with no latency) against "
          f"{eff['compute_s'] * 1e3:.2f} ms of compute a span: "
          f"{100 * eff['efficiency']:.3f}% efficiency "
          f"({100 * eff0['efficiency']:.3f}%)", flush=True)

    # ---- 16. config #1, the narrow queue, irfft_planes ---------------------------
    from bbcat_dsp_torch.convolve import irfft_planes

    # (a) BASELINE config #1 at its own geometry, uncut (BASELINE.md item
    # 1, scripts/bench_all.py:50-65): mono, block 512, one 4096-tap IR
    # (P = 8), T = 64 blocks = 32768 samples
    N1, T1 = 4096, 64 * BLOCK
    rng16 = np.random.default_rng(SEED + 16)
    ir1 = rng16.standard_normal(N1) * np.exp(-np.arange(N1) / 500.0)
    x1 = rng16.standard_normal((10, T1)).astype(np.float32)  # 2 + 8 timed
    x1d = torch.from_numpy(x1).to(dev)
    c1 = BlockConvolver(ir1, BLOCK, device=dev)
    if c1.nparts != N1 // BLOCK:
        fail(f"config #1 BlockConvolver holds {c1.nparts} partitions")

    def exact_launches(label: str, want: dict) -> None:
        """``check_path``, and the launches exactly ``want``."""
        counts = ops_hook.counts()
        check_path(label, counts, set(want))
        got = {k: v for k, v in counts["launches"].items() if v}
        if got != want:
            fail(f"{label}: launches {got}, expected {want}")

    torch.cuda.synchronize()
    ops_hook.reset_counts()
    y1 = c1.process(x1d[0])
    torch.cuda.synchronize()
    exact_launches("config #1 process, T = 32768",
                   {"rfft_half": 1, "head_mac": 1, "irfft_tail": 1})
    c1.reset()
    torch.cuda.synchronize()
    ops_hook.reset_counts()
    yb1 = torch.cat([c1.process_block(x1d[1, i * BLOCK:(i + 1) * BLOCK])
                     for i in range(T1 // BLOCK)])
    torch.cuda.synchronize()
    exact_launches("config #1 process_block x 64",
                   {"rfft_half": 64, "rotated_mac": 64, "irfft_tail": 64})
    for label, i, y in (("process", 0, y1), ("process_block x 64", 1, yb1)):
        y = y.cpu().numpy()
        if y.shape != (T1,) or not np.all(np.isfinite(y)):
            fail(f"config #1 {label}: shape {y.shape} or non-finite values")
        s = snr_db(fftconvolve(x1[i].astype(np.float64), ir1)[:T1], y)
        print(f"config #1 {label}: {s:.2f} dB against float64", flush=True)
        if not s >= 90.0:
            fail(f"config #1 {label}: {s:.2f} dB < 90 against float64")

    audio1 = T1 / FS
    c1.reset()
    for r in range(2):
        c1.process(x1d[r])
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for r in range(8):
        c1.process(x1d[2 + r])
    b.record()
    torch.cuda.synchronize()
    b2b1 = a.elapsed_time(b) / 8
    it = iter(range(10 ** 6))
    devo1 = [per_block_ms(lambda _: c1.process(x1d[2 + next(it) % 8]), 1,
                          True) for _ in range(8)]
    dev_txt = ("device-only not resolved (host slower than the spin)"
               if None in devo1 else
               f"device-only median {statistics.median(t[0] for t in devo1):.4f}"
               f" ms = {audio1 / (statistics.median(t[0] for t in devo1) / 1e3):.2f}"
               " x real time")
    print(f"config #1 process, T = {T1} ({audio1:.4f} s of audio), 8 distinct "
          f"signals: {b2b1:.4f} ms back to back = "
          f"{audio1 / (b2b1 / 1e3):.2f} x real time; {dev_txt} ({card})",
          flush=True)

    xflat = x1d.reshape(-1)       # 640 distinct blocks
    at = iter(range(10 ** 6))

    def step1(_):
        i = next(at) % (xflat.numel() // BLOCK)
        c1.process_block(xflat[i * BLOCK:(i + 1) * BLOCK])

    c1.reset()
    for i in range(8):
        step1(i)
    runs = [per_block_ms(step1, 64, False) for _ in range(3)]
    devo = [per_block_ms(step1, 1, True) for _ in range(20)]
    worsts = [max(r) for r in runs]
    worst = statistics.median(worsts)
    dev_txt = ("device-only not resolved (host slower than the spin)"
               if None in devo else
               f"device-only mean {statistics.mean(t[0] for t in devo):.4f} "
               f"ms, max {max(t[0] for t in devo):.4f} ms")
    print(f"latency config #1 process_block: back to back mean "
          f"{statistics.mean(t for r in runs for t in r):.4f} ms, worst "
          + " / ".join(f"{w:.4f}" for w in worsts) + f" ms, median worst "
          f"{worst:.4f} ms ({DEADLINE_MS / worst:.1f}x inside the "
          f"{DEADLINE_MS:.4f} ms deadline); {dev_txt} ({card})", flush=True)
    if not worst < DEADLINE_MS:
        fail(f"config #1: median worst block {worst:.4f} ms misses the "
             f"{DEADLINE_MS:.4f} ms deadline")
    where_time_goes("config #1 process, T = 32768 (mean of 8 renders)",
                    lambda i: c1.process(x1d[2 + i]), 8)
    where_time_goes("config #1 process_block (mean of 64 blocks)", step1, 64)

    # (b) the narrow queue (dtype bfloat16, float16) at the headline's
    # geometry: 64 ch x 32768 taps, block 512, P = 64; 64 blocks with an
    # exchange of every IR at block 32.  K9 on the stream's own stored
    # queue against its plain version (>= 110 dB: both widen the same
    # values), and the whole kernel path against the plain path at the
    # same dtype.  The two paths' float32 windows differ in their last
    # bits (K3 is not torch.fft), so a few queue entries round to the
    # neighbouring narrow value: each differing entry must be one step of
    # the narrow type apart, and the outputs >= 80 dB apart (the bar of
    # the CPU tests' port-against-JAX narrow streams, the same cause).
    # The distance from the float32 engine and from float64 is printed
    gq1, gq2 = exp_irs(rng16, C, N), exp_irs(rng16, C, N)
    NBQ, SWQ = 64, 32
    xq = rng16.standard_normal((C, NBQ * BLOCK)).astype(np.float32)
    xqd = torch.from_numpy(xq).to(dev)

    def narrow_stream(dt):
        conv = BlockConvolver(gq1, BLOCK, dtype=dt, device=dev)
        torch.cuda.synchronize()
        ops_hook.reset_counts()
        ys = []
        for i in range(NBQ):
            if i == SWQ:
                conv.set_filter(gq2)
            ys.append(conv.process_block(xqd[:, i * BLOCK:(i + 1) * BLOCK]))
        y = torch.cat(ys, dim=-1)
        torch.cuda.synchronize()
        return y.cpu().numpy(), conv, ops_hook.counts()

    def one_step_apart(qa, qb, mantissa_bits: int):
        """How many entries of two narrow queues differ, and how many of
        them by more than one step of the type at their magnitude (plus
        1e-6 of the queue's rms, for a sign that differs at zero)."""
        qa, qb = qa.float(), qb.float()
        big = torch.maximum(qa.abs(), qb.abs()).clamp_min(1e-30)
        step = torch.exp2(torch.floor(torch.log2(big)) - mantissa_bits)
        d = (qa - qb).abs()
        far = d > step + 1e-6 * float(qb.pow(2).mean().sqrt())
        return int((d != 0).sum()), int(far.sum())

    y32q = narrow_stream(torch.float32)[0]
    models = {ch: fade(conv64(xq[ch], gq1[ch]), conv64(xq[ch], gq2[ch]),
                       SWQ * BLOCK, BLOCK) for ch in CHECKED}
    for name, dt, bits in (("rotated_mac_bf16", torch.bfloat16, 7),
                           ("rotated_mac_f16", torch.float16, 10)):
        yk, kconv, counts = narrow_stream(dt)
        label = f"BlockConvolver dtype={str(dt)[6:]}, 64 blocks + exchange"
        check_path(label, counts, {"rfft_half", name, "irfft_tail"})
        kq = kconv.state.queue
        if counts["launches"]["rotated_mac"] or kq.dtype != dt:
            fail(f"{label}: the float32 K9 ran or the queue is {kq.dtype}")
        s9 = min(snr_db(
            k79.rotated_mac_plain(kq, kconv.H, slot).cpu().numpy(),
            k79.rotated_mac_cuda(kq, kconv.H, slot).cpu().numpy())
            for slot in (kconv.state.step % kconv.nparts, 0))
        use("plain")
        yp, pconv, pcounts = narrow_stream(dt)
        use("kernels")
        if pcounts["plain"][name] != NBQ + 1:
            fail(f"{label}, plain: {pcounts['plain']}")
        ndiff, nfar = one_step_apart(kq, pconv.state.queue, bits)
        s = snr_db(yp, yk)
        print(f"{label}: K9 on the stream's queue against its plain version "
              f">= {s9:.2f} dB; kernels against the plain versions {s:.2f} "
              f"dB, their queues apart in {ndiff} of {kq.numel()} entries, "
              f"{nfar} of them by more than one step; "
              + "; ".join(f"channel {ch} {snr_db(y32q[ch], yk[ch]):.2f} dB "
                          f"against the float32 engine, "
                          f"{snr_db(models[ch], yk[ch]):.2f} dB against "
                          f"float64" for ch in CHECKED), flush=True)
        if not s9 >= 110.0:
            fail(f"{label}: K9 {s9:.2f} dB < 110 on the stream's queue")
        if nfar or ndiff > 1e-2 * kq.numel():
            fail(f"{label}: the paths' queues differ beyond rounding")
        if not s >= 80.0 or not np.all(np.isfinite(yk)):
            fail(f"{label}: {s:.2f} dB < 80 against the plain path")
        r = results[name]
        print(f"  {name}: {r['ms']:.4f} ms a launch, bound {r['bound_ms']:.4f}"
              f" ms; float32 K9 {results['rotated_mac']['ms']:.4f} ms, bound "
              f"{results['rotated_mac']['bound_ms']:.4f} ms ({card})",
              flush=True)

    # (c) irfft_planes on the card, spectra with nonzero imaginary parts at
    # DC and Nyquist, against the CPU; the same spectra straight into
    # torch.fft.irfft read far lower where cuFFT's C2R uses those parts
    # (the render shapes among them)
    lowest_raw = float("inf")
    for lead, n in (((48, 64), 1024), ((64,), 1024), ((64,), 4096),
                    ((6, 64), 8192), ((1,), 8192), ((3,), 65536)):
        sp = torch.from_numpy(rng16.standard_normal(
            (2, *lead, n // 2 + 1)).astype(np.float32))
        want = irfft_planes(sp, n).numpy()
        spd = sp.to(dev)
        got = irfft_planes(spd, n).cpu().numpy()
        raw = torch.fft.irfft(torch.complex(spd[0], spd[1]), n=n).cpu().numpy()
        s, s_raw = snr_db(want, got), snr_db(want, raw)
        lowest_raw = min(lowest_raw, s_raw)
        print(f"irfft_planes rows={lead} n={n} on the card: {s:.2f} dB "
              f"against the CPU; torch.fft.irfft of the same spectra "
              f"{s_raw:.2f} dB", flush=True)
        if not s >= 110.0:
            fail(f"irfft_planes rows={lead} n={n}: {s:.2f} dB < 110")
    if not lowest_raw < 100.0:
        fail("irfft_planes: no shape shows cuFFT using the DC and Nyquist "
             "imaginary parts, so nothing shows the zeroing at work")
    del c1, x1d, xqd
    torch.cuda.empty_cache()

    # ---- 17. the dtype surface at full width --------------------------------------
    # Each part at bfloat16 and float16 beside float32, on inputs of their
    # own seed (phase17_inputs).  Each SNR against float64 must meet its bar
    # in NARROW_BARS: the JAX package's own narrow output on the same
    # inputs against the same float64 reference, less 1 dB, measured on
    # the CPU by tests/narrow_bars.py (this machine has no JAX).
    from bbcat_dsp_torch.filters.fractional import FractionalDelayLine
    from bbcat_dsp_torch.filters.resample import Resampler

    inp17 = phase17_inputs(
        lambda f, g: biquad_coeffs(FilterType.PEQ, f, FS, gain=g))
    NARROW17 = (("bfloat16", torch.bfloat16), ("float16", torch.float16))
    WIDE17 = (("float32", torch.float32),) + NARROW17

    def peak_mb(fn):
        """``fn()`` and the device memory it held at its peak beyond what
        was allocated before it, MB."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated() - base) / 1e6

    def meets(label, name, part, got):
        want = NARROW_BARS[name][part]
        print(f"{label}: {got:.2f} dB against float64, bar {want:.2f} dB "
              f"(JAX's own less 1 dB)", flush=True)
        if not got >= want:
            fail(f"{label}: {got:.2f} dB < the bar {want:.2f} dB")

    def block_times(step, nblk: int) -> str:
        """Back to back (the mean over ``nblk`` calls ``step(i)``) and
        device-only (median over 8, behind a spin) ms a call."""
        step(0)
        b2b = statistics.mean(per_block_ms(step, nblk, False))
        it = iter(range(10 ** 6))
        devo = device_ms(lambda: step(next(it) % nblk), 8)
        return f"{b2b:.4f} ms back to back, {devo} device-only"

    # (a) the headline two-level engine with a narrow tail queue, through
    # process_block: an exchange of every IR at super-block 6 and of
    # channel 31's at 11; exactly the float32 path's launches
    a17 = inp17["a"]
    xa17 = torch.from_numpy(a17["x"]).to(dev)
    k17 = C // 2 - 1

    def stream17(dt):
        conv = NonUniformConvolver(a17["h1"], BLOCK, RATIO, dtype=dt,
                                   device=dev)
        torch.cuda.synchronize()
        ops_hook.reset_counts()
        ys = []
        for j in range(NSUP17):
            if j == SW_ALL:
                conv.set_filter(a17["h2"])
            if j == SW_ONE:
                conv.set_filter(a17["h3"], channel=k17)
            ys.append(conv.process_block(xa17[:, j * SB:(j + 1) * SB]))
        torch.cuda.synchronize()
        return torch.cat(ys, -1).cpu().numpy(), conv, ops_hook.counts()

    models17 = {ch: two_level_model(a17["x"], a17["h1"], a17["h2"],
                                    a17["h3"], ch, k17) for ch in CHECKED}
    runs17 = {}
    for name, dt in WIDE17:
        (y, conv, counts), mb = peak_mb(lambda: stream17(dt))
        label = (f"phase 17 (a) two-level, {name} tail queue, {NSUP17} "
                 "super-blocks, 2 exchanges")
        if name == "float32":
            want17 = {k: v for k, v in counts["launches"].items() if v}
        exact_launches(label, want17)
        if y.shape != a17["x"].shape or not np.all(np.isfinite(y)):
            fail(f"{label}: output shape {y.shape} or non-finite values")
        q = conv.state.tail.queue
        if q.dtype != dt or conv.state.xcarry.dtype != torch.float32:
            fail(f"{label}: tail queue {q.dtype}, xcarry "
                 f"{conv.state.xcarry.dtype}")
        s = min(snr_db(models17[ch], y[ch]) for ch in CHECKED)
        if not all(click_free(y[ch]) for ch in CHECKED):
            fail(f"{label}: a click")
        if name != "float32":
            meets(f"{label}, channels {CHECKED} against the crossfade "
                  "model", name, "a", s)
            for call, arg in (("process", xa17[:, :6 * SB]),
                              ("process_small_block", xa17[:, :BLOCK])):
                try:
                    getattr(conv, call)(arg)
                except ValueError as e:
                    if "TypeError" not in str(e):
                        fail(f"{label}: {call} raised {e}")
                else:
                    fail(f"{label}: {call} ran on a narrow engine")
        ts = block_times(lambda i, c=conv: c.process_block(
            xa17[:, i * SB:(i + 1) * SB]), NSUP17)
        runs17[name] = y
        print(f"{label}: {s:.2f} dB against float64 (worst checked "
              f"channel), {snr_db(runs17['float32'], y):.2f} dB against "
              f"the float32 engine; tail queue {q.nbytes / 1e6:.2f} MB; "
              f"process_block {ts}; peak memory {mb:.1f} MB ({card})",
              flush=True)
    del xa17, conv
    torch.cuda.empty_cache()

    # (b) config #3 narrow: the renderer's EQ parameters and state and its
    # matrix queue in the narrow type, the output float32
    b17 = inp17["b"]
    xb17 = torch.from_numpy(b17["x"]).to(dev)
    refb17 = binaural_model(b17["x"], b17["eq"], b17["h1"], b17["h2"])

    def rend17(dt):
        rend = BinauralRenderer(b17["h1"], block=BLOCK, eq_stages=[b17["eq"]],
                                fs=FS, dtype=dt, device=dev)
        torch.cuda.synchronize()
        ops_hook.reset_counts()
        ys = []
        for i in range(NB17):
            if i == SW17:
                rend.set_hrtf(b17["h2"])
            ys.append(rend.process_block(xb17[:, i * BLOCK:(i + 1) * BLOCK]))
        torch.cuda.synchronize()
        return torch.cat(ys, -1), rend, ops_hook.counts()

    for name, dt in WIDE17:
        (y, rend, counts), mb = peak_mb(lambda: rend17(dt))
        label = f"phase 17 (b) config #3 BinauralRenderer dtype={name}"
        check_path(label, counts, MATRIX_KERNELS)
        if y.dtype != torch.float32 or rend.state.conv.queue.dtype != dt:
            fail(f"{label}: output {y.dtype}, queue "
                 f"{rend.state.conv.queue.dtype}")
        y = y.cpu().numpy()
        s = min(snr_db(refb17[o], y[o]) for o in range(2))
        if not np.all(np.isfinite(y)) or not all(click_free(r) for r in y):
            fail(f"{label}: non-finite values or a click")
        fed = (y.shape[1] // rend.meter.step) * rend.meter.step
        z = block_powers64(kweight64(y)[:, :fed], [1.0, 1.0],
                           start=-(rend.meter.blk - rend.meter.step))
        lk, lk64 = rend.loudness()["integrated_lkfs"], gated_lkfs(z[3:])
        if not abs(lk - lk64) <= 0.01:
            fail(f"{label}: meter {lk:.4f} against float64 {lk64:.4f}")
        if name != "float32":
            meets(f"{label}, both ears against the float64 chain", name, "b",
                  s)
        ts = block_times(lambda i, r=rend: r.process_block(
            xb17[:, i * BLOCK:(i + 1) * BLOCK]), NB17)
        print(f"{label}: {s:.2f} dB against float64 (worse ear), meter "
              f"{lk:.4f} LUFS against {lk64:.4f}; process_block {ts}; peak "
              f"memory {mb:.1f} MB ({card})", flush=True)
    del xb17, rend
    torch.cuda.empty_cache()

    # (c) config #2 narrow: both delay paths and the modal fallback, the
    # output in the narrow type; then a FractionalDelayLine, a
    # SoundDelayBuffer and a Resampler at 64 channels
    c17 = inp17["c"]
    x2n = torch.from_numpy(c17["x"]).to(dev)

    def pipe17(dt, stages, delays, nblk):
        pipe = EQDelayPipeline(stages, C17, B17, 256.0, FS, dt, device=dev)
        dd = torch.from_numpy(delays).to(dev)

        def step(i):
            d = dd[:, i * B17:(i + 1) * B17] if dd.dim() > 1 else dd
            return pipe.process_block(x2n[:, i * B17:(i + 1) * B17], d)

        return torch.cat([step(i) for i in range(nblk)], -1), pipe, step

    L17 = 1 << int(np.ceil(np.log2(256 + 14 + B17)))   # the ring: 8192
    torch.cuda.synchronize()
    ops_hook.reset_counts()
    for part, stages, delays, nblk in (
            ("c stream", c17["eq"], c17["steady"], NBLK17),
            ("c gather", c17["eq"], c17["glide"], NBLK17),
            ("c modal", c17["twice"], c17["steady"], 4)):
        n = nblk * B17
        ref = delayed64(cascade64(c17["x"][:, :n], stages),
                        delays[..., :n] if delays.ndim > 1 else delays,
                        L17, B17)
        for name, dt in WIDE17:
            (y, pipe, step), mb = peak_mb(
                lambda: pipe17(dt, stages, delays, nblk))
            label = f"phase 17 ({part}) config #2 EQDelayPipeline dtype={name}"
            if pipe.length != L17 or (pipe.psos is None) != (
                    part == "c modal"):
                fail(f"{label}: ring {pipe.length}, parallel form "
                     f"{pipe.psos is not None}")
            if y.dtype != dt or pipe.state.ring.data.dtype != dt:
                fail(f"{label}: output {y.dtype}, ring "
                     f"{pipe.state.ring.data.dtype}")
            y = y.float().cpu().numpy()
            s = min(snr_db(r, t) for r, t in zip(ref, y))
            if name != "float32":
                meets(f"{label}, worst channel", name, part, s)
            ts = block_times(step, nblk)
            print(f"{label}: {s:.2f} dB (worst channel); process_block "
                  f"{ts}; peak memory {mb:.1f} MB ({card})", flush=True)
    counts = ops_hook.counts()
    if any(counts["launches"].values()) or any(counts["plain"].values()):
        fail(f"phase 17 (c) ran a kernel of the port or a plain version: "
             f"{counts}")
    xs17 = torch.from_numpy(c17["xs"]).to(dev)
    ds17 = torch.from_numpy(c17["ds"]).to(dev)
    ref_line = fractional_reference(c17["xs"], c17["ds"], 8192, 1024)
    twin = Resampler(C, 44100.0 / 48000.0, 1024, device=dev)
    wide_out = [twin.process(xs17[:, k * 1024:(k + 1) * 1024])
                for k in range(8)]
    for name, dt in NARROW17:
        line = FractionalDelayLine(C, 8192, dt, device=dev)
        dbuf = SoundDelayBuffer(C, 8192, dt, device=dev)
        rs = Resampler(C, 44100.0 / 48000.0, 1024, dt, device=dev)
        reads, exact = [], True
        for k in range(8):
            blk = xs17[:, k * 1024:(k + 1) * 1024]
            line.write(blk)
            reads.append(line.read(ds17))
            dbuf.write(blk)
            exact &= torch.equal(dbuf.read(1024, 1024), blk.to(dt))
            exact &= torch.equal(rs.process(blk), wide_out[k])
        packed = dbuf.read_packed(SampleFormat.INT24, False, 4096, 4096)
        twin_buf = SoundDelayBuffer(C, 8192, device=dev)
        twin_buf.write(xs17.to(dt).float())
        exact &= np.array_equal(packed, twin_buf.read_packed(
            SampleFormat.INT24, False, 4096, 4096))
        y = torch.cat(reads, -1)
        if y.dtype != dt or not exact:
            fail(f"phase 17 (c) {name} small ops: read {y.dtype}, the delay "
                 "buffer or the resampler not exact")
        s = min(snr_db(r, t) for r, t in zip(ref_line,
                                              y.float().cpu().numpy()))
        meets(f"phase 17 (c) FractionalDelayLine dtype={name}, {C} ch x "
              f"8192, 8 writes of 1024, 512 reads a channel after each, "
              f"worst channel", name, "c line", s)
        print(f"phase 17 (c) {name}: SoundDelayBuffer reads and INT24 "
              "packed frames equal the rounded input; the Resampler's output "
              "is the float32 one, exactly (its history is float32 after a "
              "block, as the reference's)", flush=True)
    del x2n, xs17
    torch.cuda.empty_cache()

    # (d) config #4 narrow: the meter and the mixdown at 128 channels x 1 s
    d17 = inp17["d"]
    xd17 = torch.from_numpy(d17["x"]).to(dev)
    lk64 = meter_reference(d17["x"])
    mix64 = d17["gains"] @ d17["x"].astype(np.float64)
    for name, dt in WIDE17:
        meter = LoudnessMeter(C4_17, FS, dtype=dt, device=dev)
        mix = MixdownPipeline(d17["gains"], FS, dtype=dt, device=dev)

        def step(_):
            meter.process(xd17)
            return mix.process_block(xd17)

        y, mb = peak_mb(lambda: step(0))
        lk = meter.integrated()
        label = f"phase 17 (d) config #4 meter and mixdown dtype={name}"
        if (meter.state.sq_tail.dtype != dt or mix.gains.dtype != dt
                or y.dtype != torch.float32):
            fail(f"{label}: tail {meter.state.sq_tail.dtype}, gains "
                 f"{mix.gains.dtype}, output {y.dtype}")
        s = min(snr_db(r, t) for r, t in zip(mix64, y.cpu().numpy()))
        err = abs(lk - lk64)
        if name != "float32":
            meets(f"{label}, the mix", name, "d mixdown", s)
            if not err <= NARROW_LU[name]:
                fail(f"{label}: integrated {lk:.4f} LUFS, {err:.4f} LU from "
                     f"float64, the bar {NARROW_LU[name]} LU")
        ts = block_times(step, 1)
        print(f"{label}: integrated {lk:.4f} LUFS against float64 "
              f"{lk64:.4f} ({err:.4f} LU); mix {s:.2f} dB; the step (1 s) "
              f"{ts}; peak memory {mb:.1f} MB ({card})", flush=True)
    del xd17
    torch.cuda.empty_cache()

    # (e) narrow state files: (a)-(c) stopped half-way, written, read into
    # fresh engines and continued on the card (>= 110 dB against the
    # uninterrupted stream; bit-exact is expected)
    tmpdir = tempfile.TemporaryDirectory()
    ckpt = str(Path(tmpdir.name) / "state.pkl")
    xa17 = torch.from_numpy(a17["x"]).to(dev)
    xb17 = torch.from_numpy(b17["x"]).to(dev)
    x2n = torch.from_numpy(c17["x"]).to(dev)
    steady17 = torch.from_numpy(c17["steady"]).to(dev)

    def sbs(e, lo, hi):
        return [e.process_block(xa17[:, j * SB:(j + 1) * SB])
                for j in range(lo, hi)]

    def blocks(e, lo, hi):
        return [e.process_block(xb17[:, i * BLOCK:(i + 1) * BLOCK])
                for i in range(lo, hi)]

    def eqd(e, lo, hi):
        return [e.process_block(x2n[:, i * B17:(i + 1) * B17],
                                steady17).float() for i in range(lo, hi)]

    for name, dt in NARROW17:
        resumed(f"phase 17 (e) two-level {name} tail queue",
                lambda: NonUniformConvolver(a17["h1"], BLOCK, RATIO,
                                            dtype=dt, device=dev),
                lambda e: sbs(e, 0, 8), lambda e: sbs(e, 8, 16),
                {"fused_head", "rfft_half", "xt_step_mac", "irfft_tail"})
        resumed(f"phase 17 (e) BinauralRenderer dtype={name}",
                lambda: BinauralRenderer(b17["h1"], block=BLOCK,
                                         eq_stages=[b17["eq"]], fs=FS,
                                         dtype=dt, device=dev),
                lambda e: blocks(e, 0, 24), lambda e: blocks(e, 24, 48),
                MATRIX_KERNELS)
        resumed(f"phase 17 (e) EQDelayPipeline dtype={name}",
                lambda: EQDelayPipeline(c17["eq"], C17, B17, 256.0, FS, dt,
                                        device=dev),
                lambda e: eqd(e, 0, 8), lambda e: eqd(e, 8, 16), set())
    tmpdir.cleanup()
    del xa17, xb17, x2n
    torch.cuda.empty_cache()

    for name in results:
        results[name]["launches"] = sum(c[name] for c in path_launches)
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
