#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which exits nonzero on failure:

1. the card (``nvidia-smi`` name and power limit) and the PyTorch version;
   no CUDA device means exit 1 before anything else;
2. build the eight CUDA kernels from ``bbcat_dsp_torch/csrc`` with nvcc,
   one compiler per source, all at once;
3. each kernel against its plain PyTorch version on the card, at the
   shapes its paths give it and at small and odd ones, with times (CUDA
   events, median of 20 launches) at the main paths' shapes;
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
   factor of the config #4 step.  Phases 8 and 9 end with a profile of a
   binaural block and a config #4 step (device time by kernel).

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel with its launches, error and times.
"""

from __future__ import annotations

import contextlib
import json
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

# the kernels each path must launch
RENDER_KERNELS = {"fused_head", "rfft_half", "xt_grouped_mac", "irfft_tail",
                  "gather_supers", "delayed_add"}
STREAM_KERNELS = RENDER_KERNELS | {"head_mac"}
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

    def median_ms(fn, iters: int = 20) -> float:
        """Device time of ``fn``'s launches, median over ``iters`` runs.
        A ~2 ms spin on the stream first lets the host enqueue all of
        ``fn`` before the start event fires, so host launch overhead stays
        outside the events."""
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(4_000_000)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    results = {}

    def record(name, source, replaces, err, ms, plain_ms):
        results[name] = {"name": name, "route": "cuda",
                         "source": source, "replaces": replaces,
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        print(f"{name}: max_abs_err {err:.3e}  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms  ({card})", flush=True)

    # ---- 3. each kernel against its plain version ----------------------------
    # K1 fused head: (C, P, B, R); the first is the render's, R < P and
    # R >= P both covered
    k1_err, bad = None, []
    for Cc, P, B, R in ((C, 16, BLOCK, T_RENDER // BLOCK), (C, 16, BLOCK, 8),
                        (1, 1, 32, 1), (5, 6, 32, 4), (8, 6, 32, 16),
                        (5, 1, 512, 3), (8, 16, 512, 24), (3, 4, 1024, 5)):
        F = B + 1
        args = (randn(Cc, R * B), randn(2, P, Cc, F), randn(2, Cc, F),
                randn(2, P, Cc, F))
        got = k1.fused_head_cuda(*args, B)
        want = k1.fused_head_plain(*args, B)
        torch.cuda.synchronize()
        snrs = [snr_db(w.cpu().numpy(), g.cpu().numpy())
                for g, w in zip(got, want)]
        print(f"fused_head C={Cc} P={P} B={B} R={R}: y/xcarry/prev "
              + " ".join(f"{s:.1f}" for s in snrs) + " dB", flush=True)
        if not min(snrs) >= 110.0:
            bad.append(f"fused_head C={Cc} P={P} B={B} R={R}")
        if k1_err is None:
            k1_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            bench_args = args
    if bad:
        fail(f"below 110 dB: {bad}")
    record("fused_head", "bbcat_dsp_torch/csrc/fused_head.cu",
           tpu_kernel("fused_head_pallas"), k1_err,
           median_ms(lambda: k1.fused_head_cuda(*bench_args, BLOCK)),
           median_ms(lambda: k1.fused_head_plain(*bench_args, BLOCK)))

    # K3/K4 tail transforms: (row shape, n); the first is the group
    # render's, the second the per-super-step branch's
    errs, bad = None, []
    for lead, n in (((6, C), 2 * SB), ((C,), 2 * SB), ((1,), 64),
                    ((5, 3), 256), ((2,), 16384), ((7,), 2 * BLOCK),
                    ((128, C), 2 * BLOCK), ((C,), 2 * BLOCK),
                    ((128, 2), 2 * BLOCK), ((2,), 2 * BLOCK)):
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
        if errs is None:
            errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
            bench_x, bench_planes = x, planes
    if bad:
        fail(f"below 110 dB: {bad}")
    record("rfft_half", "bbcat_dsp_torch/csrc/half_fft.cu",
           tpu_kernel("perm_rfft_half_pallas"), errs[0],
           median_ms(lambda: k34.rfft_half_cuda(bench_x, 2 * SB)),
           median_ms(lambda: k34.rfft_half_plain(bench_x, 2 * SB)))
    record("irfft_tail", "bbcat_dsp_torch/csrc/half_fft.cu",
           tpu_kernel("perm_irfft_tail_pallas"), errs[1],
           median_ms(lambda: k34.irfft_tail_cuda(bench_planes, 2 * SB)),
           median_ms(lambda: k34.irfft_tail_plain(bench_planes, 2 * SB)))

    # K2 xt-grouped tail MAC: (P, C, F, slot0)
    k2_err, bad = None, []
    for P, Cc, F, slot0 in ((6, C, SB + 1, 0), (6, C, SB + 1, 3),
                            (1, 1, 33, 0), (2, 5, 33, 1), (6, 8, 257, 5),
                            (2, 8, SB + 1, 0), (1, 5, SB + 1, 0)):
        args = (randn(2, P, Cc, F), randn(2, P, Cc, F), randn(2, P, Cc, F))
        got = k2.xt_grouped_mac_cuda(*args, slot0)
        want = k2.xt_grouped_mac_plain(*args, slot0)
        s = snr_db(want.cpu().numpy(), got.cpu().numpy())
        if not s >= 120.0:
            bad.append(f"xt_grouped_mac P={P} C={Cc} F={F} slot0={slot0}")
        print(f"xt_grouped_mac P={P} C={Cc} F={F} slot0={slot0}: "
              f"{s:.1f} dB", flush=True)
        if k2_err is None:
            k2_err = float((got - want).abs().max())
            bench_args = args
    if bad:
        fail(f"below 120 dB: {bad}")
    record("xt_grouped_mac", "bbcat_dsp_torch/csrc/xt_grouped_mac.cu",
           tpu_kernel("xt_grouped_mac_pallas"), k2_err,
           median_ms(lambda: k2.xt_grouped_mac_cuda(*bench_args, 0)),
           median_ms(lambda: k2.xt_grouped_mac_plain(*bench_args, 0)))

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
           median_ms(lambda: k56.gather_supers_plain(bench_x, 6)))

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
           median_ms(lambda: k56.delayed_add_plain(*bench_args)))

    # K7 head MAC: (C, P, R, F, extra history slots); the first four are
    # the paths' shapes (small-block head, head crossfade, per-super-step
    # tail, BlockConvolver render), then C = 1, 5, 12 (K8's regime in the
    # JAX package), P = 1, and the crossfade's deeper history
    k7_shapes = ((C, 16, 1, BLOCK + 1, 0), (C, 16, RATIO, BLOCK + 1, 0),
                 (C, 6, 1, SB + 1, 0),
                 (C, P_UNIFORM, T_RENDER // BLOCK, BLOCK + 1, 0),
                 (1, 16, 1, BLOCK + 1, 0), (5, 16, RATIO, BLOCK + 1, 0),
                 (12, 6, 1, SB + 1, 0), (C, 1, 3, BLOCK + 1, 0),
                 (5, 3, 17, 33, 0), (C, 16, 1, BLOCK + 1, RATIO - 1))
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
                     f"{k7_ms[(P, R, F)][1]:.4f} ms ({card})")
            k7_err = max(k7_err or 0.0, float((got - want).abs().max()))
        print(line, flush=True)
    if bad:
        fail(f"below 120 dB: {bad}")
    # the JSON line carries the BlockConvolver render's shape, the largest
    ms, plain_ms = k7_ms[(P_UNIFORM, T_RENDER // BLOCK, BLOCK + 1)]
    record("head_mac", "bbcat_dsp_torch/csrc/spectral_mac.cu",
           tpu_kernel("head_mac_tiled_pallas"), k7_err, ms, plain_ms)

    # K9 rotated MAC: (P, C, F, slot); the BlockConvolver step's shape at
    # two cursors, then small odd ones
    k9_err, bad = None, []
    for P, Cc, F, slot in ((P_UNIFORM, C, BLOCK + 1, 0),
                           (P_UNIFORM, C, BLOCK + 1, 37), (5, 3, 17, 4),
                           (1, 1, 9, 0), (7, 5, 33, 6)):
        args = (randn(2, P, Cc, F), randn(2, P, Cc, F))
        got = k79.rotated_mac_cuda(*args, slot)
        want = k79.rotated_mac_plain(*args, slot)
        s = snr_db(want.cpu().numpy(), got.cpu().numpy())
        if not s >= 120.0:
            bad.append(f"rotated_mac P={P} C={Cc} F={F} slot={slot}")
        print(f"rotated_mac P={P} C={Cc} F={F} slot={slot}: {s:.1f} dB",
              flush=True)
        if slot == 37:
            k9_err = float((got - want).abs().max())
            bench_args = args
    if bad:
        fail(f"below 120 dB: {bad}")
    record("rotated_mac", "bbcat_dsp_torch/csrc/spectral_mac.cu",
           tpu_kernel("rotated_mac_pallas"), k9_err,
           median_ms(lambda: k79.rotated_mac_cuda(*bench_args, 37)),
           median_ms(lambda: k79.rotated_mac_plain(*bench_args, 37)))

    path_launches = []

    def check_path(label: str, counts: dict, must: set) -> None:
        """Fail unless the path launched every kernel in ``must`` and ran
        no plain version."""
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
    check_path("streaming two-level", ops_hook.counts(), STREAM_KERNELS)
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
    from bbcat_dsp_torch.loudness import k_weighting_coeffs

    MATRIX_KERNELS = {"rfft_half", "irfft_tail"}
    CI, N_HRTF, N_BRIR = 64, 1024, 32768   # scripts/bench_all.py config #3
    eq = biquad_coeffs(FilterType.PEQ, 1000.0, FS, gain=4.0)
    shelf, rlb = k_weighting_coeffs(FS)

    def kweight64(x):
        return lfilter64(lfilter64(x, shelf), rlb)

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

    xl = randn(CI, 40 * BLOCK)
    where_time_goes("BinauralRenderer.process_block (mean of 40 blocks)",
                    lambda i: rend.process_block(
                        xl[:, i * BLOCK:(i + 1) * BLOCK]), 40)
    where_time_goes("config #4 step", lambda i: step4(xs4[i % 10]), 4)

    for name in results:
        results[name]["launches"] = sum(c[name] for c in path_launches)
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
