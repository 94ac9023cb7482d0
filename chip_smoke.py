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
   real-time factor.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel with its launches, error and times.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
                    ((5, 3), 256), ((2,), 16384), ((7,), 2 * BLOCK)):
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

    for name in results:
        results[name]["launches"] = sum(c[name] for c in path_launches)
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
