#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which exits nonzero on failure:

1. the card (``nvidia-smi`` name and power limit) and the PyTorch version;
   no CUDA device means exit 1 before anything else;
2. build the six CUDA kernels from ``bbcat_dsp_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on the card, at the
   headline render's shapes and at small and odd ones, with times
   (CUDA events, median of 20 launches) at the headline shapes;
4. the headline engine (64 channels x 32768-tap IRs, block 512, ratio 8)
   over a stream of distinct signals that takes all three render
   branches, held against a float64 ``scipy.signal.fftconvolve`` at
   >= 90 dB, with every kernel launched and no plain version run;
5. throughput, ``rtf_64ch_32ktap_48kHz_1chip``: audio seconds over
   device time per render, over 24 distinct signals; and the same render
   with the plain versions in place of the kernels, for comparison.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel with its launches, error and times.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

FS = 48000.0
C, N, BLOCK, RATIO = 64, 32768, 512, 8   # bench.py's headline geometry
SB = BLOCK * RATIO
T_RENDER = 6 * SB                        # one render group: Pt = 6
SEED = 0


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
        from bbcat_dsp_torch import NonUniformConvolver, ops_hook
        from bbcat_dsp_torch.ops.kernels import _build
        from bbcat_dsp_torch.ops.kernels import fused_head as k1
        from bbcat_dsp_torch.ops.kernels import half_fft as k34
        from bbcat_dsp_torch.ops.kernels import marshal as k56
        from bbcat_dsp_torch.ops.kernels import spectral_fir as k2
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
    counts = ops_hook.counts()
    y = torch.cat(ys, dim=-1).cpu().numpy()
    print(f"end to end: counts {counts}", flush=True)
    if conv.state.tail.step != sum(lengths) // SB:
        fail(f"tail step {conv.state.tail.step} != {sum(lengths) // SB}")
    for name, n in counts["launches"].items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
        results[name]["launches"] = n
    if any(counts["plain"].values()):
        fail(f"plain versions ran on the main path: {counts['plain']}")
    if y.shape != x.shape or not np.all(np.isfinite(y)):
        fail(f"output shape {y.shape} or non-finite values")
    for ch in (0, C // 2 - 1, C - 1):  # 0, 31, 63
        ref = fftconvolve(x[ch].astype(np.float64), irs[ch])[:x.shape[1]]
        s = snr_db(ref, y[ch])
        print(f"snr_db_vs_golden channel {ch}: {s:.2f} dB", flush=True)
        if not s >= 90.0:
            fail(f"channel {ch}: {s:.2f} dB < 90 against float64")

    # ---- 5. throughput -------------------------------------------------------
    audio_s = T_RENDER / FS
    xs = randn(26, C, T_RENDER)  # 2 warm-up + 24 timed, all distinct

    def render_ms():
        """Per render: back-to-back stream time over 24 renders (host
        gaps included, what a streaming caller gets) and the median
        device-only time (``median_ms``)."""
        conv.reset()
        for r in range(2):
            conv.process(xs[r])
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for r in range(24):
            conv.process(xs[2 + r])
        b.record()
        torch.cuda.synchronize()
        it = iter(range(24))
        return a.elapsed_time(b) / 24, median_ms(
            lambda: conv.process(xs[2 + next(it) % 24]), iters=23)

    plain = {"fused_head": k1.fused_head_plain,
             "rfft_half": k34.rfft_half_plain,
             "xt_grouped_mac": k2.xt_grouped_mac_plain,
             "irfft_tail": k34.irfft_tail_plain,
             "gather_supers": k56.gather_supers_plain,
             "delayed_add": k56.delayed_add_plain}
    kern = {name: getattr(ops_hook, name) for name in plain}

    rows = []
    for label in ("kernels", "plain", "plain", "kernels"):
        for name in plain:
            setattr(ops_hook, name, (kern if label == "kernels" else plain)[name])
        stream_ms, device_ms = render_ms()
        rows.append((label, stream_ms, device_ms))
        print(f"render ({label}): {stream_ms:.4f} ms/render back to back, "
              f"{device_ms:.4f} ms device-only median, "
              f"{audio_s / (stream_ms / 1e3):.2f} x real time ({card})",
              flush=True)
    for name in plain:
        setattr(ops_hook, name, kern[name])
    k_ms = statistics.mean(r[1] for r in rows if r[0] == "kernels")
    p_ms = statistics.mean(r[1] for r in rows if r[0] == "plain")
    rtf = audio_s / (k_ms / 1e3)
    print(f"rtf_64ch_32ktap_48kHz_1chip: {rtf:.2f} (kernels; plain versions "
          f"{audio_s / (p_ms / 1e3):.2f}) on {card}", flush=True)

    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
