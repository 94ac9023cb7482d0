#!/usr/bin/env python3
"""Time the port's fused head (K1), head MAC (K7), tail transforms (K3,
K4), tail MAC (K2) and single-step tail MAC (K2s) on one NVIDIA GPU.

    python3 scripts/kernel_times.py                  # from the repo root
    python3 scripts/kernel_times.py --only K1 --against ../parent  # before
    python3 scripts/kernel_times.py --only K34       # K3 and K4 alone
    python3 scripts/kernel_times.py --only K2        # the tail MAC alone
    python3 scripts/kernel_times.py --only K2s       # the single step alone

Builds the CUDA kernels of ``bbcat_dsp_torch/csrc``, prints what ``ptxas``
says of the K1, K7, K3 and K4 entries (registers, spills), holds K1, K7,
K3 and K4 against their plain PyTorch versions at the paths' shapes and at
small and ragged ones (K3/K4 at every size they serve), and prints
device-only median times (CUDA events behind a spin on the stream, 20
launches) of K1 at R = 48, 8 and 1 (C = 64, P = 16, B = 512) and at BASELINE
config #5's shape (C = 1024, R = 112), each in both of its schedules (the
windowed one's two launches apart, torch.profiler), and over a sweep of C
and R about the SM count and the L2 (``K1_SWEEP``, the schedules in
turns, with the pick of ``fused_head_schedule``), of
K7 at its four path shapes, of K3 and
K4 at their four path shapes (the render's 384 rows and the super-step's
64 rows of n = 8192, the streamed block's 64 and the uniform render's 3072
rows of n = 1024) beside ``torch.fft.rfft`` and ``torch.fft.irfft`` with
the tail half copied, and of K5 beside ``permute().contiguous()``.  K2 is
held against plain at BASELINE config #5's tail (P = 14, C = 1024,
F = 4097) and the render's shape (P = 6, C = 64) at every queue cursor, at
every partition count 1 .. 16 (the register kernel, on its vector and its
one-element path) and above (the general one) and at odd ``C F``, large
shapes before small ones, each launch into memory that was filled with NaN
just before; it is timed at config #5's tail and at C = 64 for P = 6, 12
and 20 beside its bound, and ``ptxas``'s line is printed for the register
kernel at P = 6, 14 and 16 and for the general one.  K2s is held against
its plain version on the card (output, and the queue after its slot
write) at every queue type, at config #5's tail (P = 14, C = 1024,
F = 4097), at a vector and at a one-element shape, and timed at config
#5's tail with the slot write, at each queue type, beside its bound and
beside the composition the tail step ran before it (roll, two cats, the
window sums, K7 at R = 1, a copy of the queue, the slot write). It runs
on any tree that has the wrappers, so an older checkout gives the
earlier kernels' times (K2s only where the tree has it).

Each ``--define NAME=VALUE`` (comma-separated for several at once) builds
the library once more with ``-DNAME=VALUE`` and times it in turn, then the
plain build again: a way to compare values of a constant that the source
gives an ``#ifndef`` default for the length of an experiment.
``--against DIR`` builds the kernels of another checkout (an earlier
commit, unpacked with ``git archive``) and times them the same way, between
two builds of this one: a kernel's before and after from one card.  Exits
nonzero without a card or if a kernel disagrees with its plain version.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

C, P, B = 64, 16, 512
K1_SHAPES = ((C, P, B, 48), (C, P, B, 8), (C, P, B, 1), (1024, P, B, 112),
             (1, 1, 32, 1),
             (5, 6, 32, 4), (8, 6, 32, 16), (5, 1, 512, 3), (8, 16, 512, 24),
             (3, 4, 1024, 5), (3, 5, 64, 7), (3, 5, 128, 17), (2, 3, 256, 9),
             (5, 16, 512, 7), (5, 16, 512, 17), (5, 1, 512, 48),
             (2, 20, 1024, 11))
# K1 at B = 512, P = 16: (C, R) from 16 to 1024 channels, the windowed
# schedule's scratch from 4.5 MB to 538 MB; where the two schedules cross
# set the dispatch's rule
K1_SWEEP = ((64, 1), (64, 8), (64, 48), (64, 112), (64, 448), (16, 2000),
            (96, 8), (96, 48), (112, 48), (128, 8), (128, 48), (131, 48),
            (132, 1), (132, 4), (132, 8), (132, 48), (199, 48), (200, 48),
            (256, 8), (256, 48), (256, 112), (512, 48), (512, 112),
            (1024, 1), (1024, 2), (1024, 4), (1024, 8), (1024, 48),
            (1024, 112))
# (C, P, R, F, extra history slots)
K7_SHAPES = ((C, 16, 1, 513, 0), (C, 16, 8, 513, 0), (C, 6, 1, 4097, 0),
             (C, 64, 48, 513, 0), (1, 16, 1, 513, 0), (5, 16, 8, 513, 0),
             (12, 6, 1, 4097, 0), (C, 1, 3, 513, 0), (5, 3, 17, 33, 0),
             (C, 16, 1, 513, 7), (5, 7, 19, 33, 3), (3, 64, 33, 17, 0),
             (5, 20, 5, 33, 0))
# (rows' shape, n); the first four are the paths' shapes, timed; then every
# size at a single, an odd and a larger odd row count, and row counts that
# leave the last CTA of a packed launch partly empty
K34_SHAPES = (((6, C), 8192), ((C,), 8192), ((C,), 1024), ((48, C), 1024),
              ((128, C), 1024), ((128, 2), 1024), ((530,), 1024),
              ((1061,), 512), ((13,), 64), ((7,), 128), ((1059,), 128),
              *(((r,), 2 * h) for h in (8192, 32, 4096, 64, 2048, 128, 1024,
                                        256, 512) for r in (1, 5, 67)))
# (P, C, F): config #5's tail, timed; a vector and a one-element shape
K2S_SHAPES = ((14, 1024, 4097), (6, 64, 4097), (14, 3, 33))
# (P, C, F), each at every queue cursor: config #5's tail and, at C = 64,
# the render's P, a register and a general P (timed); then every P of the
# register kernel on its vector path (C F even) and on its one-element
# path (C F odd), the first general P, larger ones
K2_SHAPES = ((14, 1024, 4097), (6, C, 4097), (12, C, 4097), (20, C, 4097),
             (6, 7, 4097), (2, 8, 4097), (1, 5, 4097), (12, 8, 4097),
             *((p, 8, 257) for p in range(1, 18)),
             *((p, 5, 33) for p in range(1, 18)), (12, 5, 33),
             (20, 3, 65), (64, 2, 33), (1, 1, 33))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--define", action="append", default=[],
                    help="NAME=VALUE[,NAME=VALUE...]: one more build")
    ap.add_argument("--against", metavar="DIR",
                    help="one more build, of another checkout's kernels "
                         "(the same C interface), between two of this one")
    ap.add_argument("--only", default="K1,K7,K34,K2,K2s",
                    help="which of K1, K7, K34, K2, K2s each build runs")
    args = ap.parse_args()
    only = set(args.only.split(","))
    entries = [name for key, names in (
        ("K1", ("fused_head", "windows_kernel", "mac_inverse",
                "resident_kernel")),
        ("K7", ("head_mac",)), ("K34", ("rfft_half", "irfft_tail")),
        ("K2", ("xt_mac_unrolled_kernelILi6E",
                "xt_mac_unrolled_kernelILi14E",
                "xt_mac_unrolled_kernelILi16E", "xt_mac_general")),
        ("K2s", ("xt_step_mac",)))
        if key in only for name in names]

    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    from torch.profiler import ProfilerActivity, profile

    from bbcat_dsp_torch.ops.kernels import _build
    from bbcat_dsp_torch.ops.kernels import fused_head as k1
    from bbcat_dsp_torch.ops.kernels import half_fft as k34
    from bbcat_dsp_torch.ops.kernels import marshal as k56
    from bbcat_dsp_torch.ops.kernels import spectral_fir as k2
    from bbcat_dsp_torch.ops.kernels import spectral_mac as k79

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda")

    def snr(ref, t) -> float:
        ref = ref.double()
        noise = ((ref - t.double()) ** 2).sum().item()
        return float("inf") if noise == 0 else float(
            10 * np.log10((ref ** 2).sum().item() / noise))

    def median_ms(fn, iters: int = 20) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(4_000_000)   # the host enqueues fn behind it
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def launches_us(fn, n: int = 10) -> dict:
        """Median device time of each kernel name ``fn`` launches."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        by_name: dict[str, list] = {}
        for ev in events:
            if ev.get("cat") == "kernel":
                by_name.setdefault(ev["name"][:60], []).append(ev["dur"])
        return {k: round(statistics.median(v), 1) for k, v in by_name.items()}

    def one_build(tag: str) -> bool:
        _build.library()
        lines = _build.BUILD_LOG.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and any(
                    k in line for k in entries):
                used = " ".join(x.strip() for x in lines[i + 1:i + 4]
                                if "Used" in x or "spill" in x)
                print(f"  ptxas {line.strip()[-70:]} | {used}")
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        ok = True
        for Cc, Pp, Bb, R in K1_SHAPES if "K1" in only else ():
            F = Bb + 1
            a = (randn(Cc, R * Bb), randn(2, Pp, Cc, F), randn(2, Cc, F),
                 randn(2, Pp, Cc, F))
            want = k1.fused_head_plain(*a, Bb)
            for sched in k1.SCHEDULES:
                if (sched == "resident" and k1.resident_smem_bytes(Pp, Bb)
                        > k1._card_limits(dev)[0]):
                    continue
                run = lambda: k1.fused_head_cuda_as(sched, *a, Bb)
                got = run()
                torch.cuda.synchronize()
                s = [snr(w, g) for g, w in zip(got, want)]
                ok &= min(s) >= 110.0
                line = (f"{tag} K1 C={Cc} P={Pp} B={Bb} R={R} {sched}: "
                        + " ".join(f"{v:.1f}" for v in s) + " dB")
                if Cc in (C, 1024):
                    line += f"  {median_ms(run):.4f} ms  {launches_us(run)}"
                print(line, flush=True)
            del want
        for Cc, R in K1_SWEEP if "K1" in only else ():
            F = B + 1
            a = (randn(Cc, R * B), randn(2, P, Cc, F), randn(2, Cc, F),
                 randn(2, P, Cc, F))
            turns = {s_: [] for s_ in k1.SCHEDULES}
            for sched in (*k1.SCHEDULES, *reversed(k1.SCHEDULES)):
                turns[sched].append(median_ms(
                    lambda: k1.fused_head_cuda_as(sched, *a, B)))
            picked = k1.fused_head_schedule(Cc, P, B, R,
                                            *k1._card_limits(dev))
            print(f"{tag} K1 sweep C={Cc} R={R} scratch "
                  f"{Cc * (P + R) * (B + 1) * 8 / 1e6:.1f} MB: "
                  + ", ".join(f"{k} " + " / ".join(f"{t:.4f}" for t in v)
                              for k, v in turns.items())
                  + f" ms; picks {picked}", flush=True)
        for Cc, Pp, R, F, extra in K7_SHAPES if "K7" in only else ():
            a = (randn(2, Pp + R + extra, Cc, F), randn(2, Pp, Cc, F))
            got = k79.head_mac_cuda(*a, R)
            torch.cuda.synchronize()
            s = snr(k79.head_mac_plain(*a, R), got)
            ok &= s >= 120.0
            line = (f"{tag} K7 C={Cc} P={Pp} R={R} F={F} extra={extra}: "
                    f"{s:.1f} dB")
            if Cc == C:
                line += f"  {median_ms(lambda: k79.head_mac_cuda(*a, R)):.4f} ms"
            print(line, flush=True)
        worst = []   # of the shapes that are not timed, one line in all
        for i, (lead, n) in enumerate(K34_SHAPES if "K34" in only else ()):
            h = n // 2
            x, X = randn(*lead, h), randn(2, *lead, h + 1)
            got = (k34.rfft_half_cuda(x, n), k34.irfft_tail_cuda(X, n))
            torch.cuda.synchronize()
            s = [snr(w, g) for g, w in zip(got, (k34.rfft_half_plain(x, n),
                                                 k34.irfft_tail_plain(X, n)))]
            ok &= min(s) >= 110.0
            line = f"{tag} K3/K4 rows={lead} n={n}: {s[0]:.1f} {s[1]:.1f} dB"
            if i < 4:
                Xc = torch.complex(X[0], X[1])
                line += (
                    f"  K3 {median_ms(lambda: k34.rfft_half_cuda(x, n)):.4f}"
                    f" ms (rfft {median_ms(lambda: torch.fft.rfft(x, n=n)):.4f})"
                    f"  K4 {median_ms(lambda: k34.irfft_tail_cuda(X, n)):.4f}"
                    " ms (irfft, tail copied "
                    f"{median_ms(lambda: torch.fft.irfft(Xc, n=n)[..., h:].contiguous()):.4f})")
            elif min(s) >= 110.0:
                worst.append(min(s))
                continue
            print(line, flush=True)
        if worst:
            print(f"{tag} K3/K4 at {len(worst)} more shapes: >= "
                  f"{min(worst):.1f} dB", flush=True)
        for Pp, Cc, F in K2_SHAPES if "K2" in only else ():
            shape = (2, Pp, Cc, F)
            low = []
            for slot0 in range(Pp):
                a = (randn(*shape), randn(*shape), randn(*shape))
                poison = torch.full(shape, float("nan"), device=dev)
                del poison          # the launch's output lands on it
                got = k2.xt_grouped_mac_cuda(*a, slot0)
                torch.cuda.synchronize()
                low.append(snr(k2.xt_grouped_mac_plain(*a, slot0), got))
            ok &= min(low) >= 110.0   # NaN compares false
            path = ("unrolled" if Pp <= _build.library()
                    .bbcat_xt_unrolled_parts() else "general")
            line = (f"{tag} K2 P={Pp} C={Cc} F={F} ({path}), slot0 = 0 .. "
                    f"{Pp - 1}: >= {min(low):.1f} dB")
            if Cc in (C, 1024):
                nbytes = 4 * 8.0 * Pp * Cc * F
                line += (f"  {median_ms(lambda: k2.xt_grouped_mac_cuda(*a, 0)):.4f}"
                         f" ms at slot0 = 0, "
                         f"{median_ms(lambda: k2.xt_grouped_mac_cuda(*a, 3)):.4f}"
                         f" at 3; bound {nbytes / 3.35e9:.4f} ms "
                         f"({nbytes / 1e6:.1f} MB over 3.35 TB/s)")
            print(line, flush=True)
        for Pp, Cc, F in (K2S_SHAPES if "K2s" in only
                          and hasattr(k79, "xt_step_mac_cuda") else ()):
            for dt in (torch.float32, torch.bfloat16, torch.float16):
                q = randn(2, Pp, Cc, F).to(dt)
                xt, H = randn(2, Cc, F), randn(2, Pp, Cc, F)
                slot = Pp // 2
                want_q = q.clone()
                want = k79.xt_step_mac_plain(want_q, xt, H, slot, True)
                got = k79.xt_step_mac_cuda(q, xt, H, slot, True)
                torch.cuda.synchronize()
                s = snr(want, got)
                same = bool(torch.equal(q, want_q))
                ok &= s >= 110.0 and same
                line = (f"{tag} K2s P={Pp} C={Cc} F={F} {dt}, slot {slot}: "
                        f"{s:.1f} dB, queue after "
                        f"{'equal' if same else 'DIFFERENT'}")
                if Cc == 1024:
                    # the queue read and its slot written; H, xt, out
                    nbytes = (2 * (Pp + 1) * Cc * F * q.element_size()
                              + 4 * (2 * Pp + 4) * Cc * F)
                    if dt == torch.float32:
                        sg = torch.ones(F, device=dev)
                        sg[1::2] = -1.0

                        def before():
                            t = torch.cat([torch.roll(q, -slot, dims=1),
                                           xt[:, None]], dim=1)
                            w = t[:, :-1] + sg * t[:, 1:]
                            ext = torch.cat([torch.zeros_like(w[:, :1]), w],
                                            1)
                            k79.head_mac_cuda(ext, H, 1)
                            q2 = q.clone()
                            q2[:, slot] = xt

                        line += f"; before K2s {median_ms(before):.4f} ms"
                    line += (f"; {median_ms(lambda: k79.xt_step_mac_cuda(q, xt, H, slot, True)):.4f}"
                             f" ms with the slot write, bound "
                             f"{nbytes / 3.35e9:.4f} ms ({nbytes / 1e6:.1f} "
                             f"MB over 3.35 TB/s)  "
                             f"{launches_us(lambda: k79.xt_step_mac_cuda(q, xt, H, slot, True))}")
                print(line, flush=True)
                del q, xt, H, want_q
        return ok

    base, here = list(_build.NVCC_FLAGS), _build.CSRC_DIR
    builds = [([], here)] + [([f"-D{d}" for d in spec.split(",")], here)
                             for spec in args.define]
    if args.against:
        builds.append(([], Path(args.against).resolve()
                       / "bbcat_dsp_torch" / "csrc"))
    if len(builds) > 1:
        builds.append(([], here))
    ok = True
    for flags, csrc in builds:
        _build._LIB = None
        _build.NVCC_FLAGS[:] = base + flags
        _build.CSRC_DIR = csrc
        _build.BUILD_LOG = ""   # a build that exists prints no ptxas lines
        tag = (" ".join(flags) or "default") if csrc == here else "against"
        print(f"=== build {flags or 'as committed'} of {csrc} ({card})",
              flush=True)
        ok &= one_build(tag)
    _build.CSRC_DIR = here

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    xs = torch.randn((C, 6 * 4096), generator=gen, device=dev)
    print(f"K5 {median_ms(lambda: k56.gather_supers_cuda(xs, 6)):.4f} ms, "
          "permute().contiguous() "
          f"{median_ms(lambda: xs.reshape(C, 6, 4096).permute(1, 0, 2).contiguous()):.4f}")
    print("OK" if ok else "FAIL: a kernel disagrees with its plain version")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
