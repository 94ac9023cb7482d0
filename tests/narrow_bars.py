"""The bars of ``chip_smoke.py`` phase 17 (the dtype surface at full
width): the JAX package's own narrow output on phase 17's inputs against
the same float64 references, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/narrow_bars.py

For each part and dtype it runs the JAX package compiled and, where the
part does narrow arithmetic, operation by operation (``jax.disable_jit``:
its types' own semantics, which the port follows; compiled, XLA:CPU keeps
some narrow values wider, ``tests/test_torch_narrow.py``), takes the lower
SNR of the two and prints it less 1 dB, as ``NARROW_BARS`` holds it; for
the meter, JAX's integrated loudness error against a float64 gating plus
0.01 LU (``NARROW_LU``).  The card machine has no JAX, so the bars are
fixed in the script beforehand.  Full width: a few minutes and about 3
GB on the CPU.
"""

import json
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from bbcat_dsp_torch.filters import FilterType, biquad_coeffs  # noqa: E402
from bbcat_dsp_tpu.convolve import NonUniformConvolver  # noqa: E402
from bbcat_dsp_tpu.convolve.fft import resolve_spectral_spec  # noqa: E402
from bbcat_dsp_tpu.filters.fractional import FractionalDelayLine  # noqa: E402
from bbcat_dsp_tpu.loudness import LoudnessMeter  # noqa: E402
from bbcat_dsp_tpu.models import (BinauralRenderer, EQDelayPipeline,  # noqa: E402
                                  MixdownPipeline)


def peq(f, gain):
    return biquad_coeffs(FilterType.PEQ, f, cs.FS, gain=gain)


def f64(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def spec(n):
    return resolve_spectral_spec(n, backend="xla", probe=False,
                                 layout="std")._replace(
        mac="0", fused_head="0", permfft="0")


def both(run):
    """``run()`` compiled and operation by operation: the lower value."""
    compiled = run()
    with jax.disable_jit():
        op_by_op = run()
    return min(compiled, op_by_op), compiled, op_by_op


def part_a(inp, jdt):
    a = inp["a"]
    conv = NonUniformConvolver(a["h1"], cs.BLOCK, cs.RATIO, dtype=jdt,
                               spectral=(spec(2 * cs.BLOCK), spec(2 * cs.SB)))
    ys = []
    for j in range(cs.NSUP17):
        if j == cs.SW_ALL:
            conv.set_filter(a["h2"])
        if j == cs.SW_ONE:
            conv.set_filter(a["h3"], channel=cs.C // 2 - 1)
        ys.append(f64(conv.process_block(
            jnp.asarray(a["x"][:, j * cs.SB:(j + 1) * cs.SB]))))
    y = np.concatenate(ys, -1)
    return min(cs.snr_db(cs.two_level_model(a["x"], a["h1"], a["h2"],
                                            a["h3"], ch, cs.C // 2 - 1),
                         y[ch]) for ch in cs.CHECKED)


def part_b(inp, jdt):
    b = inp["b"]

    def run():
        rend = BinauralRenderer(b["h1"], cs.BLOCK, eq_stages=[b["eq"]],
                                fs=cs.FS, dtype=jdt)
        ys = []
        for i in range(cs.NB17):
            if i == cs.SW17:
                rend.set_hrtf(b["h2"])
            ys.append(f64(rend.process_block(jnp.asarray(
                b["x"][:, i * cs.BLOCK:(i + 1) * cs.BLOCK]))))
        y = np.concatenate(ys, -1)
        ref = cs.binaural_model(b["x"], b["eq"], b["h1"], b["h2"])
        return min(cs.snr_db(ref[o], y[o]) for o in range(2))

    return both(run)


def part_c(inp, jdt, stages, delays, nblk):
    c = inp["c"]

    def run():
        pipe = EQDelayPipeline(stages, cs.C17, cs.B17, 256.0, cs.FS, jdt)
        ys = []
        for i in range(nblk):
            d = (delays[:, i * cs.B17:(i + 1) * cs.B17] if delays.ndim > 1
                 else delays)
            ys.append(f64(pipe.process_block(jnp.asarray(
                c["x"][:, i * cs.B17:(i + 1) * cs.B17]), d)))
        y = np.concatenate(ys, -1)
        n = nblk * cs.B17
        ref = cs.delayed64(cs.cascade64(c["x"][:, :n], stages),
                           delays[..., :n] if delays.ndim > 1 else delays,
                           pipe.length, cs.B17)
        return min(cs.snr_db(r, t) for r, t in zip(ref, y))

    return both(run)


def part_c_line(inp, jdt):
    c = inp["c"]
    L, blk = c["xs"].shape[1], 1024

    def run():
        line = FractionalDelayLine(cs.C, L, jdt)
        out = []
        for k in range(c["xs"].shape[1] // blk):
            line.write(jnp.asarray(c["xs"][:, k * blk:(k + 1) * blk]))
            out.append(f64(line.read(jnp.asarray(c["ds"]))))
        y = np.concatenate(out, -1)
        ref = cs.fractional_reference(c["xs"], c["ds"], L, blk)
        return min(cs.snr_db(r, t) for r, t in zip(ref, y))

    return both(run)


def part_d(inp, jdt):
    d = inp["d"]
    want = cs.meter_reference(d["x"])

    def run():
        m = LoudnessMeter(cs.C4_17, cs.FS, dtype=jdt)
        m.process(jnp.asarray(d["x"]))
        return -abs(m.integrated() - want)

    worst, _, _ = both(run)
    mix = MixdownPipeline(d["gains"], cs.FS, dtype=jdt)
    y = f64(mix.process_block(jnp.asarray(d["x"])))
    ref = d["gains"] @ d["x"].astype(np.float64)
    return -worst, min(cs.snr_db(r, t) for r, t in zip(ref, y))


def main():
    inp = cs.phase17_inputs(peq)
    c = inp["c"]
    bars, lu, seen = {}, {}, {}
    for name, jdt in (("bfloat16", jnp.bfloat16), ("float16", jnp.float16)):
        got = {"a": (part_a(inp, jdt),) * 3, "b": part_b(inp, jdt),
               "c stream": part_c(inp, jdt, c["eq"], c["steady"],
                                  cs.NBLK17),
               "c gather": part_c(inp, jdt, c["eq"], c["glide"], cs.NBLK17),
               "c modal": part_c(inp, jdt, c["twice"], c["steady"], 4),
               "c line": part_c_line(inp, jdt)}
        err, mix = part_d(inp, jdt)
        got["d mixdown"] = (mix,) * 3
        seen[name] = {k: [round(v, 2) for v in t] for k, t in got.items()}
        seen[name]["d integrated error LU"] = round(err, 4)
        bars[name] = {k: math.floor(100 * (t[0] - 1.0)) / 100
                      for k, t in got.items()}
        lu[name] = math.ceil(1e4 * (err + 0.01)) / 1e4
    print(json.dumps({"measured (lower, compiled, op by op)": seen},
                     indent=1))
    print("NARROW_BARS =", json.dumps(bars))
    print("NARROW_LU =", json.dumps(lu))


if __name__ == "__main__":
    main()
