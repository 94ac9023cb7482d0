"""The port's WAV files and command-line tools against the JAX package's.

WAV files: the same bytes written, the same samples read, every format,
dithered or not.  The CLIs run on the CPU here (``device="cpu"``, which
the command line does not offer): the convolve tool's outputs (IR and SOFA
branches) within 2 INT24 steps of JAX's (at >= 120 dB where the tool
normalises them to full scale), the loudness tool's readings within its
printed 0.1.  Without a card the command line refuses to run.
Also the registry of versions and the profiling helpers.
"""

import json
import os
import re
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from bbcat_dsp_tpu.formats.dither import TPDFDitherer as JTPDF
from bbcat_dsp_tpu.sofa import write_sofa
from bbcat_dsp_tpu.tools import convolve_cli as jconvolve_cli
from bbcat_dsp_tpu.tools import loudness_cli as jloudness_cli
from bbcat_dsp_tpu.tools import read_wav as jread_wav
from bbcat_dsp_tpu.tools import write_wav as jwrite_wav
from bbcat_dsp_torch.formats import SampleFormat, TPDFDitherer
from bbcat_dsp_torch.tools import convolve_cli, loudness_cli, read_wav, write_wav
from bbcat_dsp_torch.utils.profiling import Timer, named_scope, trace
from test_torch_sofa import write_nc3

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMATS = [SampleFormat.INT16, SampleFormat.INT24, SampleFormat.INT32,
           SampleFormat.FLOAT, SampleFormat.DOUBLE]
INT24_STEP = 2.0 ** -23


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch's CPU ops on one thread: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dither", [False, True])
def test_wav_files_are_the_same_bytes_both_ways(tmp_path, rng, fmt, dither):
    audio = np.clip(rng.standard_normal((3, 700)) * 0.4, -1.2, 1.2).astype(
        np.float32)
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    write_wav(a, audio, 44100.0, fmt, TPDFDitherer(seed=5) if dither else None)
    jwrite_wav(b, audio, 44100.0, fmt, JTPDF(seed=5) if dither else None)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    for path in (a, b):
        ours, fs = read_wav(path)
        theirs, jfs = jread_wav(path)
        assert fs == jfs == 44100.0 and ours.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)


def test_wav_mono_and_odd_chunks_read_as_in_jax(tmp_path, rng):
    """A mono write, and a file with an odd-sized chunk before the data
    (the RIFF pad byte), read the same in both."""
    x = (rng.standard_normal(301) * 0.2).astype(np.float32)
    p = str(tmp_path / "m.wav")
    write_wav(p, x, 48000.0, SampleFormat.INT24)
    ours, _ = read_wav(p)
    assert ours.shape == (1, 301)
    with open(p, "rb") as fp:
        data = fp.read()
    extra = b"LIST" + struct.pack("<I", 3) + b"abc\x00"
    q = str(tmp_path / "q.wav")
    with open(q, "wb") as fp:
        fp.write(data[:36] + extra + data[36:])
    np.testing.assert_array_equal(read_wav(q)[0], jread_wav(q)[0])
    np.testing.assert_array_equal(read_wav(q)[0], ours)


def test_extensible_and_broken_files_are_refused_as_in_jax(tmp_path, rng):
    """Neither package reads WAVE_FORMAT_EXTENSIBLE (tag 0xFFFE), which
    most tools write for more than two channels."""
    p = str(tmp_path / "x.wav")
    write_wav(p, rng.standard_normal((4, 10)) * 0.1, 48000.0,
              SampleFormat.INT16)
    with open(p, "rb") as fp:
        data = bytearray(fp.read())
    data[20:22] = struct.pack("<H", 0xFFFE)
    with open(p, "wb") as fp:
        fp.write(data)
    for reader in (read_wav, jread_wav):
        with pytest.raises(ValueError, match="unsupported format 65534"):
            reader(p)
    (tmp_path / "n.wav").write_bytes(b"RIFX0000WAVEfmt ")
    for reader in (read_wav, jread_wav):
        with pytest.raises(ValueError, match="not a RIFF/WAVE"):
            reader(str(tmp_path / "n.wav"))


def _lines(out: str):
    """(LKFS, dBTP) of each line the loudness tool printed."""
    return [tuple(map(float, m)) for m in re.findall(
        r"integrated ([-+]\S+) LKFS, true peak ([-+]\S+) dBTP", out)]


def test_loudness_cli_matches_jax(tmp_path, rng, capsys):
    t = np.arange(3 * 48000) / 48000.0
    sine = (0.1 * np.sin(2 * np.pi * 997 * t)).astype(np.float32)
    noise = (rng.standard_normal((5, 2 * 48000)) * 0.05).astype(np.float32)
    paths = [str(tmp_path / "sine.wav"), str(tmp_path / "noise.wav")]
    write_wav(paths[0], np.stack([sine, 0.5 * sine]), 48000.0,
              SampleFormat.FLOAT)
    write_wav(paths[1], noise, 48000.0, SampleFormat.INT24)
    assert loudness_cli.main(paths, device="cpu") == 0
    ours = capsys.readouterr().out
    assert jloudness_cli.main(paths) == 0
    theirs = capsys.readouterr().out
    got, want = _lines(ours), _lines(theirs)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert abs(g[0] - w[0]) <= 0.1 and abs(g[1] - w[1]) <= 0.1
    # the rest of each line word for word
    strip = re.compile(r"integrated \S+ LKFS, true peak \S+ dBTP")
    assert strip.sub("", ours) == strip.sub("", theirs)
    assert loudness_cli.main([], device="cpu") == 2
    assert loudness_cli.main(["--help"], device="cpu") == 0


def _int24_steps(a, b) -> float:
    return float(np.abs(a.astype(np.float64) - b).max() / INT24_STEP)


@pytest.mark.parametrize("nch,n_ir,T,level", [
    (1, 64, 9000, 0.3),    # mono, as tests/test_tools.py: normalised
    (3, 700, 9000, 0.02),  # per-channel IRs, a head and a tail
    (2, 1, 5000, 0.02),    # one IR broadcast to every channel
    (2, 5000, 12288, 0.3),  # a tail of two super-blocks: normalised
])
def test_convolve_cli_ir_branch_matches_jax(tmp_path, rng, capsys, nch,
                                            n_ir, T, level):
    """Within 2 INT24 steps where the output stays below full scale; where
    the tool normalises the output to a peak of 0.999, the two float32
    renders' few ulps there come to 2-4 steps, so those are held at >= 120
    dB against JAX."""
    from conftest import snr_db

    x = (rng.standard_normal((nch, T)) * level).astype(np.float32)
    ir = (rng.standard_normal((nch if n_ir > 1 else 1, max(n_ir, 64)))
          * np.exp(-np.arange(max(n_ir, 64)) / 50.0)).astype(np.float32)
    pi, pr = str(tmp_path / "in.wav"), str(tmp_path / "ir.wav")
    po, pj = str(tmp_path / "out.wav"), str(tmp_path / "jax.wav")
    write_wav(pi, x, 48000.0, SampleFormat.FLOAT)
    write_wav(pr, ir, 48000.0, SampleFormat.FLOAT)
    timings = {}
    assert convolve_cli.main([pi, pr, po], device="cpu", timings=timings) == 0
    ours = capsys.readouterr().out
    assert jconvolve_cli.main([pi, pr, pj]) == 0
    assert ours == capsys.readouterr().out        # the same lines
    y, fs = read_wav(po)
    yj, _ = read_wav(pj)
    assert y.shape == x.shape and fs == 48000.0
    if "normalised by" in ours:
        assert level == 0.3 and snr_db(yj, y) >= 120.0
    else:
        assert level == 0.02 and _int24_steps(y, yj) <= 2.0
    assert set(timings) == {"read", "render", "write"}
    assert all(v >= 0.0 for v in timings.values())


@pytest.mark.parametrize("container", ["hdf5", "netcdf3"])
def test_convolve_cli_sofa_branch_matches_jax(tmp_path, rng, capsys,
                                              container):
    x = (rng.standard_normal((4, 2048)) * 0.1).astype(np.float32)
    ir = rng.standard_normal((8, 2, 64)) * np.exp(-np.arange(64) / 20.0)
    az = np.linspace(0, 315, 8)
    pos = np.stack([az, np.zeros(8), np.ones(8)], -1)
    pi, ps = str(tmp_path / "in.wav"), str(tmp_path / "h.sofa")
    po, pj = str(tmp_path / "out.wav"), str(tmp_path / "jax.wav")
    write_wav(pi, x, 48000.0, SampleFormat.FLOAT)
    (write_sofa if container == "hdf5" else write_nc3)(ps, ir, 48000.0, pos)
    assert convolve_cli.main([pi, ps, po], device="cpu") == 0
    ours = capsys.readouterr().out
    assert jconvolve_cli.main([pi, ps, pj]) == 0
    theirs = capsys.readouterr().out
    assert ours.startswith("binaural: 4 ch -> 2 ch via") and \
        theirs.startswith("binaural: 4 ch -> 2 ch via")
    y, fs = read_wav(po)
    yj, _ = read_wav(pj)
    assert y.shape == (2, 2048) and fs == 48000.0 and np.abs(y).max() > 0
    assert _int24_steps(y, yj) <= 2.0


def test_convolve_cli_usage(capsys):
    assert convolve_cli.main(["only", "two"], device="cpu") == 2
    assert "convolve_cli" in capsys.readouterr().out


def test_without_a_card_the_tools_refuse_to_run(tmp_path, rng):
    """The default device is the card: without one, in process and on the
    command line, the tools stop with an error and write nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot show")
    p = str(tmp_path / "in.wav")
    write_wav(p, rng.standard_normal((1, 100)) * 0.1, 48000.0)
    with pytest.raises(SystemExit, match="no CUDA device"):
        convolve_cli.main([p, p, str(tmp_path / "o.wav")])
    with pytest.raises(SystemExit, match="no CUDA device"):
        loudness_cli.main([p])
    for tool, args in (("convolve_cli", [p, p, str(tmp_path / "o.wav")]),
                       ("loudness_cli", [p])):
        r = subprocess.run(
            [sys.executable, "-m", f"bbcat_dsp_torch.tools.{tool}", *args],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert r.returncode == 1 and "no CUDA device" in r.stderr
        assert "LKFS" not in r.stdout
    assert not (tmp_path / "o.wav").exists()


def test_register_records_the_port_and_its_dependencies():
    import numpy
    import bbcat_dsp_torch

    assert bbcat_dsp_torch.register() is True
    v = bbcat_dsp_torch.loaded_versions()
    assert v == {"bbcat_dsp_torch": bbcat_dsp_torch.__version__,
                 "torch": torch.__version__,
                 "cuda": torch.version.cuda or "none",
                 "numpy": numpy.__version__}
    v["torch"] = "changed"                      # a copy, not the registry
    assert bbcat_dsp_torch.loaded_versions()["torch"] == torch.__version__


def test_timer_and_named_scope_and_trace(tmp_path):
    """``tests/test_utils.py::test_timer``'s contract, a scope's name in a
    trace, and the trace file."""
    t = Timer()
    out, per = t.time(lambda v: v * 2, torch.ones(16), iters=3)
    assert per >= 0.0 and tuple(out.shape) == (16,)
    with Timer() as w:
        sum(range(1000))
    assert w.elapsed > 0.0

    @named_scope("bbcat_scope_probe")
    def work(v):
        return (v * 3).sum()

    with trace(str(tmp_path)):
        assert float(work(torch.ones(8))) == 24.0
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "bbcat_scope_probe" for e in events)
