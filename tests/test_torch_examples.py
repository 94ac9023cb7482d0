"""The port's examples (``bbcat_dsp_torch/examples/``) on the CPU, at
reduced sizes, each with its own check kept: the IR fit's SNR, both
Doppler shifts within 0.5 %, the EQ's click check and its float64 model
(>= 90 dB), the binaural scene's WAV and netCDF-3 SOFA files read back and
its loudness against the JAX package's ``integrated_loudness`` of the same
output.  Without a card the examples refuse to run, in the process and as
``python -m``."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbcat_dsp_tpu.loudness import integrated_loudness as jax_loudness
from bbcat_dsp_torch import ops_hook
from bbcat_dsp_torch.examples import binaural_demo, doppler, fit_ir, streaming_eq
from bbcat_dsp_torch.sofa import SOFAFile
from bbcat_dsp_torch.tools.wav import read_wav
from conftest import snr_db

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = {"fit_ir": fit_ir, "doppler": doppler,
            "streaming_eq": streaming_eq, "binaural_demo": binaural_demo}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """PyTorch's CPU ops on one thread: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(*args):
    pass


def test_fit_ir_recovers_the_ir_through_the_functions():
    ops_hook.reset_counts()
    r = fit_ir.main(n_taps=128, n_blocks=8, steps=200, device="cpu",
                    log=_quiet)
    assert r["snr_db"] > 30.0 and r["rel_loss"] < 1e-3
    counts = ops_hook.counts()
    # the target, 200 steps and the final loss: K3 for the IR and the
    # signal, K7, K4 forward; their adjoints backward in every step (the
    # signal's transform needs none)
    assert counts["plain"]["head_mac"] == 202
    assert counts["adjoint"] == {**dict.fromkeys(counts["adjoint"], 0),
                                 "rfft_half": 200, "head_mac": 200,
                                 "irfft_tail": 200}


def test_doppler_shifts_within_half_a_percent(tmp_path):
    path = str(tmp_path / "d.wav")
    r = doppler.main(path, seconds=1.0, device="cpu", log=_quiet)
    for f in (r["f_delay"], r["f_asrc"]):
        assert abs(f - r["f_theory"]) / r["f_theory"] < 0.005
    audio, fs = read_wav(path)
    assert fs == 48000.0 and audio.shape == (2, 1.0 * 48000 // 512 * 512)
    assert np.array_equal(audio[0], audio[1]) and np.abs(audio).max() > 0.4


def test_streaming_eq_ramps_without_a_click_as_the_float64_bank(tmp_path):
    path = str(tmp_path / "e.wav")
    r = streaming_eq.main(path, nblocks=40, device="cpu", log=_quiet)
    assert r["ramp_slew"] <= r["program_slew"] + 1e-6
    assert r["snr_db"] >= 90.0
    mid = 20 * 512
    want = streaming_eq.reference64(r["x"], mid)
    assert snr_db(want[:, mid:mid + 2400], r["y"][:, mid:mid + 2400]) >= 90.0
    # the retarget moved the output: the ramp is not a no-op
    fixed = streaming_eq.reference64(r["x"], r["x"].shape[-1])
    assert np.abs(fixed - want)[:, mid + 2400:].max() > 1e-3
    audio, _ = read_wav(path)
    assert snr_db(r["y"], audio) >= 100.0


def test_binaural_demo_files_read_back_and_its_loudness_matches_jax(tmp_path):
    out, sofa = str(tmp_path / "b.wav"), str(tmp_path / "h.sofa")
    r = binaural_demo.main(out, seconds=1.0, sofa_path=sofa, device="cpu",
                           log=_quiet)
    ir, pos = binaural_demo.synth_hrtf(str(tmp_path / "again.sofa"))
    f = SOFAFile.open(sofa)
    assert np.array_equal(f.ir, ir) and np.array_equal(f.source_positions, pos)
    assert f.fs == 48000.0 and f.convention == "SimpleFreeFieldHRIR"
    assert np.array_equal(r["hrtf"], ir[[0, 3, 9]])     # 0, 90, 270 degrees
    y = r["y"]
    assert y.shape == (2, 48000 // 512 * 512) and np.all(np.isfinite(y))
    audio, fs = read_wav(out)
    assert fs == 48000.0
    assert snr_db(y / max(1.0, np.abs(y).max()), audio) >= 100.0
    want = float(jax_loudness(jnp.asarray(y), 48000.0))
    assert abs(r["loudness"]["integrated_lkfs"] - want) < 0.05


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_without_a_card_the_examples_refuse_to_run(tmp_path, name):
    """The default device is the card: without one the example stops with
    an error, in the process and as ``python -m``, and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot show")
    with pytest.raises(SystemExit, match="no CUDA device"):
        EXAMPLES[name].main()
    out = str(tmp_path / "o.wav")
    args = [] if name == "fit_ir" else [out]
    r = subprocess.run(
        [sys.executable, "-m", f"bbcat_dsp_torch.examples.{name}", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 1 and "no CUDA device" in r.stderr
    assert not os.path.exists(out)
