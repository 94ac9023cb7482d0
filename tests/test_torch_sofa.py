"""The port's SOFA reader and writer against the JAX package's.

HDF5 files (written by either package) and classic netCDF-3 files read
into equal arrays in both packages, ``nearest`` picks the same
measurements, and the HRTF matrix of a file renders in the port's
``BinauralRenderer`` as in the JAX one.  Without ``h5py`` an HDF5 file
raises an ``ImportError`` that names it and a netCDF-3 file still reads.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from bbcat_dsp_tpu.models import BinauralRenderer as JRenderer
from bbcat_dsp_tpu.sofa import SOFAFile as JSOFAFile
from bbcat_dsp_tpu.sofa import write_sofa as jwrite_sofa
from bbcat_dsp_torch import BinauralRenderer
from bbcat_dsp_torch.sofa import SOFAFile, write_sofa
from conftest import snr_db


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch's CPU ops on one thread: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _irs(rng, M=12, R=2, N=128):
    ir = rng.standard_normal((M, R, N)) * np.exp(-np.arange(N) / 30.0)
    az = np.linspace(0, 360, M, endpoint=False)
    el = np.resize([0.0, 15.0, -15.0], M)
    return ir, np.stack([az, el, np.full(M, 1.2)], -1)


def write_nc3(path, ir, fs, pos):
    """A classic netCDF-3 SimpleFreeFieldHRIR file, as
    ``tests/test_sofa.py`` writes one."""
    M, R, N = ir.shape
    with netcdf_file(path, "w") as f:
        for name, n in (("M", M), ("R", R), ("N", N), ("I", 1), ("C", 3)):
            f.createDimension(name, n)
        f.createVariable("Data.IR", "d", ("M", "R", "N"))[:] = ir
        f.createVariable("Data.SamplingRate", "d", ("I",))[:] = [fs]
        f.createVariable("SourcePosition", "d", ("M", "C"))[:] = pos
        f.SOFAConventions = "SimpleFreeFieldHRIR"


def _same(a, b):
    for name in ("ir", "delay", "source_positions", "listener_position"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.fs == b.fs and a.convention == b.convention
    assert a.attributes == b.attributes
    assert (a.n_measurements, a.n_receivers, a.n_samples) == \
        (b.n_measurements, b.n_receivers, b.n_samples)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_hdf5_files_read_the_same_in_both_packages(tmp_path, rng, writer):
    ir, pos = _irs(rng)
    p = str(tmp_path / "h.sofa")
    (write_sofa if writer == "port" else jwrite_sofa)(p, ir, 44100.0, pos)
    ours, theirs = SOFAFile.open(p), JSOFAFile.open(p)
    _same(ours, theirs)
    np.testing.assert_array_equal(ours.ir, ir)
    np.testing.assert_array_equal(ours.source_positions, pos)
    assert ours.fs == 44100.0


def test_the_two_writers_write_the_same_arrays(tmp_path, rng):
    ir, pos = _irs(rng, M=5, N=32)
    a, b = str(tmp_path / "a.sofa"), str(tmp_path / "b.sofa")
    write_sofa(a, ir, 48000.0, pos, convention="GeneralFIR")
    jwrite_sofa(b, ir, 48000.0, pos, convention="GeneralFIR")
    _same(SOFAFile.open(a), SOFAFile.open(b))
    write_sofa(a, ir, 48000.0)                      # default positions
    assert not SOFAFile.open(a).source_positions.any()


def test_netcdf3_files_read_the_same_in_both_packages(tmp_path, rng):
    ir, pos = _irs(rng, M=6, N=64)
    p = str(tmp_path / "classic.sofa")
    write_nc3(p, ir, 44100.0, pos)
    ours = SOFAFile.open(p)
    _same(ours, JSOFAFile.open(p))
    np.testing.assert_array_equal(ours.ir, ir)
    assert ours.fs == 44100.0


def test_nearest_and_hrtf_matrix_match_jax(tmp_path, rng):
    ir, pos = _irs(rng, M=24)
    p = str(tmp_path / "n.sofa")
    write_nc3(p, ir, 48000.0, pos)
    ours, theirs = SOFAFile.open(p), JSOFAFile.open(p)
    dirs = [(az, el) for az in np.linspace(-180, 540, 49)
            for el in (-40.0, 0.0, 7.0, 20.0)]
    assert [ours.nearest(*d) for d in dirs] == [theirs.nearest(*d)
                                               for d in dirs]
    mixed = [(30.0, 0.0), 3, np.int64(7), (359.0, 14.0)]
    np.testing.assert_array_equal(ours.hrtf_matrix(mixed),
                                  theirs.hrtf_matrix(mixed))
    np.testing.assert_array_equal(ours.impulse_response(5),
                                  theirs.impulse_response(5))


def test_not_a_sofa_file_is_refused(tmp_path):
    p = tmp_path / "x.sofa"
    p.write_bytes(b"RIFF0000WAVE")
    with pytest.raises(ValueError, match="neither HDF5 nor netCDF"):
        SOFAFile.open(str(p))
    with pytest.raises(ValueError, match="missing Data.IR"):
        SOFAFile({"attrs": {}, "vars": {}})


def test_without_h5py_hdf5_raises_an_import_error_naming_it(tmp_path, rng,
                                                            monkeypatch):
    """Where h5py is not installed, an HDF5 file and ``write_sofa`` raise
    an ImportError that names it; a netCDF-3 file still reads."""
    ir, pos = _irs(rng, M=4, N=16)
    h5, nc3 = str(tmp_path / "h.sofa"), str(tmp_path / "c.sofa")
    write_sofa(h5, ir, 48000.0, pos)
    write_nc3(nc3, ir, 48000.0, pos)
    monkeypatch.setitem(sys.modules, "h5py", None)   # import h5py now fails
    with pytest.raises(ImportError, match="h5py"):
        SOFAFile.open(h5)
    with pytest.raises(ImportError, match="h5py"):
        write_sofa(str(tmp_path / "w.sofa"), ir, 48000.0)
    np.testing.assert_array_equal(SOFAFile.open(nc3).ir, ir)


def test_sofa_hrtfs_render_as_in_jax(tmp_path, rng):
    """A file's HRTF matrix through both packages' ``BinauralRenderer``:
    >= 90 dB against the float64 sum of direct convolutions, and against
    each other."""
    ir, pos = _irs(rng, M=8, N=64)
    p = str(tmp_path / "r.sofa")
    write_nc3(p, ir, 48000.0, pos)
    hm = SOFAFile.open(p).hrtf_matrix([(0.0, 0.0), (90.0, 0.0), (180.0, 0.0)])
    B, T = 64, 64 * 4
    x = rng.standard_normal((3, T)).astype(np.float32)
    r, jr = BinauralRenderer(hm, block=B, device="cpu"), JRenderer(hm, block=B)
    y = torch.cat([r.process_block(torch.from_numpy(x[:, i * B:(i + 1) * B]))
                   for i in range(T // B)], -1).numpy()
    yj = np.concatenate([np.asarray(jr.process_block(
        jnp.asarray(x[:, i * B:(i + 1) * B]))) for i in range(T // B)], -1)
    for o in range(2):
        ref = sum(np.convolve(x[i].astype(np.float64), hm[i, o])[:T]
                  for i in range(3))
        assert snr_db(ref, y[o]) > 90.0
        assert snr_db(yj[o], y[o]) > 100.0
