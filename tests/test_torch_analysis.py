"""The port's running average and histogram against the JAX package's.

The running means come from a float32 ``cumsum`` in both packages, summed
in different orders: held at ``rtol`` 1e-5 (with an ``atol`` of 1e-6 for
means that cancel to near zero) and against float64.  A histogram's
counts, percentiles and bins are exact; its float32 sums agree to a
relative 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbcat_dsp_tpu import analysis as janalysis
from bbcat_dsp_torch import analysis
from bbcat_dsp_torch.utils.interop import (
    histogram_state_from_jax,
    running_average_state_from_jax,
)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch's CPU ops on one thread: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _means64(x, w):
    """Float64 sliding means over the last ``w`` samples (fewer at the
    start), per row of ``x [..., T]``."""
    cs = np.concatenate([np.zeros(x.shape[:-1] + (1,)),
                         np.cumsum(np.asarray(x, np.float64), -1)], -1)
    i = np.arange(x.shape[-1])
    lo = np.maximum(i + 1 - w, 0)
    return (cs[..., i + 1] - cs[..., lo]) / (i + 1 - lo)


@pytest.mark.parametrize("window,alt,shape,blocks", [
    (8, None, (), [32, 32]),
    (16, 4, (), [32]),
    (5, 2, (3,), [7, 1, 12, 40]),
    (1, None, (2,), [9, 9]),
    (64, 10, (4,), [30, 30, 100]),        # the window fills in block 3
])
def test_running_average_matches_jax(rng, window, alt, shape, blocks):
    ours = analysis.RunningAverage(window, shape, alt, device="cpu")
    theirs = janalysis.RunningAverage(window, shape, alt)
    xs = [rng.standard_normal(shape + (b,)).astype(np.float32) for b in blocks]
    got, want = [], []
    for x in xs:
        got.append(ours.write(torch.from_numpy(x)).numpy())
        want.append(np.asarray(theirs.write(jnp.asarray(x))))
        assert ours.state.count == int(theirs.state.count)
        np.testing.assert_array_equal(ours.state.tail.numpy(),
                                      np.asarray(theirs.state.tail))
        if ours._last_alt is not None:
            np.testing.assert_allclose(ours._last_alt.numpy(),
                                       np.asarray(theirs._last_alt),
                                       rtol=RTOL, atol=ATOL)
    got, want = np.concatenate(got, -1), np.concatenate(want, -1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _means64(np.concatenate(xs, -1), window),
                               rtol=RTOL, atol=ATOL)
    if shape == ():
        assert abs(ours.average() - theirs.average()) <= ATOL
        assert abs(ours.alt_average() - theirs.alt_average()) <= ATOL
    ours.reset()
    assert ours.state.count == 0 and ours._last is None


def test_running_average_started_in_jax_continues_in_the_port(rng):
    theirs = janalysis.RunningAverage(12, (2,), alt_window=3)
    theirs.write(jnp.asarray(rng.standard_normal((2, 20)).astype(np.float32)))
    ours = analysis.RunningAverage(12, (2,), alt_window=3, device="cpu")
    ours.state = running_average_state_from_jax(
        janalysis.RunningAverageState(np.asarray(theirs.state.tail),
                                      np.asarray(theirs.state.count)),
        device="cpu")
    for _ in range(3):
        x = rng.standard_normal((2, 17)).astype(np.float32)
        np.testing.assert_allclose(ours.write(torch.from_numpy(x)).numpy(),
                                   np.asarray(theirs.write(jnp.asarray(x))),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ours._last_alt.numpy(),
                                   np.asarray(theirs._last_alt), rtol=RTOL,
                                   atol=ATOL)


def _same_histogram(ours, theirs):
    np.testing.assert_array_equal(ours.counts(), theirs.counts())
    np.testing.assert_allclose(ours.sums(), theirs.sums(), rtol=1e-6,
                               atol=1e-6)
    for f in (0.0, 0.1, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert ours.percentile_index(f) == theirs.percentile_index(f)
        assert ours.percentile_data(f) == theirs.percentile_data(f)
    assert ours.mean_index() == theirs.mean_index()
    assert ours.mean_index(3, 17) == theirs.mean_index(3, 17)
    assert ours.mean_data() == pytest.approx(theirs.mean_data(), rel=1e-6)


@pytest.mark.parametrize("nbins,vmin,vmax,dist", [
    (100, 0.0, 1.0, "uniform"),
    (10, 0.0, 1.0, "wide"),         # values clamped into the end bins
    (37, -3.0, 2.5, "normal"),      # an odd width: float32 index rounding
    (64, -70.0, 10.0, "lufs"),      # the meter's histogram geometry
])
def test_histogram_matches_jax(rng, nbins, vmin, vmax, dist):
    ours = analysis.Histogram(nbins, vmin, vmax, device="cpu")
    theirs = janalysis.Histogram(nbins, vmin, vmax)
    for _ in range(3):
        if dist == "uniform":
            x = rng.uniform(0, 1, 5000)
        elif dist == "wide":
            x = rng.uniform(-5, 5, 300)
        elif dist == "normal":
            x = rng.standard_normal(4000)
        else:
            x = rng.uniform(-90, 20, (4, 500))
        x = np.r_[x.reshape(-1), vmin, vmax,
                  np.linspace(vmin, vmax, 4 * nbins + 1)]
        ours.write(x)
        theirs.write(x)
        _same_histogram(ours, theirs)
    ours.reset()
    assert ours.counts().sum() == 0


def test_histogram_write_to_file_matches_jax(tmp_path):
    ours = analysis.Histogram(4, 0.0, 4.0, device="cpu")
    theirs = janalysis.Histogram(4, 0.0, 4.0)
    x = np.array([0.5, 1.5, 1.6, 3.2, -1.0, 9.0])
    ours.write(x)
    theirs.write(x)
    ours.write_to_file(str(tmp_path / "a.dat"))
    theirs.write_to_file(str(tmp_path / "b.dat"))
    assert (tmp_path / "a.dat").read_text() == (tmp_path / "b.dat").read_text()


def test_histogram_started_in_jax_continues_in_the_port(rng):
    theirs = janalysis.Histogram(50, -1.0, 1.0)
    theirs.write(rng.uniform(-1.2, 1.2, 1000))
    ours = analysis.Histogram(50, -1.0, 1.0, device="cpu")
    ours.state = histogram_state_from_jax(
        janalysis.HistogramState(np.asarray(theirs.state.count),
                                 np.asarray(theirs.state.sum)), device="cpu")
    x = rng.uniform(-1.2, 1.2, 2000)
    ours.write(x)
    theirs.write(x)
    _same_histogram(ours, theirs)
