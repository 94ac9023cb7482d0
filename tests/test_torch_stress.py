"""Long streams and fuzz on the port: the counterpart of
``tests/test_stress.py``, which catches cursor and state-carry faults that
short streams cannot show.

Each case holds the port to float64 (``golden.direct_convolve``, the
golden fractional reader) or to the same stream uninterrupted, at bars
set a few dB under what the port reads: the convolvers read 135-137 dB
against float64, so they are held at >= 130 dB, where the JAX file asks
for > 90 dB.  On the CPU the port runs its kernels' plain versions.
"""

import numpy as np
import pytest
import torch

from bbcat_dsp_tpu import golden
from bbcat_dsp_torch import (
    BlockConvolver,
    EQDelayPipeline,
    LoudnessMeter,
    NonUniformConvolver,
)
from bbcat_dsp_torch.filters import FilterType, biquad_coeffs
from bbcat_dsp_torch.utils import load_state, save_state
from conftest import snr_db


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch's CPU ops on one thread: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _decaying(rng, n, tau):
    return rng.standard_normal(n) * np.exp(-np.arange(n) / tau)


@pytest.mark.parametrize("method", ["process", "process_block"])
def test_long_stream_no_drift(rng, method):
    """1000 blocks through the uniform convolver (the queue cursor wraps
    83 times), as one render or block by block: the whole stream matches
    float64."""
    B, N, nblocks = 64, 768, 1000
    T = B * nblocks
    ir = _decaying(rng, N, 150.0)
    x = rng.standard_normal(T).astype(np.float32)
    conv = BlockConvolver(ir, block=B, device="cpu")
    if method == "process":
        y = conv.process(x).numpy()
    else:
        y = np.concatenate([conv.process_block(x[i * B:(i + 1) * B]).numpy()
                            for i in range(nblocks)])
    assert conv.state.step == nblocks
    assert snr_db(golden.direct_convolve(x, ir)[:T], y) >= 130.0


def test_many_swaps_fuzz(rng):
    """Four IR exchanges at random blocks: the stream lands on the last
    IR's steady state and no step is a click."""
    B, N, nblocks = 64, 512, 60
    irs = [rng.standard_normal(N) * 0.3 for _ in range(5)]
    swap_at = sorted(rng.choice(np.arange(5, nblocks - 12), 4, replace=False))
    x = rng.standard_normal(B * nblocks).astype(np.float32)
    conv = BlockConvolver(irs[0], block=B, nparts=N // B, device="cpu")
    cur, outs = 0, []
    for i in range(nblocks):
        if swap_at and i == swap_at[0]:
            swap_at = swap_at[1:]
            cur += 1
            conv.set_filter(irs[cur])
        outs.append(conv.process_block(x[i * B:(i + 1) * B]).numpy())
    y = np.concatenate(outs)
    ref = golden.direct_convolve(x, irs[cur])[:B * nblocks]
    settle = (nblocks - 10) * B
    assert snr_db(ref[settle:], y[settle:]) >= 130.0
    assert np.abs(np.diff(y)).max() <= 25 * np.median(np.abs(y) + 1e-9)


def test_nonuniform_long_stream(rng):
    """The tail's pending alignment survives many super-blocks: renders
    that take the whole-group path, the per-super-step path and the whole
    groups again."""
    B, ratio = 32, 4
    SB = B * ratio
    ir = _decaying(rng, 3 * SB, 120.0)
    conv = NonUniformConvolver(ir, block=B, ratio=ratio, device="cpu")
    Pt = conv.tail_parts
    T1, T2 = SB * Pt * 3, SB * (Pt + 1)
    x = rng.standard_normal(T1 + T2 + T1).astype(np.float32)
    y = np.concatenate([conv.process(x[None, a:b]).numpy()[0] for a, b in
                        ((0, T1), (T1, T1 + T2), (T1 + T2, x.size))])
    assert snr_db(golden.direct_convolve(x, ir)[:y.size], y) >= 130.0


def test_mixed_calls_on_one_stream(rng):
    """398 calls on one two-level stream, each a render of one or two
    super-blocks, a super-block or a small block in a seeded random order
    (a super-block or a render starts only where the small blocks have
    filled a super-block): the stream matches float64."""
    B, ratio = 32, 4
    SB = B * ratio
    ir = _decaying(rng, 5 * SB, 150.0)
    conv = NonUniformConvolver(ir, block=B, ratio=ratio, device="cpu")
    choice = np.random.default_rng(7)
    fill, ops = 0, []       # fill: small blocks into the super-block
    for _ in range(398):
        op = int(choice.integers(3)) if fill == 0 else 2
        n = (int(choice.integers(1, 3)) * SB, SB, B)[op]
        ops.append((op, n))
        if op == 2:
            fill = (fill + 1) % ratio
    x = rng.standard_normal(sum(n for _, n in ops)).astype(np.float32)
    calls = (conv.process, conv.process_block, conv.process_small_block)
    outs, t = [], 0
    for op, n in ops:
        outs.append(calls[op](x[None, t:t + n]).numpy()[0])
        t += n
    assert {op for op, _ in ops} == {0, 1, 2}
    y = np.concatenate(outs)
    assert snr_db(golden.direct_convolve(x, ir)[:t], y) >= 130.0


def test_meter_checkpoint_resume(tmp_path, rng):
    """The meter's state crosses a state file mid-stream: the resumed
    meter reads what the uninterrupted one reads."""
    fs = 48000.0
    x = torch.from_numpy(
        (rng.standard_normal((2, int(fs * 2))) * 0.1).astype(np.float32))
    a = LoudnessMeter(2, fs, device="cpu")
    chunk = a.step * 4
    n = x.shape[1] // chunk
    for i in range(n // 2):
        a.process(x[:, i * chunk:(i + 1) * chunk])
    p = str(tmp_path / "meter.ckpt")
    save_state(p, a.state)
    b = LoudnessMeter(2, fs, device="cpu")
    b.state = load_state(p, like=b.state)
    for m in (a, b):
        for i in range(n // 2, n):
            m.process(x[:, i * chunk:(i + 1) * chunk])
    assert abs(a.integrated() - b.integrated()) < 1e-6
    assert abs(a.short_term() - b.short_term()) < 1e-6


def test_doppler_modulated_delay(rng):
    """A delay that changes every sample (a source approaching, 20 -> 60
    samples) through ``EQDelayPipeline`` matches the golden fractional
    reader at every probed output."""
    C, B = 1, 128
    T = 2 * B
    eq = np.stack([biquad_coeffs(FilterType.FLAT, 1000, 48000.0)])
    pipe = EQDelayPipeline(eq, nchannels=C, block=B, max_delay=100.0,
                           fs=48000.0, device="cpu")
    x = rng.standard_normal((C, T)).astype(np.float32)
    delays = np.linspace(20.0, 60.0, T, dtype=np.float32).reshape(1, T)
    y = np.concatenate([pipe.process_block(x[:, :B], delays[:, :B]).numpy(),
                        pipe.process_block(x[:, B:], delays[:, B:]).numpy()],
                       -1)
    L = pipe.length
    ring = np.zeros(L)
    ring[:T] = x[0]  # the flat EQ passes the input through (b0 = 1)
    for i in (150, 200, 255):
        pos = (i - delays[0, i]) % L
        want = golden.fractional_sample(ring, 0, 1, L, float(pos))
        assert abs(y[0, i] - want) < 2e-3, i
