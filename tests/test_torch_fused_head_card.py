"""The fused head's (K1) resident schedule on a card, and the schedule
its wrapper runs.

On the CPU: ``fused_head_cuda`` launches the schedule
``fused_head_schedule`` picks from the shape and the card's limits (both
stubbed), and the plain version counts no launch.

On a card (marked ``card``; they skip without one): the kernel through
``ops_hook.fused_head`` against ``fused_head_plain`` on the card at config
#5's render (C = 1024, P = 16, B = 512, R = 112), at one tile (R = 8), at
ragged R with C not a multiple of the SM count, and at B = 1024, each over
two chained calls (the second from the first one's carries on each side),
with the launch count after each call.  The file imports neither JAX nor
the suite's ``conftest.py``, so on a machine without JAX it runs as
``python -m pytest --noconftest tests/test_torch_fused_head_card.py``.
"""

import numpy as np
import pytest
import torch

from bbcat_dsp_torch import ops_hook
from bbcat_dsp_torch.ops.kernels import _build
from bbcat_dsp_torch.ops.kernels import fused_head as k1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda:0")


def _snr_db(ref, test) -> float:
    ref = ref.detach().double().cpu()
    noise = ((ref - test.detach().double().cpu()) ** 2).sum().item()
    return float("inf") if noise == 0 else float(
        10 * np.log10((ref ** 2).sum().item() / noise))


def test_the_wrapper_launches_the_rules_pick(monkeypatch):
    # an H100's opt-in shared memory a CTA and SMs
    limits = (232448, 132)
    picked = []
    monkeypatch.setattr(_build, "require_cuda",
                        lambda **t: torch.device("cuda", 0))
    monkeypatch.setattr(k1, "_card_limits", lambda device: limits)
    monkeypatch.setattr(k1, "_launch",
                        lambda schedule, *args: picked.append(schedule))
    P, B = 16, 512
    F = B + 1
    for C, R, want in ((1024, 112, "resident"),  # config #5's render
                       (64, 112, "windowed")):   # fewer channels than SMs
        args = [torch.empty(s, device="meta") for s in
                ((C, R * B), (2, P, C, F), (2, C, F), (2, P, C, F))]
        k1.fused_head_cuda(*args, B)
        assert picked[-1] == k1.fused_head_schedule(C, P, B, R,
                                                    *limits) == want
    assert len(picked) == 2


def test_the_plain_version_counts_no_schedule():
    gen = torch.Generator().manual_seed(23)
    C, P, B, R = 2, 3, 32, 5
    F = B + 1
    args = [torch.randn(s, generator=gen) for s in
            ((C, R * B), (2, P, C, F), (2, C, F), (2, P, C, F))]
    ops_hook.reset_counts()
    ops_hook.fused_head(*args, B)
    counts = ops_hook.counts()
    assert counts["plain"]["fused_head"] == 1
    assert counts["launches"]["fused_head"] == 0
    ops_hook.reset_counts()


@pytest.mark.card
@pytest.mark.parametrize("C,P,B,R", [
    (1024, 16, 512, 112),  # config #5's render: 14 tiles
    (1024, 16, 512, 8),    # its streaming super-step: one tile
    (133, 16, 512, 9),     # one SM with two channels, a block past a tile
    (1000, 16, 512, 113),  # a ragged last tile
    (200, 9, 1024, 57),    # B = 1024: tiles of 2, the last ragged
])
def test_resident_kernel_matches_plain_over_two_calls(card, C, P, B, R):
    assert k1.fused_head_schedule(C, P, B, R,
                                  *k1._card_limits(card)) == "resident"
    gen = torch.Generator(device=card).manual_seed(C * 1000 + R)
    F = B + 1

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=card)

    H = randn(2, P, C, F)
    kernel = plain = (randn(2, P, C, F), randn(2, C, F))
    ops_hook.reset_counts()
    for call in (1, 2):
        x = randn(C, R * B)
        got = ops_hook.fused_head(x, *kernel, H, B)
        want = k1.fused_head_plain(x, *plain, H, B)
        torch.cuda.synchronize(card)
        for name, g, w in zip(("y", "xcarry_out", "prev_out"), got, want):
            assert g.shape == w.shape
            assert _snr_db(w, g) >= 110.0, (name, call)
        assert ops_hook.counts()["launches"]["fused_head"] == call
        kernel, plain = got[1:], want[1:]
    ops_hook.reset_counts()


@pytest.mark.card
def test_a_windowed_call_counts_as_windowed(card):
    gen = torch.Generator(device=card).manual_seed(64)
    C, P, B, R = 64, 16, 512, 8   # fewer channels than SMs
    assert k1.fused_head_schedule(C, P, B, R,
                                  *k1._card_limits(card)) == "windowed"
    F = B + 1
    args = [torch.randn(s, generator=gen, device=card) for s in
            ((C, R * B), (2, P, C, F), (2, C, F), (2, P, C, F))]
    ops_hook.reset_counts()
    got = ops_hook.fused_head(*args, B)
    want = k1.fused_head_plain(*args, B)
    torch.cuda.synchronize(card)
    assert min(_snr_db(w, g) for g, w in zip(got, want)) >= 110.0
    assert ops_hook.counts()["launches"]["fused_head"] == 1
    ops_hook.reset_counts()
