"""The tail MAC (K2) on a card, and which of its kernels serves a shape.

On a card (marked ``card``; they skip without one): the kernel through
``ops_hook.xt_grouped_mac`` against ``xt_grouped_mac_plain`` on the card at
BASELINE config #5's tail (P = 14, C = 1024, F = 4097) at three queue
cursors, at the register kernel's last P and the general kernel's first,
at the render's P = 6, on the one-element path (``C F`` odd, or a plane
off the vector boundary), each launch into memory just filled with NaN,
with one launch counted a call and the kernel that ran named by the
profiler.  The file imports neither JAX nor the suite's ``conftest.py``,
so on a machine without JAX it runs as
``python -m pytest --noconftest tests/test_torch_xt_grouped_mac_card.py``.
"""

import numpy as np
import pytest
import torch

from bbcat_dsp_torch import ops_hook
from bbcat_dsp_torch.ops.kernels import spectral_fir as k2


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


def _kernel_names(fn) -> list:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if "xt_mac" in e.key]


def _kernel(P, N, vec_ok=True) -> str:
    """The name the trace gives the kernel that serves the shape."""
    if P > k2.XT_UNROLLED_PARTS:
        return "xt_mac_general_kernel"
    V = k2.XT_VEC if N % k2.XT_VEC == 0 and vec_ok else 1
    return f"xt_mac_unrolled_kernel<{P}, {V}>"


@pytest.mark.card
@pytest.mark.parametrize("P,C,F,slot0,offset", [
    (14, 1024, 4097, 0, 0),    # config #5's render: every call
    (14, 1024, 4097, 7, 0),
    (14, 1024, 4097, 13, 0),
    (16, 64, 4097, 5, 0),      # the register kernel's last P
    (17, 64, 4097, 16, 0),     # the general kernel's first
    (6, 64, 4097, 3, 0),       # the render's P
    (14, 5, 33, 9, 0),         # C F odd: one element a thread
    (14, 8, 257, 2, 1),        # planes one float off the vector boundary
])
def test_xt_grouped_mac_matches_plain_on_the_card(card, P, C, F, slot0,
                                                  offset):
    gen = torch.Generator(device=card).manual_seed(P * 100000 + C + slot0)
    shape = (2, P, C, F)
    n = int(np.prod(shape))

    def operand():
        buf = torch.randn(n + offset, generator=gen, device=card)
        return buf[offset:].view(shape)

    q, xt, H = operand(), operand(), operand()
    want = k2.xt_grouped_mac_plain(q, xt, H, slot0)
    poison = torch.full(shape, float("nan"), device=card)
    ptr = poison.data_ptr()
    del poison                 # the launch's output takes this block
    ops_hook.reset_counts()
    got = ops_hook.xt_grouped_mac(q, xt, H, slot0)
    torch.cuda.synchronize(card)
    assert got.data_ptr() == ptr
    assert bool(torch.isfinite(got).all())        # every element written
    assert _snr_db(want, got) >= 110.0
    counts = ops_hook.counts()
    assert counts["launches"]["xt_grouped_mac"] == 1
    assert counts["plain"]["xt_grouped_mac"] == 0
    names = _kernel_names(lambda: ops_hook.xt_grouped_mac(q, xt, H, slot0))
    want_name = _kernel(P, C * F, vec_ok=offset % k2.XT_VEC == 0)
    assert len(names) == 1 and want_name in names[0], names
    ops_hook.reset_counts()
