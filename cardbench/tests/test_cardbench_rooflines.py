"""The roofline arithmetic reproduces the kernel table's bounds at config
#5 (PERF.md: K1 679.9 MB, 14.23 GFLOP, 0.2124 ms; K2 1879.5 MB, 7.031
GFLOP, 0.5610 ms: 32 x 14 x 1024 x 4097 bytes), and a roofline share reads the least time over the
mapped kernels' device time."""

import pytest

from cardbench.core import costs, manifest, readers
from cardbench.core.trace import Slice


def test_k1_at_config_5():
    roof = manifest.load().roofline("k1_fused_head")
    nbytes, flops = roof.cost(C=1024, P=16, B=512, R=112)
    assert round(nbytes / 1e6, 1) == 679.9
    assert round(flops / 1e9, 2) == 14.23
    t, what = costs.bound_s(nbytes, flops)
    assert round(t * 1e3, 4) == 0.2124 and what == "operations"


def test_k2_at_config_5():
    roof = manifest.load().roofline("k2_xt_grouped_mac")
    nbytes, flops = roof.cost(P=14, C=1024, F=4097)
    assert nbytes == 32 * 14 * 1024 * 4097 == 1879506944
    assert round(flops / 1e9, 3) == 7.031
    t, what = costs.bound_s(nbytes, flops)
    assert round(t * 1e3, 4) == 0.5610 and what == "bytes"


class _Ctx:
    def __init__(self, sl, shapes):
        self.bench = manifest.load()
        self.slice = sl
        self.shapes = shapes
        self.kernel_functions = self.bench.kernel_functions()


def _slice(kernels, counters):
    ops, t = [], 0.0
    for name, dur in kernels:
        ops.append((name, "kernel", t, t + dur))
        t += dur
    return Slice(2, 0.0, t, ops, [], counters)


def test_a_roofline_share_is_the_least_time_over_the_mapped_kernels():
    shapes = {"k1_fused_head": {"C": 1024, "P": 16, "B": 512, "R": 112}}
    least = costs.bound_s(*manifest.load().roofline("k1_fused_head").cost(
        **shapes["k1_fused_head"]))[0]
    # two calls: 4 ms of mapped kernels, the rest is not K1's
    sl = _slice([("resident_kernel", 0.002), ("rfft_half_kernel", 0.005),
                 ("resident_kernel", 0.002)],
                {"launches": {"fused_head": 2}})
    got = readers.roofline_pct(_Ctx(sl, shapes), "k1_fused_head")
    assert got == pytest.approx(100 * 2 * least / 0.004)
    # both of the windowed schedule's kernels count
    sl = _slice([("windows_kernel", 0.001), ("mac_inverse_kernel", 0.003)],
                {"launches": {"fused_head": 1}})
    assert readers.roofline_pct(_Ctx(sl, shapes), "k1_fused_head") == \
        pytest.approx(100 * least / 0.004)


def test_a_roofline_with_nothing_to_read_is_silent_never_zero():
    shapes = {"k1_fused_head": {"C": 64, "P": 16, "B": 512, "R": 48}}
    sl = _slice([("rfft_half_kernel", 0.001)], {"launches": {"fused_head": 0}})
    assert readers.roofline_pct(_Ctx(sl, shapes), "k1_fused_head") is None
    assert readers.roofline_pct(_Ctx(sl, {}), "k1_fused_head") is None
    assert readers.roofline_pct(_Ctx(None, shapes), "k1_fused_head") is None
    assert readers.roofline_pct(_Ctx(sl, shapes), "no_such_function") is None
