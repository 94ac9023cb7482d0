"""The metric readers on synthetic timelines: the idle union with
overlapping kernels, launches and busy time over the calls, the breakdown,
the p99 of latencies taken from due times in an open loop, and ``rtf``
over the whole window."""

import time

import numpy as np
import pytest
import torch

from cardbench.core import manifest, trace
from cardbench.core.cell import Context, Run


def _x(cat, name, ts_us, dur_us, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us,
            "tid": tid, "pid": 0}


EVENTS = [
    # two calls of the benchmark's span on the host thread
    _x("user_annotation", "cardbench.render", 100, 50),
    _x("cpu_op", "aten::cat", 110, 20),
    _x("cuda_runtime", "cudaLaunchKernel", 115, 3),
    _x("user_annotation", "cardbench.render", 200, 40),
    _x("cpu_op", "aten::add", 205, 10),
    # device: overlapping kernels on two streams, a copy, and a kernel
    # that ends before the first call and is left out
    _x("kernel", "void (anonymous namespace)::windows_kernel<512>(float const*)",
       120, 30, tid=7),
    _x("kernel", "void (anonymous namespace)::mac_inverse_kernel<512>(float2 const*)",
       140, 20, tid=8),
    _x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 210, 10, tid=7),
    _x("kernel", "void at::native::vectorized_elementwise_kernel<4, X>(int)",
       225, 35, tid=7),
    _x("kernel", "early_kernel", 10, 5, tid=7),
]


def _slice():
    return trace.parse(EVENTS, "cardbench.render", 2,
                       {"launches": {"fused_head": 2}})


def test_kernel_base_names():
    assert trace.kernel_base_name(
        "void (anonymous namespace)::resident_kernel<512>(float const*, int)"
    ) == "resident_kernel"
    assert trace.kernel_base_name(
        "void at::native::(anonymous namespace)::CatArrayBatchedCopy_"
        "vectorized<float, 4>(X)") == "CatArrayBatchedCopy_vectorized"
    assert trace.kernel_base_name("xt_mac_general_kernel(float const*)") == \
        "xt_mac_general_kernel"


def test_the_idle_union_counts_overlapping_kernels_once():
    sl = _slice()
    # span: first call's start (100 us) to the last device op's end (260)
    assert sl.lo == pytest.approx(100e-6) and sl.hi == pytest.approx(260e-6)
    # busy: [120, 160) + [210, 220) + [225, 260) = 85 us
    assert sl.busy_s == pytest.approx(85e-6)
    assert len(sl.kernels) == 3            # the copy is no launch
    assert trace.covered([(0, 2), (1, 3), (5, 6)], 0.5, 5.5) == \
        pytest.approx(3.0)
    assert trace.gaps([(1, 2), (1.5, 3)], 0, 4) == [(0, 1), (3, 4)]


def test_the_breakdown_ranks_device_ops_and_splits_idle_by_host_op():
    b = _slice().breakdown()
    names = [n for n, _ in b["device_ops"]]
    assert names[0] == "vectorized_elementwise_kernel"
    assert set(names) == {"windows_kernel", "mac_inverse_kernel",
                          "Memcpy DtoD (Device -> Device)",
                          "vectorized_elementwise_kernel"}
    idle = dict(b["idle_gaps"])
    assert sum(idle.values()) == pytest.approx((160 - 85) * 1e-6)
    # gap [100, 120): the span alone to 110, cat to 115, its launch to
    # 118, cat again; gap [160, 210): no op to 200 (the first span ended
    # at 150), the second span to 205, add; gap [220, 225): the span
    assert idle["aten::cat"] == pytest.approx(7e-6)
    assert idle["cudaLaunchKernel"] == pytest.approx(3e-6)
    assert idle["aten::add"] == pytest.approx(5e-6)
    assert idle["cardbench.render"] == pytest.approx(20e-6)
    assert idle[trace.NO_HOST_OP] == pytest.approx(40e-6)
    assert all(len(x) == 2 for x in b["device_ops"] + b["idle_gaps"])


def _ctx(window=None, sl=None, setup_s=1.5):
    return Context(manifest.load(), setup_s, window or {}, sl)


@pytest.mark.parametrize("cfg", ["hoa64", "pod1024"])
@pytest.mark.parametrize("metric, want", [
    ("nonuniform.launches_per_call.render.{}", 1.5),
    ("nonuniform.launches_per_block.live.{}", 1.5),
    ("device.idle_pct.render.{}", 100 * 75 / 160),
    ("device.busy_ms_per_block.live.{}", 0.0425),
])
def test_the_per_layer_readers(metric, want, cfg):
    metric = metric.format(cfg)
    got = manifest.load().reader(metric).read(_ctx(sl=_slice()))
    assert got == pytest.approx(want)
    assert manifest.load().reader(metric).read(_ctx()) is None


@pytest.mark.parametrize("cfg", ["hoa64", "pod1024"])
def test_rtf_is_all_the_audio_over_all_the_window(cfg):
    read = manifest.load().reader(f"rtf.{cfg}").read
    assert read(_ctx({"audio_s": 600.0, "wall_s": 2.0})) == 300.0
    assert read(_ctx({"latency_s": np.ones(3)})) is None
    assert manifest.load().reader("setup_s").read(_ctx()) == 1.5


@pytest.mark.parametrize("cfg", ["hoa64", "pod1024"])
def test_p99_is_numpys_linear_percentile_over_every_block(cfg):
    lat = np.arange(1, 1001) * 1e-3                # 1 .. 1000 ms
    got = manifest.load().reader(f"block_ms_p99.{cfg}").read(
        _ctx({"latency_s": lat}))
    assert got == pytest.approx(np.percentile(lat, 99) * 1e3)
    assert got == pytest.approx(990.01)


class _Stalling:
    """A stand-in engine whose block 5 of the window stalls 40 ms."""
    block, cycle_blocks = 512, 8

    def __init__(self):
        self.n = 0

    def live(self, x):
        self.n += 1
        if self.n == 16 + 6:
            time.sleep(0.040)
        return torch.as_tensor(x).clone()


def test_an_open_loop_counts_a_stall_against_the_blocks_behind_it():
    from cardbench.drivers import paced_blocks

    cfg = {"channels": 2, "sample_rate": 48000, "signal_rms": 0.1,
           "ir_taps": 1024}
    tr = {"input_pool_blocks": 4, "warmup_super_blocks": 2, "keep": 2,
          "trace_slice": {"super_blocks": 1}}
    run = Run(cfg, tr, 7, torch.device("cpu"), _Stalling())
    drv = paced_blocks.Driver(run)
    drv.setup()
    rec = drv.window(0.2, None)
    lat, period = rec["latency_s"], rec["period_s"]
    assert rec["attempted"] == round(0.2 / period) == 19
    # block 5 is due, stalls 40 ms; blocks 6..8 were due meanwhile and
    # wait for it, each later than the one before by less than a period
    assert lat[5] > 0.039
    assert lat[6] > 0.039 - period and lat[7] > 0.039 - 2 * period
    assert lat[6] > lat[7] > lat[8]
    assert np.median(rec["late_s"]) < period
    assert rec["failed"] == 0
