"""The port's ``parallel/`` in local worlds of processes, against the JAX
package's ``parallel/`` on the conftest's CPU mesh of the same size.

Every sharded function of the port runs in gloo worlds of 4 and of 2
ranks on the CPU (``run_local_world``, one module-scoped world each, all
cases in it: ``bbcat_dsp_torch.parallel.cases``).  Each case is held three
ways, at >= 110 dB (the bar of ``tests/test_parallel.py``): against the
JAX package's same function on the same numpy inputs, on a mesh of the
same size (``make_mesh(n)``, or ``Mesh(devs.reshape(2, 2), ("ch",
"t"))``); against the port's single-process engine; and, for the
time-sharded renders, that engine is the sequential stream.  The loudness
is held within 1e-4 LU of JAX's.  The JAX engines run on explicit
standard-layout specs with every kernel gate shut, as in
``tests/test_torch_nonuniform.py``; the port runs its kernels' plain
versions.  The communication model equals JAX's with an explicit link
environment.
"""

import multiprocessing
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from bbcat_dsp_tpu.convolve import BlockConvolver as JaxBlock
from bbcat_dsp_tpu.convolve import NonUniformConvolver as JaxNonUniform
from bbcat_dsp_tpu.convolve import convolver_init as jax_init
from bbcat_dsp_tpu.convolve import partition_ir as jax_partition
from bbcat_dsp_tpu.convolve.fft import resolve_spectral_spec
from bbcat_dsp_tpu.loudness import integrated_loudness as jax_loudness
from bbcat_dsp_tpu import parallel as jpar
from bbcat_dsp_torch import (BlockConvolver, NonUniformConvolver, ops_hook,
                             parallel)
from bbcat_dsp_torch.convolve import convolver_init
from bbcat_dsp_torch.examples import pod_render
from bbcat_dsp_torch.loudness import integrated_loudness
from bbcat_dsp_torch.parallel import cases, comms, run_local_world
from conftest import snr_db

ROOT = Path(__file__).resolve().parent.parent
WORLD_TIMEOUT = 300.0
FS = 48000.0

_rng = np.random.default_rng(20261017)


def _exp_irs(C, N, decay):
    return _rng.standard_normal((C, N)) * np.exp(-np.arange(N) / decay)


def _signal(C, T):
    return _rng.standard_normal((C, T)).astype(np.float32)


# the inputs, one set for both worlds; a world of n renders n spans
STEP = {"irs": _exp_irs(16, 2048, 500.0), "x": _signal(16, 8 * 64),
        "block": 64}                                  # P = 32
RENDER = {"irs": _exp_irs(16, 2048, 500.0), "x": _signal(16, 8 * 128),
          "block": 128}                               # P = 16
# head 1024 taps, tail Pt = 3 of 512; two super-blocks of warm-up leave
# the queue at slot 2, then two render groups
NONUNIFORM = {"irs": _exp_irs(16, 2560, 800.0), "x": _signal(16, 8 * 512),
              "block": 64, "ratio": 8, "warm": 2 * 512}
# P = 32: the halo is 2048 samples, a span 4096
TIME = {"irs": _exp_irs(4, 2048, 600.0), "x": _signal(4, 4 * 4096),
        "block": 64}
# head 512 taps, tail Pt = 6 of 256: the halo 8 super-blocks, a span two
# render groups (3072 samples)
TIME_NU = {"irs": _exp_irs(8, 2048, 600.0), "x": _signal(8, 4 * 3072),
           "block": 64, "ratio": 4}
LOUD = {"x": 0.1 * _rng.standard_normal((16, 48000)),
        "w": _rng.uniform(0.5, 1.5, 16), "fs": FS}
HALO = {"C": 3, "nparts": 4, "block": 16, "seed": 7}


def _spans(d, n, per):
    """``d`` with its signal cut to ``n`` spans of ``per`` samples."""
    return {**d, "x": d["x"][:, :n * per]}


def _case_list(n):
    """``{label: (case, kwargs)}`` for a world of ``n``."""
    out = {
        "step": ("channel_step", STEP),
        "render": ("channel_render", RENDER),
        "nonuniform": ("channel_nonuniform",
                       {**NONUNIFORM, "gather_state": True}),
        "time": ("time_render", _spans(TIME, n, 4096)),
        "time_nonuniform": ("time_nonuniform", _spans(TIME_NU, n, 3072)),
        "loudness": ("loudness", LOUD),
        "halo": ("halo", HALO),
        "halo_staged": ("halo", {**HALO, "stand_in": True}),
        "all_reduce": ("all_reduce", {"values": [1.0, 2.5, -4.0]}),
    }
    if n == 4:
        out["time_2d"] = ("time_render",
                          {**_spans(TIME, 2, 4096), "mesh_shape": (2, 2)})
        out["time_nonuniform_2d"] = (
            "time_nonuniform",
            {**_spans(TIME_NU, 2, 3072), "mesh_shape": (2, 2)})
    return out


def _run_world(n):
    labelled = _case_list(n)
    ranks = run_local_world(cases.run, n, args=(list(labelled.values()), 1),
                            backend="gloo", device="cpu",
                            timeout=WORLD_TIMEOUT)
    return {label: [r[i] for r in ranks] for i, label in enumerate(labelled)}


_WORLDS = {}


@pytest.fixture(scope="module")
def worlds():
    """Each world's results by case label, a list over ranks; a world runs
    at its first use."""
    def get(n):
        if n not in _WORLDS:
            _WORLDS[n] = _run_world(n)
        return _WORLDS[n]

    yield get
    _WORLDS.clear()


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(n):
    return resolve_spectral_spec(n, backend="xla", probe=False,
                                 layout="std")._replace(
        mac="0", fused_head="0", permfft="0")


def _jax_mesh(n, axis="ch"):
    return jpar.make_mesh(n, axis_name=axis)


def _jax_mesh_2d():
    return JaxMesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("ch", "t"))


def _plain_counts(result, kernels):
    """The case ran its kernels' plain versions (the CPU's) and no other."""
    plain = result["counts"]["plain"]
    assert {k for k, v in plain.items() if v} == set(kernels), plain
    assert not any(result["counts"]["launches"].values())


WORLD_SIZES = [2, 4]


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_channel_sharded_step_matches_jax_and_one_process(worlds, n):
    r = worlds(n)["step"]
    irs, x, B = STEP["irs"], STEP["x"], STEP["block"]
    spec = _spec(2 * B)
    H = jax_partition(irs, B, spec=spec)
    state = jax_init(irs.shape[0], B, H.shape[1], spec=spec)
    step = jpar.channel_sharded_step(_jax_mesh(n), spec=spec)
    ys = []
    for k in range(x.shape[1] // B):
        state, y = step(state, H, jnp.asarray(x[:, k * B:(k + 1) * B]))
        ys.append(np.asarray(y))
    assert snr_db(np.concatenate(ys, -1), r[0]["y"]) >= 110.0
    conv = BlockConvolver(irs, B, device="cpu")
    y1 = torch.cat([conv.process_block(torch.from_numpy(x[:, k * B:(k + 1)
                                                          * B]))
                    for k in range(x.shape[1] // B)], -1).numpy()
    assert np.array_equal(y1, r[0]["y"])
    assert np.array_equal(conv.state.queue.numpy(), r[0]["queue"])
    assert np.array_equal(conv.state.prev.numpy(), r[0]["prev"])
    assert all(ri["step"] == conv.state.step for ri in r)
    assert all(ri["y"] is None for ri in r[1:])
    for ri in r:
        _plain_counts(ri, {"rfft_half", "rotated_mac", "irfft_tail"})


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_channel_sharded_render_matches_jax_and_one_process(worlds, n):
    r = worlds(n)["render"]
    irs, x, B = RENDER["irs"], RENDER["x"], RENDER["block"]
    spec = _spec(2 * B)
    H = jax_partition(irs, B, spec=spec)
    render = jpar.channel_sharded_render(_jax_mesh(n), B, spec=spec)
    _, yj = render(jax_init(irs.shape[0], B, H.shape[1], spec=spec), H,
                   jpar.shard_channels(x, _jax_mesh(n)))
    assert snr_db(np.asarray(yj), r[0]["y"]) >= 110.0
    conv = BlockConvolver(irs, B, device="cpu")
    assert np.array_equal(conv.process(torch.from_numpy(x)).numpy(),
                          r[0]["y"])
    assert np.array_equal(conv.state.queue.numpy(), r[0]["queue"])
    for ri in r:
        _plain_counts(ri, {"rfft_half", "head_mac", "irfft_tail"})


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_channel_sharded_nonuniform_render_matches_jax_and_one_process(
        worlds, n):
    """From the state two super-blocks of streaming left (queue slot 2 of
    Pt = 3), two render groups: output and every leaf of the final
    state."""
    r = worlds(n)["nonuniform"]
    irs, x, B, ratio, warm = (NONUNIFORM[k] for k in
                              ("irs", "x", "block", "ratio", "warm"))
    specs = (_spec(2 * B), _spec(2 * B * ratio))
    jconv = JaxNonUniform(irs, block=B, ratio=ratio, spectral=specs)
    jconv.process(jnp.asarray(x[:, :warm]))
    Pt = jconv.tail_parts
    render = jpar.channel_sharded_nonuniform_render(
        _jax_mesh(n), B, tail_slot0=(warm // (B * ratio)) % Pt, specs=specs)
    jstate, yj = render(jconv.state, jconv.H_head, jconv.H_tail,
                        jpar.shard_channels(x[:, warm:], _jax_mesh(n)))
    assert snr_db(np.asarray(yj), r[0]["y"]) >= 110.0
    jleaves = {"xcarry": jstate.xcarry, "prev": jstate.prev,
               "tail.queue": jstate.tail.queue, "tail.prev": jstate.tail.prev,
               "pending": jstate.pending}
    for name, leaf in jleaves.items():
        assert snr_db(np.asarray(leaf), r[0][name]) >= 110.0, name

    conv = NonUniformConvolver(irs, B, ratio, device="cpu")
    conv.process(torch.from_numpy(x[:, :warm]))
    y1 = conv.process(torch.from_numpy(x[:, warm:])).numpy()
    assert np.array_equal(y1, r[0]["y"])
    st = conv.state
    for name, leaf in (("xcarry", st.xcarry), ("prev", st.prev),
                       ("tail.queue", st.tail.queue),
                       ("tail.prev", st.tail.prev),
                       ("pending", st.pending)):
        assert np.array_equal(leaf.numpy(), r[0][name]), name
    assert all(ri["tail_step"] == st.tail.step for ri in r)
    for ri in r:
        _plain_counts(ri, {"fused_head", "gather_supers", "rfft_half",
                           "xt_grouped_mac", "irfft_tail", "delayed_add"})


def _time_case(n, label):
    d = _spans(TIME, n if label == "time" else 2, 4096)
    return d["irs"], d["x"], d["block"]


@pytest.mark.parametrize("n,label", [(2, "time"), (4, "time"),
                                     (4, "time_2d")])
def test_time_sharded_render_matches_jax_and_the_sequential_stream(
        worlds, n, label):
    r = worlds(n)[label]
    irs, x, B = _time_case(n, label)
    spec = _spec(2 * B)
    H = jax_partition(irs, B, spec=spec)
    if label == "time":
        render = jpar.time_sharded_render(_jax_mesh(n, "t"), B, H.shape[1],
                                          axis_name="t", spec=spec)
    else:
        render = jpar.time_sharded_render(_jax_mesh_2d(), B, H.shape[1],
                                          axis_name="t", ch_axis="ch",
                                          spec=spec)
    assert snr_db(np.asarray(render(H, jnp.asarray(x))), r[0]["y"]) >= 110.0
    seq = BlockConvolver(irs, B, device="cpu").process(
        torch.from_numpy(x)).numpy()
    assert snr_db(seq, r[0]["y"]) >= 110.0
    P = H.shape[1]
    for ri in r:
        c_local = irs.shape[0] // (1 if label == "time" else 2)
        first = ri is r[0] or (label == "time_2d" and ri is r[2])
        assert ri["comm"]["halo_exchange"]["bytes_received"] == (
            0 if first else comms.halo_bytes(c_local, P, B))
        _plain_counts(ri, {"rfft_half", "head_mac", "irfft_tail"})


@pytest.mark.parametrize("n,label", [(2, "time_nonuniform"),
                                     (4, "time_nonuniform"),
                                     (4, "time_nonuniform_2d")])
def test_time_sharded_nonuniform_render_matches_jax_and_the_sequential_stream(
        worlds, n, label):
    """Each span rebuilds the head carry, the tail queue and the 2-slot
    pending from one (Pt+2)-super-block halo."""
    r = worlds(n)[label]
    d = _spans(TIME_NU, n if label == "time_nonuniform" else 2, 3072)
    irs, x, B, ratio = d["irs"], d["x"], d["block"], d["ratio"]
    specs = (_spec(2 * B), _spec(2 * B * ratio))
    jconv = JaxNonUniform(irs, block=B, ratio=ratio, spectral=specs)
    Pt, Ph = jconv.tail_parts, jconv.head_parts
    if label == "time_nonuniform":
        mesh, ch = _jax_mesh(n, "t"), None
    else:
        mesh, ch = _jax_mesh_2d(), "ch"
    render = jpar.time_sharded_nonuniform_render(
        mesh, B, ratio, Ph, Pt, axis_name="t", ch_axis=ch, specs=specs)
    yj = np.asarray(render(jconv.H_head, jconv.H_tail, jnp.asarray(x)))
    assert snr_db(yj, r[0]["y"]) >= 110.0
    seq = NonUniformConvolver(irs, B, ratio, device="cpu").process(
        torch.from_numpy(x)).numpy()
    assert snr_db(seq, r[0]["y"]) >= 110.0
    assert r[0]["tail_parts"] == Pt == 6
    for ri in r:
        _plain_counts(ri, {"fused_head", "gather_supers", "rfft_half",
                           "xt_grouped_mac", "irfft_tail", "delayed_add",
                           "head_mac"})


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_sharded_loudness_matches_jax_and_one_process(worlds, n):
    r = worlds(n)["loudness"]
    x, w = LOUD["x"].astype(np.float32), LOUD["w"].astype(np.float32)
    meter = jpar.sharded_integrated_loudness(_jax_mesh(n), FS, x.shape[0])
    want = float(meter(jnp.asarray(x), jnp.asarray(w)))
    one = float(integrated_loudness(torch.from_numpy(x), FS, w))
    assert abs(float(jax_loudness(jnp.asarray(x), FS, w)) - want) < 1e-4
    for ri in r:
        assert abs(ri["lkfs"] - want) < 1e-4
        assert abs(ri["lkfs"] - one) < 1e-4
        ar = ri["comm"]["all_reduce_sum"]
        # one all-reduce of the block powers, float32
        nblocks = (x.shape[1] - 19200) // 4800 + 1
        assert ar["calls"] == 1
        assert ar["bytes_sent"] == comms.allreduce_bytes(4 * nblocks, n)


@pytest.mark.parametrize("n", WORLD_SIZES)
@pytest.mark.parametrize("label", ["halo", "halo_staged"])
def test_halo_exchange_moves_halo_bytes_to_the_right_neighbour(
        worlds, n, label):
    """Rank i gets rank i-1's samples, rank 0 zeros; each rank sends and
    receives exactly ``halo_bytes``, the last sends nothing.  The branch
    that stages a CUDA tensor through the host under gloo, driven with a
    CPU tensor standing in, moves the same and counts its copies."""
    r = worlds(n)[label]
    nbytes = comms.halo_bytes(HALO["C"], HALO["nparts"], HALO["block"])
    assert not r[0]["halo"].any()
    for i, ri in enumerate(r):
        c = ri["comm"]["halo_exchange"]
        if i:
            assert np.array_equal(ri["halo"], r[i - 1]["sent"])
        assert c["calls"] == 1
        assert c["bytes_sent"] == (nbytes if i + 1 < n else 0)
        assert c["bytes_received"] == (nbytes if i else 0)
        assert c["staged_bytes"] == (2 * nbytes if label == "halo_staged"
                                     else 0)


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_all_reduce_sum(worlds, n):
    want = np.asarray([1.0, 2.5, -4.0], np.float32) * sum(range(1, n + 1))
    for ri in worlds(n)["all_reduce"]:
        assert np.array_equal(ri["sum"], want)
        assert ri["comm"]["all_reduce_sum"]["bytes_sent"] == \
            comms.allreduce_bytes(12, n)


# the cases of tests/test_parallel.py::test_comm_model_accounting, with
# the link environment given: JAX's defaults, and the port's H100
# bandwidths with round latencies
ENVS = [(4.5e10, 1e-6, 3.125e9, 25e-6), (4.5e11, 2e-6, 5e10, 5e-6)]


def _envs(e):
    bw, lat, bw2, lat2 = e
    return (jpar.CommEnv(ici_bw=bw, ici_lat=lat, dcn_bw=bw2, dcn_lat=lat2),
            comms.CommEnv(nvlink_lat=lat, ib_lat=lat2, nvlink_bw=bw,
                          ib_bw=bw2))


@pytest.mark.parametrize("payload,n", [(4, 1), (4, 8), (1024, 4), (68, 4),
                                       (4, 2)])
def test_allreduce_bytes_as_jax(payload, n):
    assert comms.allreduce_bytes(payload, n) == jpar.allreduce_bytes(
        payload, n)


@pytest.mark.parametrize("args", [(16, 64, 512), (16, 64, 512, 2),
                                  (3, 4, 16), (256, 14, 4096)])
def test_halo_bytes_as_jax(args):
    assert comms.halo_bytes(*args) == jpar.halo_bytes(*args)


@pytest.mark.parametrize("env", ENVS)
@pytest.mark.parametrize("hops", [(0, 1), (1, 0), (1, 1), (0, 0)])
def test_collective_seconds_as_jax(env, hops):
    jenv, tenv = _envs(env)
    nbytes = jpar.halo_bytes(16, 64, 512)
    want = jpar.collective_seconds(nbytes, jenv, hops_dcn=hops[0],
                                   hops_ici=hops[1])
    assert comms.collective_seconds(nbytes, tenv, hops_ib=hops[0],
                                    hops_nvlink=hops[1]) == want


@pytest.mark.parametrize("env", ENVS)
@pytest.mark.parametrize("rtf", [16.4, 1818.24])
def test_config5_scaling_table_as_jax(env, rtf):
    jenv, tenv = _envs(env)
    want = jpar.config5_scaling_table(rtf, env=jenv)
    assert comms.config5_scaling_table(rtf, env=tenv) == want
    assert comms.scaling_efficiency(1.0, 0.25) == jpar.scaling_efficiency(
        1.0, 0.25)


@pytest.mark.parametrize("env", ENVS)
def test_time_sharded_efficiency_as_jax(env):
    jenv, tenv = _envs(env)
    args = (16.4, 10.0, 16, 64, 512, 8)
    assert comms.time_sharded_efficiency(*args, env=tenv) == \
        jpar.time_sharded_efficiency(*args, env=jenv)


def test_comm_env_names_h100_links_and_no_latency():
    """The bandwidths are the data sheets' H100 links; the latencies must
    be given."""
    with pytest.raises(TypeError):
        comms.CommEnv()
    env = comms.CommEnv(nvlink_lat=1e-6, ib_lat=5e-6)
    assert env.nvlink_bw == 450e9 and env.ib_bw == 50e9


def _stand_in_mesh(n, i, axis="t"):
    """A mesh of ``n`` along ``axis`` seen from position ``i``, with no
    process group (the span checks come before any collective)."""
    return SimpleNamespace(size=lambda a: n, index=lambda a: i,
                           group=lambda a: None, device=torch.device("cpu"))


@pytest.mark.parametrize("T,why", [(3 * 256, "whole number of render"),
                                   (6 * 256 + 1, "whole number of render"),
                                   (6 * 256, "cover the halo")])
def test_time_sharded_nonuniform_span_rules_raise(T, why):
    """Pt = 6 of 256: a span must be whole render groups (1536 samples)
    and cover the halo of Pt + 2 = 8 super-blocks (2048)."""
    conv = NonUniformConvolver(TIME_NU["irs"], 64, 4, device="cpu")
    render = parallel.time_sharded_nonuniform_render(
        _stand_in_mesh(4, 1), 64, 4, conv.head_parts, conv.tail_parts)
    with pytest.raises(ValueError, match=why):
        render(conv.H_head, conv.H_tail, torch.zeros(8, T))


@pytest.mark.parametrize("T,why", [(4096 + 32, "whole number of blocks"),
                                   (1024, "cover the halo")])
def test_time_sharded_render_span_rules_raise(T, why):
    conv = BlockConvolver(TIME["irs"], 64, device="cpu")
    render = parallel.time_sharded_render(_stand_in_mesh(2, 0), 64,
                                          conv.nparts)
    with pytest.raises(ValueError, match=why):
        render(conv.H, torch.zeros(4, T))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_shard_state_and_channels_cut_every_leaf_by_channel(n):
    conv = NonUniformConvolver(NONUNIFORM["irs"], 64, 8, device="cpu")
    conv.process(torch.from_numpy(NONUNIFORM["x"][:, :1024]))
    shards = [parallel.shard_state(conv.state, _stand_in_mesh(n, i, "ch"))
              for i in range(n)]
    st = conv.state
    for get, dim in ((lambda s: s.xcarry, 2), (lambda s: s.prev, 1),
                     (lambda s: s.tail.queue, 2), (lambda s: s.tail.prev, 1),
                     (lambda s: s.pending, 1)):
        assert all(get(s).shape[dim] == 16 // n for s in shards)
        assert torch.equal(torch.cat([get(s) for s in shards], dim), get(st))
    assert all(s.tail.step == st.tail.step for s in shards)
    bst = convolver_init(16, 64, 5, device="cpu")
    parts = [parallel.shard_state(bst, _stand_in_mesh(n, i, "ch"))
             for i in range(n)]
    assert torch.equal(torch.cat([p.queue for p in parts], 2), bst.queue)
    H = conv.H_tail
    got = [parallel.shard_channels(H, _stand_in_mesh(n, i, "ch"), 2)
           for i in range(n)]
    assert torch.equal(torch.cat(got, 2), H) and got[0].is_contiguous()
    if n > 1:
        with pytest.raises(ValueError, match="do not split"):
            parallel.shard_channels(torch.zeros(n + 1, 5), _stand_in_mesh(n, 0,
                                                                      "ch"))


def test_make_mesh_and_shard_channels_take_the_references_keywords():
    """``make_mesh(n_devices=...)`` and ``shard_channels(arr=...)`` as the
    reference names them (``bbcat_dsp_tpu/parallel/mesh.py:27``, ``:44``),
    and by position as the port's callers pass them, in a gloo world of
    one in this process."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        x = torch.arange(12.0).reshape(4, 3)
        for mesh in (parallel.make_mesh(n_devices=1, axis_name="ch",
                                        device="cpu"),
                     parallel.make_mesh(1, "ch", device="cpu")):
            assert mesh.size("ch") == 1
            assert torch.equal(parallel.shard_channels(arr=x, mesh=mesh), x)
            assert torch.equal(parallel.shard_channels(x, mesh, 1), x)
    finally:
        dist.destroy_process_group()
    assert jpar.make_mesh(n_devices=2).devices.size == 2


def test_pod_render_example_runs_and_checks_itself():
    lines = []
    r = pod_render.main(C=16, block=32, ratio=4, n_super=160, world=2,
                        device="cpu", timeout=WORLD_TIMEOUT,
                        log=lines.append)
    assert r["snr_db"] >= 110.0 and abs(r["lkfs"] - r["lkfs_ref"]) < 1e-4
    for rank in r["ranks"]:
        assert rank["counts"]["plain"]["fused_head"] > 0
        assert rank["comm"]["all_reduce_sum"]["calls"] == 1
    assert [row["chips"] for row in r["rows"]] == [1, 2, 4, 8]
    assert r["rows"][0]["aggregate_rtf"] == r["rtf"]
    assert any("contract >= 110" in line for line in lines)


def test_pod_render_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        pod_render.main()


def test_a_rank_that_fails_fails_the_world_and_leaves_no_process():
    with pytest.raises(RuntimeError, match="KeyError"):
        run_local_world(cases.run, 2, args=([("no_such_case", {})],),
                        backend="gloo", device="cpu", timeout=WORLD_TIMEOUT)
    assert not multiprocessing.active_children()


def test_a_world_past_its_timeout_raises_and_leaves_no_process():
    """Ranks that cannot finish in time (here: not even start) never
    count as a pass."""
    with pytest.raises(TimeoutError, match="did not finish"):
        run_local_world(cases.run, 2, args=([],), backend="gloo",
                        device="cpu", timeout=0.5)
    assert not multiprocessing.active_children()


RANKS_WITHOUT_JAX = r"""
import sys

class Forbid:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "bbcat_dsp_tpu"):
            raise ImportError("forbidden here: " + name)

sys.meta_path.insert(0, Forbid())
from bbcat_dsp_torch.examples import pod_render
from bbcat_dsp_torch.parallel import cases, run_local_world

if __name__ == "__main__":
    r = run_local_world(cases.run, 2, args=([("all_reduce",
                        {"values": [1.0]})],), backend="gloo",
                        device="cpu", timeout=120.0)
    assert [float(x[0]["sum"][0]) for x in r] == [3.0, 3.0], r
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "bbcat_dsp_tpu")]
    assert not bad, bad
    print("ranks without jax")
"""


def test_the_rank_programs_import_neither_jax_nor_the_jax_package(tmp_path):
    script = tmp_path / "ranks.py"
    script.write_text(RANKS_WITHOUT_JAX)
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT),
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ranks without jax" in out.stdout


def test_a_span_shorter_than_the_halo_raises_in_the_port_and_is_wrong_in_jax():
    """The reference's ``time_sharded_render`` checks no span: with spans
    of 1024 samples under a halo of 2048 (P = 32 of 64), each device's
    halo is its left neighbour's whole span, the older half missing, and
    the output falls to a few dB against the sequential stream.  The
    port refuses the span."""
    irs, B = TIME["irs"][:2], TIME["block"]
    x = TIME["x"][:2, :4 * 1024]
    H = jax_partition(irs, B)
    y = np.asarray(jpar.time_sharded_render(_jax_mesh(4, "t"), B, H.shape[1],
                                            axis_name="t")(H, jnp.asarray(x)))
    seq = np.asarray(JaxBlock(irs, block=B).process(jnp.asarray(x)))
    assert snr_db(seq, y) < 20.0
    render = parallel.time_sharded_render(_stand_in_mesh(4, 1), B,
                                          H.shape[1])
    with pytest.raises(ValueError, match="cover the halo"):
        render(torch.tensor(np.asarray(H)), torch.from_numpy(x[:, :1024]))


KERNELS = ("fused_head", "rfft_half", "xt_grouped_mac", "irfft_tail",
           "gather_supers", "delayed_add", "head_mac", "rotated_mac")


@pytest.fixture
def strict_kernels(monkeypatch):
    """Every dispatch refuses an operand that is not contiguous and
    returns contiguous outputs, as the card's kernels do (the CPU's plain
    versions take and give any strides); the halo exchange stands in as
    the first rank's, which gets zeros.  Returns the dispatches made."""
    seen = []
    for name in KERNELS:
        def strict(*args, _fn=getattr(ops_hook, name), _name=name):
            bad = [i for i, a in enumerate(args)
                   if isinstance(a, torch.Tensor) and not a.is_contiguous()]
            assert not bad, f"{_name}: operands {bad} are not contiguous"
            seen.append(_name)
            out = _fn(*args)   # a kernel's outputs are contiguous
            return (tuple(o.contiguous() for o in out)
                    if isinstance(out, tuple) else out.contiguous())

        monkeypatch.setattr(ops_hook, name, strict)
    monkeypatch.setattr(parallel.convolve, "halo_exchange",
                        lambda t, group: torch.zeros_like(t.contiguous()))
    return seen


def test_the_sharded_callables_hand_the_kernels_contiguous_operands(
        strict_kernels):
    """Each sharded function's callable, given a signal that is a view of
    a longer one (a block, a span), launches only on contiguous
    operands."""
    mesh = _stand_in_mesh(1, 0)
    wide = torch.from_numpy(_signal(8, 4 * 3072 + 7))

    def view(T):
        return wide[:, 7:7 + T]

    irs = TIME_NU["irs"]
    conv = BlockConvolver(irs, 64, device="cpu")
    parallel.channel_sharded_step(mesh)(conv.state, conv.H, view(64))
    parallel.channel_sharded_render(mesh, 64)(conv.state, conv.H, view(512))
    parallel.time_sharded_render(mesh, 64, conv.nparts)(conv.H, view(4096))
    nu = NonUniformConvolver(irs, 64, 4, device="cpu")
    parallel.channel_sharded_nonuniform_render(mesh, 64)(
        nu.state, nu.H_head, nu.H_tail, view(6 * 256))
    parallel.time_sharded_nonuniform_render(
        mesh, 64, 4, nu.head_parts, nu.tail_parts)(nu.H_head, nu.H_tail,
                                                   view(2 * 6 * 256))
    assert set(strict_kernels) == set(KERNELS)


ENDED_EARLY = r"""
import numpy as np
from bbcat_dsp_torch.parallel import cases, run_local_world

if __name__ == "__main__":
    x = np.zeros((64, 16384), np.float32)   # far more than a pipe holds
    try:
        run_local_world(cases.run, 2, args=([("loudness", {
            "x": x, "w": np.ones(64), "fs": 48000.0})],), backend="gloo",
            device="cpu", timeout=0.5)
    except TimeoutError:
        print("timed out")
"""


def test_a_world_that_ends_early_does_not_hold_its_caller_at_exit(tmp_path):
    """Work that no rank took in time is dropped: the caller's process
    exits instead of waiting for a reader of its queue."""
    script = tmp_path / "early.py"
    script.write_text(ENDED_EARLY)
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT),
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "timed out" in out.stdout
