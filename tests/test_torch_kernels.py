"""The kernels' plain PyTorch versions against the JAX package.

Each plain version is held against its ``adjoint.xla_*`` contract (the
oracle the Pallas kernels are tested against) and against its Pallas
kernel run with ``interpret=True`` at a tiny shape.  The tail transforms'
(K3/K4) plain versions are the standard-layout ``rfft_half_planes`` and
``irfft_tail_planes``, held against the reference's ``xla`` backend in
``test_torch_fft.py``; their ``xla_*`` contracts are for the permuted
layout, which the port does not serve.  The CUDA kernels run
only on the card (``chip_smoke.py`` holds each against these plain
versions there); here their wrappers are checked to refuse what they do
not take, before any build.  The fused head (K1) and the head MAC (K7)
split their work over the card in ways the plain versions do not, the
tail transforms (K3/K4) carry their own FFT, the tail MAC (K2) walks
its planes flat, and the rotated MAC (K9) splits its partitions over the
rows of a CTA: models of those schedules in plain PyTorch or numpy,
each unit reading only what its CTA reads, are held against the plain
versions and the contracts here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbcat_dsp_tpu.convolve import fft as jfft
from bbcat_dsp_tpu.ops.pallas import adjoint
from bbcat_dsp_tpu.ops.pallas.fused_head import fused_head_pallas
from bbcat_dsp_tpu.ops.pallas.marshal import (
    delayed_add_pallas,
    gather_supers_pallas,
)
from bbcat_dsp_tpu.ops.pallas.perm_fft import (
    perm_irfft_tail_pallas,
    perm_rfft_half_pallas,
)
from bbcat_dsp_tpu.ops.pallas.spectral_fir import (
    head_mac_tiled_pallas,
    rotated_mac_pallas,
    xt_grouped_mac_pallas,
)
from bbcat_dsp_tpu.ops.pallas.spectral_mac import head_mac_pallas
from bbcat_dsp_torch import ops_hook
from bbcat_dsp_torch.ops.kernels import fused_head as k1
from bbcat_dsp_torch.ops.kernels import half_fft as k34
from bbcat_dsp_torch.ops.kernels import marshal as k56
from bbcat_dsp_torch.ops.kernels import spectral_fir as k2
from bbcat_dsp_torch.ops.kernels import spectral_mac as k79
from conftest import snr_db


# the contracts run jitted: one compile per shape beats eager op-by-op
# dispatch of their many small ops
_xla_fused_head = jax.jit(adjoint.xla_fused_head, static_argnums=4)
_xla_xt_grouped_mac = jax.jit(adjoint.xla_xt_grouped_mac,
                              static_argnums=(3, 4, 5))


def _arrays(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _head_inputs(rng, C, P, B, R):
    F = B + 1
    return _arrays(rng, (C, R * B), (2, P, C, F), (2, C, F), (2, P, C, F))


# ---- K1 fused head ------------------------------------------------------------

@pytest.mark.parametrize("C,P,B,R", [
    (8, 8, 32, 4),     # R < P: part of the carry is kept
    (8, 8, 32, 16),    # R > P: the carry is all new windows
    (5, 3, 64, 7),     # odd C and P
    (1, 1, 32, 2),     # one channel, one partition
])
def test_fused_head_plain_matches_xla_contract(rng, C, P, B, R):
    ins = _head_inputs(rng, C, P, B, R)
    want = _xla_fused_head(*map(jnp.asarray, ins), B)
    got = k1.fused_head_plain(*map(torch.from_numpy, ins), B)
    assert got[0].shape == (C, R * B)
    for w, g in zip(want, got):
        assert snr_db(np.asarray(w), g.numpy()) >= 110.0


def test_fused_head_plain_matches_pallas_interpret(rng):
    """Tiny shape through the Pallas kernel itself.  The kernel's DFT
    matmuls split float32 into bf16 parts (HIGH precision), which bounds
    its agreement with an exact float32 FFT near 100 dB."""
    C, P, B, R = 8, 4, 32, 6
    ins = _head_inputs(rng, C, P, B, R)
    want = fused_head_pallas(*map(jnp.asarray, ins), B, interpret=True)
    got = k1.fused_head_plain(*map(torch.from_numpy, ins), B)
    for w, g in zip(want, got):
        assert snr_db(np.asarray(w), g.numpy()) >= 90.0


# ---- the schedules of the CUDA K1 and K7, modelled in PyTorch ------------------

def _window_mac_model(RT, U, P, x, h):
    """``csrc/window_mac.cuh``: ``acc[k] = sum_p x(p - k) h(p)`` for a tile
    of ``RT`` outputs, the partitions in chunks of ``U`` whose history
    entries ``e`` and filter bins ``g`` are fetched ahead, the window ``w``
    moved by ``U`` a chunk; p ascends for every output."""
    zero = torch.zeros_like(h(0))
    acc = [zero] * RT
    w = [x(-k) for k in range(RT)]
    for p0 in range(0, P, U):
        g = [h(p0 + u) if p0 + u < P else zero for u in range(U)]
        e = [x(p0 + 1 + j) if p0 + 1 + j < P else zero for j in range(U)]
        for u in range(min(U, P - p0)):
            for k in range(RT):
                acc[k] = acc[k] + (w[k - u] if k >= u else e[u - k - 1]) * g[u]
        w = [w[k - U] if k >= U else e[U - k - 1] for k in range(RT)]
    return acc


def _k1_tile(B):
    """Output blocks a CTA of ``mac_inverse_kernel`` (csrc/fused_head.cu)."""
    return 2 if B > 512 else (8 if B < 64 else 4)


def _fused_head_model(x, xcarry, prev, H, B):
    """The two launches of ``csrc/fused_head.cu``.  First every window on
    its own: block 0 from ``[x_0, 0]`` and ``prev``, block j > 0 as one
    transform of ``[x_{j-1}, x_j]``, one more of ``[x_{R-1}, 0]`` for the
    carry, the carried windows copied in front and those the new carry
    keeps moved up.  Then per (channel, tile): the MAC over the windows
    ``i0 + 1 .. P + i0 + tile - 1`` alone and the inverses' last B
    samples."""
    C, T = x.shape
    R, P, F = T // B, H.shape[1], B + 1
    n = 2 * B
    sign = torch.where(torch.arange(F) % 2 == 1, -1.0, 1.0)
    Hc = torch.complex(H[0], H[1])
    win = torch.full((C, P + R, F), float("nan"), dtype=torch.complex64)
    carry = torch.full((P, C, F), float("nan"), dtype=torch.complex64)
    xc = torch.complex(xcarry[0], xcarry[1])
    for p in range(P):                                   # the copying CTAs
        win[:, p] = xc[p]
        if p >= R:
            carry[p - R] = xc[p]
    prev_out = None
    for c in range(C):
        for j in range(R + (1 if R > 1 else 0)):         # one transform each
            if j == 0 or j == R:
                blk = R - 1 if j == R else 0
                w = torch.fft.rfft(x[c, blk * B:(blk + 1) * B], n=n)
                w.imag[[0, -1]] = 0.0
            else:
                w = torch.fft.rfft(x[c, (j - 1) * B:(j + 1) * B])
            if j == R or R == 1:
                if prev_out is None:
                    prev_out = torch.empty((C, F), dtype=torch.complex64)
                prev_out[c] = w
                if j == R:
                    continue
            if j == 0:
                w = torch.complex(prev[0, c], prev[1, c]) + sign * w
            win[c, P + j] = w
            if P + j - R >= 0:
                carry[P + j - R, c] = w
    assert not torch.isnan(torch.view_as_real(win)).any()
    y = torch.full((C, T), float("nan"))
    RT = _k1_tile(B)
    for c in range(C):
        for i0 in range(0, R, RT):
            lo = i0 + 1                                  # oldest window read
            seen = win[c, lo:min(P + i0 + RT, P + R)]    # all this CTA reads

            def hist(d, i0=i0, lo=lo, seen=seen):
                m = P + i0 - d
                return seen[m - lo] if m <= P + R - 1 else torch.zeros(
                    F, dtype=torch.complex64)

            acc = _window_mac_model(RT, 4, P, hist, lambda p: Hc[p, c])
            for r in range(min(RT, R - i0)):
                a = acc[r].clone()
                a.imag[[0, -1]] = 0.0
                y[c, (i0 + r) * B:(i0 + r + 1) * B] = torch.fft.irfft(
                    a, n=n)[B:]
    planes = lambda z: torch.stack([z.real, z.imag])
    return y, planes(carry), planes(prev_out)


def _k1_producers(B):
    """Transforms the producer of ``resident_kernel`` (csrc/fused_head.cu)
    runs side by side: half the tile's, at least a warp of B/8 threads."""
    RT = k1.resident_tile(B)
    return min(RT, max(RT // 2, -(-32 // (B // 8))))


def _fused_head_resident_model(x, xcarry, prev, H, B):
    """The resident schedule of ``csrc/fused_head.cu``, a pipeline: per
    channel (one CTA) a ring of ``S = P + 2 tile - 1`` window slots, window
    m in slot m mod S, the carried windows 1 .. P-1 copied in (no output
    reads window 0).  The consumer puts tile 0's windows into the ring
    itself (blocks past the last give zero windows); then, between one
    hand-off and the next, it runs tile n's MAC over the ring (p ascending;
    the kernel fuses each product into the sum) and the inverses' last B
    samples, while the producer puts tile n + 1's windows, or after its
    last tile transforms the half window ``[x_{R-1}, 0]`` for the carry
    out through the slots of windows ``P + tiles * tile + g``.  Here the
    producer's writes of an interval land before the consumer's MAC of the
    same interval, the order that would expose a slot written too early,
    and every write asserts that its slot holds no window a MAC of the
    interval still reads.  The new carry is read from the ring at the
    end.  Channels are independent: the model runs them side by side."""
    C, T = x.shape
    R, P, F = T // B, H.shape[1], B + 1
    n = 2 * B
    RT = k1.resident_tile(B)
    S = P + 2 * RT - 1
    tiles = -(-R // RT)
    sign = torch.where(torch.arange(F) % 2 == 1, -1.0, 1.0)
    Hc = torch.complex(H[0], H[1])                       # [P, C, F]
    xc = torch.complex(xcarry[0], xcarry[1])
    pc = torch.complex(prev[0], prev[1])
    xb = x.reshape(C, R, B)
    ring = torch.full((S, C, F), float("nan"), dtype=torch.complex64)
    held = [None] * S                                    # window in a slot
    pending = set()                                      # slots a MAC reads

    def put(m, w):
        s = m % S
        assert s not in pending, f"slot {s} written while a MAC reads it"
        ring[s], held[s] = w, m

    def half(blk):
        w = torch.fft.rfft(xb[:, blk], n=n)
        w.imag[:, [0, -1]] = 0.0
        return w

    def window(j):
        if j >= R:
            return torch.zeros((C, F), dtype=torch.complex64)
        if j == 0:
            return pc + sign * half(0)
        return torch.fft.rfft(torch.cat([xb[:, j - 1], xb[:, j]], dim=1))

    for m in range(1, P):                                # cp.async
        put(m, xc[m])
    for r in range(RT):                                  # the consumer
        put(P + r, window(r))
    y = torch.full((C, T), float("nan"))
    prev_out = None
    for i in range(tiles):
        i0 = i * RT
        base = (P + i0) % S
        reads = {(base - d) % S for d in range(-(RT - 1), P)}
        for s_ in reads:                                 # windows i0 + 1 ..
            assert held[s_] is not None and i0 + 1 <= held[s_] < P + i0 + RT
        pending = reads
        if i + 1 < tiles:                                # the producer
            for r in range(RT):
                put(P + i0 + RT + r, window(i0 + RT + r))
        else:
            for g in range(_k1_producers(B)):            # exchange scratch
                put(P + tiles * RT + g,
                    torch.full((C, F), float("nan"), dtype=torch.complex64))
            prev_out = half(R - 1)
        acc = _window_mac_model(RT, 4, P, lambda d: ring[(base - d) % S],
                                lambda p: Hc[p])
        pending = set()
        for r in range(min(RT, R - i0)):
            a = acc[r].clone()
            a.imag[:, [0, -1]] = 0.0
            y[:, (i0 + r) * B:(i0 + r + 1) * B] = torch.fft.irfft(
                a, n=n)[:, B:]
    assert [held[(R + q) % S] for q in range(P)] == list(range(R, P + R))
    carry = torch.stack([ring[(R + q) % S] for q in range(P)])
    planes = lambda z: torch.stack([z.real, z.imag])
    return y, planes(carry), planes(prev_out)


def _head_mac_model(xext, H, R):
    """``head_mac_kernel`` of ``csrc/spectral_mac.cu``: a tile of 1, 8 or 16
    outputs a thread, 4 (single block) or 8 partitions fetched ahead; only
    the history's first ``P + R`` slots are read."""
    P = H.shape[1]
    RT = 1 if R == 1 else (8 if R <= 8 else 16)
    X = torch.complex(xext[0], xext[1])[:P + R]
    Hc = torch.complex(H[0], H[1])
    out = torch.full((R, *H.shape[2:]), float("nan"), dtype=torch.complex64)
    for i0 in range(0, R, RT):
        def hist(d, i0=i0):
            s = P + i0 - d
            assert s >= 0
            return X[s] if s <= P + R - 1 else torch.zeros_like(X[0])

        acc = _window_mac_model(RT, 4 if RT == 1 else 8, P, hist,
                                lambda p: Hc[p])
        for k in range(min(RT, R - i0)):
            out[i0 + k] = acc[k]
    return torch.stack([out.real, out.imag])


@pytest.mark.parametrize("C,P,B,R", [
    (3, 4, 64, 7),     # R not a multiple of the tile of 4
    (2, 4, 64, 1),     # one block: the half spectrum is the window's own
    (2, 8, 32, 3),     # R < P: the carry mixes old and new windows
    (2, 4, 64, 4),     # R = P
    (2, 3, 64, 9),     # R > 2P
    (2, 1, 64, 6),     # one partition
    (5, 6, 32, 10),    # odd C, the tile of 8 at B = 32
    (1, 5, 128, 5),    # B = 128: radix 8, 8, 2
])
def test_fused_head_schedule_matches_plain_and_contract(rng, C, P, B, R):
    ins = _head_inputs(rng, C, P, B, R)
    tins = list(map(torch.from_numpy, ins))
    got = _fused_head_model(*tins, B)
    plain = k1.fused_head_plain(*tins, B)
    want = _xla_fused_head(*map(jnp.asarray, ins), B)
    for g, p_, w in zip(got, plain, want):
        assert g.shape == p_.shape
        assert snr_db(p_.numpy(), g.numpy()) >= 110.0
        assert snr_db(np.asarray(w), g.numpy()) >= 110.0


# the shared memory an H100's CTA may opt into
# (cudaDevAttrMaxSharedMemoryPerBlockOptin) and its SMs
H100_SMEM, H100_SMS = 232448, 132


@pytest.mark.parametrize("C,P,B,R", [
    (3, 8, 32, 3),     # R < P: the carry keeps carried windows of the ring
    (2, 4, 64, 1),     # R = 1: one tile, seven blocks past the last
    (3, 4, 64, 11),    # R not a multiple of the tile of 8
    (5, 6, 32, 10),    # odd C (one CTA a channel), B = 32
    (2, 3, 128, 16),   # R a multiple of the tile, the ring wraps often
    (2, 1, 64, 9),     # one partition: the ring holds the tile alone
    (2, 3, 1024, 5),   # B = 1024: the tile of 2, the last one ragged
    (1, 9, 1024, 2),   # B = 1024: one tile
    # the shapes test_fused_head_schedule_rule finds resident, at two
    # channels (each runs alone in its CTA): config #5's render and its
    # channel shard, the streaming super-step (one tile, as at C = 132),
    # P = 9 at B = 1024
    (2, 16, 512, 112),
    (2, 16, 512, 8),
    (2, 9, 1024, 56),
    (2, 16, 512, 9),   # one block past the first tile
    (2, 16, 512, 113),  # a ragged last tile after 14 full ones
    (1, 11, 1024, 3),  # the most partitions a channel at B = 1024 holds
])
def test_fused_head_resident_schedule_matches_plain_and_contract(
        rng, C, P, B, R):
    # on a card of C SMs the library picks the resident schedule where R
    # fills a tile; the others run it when it is asked for by name
    want_pick = "resident" if R >= k1.resident_tile(B) else "windowed"
    assert k1.fused_head_schedule(C, P, B, R, H100_SMEM, C) == want_pick
    ins = _head_inputs(rng, C, P, B, R)
    tins = list(map(torch.from_numpy, ins))
    got = _fused_head_resident_model(*tins, B)
    plain = k1.fused_head_plain(*tins, B)
    want = _xla_fused_head(*map(jnp.asarray, ins), B)
    for g, p_, w in zip(got, plain, want):
        assert g.shape == p_.shape
        assert snr_db(p_.numpy(), g.numpy()) >= 110.0
        assert snr_db(np.asarray(w), g.numpy()) >= 110.0


@pytest.mark.parametrize("C,P,B,R,want", [
    (64, 16, 512, 48, "windowed"),     # the headline render
    (64, 16, 512, 8, "windowed"),      # the streaming super-step
    (64, 16, 512, 1, "windowed"),      # process_small_block's head
    (1024, 16, 512, 112, "resident"),  # config #5's render
    (256, 16, 512, 112, "resident"),   # its channel shard on 4 ranks
    (1024, 16, 512, 8, "resident"),    # its streaming super-step
    (1024, 16, 512, 1, "windowed"),    # its small block: R short of a tile
    (132, 16, 512, 8, "resident"),     # a channel an SM, a full tile
    (131, 16, 512, 48, "windowed"),    # an SM idle
    (64, 16, 512, 448, "windowed"),    # 121.9 MB of scratch, half the SMs
    (16, 16, 512, 2000, "windowed"),   # 132.4 MB, 16 SMs
    (1024, 20, 512, 112, "windowed"),  # P = 20 does not fit
    (1024, 16, 1024, 56, "windowed"),  # nor P = 16 at B = 1024
    (1024, 9, 1024, 56, "resident"),   # P = 9 does
])
def test_fused_head_schedule_rule(C, P, B, R, want):
    assert k1.fused_head_schedule(C, P, B, R, H100_SMEM, H100_SMS) == want


def test_fused_head_schedule_thresholds():
    C, P, B, R = 100, 16, 512, 48
    # the channels must fill the SMs
    assert k1.fused_head_schedule(C, P, B, R, H100_SMEM, C) == "resident"
    assert k1.fused_head_schedule(C, P, B, R, H100_SMEM, C + 1) == "windowed"
    # R a tile
    assert k1.resident_tile(B) == 8 and k1.resident_tile(1024) == 2
    assert k1.fused_head_schedule(C, P, B, 8, H100_SMEM, C) == "resident"
    assert k1.fused_head_schedule(C, P, B, 7, H100_SMEM, C) == "windowed"
    # and the channel must fit in shared memory
    need = k1.resident_smem_bytes(P, B)
    # stage twiddles 4032 + filter 65664 + ring of 31 windows 127224 + tile
    assert need == 229752
    assert k1.resident_smem_bytes(11, 1024) <= H100_SMEM
    assert k1.resident_smem_bytes(12, 1024) > H100_SMEM
    assert k1.resident_smem_bytes(17, B) > H100_SMEM
    assert k1.fused_head_schedule(C, P, B, R, need - 1, 1) == "windowed"
    assert k1.fused_head_schedule(C, P, B, R, need, 1) == "resident"


@pytest.mark.parametrize("P,R,C,F,depth", [
    (16, 1, 3, 17, 0),    # the single block: tile 1, 4 partitions ahead
    (16, 8, 2, 9, 0),     # the super-step: one full tile of 8
    (6, 5, 5, 9, 0),      # R and P off the tile and the chunk, odd C
    (20, 19, 3, 7, 0),    # tiles of 16, the last one ragged
    (64, 48, 1, 5, 0),    # the uniform render's P and R
    (1, 20, 2, 5, 0),     # one partition
    (9, 33, 5, 3, 4),     # a deeper history, C * F odd
    (3, 1, 1, 9, 7),      # the crossfade's old-filter block
])
def test_head_mac_schedule_matches_plain_and_contract(rng, P, R, C, F, depth):
    V, H, plain = _head_mac_case(rng, P, R, C, F, depth)
    got = _head_mac_model(torch.from_numpy(V), torch.from_numpy(H), R).numpy()
    assert snr_db(plain, got) >= 120.0
    want = adjoint.xla_head_mac(jnp.asarray(V[:, :P + R]), jnp.asarray(H), R)
    assert snr_db(np.asarray(want), got) >= 120.0


# ---- K2 xt-grouped tail MAC ---------------------------------------------------

@pytest.mark.parametrize("P,C,F", [(5, 5, 33), (6, 8, 65), (1, 3, 17),
                                   (2, 1, 9)])
def test_xt_grouped_mac_plain_matches_xla_contract(rng, P, C, F):
    for slot0 in sorted({0, P // 2, P - 1}):
        q, xt, H = _arrays(rng, *[(2, P, C, F)] * 3)
        want = _xla_xt_grouped_mac(
            jnp.asarray(q), jnp.asarray(xt), jnp.asarray(H), slot0, 1, F)
        got = k2.xt_grouped_mac_plain(
            torch.from_numpy(q), torch.from_numpy(xt), torch.from_numpy(H),
            slot0)
        assert got.shape == (2, P, C, F)
        assert snr_db(np.asarray(want), got.numpy()) >= 110.0


def test_xt_grouped_mac_plain_matches_pallas_interpret(rng):
    P, C, F, slot0 = 3, 8, 33, 2
    q, xt, H = _arrays(rng, *[(2, P, C, F)] * 3)
    want = xt_grouped_mac_pallas(jnp.asarray(q), jnp.asarray(xt),
                                 jnp.asarray(H), slot0, interpret=True)
    got = k2.xt_grouped_mac_plain(torch.from_numpy(q), torch.from_numpy(xt),
                                  torch.from_numpy(H), slot0)
    assert snr_db(np.asarray(want), got.numpy()) >= 110.0


# ---- the schedule of the CUDA K2, modelled in numpy ----------------------------

def _xt_grouped_mac_model(queue, xt, H, slot0, vec_ok=True):
    """Both kernels of ``csrc/xt_grouped_mac.cu``, thread by thread over
    flat ``[2, P, N]`` planes, ``N = C F``.  The dispatch is by ``P``
    alone: the register kernel up to ``XT_UNROLLED_PARTS``, the general
    one above.  A register thread owns ``XT_VEC`` consecutive elements
    where ``N`` is a multiple of it and every plane is aligned to it
    (``vec_ok``), else one; a general thread owns one.  Threads of whole
    CTAs of 128 take ``at = thread * V`` (those past ``N`` return); each
    element reads the queue's slot ``(slot0 + i) % P`` as the ``i``-th
    oldest half spectrum, takes its sign from its own ``at % F``, forms
    the windows in place (ascending, so ``t[k + 1]`` is still whole) and
    sums ``w[P - 1 + j - p] H[p]``, p ascending.  The two kernels differ
    in where the windows live, not in this arithmetic.  Returns ``(out,
    path)``, path ``"unrolled"`` with ``V`` or ``"general"``."""
    _, P, C, F = H.shape
    N = C * F
    if P > k2.XT_UNROLLED_PARTS:
        path, V = "general", 1
    elif N % k2.XT_VEC == 0 and vec_ok:
        path, V = f"unrolled V={k2.XT_VEC}", k2.XT_VEC
    else:
        path, V = "unrolled V=1", 1
    q, x, h = (a.reshape(2, P, N) for a in (queue, xt, H))
    out = np.full((2, P, N), np.nan, np.float32)   # poisoned: all written?
    first = np.arange(-(-N // V // 128) * 128, dtype=np.int64) * V
    first = first[first < N]                       # the live threads
    at = (first[:, None] + np.arange(V)).ravel()   # their elements
    assert np.array_equal(np.sort(at), np.arange(N))   # each exactly once
    s = np.where((at % F) & 1, -1.0, 1.0).astype(np.float32)
    t = np.empty((2, 2 * P, at.size), np.float32)
    for i in range(P):
        slot = slot0 + i
        if slot >= P:
            slot -= P
        t[:, i] = q[:, slot, at]
        t[:, P + i] = x[:, i, at]
    for k in range(2 * P - 1):
        t[:, k] += s * t[:, k + 1]
    for j in range(P):
        ar = np.zeros(at.size, np.float32)
        ai = np.zeros(at.size, np.float32)
        for p in range(P):
            k = P - 1 + j - p
            ar += t[0, k] * h[0, p, at] - t[1, k] * h[1, p, at]
            ai += t[0, k] * h[1, p, at] + t[1, k] * h[0, p, at]
        out[0, j, at], out[1, j, at] = ar, ai
    return out.reshape(H.shape), path


_V = f"unrolled V={k2.XT_VEC}"


@pytest.mark.parametrize("P,C,F,vec_ok,path", [
    (6, 4, 33, True, _V),             # the headline's Pt
    (6, 5, 33, True, "unrolled V=1"),  # C F odd: one element a thread
    (1, 2, 9, True, _V),              # one partition: a single window
    (2, 6, 17, True, _V),
    (3, 2, 129, True, _V),            # more than one CTA, the last partly empty
    (4, 3, 8, True, _V),              # even F: rows start on either parity
    (5, 2, 65, True, _V),
    (7, 2, 33, True, _V),
    (8, 2, 17, True, _V),
    (9, 2, 17, True, _V),             # general until the template reached 16
    (12, 3, 9, True, "unrolled V=1"),
    (14, 4, 129, True, _V),           # config #5's tail partitions
    (14, 3, 33, True, "unrolled V=1"),
    (14, 4, 33, False, "unrolled V=1"),  # a plane off the vector boundary
    (16, 2, 33, True, _V),            # the register kernel's last P
    (17, 2, 17, True, "general"),     # the first general one
    (17, 3, 9, True, "general"),
])
def test_xt_grouped_mac_schedule_matches_plain_and_contract(rng, P, C, F,
                                                            vec_ok, path):
    for slot0 in range(P):
        q, xt, H = _arrays(rng, *[(2, P, C, F)] * 3)
        got, took = _xt_grouped_mac_model(q, xt, H, slot0, vec_ok)
        assert took == path
        assert np.all(np.isfinite(got))            # every element written
        plain = k2.xt_grouped_mac_plain(*map(torch.from_numpy, (q, xt, H)),
                                        slot0).numpy()
        assert snr_db(plain, got) >= 110.0
        want = _xla_xt_grouped_mac(
            jnp.asarray(q), jnp.asarray(xt), jnp.asarray(H), slot0, 1, F)
        assert snr_db(np.asarray(want), got) >= 110.0


def test_cplane_mac_matches_xla_head_mac(rng):
    """The MAC both plain versions share is the K7 (head MAC) contract."""
    P, R, C, F = 6, 3, 4, 17
    V, H = _arrays(rng, (2, P + R, C, F), (2, P, C, F))
    want = adjoint.xla_head_mac(jnp.asarray(V), jnp.asarray(H), R)
    got = k2.cplane_mac(torch.from_numpy(V), torch.from_numpy(H), R)
    assert snr_db(np.asarray(want), got.numpy()) >= 110.0


# ---- K3/K4 tail transforms ------------------------------------------------------

def test_tail_transforms_plain_match_pallas_interpret(rng):
    """The Pallas kernels compute the same transforms in the TPU's
    permuted bin order; mapped to the natural order they agree with the
    plain versions.  Their stage matmuls split float32 into bf16 parts,
    which bounds the agreement near 100 dB, as for the fused head."""
    n, r, rows = 4096, 8, 8
    x = rng.standard_normal((rows, n // 2)).astype(np.float32)
    perm = np.asarray(perm_rfft_half_pallas(jnp.asarray(x), n, radix=r,
                                            interpret=True))
    std = jfft.unpermute_half_spectrum(perm[0] + 1j * perm[1], n, radix=r)
    got = k34.rfft_half_plain(torch.from_numpy(x), n).numpy()
    assert snr_db(np.stack([std.real, std.imag]), got) >= 90.0

    spec = rng.standard_normal((2, rows, n // 2 + 1)).astype(np.float32)
    spec[1][:, [0, -1]] = 0.0          # a real signal's DC and Nyquist
    pspec = jfft.permute_half_spectrum(spec[0] + 1j * spec[1], n, radix=r)
    want = perm_irfft_tail_pallas(
        jnp.asarray(np.stack([pspec.real, pspec.imag]).astype(np.float32)),
        n, interpret=True)
    got = k34.irfft_tail_plain(torch.from_numpy(spec), n).numpy()
    assert snr_db(np.asarray(want), got) >= 90.0


# ---- the schedule of the CUDA K3 and K4, modelled in PyTorch --------------------

def _k34_rows_per_cta(M, T):
    """``rows_per_cta`` of ``csrc/half_fft.cu``: a warp's worth of rows,
    doubled up to 256 threads while 264 CTAs remain."""
    cap = max(256 // T, 1)
    r = min(max(32 // T, 1), cap)
    while 2 * r <= cap and 2 * r <= M // 264:
        r *= 2
    return r


def _swizzled(i, NP):
    """``Swizzled<NP>`` of ``csrc/fft_common.cuh``."""
    if NP == 16:
        return i ^ ((i >> 4) & 15)
    return i ^ ((i >> 4) & 7) ^ ((i >> 3) & 8)


def _dft_rows(R, rows, n_in):
    """Rows ``rows`` of the R-point DFT matrix over its first ``n_in``
    inputs, complex64."""
    q = torch.tensor(rows, dtype=torch.float64)[:, None]
    m = torch.arange(n_in, dtype=torch.float64)[None, :]
    return torch.polar(torch.ones(len(rows), n_in, dtype=torch.float64),
                       -2.0 * np.pi * q * m / R).to(torch.complex64)


def _fft_regs_model(v, B, NP, tw, upper_zero=False, tail_only=False):
    """``fft_regs`` of ``csrc/fft_common.cuh`` for the transforms of one
    CTA: ``v [rows, NP, T]`` holds ``z[t + m T]`` at ``[m, t]``, and comes
    back as the transform in the same layout.  Stockham stages of radix NP,
    then what is left, with the kernel's twiddle indices into its stage
    tables ``tw`` and its swizzled exchange buffer, every slot of which
    must be written before it is read.  ``upper_zero``: the first stage
    reads ``v[:, :NP/2]`` alone.  ``tail_only``: the last stage computes
    ``v[:, NP/2:]`` alone and leaves NaN in the rest."""
    rows, _, T = v.shape
    t = torch.arange(T)
    NS, table = 1, 0
    v = v.clone()
    if upper_zero:
        v[:, NP // 2:] = float("nan")
    while True:
        R = min(NP, B // NS)
        G = NP // R
        last = NS * R == B
        if NS > 1:
            for u in range(G):
                k = (t + u * T) & (NS - 1)
                for q in range(1, R):
                    v[:, u + q * G] *= tw[table + (q - 1) * NS + k]
            table += (R - 1) * NS
        n_in = R // 2 if upper_zero and NS == 1 else R
        outs = list(range(R // 2, R)) if tail_only and last else list(range(R))
        D = _dft_rows(R, outs, n_in)
        new = torch.full_like(v, float("nan"))
        for u in range(G):
            ins = v[:, [u + q * G for q in range(n_in)]]       # [rows, n_in, T]
            new[:, [u + q * G for q in outs]] = torch.einsum("qm,rmt->rqt",
                                                             D, ins)
        v = new
        if last:
            assert table == len(tw) - (B + 1)    # every stage table was used
            return v
        buf = torch.full((rows, B), float("nan"), dtype=v.dtype)
        for u in range(G):
            j = t + u * T
            k = j & (NS - 1)
            d = (j - k) * R + k
            for q in range(R):
                buf[:, _swizzled(d + q * NS, NP)] = v[:, u + q * G]
        assert not torch.isnan(buf.real).any()
        for m in range(NP):
            v[:, m] = buf[:, _swizzled(t + m * T, NP)]
        NS *= R


def _k34_ctas(M, h):
    """The rows of each CTA of a launch over ``M`` rows."""
    T = h // k34._points(h)
    rpc = _k34_rows_per_cta(M, T)
    return [range(c, min(c + rpc, M)) for c in range(0, M, rpc)]


def _k34_tables(n):
    """The stage tables with the real transform's twiddles behind them
    (the FFT model checks where the one ends), and the latter alone."""
    tw = torch.view_as_complex(torch.from_numpy(k34._twiddle_table(n)))
    return tw, tw[-(n // 2 + 1):]


def _rfft_half_model(x, n):
    """``rfft_half_kernel``: per CTA, its rows' sample pairs (the lower
    half of the packed window; the zero half is never made), the pruned
    transform, and the bins ``k < h/2`` and ``h - k`` together from
    ``Z[k]`` in registers and ``Z[h-k]`` through half an exchange more, in
    natural order; thread 0 adds the middle bin."""
    M, h = x.shape
    NP = k34._points(h)
    T = h // NP
    tw, twh = _k34_tables(n)
    t = torch.arange(T)
    out = torch.full((M, h + 1), float("nan"), dtype=torch.complex64)
    for rows in _k34_ctas(M, h):
        z = torch.view_as_complex(x[rows.start:rows.stop].reshape(-1, h // 2, 2))
        v = torch.full((len(rows), NP, T), float("nan"), dtype=torch.complex64)
        v[:, :NP // 2] = z.reshape(-1, NP // 2, T)
        v = _fft_regs_model(v, h, NP, tw, upper_zero=True)
        buf = torch.full((len(rows), h), float("nan"), dtype=torch.complex64)
        for m in range(NP // 2, NP):
            buf[:, t + m * T] = v[:, m]
        buf[:, 0] = v[:, 0, 0]            # k = 0 pairs Z[0] with itself
        for m in range(NP // 2):
            k = t + m * T
            zk, zc = v[:, m], buf[:, (h - k) & (h - 1)].conj()
            e, o = 0.5 * (zk + zc), twh[k] * (-0.5j * (zk - zc))
            Xk, Xhk = e + o, (e - o).conj()
            Xk.imag[:, k == 0] = 0.0
            Xhk.imag[:, k == 0] = 0.0
            out[rows.start:rows.stop, k] = Xk
            out[rows.start:rows.stop, h - k] = Xhk
        mid = v[:, NP // 2, 0]            # the middle bin, its own partner
        out[rows.start:rows.stop, h // 2] = mid.conj()
    return torch.stack([out.real, out.imag])


def _irfft_tail_model(planes, n):
    """``irfft_tail_kernel``: per CTA, the packed spectrum from ``X[k]`` and
    ``X[h-k]`` with DC's and Nyquist's imaginary parts dropped, re and im
    swapped into the forward transform and out of it, and of the last
    stage only the tail half's outputs."""
    _, M, F = planes.shape
    h = F - 1
    NP = k34._points(h)
    T = h // NP
    tw, twh = _k34_tables(n)
    t = torch.arange(T)
    Xc = torch.complex(planes[0], planes[1])
    y = torch.full((M, h), float("nan"))
    swap = lambda z: torch.complex(z.imag, z.real)
    for rows in _k34_ctas(M, h):
        Xr = Xc[rows.start:rows.stop]
        v = torch.empty((len(rows), NP, T), dtype=torch.complex64)
        for m in range(NP):
            k = t + m * T
            a, b = Xr[:, k].clone(), Xr[:, h - k].clone()
            a.imag[:, k == 0] = 0.0
            b.imag[:, k == 0] = 0.0
            b = b.conj()
            v[:, m] = swap(0.5 * (a + b) + 0.5j * (a - b) * twh[k].conj())
        v = _fft_regs_model(v, h, NP, tw, tail_only=True)
        z = swap(v[:, NP // 2:]).reshape(len(rows), h // 2) / h
        y[rows.start:rows.stop] = torch.view_as_real(z).reshape(-1, h)
    return y


@pytest.mark.parametrize("h,rows", [
    (32, 1), (32, 5), (32, 13),        # 8 rows a CTA: 13 leaves 3 slots empty
    (64, 1), (64, 5), (64, 7),         # 4 rows a CTA
    (256, 1), (256, 5), (256, 531),    # 2 rows a CTA from 528 rows on
    (512, 1), (512, 5), (512, 529),
    (1024, 5), (1024, 529),            # 16 points a thread: radix 16, 16, 4
    (2048, 1), (2048, 5), (2048, 3),   # radix 16, 16, 8
    (4096, 1), (4096, 5), (4096, 3),   # radix 16, 16, 16; a row a CTA
    (8192, 1), (8192, 5), (8192, 3),   # radix 16, 16, 16, 2
])
def test_tail_transform_schedules_match_plain(rng, h, rows):
    n = 2 * h
    x, spec = _arrays(rng, (rows, h), (2, rows, h + 1))
    x, spec = torch.from_numpy(x), torch.from_numpy(spec)
    got = _rfft_half_model(x, n)
    assert not torch.isnan(got).any()
    assert snr_db(k34.rfft_half_plain(x, n).numpy(), got.numpy()) >= 110.0
    got = _irfft_tail_model(spec, n)
    assert not torch.isnan(got).any()
    assert snr_db(k34.irfft_tail_plain(spec, n).numpy(), got.numpy()) >= 110.0


def test_tail_transform_schedules_match_pallas_interpret(rng):
    """The models against the Pallas kernels, mapped from the permuted bin
    order; the kernels' bf16 split bounds the agreement, as above."""
    n, r, rows = 4096, 8, 8
    x = rng.standard_normal((rows, n // 2)).astype(np.float32)
    perm = np.asarray(perm_rfft_half_pallas(jnp.asarray(x), n, radix=r,
                                            interpret=True))
    std = jfft.unpermute_half_spectrum(perm[0] + 1j * perm[1], n, radix=r)
    got = _rfft_half_model(torch.from_numpy(x), n).numpy()
    assert snr_db(np.stack([std.real, std.imag]), got) >= 90.0

    spec = rng.standard_normal((2, rows, n // 2 + 1)).astype(np.float32)
    spec[1][:, [0, -1]] = 0.0
    pspec = jfft.permute_half_spectrum(spec[0] + 1j * spec[1], n, radix=r)
    want = perm_irfft_tail_pallas(
        jnp.asarray(np.stack([pspec.real, pspec.imag]).astype(np.float32)),
        n, interpret=True)
    got = _irfft_tail_model(torch.from_numpy(spec), n).numpy()
    assert snr_db(np.asarray(want), got) >= 90.0


# ---- K5 gather_supers and K6 delayed_add: bit-exact ---------------------------

@pytest.mark.parametrize("C,nsup,B2", [(16, 5, 64), (5, 6, 32), (1, 1, 8),
                                       (8, 2, 33)])
def test_gather_supers_plain_is_exact(rng, C, nsup, B2):
    (x,) = _arrays(rng, (C, nsup * B2))
    got = k56.gather_supers_plain(torch.from_numpy(x), nsup).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(adjoint.xla_gather_supers(jnp.asarray(x), nsup)))
    np.testing.assert_array_equal(
        got, np.asarray(gather_supers_pallas(jnp.asarray(x), nsup,
                                             interpret=True)))


@pytest.mark.parametrize("C,Pt,B2", [(16, 5, 64), (5, 2, 32), (3, 1, 16),
                                     (8, 6, 33)])
def test_delayed_add_plain_is_exact(rng, C, Pt, B2):
    yh, pend, tail = _arrays(rng, (C, Pt * B2), (2, C, B2), (Pt, C, B2))
    got = k56.delayed_add_plain(*map(torch.from_numpy, (yh, pend, tail)))
    jargs = tuple(map(jnp.asarray, (yh, pend, tail)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(adjoint.xla_delayed_add(*jargs)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(delayed_add_pallas(*jargs, interpret=True)))


def test_delayed_add_plain_takes_strided_tail(rng):
    """The render passes the inverse transform's tail half, a row-strided
    view; the result equals the dense tensor's."""
    C, Pt, B2 = 4, 3, 16
    yh, pend, full = _arrays(rng, (C, Pt * B2), (2, C, B2), (Pt, C, 2 * B2))
    view = torch.from_numpy(full)[..., B2:]
    assert not view.is_contiguous()
    a = k56.delayed_add_plain(torch.from_numpy(yh), torch.from_numpy(pend),
                              view)
    b = k56.delayed_add_plain(torch.from_numpy(yh), torch.from_numpy(pend),
                              view.contiguous())
    assert torch.equal(a, b)


# ---- K7/K8 head MAC and K9 rotated MAC ----------------------------------------

def _head_mac_case(rng, P, R, C, F, depth=0):
    V, H = _arrays(rng, (2, P + R + depth, C, F), (2, P, C, F))
    got = k79.head_mac_plain(torch.from_numpy(V), torch.from_numpy(H), R)
    assert got.shape == (2, R, C, F)
    return V, H, got.numpy()


@pytest.mark.parametrize("P,R,C,F", [
    (6, 3, 1, 17),     # one channel: K8's regime
    (16, 1, 5, 33),    # odd C, one block (the small-block head)
    (4, 9, 5, 9),      # R > P, odd C
    (1, 2, 1, 5),      # one partition
])
def test_head_mac_plain_matches_xla_contract_and_untiled_pallas(rng, P, R,
                                                               C, F):
    V, H, got = _head_mac_case(rng, P, R, C, F)
    want = adjoint.xla_head_mac(jnp.asarray(V), jnp.asarray(H), R)
    assert snr_db(np.asarray(want), got) >= 120.0
    pallas = head_mac_pallas(jnp.asarray(V), jnp.asarray(H), R,
                             interpret=True)
    assert snr_db(np.asarray(pallas), got) >= 120.0


def test_head_mac_plain_matches_tiled_pallas(rng):
    P, R, C, F = 8, 4, 16, 33
    V, H, got = _head_mac_case(rng, P, R, C, F)
    want = head_mac_tiled_pallas(jnp.asarray(V), jnp.asarray(H), R, ct=8,
                                 interpret=True)
    assert snr_db(np.asarray(want), got) >= 120.0


def test_head_mac_plain_reads_the_first_slots_of_a_deeper_history(rng):
    """A history deeper than ``P + R`` gives the MAC of its first
    ``P + R`` slots (the crossfade's old-filter block relies on it)."""
    P, R, C, F = 5, 1, 3, 9
    V, H, got = _head_mac_case(rng, P, R, C, F, depth=4)
    short = k79.head_mac_plain(torch.from_numpy(V[:, :P + R].copy()),
                               torch.from_numpy(H), R)
    assert torch.equal(short, torch.from_numpy(got))


@pytest.mark.parametrize("P,C,F", [(5, 16, 33), (3, 5, 17), (1, 1, 9)])
def test_rotated_mac_plain_matches_xla_contract_at_every_slot(rng, P, C, F):
    q, H = _arrays(rng, (2, P, C, F), (2, P, C, F))
    for slot in range(P):
        want = adjoint.xla_rotated_mac(jnp.asarray(q), jnp.asarray(H), slot)
        got = k79.rotated_mac_plain(torch.from_numpy(q), torch.from_numpy(H),
                                    slot)
        assert got.shape == (2, C, F)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
        assert snr_db(np.asarray(want), got.numpy()) >= 120.0


def test_rotated_mac_plain_matches_pallas_at_every_slot(rng):
    P, C, F = 5, 16, 65
    q, H = _arrays(rng, (2, P, C, F), (2, P, C, F))
    for slot in range(P):
        want = rotated_mac_pallas(jnp.asarray(q), jnp.asarray(H), slot, ct=8,
                                  interpret=True)
        got = k79.rotated_mac_plain(torch.from_numpy(q), torch.from_numpy(H),
                                    slot)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
        assert snr_db(np.asarray(want), got.numpy()) >= 120.0



# ---- the schedule of the CUDA K9, modelled in numpy ----------------------------

def _rotated_mac_model(queue, H, slot, aligned=True):
    """``csrc/spectral_mac.cu``'s K9 thread by thread over flat ``[2, P,
    N]`` planes, ``N = C F``, by ``k79.ROTATED_MAC_SCHEDULE``: a thread
    takes ``vec`` consecutive bins where ``N`` is a multiple of ``vec`` and
    the planes are aligned, else one; a CTA is ``lanes`` threads along the
    bins times ``split`` rows; row ``g`` sums partitions ``g P // split ..
    (g + 1) P // split - 1`` in ascending order (chunks of ``ahead`` loaded
    before their MACs, which leaves the arithmetic as it is), the queue
    widened to float32, from slot ``(slot - p) mod P``; then one thread an
    output of the CTA adds the rows' sums in row order.  Returns ``(out,
    vec)``; bins no thread writes stay NaN."""
    sch = k79.ROTATED_MAC_SCHEDULE
    lanes, split = sch["lanes"], sch["split"]
    _, P, C, F = H.shape
    N = C * F
    vec = sch["vec"] if N % sch["vec"] == 0 and aligned else 1
    q = np.asarray(queue, np.float32).reshape(2, P, N)
    h = np.asarray(H, np.float32).reshape(2, P, N)
    per_cta = lanes * vec
    ctas = -(-N // per_cta)
    out = np.full((2, N), np.nan, np.float32)
    # each thread's first bin, [cta, lane]; a live thread's bins are all
    # live (N is a multiple of vec)
    first = (np.arange(ctas)[:, None] * per_cta
             + np.arange(lanes)[None, :] * vec)
    live = first < N
    assert np.all(first[live] + vec <= N)
    bins = (first[..., None] + np.arange(vec)).reshape(-1)      # [thread bins]
    keep = np.repeat(live.reshape(-1), vec)
    part = np.zeros((2, split, bins.size), np.float32)
    for g in range(split):
        acc = np.zeros((2, int(keep.sum())), np.float32)
        for p in range(g * P // split, (g + 1) * P // split):
            k = (slot - p) % P
            qr, qi = q[0, k, bins[keep]], q[1, k, bins[keep]]
            hr, hi = h[0, p, bins[keep]], h[1, p, bins[keep]]
            acc[0] += qr * hr - qi * hi
            acc[1] += qr * hi + qi * hr
        part[:, g, keep] = acc
    # the combine: output j of a CTA is lane j // vec's bin j % vec, i.e.
    # bin tile + j, which the flat order of ``bins`` already is
    tot = part[:, 0].copy()
    for g in range(1, split):
        tot += part[:, g]
    written = bins < N
    assert np.all(np.isnan(out[:, bins[written]]))             # once each
    out[:, bins[written]] = tot[:, written]
    return out.reshape(2, C, F), vec


@pytest.mark.parametrize("qdt", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("P,C,F,aligned,vec", [
    (1, 1, 513, True, 1),     # one partition; C F odd: one bin a thread
    (1, 4, 33, True, 4),      # one partition on the vector path
    (8, 1, 513, True, 1),     # BASELINE config #1's block
    (8, 3, 17, True, 1),      # C F odd
    (8, 4, 17, True, 4),      # C F = 68: the vector path
    (5, 4, 17, True, 4),      # fewer partitions than rows, uneven rows
    (64, 1, 513, True, 1),
    (64, 4, 33, True, 4),
    (64, 4, 33, False, 1),    # planes off a vector boundary: one bin
])
def test_rotated_mac_schedule_matches_contract_and_pallas(rng, qdt, P, C, F,
                                                          aligned, vec):
    """The CUDA K9's schedule against ``adjoint.xla_rotated_mac`` and the
    Pallas kernel in interpret mode, over a float32, bfloat16 or float16
    queue, at every slot up to P = 8 and at slots 0, 37 and P - 1 at
    P = 64."""
    jdt = getattr(jnp, qdt)
    q, H = _arrays(rng, (2, P, C, F), (2, P, C, F))
    qj = jnp.asarray(q).astype(jdt)
    q = np.array(qj.astype(jnp.float32))         # the stored values
    slots = range(P) if P <= 8 else (0, 37, P - 1)
    for slot in slots:
        got, took = _rotated_mac_model(q, H, slot, aligned)
        assert took == vec and np.all(np.isfinite(got))
        want = adjoint.xla_rotated_mac(qj, jnp.asarray(H), slot)
        assert snr_db(np.asarray(want), got) >= 110.0
        pallas = rotated_mac_pallas(qj, jnp.asarray(H), slot, interpret=True)
        assert snr_db(np.asarray(pallas), got) >= 110.0
        plain = k79.rotated_mac_plain(torch.from_numpy(q).to(
            getattr(torch, qdt)), torch.from_numpy(H), slot).numpy()
        assert snr_db(plain, got) >= 110.0

def test_plain_k1_and_k2_do_not_count_as_head_mac(rng):
    """K1's and K2's plain versions share the MAC with K7's plain version
    but not its count."""
    ops_hook.reset_counts()
    C, P, B, R = 3, 2, 32, 2
    ins = [torch.from_numpy(a) for a in _head_inputs(rng, C, P, B, R)]
    ops_hook.fused_head(*ins, B)
    q = torch.zeros(2, 2, C, 9)
    ops_hook.xt_grouped_mac(q, q, q, 0)
    plain = ops_hook.counts()["plain"]
    assert plain["head_mac"] == 0 and plain["rotated_mac"] == 0
    assert plain["fused_head"] == plain["xt_grouped_mac"] == 1


def test_mac_wrappers_refuse_what_the_kernels_do_not_take():
    C, P, F = 3, 4, 9
    V, H = torch.zeros(2, P + 2, C, F), torch.zeros(2, P, C, F)
    with pytest.raises(ValueError, match="CUDA"):
        k79.head_mac_cuda(V, H, 2)                      # CPU tensors
    with pytest.raises(ValueError, match="CUDA"):
        k79.head_mac_cuda(V, H, 1)                      # deeper history
    with pytest.raises(ValueError, match="shape"):
        k79.head_mac_cuda(V, H, 3)                      # history too short
    with pytest.raises(ValueError, match="shape"):
        k79.head_mac_cuda(V[:, :, :2], H, 2)
    with pytest.raises(ValueError, match="shape"):
        k79.head_mac_cuda(V, H[0], 2)
    with pytest.raises(ValueError, match="dtype"):
        k79.head_mac_cuda(V.double(), H, 2)
    with pytest.raises(ValueError, match="contiguous"):
        k79.head_mac_cuda(V, H.transpose(2, 3).contiguous().transpose(2, 3),
                          2)
    with pytest.raises(ValueError, match="CUDA"):
        k79.rotated_mac_cuda(H, H, 5)
    with pytest.raises(ValueError, match="shape"):
        k79.rotated_mac_cuda(V, H, 0)
    with pytest.raises(ValueError, match="dtype"):
        k79.rotated_mac_cuda(H.double(), H, 0)          # float32/16, bf16
    with pytest.raises(ValueError, match="dtype"):
        k79.rotated_mac_cuda(H, H.half(), 0)            # H is float32
    with pytest.raises(ValueError, match="contiguous"):
        k79.rotated_mac_cuda(H, H.transpose(2, 3).contiguous().transpose(2, 3),
                             0)
    xt = torch.zeros(2, C, F)
    with pytest.raises(ValueError, match="CUDA"):
        k79.xt_step_mac_cuda(H, xt, H, 1, True)         # CPU tensors
    with pytest.raises(ValueError, match="shape"):
        k79.xt_step_mac_cuda(V, xt, H, 0)
    with pytest.raises(ValueError, match="shape"):
        k79.xt_step_mac_cuda(H, H, H, 0)                # xt is one step
    with pytest.raises(ValueError, match="dtype"):
        k79.xt_step_mac_cuda(H.double(), xt, H, 0)      # float32/16, bf16
    with pytest.raises(ValueError, match="dtype"):
        k79.xt_step_mac_cuda(H, xt.half(), H, 0)        # xt is float32
    with pytest.raises(ValueError, match="contiguous"):
        k79.xt_step_mac_cuda(H.transpose(2, 3).contiguous().transpose(2, 3),
                             xt, H, 0)


# ---- dispatch and the kernel wrappers' checks ---------------------------------

def test_dispatch_takes_plain_versions_on_cpu_and_counts(rng):
    ops_hook.reset_counts()
    C, P, B, R = 4, 2, 32, 2
    ins = [torch.from_numpy(a) for a in _head_inputs(rng, C, P, B, R)]
    ops_hook.fused_head(*ins, B)
    xt = ops_hook.rfft_half(ins[0], 2 * R * B)
    ops_hook.irfft_tail(xt, 2 * R * B)
    q = torch.zeros(2, 2, C, 9)
    ops_hook.xt_grouped_mac(q, q, q, 1)
    ops_hook.gather_supers(ins[0], 2)
    ops_hook.delayed_add(ins[0], torch.zeros(2, C, B), torch.zeros(2, C, B))
    ops_hook.head_mac(torch.zeros(2, 3, C, 9), q, 1)
    ops_hook.rotated_mac(q, q, 1)
    ops_hook.rotated_mac(q.bfloat16(), q, 1)
    ops_hook.rotated_mac(q.half(), q, 1)
    ops_hook.xt_step_mac(q, q[:, 0], q, 1)
    counts = ops_hook.counts()
    assert counts["plain"] == dict.fromkeys(counts["plain"], 1)
    assert counts["launches"] == dict.fromkeys(counts["launches"], 0)
    ops_hook.reset_counts()
    assert not any(ops_hook.counts()["plain"].values())


def test_dispatch_refuses_other_devices():
    x = torch.empty(4, 64, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops_hook.gather_supers(x, 2)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(rng):
    C, P, B, R = 4, 2, 32, 2
    ins = [torch.from_numpy(a) for a in _head_inputs(rng, C, P, B, R)]
    with pytest.raises(ValueError, match="CUDA"):
        k1.fused_head_cuda(*ins, B)                    # CPU tensors
    with pytest.raises(ValueError, match="power-of-two"):
        k1.fused_head_cuda(*ins, 48)
    with pytest.raises(ValueError, match="power-of-two"):
        k1.fused_head_cuda(*ins, 2048)
    with pytest.raises(ValueError, match="shape"):
        k1.fused_head_cuda(ins[0], ins[1][:, :1], ins[2], ins[3], B)
    with pytest.raises(ValueError, match="dtype"):
        k1.fused_head_cuda(ins[0].double(), *ins[1:], B)
    with pytest.raises(ValueError, match="contiguous"):
        k1.fused_head_cuda(ins[0].t().contiguous().t(), *ins[1:], B)
    with pytest.raises(ValueError, match="schedule"):
        k1.fused_head_cuda_as("tiled", *ins, B)
    with pytest.raises(ValueError, match="CUDA"):
        k1.fused_head_cuda_as("resident", *ins, B)     # CPU tensors
    q = torch.zeros(2, 3, C, 9)
    with pytest.raises(ValueError, match="CUDA"):
        k2.xt_grouped_mac_cuda(q, q, q, 0)
    with pytest.raises(ValueError, match="P <="):
        big = torch.zeros(2, k2.XT_MAX_PARTS + 1, 1, 3)
        k2.xt_grouped_mac_cuda(big, big, big, 0)
    with pytest.raises(ValueError, match="split"):
        k56.gather_supers_cuda(torch.zeros(C, 10), 3)
    with pytest.raises(ValueError, match="CUDA"):
        k56.gather_supers_cuda(torch.zeros(C, 12), 3)
    tail = torch.zeros(2, C, 16)
    with pytest.raises(ValueError, match="contiguous"):
        k56.delayed_add_cuda(torch.zeros(C, 32), torch.zeros(2, C, 16),
                             tail.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA"):
        k56.delayed_add_cuda(torch.zeros(C, 32), torch.zeros(2, C, 16), tail)


class _FakePlanLibrary:
    """Answers ``bbcat_half_fft_plan`` as ``csrc/half_fft.cu`` does for
    a kernel built with ``points(h)`` points a thread."""

    def __init__(self, points):
        self.points = points

    def bbcat_half_fft_plan(self, h, points, radices, cap, nstages, length):
        NP, ns, n, size = self.points(h), 1, 0, 0
        while ns < h:
            r = min(NP, h // ns)
            radices[n] = r
            if ns > 1:
                size += (r - 1) * ns
            ns, n = ns * r, n + 1
        points._obj.value, nstages._obj.value = NP, n
        length._obj.value = size + h + 1
        return 0


@pytest.mark.parametrize("h", [32, 512, 1024, 8192])
def test_twiddle_table_layout_is_held_against_the_kernels(monkeypatch, h):
    """The twiddle table has two owners, the kernels and the wrapper: a
    kernel built for other points a thread than the wrapper lays out is
    refused before a table is made."""
    table_len = k34._twiddle_table(2 * h).shape[0]
    monkeypatch.setattr(k34._build, "library",
                        lambda: _FakePlanLibrary(k34._points))
    k34._check_plan(h, table_len)
    with pytest.raises(RuntimeError, match="twiddle table"):
        k34._check_plan(h, table_len + 1)
    monkeypatch.setattr(k34._build, "library",
                        lambda: _FakePlanLibrary(lambda h: 16))
    if k34._points(h) == 16:
        k34._check_plan(h, table_len)
    else:
        with pytest.raises(RuntimeError, match="change kPoints"):
            k34._check_plan(h, table_len)


def test_tail_transform_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="CUDA"):
        k34.rfft_half_cuda(torch.zeros(3, 64), 128)     # CPU tensors
    with pytest.raises(ValueError, match="power-of-two"):
        k34.rfft_half_cuda(torch.zeros(3, 48), 96)
    with pytest.raises(ValueError, match="power-of-two"):
        k34.rfft_half_cuda(torch.zeros(3, 16), 32)
    with pytest.raises(ValueError, match="shape"):
        k34.rfft_half_cuda(torch.zeros(3, 32), 128)
    with pytest.raises(ValueError, match="dtype"):
        k34.rfft_half_cuda(torch.zeros(3, 64, dtype=torch.float64), 128)
    with pytest.raises(ValueError, match="contiguous"):
        k34.rfft_half_cuda(torch.zeros(64, 3).t(), 128)
    with pytest.raises(ValueError, match="CUDA"):
        k34.irfft_tail_cuda(torch.zeros(2, 3, 65), 128)
    with pytest.raises(ValueError, match="power-of-two"):
        k34.irfft_tail_cuda(torch.zeros(2, 3, 32769), 65536)
    with pytest.raises(ValueError, match="shape"):
        k34.irfft_tail_cuda(torch.zeros(3, 65), 128)
