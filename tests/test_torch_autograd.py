"""Derivatives through the port's kernels against the JAX package.

Each kernel's ``torch.autograd.Function`` (``ops/autograd.py``) is held in
reverse mode against ``jax.vjp`` and in forward mode against ``jax.jvp``
of the matching ``adjoint.xla_*`` contract (for the tail transforms, the
reference's standard-layout ``rfft_half_planes`` / ``irfft_tail_planes``:
its ``xla_perm_*`` contracts are for the permuted layout), on the same
inputs, cotangents and tangents, at >= 110 dB: the bar at which
``tests/test_pallas.py`` holds the kernels to those contracts.  On the CPU
the Functions run the plain versions forward and their vjp backward.

The render is held to the JAX engine built on standard-layout specs with
every kernel gate shut (``mac="0"``, ``fused_head="0"``), the program the
JAX package differentiates when its kernels are off, at >= 80 dB, the bar
of ``tests/test_autodiff.py``: gradients in reverse mode and, where the
JAX package pins its kernel path as raising, tangents in forward mode.
The IR fit and the modal IIR's gradient are ported from that file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bbcat_dsp_tpu.convolve import NonUniformConvolver as JaxConvolver
from bbcat_dsp_tpu.convolve import fft as jfft
from bbcat_dsp_tpu.convolve.fft import resolve_spectral_spec
from bbcat_dsp_tpu.convolve.nonuniform import _render_impl as jax_render
from bbcat_dsp_tpu.filters.iir import ModalParams as JaxModalParams
from bbcat_dsp_tpu.filters.iir import modal_apply as jax_modal_apply
from bbcat_dsp_tpu.ops.pallas import adjoint
from bbcat_dsp_torch import NonUniformConvolver, ops_hook
from bbcat_dsp_torch.convolve import (
    convolver_init,
    convolver_render,
    convolver_step,
    ir_spectra,
    nonuniform_render,
    nonuniform_spectra,
    partition_ir,
    rfft_planes,
)
from bbcat_dsp_torch.filters.iir import ModalParams, modal_apply
from bbcat_dsp_torch.ops import autograd as ag
from conftest import snr_db


@pytest.fixture(autouse=True)
def one_torch_thread():
    """PyTorch's CPU ops on one thread: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _xla_contract(fn, *statics):
    return jax.jit(lambda *a: fn(*a, *statics))


def _xla_xt_step_mac(queue, xt, H, slot):
    """K2s's contract, which the JAX package forms with XLA ops in its
    per-super-step tail: the head MAC at one output over the windows of
    the queue rolled to its oldest slot and the new half spectrum."""
    F = H.shape[-1]
    s = jnp.where(jnp.arange(F) % 2, -1.0, 1.0).astype(queue.dtype)
    t = jnp.concatenate([jnp.roll(queue, -slot, axis=1), xt[:, None]], 1)
    w = t[:, :-1] + s * t[:, 1:]
    ext = jnp.concatenate([jnp.zeros_like(w[:, :1]), w], 1)
    return adjoint.xla_head_mac(ext, H, 1)[:, 0]


# kernel -> (port dispatch, JAX contract, operand shapes, statics); C = 4
# channels, odd partition counts, every static off zero
def _cases():
    C, P, B, R, F = 4, 3, 32, 5, 17
    Fh = B + 1
    return {
        "fused_head": (ops_hook.fused_head, adjoint.xla_fused_head,
                       [(C, R * B), (2, P, C, Fh), (2, C, Fh), (2, P, C, Fh)],
                       (B,)),
        "xt_grouped_mac": (
            ops_hook.xt_grouped_mac,
            lambda q, xt, H, s: adjoint.xla_xt_grouped_mac(q, xt, H, s, 1, F),
            [(2, P, C, F)] * 3, (1,)),
        "rfft_half": (ops_hook.rfft_half,
                      lambda x, n: jfft.rfft_half_planes(x, n, backend="xla"),
                      [(3, C, 32)], (64,)),
        "irfft_tail": (
            ops_hook.irfft_tail,
            lambda p, n: jfft.irfft_tail_planes(p, n, backend="xla"),
            [(2, 3, C, 33)], (64,)),
        "gather_supers": (ops_hook.gather_supers, adjoint.xla_gather_supers,
                          [(C, 3 * 16)], (3,)),
        "delayed_add": (ops_hook.delayed_add, adjoint.xla_delayed_add,
                        [(C, 3 * 16), (2, C, 16), (3, C, 16)], ()),
        "head_mac": (ops_hook.head_mac, adjoint.xla_head_mac,
                     [(2, P + R, C, F), (2, P, C, F)], (R,)),
        "rotated_mac": (ops_hook.rotated_mac, adjoint.xla_rotated_mac,
                        [(2, P, C, F), (2, P, C, F)], (2,)),
        "xt_step_mac": (ops_hook.xt_step_mac, _xla_xt_step_mac,
                        [(2, P, C, F), (2, C, F), (2, P, C, F)], (1,)),
    }


KERNELS = list(_cases())
# the bilinear kernels' operand groups: signal first, filter second
GROUPS = {"fused_head": ((0, 1, 2), (3,)), "xt_grouped_mac": ((0, 1), (2,)),
          "head_mac": ((0,), (1,)), "rotated_mac": ((0,), (1,)),
          "xt_step_mac": ((0, 1), (2,))}


def _tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _draw(rng, shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("name", KERNELS)
def test_reverse_mode_matches_jax_vjp_of_the_contract(rng, name):
    port, contract, shapes, statics = _cases()[name]
    ins = _draw(rng, shapes)
    jf = _xla_contract(contract, *statics)
    outs, vjp = jax.vjp(jf, *map(jnp.asarray, ins))
    cts = _draw(rng, [o.shape for o in _tuple(outs)])
    want = vjp(tuple(map(jnp.asarray, cts)) if isinstance(outs, tuple)
               else jnp.asarray(cts[0]))

    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    ops_hook.reset_counts()
    got_out = _tuple(port(*ts, *statics))
    assert all(o.grad_fn is not None for o in got_out)
    got = torch.autograd.grad(got_out, ts, [torch.from_numpy(c) for c in cts])
    counts = ops_hook.counts()
    assert counts["plain"][name] == 1 and counts["adjoint"][name] == 1
    for w, g in zip(want, got):
        assert g.shape == w.shape
        assert snr_db(np.asarray(w), g.numpy()) >= 110.0
    for o, jo in zip(got_out, _tuple(outs)):
        assert snr_db(np.asarray(jo), o.detach().numpy()) >= 110.0


@pytest.mark.parametrize("name", KERNELS)
def test_forward_mode_matches_jax_jvp_of_the_contract(rng, name):
    port, contract, shapes, statics = _cases()[name]
    ins, tans = _draw(rng, shapes), _draw(rng, shapes)
    jf = _xla_contract(contract, *statics)
    _, want = jax.jvp(jf, tuple(map(jnp.asarray, ins)),
                      tuple(map(jnp.asarray, tans)))
    _, got = torch.func.jvp(lambda *a: port(*a, *statics),
                            tuple(map(torch.from_numpy, ins)),
                            tuple(map(torch.from_numpy, tans)))
    for w, g in zip(_tuple(want), _tuple(got)):
        assert g.shape == w.shape
        assert snr_db(np.asarray(w), g.numpy()) >= 110.0


@pytest.mark.parametrize("name,group", [(k, g) for k in GROUPS
                                        for g in (0, 1)])
def test_forward_mode_of_one_operand_group(rng, name, group):
    """A tangent in one group of a bilinear kernel's operands only, through
    ``torch.autograd.forward_ad``: the other group's term is left out, and
    K1's carry outputs, which do not depend on the filter, get a zero
    tangent from a filter tangent."""
    import torch.autograd.forward_ad as fwAD

    port, contract, shapes, statics = _cases()[name]
    ins, tans = _draw(rng, shapes), _draw(rng, shapes)
    for i in GROUPS[name][1 - group]:
        tans[i] = np.zeros_like(tans[i])
    jf = _xla_contract(contract, *statics)
    _, want = jax.jvp(jf, tuple(map(jnp.asarray, ins)),
                      tuple(map(jnp.asarray, tans)))
    with fwAD.dual_level():
        args = [fwAD.make_dual(torch.from_numpy(a), torch.from_numpy(t))
                if i in GROUPS[name][group] else torch.from_numpy(a)
                for i, (a, t) in enumerate(zip(ins, tans))]
        got = [fwAD.unpack_dual(o).tangent
               for o in _tuple(port(*args, *statics))]
    for w, g in zip(_tuple(want), got):
        w = np.asarray(w)
        if not np.any(w):
            assert not torch.any(g)
        else:
            assert snr_db(w, g.numpy()) >= 110.0


def test_tail_inverse_gives_dc_and_nyquist_imaginary_parts_no_cotangent(rng):
    """cuFFT's inverse ignores the imaginary parts of the DC and Nyquist
    bins (``irfft_tail_planes`` zeroes them): their cotangent is 0, as
    JAX's is."""
    n = 64
    planes = torch.from_numpy(rng.standard_normal((2, 3, n // 2 + 1))
                              .astype(np.float32)).requires_grad_()
    y = ops_hook.irfft_tail(planes, n)
    (g,) = torch.autograd.grad(y, planes, torch.randn_like(y))
    assert torch.all(g[1, :, 0] == 0) and torch.all(g[1, :, n // 2] == 0)
    assert torch.all(g[1, :, 1:n // 2] != 0)
    _, vjp = jax.vjp(lambda p: jfft.irfft_tail_planes(p, n, backend="xla"),
                     jnp.asarray(planes.detach().numpy()))
    (jg,) = vjp(jnp.ones((3, n // 2), jnp.float32))
    assert not np.any(np.asarray(jg)[1, :, [0, n // 2]])


def test_the_kernel_gets_storage_backed_contiguous_operands_in_every_mode(
        monkeypatch, rng):
    """A kernel reads its operands through ``data_ptr()``: whatever the
    mode (``torch.func.jvp``, whose tangents and saved inputs are functorch
    wrappers without storage; ``forward_ad``; ``torch.func.grad``; plain
    ``backward``), and whatever the tangent (an expanded zero, a view at an
    odd offset), the kernel gets contiguous, 16-byte aligned tensors with
    storage.  A stand-in for the K7 kernel checks that, taking the card's
    path on CPU tensors."""
    import torch.autograd.forward_ad as fwAD

    from bbcat_dsp_torch.ops.kernels.spectral_mac import head_mac_plain

    calls = []

    def kernel(xext, H, ratio):
        for t in (xext, H):
            assert t.is_contiguous() and t.data_ptr() % 16 == 0
        calls.append(ratio)
        return head_mac_plain(xext, H, ratio)

    Mac = ag._function("Mac", kernel, head_mac_plain, ((0,), (1,)))
    monkeypatch.setattr(ag, "_on_cuda", lambda t: True)
    V, H = (torch.from_numpy(a) for a in _draw(rng, [(2, 5, 3, 9),
                                                     (2, 3, 3, 9)]))
    dV = torch.from_numpy(_draw(rng, [(2, 5, 3, 10)])[0])[..., 1:]
    dH = torch.ones(1, 1, 1, 9).expand(2, 3, 3, 9)

    def mac(a, b):
        return Mac.apply(a, b, 2)

    def plain(a, b):
        return head_mac_plain(a, b, 2)

    _, want = torch.func.jvp(plain, (V, H), (dV, dH))
    _, got = torch.func.jvp(mac, (V, H), (dV, dH))
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-5)
    with fwAD.dual_level():
        got = fwAD.unpack_dual(mac(fwAD.make_dual(V, dV),
                                   fwAD.make_dual(H, dH))).tangent
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-5)
    want = torch.func.grad(lambda a, b: plain(a, b).pow(2).sum(),
                           argnums=(0, 1))(V, H)
    got = torch.func.grad(lambda a, b: mac(a, b).pow(2).sum(),
                          argnums=(0, 1))(V, H)
    assert all(torch.allclose(g, w, rtol=1e-6, atol=1e-5)
               for g, w in zip(got, want))
    assert len(calls) == 1 + 2 + 1 + 2 + 1


# ---- dispatch -------------------------------------------------------------------

def _render_case(rng, C=3, B=32, ratio=2, Pt=2):
    N = 2 * ratio * B + Pt * ratio * B
    ir = (rng.standard_normal((C, N)) * 0.3).astype(np.float32)
    conv = NonUniformConvolver(ir, block=B, ratio=ratio, device="cpu")
    x = rng.standard_normal((C, 2 * Pt * ratio * B)).astype(np.float32)
    return conv, torch.from_numpy(x)


def test_the_functions_engage_only_when_a_derivative_is_needed(rng):
    conv, x = _render_case(rng)
    Hh, Ht = conv.H_head, conv.H_tail

    def render(*a):
        ops_hook.reset_counts()
        _, y = nonuniform_render(conv.state, *a, conv.block)
        return y, ops_hook.counts()

    y0, inference = render(Hh, Ht, x)
    assert y0.grad_fn is None
    assert sum(inference["plain"].values()) == 12        # 6 kernels, 2 groups
    assert not any(inference["adjoint"].values())
    leaves = [t.clone().requires_grad_() for t in (Hh, Ht, x)]
    with torch.no_grad():
        y1, no_grad = render(*leaves)
    assert y1.grad_fn is None and no_grad == inference
    y2, forward = render(*leaves)
    assert y2.grad_fn is not None
    assert forward["plain"] == inference["plain"]
    ops_hook.reset_counts()
    (y2 ** 2).mean().backward()
    adjoint_counts = ops_hook.counts()
    assert adjoint_counts["adjoint"] == inference["plain"]
    assert not any(adjoint_counts["plain"].values())
    assert torch.equal(y2.detach(), y0) and torch.equal(y1, y0)


def test_needs_derivative_sees_grad_and_both_forward_modes():
    import torch.autograd.forward_ad as fwAD

    a, b = torch.zeros(3), torch.zeros(3, requires_grad=True)
    assert not ag.needs_derivative(a)
    assert ag.needs_derivative(a, b)
    with torch.no_grad():
        assert not ag.needs_derivative(a, b)
    with fwAD.dual_level():
        assert not ag.needs_derivative(a)
        assert ag.needs_derivative(a, fwAD.make_dual(a, torch.ones(3)))
    seen = []
    torch.func.jvp(lambda t: seen.append(ag.needs_derivative(t)) or t,
                   (a,), (torch.ones(3),))
    torch.func.grad(lambda t: seen.append(ag.needs_derivative(t)) or t.sum())(a)
    assert seen == [True, True]


# ---- the IR spectra ----------------------------------------------------------------

def test_rfft_planes_matches_jax(rng):
    x = rng.standard_normal((2, 3, 40)).astype(np.float32)
    want = jfft.rfft_planes(jnp.asarray(x), 64, backend="xla")
    got = rfft_planes(torch.from_numpy(x), 64)
    assert snr_db(np.asarray(want), got.numpy()) >= 110.0


@pytest.mark.parametrize("C,N,block,nparts", [(3, 200, 32, None),
                                              (2, 64, 32, 4), (1, 31, 32, None)])
def test_ir_spectra_match_partition_ir(rng, C, N, block, nparts):
    ir = rng.standard_normal((C, N)).astype(np.float32)
    want = partition_ir(ir, block, nparts, device="cpu")
    got = ir_spectra(torch.from_numpy(ir), block, nparts)
    assert got.shape == want.shape
    assert snr_db(want.numpy(), got.numpy()) >= 110.0
    with pytest.raises(ValueError, match="partitions"):
        ir_spectra(torch.from_numpy(ir), block, -(-N // block) - 1)


@pytest.mark.parametrize("N", [100, 128, 128 + 64 * 3 + 5])
def test_nonuniform_spectra_match_the_engine(rng, N):
    ir = rng.standard_normal((2, N)).astype(np.float32)
    conv = NonUniformConvolver(ir, block=32, ratio=2, device="cpu")
    Hh, Ht = nonuniform_spectra(torch.from_numpy(ir), 32, 2)
    for want, got in ((conv.H_head, Hh), (conv.H_tail, Ht)):
        assert got.shape == want.shape
        assert snr_db(want.numpy(), got.numpy()) >= 110.0


# ---- the render ----------------------------------------------------------------------

def _jax_specs(block, ratio):
    def spec(n):
        return resolve_spectral_spec(
            n, backend="xla", probe=False, layout="std"
        )._replace(mac="0", fused_head="0", permfft="0")

    return spec(2 * block), spec(2 * block * ratio)


def _grad_case(rng):
    """``tests/test_autodiff.py``'s case: 16 channels, block 32, ratio 2,
    two tail partitions, two render groups."""
    C, B, ratio = 16, 32, 2
    B2 = B * ratio
    N = 2 * ratio * B + 2 * B2
    irs = rng.standard_normal((C, N)).astype(np.float32) * 0.3
    x = rng.standard_normal((C, 2 * 2 * B2)).astype(np.float32)
    specs = _jax_specs(B, ratio)
    jconv = JaxConvolver(irs, block=B, ratio=ratio, spectral=specs)
    tconv = NonUniformConvolver(irs, block=B, ratio=ratio, device="cpu")
    ins = [np.array(jconv.H_head), np.array(jconv.H_tail), x]
    return B, specs, jconv, tconv, ins


def test_render_gradients_match_jax(rng):
    """``test_grad_through_kernel_path`` ported: d/dH_head, d/dH_tail and
    d/dx of ``mean(y ** 2)`` through the Functions against ``jax.grad`` of
    the JAX engine's ``mac="0"`` program."""
    B, specs, jconv, tconv, ins = _grad_case(rng)

    def jloss(Hh, Ht, xs):
        _, y = jax_render(jconv.state, Hh, Ht, xs, B, 0, specs)
        return jnp.mean(y ** 2)

    jv, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        *map(jnp.asarray, ins))
    leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
    _, y = nonuniform_render(tconv.state, *leaves, B)
    loss = (y ** 2).mean()
    loss.backward()
    assert abs(loss.item() - float(jv)) <= 1e-5 * float(jv)
    for w, t, what in zip(jg, leaves, ("dH_head", "dH_tail", "dx")):
        assert snr_db(np.asarray(w).ravel(), t.grad.numpy().ravel()) > 80.0, \
            what


def test_render_tangents_match_jax_jvp(rng):
    """Forward mode through the render, the port's answer to
    ``test_jvp_contract_on_kernel_path``: where the JAX package's kernel
    path raises, the port runs the kernels on the tangents.  Held to
    ``jax.jvp`` of the JAX ``mac="0"`` program, tangents in H_head,
    H_tail and x at once and in x alone."""
    B, specs, jconv, tconv, ins = _grad_case(rng)
    tans = [rng.standard_normal(a.shape).astype(np.float32) for a in ins]

    def jrender(Hh, Ht, xs):
        return jax_render(jconv.state, Hh, Ht, xs, B, 0, specs)[1]

    def render(Hh, Ht, xs):
        return nonuniform_render(tconv.state, Hh, Ht, xs, B)[1]

    for which in ((0, 1, 2), (2,)):
        t = [a if i in which else np.zeros_like(a) for i, a in enumerate(tans)]
        _, want = jax.jvp(jrender, tuple(map(jnp.asarray, ins)),
                          tuple(map(jnp.asarray, t)))
        _, got = torch.func.jvp(render, tuple(map(torch.from_numpy, ins)),
                                tuple(map(torch.from_numpy, t)))
        assert snr_db(np.asarray(want), got.numpy()) > 80.0, which


def _correlate64(a, b, n):
    """``r[k] = sum_t a[t + k] b[t]`` for ``k < n``, per row, float64."""
    T = a.shape[-1]
    L = 1 << (2 * T).bit_length()
    r = np.fft.irfft(np.fft.rfft(a, L) * np.conj(np.fft.rfft(b, L)), L)
    return r[..., :n]


def _conv64(a, b):
    """The causal convolution of ``a`` and ``b`` per row, cut to ``a``'s
    length, float64."""
    T = a.shape[-1]
    L = 1 << (T + b.shape[-1]).bit_length()
    return np.fft.irfft(np.fft.rfft(a, L) * np.fft.rfft(b, L), L)[..., :T]


def test_time_domain_ir_gradient_and_tangent_against_float64(rng):
    """The IRs through ``nonuniform_spectra`` into a two-group render
    from silence: ``y = h * x`` cut to T, so for a cotangent g, ``dL/dh[n]
    = sum_t g[t+n] x[t]`` and ``dL/dx[t] = sum_n g[t+n] h[n]``, and the
    tangent is ``dx * h + x * dh``.  The checks of ``chip_smoke.py``'s
    training phase at a small size, >= 90 dB against float64."""
    C, B, ratio = 3, 32, 4
    N = 2 * ratio * B + 3 * ratio * B - 17          # three tail partitions
    T = 2 * 3 * ratio * B
    h = (rng.standard_normal((C, N)) * np.exp(-np.arange(N) / 200.0))
    x = rng.standard_normal((C, T))
    g = rng.standard_normal((C, T))
    ht = torch.tensor(h, dtype=torch.float32, requires_grad=True)
    xt = torch.tensor(x, dtype=torch.float32, requires_grad=True)
    conv = NonUniformConvolver(np.zeros((C, N)), block=B, ratio=ratio,
                               device="cpu")

    def render(ir, sig):
        Hh, Ht = nonuniform_spectra(ir, B, ratio)
        return nonuniform_render(conv.state, Hh, Ht, sig, B)[1]

    y = render(ht, xt)
    assert snr_db(_conv64(x, h), y.detach().numpy()) >= 90.0
    y.backward(torch.tensor(g, dtype=torch.float32))
    assert snr_db(_correlate64(g, x, N), ht.grad.numpy()) >= 90.0
    assert snr_db(_correlate64(g, h, T), xt.grad.numpy()) >= 90.0
    dh, dx = rng.standard_normal((C, N)), rng.standard_normal((C, T))
    _, tan = torch.func.jvp(render, (ht.detach(), xt.detach()),
                            (torch.tensor(dh, dtype=torch.float32),
                             torch.tensor(dx, dtype=torch.float32)))
    assert snr_db(_conv64(dx, h) + _conv64(x, dh), tan.numpy()) >= 90.0


def test_uniform_render_and_step_differentiate_alike(rng):
    """``convolver_render`` (K3, K7, K4) and a chain of ``convolver_step``
    (K3, K9, K4) give the same gradients and tangents: they compute the
    same function of the IR and the signal."""
    B, N, n = 32, 100, 6
    h = torch.from_numpy(rng.standard_normal((2, N)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, n * B)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, n * B)).astype(np.float32))
    P = -(-N // B)

    def by_render(ir, sig):
        st = convolver_init(2, B, P, device="cpu")
        return convolver_render(st, ir_spectra(ir, B), sig, B)[1]

    def by_steps(ir, sig):
        st, H, ys = convolver_init(2, B, P, device="cpu"), ir_spectra(ir, B), []
        for k in range(n):
            st, y = convolver_step(st, H, sig[:, k * B:(k + 1) * B])
            ys.append(y)
        return torch.cat(ys, -1)

    results = []
    for f in (by_render, by_steps):
        _, vjp = torch.func.vjp(f, h, x)
        _, tan = torch.func.jvp(f, (h, x), (x[:, :N] * 0.5, g))
        results.append((*vjp(g), tan))
    for a, b in zip(*results):
        assert snr_db(a.numpy(), b.numpy()) >= 110.0


def test_fit_ir_by_gradient_descent(rng):
    """``test_fit_ir_by_gradient_descent`` ported: recover a 128-tap IR
    from (input, output) by optimising the time-domain IR through the
    uniform engine, with ``torch.optim.Adam`` (optax's defaults) in place
    of optax."""
    B, N, T = 64, 128, 64 * 8
    true_ir = (rng.standard_normal(N) * np.exp(-np.arange(N) / 30.0)).astype(
        np.float32)
    x = torch.from_numpy(rng.standard_normal((1, T)).astype(np.float32))
    H_true = partition_ir(true_ir, B, device="cpu")
    P = H_true.shape[1]
    _, y_target = convolver_render(convolver_init(1, B, P, device="cpu"),
                                   H_true, x, B)

    def loss(ir):
        st = convolver_init(1, B, P, device="cpu")
        _, y = convolver_render(st, ir_spectra(ir[None], B), x, B)
        return torch.mean((y - y_target) ** 2)

    ir = torch.zeros(P * B, requires_grad=True)
    opt = torch.optim.Adam([ir], lr=3e-2)
    for _ in range(200):
        opt.zero_grad()
        loss(ir).backward()
        opt.step()
    fitted = ir.detach().numpy()[:N]
    assert snr_db(true_ir, fitted) > 30.0
    with torch.no_grad():
        rel = float(loss(ir)) / float(torch.mean(y_target ** 2))
    assert rel < 1e-3, rel


def test_gradients_flow_through_iir_as_in_jax(rng):
    """``test_gradients_flow_through_iir`` ported, and the gradient held to
    ``jax.grad``'s value: both take the Toeplitz branch at T = 256."""
    x = rng.standard_normal(256).astype(np.float32)

    def jloss(pr):
        f = jnp.float32
        params = JaxModalParams(b0=f(1.0), d1=f(0.5), d2=f(0.1), p1r=pr,
                                p1i=f(0.3), p2r=pr, p2i=f(-0.3))
        y, _ = jax_modal_apply(jnp.asarray(x), params)
        return jnp.mean(y ** 2)

    def loss(pr, sig):
        f = torch.tensor
        params = ModalParams(f(1.0), f(0.5), f(0.1), pr, f(0.3), pr, f(-0.3))
        y, _ = modal_apply(sig, params)
        return torch.mean(y ** 2)

    want = float(jax.grad(jloss)(jnp.float32(0.5)))
    pr = torch.tensor(0.5, requires_grad=True)
    loss(pr, torch.from_numpy(x)).backward()
    assert np.isfinite(float(pr.grad)) and abs(float(pr.grad)) > 0
    assert snr_db([want], [float(pr.grad)]) >= 80.0
    # the doubling scan's branch (T not a multiple of 128), both modes
    xs = torch.from_numpy(x[:200])
    g_rev = torch.func.grad(loss)(torch.tensor(0.5), xs)
    _, g_fwd = torch.func.jvp(lambda p: loss(p, xs), (torch.tensor(0.5),),
                              (torch.tensor(1.0),))
    assert snr_db([float(g_rev)], [float(g_fwd)]) >= 80.0
