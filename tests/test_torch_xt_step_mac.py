"""The single-step tail MAC (K2s, ``ops_hook.xt_step_mac``) and the
two-level engine's ownership of its tail queue.

On the CPU: the plain version against the contract in float64 and
against a model of the kernel's walk over the queue, and its slot write
against a copy of the queue with that slot set; derivatives through
``nonuniform_render`` at a super-block count that is not a multiple of
``Pt``, against the same render with the plain version's own PyTorch
derivatives in place of the Function; a functional super-step leaves the
state it is given as it was; the engine copies a queue it does not hold
alone once, then writes its own in place, and a state read from it and
assigned back restarts the stream where it was read.

On a card (marked ``card``; they skip without one): the kernel against
its plain version on the card at every queue type, on its vector and its
one-element path, with and without the slot write, and the engine on the
card against the engine on the CPU through exchanges that fade in the
tail.  The file imports neither JAX nor the suite's ``conftest.py``, so
on a machine without JAX it runs as ``python -m pytest --noconftest
tests/test_torch_xt_step_mac.py``.
"""

import weakref

import numpy as np
import pytest
import torch

from bbcat_dsp_torch import NonUniformConvolver, ops_hook
from bbcat_dsp_torch.convolve import nonuniform
from bbcat_dsp_torch.ops.kernels import spectral_mac as k79

DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """PyTorch's CPU ops on one thread: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def gen():
    return torch.Generator().manual_seed(19)


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


def _operands(gen, P, C, F, dtype, device="cpu"):
    """``(queue, xt, H)``: the queue in ``dtype``, the rest float32."""
    q, H = (torch.randn((2, P, C, F), generator=gen) for _ in range(2))
    xt = torch.randn((2, C, F), generator=gen)
    return q.to(dtype).to(device), xt.to(device), H.to(device)


def _slot_written(queue, xt, slot):
    """A copy of ``queue`` with ``xt`` in its slot ``slot``, rounded to
    the queue's type."""
    q2 = queue.clone()
    q2[:, slot] = xt.to(queue.dtype)
    return q2


def _contract64(queue, xt, H, slot):
    """``sum_p w[P-1-p] H[p]`` over ``t = [queue rolled by slot | xt]``,
    complex float64."""
    q, x, h = (a.double().numpy() for a in (queue, xt, H))
    P, F = h.shape[1], h.shape[-1]
    t = np.concatenate([np.roll(q, -slot, axis=1), x[:, None]], axis=1)
    s = np.where(np.arange(F) % 2, -1.0, 1.0)
    w = t[:, :-1] + s * t[:, 1:]
    wc, hc = w[0] + 1j * w[1], h[0] + 1j * h[1]
    acc = sum(wc[P - 1 - p] * hc[p] for p in range(P))
    return torch.from_numpy(np.stack([acc.real, acc.imag]))


def _kernel_model(queue, xt, H, slot):
    """``csrc/xt_step_mac.cu``'s walk, every element at once in float32:
    the newer half spectrum starts as xt, partition p reads queue slot
    ``(slot - 1 - p) mod P`` and IR bin p, in ascending p."""
    q = queue.float().numpy()
    x, h = xt.numpy(), H.numpy()
    P, F = h.shape[1], h.shape[-1]
    s = np.where(np.arange(F) % 2, -1.0, 1.0).astype(np.float32)
    pr, pi = x[0].copy(), x[1].copy()
    ar = np.zeros_like(pr)
    ai = np.zeros_like(pi)
    k = (P if slot == 0 else slot) - 1
    for p in range(P):
        cr, ci = q[0, k], q[1, k]
        wr, wi = cr + s * pr, ci + s * pi
        ar += wr * h[0, p] - wi * h[1, p]
        ai += wr * h[1, p] + wi * h[0, p]
        pr, pi = cr, ci
        k = (P if k == 0 else k) - 1
    assert k == (P if slot == 0 else slot) - 1   # every slot read once
    return torch.from_numpy(np.stack([ar, ai]))


# ---- the plain version --------------------------------------------------------

# C F = 99: no vector width divides it
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P", [1, 2, 6, 14])
def test_plain_version_holds_the_contract_and_writes_one_slot(gen, P, dtype):
    C, F = 3, 33
    for slot in range(P):
        queue, xt, H = _operands(gen, P, C, F, dtype)
        kept = queue.clone()
        want = k79.xt_step_mac_plain(queue, xt, H, slot)
        assert torch.equal(queue, kept)
        assert _snr_db(_contract64(kept, xt, H, slot), want) >= 110.0
        assert _snr_db(want, _kernel_model(kept, xt, H, slot)) >= 110.0
        got = k79.xt_step_mac_plain(queue, xt, H, slot, True)
        assert torch.equal(got, want)
        assert torch.equal(queue, _slot_written(kept, xt, slot))
        assert queue.dtype == dtype


def test_dispatch_writes_in_place_only_where_no_derivative_is_recorded(gen):
    queue, xt, H = _operands(gen, 3, 2, 9, torch.float32)
    kept = queue.clone()
    ops_hook.reset_counts()
    ops_hook.xt_step_mac(queue, xt, H, 2)
    assert torch.equal(queue, kept)
    ops_hook.xt_step_mac(queue, xt, H, 2, True)
    assert torch.equal(queue[:, 2], xt) and torch.equal(queue[:, :2],
                                                        kept[:, :2])
    assert ops_hook.counts()["plain"]["xt_step_mac"] == 2
    with pytest.raises(ValueError, match="derivative"):
        ops_hook.xt_step_mac(queue, xt.requires_grad_(), H, 0, True)


# ---- derivatives --------------------------------------------------------------

def _render_case(gen, dtype=torch.float32, C=3, B=16, ratio=2, Pt=3):
    """An engine with ``Pt`` tail partitions after two super-blocks, its
    state with a random queue in it, and 4 super-blocks of signal: not a
    multiple of ``Pt``, so a render of it steps one super-block at a
    time."""
    N = 2 * ratio * B + Pt * ratio * B
    ir = (torch.randn((C, N), generator=gen) * 0.3).numpy()
    conv = NonUniformConvolver(ir, block=B, ratio=ratio, dtype=dtype,
                               device="cpu")
    assert conv.tail_parts == Pt
    SB = conv.super_block
    for _ in range(2):
        conv.process_block(torch.randn((C, SB), generator=gen))
    st = conv.state
    state = st._replace(tail=st.tail._replace(
        queue=torch.randn(st.tail.queue.shape, generator=gen).to(dtype)))
    x = torch.randn((C, 4 * SB), generator=gen)
    return conv, state, x


def _through_plain(queue, xt, H, slot, retire=False):
    assert not retire
    return k79.xt_step_mac_plain(queue, xt, H, slot)


@pytest.mark.parametrize("mode", ["reverse", "forward"])
def test_render_derivatives_through_single_steps_match_the_plain_path(
        gen, monkeypatch, mode):
    """d/dH_tail, d/dx and d/dqueue (reverse) and the tangent in all three
    (forward) of a render of 4 super-blocks at Pt = 3, through K2s's
    Function, against the same render with the plain version called
    outside the Function (PyTorch's own derivatives of its ops)."""
    conv, state, x = _render_case(gen)
    Hh, Ht, B = conv.H_head, conv.H_tail, conv.block

    def render(Ht_, x_, q_):
        st = state._replace(tail=state.tail._replace(queue=q_))
        return nonuniform.nonuniform_render(st, Hh, Ht_, x_, B)[1]

    ins = (Ht, x, state.tail.queue)
    tans = tuple(torch.randn(a.shape, generator=gen) for a in ins)

    def derivatives():
        if mode == "forward":
            return torch.func.jvp(render, ins, tans)
        leaves = [a.clone().requires_grad_() for a in ins]
        y = render(*leaves)
        return (y,) + torch.autograd.grad((y ** 2).mean(), leaves)

    ops_hook.reset_counts()
    got = derivatives()
    counts = ops_hook.counts()
    assert counts["plain"]["xt_step_mac"] >= 4
    if mode == "reverse":
        assert counts["plain"]["xt_step_mac"] == 4
        # the last step's output waits in ``pending``, outside the loss
        assert counts["adjoint"]["xt_step_mac"] == 3
    monkeypatch.setattr(ops_hook, "xt_step_mac", _through_plain)
    want = derivatives()
    for g, w in zip(got, want):
        assert torch.allclose(g, w, rtol=1e-5, atol=1e-6)
        assert torch.any(g != 0)


# ---- who may write the queue --------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_the_functional_super_step_leaves_its_input_state_as_it_was(
        gen, dtype):
    """``_super_step`` as ``nonuniform_render`` calls it, at every queue
    type; and the engine's own step, asked to write in place, while it
    records a derivative."""
    conv, _, x = _render_case(gen, dtype)
    st = conv.state
    assert st.tail.queue.dtype == dtype
    before = [t.clone() for t in (st.xcarry, st.prev, st.tail.queue,
                                  st.tail.prev, st.pending)]

    def unchanged():
        return all(torch.equal(t, k) for t, k in zip(
            (st.xcarry, st.prev, st.tail.queue, st.tail.prev, st.pending),
            before))

    xs = x[:, :conv.super_block].contiguous()
    new, _ = nonuniform._super_step(st, conv.H_head, conv.H_tail, xs,
                                    conv.block)
    assert unchanged()
    assert new.tail.queue is not st.tail.queue
    assert new.tail.queue.dtype == dtype
    slot = st.tail.step % conv.tail_parts
    assert torch.equal(new.tail.queue[:, slot], new.tail.prev.to(dtype))
    if dtype == torch.float32:
        new, _ = nonuniform._super_step(st, conv.H_head, conv.H_tail,
                                        xs.clone().requires_grad_(),
                                        conv.block, in_place=True)
        assert unchanged()
        assert new.tail.queue.grad_fn is not None


def test_the_engine_copies_a_queue_it_did_not_make_once_then_writes_its_own(
        gen):
    """Read through ``_state``, which, unlike ``state``, leaves the
    engine holding its buffer."""
    conv, _, _ = _render_case(gen)              # it read ``state``
    C, B, SB, Pt = 3, conv.block, conv.super_block, conv.tail_parts
    read = first = conv._state.tail.queue
    for _ in range(2 * conv.ratio):                 # two firings
        conv.process_small_block(torch.randn((C, B), generator=gen))
        if conv._sb_fill == 0 and read is not None:
            own, read = conv._state.tail.queue, None    # copied at the first
    assert own is not first and conv._state.tail.queue is own   # in place
    gone = weakref.ref(own)
    del own
    conv.process(torch.randn((C, Pt * SB), generator=gen))
    assert gone() is None               # no buffer kept that the state left
    rendered = conv._state.tail.queue
    kept = rendered.clone()
    ops_hook.reset_counts()
    fired = []
    for _ in range(3 * conv.ratio):                 # three firings
        conv.process_small_block(torch.randn((C, B), generator=gen))
        if conv._sb_fill == 0:
            fired.append(conv._state.tail.queue)
    mine = fired[0]                                 # copied at the first
    assert mine is not rendered and all(q is mine for q in fired)
    assert torch.equal(rendered, kept)              # the render's untouched
    assert ops_hook.counts()["plain"]["xt_step_mac"] == 3
    conv.process_block(torch.randn((C, SB), generator=gen))
    assert conv._state.tail.queue is mine


@pytest.mark.parametrize("method", ["process_small_block", "process_block"])
def test_a_state_read_and_assigned_back_restarts_the_stream(gen, method):
    """The state read from ``state`` is a value: the firings after the
    read leave it as it was, and assigned back it restarts the stream,
    which then gives the same outputs and state bit for bit."""
    conv, _, _ = _render_case(gen)
    C, B, SB = 3, conv.block, conv.super_block
    n = B if method == "process_small_block" else SB
    conv.process_small_block(torch.randn((C, B), generator=gen))
    conv.process_small_block(torch.randn((C, B), generator=gen))
    xs = [torch.randn((C, n), generator=gen) for _ in range(3 * SB // n)]
    kept = conv.state
    copies = [t.clone() for t in (kept.tail.queue, kept.tail.prev)]
    fill, buf = conv._sb_fill, conv._sb_buf.clone()

    def run():
        ys = [getattr(conv, method)(x) for x in xs]
        return torch.cat(ys, dim=-1), conv._state

    y1, st1 = run()
    assert st1.tail.step == kept.tail.step + 3
    assert torch.equal(kept.tail.queue, copies[0])
    assert torch.equal(kept.tail.prev, copies[1])
    conv.state, conv._sb_fill, conv._sb_buf = kept, fill, buf
    y2, st2 = run()
    assert torch.equal(y1, y2)
    assert all(torch.equal(a, b) for a, b in zip(
        (st1.xcarry, st1.prev, st1.tail.queue, st1.tail.prev, st1.pending),
        (st2.xcarry, st2.prev, st2.tail.queue, st2.tail.prev, st2.pending)))
    assert torch.equal(kept.tail.queue, copies[0])


# ---- on the card ---------------------------------------------------------------

# (P, C, F): config #5's shape, then small shapes on the vector path (C F
# a multiple of 4: 132, 68) and on the one-element path (99, 45, 34)
CARD_SHAPES = [(14, 1024, 4097), (14, 3, 33), (6, 4, 33), (3, 5, 9),
               (2, 4, 17), (1, 2, 17)]


@pytest.mark.card
@pytest.mark.parametrize("P,C,F", CARD_SHAPES)
def test_kernel_matches_its_plain_version_on_the_card(card, P, C, F):
    g = torch.Generator().manual_seed(P * 1000 + C)
    slots = range(P) if C * F < 10000 else (0, P // 2, P - 1)
    for dtype in DTYPES:
        for slot in slots:
            queue, xt, H = _operands(g, P, C, F, dtype, card)
            want_q = queue.clone()
            want = k79.xt_step_mac_plain(want_q, xt, H, slot, True)
            kept = queue.clone()
            got = k79.xt_step_mac_cuda(queue, xt, H, slot)
            torch.cuda.synchronize()
            assert torch.equal(queue, kept)         # no write unasked
            assert _snr_db(want, got) >= 110.0, (P, C, F, dtype, slot)
            got = k79.xt_step_mac_cuda(queue, xt, H, slot, True)
            torch.cuda.synchronize()
            assert _snr_db(want, got) >= 110.0, (P, C, F, dtype, slot)
            assert torch.equal(queue, want_q), (P, C, F, dtype, slot)
            del queue, xt, H, want_q, kept


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_takes_a_queue_off_the_vector_boundary(card, dtype):
    """A queue that starts one element past an allocation's start runs
    on the one-element path."""
    g = torch.Generator().manual_seed(7)
    P, C, F = 5, 4, 33
    queue, xt, H = _operands(g, P, C, F, dtype, card)
    base = torch.empty(queue.numel() + 1, dtype=dtype, device=card)
    off = base[1:].view(queue.shape)
    off.copy_(queue)
    want = k79.xt_step_mac_plain(queue, xt, H, 3, True)
    got = k79.xt_step_mac_cuda(off, xt, H, 3, True)
    torch.cuda.synchronize()
    assert _snr_db(want, got) >= 110.0
    assert torch.equal(off, queue)


@pytest.mark.card
def test_the_engine_on_the_card_matches_the_cpu_through_tail_exchanges(card):
    """A render group, small blocks with an exchange that fades in the
    tail at the next firing, super-blocks with a one-channel exchange: on
    the card, every output and state leaf against the engine on the CPU,
    K2s launched once a tail step and once more a fade, no plain version,
    and the queue written in place from the first step after the render."""
    g = torch.Generator().manual_seed(19)
    C, B, ratio = 8, 64, 4
    SB = B * ratio
    N = 2 * SB + 3 * SB
    irs = [(torch.randn((C, N), generator=g)
            * torch.exp(-torch.arange(N) / 400.0)).numpy() for _ in range(3)]
    x = torch.randn((C, 12 * SB), generator=g)
    engines = [NonUniformConvolver(irs[0], B, ratio, device=d)
               for d in ("cpu", card)]
    Pt = engines[0].tail_parts
    outs, leaves, counts, queues = [], [], None, []
    for conv in engines:
        ops_hook.reset_counts()
        ys = [conv.process(x[:, :Pt * SB].to(conv.device))]
        t = Pt * SB
        for i in range(3 * ratio):
            if i == ratio + 1:
                conv.set_filter(irs[1])
            ys.append(conv.process_small_block(
                x[:, t:t + B].to(conv.device)))
            t += B
            if conv._sb_fill == 0:
                queues.append(conv._state.tail.queue)
        for j in range(2):
            if j == 1:
                conv.set_filter(irs[2][3], channel=3)
            ys.append(conv.process_block(x[:, t:t + SB].to(conv.device)))
            queues.append(conv._state.tail.queue)
            t += SB
        torch.cuda.synchronize()
        counts = ops_hook.counts()
        outs.append(torch.cat(ys, dim=-1).cpu())
        st = conv.state
        leaves.append([a.cpu() for a in (st.xcarry, st.prev, st.tail.queue,
                                         st.tail.prev, st.pending)])
    assert _snr_db(outs[0], outs[1]) >= 100.0
    for a, b in zip(*leaves):
        assert _snr_db(a, b) >= 100.0
    assert not any(counts["plain"].values())
    # 3 small-block firings and 2 super-blocks, 2 of the 5 fading
    assert counts["launches"]["xt_step_mac"] == 5 + 2
    card_queues = queues[len(queues) // 2:]
    assert all(q is card_queues[0] for q in card_queues)
    assert counts["launches"]["head_mac"] > 0
