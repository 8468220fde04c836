"""The port's grouped-scan API (ops/lstm_grouped.py: K7, K8 and their plain
version) vs the JAX package's lstm_pallas (its Pallas kernels in interpret mode,
exactly as tests/test_lstm_pallas.py runs them) on every case of that file, plus
a call at n = 1024, t = 2 that takes the JAX side's streaming kernel: outputs at
rtol 1e-5 / atol 1e-5 and gradients of (out**2).sum() + (fin**2).sum() at
1e-4 / 1e-5, the JAX file's own tolerances. Parameters cross over with
convert.lstm_params_from_jax. With the kernels swapped for an emulation that
counts its launches, the CPU also runs the card's routing (K7 vs K8 by shape),
the grouping and the autograd Function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvta_memexqa_tpu.ops.lstm_pallas import bilstm_pallas, lstm_scan_pallas
from fvta_memexqa_tpu.ops.lstm_ref import init_lstm_params

from fvta_memexqa_torch.convert import lstm_params_from_jax
from fvta_memexqa_torch.ops import lstm_grouped, lstm_ref
from fvta_memexqa_torch.ops.lstm_grouped import bilstm_grouped, lstm_scan_grouped

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def make_case(n=5, t=7, d=6, h=4, seed=0, ragged=True):
    """tests/test_lstm_pallas.py's case: numpy x and mask, flax-initialized
    parameters; returned for both frameworks."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, t, d)).astype(np.float32)
    if ragged:
        lengths = rng.integers(1, t + 1, n)
        lengths[0] = t
    else:
        lengths = np.full(n, t)
    mask = np.arange(t)[None, :] < lengths[:, None]
    p_fw = init_lstm_params(jax.random.key(seed), d, h)
    p_bw = init_lstm_params(jax.random.key(seed + 100), d, h)
    return x, mask, p_fw, p_bw


def torch_params(*ps):
    return [lstm_params_from_jax(jax.tree.map(np.asarray, p)) for p in ps]


def assert_pair(got, ref, tol=TOL):
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unidirectional_matches_jax(seed):
    x, mask, p, _ = make_case(seed=seed)
    ref = lstm_scan_pallas(p, jnp.asarray(x), jnp.asarray(mask, jnp.float32))
    (tp,) = torch_params(p)
    got = lstm_scan_grouped(tp, torch.from_numpy(x), torch.from_numpy(mask).float())
    assert_pair(got, ref)


def test_bidirectional_matches_jax():
    x, mask, p_fw, p_bw = make_case(n=6, t=9, seed=3)
    ref = bilstm_pallas(p_fw, p_bw, jnp.asarray(x), jnp.asarray(mask))
    got = bilstm_grouped(*torch_params(p_fw, p_bw), torch.from_numpy(x),
                         torch.from_numpy(mask))
    assert_pair(got, ref)


def test_batch_not_multiple_of_block_matches_jax():
    x, mask, p, _ = make_case(n=5, seed=4)
    ref = lstm_scan_pallas(p, jnp.asarray(x), jnp.asarray(mask, jnp.float32), 1.0, 4)
    (tp,) = torch_params(p)
    got = lstm_scan_grouped(tp, torch.from_numpy(x), torch.from_numpy(mask).float(), 1.0, 4)
    assert_pair(got, ref)


def test_all_pad_row():
    x, mask, p, _ = make_case(n=4, seed=5)
    mask[2] = False
    ref = lstm_scan_pallas(p, jnp.asarray(x), jnp.asarray(mask, jnp.float32))
    (tp,) = torch_params(p)
    out, fin = lstm_scan_grouped(tp, torch.from_numpy(x), torch.from_numpy(mask).float())
    assert not out[2].any() and not fin[2].any()
    assert_pair((out, fin), ref)


def test_empty_and_single_step_rows_match_jax():
    x, _, p_fw, p_bw = make_case(n=3, t=4, seed=6, ragged=False)
    mask = np.asarray([[True, False, False, False],
                       [True, True, True, True],
                       [False, False, False, False]])
    ref = bilstm_pallas(p_fw, p_bw, jnp.asarray(x), jnp.asarray(mask))
    got = bilstm_grouped(*torch_params(p_fw, p_bw), torch.from_numpy(x),
                         torch.from_numpy(mask))
    assert_pair(got, ref)


def test_stream_route_matches_jax():
    """n = 1024, t = 2: the JAX side takes _stream_kernel (lstm_pallas.py:280),
    as a card call of the port takes K8."""
    x, mask, p, _ = make_case(n=1024, t=2, d=4, h=4, seed=8)
    assert lstm_grouped.uses_stream(1024, 2)
    ref = lstm_scan_pallas(p, jnp.asarray(x), jnp.asarray(mask, jnp.float32))
    (tp,) = torch_params(p)
    got = lstm_scan_grouped(tp, torch.from_numpy(x), torch.from_numpy(mask).float())
    assert_pair(got, ref)


def _losses(out, fin):
    return (out ** 2).sum() + (fin ** 2).sum()


def test_grads_match_jax():
    """The backward recomputes through the plain reference, as the JAX
    package's custom_vjp does: dx and every parameter of both directions."""
    x, mask, p_fw, p_bw = make_case(n=4, t=6, seed=7)
    jm = jnp.asarray(mask)
    g_ref = jax.grad(lambda ps, xx: _losses(*bilstm_pallas(ps[0], ps[1], xx, jm)),
                     argnums=(0, 1))((p_fw, p_bw), jnp.asarray(x))
    leaves = [torch.from_numpy(x).requires_grad_()]
    for p in torch_params(p_fw, p_bw):
        leaves += [a.requires_grad_() for a in p]
    out, fin = bilstm_grouped(lstm_ref.LSTMParams(*leaves[1:4]),
                              lstm_ref.LSTMParams(*leaves[4:]), leaves[0],
                              torch.from_numpy(mask))
    got = torch.autograd.grad(_losses(out, fin), leaves)
    (jpf, jpb), jdx = g_ref
    ref = [jdx, *jpf, *jpb]
    for name, a, b in zip(("x", "wx_fw", "wh_fw", "b_fw", "wx_bw", "wh_bw", "b_bw"),
                          got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL, err_msg=name)


# ---- the card's routing, grouping and autograd Function, on the CPU -------------

def emulated(name):
    """The plain grouped scan as a stand-in kernel that counts its launches and
    checks what a kernel wrapper checks of its arguments."""
    def kernel(x_proj, lengths, wh, forget_bias):
        # wh: the G groups' [H, 4H] tensors, read where they lie (no stacked copy)
        assert x_proj.is_contiguous() and len(wh) == x_proj.shape[0]
        assert all(w.is_contiguous() and w.shape == (x_proj.shape[-1] // 4, x_proj.shape[-1])
                   for w in wh)
        assert lengths.dtype == torch.int32 and lengths.shape == x_proj.shape[:2]
        assert lengths.stride(1) == 1 or lengths.shape[1] <= 1
        kernel.launches += 1
        return lstm_grouped.grouped_scan_ref(x_proj, lengths, wh, forget_bias)
    kernel.launches = 0
    kernel.__name__ = name
    return kernel


@pytest.fixture
def card_kernels(monkeypatch):
    k7, k8 = emulated("k7"), emulated("k8")
    monkeypatch.setattr(lstm_grouped, "_kernels", lambda device: (k7, k8))
    return k7, k8


@pytest.mark.parametrize("n,t,stream", [(8, 5, False), (1023, 3, False), (1024, 2, True),
                                        (1024, 1, False), (1100, 4, True)])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_routing_by_shape(card_kernels, n, t, stream, bidirectional):
    k7, k8 = card_kernels
    x, mask, p_fw, p_bw = make_case(n=n, t=t, d=3, h=2, seed=9)
    tf, tb = torch_params(p_fw, p_bw)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    if bidirectional:
        got = bilstm_grouped(tf, tb, xt, mt)
        ref = lstm_ref.bilstm_ref(tf, tb, xt, mt)
    else:
        got = lstm_scan_grouped(tf, xt, mt.float())
        ref = lstm_ref.lstm_scan_ref(tf, xt, mt)
    assert (k7.launches, k8.launches) == ((0, 1) if stream else (1, 0))
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_autograd_function_with_emulated_kernels(card_kernels):
    """Forward through the (emulated) kernels, backward by recompute: the
    gradients of a uni- and a bidirectional call under one loss equal plain
    autograd's; the mask gets none."""
    x, mask, p_fw, p_bw = make_case(n=6, t=5, d=4, h=3, seed=10)
    mask[1] = False
    tf, tb = torch_params(p_fw, p_bw)
    rng = np.random.default_rng(11)
    g_out = torch.from_numpy(rng.normal(0, 1, (6, 5, 6)).astype(np.float32))

    def run(uni, bi):
        leaves = [a.clone().requires_grad_() for a in (torch.from_numpy(x), *tf, *tb)]
        pf, pb = lstm_ref.LSTMParams(*leaves[1:4]), lstm_ref.LSTMParams(*leaves[4:])
        out_u, fin_u = uni(pf, leaves[0])
        out_b, fin_b = bi(pf, pb, leaves[0])
        loss = (out_b * g_out).sum() + (fin_b ** 2).sum() + _losses(out_u, fin_u)
        return torch.autograd.grad(loss, leaves)

    mt = torch.from_numpy(mask)
    got = run(lambda pf, xx: lstm_scan_grouped(pf, xx, mt.float()),
              lambda pf, pb, xx: bilstm_grouped(pf, pb, xx, mt))
    ref = run(lambda pf, xx: lstm_ref.lstm_scan_ref(pf, xx, mt),
              lambda pf, pb, xx: lstm_ref.bilstm_ref(pf, pb, xx, mt))
    assert card_kernels[0].launches == 2
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert not got[0][1].any()


def test_grad_of_unused_or_frozen_inputs(card_kernels):
    """Only the inputs that need a gradient get one; a loss on fin alone and
    frozen weights work."""
    x, mask, p, _ = make_case(n=4, t=3, d=3, h=2, seed=12)
    (tp,) = torch_params(p)
    xx = torch.from_numpy(x).requires_grad_()
    _, fin = lstm_scan_grouped(tp, xx, torch.from_numpy(mask).float())
    (dx,) = torch.autograd.grad(fin.sum(), [xx])
    xr = torch.from_numpy(x).requires_grad_()
    (ref,) = torch.autograd.grad(lstm_ref.lstm_scan_ref(tp, xr, torch.from_numpy(mask))[1]
                                 .sum(), [xr])
    torch.testing.assert_close(dx, ref, rtol=1e-5, atol=1e-6)


def test_plain_grouped_scan_is_two_plain_scans():
    """grouped_scan_ref over G = 2 equals lstm_scan_ref per group, and zero
    rows / steps give zeros."""
    x, mask, p_fw, p_bw = make_case(n=5, t=6, d=4, h=3, seed=13)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    ps = torch_params(p_fw, p_bw)
    xp = torch.stack([xt @ p.wx + p.b for p in ps])
    lens = mt.sum(1, dtype=torch.int32)[None].expand(2, -1)
    out, fin = lstm_grouped.grouped_scan_ref(xp, lens, torch.stack([p.wh for p in ps]), 1.0)
    for g, p in enumerate(ps):
        ro, rf = lstm_ref.lstm_scan_ref(p, xt, mt)
        torch.testing.assert_close(out[g], ro, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(fin[g], rf, rtol=1e-6, atol=1e-7)
    out, fin = lstm_grouped.grouped_scan_ref(xp[:, :, :0], lens, torch.stack([p.wh for p in ps]),
                                             1.0)
    assert out.shape == (2, 5, 0, 3) and not fin.any()
