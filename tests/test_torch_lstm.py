"""Port bi-LSTM (plain version and the K1 wrappers) vs the JAX package's
lstm_ref.bilstm_ref and lstm_fused.bilstm_fused (Pallas, interpret mode on the
CPU), at the shapes of tests/test_lstm_fused.py and the JAX suite's forward
tolerance rtol 1e-5 / atol 1e-6; and the gradients (dx, dwx, dwh, db of both
directions, full and final-only) of the port's autograd — through the plain
version, and through `_BiLSTMFn` with the kernels emulated on the CPU — vs
jax.grad of bilstm_fused / bilstm_fused_final and of bilstm_ref, at the JAX
suite's gradient tolerance 1e-4 / 1e-5. The kernels themselves are held
against the plain version on the card in tests/test_torch_kernels.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvta_memexqa_tpu.ops import lstm_fused as j_fused
from fvta_memexqa_tpu.ops import lstm_ref as j_ref

from test_torch_kernels import hopper_emulated, old_route
from fvta_memexqa_torch.ops import lstm_fused, lstm_ref

RTOL, ATOL = 1e-5, 1e-6
SHAPES = [(12, 7, 10, 5), (9, 3, 4, 3), (4, 11, 33, 7)]


def make_case(n=12, t=7, d=10, h=5, seed=0, full_lengths=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, t, d)).astype(np.float32)
    if full_lengths:
        lens = np.full(n, t)
    else:
        lens = rng.integers(0, t + 1, n)
        lens[0], lens[1] = t, 0            # cover full and empty rows
    mask = np.arange(t)[None, :] < lens[:, None]
    lim = np.sqrt(6.0 / (d + 5 * h))
    params = []
    for _ in range(2):
        k = rng.uniform(-lim, lim, (d + h, 4 * h)).astype(np.float32)
        b = rng.normal(0, 0.1, 4 * h).astype(np.float32)
        params.append((k[:d], k[d:], b))
    return x, mask, params


def as_torch(x, mask, params):
    t = torch.from_numpy
    return (t(x), t(mask), lstm_ref.LSTMParams(*map(t, params[0])),
            lstm_ref.LSTMParams(*map(t, params[1])))


def as_jax(x, mask, params):
    return (jnp.asarray(x), jnp.asarray(mask),
            j_ref.LSTMParams(*map(jnp.asarray, params[0])),
            j_ref.LSTMParams(*map(jnp.asarray, params[1])))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_ref(seed, shape):
    case = make_case(*shape, seed=seed)
    jp_fw, jp_bw = as_jax(*case)[2:]
    out_r, fin_r = j_ref.bilstm_ref(jp_fw, jp_bw, *as_jax(*case)[:2])
    x, mask, p_fw, p_bw = as_torch(*case)
    out, fin = lstm_ref.bilstm_ref(p_fw, p_bw, x, mask)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_r), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(fin.numpy(), np.asarray(fin_r), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_matches_jax_fused(seed, shape):
    case = make_case(*shape, seed=seed)
    jx, jm, jp_fw, jp_bw = as_jax(*case)
    out_j, fin_j = j_fused.bilstm_fused(jp_fw, jp_bw, jx, jm)
    fin_only_j = j_fused.bilstm_fused_final(jp_fw, jp_bw, jx, jm)
    x, mask, p_fw, p_bw = as_torch(*case)
    out, fin = lstm_fused.bilstm_fused(p_fw, p_bw, x, mask)
    fin_only = lstm_fused.bilstm_fused_final(p_fw, p_bw, x, mask)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(fin.numpy(), np.asarray(fin_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(fin_only.numpy(), np.asarray(fin_only_j), rtol=RTOL,
                               atol=ATOL)


def test_unidirectional_and_golden():
    g = np.load(os.path.join(os.path.dirname(__file__), "golden", "lstm.npz"))
    t = lambda k: torch.from_numpy(g[k])
    p_fw = lstm_ref.LSTMParams(t("wx_fw"), t("wh_fw"), t("b_fw"))
    p_bw = lstm_ref.LSTMParams(t("wx_bw"), t("wh_bw"), t("b_bw"))
    out_u, fin_u = lstm_ref.lstm_scan_ref(p_fw, t("x"), t("mask"))
    np.testing.assert_allclose(out_u.numpy(), g["uni_out"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(fin_u.numpy(), g["uni_fin"], rtol=1e-6, atol=1e-7)
    out_b, fin_b = lstm_ref.bilstm_ref(p_fw, p_bw, t("x"), t("mask"))
    np.testing.assert_allclose(out_b.numpy(), g["bi_out"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(fin_b.numpy(), g["bi_fin"], rtol=1e-6, atol=1e-7)


def test_outputs_zero_past_length_and_empty_rows():
    x, mask, p_fw, p_bw = as_torch(*make_case(seed=3))
    out, fin = lstm_fused.bilstm_fused(p_fw, p_bw, x, mask)
    assert not out[~mask].any()
    assert not fin[1].any()                      # row 1 has length 0


GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
FIELDS = ("wx", "wh", "b")


def jax_grads(fn, case, g_out, g_fin):
    """jax.grad of <out, g_out> + <fin, g_fin> (fin only if g_out is None)
    w.r.t. (p_fw, p_bw, x); fn(p_fw, p_bw, x, mask) → (out, fin) or fin."""
    x, mask, p_fw, p_bw = as_jax(*case)

    def loss(pf, pb, xx):
        res = fn(pf, pb, xx, mask)
        if g_out is None:
            fin = res if not isinstance(res, tuple) else res[1]
            return jnp.sum(fin * g_fin)
        return jnp.sum(res[0] * g_out) + jnp.sum(res[1] * g_fin)

    gf, gb, gx = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(p_fw, p_bw, x)
    return [np.asarray(gx)] + [np.asarray(getattr(g, f)) for g in (gf, gb) for f in FIELDS]


def port_grads(run, case, g_out, g_fin):
    x, mask, p_fw, p_bw = as_torch(*case)
    leaves = [a.clone().requires_grad_() for a in (x, *p_fw, *p_bw)]
    out, fin = run(lstm_ref.LSTMParams(*leaves[1:4]), lstm_ref.LSTMParams(*leaves[4:]),
                   leaves[0], mask)
    loss = (fin * torch.from_numpy(g_fin)).sum()
    if g_out is not None:
        loss = loss + (out * torch.from_numpy(g_out)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def emulated_fn(monkeypatch):
    """`_BiLSTMFn` with the L2-streaming K1 and K1b emulated on the CPU (the old
    route's launch path)."""
    old_route(monkeypatch)
    return lambda pf, pb, x, mask: lstm_fused._BiLSTMFn.apply(
        x, mask.sum(1, dtype=torch.int32), 1.0, *pf, *pb)


@pytest.mark.parametrize("final_only", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_grads_match_jax_fused_and_ref(monkeypatch, shape, final_only):
    case = make_case(*shape, seed=4)
    n, t, _, h = shape
    rng = np.random.default_rng(8)
    g_fin = rng.normal(0, 1, (n, 2 * h)).astype(np.float32)
    g_out = None if final_only else rng.normal(0, 1, (n, t, 2 * h)).astype(np.float32)
    j_fused_fn = j_fused.bilstm_fused_final if final_only else j_fused.bilstm_fused
    refs = {"jax fused": jax_grads(j_fused_fn, case, g_out, g_fin),
            "jax ref": jax_grads(j_ref.bilstm_ref, case, g_out, g_fin)}
    plain = lambda pf, pb, x, mask: lstm_fused.bilstm_fused(pf, pb, x, mask)
    mine = {"plain": port_grads(plain, case, g_out, g_fin),
            "emulated kernels": port_grads(emulated_fn(monkeypatch), case, g_out, g_fin)}
    names = ["dx"] + [f"{d}.{f}" for d in ("fw", "bw") for f in FIELDS]
    for mk, got in mine.items():
        for rk, ref in refs.items():
            for name, a, b in zip(names, got, ref):
                np.testing.assert_allclose(a, b, **GRAD_TOL, err_msg=f"{mk} vs {rk}: {name}")


@pytest.mark.parametrize("final_only", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_hopper_route_matches_jax_fused_and_ref(monkeypatch, shape, final_only):
    """`_BiLSTMFn` on the Hopper route (lstm_proj, lstm_rec writing the
    pre-activations, lstm_rec_bwd reading them; emulated on the CPU): outputs
    and gradients vs the JAX package's bilstm_fused / bilstm_fused_final (under
    grad) and bilstm_ref."""
    hopper_emulated(monkeypatch)
    assert lstm_fused.lstm_route(*shape).kernels == lstm_fused.REC_KERNELS
    case = make_case(*shape, seed=5)
    n, t, _, h = shape
    rng = np.random.default_rng(9)
    g_fin = rng.normal(0, 1, (n, 2 * h)).astype(np.float32)
    g_out = None if final_only else rng.normal(0, 1, (n, t, 2 * h)).astype(np.float32)
    jx, jm, jp_fw, jp_bw = as_jax(*case)
    out_j, fin_j = j_fused.bilstm_fused(jp_fw, jp_bw, jx, jm)
    x, mask, p_fw, p_bw = as_torch(*case)
    x = x.clone().requires_grad_()
    out, fin = lstm_fused._BiLSTMFn.apply(x, mask.sum(1, dtype=torch.int32), 1.0, *p_fw, *p_bw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(fin.detach().numpy(), np.asarray(fin_j), rtol=RTOL, atol=ATOL)
    j_fused_fn = j_fused.bilstm_fused_final if final_only else j_fused.bilstm_fused
    refs = {"jax fused": jax_grads(j_fused_fn, case, g_out, g_fin),
            "jax ref": jax_grads(j_ref.bilstm_ref, case, g_out, g_fin)}
    got = port_grads(lambda pf, pb, xx, m: lstm_fused._BiLSTMFn.apply(
        xx, m.sum(1, dtype=torch.int32), 1.0, *pf, *pb), case, g_out, g_fin)
    names = ["dx"] + [f"{d}.{f}" for d in ("fw", "bw") for f in FIELDS]
    for rk, ref in refs.items():
        for name, a, b in zip(names, got, ref):
            np.testing.assert_allclose(a, b, **GRAD_TOL, err_msg=f"hopper route vs {rk}: {name}")
