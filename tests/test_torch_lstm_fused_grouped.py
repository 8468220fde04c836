"""The port's bilstm_fused_grouped (K bi-LSTMs over one batch in one launch of K1
and one of K1b on the card; on the CPU its plain version, bilstm_ref per pair)
against the JAX package's bilstm_fused_grouped in interpret mode, as
tests/test_lstm_fused.py runs it: TestGrouped's two cases (mixed T and D; rows
of length 0) and the flagship's six time encoders at narrow widths (K = 6),
with the JAX parameters carried across by convert.lstm_params_from_jax.
Forward at rtol 1e-5 / atol 1e-6, every parameter and input gradient at 1e-4 /
1e-5 (the JAX suite's tolerances); the shared-H ValueError on both sides. The
same cases also run through the port's autograd Function with the grouped
launchers emulated on the CPU (tests/test_torch_kernels.py grouped_emulated),
and the card holds the kernels against the plain version there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvta_memexqa_tpu.ops.lstm_fused import bilstm_fused_grouped as j_grouped
from fvta_memexqa_tpu.ops.lstm_ref import init_lstm_params

from test_torch_kernels import grouped_emulated
from fvta_memexqa_torch.convert import lstm_params_from_jax
from fvta_memexqa_torch.ops import lstm_fused

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)

# name -> (seed, N, H, [(T_k, D_k)], min length): TestGrouped's cases, then the
# flagship model's six time encoders (photo and photo titles at T = 12, the
# four album texts at T = 24; D = 2H for the titles' summaries) at narrow widths
CASES = {
    "mixed_t_and_d": (3, 10, 4, [(6, 9), (3, 9), (6, 5)], 0),
    "grads_case": (8, 6, 3, [(5, 7), (4, 3)], 1),
    "six_encoders": (11, 8, 5, [(12, 12), (12, 10), (24, 12), (24, 12), (24, 12), (24, 12)], 0),
}


def case(name):
    """(JAX pairs, xs, masks, cotangents) as numpy-backed JAX arrays."""
    seed, n, h, specs, lo = CASES[name]
    rng = np.random.default_rng(seed)
    pairs, xs, masks, cots = [], [], [], []
    for k, (t, d) in enumerate(specs):
        xs.append(rng.normal(0, 1, (n, t, d)).astype(np.float32))
        lens = rng.integers(lo, t + 1, n)
        lens[0] = t
        masks.append(np.arange(t)[None] < lens[:, None])
        pairs.append((init_lstm_params(jax.random.key(k + seed), d, h),
                      init_lstm_params(jax.random.key(k + seed + 50), d, h)))
        cots.append((rng.normal(0, 1, (n, t, 2 * h)).astype(np.float32),
                     rng.normal(0, 1, (n, 2 * h)).astype(np.float32)))
    return pairs, xs, masks, cots


def port_inputs(pairs, xs, masks):
    return ([tuple(lstm_params_from_jax(p) for p in pair) for pair in pairs],
            [torch.from_numpy(x) for x in xs], [torch.from_numpy(m) for m in masks])


def jax_result(pairs, xs, masks, cots):
    """JAX's outputs and the gradients of sum_k <out_k, g_k> + <fin_k, f_k>
    w.r.t. every parameter, then every input."""
    def loss(ps, xx):
        res = j_grouped(ps, xx, tuple(jnp.asarray(m) for m in masks), interpret=True)
        return sum((o * go).sum() + (f * gf).sum() for (o, f), (go, gf) in zip(res, cots))

    ps = tuple(pairs)
    xx = tuple(jnp.asarray(x) for x in xs)
    res = j_grouped(ps, xx, tuple(jnp.asarray(m) for m in masks), interpret=True)
    gp, gx = jax.grad(loss, argnums=(0, 1))(ps, xx)
    grads = [getattr(p, f) for pair in gp for p in pair for f in ("wx", "wh", "b")]
    return [np.asarray(a) for r in res for a in r], [np.asarray(g) for g in (*grads, *gx)]


def port_result(fn, pairs, xs, masks, cots):
    """The port's outputs and gradients in jax_result's order."""
    leaves_w = [w.clone().requires_grad_() for pair in pairs for p in pair for w in p]
    leaves_x = [x.clone().requires_grad_() for x in xs]
    ps = tuple((lstm_fused.LSTMParams(*leaves_w[6 * k:6 * k + 3]),
                lstm_fused.LSTMParams(*leaves_w[6 * k + 3:6 * k + 6])) for k in range(len(xs)))
    res = fn(ps, tuple(leaves_x), tuple(masks))
    loss = sum((o * torch.from_numpy(go)).sum() + (f * torch.from_numpy(gf)).sum()
               for (o, f), (go, gf) in zip(res, cots))
    grads = torch.autograd.grad(loss, leaves_w + leaves_x)
    return [a.detach().numpy() for r in res for a in r], [g.numpy() for g in grads]


def check(got, ref):
    (out_g, grads_g), (out_r, grads_r) = got, ref
    assert len(out_g) == len(out_r) and len(grads_g) == len(grads_r)
    for i, (a, b) in enumerate(zip(out_g, out_r)):
        np.testing.assert_allclose(a, b, **FWD_TOL, err_msg=f"output {i}")
    for i, (a, b) in enumerate(zip(grads_g, grads_r)):
        assert a.shape == b.shape, i
        np.testing.assert_allclose(a, b, **GRAD_TOL, err_msg=f"gradient {i}")


@pytest.fixture(scope="module")
def jax_results():
    return {name: jax_result(*case(name)) for name in CASES}


@pytest.mark.parametrize("name", list(CASES))
def test_cpu_path_matches_jax_grouped(jax_results, name):
    """The port's CPU path (the plain version, autograd through it)."""
    pairs, xs, masks, cots = case(name)
    got = port_result(lstm_fused.bilstm_fused_grouped, *port_inputs(pairs, xs, masks), cots)
    check(got, jax_results[name])


@pytest.mark.parametrize("route", ["hopper", "old"])
@pytest.mark.parametrize("name", list(CASES))
def test_grouped_fn_with_emulated_kernels_matches_jax_grouped(monkeypatch, jax_results, name,
                                                              route):
    """The card's autograd Function (one grouped K1 and K1b call, the
    per-bi-LSTM products) with the launchers emulated on the CPU."""
    grouped_emulated(monkeypatch, route)
    pairs, xs, masks, cots = case(name)

    def fn(ps, xx, mm):
        flat = lstm_fused._GroupedBiLSTMFn.apply(1.0, len(xx), *mm, *xx,
                                                 *(w for pair in ps for p in pair for w in p))
        return list(zip(flat[0::2], flat[1::2]))

    check(port_result(fn, *port_inputs(pairs, xs, masks), cots), jax_results[name])


def test_mixed_hidden_widths_raise_as_in_jax():
    pairs, xs, masks, _ = case("mixed_t_and_d")
    pairs[1] = (init_lstm_params(jax.random.key(7), 9, 6),) * 2
    msg = "grouped bi-LSTMs must share hidden_dim, got \\[4, 6\\]"
    with pytest.raises(ValueError, match=msg):
        j_grouped(tuple(pairs), tuple(map(jnp.asarray, xs)), tuple(map(jnp.asarray, masks)),
                  interpret=True)
    with pytest.raises(ValueError, match=msg):
        lstm_fused.bilstm_fused_grouped(*port_inputs(pairs, xs, masks))
