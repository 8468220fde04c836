"""The port's streaming FVTA statistics (ops/fvta_stats) and the streaming form
of its attention (ops/fvta_fused at T >= STREAM_MIN_T) vs the JAX package on
the CPU: focal_local_stats / focal_finalize vs JAX's; fvta_stats_fused vs
fvta_stats_pallas run as the JAX suite runs it (interpret mode, tblock=2, T =
64, so the stats kernel, the tie-count kernel and the streaming backward kernel
really run); the streaming attention vs fvta_attention_pallas; and gradients in
the cases of TestFVTAStreamingBackward (dead sequence, all-masked example with
global ties, all-masked question, S = 1 and 2). Tolerances are the JAX suite's
(tests/test_fvta_pallas.py): stats 1e-5 / 1e-5, gradients 1e-4 / 1e-5, the
streaming attention 1e-4 / 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvta_memexqa_tpu.ops import fvta_pallas as jfp
from fvta_memexqa_tpu.ops import fvta_ref as j_ref

from fvta_memexqa_torch.ops import fvta_fused, fvta_ref, fvta_stats

STATS = ("m", "den", "v", "eq", "e")
FIELDS = ("context", "question", "time_attn", "seq_attn")
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
WEIGHTS = ("w_x", "w_y", "w_xy")


def make_case(n=2, s=8, t=64, j=5, d=6, seed=0, masked=None):
    """The JAX suite's make_case, plus the masked variants of its tests."""
    rng = np.random.default_rng(seed)
    h = rng.normal(0, 1, (n, s, t, d)).astype(np.float32)
    q = rng.normal(0, 1, (n, j, d)).astype(np.float32)
    cm = np.arange(t)[None, None, :] < rng.integers(1, t + 1, (n, s))[..., None]
    qm = np.arange(j)[None, :] < rng.integers(1, j + 1, n)[:, None]
    h, q = h * cm[..., None], q * qm[..., None]
    # masked after h and q, as the JAX suite's cases do
    if masked == "dead":
        cm[:, 0, :] = False
    elif masked == "example":
        cm[0] = False
    elif masked == "question":
        qm[0] = False
    p = {k: rng.normal(0, 1, d).astype(np.float32) for k in WEIGHTS}
    return h, cm, q, qm, p


def jx(case):
    h, cm, q, qm, p = case
    return (jnp.asarray(h), jnp.asarray(cm), jnp.asarray(q), jnp.asarray(qm),
            {k: jnp.asarray(v) for k, v in p.items()})


def tx(case):
    h, cm, q, qm, p = case
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return t(h), t(cm), t(q), t(qm), {k: t(v) for k, v in p.items()}


def assert_all_close(got, ref, names, **tol):
    for name, a, b in zip(names, got, ref):
        np.testing.assert_allclose(np.asarray(a.detach() if hasattr(a, "detach") else a),
                                   np.asarray(b), err_msg=name, **tol)


@pytest.mark.parametrize("seed", [0, 1])
def test_local_stats_and_finalize_match_jax(seed):
    case = make_case(t=16, seed=seed)
    h, cm, q, qm, p = tx(case)
    mine = fvta_ref.focal_local_stats(h, cm, q, qm, "trilinear", p)
    jh, jcm, jq, jqm, jp = jx(case)
    ref = j_ref.focal_local_stats(jh, jcm, jq, jqm, "trilinear", jp)
    assert_all_close(mine, ref, STATS, rtol=1e-5, atol=1e-5)
    out = fvta_ref.focal_finalize(*mine, q, qm, cm.any(-1))
    assert_all_close(out, j_ref.focal_finalize(*ref, jq, jqm, jcm.any(-1)), FIELDS,
                     rtol=1e-5, atol=1e-5)
    # and focal_finalize(focal_local_stats) is the one-pass attention
    one = fvta_ref.fvta_attention(h, cm, q, qm,
                                  fvta_ref.similarity_tensor(h, q, "trilinear", p))
    assert_all_close(out, [a.numpy() for a in one], FIELDS, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,t,masked", [(8, 8, None), (2, 16, None), (8, 8, "dead"),
                                        (1, 64, "example")])
def test_stats_fused_matches_jax_stats_pallas(s, t, masked):
    case = make_case(s=s, t=t, seed=3, masked=masked)
    h, cm, q, qm, p = tx(case)
    with torch.no_grad():
        mine = fvta_stats.fvta_stats_fused(h, cm, q, qm, "trilinear", p)
    jh, jcm, jq, jqm, jp = jx(case)
    assert_all_close(mine, jfp.fvta_stats_pallas(jh, jcm, jq, jqm, "trilinear", jp, tblock=2),
                     STATS, rtol=1e-5, atol=1e-5)


def test_bilinear_stats_is_the_plain_path():
    case = make_case(t=8, seed=4)
    h, cm, q, qm, _ = tx(case)
    p = {"w_bilinear": torch.from_numpy(np.random.default_rng(5).normal(0, 1, (6, 6))
                                        .astype(np.float32))}
    mine = fvta_stats.fvta_stats_fused(h, cm, q, qm, "bilinear", p)
    jh, jcm, jq, jqm, _ = jx(case)
    ref = jfp.fvta_stats_pallas(jh, jcm, jq, jqm, "bilinear",
                                {"w_bilinear": jnp.asarray(p["w_bilinear"].numpy())})
    assert_all_close(mine, ref, STATS, rtol=1e-5, atol=1e-5)


@pytest.fixture
def streaming(monkeypatch):
    """Every T of these small cases takes the port's streaming form."""
    monkeypatch.setattr(fvta_fused, "STREAM_MIN_T", 8)


@pytest.mark.parametrize("kind,masked", [("trilinear", None), ("trilinear", "dead"),
                                         ("trilinear", "question"), ("dot", None)])
def test_streaming_attention_matches_jax_pallas(streaming, kind, masked):
    case = make_case(t=64, seed=10, masked=masked)
    h, cm, q, qm, p = tx(case)
    p = p if kind == "trilinear" else {}
    with torch.no_grad():
        mine = fvta_fused.fvta_attention_fused(h, cm, q, qm, kind, p)
    assert np.isfinite(mine.context.numpy()).all()
    jh, jcm, jq, jqm, jp = jx(case)
    jp = jp if kind == "trilinear" else {}
    # the JAX package streams at T // tblock > _FINALIZE_MAX_BLOCKS (64 // 2 here)
    ref = jfp.fvta_attention_pallas(jh, jcm, jq, jqm, kind, jp, tblock=2)
    assert_all_close(mine, ref, FIELDS, rtol=1e-4, atol=1e-5)
    one = j_ref.fvta_attention(jh, jcm, jq, jqm, j_ref.similarity_tensor(jh, jq, kind, jp))
    assert_all_close(mine, one, FIELDS, rtol=1e-4, atol=1e-5)


def jax_stats_grads(fn, case):
    jh, jcm, jq, jqm, jp = jx(case)

    def loss(h_, q_, p_):
        m, den, v, eq, e = fn(h_, jcm, q_, jqm, "trilinear", p_)
        return ((v ** 2).sum() + jnp.log(den).sum() + (eq * 0.1).sum() + (m * 0.03).sum()
                + jnp.where(jcm, e, 0.0).sum() * 1e-3)

    g = jax.grad(loss, argnums=(0, 1, 2))(jh, jq, jp)
    return [np.asarray(g[0]), np.asarray(g[1])] + [np.asarray(g[2][k]) for k in WEIGHTS]


def port_stats_grads(case):
    h, cm, q, qm, p = tx(case)
    leaves = [a.clone().requires_grad_() for a in (h, q, *(p[k] for k in WEIGHTS))]
    m, den, v, eq, e = fvta_stats.fvta_stats_fused(leaves[0], cm, leaves[1], qm, "trilinear",
                                                   dict(zip(WEIGHTS, leaves[2:])))
    loss = ((v ** 2).sum() + torch.log(den).sum() + (eq * 0.1).sum() + (m * 0.03).sum()
            + torch.where(cm, e, 0.0).sum() * 1e-3)
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


# TestFVTAStreamingBackward's cases (tests/test_fvta_pallas.py), plus S = 1
BACKWARD_CASES = {
    "seed0": dict(seed=0), "seed20": dict(seed=20), "thin_s2": dict(s=2, seed=20),
    "s1": dict(s=1, seed=25), "dead_sequence": dict(seed=21, masked="dead"),
    "all_masked_example": dict(seed=22, masked="example"),
    "all_masked_example_thin_s": dict(s=2, seed=23, masked="example"),
    "all_masked_question": dict(seed=24, masked="question"),
}


@pytest.mark.parametrize("name", list(BACKWARD_CASES))
def test_stats_grads_match_jax_streaming_backward(name):
    case = make_case(t=64, **BACKWARD_CASES[name])
    mine = port_stats_grads(case)
    pallas = lambda h, cm, q, qm, k, p: jfp.fvta_stats_pallas(h, cm, q, qm, k, p, tblock=2)
    for label, ref in (("jax pallas", jax_stats_grads(pallas, case)),
                       ("jax ref", jax_stats_grads(j_ref.focal_local_stats, case))):
        assert_all_close(mine, ref, [f"{label}: {a}" for a in ("h", "q", *WEIGHTS)],
                         **GRAD_TOL)


@pytest.mark.parametrize("s,j", [(8, 5), (2, 24)])
def test_streaming_attention_grads_match_jax(streaming, s, j):
    case = make_case(s=s, t=64, j=j, seed=12 if s == 8 else 30)
    h, cm, q, qm, p = tx(case)
    leaves = [a.clone().requires_grad_() for a in (h, q, *(p[k] for k in WEIGHTS))]
    o = fvta_fused.fvta_attention_fused(leaves[0], cm, leaves[1], qm, "trilinear",
                                        dict(zip(WEIGHTS, leaves[2:])))
    mine = torch.autograd.grad((o.context ** 2).sum() + (o.question ** 2).sum(), leaves)
    jh, jcm, jq, jqm, jp = jx(case)

    def loss(h_, q_, p_):
        o = jfp.fvta_attention_pallas(h_, jcm, q_, jqm, "trilinear", p_, tblock=2)
        return (o.context ** 2).sum() + (o.question ** 2).sum()

    g = jax.grad(loss, argnums=(0, 1, 2))(jh, jq, jp)
    ref = [g[0], g[1]] + [g[2][k] for k in WEIGHTS]
    assert_all_close(mine, ref, ("h", "q", *WEIGHTS), **GRAD_TOL)
