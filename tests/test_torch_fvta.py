"""Port FVTA attention (plain version and the K2 wrapper) vs the JAX package's
fvta_pallas.fvta_attention_pallas (Pallas, interpret mode on the CPU) and
fvta_ref, with the tolerances of tests/test_fvta_pallas.py; masking primitives;
golden fixtures; and the gradients of fvta_attention_fused (through the plain
version, and through `_FVTAFn` with K2's forward emulated by the plain one) vs
jax.grad of fvta_attention_pallas and of the reference, with a dead sequence
and an all-masked question (ties), at the JAX suite's gradient tolerance
1e-4 / 1e-5. The kernel itself is held against the plain version on the card
in tests/test_torch_kernels.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvta_memexqa_tpu.ops import fvta_ref as j_ref
from fvta_memexqa_tpu.ops.fvta_pallas import fvta_attention_pallas

from fvta_memexqa_torch.ops import fvta_fused, fvta_ref, masking

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FIELDS = ("context", "question", "time_attn", "seq_attn")


def make_case(n=2, s=8, t=8, j=5, d=6, seed=0, ragged=True, kind="trilinear"):
    rng = np.random.default_rng(seed)
    h = rng.normal(0, 1, (n, s, t, d)).astype(np.float32)
    q = rng.normal(0, 1, (n, j, d)).astype(np.float32)
    if ragged:
        t_len = rng.integers(1, t + 1, (n, s))
        j_len = rng.integers(1, j + 1, n)
    else:
        t_len = np.full((n, s), t)
        j_len = np.full(n, j)
    cm = np.arange(t)[None, None, :] < t_len[..., None]
    qm = np.arange(j)[None, :] < j_len[:, None]
    h = h * cm[..., None]
    q = q * qm[..., None]
    if kind == "bilinear":
        params = {"w_bilinear": rng.normal(0, 1, (d, d)).astype(np.float32)}
    elif kind == "trilinear":
        params = {k: rng.normal(0, 1, d).astype(np.float32) for k in ("w_x", "w_y", "w_xy")}
    else:
        params = {}
    return h, cm, q, qm, params


def run_port(case, kind):
    h, cm, q, qm, params = case
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    with torch.no_grad():
        return fvta_fused.fvta_attention_fused(t(h), t(cm), t(q), t(qm), kind,
                                               {k: t(v) for k, v in params.items()})


def run_jax_pallas(case, kind):
    h, cm, q, qm, params = case
    return fvta_attention_pallas(jnp.asarray(h), jnp.asarray(cm), jnp.asarray(q),
                                 jnp.asarray(qm), kind,
                                 {k: jnp.asarray(v) for k, v in params.items()})


def run_jax_ref(case, kind, variant="fvta"):
    h, cm, q, qm, params = case
    jh, jq = jnp.asarray(h), jnp.asarray(q)
    c = j_ref.similarity_tensor(jh, jq, kind, {k: jnp.asarray(v) for k, v in params.items()})
    return j_ref.ATTENTION_VARIANTS[variant](jh, jnp.asarray(cm), jq, jnp.asarray(qm), c)


def assert_close(a, b, rtol=1e-5, atol=1e-5):
    for x, y, name in zip(a, b, FIELDS):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=rtol, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("kind,seed", [("trilinear", 0), ("trilinear", 1),
                                       ("trilinear", 2), ("dot", 3), ("bilinear", 4)])
def test_matches_jax_pallas_and_ref(kind, seed):
    case = make_case(seed=seed, kind=kind)
    mine = run_port(case, kind)
    assert_close(mine, run_jax_pallas(case, kind))
    assert_close(mine, run_jax_ref(case, kind))


def test_dead_sequence_and_block():
    h, cm, q, qm, p = make_case(t=8, seed=6)
    cm = cm.copy()
    cm[:, 0, :] = False       # dead sequence
    cm[:, 1, 4:] = False      # dead second half
    case = (h, cm, q, qm, p)
    mine = run_port(case, "trilinear")
    assert np.isfinite(mine.context.numpy()).all()
    assert_close(mine, run_jax_pallas(case, "trilinear"))
    assert_close(mine, run_jax_ref(case, "trilinear"))


def test_all_masked_question():
    h, cm, q, qm, p = make_case(t=8, seed=9)
    qm = qm.copy()
    qm[0, :] = False
    case = (h, cm, q, qm, p)
    mine = run_port(case, "trilinear")
    assert mine.time_attn[0].sum() > 0          # finite-uniform maps, not zeros
    assert_close(mine, run_jax_pallas(case, "trilinear"))
    assert_close(mine, run_jax_ref(case, "trilinear"))


def test_serving_widths_d200():
    case = make_case(n=4, s=24, t=24, j=30, d=200, seed=7)
    mine = run_port(case, "trilinear")
    assert_close(mine, run_jax_pallas(case, "trilinear"), rtol=1e-4, atol=1e-4)
    assert_close(mine, run_jax_ref(case, "trilinear"), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", ["flat", "none"])
def test_ablation_variants_match_jax(variant):
    h, cm, q, qm, params = make_case(seed=11)
    t = torch.from_numpy
    c = fvta_ref.similarity_tensor(t(h), t(q), "trilinear",
                                   {k: t(v) for k, v in params.items()})
    mine = fvta_ref.ATTENTION_VARIANTS[variant](t(h), t(cm), t(q), t(qm), c)
    assert_close(mine, run_jax_ref((h, cm, q, qm, params), "trilinear", variant))


def test_masking_and_fvta_golden():
    g = np.load(os.path.join(GOLDEN, "masking.npz"))
    lg, mk = torch.from_numpy(g["logits"]), torch.from_numpy(g["mask"])
    np.testing.assert_allclose(masking.exp_mask(lg, mk).numpy(), g["exp_mask"], rtol=1e-6)
    np.testing.assert_allclose(masking.masked_softmax(lg, mk).numpy(), g["masked_softmax"],
                               rtol=1e-6, atol=1e-7)
    g = np.load(os.path.join(GOLDEN, "fvta.npz"))
    t = lambda k: torch.from_numpy(g[k])
    params = {k: t(k) for k in ("w_x", "w_y", "w_xy")}
    c = fvta_ref.similarity_tensor(t("h"), t("q"), "trilinear", params)
    np.testing.assert_allclose(c.numpy(), g["corr"], rtol=1e-5, atol=1e-6)
    out = fvta_ref.fvta_attention(t("h"), t("cm"), t("q"), t("qm"), c)
    for key, val in zip(FIELDS, out):
        np.testing.assert_allclose(val.numpy(), g[key], rtol=1e-5, atol=1e-6, err_msg=key)


GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_ARGS = ("h", "q", "w_x", "w_y", "w_xy")


def grad_case(seed, dead=False, masked_question=False):
    h, cm, q, qm, p = make_case(seed=seed)
    cm, qm = cm.copy(), qm.copy()
    if dead:
        cm[:, 0, :] = False       # a dead sequence in every example
    if masked_question:
        qm[0, :] = False          # an all-masked question: its rows are all ties
    rng = np.random.default_rng(seed + 100)
    g = [rng.normal(0, 1, s).astype(np.float32)
         for s in ((2, 6), (2, 6), cm.shape, cm.shape[:2])]
    return (h, cm, q, qm, p), g


def jax_attention_grads(fn, case, g):
    h, cm, q, qm, p = case

    def loss(hh, qq, wx, wy, wxy):
        out = fn(hh, jnp.asarray(cm), qq, jnp.asarray(qm), {"w_x": wx, "w_y": wy, "w_xy": wxy})
        return sum(jnp.sum(o * jnp.asarray(gg)) for o, gg in zip(out, g))

    args = [jnp.asarray(a) for a in (h, q, p["w_x"], p["w_y"], p["w_xy"])]
    return [np.asarray(a) for a in jax.jit(jax.grad(loss, argnums=tuple(range(5))))(*args)]


def port_attention_grads(fn, case, g):
    h, cm, q, qm, p = case
    t = torch.from_numpy
    leaves = [t(a).clone().requires_grad_() for a in (h, q, p["w_x"], p["w_y"], p["w_xy"])]
    out = fn(leaves[0], t(cm), leaves[1], t(qm), dict(zip(("w_x", "w_y", "w_xy"), leaves[2:])))
    loss = sum((o * t(gg)).sum() for o, gg in zip(out, g))
    return [a.numpy() for a in torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize("dead,masked_question", [(False, False), (True, False), (False, True),
                                                  (True, True)])
def test_grads_match_jax_pallas_and_ref(monkeypatch, dead, masked_question):
    case, g = grad_case(seed=21, dead=dead, masked_question=masked_question)
    refs = {
        "jax pallas": jax_attention_grads(
            lambda h, cm, q, qm, p: fvta_attention_pallas(h, cm, q, qm, "trilinear", p), case, g),
        "jax ref": jax_attention_grads(
            lambda h, cm, q, qm, p: j_ref.fvta_attention(
                h, cm, q, qm, j_ref.similarity_tensor(h, q, "trilinear", p)), case, g),
    }
    plain = lambda h, cm, q, qm, p: fvta_fused.fvta_attention_fused(h, cm, q, qm,
                                                                    "trilinear", p)

    def emulated_fwd(h, cm_f, q, qm_f, wx, wy, wxy):
        with torch.no_grad():
            c = fvta_ref.similarity_tensor(h, q, "trilinear", {"w_x": wx, "w_y": wy, "w_xy": wxy})
            return fvta_ref.fvta_attention(h, cm_f > 0.5, q, qm_f > 0.5, c)

    monkeypatch.setattr(fvta_fused, "fvta_fwd", emulated_fwd)
    fn = lambda h, cm, q, qm, p: fvta_fused._FVTAFn.apply(
        h, cm.float(), q, qm.float(), p["w_x"], p["w_y"], p["w_xy"])
    mine = {"plain": port_attention_grads(plain, case, g),
            "autograd Function": port_attention_grads(fn, case, g)}
    for mk, got in mine.items():
        for rk, ref in refs.items():
            for name, a, b in zip(GRAD_ARGS, got, ref):
                np.testing.assert_allclose(a, b, **GRAD_TOL, err_msg=f"{mk} vs {rk}: {name}")
