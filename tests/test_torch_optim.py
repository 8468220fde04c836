"""The port's optimizer (optim.py) vs the JAX package's optax chain
(train.make_optimizer): the same numpy gradient sequence fed to both, for adam
and adadelta with global-norm clipping, every LR schedule, and grad_accum = 2,
starting from the same non-zero moments (carried across by
convert.opt_state_from_optax). Parameters and moments agree at 1e-6 over 5
steps. Also the clip formula against clip_grad_norm_'s, which differs."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fvta_memexqa_tpu.config import Config as JConfig
from fvta_memexqa_tpu.config import TrainConfig as JTrainConfig
from fvta_memexqa_tpu.train import make_optimizer as j_make_optimizer

from fvta_memexqa_torch.config import TrainConfig
from fvta_memexqa_torch.convert import opt_state_from_optax, state_dict_from_flax
from fvta_memexqa_torch.optim import Optimizer, clip_by_global_norm, lr_at

TOL = dict(rtol=1e-6, atol=1e-6)
MODS = ("photo", "photo_title", "album_title", "album_desc", "when", "where")


def param_tree(rng, scale=1.0):
    """A flax-layout parameter tree of the FVTA model at toy widths (d_emb 6,
    H 3, 2H 6), as numpy arrays."""
    r = lambda *s: (rng.normal(0, 1, s) * scale).astype(np.float32)
    lstm = lambda d: {"wx": r(d, 12), "wh": r(3, 12), "b": r(12)}
    p = {"word_embed": {"oov_emb": r(4, 5)},
         "char_cnn": {"char_emb": r(7, 2), "conv_kernel": r(6, 1), "conv_bias": r(1)},
         "highway": {f"{k}{i}": {"kernel": r(6, 6), "bias": r(6)}
                     for i in range(2) for k in "hg"},
         "photo_proj": {"kernel": r(8, 6), "bias": r(6)},
         "scorer": {"kernel": r(30, 1), "bias": r(1)},
         "sim_w_x": r(6), "sim_w_y": r(6), "sim_w_xy": r(6),
         "enc_word": {"fw": lstm(6), "bw": lstm(6)}}
    for m in MODS:
        d = 6
        p[f"enc_{m}"] = {"fw": lstm(d), "bw": lstm(d)}
    return {"params": p}


CASES = [
    dict(optimizer="adam"),
    dict(optimizer="adam", lr_schedule="constant", warmup_steps=3),
    dict(optimizer="adam", lr_schedule="cosine", warmup_steps=2, decay_steps=6),
    dict(optimizer="adam", lr_schedule="linear", decay_steps=5),
    dict(optimizer="adam", grad_accum=2),
    dict(optimizer="adam", lr_schedule="cosine", decay_steps=4, grad_accum=2),
    dict(optimizer="adadelta", learning_rate=1.0),
    dict(optimizer="adadelta", learning_rate=0.5, lr_schedule="linear", warmup_steps=2,
         decay_steps=6, grad_accum=2),
    dict(optimizer="adam", grad_clip_norm=0.0),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_optimizer_matches_optax(case):
    rng = np.random.default_rng(0)
    tcfg = TrainConfig(**case)
    j_opt = j_make_optimizer(JConfig(train=JTrainConfig(**case)))
    j_step = jax.jit(lambda g, st, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(
        *j_opt.update(g, st, p)))
    params_np = param_tree(rng)
    j_params = jax.tree.map(jnp.asarray, params_np)
    j_state = j_opt.init(j_params)
    # warm-up updates move optax's moments (and counters) away from zero; the
    # port starts from the same state, carried across by the converter
    for _ in range(3):
        g = jax.tree.map(jnp.asarray, param_tree(rng, scale=2.0))
        j_params, j_state = j_step(g, j_state, j_params)
    params = {k: v.clone() for k, v in state_dict_from_flax(
        jax.tree.map(np.asarray, j_params)).items()}
    state = opt_state_from_optax(jax.tree.map(np.asarray, j_state))
    opt = Optimizer(tcfg)
    assert set(state) == set(opt.init(params))
    for step in range(5):
        # alternate large and small gradients: global norm above and below 5
        g_np = param_tree(rng, scale=3.0 if step % 2 == 0 else 0.05)
        j_params, j_state = j_step(jax.tree.map(jnp.asarray, g_np), j_state, j_params)
        opt.update(params, state_dict_from_flax(g_np), state)
        ref_p = state_dict_from_flax(jax.tree.map(np.asarray, j_params))
        ref_s = opt_state_from_optax(jax.tree.map(np.asarray, j_state))
        for k in ref_p:
            torch.testing.assert_close(params[k], ref_p[k], **TOL, msg=f"step {step} {k}")
        for field, ref in ref_s.items():
            if isinstance(ref, dict):
                for k in ref:
                    torch.testing.assert_close(state[field][k], ref[k], **TOL,
                                               msg=f"step {step} {field}.{k}")
            else:
                assert int(state[field]) == int(ref), (step, field)


@pytest.mark.parametrize("schedule,warmup,decay", [("constant", 0, 0), ("constant", 3, 0),
                                                   ("cosine", 2, 5), ("linear", 0, 4),
                                                   ("linear", 3, 4)])
def test_lr_schedule_matches_optax(schedule, warmup, decay):
    from fvta_memexqa_tpu.train import _make_lr

    t = TrainConfig(learning_rate=1e-3, lr_schedule=schedule, warmup_steps=warmup,
                    decay_steps=decay)
    ref = _make_lr(1e-3, schedule, warmup, decay)
    for c in range(12):
        want = float(ref(jnp.asarray(c, jnp.int32))) if callable(ref) else ref
        assert lr_at(t, c) == pytest.approx(want, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("vec", [[30.0, 40.0], [0.3, 0.4], [3.0, 4.0]])
def test_clip_is_optax_formula_not_clip_grad_norm(vec):
    """(g / ‖g‖) · c above the threshold, g at or below it (optax);
    clip_grad_norm_ scales by c / (‖g‖ + 1e-6) and is another function."""
    ref = optax.clip_by_global_norm(5.0).update({"a": jnp.asarray(vec)}, None)[0]
    got = clip_by_global_norm({"a": torch.tensor(vec)}, 5.0)
    assert got["a"].tolist() == np.asarray(ref["a"]).tolist()
    other = torch.tensor(vec, requires_grad=True)
    other.grad = torch.tensor(vec)
    torch.nn.utils.clip_grad_norm_([other], 5.0)
    if np.linalg.norm(vec) > 5.0:
        assert not torch.equal(other.grad, got["a"])


def test_unknown_settings_raise():
    with pytest.raises(ValueError):
        Optimizer(TrainConfig(optimizer="sgd"))
    with pytest.raises(ValueError, match="decay_steps"):
        Optimizer(TrainConfig(lr_schedule="cosine"))
