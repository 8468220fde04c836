"""The port's bf16 activation variant (ModelConfig.dtype = "bfloat16") against
the JAX package's on the CPU (tests/test_bf16.py's cases, and more):

- the plain scan (ops/lstm_ref, dtype=torch.bfloat16) vs JAX's
  bilstm_ref(dtype=bfloat16): within BF16_ATOL (measured: bitwise at D <= 40;
  at D = 200, H = 100 one flip of a rounding in ~1/1000 outputs, 2^-9 apart:
  the two products sum x . Wx in other orders before x_proj is rounded); it
  tracks the float32 scan within 0.06 as JAX's does, and the masked tail is 0;
- the fused entry on the CPU is the plain version; `_BiLSTMFn` with the
  kernels' BF16 instantiations emulated (both routes) gives the plain forward
  and its gradients within BF16_GRAD (the kernels differentiate straight
  through the roundings in float32, autograd through the plain version rounds
  the cotangents of the bf16 values as JAX does);
- the model's logits and every gradient in bf16 vs JAX's from the same weights,
  its bi-LSTMs' outputs bf16 values and its logits nearer JAX's than float32's;
  the overfit check of tests/test_bf16.py at its size; the video conv
  encoder's bf16 logits vs its float32 ones (tests/test_bf16.py) and vs JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvta_memexqa_tpu import train as j_train
from fvta_memexqa_tpu.config import ModelConfig as JModelConfig
from fvta_memexqa_tpu.data import Dataset as JDataset
from fvta_memexqa_tpu.data import SharedTables as JSharedTables
from fvta_memexqa_tpu.data.device_prepro import device_put_batch
from fvta_memexqa_tpu.models import FVTAModel as JFVTAModel
from fvta_memexqa_tpu.models import video as jv
from fvta_memexqa_tpu.ops import lstm_ref as j_ref
from test_torch_kernels import hopper_emulated, old_route
from test_torch_video import grads_pair, inputs_pair, shared_pair, video_config

from fvta_memexqa_torch import train as tr
from fvta_memexqa_torch.config import Config, TrainConfig
from fvta_memexqa_torch.convert import (model_from_flax, state_dict_from_flax,
                                        video_state_dict_from_flax)
from fvta_memexqa_torch.data import SharedTables, assemble
from fvta_memexqa_torch.data.pipeline import Dataset
from fvta_memexqa_torch.models.fvta import BiLSTM
from fvta_memexqa_torch.models.video import VideoFVTAModel
from fvta_memexqa_torch.ops import lstm_fused
from fvta_memexqa_torch.ops.lstm_ref import LSTMParams, bilstm_ref

BF16 = torch.bfloat16
# bf16 outputs vs the JAX scan's: two bf16 ulps of a value in [0.5, 1) (h lies
# in (-1, 1)); a flipped rounding of x_proj moves an output by about one.
BF16_ATOL = 2.0 ** -7
# gradients through the bf16 scan, two differentiations of it (see the module
# docstring): per tensor, max |d| <= BF16_GRAD x max |g| (~4 bf16 ulps).
BF16_GRAD = 2.0 ** -6
# the bf16 model's logits vs JAX's bf16 logits from the same weights (measured
# 1.3e-8; the float32 model's stand 2.3e-4 from them, so a model that computed
# in float32 fails this bound).
MODEL_LOGITS_ATOL = 2.0 ** -16
SHAPES = [(4, 12, 10, 8), (6, 30, 40, 16), (8, 24, 200, 100)]


def case(n, t, d, h, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, t, d)).astype(np.float32)
    lens = rng.integers(0, t + 1, n)
    lens[0] = t
    mask = np.arange(t)[None, :] < lens[:, None]
    ps = [j_ref.init_lstm_params(jax.random.key(seed + k), d, h) for k in (0, 1)]
    ps = [j_ref.LSTMParams(p.wx, p.wh, jnp.asarray(rng.normal(0, 0.1, 4 * h), jnp.float32))
          for p in ps]
    return x, mask, ps


def torch_params(p) -> LSTMParams:
    return LSTMParams(*(torch.from_numpy(np.array(a)) for a in p))


def rel_close(got, want, rel, what):
    """max |got - want| <= rel x max |want|, plus 1e-6 for a gradient whose exact
    value is 0 (the scorer's bias: both sides return rounding noise there)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = rel * np.abs(want).max() + 1e-6
    assert np.abs(got - want).max() <= bound, (what, np.abs(got - want).max(), bound)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_scan_matches_jax_bf16(shape):
    x, mask, (pf, pb) = case(*shape, seed=sum(shape))
    jo, jf = j_ref.bilstm_ref(pf, pb, jnp.asarray(x), jnp.asarray(mask), 1.0,
                              dtype=jnp.bfloat16)
    out, fin = bilstm_ref(torch_params(pf), torch_params(pb), torch.from_numpy(x),
                          torch.from_numpy(mask), 1.0, dtype=BF16)
    assert out.dtype == fin.dtype == BF16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jo, np.float32), rtol=0,
                               atol=BF16_ATOL)
    np.testing.assert_allclose(fin.float().numpy(), np.asarray(jf, np.float32), rtol=0,
                               atol=BF16_ATOL)
    out32, fin32 = bilstm_ref(torch_params(pf), torch_params(pb), torch.from_numpy(x),
                              torch.from_numpy(mask), 1.0)
    np.testing.assert_allclose(out.float().numpy(), out32.numpy(), rtol=0, atol=0.06)
    np.testing.assert_allclose(fin.float().numpy(), fin32.numpy(), rtol=0, atol=0.06)
    assert (out.float() - out32).abs().max() > 0


def test_masked_tail_still_zero():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (3, 8, 6)).astype(np.float32))
    mask = torch.arange(8)[None, :] < torch.tensor([[3], [8], [1]])
    p = torch_params(j_ref.init_lstm_params(jax.random.key(2), 6, 5))
    out, _ = bilstm_ref(p, p, x, mask, dtype=BF16)
    assert not out[0, 3:].any() and not out[2, 1:].any()


def test_fused_entry_on_the_cpu_is_the_plain_version():
    x, mask, (pf, pb) = case(5, 9, 12, 8, seed=3)
    args = (torch_params(pf), torch_params(pb), torch.from_numpy(x), torch.from_numpy(mask))
    out, fin = lstm_fused.bilstm_fused(*args, dtype=BF16)
    ref_out, ref_fin = bilstm_ref(*args, dtype=BF16)
    assert out.dtype == fin.dtype == torch.float32
    assert torch.equal(out, ref_out.float()) and torch.equal(fin, ref_fin.float())
    assert torch.equal(lstm_fused.bilstm_fused_final(*args, dtype=BF16), fin)
    with pytest.raises(ValueError, match="bfloat16"):
        lstm_fused.bilstm_fused(*args, dtype=torch.float16)


def bilstm_grads(fn, x, mask, pf, pb, g_out, g_fin):
    leaves = [torch.from_numpy(x).requires_grad_()] + [
        torch.from_numpy(np.array(a)).requires_grad_() for p in (pf, pb) for a in p]
    out, fin = fn(LSTMParams(*leaves[1:4]), LSTMParams(*leaves[4:7]), leaves[0],
                  torch.from_numpy(mask))
    loss = (fin * torch.from_numpy(g_fin)).sum()
    if g_out is not None:
        loss = loss + (out * torch.from_numpy(g_out)).sum()
    return out.detach(), fin.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("final_only", [False, True], ids=["out", "fin_only"])
@pytest.mark.parametrize("route", ["hopper", "old"])
def test_bilstm_fn_bf16_emulated_matches_plain_and_jax(monkeypatch, route, final_only):
    """The card's bf16 path (`_launch` with bf16: x and the weights rounded,
    then `_BiLSTMFn` on the BF16 instantiations, emulated on the CPU) vs the
    plain bf16 version and JAX's bf16 scan, forward and gradients."""
    (hopper_emulated if route == "hopper" else old_route)(monkeypatch)
    n, t, d, h = 6, 10, 24, 16
    x, mask, (pf, pb) = case(n, t, d, h, seed=11)
    rng = np.random.default_rng(12)
    g_fin = rng.normal(0, 1, (n, 2 * h)).astype(np.float32)
    g_out = None if final_only else rng.normal(0, 1, (n, t, 2 * h)).astype(np.float32)
    kern = lambda p, q, xx, m: lstm_fused._launch(p, q, xx, m, 1.0, emit_out=True, bf16=True)
    plain = lambda p, q, xx, m: tuple(v.float() for v in bilstm_ref(p, q, xx, m, dtype=BF16))
    k_out, k_fin, k_grads = bilstm_grads(kern, x, mask, pf, pb, g_out, g_fin)
    p_out, p_fin, p_grads = bilstm_grads(plain, x, mask, pf, pb, g_out, g_fin)
    np.testing.assert_allclose(k_out.numpy(), p_out.numpy(), rtol=0, atol=BF16_ATOL)
    np.testing.assert_allclose(k_fin.numpy(), p_fin.numpy(), rtol=0, atol=BF16_ATOL)

    def j_loss(xx, *w):
        o, f = j_ref.bilstm_ref(j_ref.LSTMParams(*w[:3]), j_ref.LSTMParams(*w[3:]), xx,
                                jnp.asarray(mask), 1.0, dtype=jnp.bfloat16)
        loss = (f.astype(jnp.float32) * g_fin).sum()
        if g_out is not None:
            loss = loss + (o.astype(jnp.float32) * g_out).sum()
        return loss

    j_grads = jax.grad(j_loss, argnums=tuple(range(7)))(jnp.asarray(x), *pf, *pb)
    names = ["dx"] + [f"{s}.{f}" for s in ("fw", "bw") for f in ("wx", "wh", "b")]
    for name, k, p, j in zip(names, k_grads, p_grads, j_grads):
        rel_close(p.numpy(), np.asarray(j), BF16_GRAD, f"plain vs jax: {name}")
        rel_close(k.numpy(), p.numpy(), BF16_GRAD, f"kernels vs plain: {name}")


# ---- the model ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def bf16_jax_pair(packed_synth, small_config):
    """(flax params, JAX bf16 logits, loss, grads) on train batch 0 of 8 rows at
    keep_prob 1."""
    cfg = small_config.replace(model=JModelConfig(hidden_dim=16, char_emb_dim=8,
                                                  char_cnn_filters=16, keep_prob=1.0,
                                                  dtype="bfloat16"))
    j_shared = JSharedTables.from_packed(packed_synth.shared)
    jb = device_put_batch(next(iter(JDataset(packed_synth, "train").get_batches(8))))
    j_model = JFVTAModel(cfg=cfg)
    mi = j_train.assemble(j_shared, jb)
    params = jax.jit(lambda k: j_model.init(k, j_shared, mi, train=False))(jax.random.key(0))
    logits = j_model.apply(params, j_shared, mi, train=False).logits
    fn = jax.jit(jax.value_and_grad(
        lambda p: j_train.loss_and_metrics(j_model, p, j_shared, jb, jax.random.key(1), True),
        has_aux=True))
    (loss, _), grads = fn(params)
    return (cfg, jax.tree.map(np.asarray, params), np.asarray(logits), float(loss),
            jax.tree.map(np.asarray, grads))


def test_model_forward_and_every_grad_match_jax_in_bf16(packed_synth, bf16_jax_pair):
    """Logits, loss and every gradient of the bf16 model vs JAX's from the same
    weights; every bi-LSTM's outputs hold bf16 values, and the logits stand
    nearer JAX's bf16 logits than the float32 model's do."""
    cfg, params, j_logits, j_loss, j_grads = bf16_jax_pair
    tcfg = Config.from_json(cfg.to_json())
    model = model_from_flax(tcfg, params)
    m32 = model_from_flax(tcfg.replace(model=dataclasses.replace(tcfg.model, dtype="float32")),
                          params)
    shared = SharedTables.from_packed(packed_synth.shared, "cpu")
    batch = next(iter(Dataset(packed_synth, "train").get_batches(8)))
    seen = []
    hooks = [m.register_forward_hook(lambda _m, _i, o: seen.extend(v for v in o if v is not None))
             for m in model.modules() if isinstance(m, BiLSTM)]
    with torch.no_grad():
        logits = model(shared, assemble(shared, batch)).logits
        logits32 = m32(shared, assemble(shared, batch)).logits
    for hook in hooks:
        hook.remove()
    assert len(seen) >= len(hooks) > 0
    assert all(v.dtype == torch.float32 and torch.equal(v, v.to(BF16).float()) for v in seen)
    gap_jax = float(np.abs(logits.numpy() - j_logits).max())
    gap_f32 = float((logits - logits32).abs().max())
    assert gap_jax <= MODEL_LOGITS_ATOL < gap_f32, (gap_jax, gap_f32)
    loss, _ = tr.loss_and_metrics(model, shared, batch, True, torch.Generator())
    assert float(loss.detach()) == pytest.approx(j_loss, rel=BF16_GRAD)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    ref = state_dict_from_flax(j_grads)
    for name, g in zip(names, grads):
        rel_close(g.numpy(), ref[name].numpy(), 4 * BF16_GRAD, name)


def test_bf16_overfits_like_f32(packed_synth, small_config, tmp_path):
    """tests/test_bf16.py's gate at its size: the bf16 model fits the 24
    derivable questions of the synthetic corpus to 100% train accuracy."""
    cfg = Config.from_json(small_config.to_json())
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, hidden_dim=16, char_emb_dim=8, char_cnn_filters=16,
                                  keep_prob=1.0, dtype="bfloat16"),
        train=TrainConfig(batch_size=8, eval_batch_size=8, learning_rate=2e-3, num_epochs=60,
                          val_period=50, save_period=100, log_period=50, seed=0))
    res = tr.train(cfg, packed_synth, str(tmp_path / "bf16run"), echo=False, device="cpu")
    m = tr.evaluate(tr.make_eval_step(res["model"].eval()), res["shared"],
                    Dataset(packed_synth, "train"), 8)
    assert m["acc"] == 1.0, f"bf16 failed the float32 wiring gate: {m['acc']}"


def j_params_of(cfg):
    """The flax params test_torch_video.grads_pair initializes (mc, dilated
    conv, T = 12): the same in either dtype, which only sets the computation."""
    j_shared, _ = shared_pair(cfg)
    j_vi, _ = inputs_pair(cfg, 12, "mc")
    j_model = jv.VideoFVTAModel(cfg=cfg, num_choices=5, temporal_encoder="dilated_conv",
                                task="mc", num_answers=0)
    return jax.tree.map(np.asarray, j_model.init(jax.random.key(0), j_shared, j_vi, train=False))


def test_video_conv_encoder_bf16_vs_f32_and_jax():
    """The video model with the dilated-conv encoder in bf16: its logits vs the
    float32 model's with the same weights (tests/test_bf16.py's bound: under
    0.5, same argmax, not equal), and its logits, loss and every gradient vs
    JAX's bf16 model's."""
    cfg = video_config()
    cfg16 = cfg.replace(model=dataclasses.replace(cfg.model, dtype="bfloat16"))
    (l16, loss16, grads16), (j_l16, j_loss16, j_ref16) = grads_pair(cfg16, "dilated_conv", "mc",
                                                                     12)
    _, shared = shared_pair(cfg)
    _, vi = inputs_pair(cfg, 12, "mc")
    m32 = VideoFVTAModel(Config.from_json(cfg.to_json()), num_choices=5)
    m32.load_state_dict(video_state_dict_from_flax(j_params_of(cfg16)))
    with torch.no_grad():
        l32 = m32(shared, vi).logits.numpy()
    l16 = l16.detach().numpy()
    assert np.isfinite(l16).all()
    assert 0 < np.abs(l16 - l32).max() < 0.5
    assert (l16.argmax(-1) == l32.argmax(-1)).all()
    np.testing.assert_allclose(l16, j_l16, rtol=0, atol=BF16_GRAD)
    assert float(loss16.detach()) == pytest.approx(j_loss16, rel=BF16_GRAD)
    for name, g in grads16.items():
        rel_close(g.numpy(), j_ref16[name].numpy(), 4 * BF16_GRAD, name)
