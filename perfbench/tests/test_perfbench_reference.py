"""The plain reference against the port's CPU path (its plain versions) at
tiny sizes: the same parameters, loss, gradients, Adam step, album cache and
logits from the same weights, inputs and dropout stream."""

from types import SimpleNamespace

import torch

from perfbench.lib import gen
from perfbench.reference import memexqa, plain
from perfbench.tests.conftest import TINY

D = SimpleNamespace(**TINY["config"]["data"])
M = SimpleNamespace(**{"keep_prob": 0.9, "forget_bias": 1.0, **TINY["config"]["model"]})


def _cfg(**train):
    from fvta_memexqa_torch.config import Config, DataConfig, ModelConfig, TrainConfig

    return Config(data=DataConfig(**TINY["config"]["data"]),
                  model=ModelConfig(**TINY["config"]["model"]), train=TrainConfig(**train))


def _model(weights):
    from fvta_memexqa_torch.models.fvta import FVTAModel

    model = FVTAModel(_cfg())
    model.load_state_dict(weights)
    return model


def _inputs(seed=1, n=6):
    from fvta_memexqa_torch.data.device_prepro import Batch, SharedTables

    shared_np = gen.synth_shared(D, 10, 20, seed)
    batch_np = gen.synth_batch(D, n, 10, seed + 1)
    shared = {k: torch.from_numpy(v) for k, v in shared_np.items()}
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    return shared, batch, SharedTables(**shared), Batch(**batch)


def test_param_spec_is_the_models():
    from fvta_memexqa_torch.models.fvta import FVTAModel

    model, spec = FVTAModel(_cfg()), memexqa.param_spec(D, M)
    assert [(n, tuple(p.shape)) for n, p in model.named_parameters()] == [
        (n, tuple(s)) for n, s, _ in spec]


def test_train_loss_and_gradients():
    from fvta_memexqa_torch.train import loss_and_metrics

    weights = plain.make_weights(memexqa.param_spec(D, M), 7, "cpu")
    shared, batch, shared_t, batch_t = _inputs()
    model = _model(weights)
    loss_p, _ = loss_and_metrics(model, shared_t, batch_t, True, torch.Generator().manual_seed(3))
    grads_p = torch.autograd.grad(loss_p, list(model.parameters()))
    p = {n: w.clone().requires_grad_() for n, w in weights.items()}
    loss_r = memexqa.train_loss(p, shared, batch, D, M, torch.Generator().manual_seed(3))
    grads_r = torch.autograd.grad(loss_r, list(p.values()))
    torch.testing.assert_close(loss_r, loss_p, rtol=1e-6, atol=1e-7)
    for (name, _), gp, gr in zip(model.named_parameters(), grads_p, grads_r):
        torch.testing.assert_close(gr, gp, rtol=1e-5, atol=1e-7, msg=name)


def test_adam_step_is_the_optimizers():
    from fvta_memexqa_torch.optim import Optimizer

    weights = plain.make_weights(memexqa.param_spec(D, M), 8, "cpu")
    g = torch.Generator().manual_seed(0)
    grads = {n: torch.randn(w.shape, generator=g) for n, w in weights.items()}
    opt = Optimizer(_cfg(learning_rate=1e-3, grad_clip_norm=5.0).train)
    prog = {n: w.clone() for n, w in weights.items()}
    ref = {n: w.clone() for n, w in weights.items()}
    state_p, state_r = opt.init(prog), {}
    for _ in range(3):
        opt.update(prog, grads, state_p)
        plain.adam_step(ref, grads, state_r, 1e-3, 5.0)
    for n in prog:
        torch.testing.assert_close(ref[n], prog[n], rtol=0, atol=0, msg=n)


def test_album_cache_and_logits():
    from fvta_memexqa_torch.eval_cache import gather_cached_context, precompute_album_cache
    from fvta_memexqa_torch.train import make_eval_tables

    weights = plain.make_weights(memexqa.param_spec(D, M), 9, "cpu")
    shared, batch, shared_t, batch_t = _inputs(seed=4, n=8)
    model = _model(weights).eval()
    with torch.no_grad():
        vt, pt = make_eval_tables(model, shared_t)
        ch, cm = precompute_album_cache(_cfg(), model, shared_t, batch_size=4, vocab_table=vt,
                                        photo_table=pt)
        h_ctx, m_ctx = gather_cached_context(ch, cm, batch_t.album_idx, batch_t.album_mask)
        logits_p = model.answer(shared_t, batch_t, h_ctx, m_ctx, vt).logits
    vt_r, ch_r, cm_r = memexqa.album_cache(weights, shared, D, M, block=3)
    logits_r = memexqa.cached_logits(weights, batch, vt_r, ch_r, cm_r, M, batch=5)
    assert torch.equal(cm_r, cm)
    torch.testing.assert_close(ch_r, ch, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(logits_r, logits_p, rtol=1e-5, atol=1e-6)
