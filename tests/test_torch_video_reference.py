"""The port's video model (VideoFVTAModel: the bilstm frame encoder, the mc
head) and its train step against the benchmark's plain reference
(perfbench/reference/video.py) on the CPU, at a small size with ragged frame,
question and choice lengths, seeded random weights, and dropout on from one
seed: logits, loss and every parameter's gradient, then one
`train_video.video_train_step` (clip and Adam) against the reference's.

Tolerances: both sides are float32 on the CPU with the same operations in
the same order except where the port shares work the reference does not (the
bi-LSTM's input projection of both directions as one product, the vocabulary
table's gathers, the attention's reductions), so sums may part in the last
bits: rtol 1e-5 with an atol of 1e-6 (logits, loss; values of order 1) or of
1e-6 x the largest |gradient| of the leaf (gradients, which span six orders
of magnitude across leaves). One Adam step moves an entry by about lr = 1e-3
whatever its gradient's size, so the parameters after it compare at atol
1e-7 (a ten-thousandth of a step), and entries whose gradient is nought on
both sides do not move on either.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from fvta_memexqa_torch import train_video as tv  # noqa: E402
from fvta_memexqa_torch.config import Config, DataConfig, ModelConfig, TrainConfig  # noqa: E402
from fvta_memexqa_torch.data.video_pack import video_shared_tables  # noqa: E402
from fvta_memexqa_torch.models.video import VideoInputs, video_loss  # noqa: E402
from fvta_memexqa_torch.optim import Optimizer  # noqa: E402
from perfbench.reference import plain, video  # noqa: E402

N, T, C = 4, 40, 5
DATA = dict(max_question_len=6, max_answer_len=4, max_word_len=7, image_feat_dim=64,
            word_emb_dim=12, word_vocab_size=50, char_vocab_size=20, num_glove_words=30)
MODEL = dict(hidden_dim=16, char_emb_dim=6, char_cnn_filters=10, char_cnn_width=3,
             keep_prob=0.9, forget_bias=1.0)
RUN = {"task": "mc", "encoder": "bilstm", "num_choices": C, "num_answers": 0, "max_frames": T}
SEED = 20261018


def _prefix(rng, shape, lo, hi):
    return np.arange(hi) < rng.integers(lo, hi + 1, shape)[..., None]


@pytest.fixture(scope="module")
def case():
    """(cfg, d, m, weights, tables, CPU VideoInputs, the reference's batch)."""
    rng = np.random.default_rng(SEED)
    d, m = SimpleNamespace(**DATA), SimpleNamespace(**MODEL)
    fm = _prefix(rng, (N,), T // 2, T)
    qm = _prefix(rng, (N,), 2, d.max_question_len)
    cm = _prefix(rng, (N, C), 1, d.max_answer_len)
    tables = {"word_emb_init": rng.normal(0, 0.5, (d.word_vocab_size, d.word_emb_dim)
                                          ).astype(np.float32),
              "vocab_chars": rng.integers(2, d.char_vocab_size, (d.word_vocab_size,
                                                                 d.max_word_len)).astype(np.int32)}
    qw = rng.integers(2, d.word_vocab_size, qm.shape).astype(np.int32) * qm
    cw = rng.integers(2, d.word_vocab_size, cm.shape).astype(np.int32) * cm
    arrays = dict(frame_feats=np.maximum(rng.normal(0, 1, (N, T, d.image_feat_dim)), 0
                                         ).astype(np.float32) * fm[..., None],
                  frame_mask=fm, q_words=qw, q_chars=tables["vocab_chars"][qw] * qm[..., None],
                  q_mask=qm, choice_words=cw,
                  choice_chars=tables["vocab_chars"][cw] * cm[..., None], choice_mask=cm,
                  label=rng.integers(0, C, N).astype(np.int32), ex_mask=np.ones(N, bool))
    vi = VideoInputs(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    batch = {k: torch.from_numpy(v) for k, v in arrays.items()}
    weights = plain.make_weights(video.param_spec(d, m), SEED, "cpu")
    cfg = Config(data=DataConfig(**DATA), model=ModelConfig(**MODEL),
                 train=TrainConfig(learning_rate=1e-3, grad_clip_norm=5.0))
    return cfg, d, m, weights, tables, vi, batch


def _port(case, seed=1):
    cfg, *_, weights, tables, _vi, _b = case
    state = tv.init_video_state(cfg, RUN, "cpu", seed=seed)
    state.model.load_state_dict(weights, strict=True)
    state.generator.manual_seed(SEED + 7)
    return state, video_shared_tables(cfg.data, tables, "cpu")


def _ref_shared(tables):
    return {"word_emb": torch.from_numpy(tables["word_emb_init"]),
            "vocab_chars": torch.from_numpy(tables["vocab_chars"])}


def _close_grads(got: dict, want: dict):
    assert set(got) == set(want)
    for n in want:
        scale = float(want[n].abs().max())
        torch.testing.assert_close(got[n], want[n], rtol=1e-5, atol=1e-6 * max(scale, 1e-30),
                                   msg=lambda s, n=n: f"{n}: {s}")


def test_param_spec_is_the_models_parameters(case):
    state, _ = _port(case)
    spec = video.param_spec(case[1], case[2])
    assert [(n, tuple(p.shape)) for n, p in state.model.named_parameters()] == [
        (n, s) for n, s, _ in spec]


@pytest.mark.parametrize("train", [False, True])
def test_logits_loss_and_gradients_match_the_reference(case, train):
    """Dropout off (train=False) and on (drawn from one seed on both sides)."""
    _cfg, d, m, weights, tables, vi, batch = case
    state, shared = _port(case)
    model = state.model
    out = model(shared, vi, train=train, generator=state.generator)
    loss, _ = video_loss(model, shared, vi, train, state.generator.manual_seed(SEED + 7))
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                 allow_unused=True)))

    p = {n: w.clone().requires_grad_() for n, w in weights.items()}
    g = torch.Generator().manual_seed(SEED + 7) if train else None
    ref_logits = video.logits(p, _ref_shared(tables), batch, d, m, g)
    ref_loss = video.train_loss(p, _ref_shared(tables), batch, d, m,
                                torch.Generator().manual_seed(SEED + 7) if train else None)
    ref_grads = dict(zip(p, torch.autograd.grad(ref_loss, list(p.values()), allow_unused=True)))

    assert out.logits.shape == (N, C)
    torch.testing.assert_close(out.logits, ref_logits, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=1e-6)
    zero = {n: torch.zeros_like(w) for n, w in weights.items()}
    _close_grads({n: zero[n] if v is None else v for n, v in grads.items()},
                 {n: zero[n] if v is None else v for n, v in ref_grads.items()})
    assert all(float(v.abs().max()) > 0 for n, v in ref_grads.items()
               if v is not None and n not in ("scorer.bias",))


@pytest.mark.parametrize("clip", [5.0, 1e-3])
def test_train_step_matches_the_references_clip_and_adam(case, clip):
    """One video_train_step against the reference's loss, gradient, global-norm
    clip and Adam; clip 1e-3 lies under the gradient's norm, so it scales."""
    cfg, d, m, weights, tables, vi, batch = case
    state, shared = _port(case)
    tcfg = TrainConfig(learning_rate=1e-3, grad_clip_norm=clip)
    out = tv.video_train_step(state, Optimizer(tcfg), shared, vi)

    p = {n: w.clone().requires_grad_() for n, w in weights.items()}
    ref_loss = video.train_loss(p, _ref_shared(tables), batch, d, m,
                                torch.Generator().manual_seed(SEED + 7))
    grads = torch.autograd.grad(ref_loss, list(p.values()), allow_unused=True)
    grads = {n: torch.zeros_like(v) if gr is None else gr for (n, v), gr in zip(p.items(), grads)}
    norm = float(torch.sqrt(sum((g * g).sum() for g in grads.values())))
    assert (norm > clip) == (clip < 1.0)
    clipped = plain.adam_step(p, grads, {}, tcfg.learning_rate, clip)

    torch.testing.assert_close(out["loss"], ref_loss.detach(), rtol=1e-5, atol=1e-6)
    _close_grads({n: mu / 0.1 for n, mu in state.opt_state["mu"].items()},
                 {n: g.detach() for n, g in clipped.items()})
    for n, w in state.model.named_parameters():
        torch.testing.assert_close(w.detach(), p[n].detach(), rtol=0, atol=1e-7,
                                   msg=lambda s, n=n: f"{n}: {s}")
    moved = {n for n, w in state.model.named_parameters()
             if not torch.equal(w.detach(), weights[n])}
    assert moved >= {n for n, g in grads.items() if bool((g != 0).any())}
