"""The port's video model (models/video.py) vs the JAX package's flax model on
the CPU, with the weights carried by convert.video_state_dict_from_flax: the
logits, the loss and every parameter gradient for the three task heads (mc,
count, frameqa) × both temporal encoders (dilated_conv, bilstm) × a short T
(the attention's K2 path) and a streaming T (the port's streaming form, with
STREAM_MIN_T lowered below it), at the JAX suite's model tolerance 1e-5 and
gradient tolerance 1e-4 / 1e-5; and the synthetic generator, the video run
directory and the model's input checks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvta_memexqa_tpu.config import Config as JConfig
from fvta_memexqa_tpu.config import DataConfig as JDataConfig
from fvta_memexqa_tpu.config import ModelConfig as JModelConfig
from fvta_memexqa_tpu.data.device_prepro import SharedTables as JSharedTables
from fvta_memexqa_tpu.models import video as jv

from fvta_memexqa_torch.config import Config
from fvta_memexqa_torch.convert import (load_video_rundir, save_video_rundir,
                                        video_state_dict_from_flax)
from fvta_memexqa_torch.data.video_pack import video_shared_tables
from fvta_memexqa_torch.models.video import (VideoFVTAModel, VideoInputs,
                                             make_synthetic_video, video_loss)
from fvta_memexqa_torch.ops import fvta_fused

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
SHORT_T, STREAM_T = 12, 40


def video_config(vocab_embed=False) -> JConfig:
    """The JAX suite's video_config (tests/test_video.py)."""
    return JConfig(
        data=JDataConfig(max_albums=1, max_photos=1, max_question_len=8, max_answer_len=3,
                         max_sent_len=3, max_album_text_len=3, max_word_len=6,
                         image_feat_dim=32, word_emb_dim=16, word_vocab_size=32,
                         char_vocab_size=16, num_glove_words=0),
        model=JModelConfig(hidden_dim=12, char_emb_dim=4, char_cnn_filters=8, keep_prob=1.0,
                           vocab_embed=vocab_embed))


def port_config(cfg: JConfig) -> Config:
    return Config.from_json(cfg.to_json())


def shared_pair(cfg):
    d = cfg.data
    rng = np.random.default_rng(1)
    emb = rng.normal(0, 0.3, (d.word_vocab_size, d.word_emb_dim)).astype(np.float32)
    chars = rng.integers(0, d.char_vocab_size, (d.word_vocab_size, d.max_word_len)).astype(np.int32)
    j_shared = JSharedTables(
        word_emb=jnp.asarray(emb), vocab_chars=jnp.asarray(chars),
        photo_feats=jnp.zeros((1, d.image_feat_dim)),
        album_photo_idx=jnp.zeros((1, 1), jnp.int32),
        album_photo_mask=jnp.zeros((1, 1), bool),
        photo_title_words=jnp.zeros((1, 1, 1), jnp.int32),
        photo_title_chars=jnp.zeros((1, 1, 1, 1), jnp.int32),
        photo_title_mask=jnp.zeros((1, 1, 1), bool),
        album_text_words=jnp.zeros((1, 4, 1), jnp.int32),
        album_text_chars=jnp.zeros((1, 4, 1, 1), jnp.int32),
        album_text_mask=jnp.zeros((1, 4, 1), bool))
    shared = video_shared_tables(port_config(cfg).data,
                                 {"word_emb_init": emb, "vocab_chars": chars})
    return j_shared, shared


def inputs_pair(cfg, t, task, seed=0):
    """The JAX generator's batch, with ragged prefix frame masks and random chars."""
    vi, _ = jv.make_synthetic_video(cfg, num_videos=6, num_frames=t, seed=seed, task=task)
    rng = np.random.default_rng(seed + 7)
    arrs = {k: np.array(v) for k, v in vi.__dict__.items()}
    lens = rng.integers(1, t + 1, arrs["frame_mask"].shape[0])
    lens[0] = t
    arrs["frame_mask"] = np.arange(t)[None, :] < lens[:, None]
    for k in ("q_chars", "choice_chars"):
        arrs[k] = rng.integers(0, cfg.data.char_vocab_size, arrs[k].shape).astype(np.int32)
        arrs[k] *= np.asarray(arrs[k.replace("chars", "mask")])[..., None]
    j_vi = jv.VideoInputs(**{k: jnp.asarray(v) for k, v in arrs.items()})
    return j_vi, VideoInputs(**{k: torch.from_numpy(v) for k, v in arrs.items()})


def grads_pair(cfg, encoder, task, t):
    num_answers = 8 if task == "frameqa" else 0
    j_shared, shared = shared_pair(cfg)
    j_vi, vi = inputs_pair(cfg, t, task)
    j_model = jv.VideoFVTAModel(cfg=cfg, num_choices=5, temporal_encoder=encoder, task=task,
                                num_answers=num_answers)
    params = j_model.init(jax.random.key(0), j_shared, j_vi, train=False)

    def loss(p):
        return jv.video_loss(j_model, p, j_shared, j_vi, None, False)[0]

    j_loss, j_grads = jax.value_and_grad(loss)(params)
    j_logits = j_model.apply(params, j_shared, j_vi, train=False).logits
    model = VideoFVTAModel(port_config(cfg), num_choices=5, temporal_encoder=encoder, task=task,
                           num_answers=num_answers)
    model.load_state_dict(video_state_dict_from_flax(jax.tree.map(np.asarray, params)))
    out = model(shared, vi)
    loss_t, _ = video_loss(model, shared, vi, False)
    names = [n for n, _ in model.named_parameters()]
    # heads that ignore a branch (count reads no attention) leave those
    # parameters out of the graph; flax returns zeros for them
    grads = dict(zip(names, (torch.zeros_like(p) if g is None else g for p, g in zip(
        model.parameters(), torch.autograd.grad(loss_t, list(model.parameters()),
                                                allow_unused=True)))))
    ref = video_state_dict_from_flax(jax.tree.map(np.asarray, j_grads))
    return (out.logits, loss_t, grads), (np.asarray(j_logits), float(j_loss), ref)


@pytest.mark.parametrize("t", [SHORT_T, STREAM_T], ids=["short_t", "streaming_t"])
@pytest.mark.parametrize("encoder", ["dilated_conv", "bilstm"])
@pytest.mark.parametrize("task", ["mc", "count", "frameqa"])
def test_forward_loss_and_every_grad_match_flax(monkeypatch, task, encoder, t):
    monkeypatch.setattr(fvta_fused, "STREAM_MIN_T", 32)
    calls = []
    real = fvta_fused.fvta_stats_fused
    monkeypatch.setattr(fvta_fused, "fvta_stats_fused", lambda *a: calls.append(1) or real(*a))
    (logits, loss, grads), (j_logits, j_loss, ref) = grads_pair(video_config(), encoder, task, t)
    assert bool(calls) == (t >= 32)              # the streaming form ran exactly at long T
    np.testing.assert_allclose(logits.detach().numpy(), j_logits, **MODEL_TOL)
    assert float(loss.detach()) == pytest.approx(j_loss, rel=1e-5, abs=1e-6)
    assert set(grads) == set(ref)
    for name in grads:
        torch.testing.assert_close(grads[name], ref[name], **GRAD_TOL, msg=name)


def test_vocab_table_path_matches_flax(monkeypatch):
    monkeypatch.setattr(fvta_fused, "STREAM_MIN_T", 32)
    (logits, loss, grads), (j_logits, j_loss, ref) = grads_pair(
        video_config(vocab_embed=True), "dilated_conv", "mc", STREAM_T)
    np.testing.assert_allclose(logits.detach().numpy(), j_logits, **MODEL_TOL)
    for name in grads:
        torch.testing.assert_close(grads[name], ref[name], **GRAD_TOL, msg=name)


@pytest.mark.parametrize("task", ["mc", "count", "frameqa"])
def test_synthetic_video_matches_jax(task):
    cfg = video_config()
    j_vi, j_words = jv.make_synthetic_video(cfg, num_videos=5, num_frames=16, seed=3, task=task)
    vi, words = make_synthetic_video(port_config(cfg), num_videos=5, num_frames=16, seed=3,
                                     task=task)
    assert words == j_words
    for k in j_vi.__dict__:
        np.testing.assert_array_equal(getattr(vi, k).numpy(), np.asarray(getattr(j_vi, k)),
                                      err_msg=k)


def test_video_rundir_round_trip(tmp_path):
    cfg = port_config(video_config())
    model = VideoFVTAModel(cfg, task="count", generator=torch.Generator().manual_seed(2))
    run = {"task": "count", "encoder": "dilated_conv", "num_choices": 1, "num_answers": 0,
           "max_frames": 16}
    save_video_rundir(str(tmp_path), cfg, model, run)
    cfg2, run2, loaded = load_video_rundir(str(tmp_path), "cpu")
    assert run2 == run and cfg2 == cfg
    for (n, a), (_, b) in zip(model.state_dict().items(), loaded.state_dict().items()):
        assert torch.equal(a, b), n


def test_model_refuses_bad_options():
    cfg = port_config(video_config())
    with pytest.raises(ValueError, match="num_answers"):
        VideoFVTAModel(cfg, task="frameqa", num_answers=1)
    with pytest.raises(ValueError, match="task"):
        VideoFVTAModel(cfg, task="caption")
    bf16 = cfg.replace(model=dataclasses.replace(cfg.model, dtype="bfloat16"))
    with pytest.raises(NotImplementedError):
        VideoFVTAModel(bf16)
