"""TGIF-QA-style video QA: FVTA over long frame-feature sequences (the JAX
package's models/video.py, module for module).

The context is one frame sequence, so S = 1 and the focal softmax reduces to
its time level; the attention is ops/fvta_fused.fvta_attention_fused, which
from STREAM_MIN_T frames on takes the streaming form (kernel K4 forward, K5 +
K6 backward on the card). Temporal encoders: "dilated_conv" (stacked dilated
convolutions with residuals, parallel over T) or "bilstm" (a projection, then
the bi-LSTM of kernels K1/K1b). Task heads:

- "mc": C-way multiple choice; logits [N, C];
- "count": repetition count as a regression; a question-conditioned per-frame
  detector on the raw frame features, summed over valid frames; logits [N, 1];
- "frameqa": classification over the pack's answer vocabulary; logits
  [N, num_answers].

Parameters carry the flax module names (convert.video_state_dict_from_flax
maps a flax tree onto them); dropout is flax's, drawn from an explicit
torch.Generator. Convolutions run through cuDNN on the card: the train and
test drivers turn TF32 off for their run (train_video.exact_float32).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fvta_memexqa_torch.config import Config
from fvta_memexqa_torch.data.device_prepro import SharedTables
from fvta_memexqa_torch.models.embed import CharCNN, Highway, WordEmbed, dense, lecun_normal_
from fvta_memexqa_torch.models.fvta import BiLSTM, flax_dropout
from fvta_memexqa_torch.ops.fvta_fused import fvta_attention_fused
from fvta_memexqa_torch.ops.fvta_ref import (ATTENTION_VARIANTS, AttentionOutput,
                                             similarity_tensor)
from fvta_memexqa_torch.utils.metrics import span

COUNT_MIN, COUNT_MAX = 1, 10  # TGIF-QA repetition-count answer range


@dataclass
class VideoInputs:
    frame_feats: torch.Tensor   # f32 [N, T, F]
    frame_mask: torch.Tensor    # bool [N, T] (a prefix of each row)
    q_words: torch.Tensor       # i32 [N, Jq]
    q_chars: torch.Tensor       # i32 [N, Jq, W]
    q_mask: torch.Tensor        # bool [N, Jq]
    choice_words: torch.Tensor  # i32 [N, C, Ja]
    choice_chars: torch.Tensor  # i32 [N, C, Ja, W]
    choice_mask: torch.Tensor   # bool [N, C, Ja]
    label: torch.Tensor         # i32 [N]
    ex_mask: torch.Tensor       # bool [N]

    def to(self, device) -> "VideoInputs":
        """The same inputs with every field on `device` (the span
        fvta.loader.h2d)."""
        with span("fvta.loader.h2d"):
            return VideoInputs(**{k: v.to(device) for k, v in self.__dict__.items()})


class VideoOutput(NamedTuple):
    logits: torch.Tensor        # [N, C] | [N, 1] | [N, num_answers]
    attention: AttentionOutput


class DilatedConvEncoder(nn.Module):
    """in_proj to 2H, then num_layers of x += gelu(conv_l(x)) (kernel 3,
    dilation 2^l, 'SAME' padding), masked at every layer; returns the states
    [N, T, 2H] and their masked mean over time [N, 2H].

    dtype="bfloat16" runs in_proj and the conv stack with bf16 activations (the
    parameters stay float32 and are cast for the computation, as flax's
    computation dtype does) and casts back to float32 at the module boundary;
    the masked mean accumulates in float32 either way. The convs stay
    nn.Conv1d modules, computed by F.conv1d on their cast parameters: the JAX
    package computes them outside any Pallas kernel."""

    def __init__(self, in_dim: int, hidden_dim: int, num_layers: int = 4, generator=None,
                 dtype: str = "float32"):
        super().__init__()
        self.act_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        h2 = 2 * hidden_dim
        self.in_proj = dense(in_dim, h2, generator)
        for li in range(num_layers):
            conv = nn.Conv1d(h2, h2, kernel_size=3, dilation=2 ** li, padding=2 ** li)
            with torch.no_grad():
                # flax Conv's lecun_normal over the kernel [3, in, out]: fan_in = 3 * in
                lecun_normal_(conv.weight, 3 * h2, generator)
                conv.bias.zero_()
            setattr(self, f"conv{li}", conv)
        self.num_layers = num_layers

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        cdt = self.act_dtype
        x = x.to(cdt)
        m = mask[..., None].to(cdt)
        x = F.linear(x, self.in_proj.weight.to(cdt), self.in_proj.bias.to(cdt)) * m
        for li in range(self.num_layers):
            conv = getattr(self, f"conv{li}")
            y = F.conv1d((x * m).transpose(1, 2), conv.weight.to(cdt), conv.bias.to(cdt),
                         padding=conv.padding, dilation=conv.dilation).transpose(1, 2)
            x = x + F.gelu(y, approximate="tanh") * m      # flax nn.gelu is the tanh form
        xf = (x * m).float()
        fin = xf.sum(dim=1) / torch.clamp(m.float().sum(dim=1), min=1.0)
        return xf, fin


class VideoFVTAModel(nn.Module):
    """Question vs a frame sequence, scored FVTA-style, with the mc, count and
    frameqa heads (see the module docstring)."""

    def __init__(self, cfg: Config, num_choices: int = 5,
                 temporal_encoder: str = "dilated_conv", task: str = "mc",
                 num_answers: int = 0, generator: torch.Generator | None = None):
        super().__init__()
        if task not in ("mc", "count", "frameqa"):
            raise ValueError(f"unknown task {task!r} (expected mc | count | frameqa)")
        if task == "frameqa" and num_answers < 2:
            raise ValueError("task='frameqa' needs num_answers >= 2 "
                             "(the pack-time answer vocabulary size)")
        self.cfg, self.num_choices, self.task = cfg, num_choices, task
        self.temporal_encoder, self.num_answers = temporal_encoder, num_answers
        d, m = cfg.data, cfg.model
        g = generator
        demb = d.word_emb_dim + m.char_cnn_filters
        h2 = 2 * m.hidden_dim
        self.keep_prob = m.keep_prob
        self.word_embed = WordEmbed(d.num_glove_words, d.word_vocab_size, d.word_emb_dim, g)
        self.char_cnn = CharCNN(max(d.char_vocab_size, 4), m.char_emb_dim,
                                m.char_cnn_filters, m.char_cnn_width, g)
        self.highway = Highway(demb, num_layers=2, generator=g)
        self.enc_word = BiLSTM(demb, m.hidden_dim, m.forget_bias, g, m.dtype)
        if temporal_encoder == "bilstm":
            self.frame_proj = dense(d.image_feat_dim, demb, g)
            self.enc_frames = BiLSTM(demb, m.hidden_dim, m.forget_bias, g, m.dtype)
        elif temporal_encoder == "dilated_conv":
            self.enc_frames = DilatedConvEncoder(d.image_feat_dim, m.hidden_dim, generator=g,
                                                 dtype=m.dtype)
        else:
            raise ValueError(f"unknown temporal encoder {temporal_encoder!r}")
        if m.similarity == "trilinear":
            for name in ("sim_w_x", "sim_w_y", "sim_w_xy"):
                setattr(self, name, nn.Parameter(torch.empty(h2).normal_(0.0, 0.1, generator=g)))
        elif m.similarity == "bilinear":
            self.sim_w_bilinear = nn.Parameter(lecun_normal_(torch.empty(h2, h2), h2, g))
        if task == "mc":
            self.scorer = dense(5 * h2, 1, g)
        elif task == "count":
            self.count_head = dense(h2 + 1, 1, g)
            self.count_frame = dense(2 * d.image_feat_dim, 1, g)
            self.count_qproj = dense(h2, d.image_feat_dim, g)
        else:
            self.frameqa_head = dense(5 * h2, num_answers, g)

    def _vocab_table(self, shared: SharedTables) -> torch.Tensor:
        """[V, d_in] token table: word emb + char-CNN + highway once per vocab row."""
        w = self.word_embed.full_table(shared.word_emb, shared.vocab_chars.shape[0])
        c = self.char_cnn(shared.vocab_chars)
        return self.highway(torch.cat([w, c], dim=-1))

    def _embed_text(self, shared, words, chars, train, generator, vocab_table=None):
        if vocab_table is not None:
            x = vocab_table[words.long()]
        else:
            w = self.word_embed(words, shared.word_emb)
            c = self.char_cnn(chars)
            x = self.highway(torch.cat([w, c], dim=-1))
        return flax_dropout(x, self.keep_prob, train, generator)

    def encode_frames(self, vi: VideoInputs, train: bool = False, generator=None):
        """Frame sequence → context states [N, 1, T, 2H] and mask [N, 1, T]
        (the span fvta.video.frames)."""
        with span("fvta.video.frames"):
            if self.temporal_encoder == "bilstm":
                x = flax_dropout(self.frame_proj(vi.frame_feats), self.keep_prob, train,
                                 generator)
                out, _ = self.enc_frames(x, vi.frame_mask)
            else:
                out, _ = self.enc_frames(vi.frame_feats, vi.frame_mask)
            return out[:, None], vi.frame_mask[:, None]

    def answer(self, shared: SharedTables, vi: VideoInputs, h_ctx, ctx_mask,
               train: bool = False, generator=None, vocab_table=None,
               cp_attention=None) -> VideoOutput:
        """Question (and choice) encode, the attention over the frame states —
        cp_attention (parallel/cp.make_cp_attention) shards its time axis over
        ranks —, then the task head."""
        m = self.cfg.model
        vt = vocab_table
        if vt is None and m.vocab_embed:
            vt = self._vocab_table(shared)   # once; shared by question and choices
        q_emb = self._embed_text(shared, vi.q_words, vi.q_chars, train, generator, vt)
        h_q, q_fin = self.enc_word(q_emb, vi.q_mask)
        if self.task == "mc":
            a_emb = self._embed_text(shared, vi.choice_words, vi.choice_chars, train,
                                     generator, vt)
            n, c_num = a_emb.shape[:2]
            _, a_fin = self.enc_word(a_emb.reshape(n * c_num, *a_emb.shape[2:]),
                                     vi.choice_mask.reshape(n * c_num, -1), fin_only=True)
            a_sum = a_fin.reshape(n, c_num, -1)

        sim_params = {}
        if m.similarity == "trilinear":
            sim_params = {"w_x": self.sim_w_x, "w_y": self.sim_w_y, "w_xy": self.sim_w_xy}
        elif m.similarity == "bilinear":
            sim_params = {"w_bilinear": self.sim_w_bilinear}
        if cp_attention is not None:
            attn = cp_attention(h_ctx, ctx_mask, h_q, vi.q_mask, sim_params)
        elif m.attention == "fvta":
            attn = fvta_attention_fused(h_ctx, ctx_mask, h_q, vi.q_mask, m.similarity,
                                        sim_params)
        else:
            corr = similarity_tensor(h_ctx, h_q, m.similarity, sim_params)
            attn = ATTENTION_VARIANTS[m.attention](h_ctx, ctx_mask, h_q, vi.q_mask, corr)

        if self.task == "mc":
            ctx = attn.context[:, None, :].expand_as(a_sum)
            qv = attn.question[:, None, :].expand_as(a_sum)
            feats = torch.cat([ctx, qv, a_sum, ctx * a_sum, qv * a_sum], dim=-1)
            return VideoOutput(self.scorer(feats)[..., 0], attn)
        if self.task == "count":
            # a per-frame detector on the RAW frame features, conditioned on the
            # question encoding alone, summed over valid frames
            f = vi.frame_feats                                          # [N, T, F]
            qp = self.count_qproj(q_fin)[:, None, :]                    # [N, 1, F]
            s_t = self.count_frame(torch.cat([f, f * qp], dim=-1))[..., 0]   # [N, T]
            softcnt = (torch.sigmoid(s_t) * vi.frame_mask.to(s_t.dtype)).sum(dim=1)
            return VideoOutput(self.count_head(torch.cat([q_fin, softcnt[:, None]], -1)), attn)
        mk = ctx_mask.to(h_ctx.dtype)[..., None]                       # [N, S, T, 1]
        hbar = (h_ctx * mk).sum(dim=(1, 2)) / torch.clamp(mk.sum(dim=(1, 2)), min=1.0)
        ctx, qv = attn.context, attn.question
        feats = torch.cat([ctx, qv, ctx * qv, hbar, ctx * hbar], dim=-1)
        return VideoOutput(self.frameqa_head(feats), attn)

    def forward(self, shared: SharedTables, vi: VideoInputs, train: bool = False,
                generator: torch.Generator | None = None, vocab_table=None,
                cp_attention=None) -> VideoOutput:
        h_ctx, ctx_mask = self.encode_frames(vi, train, generator)
        return self.answer(shared, vi, h_ctx, ctx_mask, train, generator, vocab_table,
                           cp_attention)


def video_metrics(task: str, logits: torch.Tensor, vi: VideoInputs) -> dict[str, torch.Tensor]:
    """Masked sums of one batch: loss_sum, correct, sq_err, count (ex_mask
    excludes pad rows). count: L2 on the raw count and exact match of the
    rounded, range-clipped prediction; frameqa: label -1 (an answer outside
    the train vocabulary) has no loss and always counts wrong."""
    w = vi.ex_mask.to(torch.float32)
    label = vi.label.long()
    zero = logits.new_zeros(())
    if task == "count":
        pred = logits[:, 0]
        err = pred - label.to(pred.dtype)
        rounded = torch.clamp(torch.round(pred), COUNT_MIN, COUNT_MAX).long()
        sq = (err * err * w).sum()
        return {"loss_sum": sq, "correct": ((rounded == label) * w).sum(),
                "sq_err": sq, "count": w.sum()}
    valid = (label >= 0) & vi.ex_mask
    nll = -torch.gather(F.log_softmax(logits, dim=-1), 1, label.clamp(min=0)[:, None])[:, 0]
    hit = (torch.argmax(logits, -1) == label) & valid
    loss_w = valid.to(torch.float32) if task == "frameqa" else w
    return {"loss_sum": (nll * loss_w).sum(), "correct": (hit * w).sum(), "sq_err": zero,
            "count": w.sum(), "loss_count": loss_w.sum()}


def video_loss(model: VideoFVTAModel, shared: SharedTables, vi: VideoInputs, train: bool,
               generator: torch.Generator | None = None, cp_attention=None):
    """(loss, {"acc"[, "mse"]}): masked softmax CE over choices (mc), over the
    answer vocabulary (frameqa), or masked L2 on the count (count)."""
    out = model(shared, vi, train=train, generator=generator, cp_attention=cp_attention)
    s = video_metrics(model.task, out.logits, vi)
    n = torch.clamp(s["count"], min=1.0)
    loss = s["loss_sum"] / torch.clamp(s.get("loss_count", s["count"]), min=1.0)
    metrics = {"acc": s["correct"] / n}
    if model.task == "count":
        metrics["mse"] = loss
    return loss, metrics


def make_synthetic_video(cfg: Config, num_videos: int = 32, num_frames: int = 64,
                         num_choices: int = 5, seed: int = 0, task: str = "mc"):
    """Deterministic synthetic video QA in the TGIF-QA task shapes (the JAX
    package's generator: the same numbers for the same arguments). mc: a
    dominant event direction in a contiguous span, the question asks which
    event; count: the asked event planted in `label` disjoint spans plus a
    distractor event with its own count; frameqa: one event, the label its
    index. Returns (VideoInputs of CPU tensors, vocabulary words)."""
    d = cfg.data
    rng = np.random.default_rng(seed)
    events = ["jump", "spin", "wave", "fall", "clap", "run", "nod", "point"]
    dir_rng = np.random.default_rng(20260816)
    dirs = {e: dir_rng.normal(0, 1, d.image_feat_dim).astype(np.float32) for e in events}
    n = num_videos
    feats = 0.1 * rng.normal(0, 1, (n, num_frames, d.image_feat_dim)).astype(np.float32)
    labels = np.zeros(n, np.int32)
    words = ["what", "did", "the", "person", "do", "?", "how", "many", "times"] + events
    w2i = {w: i + 2 for i, w in enumerate(words)}
    if task != "mc":
        num_choices = 1
    q_words = np.zeros((n, d.max_question_len), np.int32)
    q_mask = np.zeros((n, d.max_question_len), bool)
    c_words = np.zeros((n, num_choices, d.max_answer_len), np.int32)
    c_mask = np.zeros((n, num_choices, d.max_answer_len), bool)
    span_w = 2
    count_max = min(COUNT_MAX, max(num_frames // (2 * span_w) - 1, COUNT_MIN + 1))
    for i in range(n):
        ev_idx = int(rng.integers(len(events)))
        ev = events[ev_idx]
        if task == "count":
            k = int(rng.integers(COUNT_MIN, count_max + 1))
            k2 = int(rng.integers(COUNT_MIN, count_max + 1))
            slots = rng.permutation(num_frames // span_w)
            other = events[(ev_idx + 1 + int(rng.integers(len(events) - 1))) % len(events)]
            for sl in slots[:k]:
                feats[i, sl * span_w: (sl + 1) * span_w] += dirs[ev]
            for sl in slots[k: k + k2]:
                feats[i, sl * span_w: (sl + 1) * span_w] += dirs[other]
            labels[i] = k
            q = ["how", "many", "times", "did", "the", "person", ev, "?"]
        else:
            start = int(rng.integers(0, max(num_frames // 2, 1)))
            span = int(rng.integers(2, max(num_frames // 2, 3)))
            feats[i, start: start + span] += dirs[ev]
            q = ["what", "did", "the", "person", "do", "?"]
        for j, w in enumerate(q[: d.max_question_len]):
            q_words[i, j] = w2i[w]
            q_mask[i, j] = True
        if task == "frameqa":
            labels[i] = ev_idx
        elif task == "mc":
            others = [e for e in events if e != ev]
            pick = list(rng.choice(len(others), num_choices - 1, replace=False))
            choices = [ev] + [others[int(p)] for p in pick]
            order = rng.permutation(num_choices)
            for ci, oi in enumerate(order):
                c_words[i, ci, 0] = w2i[choices[int(oi)]]
                c_mask[i, ci, 0] = True
                if int(oi) == 0:
                    labels[i] = ci
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True) + 1e-6
    t = torch.from_numpy
    vi = VideoInputs(
        frame_feats=t(feats), frame_mask=torch.ones(n, num_frames, dtype=torch.bool),
        q_words=t(q_words), q_chars=torch.zeros(n, d.max_question_len, d.max_word_len,
                                                dtype=torch.int32),
        q_mask=t(q_mask), choice_words=t(c_words),
        choice_chars=torch.zeros(n, num_choices, d.max_answer_len, d.max_word_len,
                                 dtype=torch.int32),
        choice_mask=t(c_mask), label=t(labels), ex_mask=torch.ones(n, dtype=torch.bool))
    return vi, words
