"""The FVTA MemexQA model: embed → per-modality encoders → focal attention → scorer.

Wiring (the JAX package's models/fvta.py, module for module):

- word-level: GloVe + char-CNN (+ highway) embeddings; ONE shared word bi-LSTM
  encodes the question (per-word states), each answer candidate (summary state)
  and each photo title (summary state).
- time-level, per album: 6 modality sequences (config.MODALITIES order) — photo
  features, photo-title summaries, album title / description / when / where —
  each encoded by its own bi-LSTM, padded to a common T and stacked into the
  context tensor H [N, S=A*6, T, 2H] with mask [N, S, T].
- FVTA core: correlation + hierarchical focal softmax.
- scorer: logits_i = Linear([ctx; q~; a_i; ctx*a_i; q~*a_i]) for the 4 candidates.

Every bi-LSTM goes through ops/lstm_fused and the fvta attention through
ops/fvta_fused: on the card they launch the hand-written kernels (and their
backward under grad), on the CPU they run the plain versions. `use_pallas` /
`pallas_attention` stay in the config for compatibility with saved config.json
files and select nothing here.

Dropout (train=True) follows flax's nn.Dropout: each element is kept with
probability keep_prob and scaled by 1/keep_prob, drawn from the explicit
`torch.Generator` the caller passes (on the inputs' device), so a run that
restores the generator's state resumes bit-identically. With train=False, or
keep_prob = 1, nothing is drawn. Under data parallelism (dropout_row_shard)
each rank draws the whole batch's mask and keeps its rows.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from fvta_memexqa_torch.config import MODALITIES, Config
from fvta_memexqa_torch.data.device_prepro import ModelInputs, SharedTables
from fvta_memexqa_torch.models.embed import CharCNN, Highway, WordEmbed, dense, lecun_normal_
from fvta_memexqa_torch.ops.fvta_fused import fvta_attention_fused
from fvta_memexqa_torch.ops.fvta_ref import (ATTENTION_VARIANTS, AttentionOutput,
                                             similarity_tensor)
from fvta_memexqa_torch.ops.lstm_fused import bilstm_fused, bilstm_fused_final
from fvta_memexqa_torch.ops.lstm_ref import LSTMParams


_ROW_SHARD = threading.local()


@contextlib.contextmanager
def dropout_row_shard(index: int, count: int):
    """Inside the block every dropout draws the mask of the whole batch
    (count x the rows it is given, whose leading axis is the batch) and keeps
    rows [index * n, (index + 1) * n): data rank `index` of `count` then draws
    what the single-rank step draws for its rows, and every rank's generator
    advances alike."""
    prev = getattr(_ROW_SHARD, "value", None)
    _ROW_SHARD.value = (index, count)
    try:
        yield
    finally:
        _ROW_SHARD.value = prev


def flax_dropout(x: torch.Tensor, keep_prob: float, train: bool,
                 generator: torch.Generator | None) -> torch.Tensor:
    """flax nn.Dropout(rate=1 - keep_prob): keep each element with probability
    keep_prob, scale kept ones by 1/keep_prob; the noise comes from `generator`
    (the whole batch's under dropout_row_shard)."""
    if not train or keep_prob >= 1.0:
        return x
    if generator is None:
        raise ValueError("train=True needs a torch.Generator for dropout")
    shard = getattr(_ROW_SHARD, "value", None)
    if shard is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    else:
        index, count = shard
        n = x.shape[0]
        noise = torch.rand((n * count, *x.shape[1:]), generator=generator, device=x.device)
        keep = noise[index * n:(index + 1) * n] < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class ModelOutput(NamedTuple):
    logits: torch.Tensor        # [N, 4]
    attention: AttentionOutput


class BiLSTM(nn.Module):
    """Bidirectional LSTM with TF1 numerics: parameters wx [D, 4H], wh [H, 4H],
    b [4H] per direction (gate order i, j, f, o), glorot-uniform over the
    concatenated [D+H, 4H] kernel with zero bias, as TF1 initializes them.

    fin_only=True promises the caller consumes only the final state: the kernel
    then writes no per-step outputs and forward returns (None, fin).

    dtype="bfloat16" is the bf16 activation variant (ModelConfig.dtype): the
    scan's x-projection and carried state in bf16 with float32 accumulation
    (ops/lstm_fused, dtype=torch.bfloat16), the outputs back in float32 at this
    module's boundary, so attention and the scorer stay float32; the parameters
    stay float32. As in the JAX package, only the bi-LSTMs change."""

    def __init__(self, in_dim: int, hidden_dim: int, forget_bias: float = 1.0,
                 generator=None, dtype: str = "float32"):
        super().__init__()
        self.forget_bias = forget_bias
        self.act_dtype = torch.bfloat16 if dtype == "bfloat16" else None
        lim = math.sqrt(6.0 / (in_dim + hidden_dim + 4 * hidden_dim))
        for d in ("fw", "bw"):
            k = torch.empty(in_dim + hidden_dim, 4 * hidden_dim).uniform_(
                -lim, lim, generator=generator)
            setattr(self, f"{d}_wx", nn.Parameter(k[:in_dim].clone()))
            setattr(self, f"{d}_wh", nn.Parameter(k[in_dim:].clone()))
            setattr(self, f"{d}_b", nn.Parameter(torch.zeros(4 * hidden_dim)))

    def pair(self) -> tuple[LSTMParams, LSTMParams]:
        return (LSTMParams(self.fw_wx, self.fw_wh, self.fw_b),
                LSTMParams(self.bw_wx, self.bw_wh, self.bw_b))

    def forward(self, x: torch.Tensor, mask: torch.Tensor, fin_only: bool = False):
        p_fw, p_bw = self.pair()
        if fin_only:
            return None, bilstm_fused_final(p_fw, p_bw, x, mask, self.forget_bias,
                                            dtype=self.act_dtype)
        return bilstm_fused(p_fw, p_bw, x, mask, self.forget_bias, dtype=self.act_dtype)


class FVTAModel(nn.Module):
    def __init__(self, cfg: Config, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        d, m = cfg.data, cfg.model
        g = generator
        demb = d.word_emb_dim + m.char_cnn_filters
        h2 = 2 * m.hidden_dim
        self.word_embed = WordEmbed(d.num_glove_words, d.word_vocab_size, d.word_emb_dim, g)
        self.char_cnn = CharCNN(max(d.char_vocab_size, 4), m.char_emb_dim,
                                m.char_cnn_filters, m.char_cnn_width, g)
        self.highway = Highway(demb, num_layers=2, generator=g)
        self.keep_prob = m.keep_prob
        self.photo_proj = dense(d.image_feat_dim, demb, g)
        self.enc_word = BiLSTM(demb, m.hidden_dim, m.forget_bias, g, m.dtype)
        # photo_title consumes the word-level summary states, hence in_dim = 2H
        self.enc_time = nn.ModuleDict({
            mod: BiLSTM(h2 if mod == "photo_title" else demb, m.hidden_dim,
                        m.forget_bias, g, m.dtype)
            for mod in MODALITIES})
        if m.similarity == "trilinear":
            for name in ("sim_w_x", "sim_w_y", "sim_w_xy"):
                setattr(self, name, nn.Parameter(
                    torch.empty(h2).normal_(0.0, 0.1, generator=g)))
        elif m.similarity == "bilinear":
            self.sim_w_bilinear = nn.Parameter(lecun_normal_(torch.empty(h2, h2), h2, g))
        self.scorer = dense(5 * h2, 1, g)

    # ---- building blocks -----------------------------------------------------

    def _vocab_table(self, shared: SharedTables) -> torch.Tensor:
        """[V_ext, d_in] token-embedding table: word emb + char-CNN + highway once
        per vocab row (rows >= word_vocab_size: UNK word emb + real chars)."""
        w = self.word_embed.full_table(shared.word_emb, shared.vocab_chars.shape[0])
        c = self.char_cnn(shared.vocab_chars)
        return self.highway(torch.cat([w, c], dim=-1))

    def _photo_table(self, shared: SharedTables) -> torch.Tensor:
        """[num_albums+1, P, d_emb] album-major pre-projected photo features."""
        proj = self.photo_proj(shared.photo_feats)
        return proj[shared.album_photo_idx.long()]

    def _dropout(self, x: torch.Tensor, train: bool,
                 generator: torch.Generator | None) -> torch.Tensor:
        return flax_dropout(x, self.keep_prob, train, generator)

    def _embed_text(self, words, chars, frozen_table, vocab_table=None,
                    train: bool = False, generator=None):
        """word ids [..., L] + char ids [..., L, W] → [..., L, d_in]; dropout
        per token position either way (after the vocab-table gather)."""
        if vocab_table is not None:
            x = vocab_table[words.long()]
        else:
            w = self.word_embed(words, frozen_table)
            c = self.char_cnn(chars)
            x = self.highway(torch.cat([w, c], dim=-1))
        return self._dropout(x, train, generator)

    @staticmethod
    def _encode_words(enc: BiLSTM, x, mask, fin_only: bool = False):
        """Flatten leading dims, run a word-level bi-LSTM, restore leading dims."""
        lead = x.shape[:-2]
        out, fin = enc(x.reshape(-1, *x.shape[-2:]), mask.reshape(-1, mask.shape[-1]),
                       fin_only=fin_only)
        return (out.reshape(*lead, *out.shape[1:]) if out is not None else None,
                fin.reshape(*lead, fin.shape[-1]))

    def _tables(self, shared: SharedTables, vocab_table):
        if vocab_table is None and self.cfg.model.vocab_embed:
            return self._vocab_table(shared)
        return vocab_table

    # ---- forward -------------------------------------------------------------

    def encode_context(self, shared: SharedTables, mi: ModelInputs,
                       vocab_table: torch.Tensor | None = None, *, train: bool = False,
                       generator: torch.Generator | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """Album-side encode: ModelInputs → (H_ctx [N, S, T, 2H], ctx_mask [N, S, T]).
        The album count A is read from the inputs, so one module encodes both the
        query batch (A = max_albums) and one album per row (A = 1)."""
        d, m = self.cfg.data, self.cfg.model
        ft = shared.word_emb
        n, a = mi.album_mask.shape
        p = mi.photo_mask.shape[-1]
        h2 = 2 * m.hidden_dim
        t_ctx = d.max_context_time
        vt = self._tables(shared, vocab_table)

        # photo titles: per-photo summary [N, A, P, 2H] (final states only)
        pt_emb = self._embed_text(mi.photo_title_words, mi.photo_title_chars, ft, vt,
                                  train, generator)
        _, pt_sum = self._encode_words(self.enc_word, pt_emb, mi.photo_title_mask,
                                       fin_only=True)

        pf = mi.photo_feats if mi.photo_projected else self.photo_proj(mi.photo_feats)
        photo_in = self._dropout(pf, train, generator)
        at_emb = self._embed_text(mi.album_text_words, mi.album_text_chars, ft, vt,
                                  train, generator)
        enc_in = [
            (photo_in.reshape(n * a, p, -1), mi.photo_mask.reshape(n * a, p)),
            (pt_sum.reshape(n * a, p, h2), mi.photo_title_mask.any(dim=-1).reshape(n * a, p)),
        ]
        tt = mi.album_text_mask.shape[-1]
        for fi in range(4):  # album_title, album_desc, when, where
            enc_in.append((at_emb[:, :, fi].reshape(n * a, tt, -1),
                           mi.album_text_mask[:, :, fi].reshape(n * a, tt)))

        seqs, masks = [], []
        for enc, (x, mk) in zip(self.enc_time.values(), enc_in):
            out = enc(x, mk)[0]
            pad = t_ctx - out.shape[1]
            seqs.append(F.pad(out, (0, 0, 0, pad)))
            masks.append(F.pad(mk, (0, pad)))
        # [N*A, 6, T, 2H] → [N, A*6, T, 2H] (sequence axis S groups album-major)
        h_ctx = torch.stack(seqs, dim=1).reshape(n, a * len(MODALITIES), t_ctx, h2)
        ctx_mask = torch.stack(masks, dim=1).reshape(n, a * len(MODALITIES), t_ctx)
        return h_ctx, ctx_mask

    def answer(self, shared: SharedTables, mi: ModelInputs, h_ctx: torch.Tensor,
               ctx_mask: torch.Tensor, vocab_table: torch.Tensor | None = None, *,
               train: bool = False, generator: torch.Generator | None = None,
               cp_attention=None) -> ModelOutput:
        """Query side: question/choice encode + FVTA attention over (possibly
        cached) context states + 4-way scorer. Reads only the query fields of
        `mi` (q_*, choice_*), so a data Batch serves as well as ModelInputs.
        cp_attention: a context-parallel attention (parallel/cp.make_cp_attention)
        over the context's time axis, in place of the local one."""
        m = self.cfg.model
        ft = shared.word_emb
        vt = self._tables(shared, vocab_table)

        q_emb = self._embed_text(mi.q_words, mi.q_chars, ft, vt, train, generator)
        h_q, _ = self.enc_word(q_emb, mi.q_mask)                     # [N, J, 2H]
        a_emb = self._embed_text(mi.choice_words, mi.choice_chars, ft, vt, train,
                                 generator)
        _, a_sum = self._encode_words(self.enc_word, a_emb, mi.choice_mask,
                                      fin_only=True)                  # [N, 4, 2H]

        sim_params = {}
        if m.similarity == "trilinear":
            sim_params = {"w_x": self.sim_w_x, "w_y": self.sim_w_y, "w_xy": self.sim_w_xy}
        elif m.similarity == "bilinear":
            sim_params = {"w_bilinear": self.sim_w_bilinear}
        if cp_attention is not None:
            attn = cp_attention(h_ctx, ctx_mask, h_q, mi.q_mask, sim_params)
        elif m.attention == "fvta":
            attn = fvta_attention_fused(h_ctx, ctx_mask, h_q, mi.q_mask, m.similarity,
                                        sim_params)
        else:
            corr = similarity_tensor(h_ctx, h_q, m.similarity, sim_params)
            attn = ATTENTION_VARIANTS[m.attention](h_ctx, ctx_mask, h_q, mi.q_mask, corr)

        ctx = attn.context[:, None, :].expand_as(a_sum)
        qv = attn.question[:, None, :].expand_as(a_sum)
        feats = torch.cat([ctx, qv, a_sum, ctx * a_sum, qv * a_sum], dim=-1)  # [N, 4, 10H]
        return ModelOutput(logits=self.scorer(feats)[..., 0], attention=attn)

    def forward(self, shared: SharedTables, mi: ModelInputs,
                vocab_table: torch.Tensor | None = None, *, train: bool = False,
                generator: torch.Generator | None = None, cp_attention=None
                ) -> ModelOutput:
        vt = self._tables(shared, vocab_table)  # shared by both halves
        h_ctx, ctx_mask = self.encode_context(shared, mi, vt, train=train,
                                              generator=generator)
        return self.answer(shared, mi, h_ctx, ctx_mask, vt, train=train,
                           generator=generator, cp_attention=cp_attention)


def a1_config(cfg: Config) -> Config:
    """The album-only (max_albums=1) twin of a config: one album per row."""
    return cfg.replace(data=dataclasses.replace(cfg.data, max_albums=1))


@torch.no_grad()
def make_vocab_table(model: FVTAModel, shared: SharedTables) -> torch.Tensor | None:
    """Token-embedding table for frozen-parameter use (None without vocab_embed)."""
    if not model.cfg.model.vocab_embed:
        return None
    return model._vocab_table(shared)


@torch.no_grad()
def make_photo_table(model: FVTAModel, shared: SharedTables) -> torch.Tensor:
    """Album-major pre-projected photo table for frozen-parameter use."""
    return model._photo_table(shared)
