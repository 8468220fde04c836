"""The plain video FVTA model (fvta_memexqa_torch/models/video.py
VideoFVTAModel with temporal_encoder "bilstm" and task "mc", its loss and its
train step) as functions of a parameter dict whose names are the program's
state_dict names.

One forward: the vocabulary table (GloVe / OOV word row + char-CNN + highway
for every vocabulary row, gathered per token); the frames projected to the
token width and encoded by their own bi-LSTM; the question and each choice
encoded by the shared word bi-LSTM (per-word states, final states); the
trilinear focal attention over frames x question words at S = 1; the 5-way
scorer over [ctx; q~; a; ctx * a; q~ * a]; the masked cross-entropy. Dropout
is drawn in the model's order: the projected frames, question tokens, choice
tokens. Every bi-LSTM is plain.bilstm, the TF1 cell as a Python loop over t.

Departures from the FVTA paper (Liang et al., CVPR 2018), all the program's:
- one context sequence (the clip's frames), so the sequence-level softmax
  over S = 1 is a constant 1 and the focal attention is its time level;
- the frames enter through a learned projection to the token width (2048 ->
  word_emb_dim + char_cnn_filters) before their bi-LSTM;
- the token embedding is computed once per vocabulary row and gathered (the
  same function of the parameters as embedding each token);
- the LSTM is TF1's BasicLSTMCell (gates i, j, f, o, forget bias 1.0 inside
  the cell), a row past its length carries its state and outputs zeros;
- dropout is flax's (keep with probability keep_prob, scale by 1 / keep_prob)
  on the projected frames and the embedded tokens;
- the optimizer is optax's clip_by_global_norm then Adam, as the
  configuration states.
"""

from __future__ import annotations

from perfbench.reference import plain


def param_spec(d, m) -> list[tuple]:
    """(name, shape, std) of every parameter, in the program's named_parameters order."""
    h, demb = m.hidden_dim, d.word_emb_dim + m.char_cnn_filters
    spec = [(f"sim_w_{k}", (2 * h,), 0.1) for k in ("x", "y", "xy")]
    spec += plain.embed_spec(d, m)
    spec += plain.lstm_spec("enc_word.", demb, h)
    spec += plain.dense_spec("frame_proj", d.image_feat_dim, demb)
    spec += plain.lstm_spec("enc_frames.", demb, h)
    spec += plain.dense_spec("scorer", 10 * h, 1)
    return spec


def logits(p, shared, batch, d, m, gen):
    """Logits [N, C] of a batch (frame_feats [N, T, F], frame_mask [N, T],
    q_words, q_mask, choice_words, choice_mask); gen None: no dropout."""
    fb, kp = m.forget_bias, m.keep_prob
    vt = plain.vocab_table(p, shared["word_emb"], shared["vocab_chars"], d, m)
    x = plain.dropout(plain.dense(p, "frame_proj", batch["frame_feats"]), kp, gen)
    h_ctx, _ = plain.bilstm(p, "enc_frames.", x, batch["frame_mask"], fb)
    q_emb = plain.dropout(vt[batch["q_words"].long()], kp, gen)
    h_q, _ = plain.bilstm(p, "enc_word.", q_emb, batch["q_mask"], fb)
    a_emb = plain.dropout(vt[batch["choice_words"].long()], kp, gen)
    _, a_sum = plain.bilstm_rows(p, "enc_word.", a_emb, batch["choice_mask"], fb)
    h_ctx, ctx_mask = h_ctx[:, None], batch["frame_mask"][:, None]
    c = plain.trilinear(h_ctx, h_q, p["sim_w_x"], p["sim_w_y"], p["sim_w_xy"])
    ctx, qv = plain.fvta_attention(h_ctx, ctx_mask, h_q, batch["q_mask"], c)
    return plain.scores(p, ctx, qv, a_sum)


def train_loss(p, shared, batch, d, m, gen):
    """The train step's loss: the forward with dropout, masked C-way cross-entropy."""
    return plain.choice_metrics(logits(p, shared, batch, d, m, gen), batch["label"],
                                batch["ex_mask"])[0]
