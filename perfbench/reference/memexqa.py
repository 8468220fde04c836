"""The plain MemexQA FVTA model (fvta_memexqa_torch/models/fvta.py FVTAModel,
its train step and its cached evaluation), as functions of a parameter dict
whose names are the program's state_dict names.

Dropout is drawn in the model's order: photo-title tokens, projected photos,
album-text tokens, question tokens, choice tokens.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import plain

MODALITIES = ("photo", "photo_title", "album_title", "album_desc", "when", "where")


def param_spec(d, m) -> list[tuple]:
    """(name, shape, std) of every parameter, in the program's named_parameters order."""
    h, demb = m.hidden_dim, d.word_emb_dim + m.char_cnn_filters
    spec = [(f"sim_w_{k}", (2 * h,), 0.1) for k in ("x", "y", "xy")]
    spec += plain.embed_spec(d, m)
    spec += plain.dense_spec("photo_proj", d.image_feat_dim, demb)
    spec += plain.lstm_spec("enc_word.", demb, h)
    for mod in MODALITIES:
        spec += plain.lstm_spec(f"enc_time.{mod}.", 2 * h if mod == "photo_title" else demb, h)
    spec += plain.dense_spec("scorer", 10 * h, 1)
    return spec


def encode_context(p, shared, album_idx, album_mask, photo_in, vt, d, m, gen):
    """(h_ctx [N, A*6, T, 2H], ctx_mask [N, A*6, T]) of album rows album_idx
    [N, A]; photo_in: the projected photo features [N, A, P, D] (dropout is
    applied here)."""
    fb, kp = m.forget_bias, m.keep_prob
    n, a = album_idx.shape
    idx = album_idx.long()
    am = album_mask[..., None]
    h2, t_ctx = 2 * m.hidden_dim, max(d.max_photos, d.max_album_text_len)
    title_mask = shared["photo_title_mask"][idx] & am[..., None]
    text_mask = shared["album_text_mask"][idx] & am[..., None]
    photo_mask = shared["album_photo_mask"][idx] & am
    pt_emb = plain.dropout(vt[shared["photo_title_words"][idx].long()], kp, gen)
    _, pt_sum = plain.bilstm_rows(p, "enc_word.", pt_emb, title_mask, fb)
    photo_in = plain.dropout(photo_in, kp, gen)
    at_emb = plain.dropout(vt[shared["album_text_words"][idx].long()], kp, gen)
    p_ = photo_mask.shape[-1]
    enc_in = [(photo_in.reshape(n * a, p_, -1), photo_mask.reshape(n * a, p_)),
              (pt_sum.reshape(n * a, p_, h2), title_mask.any(dim=-1).reshape(n * a, p_))]
    tt = text_mask.shape[-1]
    for fi in range(4):
        enc_in.append((at_emb[:, :, fi].reshape(n * a, tt, -1),
                       text_mask[:, :, fi].reshape(n * a, tt)))
    seqs, masks = [], []
    for mod, (x, mk) in zip(MODALITIES, enc_in):
        out, _ = plain.bilstm(p, f"enc_time.{mod}.", x, mk, fb)
        pad = t_ctx - out.shape[1]
        seqs.append(F.pad(out, (0, 0, 0, pad)))
        masks.append(F.pad(mk, (0, pad)))
    return (torch.stack(seqs, 1).reshape(n, a * 6, t_ctx, h2),
            torch.stack(masks, 1).reshape(n, a * 6, t_ctx))


def answer(p, q, h_ctx, ctx_mask, vt, m, gen):
    """Logits [N, 4] of questions q (q_words, q_mask, choice_words,
    choice_mask) over context states."""
    fb, kp = m.forget_bias, m.keep_prob
    q_emb = plain.dropout(vt[q["q_words"].long()], kp, gen)
    h_q, _ = plain.bilstm(p, "enc_word.", q_emb, q["q_mask"], fb)
    a_emb = plain.dropout(vt[q["choice_words"].long()], kp, gen)
    _, a_sum = plain.bilstm_rows(p, "enc_word.", a_emb, q["choice_mask"], fb)
    c = plain.trilinear(h_ctx, h_q, p["sim_w_x"], p["sim_w_y"], p["sim_w_xy"])
    ctx, qv = plain.fvta_attention(h_ctx, ctx_mask, h_q, q["q_mask"], c)
    return plain.scores(p, ctx, qv, a_sum)


def train_loss(p, shared, batch, d, m, gen):
    """The train step's loss: the forward with dropout (tables recomputed from
    the parameters), masked 4-way cross-entropy."""
    vt = plain.vocab_table(p, shared["word_emb"], shared["vocab_chars"], d, m)
    idx = batch["album_idx"].long()
    feats = shared["photo_feats"][shared["album_photo_idx"][idx].long()]      # [N, A, P, F]
    photo_in = plain.dense(p, "photo_proj", feats)
    h_ctx, ctx_mask = encode_context(p, shared, batch["album_idx"], batch["album_mask"],
                                     photo_in, vt, d, m, gen)
    logits = answer(p, batch, h_ctx, ctx_mask, vt, m, gen)
    return plain.choice_metrics(logits, batch["label"], batch["ex_mask"])[0]


@torch.no_grad()
def album_cache(p, shared, d, m, block: int = 128):
    """(vocab table, cache_h [R, 6, T, 2H], cache_m [R, 6, T]) of every album
    row (row 0, the pad album, all masked), without dropout."""
    vt = plain.vocab_table(p, shared["word_emb"], shared["vocab_chars"], d, m)
    pt = plain.dense(p, "photo_proj", shared["photo_feats"])[shared["album_photo_idx"].long()]
    rows = shared["album_photo_idx"].shape[0]
    hs, ms = [], []
    for start in range(0, rows, block):
        ids = torch.arange(start, min(start + block, rows), device=vt.device)[:, None]
        h, mk = encode_context(p, shared, ids, ids > 0, pt[ids.long()], vt, d, m, None)
        hs.append(h)
        ms.append(mk)
    return vt, torch.cat(hs), torch.cat(ms)


@torch.no_grad()
def cached_logits(p, split, vt, cache_h, cache_m, m, batch: int):
    """Logits [Q, 4] of every question of the split through the album cache."""
    out = []
    for start in range(0, split["label"].shape[0], batch):
        q = {k: v[start:start + batch] for k, v in split.items()}
        n, a = q["album_idx"].shape
        idx = q["album_idx"].long()
        h = cache_h[idx]
        mk = cache_m[idx] & q["album_mask"][:, :, None, None]
        out.append(answer(p, q, h.reshape(n, a * 6, *h.shape[3:]),
                          mk.reshape(n, a * 6, mk.shape[-1]), vt, m, None))
    return torch.cat(out)
