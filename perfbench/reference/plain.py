"""Building blocks of the plain reference (see the package docstring for where
each was copied from).

- bi-LSTM with TF1 BasicLSTMCell numerics: gates (i, j, f, o), the forget bias
  inside the cell, no update past a row's length, the backward direction as a
  length-aware flip;
- the FVTA attention: trilinear correlation, time- and sequence-level focal
  softmax with exp_mask (-1e30) masking, the question side;
- GloVe + trainable-OOV word table, char-CNN (im2col + one product), highway;
- flax-style dropout drawn from an explicit torch.Generator, element by
  element in the order the model draws;
- optax's clip_by_global_norm and Adam (b1 0.9, b2 0.999, eps 1e-8,
  bias-corrected, float32 scalars).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

VERY_NEGATIVE = -1e30
UNK_ID, NUM_SPECIAL = 1, 2
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 in cuBLAS products and cuDNN convolutions off (the reference) or
    on (the control), restored afterwards."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


# ---- masking and attention -----------------------------------------------------------

def exp_mask(logits, mask):
    return logits + (1.0 - mask.to(logits.dtype)) * VERY_NEGATIVE


def masked_softmax(logits, mask, dim=-1):
    x = exp_mask(logits, mask)
    x = x - torch.amax(x, dim=dim, keepdim=True)
    e = torch.exp(x)
    return e / torch.sum(e, dim=dim, keepdim=True)


def trilinear(h, q, w_x, w_y, w_xy):
    """C [N, S, T, J] = h . w_x + q . w_y + (h * w_xy) . q."""
    sx = torch.einsum("nstd,d->nst", h, w_x)[..., None]
    sy = torch.einsum("njd,d->nj", q, w_y)[:, None, None, :]
    return sx + sy + torch.einsum("nstd,njd->nstj", h * w_xy, q)


def fvta_attention(h, ctx_mask, q, q_mask, c):
    """(context [N, D], question [N, D]) of the hierarchical focal attention."""
    e = torch.amax(exp_mask(c, q_mask[:, None, None, :]), dim=-1)      # [N, S, T]
    a_time = masked_softmax(e, ctx_mask, dim=-1)
    v = torch.einsum("nst,nstd->nsd", a_time, h)
    seq_mask = ctx_mask.any(dim=-1)
    g = torch.amax(exp_mask(e, ctx_mask), dim=-1)
    b_seq = masked_softmax(g, seq_mask, dim=-1)
    ctx = torch.einsum("ns,nsd->nd", b_seq, v)
    eq = torch.amax(exp_mask(c, ctx_mask[..., None]), dim=(1, 2))       # [N, J]
    wq = masked_softmax(eq, q_mask, dim=-1)
    return ctx, torch.einsum("nj,njd->nd", wq, q)


# ---- bi-LSTM ---------------------------------------------------------------------------

def _scan(wx, wh, b, x, mask, forget_bias):
    n, t, _ = x.shape
    x_proj = x @ wx + b
    m = mask.to(x.dtype)[..., None]
    h = x.new_zeros(n, wh.shape[0])
    c = x.new_zeros(n, wh.shape[0])
    outs = []
    for step in range(t):
        gates = x_proj[:, step] + h @ wh
        i, j, f, o = torch.chunk(gates, 4, dim=-1)
        nc = c * torch.sigmoid(f + forget_bias) + torch.sigmoid(i) * torch.tanh(j)
        nh = torch.tanh(nc) * torch.sigmoid(o)
        m_t = m[:, step]
        h = m_t * nh + (1.0 - m_t) * h
        c = m_t * nc + (1.0 - m_t) * c
        outs.append(m_t * nh)
    return torch.stack(outs, dim=1), h


def _flip(x, lengths):
    n, t = x.shape[:2]
    pos = torch.arange(t, device=x.device)[None, :]
    ln = lengths.to(pos.dtype)[:, None]
    src = torch.where(pos < ln, ln - 1 - pos, pos)
    return torch.gather(x, 1, src.reshape(n, t, *([1] * (x.ndim - 2))).expand_as(x))


def bilstm(p: dict, prefix: str, x, mask, forget_bias: float):
    """(outputs [N, T, 2H], final [N, 2H]) of the bi-LSTM whose parameters are
    p[prefix + "fw_wx"] ... p[prefix + "bw_b"]; x [N, T, D], mask [N, T]."""
    lengths = mask.sum(dim=1)
    out_fw, h_fw = _scan(p[prefix + "fw_wx"], p[prefix + "fw_wh"], p[prefix + "fw_b"], x, mask,
                         forget_bias)
    out_bw, h_bw = _scan(p[prefix + "bw_wx"], p[prefix + "bw_wh"], p[prefix + "bw_b"],
                         _flip(x, lengths), mask, forget_bias)
    return torch.cat([out_fw, _flip(out_bw, lengths)], dim=-1), torch.cat([h_fw, h_bw], dim=-1)


def bilstm_rows(p, prefix, x, mask, forget_bias):
    """bilstm over x [..., T, D] with its leading dims flattened and restored."""
    lead = x.shape[:-2]
    out, fin = bilstm(p, prefix, x.reshape(-1, *x.shape[-2:]), mask.reshape(-1, mask.shape[-1]),
                      forget_bias)
    return out.reshape(*lead, *out.shape[1:]), fin.reshape(*lead, fin.shape[-1])


# ---- embeddings ------------------------------------------------------------------------

def vocab_table(p: dict, word_emb, vocab_chars, d, m):
    """[V, D_emb]: GloVe / OOV word row + char-CNN + highway for every vocab row."""
    v = vocab_chars.shape[0]
    ids = torch.arange(v, device=word_emb.device)
    boundary = NUM_SPECIAL + d.num_glove_words
    oov = p["word_embed.oov_emb"]
    ids = torch.where(ids >= d.word_vocab_size, UNK_ID, ids)
    trainable = (ids == UNK_ID) | (ids >= boundary)
    t_id = torch.clamp(torch.where(ids == UNK_ID, 0, ids - boundary + 1), 0, oov.shape[0] - 1)
    w = torch.where(trainable[..., None], oov[t_id], word_emb[torch.clamp(ids, 0, boundary - 1)])
    emb = p["char_cnn.char_emb"][vocab_chars.long()]                       # [V, W, E]
    k = m.char_cnn_width
    n_pos = vocab_chars.shape[1] - k + 1
    wins = torch.cat([emb[:, i:n_pos + i, :] for i in range(k)], dim=-1)
    conv = (wins.reshape(-1, k * m.char_emb_dim) @ p["char_cnn.conv_kernel"]).reshape(
        v, n_pos, -1) + p["char_cnn.conv_bias"]
    x = torch.cat([w, torch.amax(torch.relu(conv), dim=1)], dim=-1)
    for i in range(2):
        hh = torch.relu(F.linear(x, p[f"highway.h{i}.weight"], p[f"highway.h{i}.bias"]))
        g = torch.sigmoid(F.linear(x, p[f"highway.g{i}.weight"], p[f"highway.g{i}.bias"]))
        x = g * hh + (1.0 - g) * x
    return x


def dropout(x, keep_prob: float, generator):
    """flax nn.Dropout(rate=1 - keep_prob); generator None: no dropout."""
    if generator is None or keep_prob >= 1.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def dense(p, prefix, x):
    return F.linear(x, p[prefix + ".weight"], p[prefix + ".bias"])


def scores(p, ctx, qv, a_sum):
    """The scorer over [ctx; q~; a; ctx * a; q~ * a] for each choice → [N, C]."""
    ctx = ctx[:, None, :].expand_as(a_sum)
    qv = qv[:, None, :].expand_as(a_sum)
    feats = torch.cat([ctx, qv, a_sum, ctx * a_sum, qv * a_sum], dim=-1)
    return dense(p, "scorer", feats)[..., 0]


def choice_metrics(logits, label, ex_mask):
    """(loss = mean NLL over the valid rows, correct count, row count)."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, label.long()[:, None])[:, 0]
    w = ex_mask.to(logp.dtype)
    count = w.sum()
    correct = ((torch.argmax(logits, -1) == label.long()).to(logp.dtype) * w).sum()
    return (nll * w).sum() / torch.clamp(count, min=1.0), correct, count


# ---- weights and the optimizer ---------------------------------------------------------

def lstm_spec(prefix: str, d_in: int, h: int) -> list[tuple]:
    """(name, shape, std) of one bi-LSTM's parameters: glorot-uniform's variance
    over the [D + H, 4H] kernel, zero bias."""
    std = math.sqrt(6.0 / (d_in + h + 4 * h)) / math.sqrt(3.0)
    out = []
    for direction in ("fw", "bw"):
        out += [(f"{prefix}{direction}_wx", (d_in, 4 * h), std),
                (f"{prefix}{direction}_wh", (h, 4 * h), std),
                (f"{prefix}{direction}_b", (4 * h,), 0.0)]
    return out


def dense_spec(prefix: str, d_in: int, d_out: int) -> list[tuple]:
    """lecun-normal's variance (1 / fan_in) for [out, in], zero bias."""
    return [(f"{prefix}.weight", (d_out, d_in), 1.0 / math.sqrt(d_in)),
            (f"{prefix}.bias", (d_out,), 0.0)]


def embed_spec(d, m) -> list[tuple]:
    demb = d.word_emb_dim + m.char_cnn_filters
    trainable = max(d.word_vocab_size - (NUM_SPECIAL + d.num_glove_words) + 1, 1)
    k = m.char_cnn_width * m.char_emb_dim
    out = [("word_embed.oov_emb", (trainable, d.word_emb_dim), 0.1),
           ("char_cnn.char_emb", (max(d.char_vocab_size, 4), m.char_emb_dim),
            math.sqrt(1.0 / max(d.char_vocab_size, 4))),
           ("char_cnn.conv_kernel", (k, m.char_cnn_filters), 1.0 / math.sqrt(k)),
           ("char_cnn.conv_bias", (m.char_cnn_filters,), 0.0)]
    for i in range(2):
        out += dense_spec(f"highway.h{i}", demb, demb) + dense_spec(f"highway.g{i}", demb, demb)
    return out


def make_weights(spec: list[tuple], seed: int, device) -> dict[str, torch.Tensor]:
    """Every parameter from one N(0, 1) draw of a torch.Generator on `device`,
    each leaf its slice times its std (0: zeros); float32."""
    total = sum(math.prod(shape) for _, shape, _ in spec)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape, std in spec:
        size = math.prod(shape)
        out[name] = flat[at:at + size].view(shape) * std
        at += size
    return out


def clip_by_global_norm(grads: dict, max_norm: float) -> dict:
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    keep = g_norm < max_norm
    return {n: torch.where(keep, g, (g / g_norm) * max_norm) for n, g in grads.items()}


def adam_step(params: dict, grads: dict, state: dict, lr: float, clip: float) -> dict:
    """One optax clip_by_global_norm + adam + scale(-lr) update of `params`
    (moved in place); returns the clipped gradients."""
    if clip > 0:
        grads = clip_by_global_norm(grads, clip)
    c = state.get("count", 0) + 1
    state["count"] = c
    bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** np.float32(c))
    bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** np.float32(c))
    with torch.no_grad():
        for n, g in grads.items():
            mu = (1 - ADAM_B1) * g + ADAM_B1 * state.setdefault("mu", {}).get(n, 0.0)
            nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * state.setdefault("nu", {}).get(n, 0.0)
            state["mu"][n], state["nu"][n] = mu, nu
            params[n].add_(-lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)))
    return grads
