"""FVTA attention core — plain tensor implementation (the canonical semantics).

Given context states H [N, S, T, D] with mask M [N, S, T] (S = album x modality
sequences, T = padded time) and question states Q [N, J, D] with mask Mq [N, J]:

1. correlation  C[n,s,t,j] = sim(H[n,s,t], Q[n,j])          (dot | bilinear | trilinear)
2. context score  E[n,s,t]  = max_j C over valid j
3. time-level focal softmax:
       A[n,s,:] = masked_softmax_T(E[n,s,:]);  V[n,s] = sum_t A[n,s,t] * H[n,s,t]
4. sequence-level focal softmax:
       G[n,s] = max over valid t of E[n,s,t];  B[n,:] = masked_softmax_S(G[n,:])
       (a sequence is valid iff any t is);     ctx[n] = sum_s B[n,s] * V[n,s]
5. question side:
       Eq[n,j] = max over valid (s,t) of C[n,s,t,j]
       q~[n]   = sum_j masked_softmax_J(Eq)[n,j] * Q[n,j]

Ablations share steps 1-2/5 and replace 3-4: `flat` (one softmax over all (s,t))
and `none` (masked mean-pool). Maxima use `amax`, whose gradient splits evenly
among ties as JAX's does (all-masked rows are exact ties at -1e30).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from fvta_memexqa_torch.ops.masking import VERY_NEGATIVE, exp_mask, masked_softmax


class AttentionOutput(NamedTuple):
    context: torch.Tensor    # [N, D] attended context
    question: torch.Tensor   # [N, D] attended question
    time_attn: torch.Tensor  # [N, S, T] time-level weights (zeros for `none`)
    seq_attn: torch.Tensor   # [N, S] sequence-level weights (zeros for `none`)


def similarity_tensor(h: torch.Tensor, q: torch.Tensor, kind: str,
                      params: dict[str, torch.Tensor]) -> torch.Tensor:
    """Correlation tensor C [N, S, T, J]; trilinear is w^T [x; y; x*y]."""
    if kind == "dot":
        return torch.einsum("nstd,njd->nstj", h, q)
    if kind == "bilinear":
        return torch.einsum("nstd,de,nje->nstj", h, params["w_bilinear"], q)
    if kind == "trilinear":
        sx = torch.einsum("nstd,d->nst", h, params["w_x"])[..., None]        # [N,S,T,1]
        sy = torch.einsum("njd,d->nj", q, params["w_y"])[:, None, None, :]   # [N,1,1,J]
        sxy = torch.einsum("nstd,njd->nstj", h * params["w_xy"], q)
        return sx + sy + sxy
    raise ValueError(f"unknown similarity kind: {kind}")


def _context_scores(c: torch.Tensor, q_mask: torch.Tensor) -> torch.Tensor:
    """E [N, S, T]: max over valid question words of the correlation."""
    return torch.amax(exp_mask(c, q_mask[:, None, None, :]), dim=-1)


def _question_side(c, ctx_mask, q, q_mask) -> torch.Tensor:
    """q~ [N, D]: attend question words by their best correlation with valid context."""
    eq = torch.amax(exp_mask(c, ctx_mask[..., None]), dim=(1, 2))     # [N, J]
    wq = masked_softmax(eq, q_mask, dim=-1)
    return torch.einsum("nj,njd->nd", wq, q)


def fvta_attention(h, ctx_mask, q, q_mask, c) -> AttentionOutput:
    """Hierarchical focal attention (steps 2-5 above). `c` is the correlation tensor."""
    e = _context_scores(c, q_mask)                                   # [N, S, T]
    a_time = masked_softmax(e, ctx_mask, dim=-1)                     # [N, S, T]
    v = torch.einsum("nst,nstd->nsd", a_time, h)                     # [N, S, D]

    seq_mask = ctx_mask.any(dim=-1)                                  # [N, S]
    g = torch.amax(exp_mask(e, ctx_mask), dim=-1)                    # [N, S]
    b_seq = masked_softmax(g, seq_mask, dim=-1)                      # [N, S]
    ctx = torch.einsum("ns,nsd->nd", b_seq, v)

    q_att = _question_side(c, ctx_mask, q, q_mask)
    sm = seq_mask.to(h.dtype)
    return AttentionOutput(ctx, q_att, a_time * sm[..., None], b_seq * sm)


def flat_attention(h, ctx_mask, q, q_mask, c) -> AttentionOutput:
    """Ablation: single soft attention over all (s, t) positions jointly."""
    n, s, t, d = h.shape
    e = _context_scores(c, q_mask).reshape(n, s * t)
    w = masked_softmax(e, ctx_mask.reshape(n, s * t), dim=-1).reshape(n, s, t)
    ctx = torch.einsum("nst,nstd->nd", w, h)
    q_att = _question_side(c, ctx_mask, q, q_mask)
    # flat weights in the time slot; per-seq mass in the seq slot
    return AttentionOutput(ctx, q_att, w, w.sum(dim=-1))


def no_attention(h, ctx_mask, q, q_mask, c) -> AttentionOutput:
    """Ablation: masked mean-pool on both sides (correlation tensor unused)."""
    cm = ctx_mask.to(h.dtype)
    denom = torch.clamp(cm.sum(dim=(1, 2)), min=1.0)[:, None]
    ctx = torch.einsum("nst,nstd->nd", cm, h) / denom
    qm = q_mask.to(q.dtype)
    q_att = torch.einsum("nj,njd->nd", qm, q) / torch.clamp(qm.sum(dim=1), min=1.0)[:, None]
    z_t = torch.zeros(ctx_mask.shape, dtype=h.dtype, device=h.device)
    return AttentionOutput(ctx, q_att, z_t, z_t[..., 0])


def focal_local_stats(h, ctx_mask, q, q_mask, kind: str, params: dict[str, torch.Tensor]):
    """The online-softmax statistics of the focal attention over a time range
    h [N, S, T, D]: m [N, S] max of the time scores E, den [N, S] =
    sum_t exp(E - m), v [N, S, D] = sum_t exp(E - m) h[:, :, t], eq [N, J] max
    over (s, t) of the ctx-masked correlation, and e [N, S, T] the masked time
    scores. focal_finalize turns them into fvta_attention's output."""
    c = similarity_tensor(h, q, kind, params)                        # [N, S, T, J]
    e = torch.amax(exp_mask(c, q_mask[:, None, None, :]), dim=-1)    # [N, S, T]
    e = exp_mask(e, ctx_mask)
    m = torch.amax(e, dim=-1)                                        # [N, S]
    p = torch.exp(e - m[..., None])
    den = torch.sum(p, dim=-1)                                       # [N, S]
    v = torch.einsum("nst,nstd->nsd", p, h)                          # [N, S, D]
    eq = torch.amax(exp_mask(c, ctx_mask[..., None]), dim=(1, 2))   # [N, J]
    return m, den, v, eq, e


def focal_finalize(m, den, v, eq, e, q, q_mask, seq_valid) -> AttentionOutput:
    """focal_local_stats' tuple (seq_valid [N, S] = any valid t) → the
    attention output, equal to fvta_attention's."""
    g = torch.where(seq_valid, m, torch.full_like(m, VERY_NEGATIVE))
    b = torch.softmax(g, dim=-1) * seq_valid
    b = b / torch.clamp(b.sum(-1, keepdim=True), min=1e-30)          # [N, S]
    vbar = v / torch.clamp(den[..., None], min=1e-30)               # [N, S, D]
    ctx = torch.einsum("ns,nsd->nd", b, vbar)

    eqm = eq + (1.0 - q_mask.to(eq.dtype)) * VERY_NEGATIVE
    wq = torch.softmax(eqm, dim=-1)
    q_att = torch.einsum("nj,njd->nd", wq, q)

    time_attn = (torch.exp(e - m[..., None]) / torch.clamp(den[..., None], min=1e-30)
                 * seq_valid[..., None])
    return AttentionOutput(context=ctx, question=q_att, time_attn=time_attn, seq_attn=b)


ATTENTION_VARIANTS: dict[str, Callable[..., AttentionOutput]] = {
    "fvta": fvta_attention,
    "flat": flat_attention,
    "none": no_attention,
}
