"""Context parallelism: the FVTA focal attention over a time-sharded context
(the JAX package's parallel/cp.py).

The context [N, S, T, D] is split along T over the ranks of a group. Each
rank computes the online-softmax statistics of its time shard — K4
(ops/fvta_stats.fvta_stats_fused) on the card, with K5 + K6 in the backward;
their plain versions on the CPU — and the ranks combine them:

    m_g   = max over ranks of m             (_diff_pmax)
    den_g = sum over ranks of den * exp(m - m_g)
    v_g   = sum over ranks of v   * exp(m - m_g)
    eq_g  = max over ranks of eq            (_diff_pmax)

then ops/fvta_ref.focal_finalize. Every sum runs in rank order.

Gradients. Every rank computes the loss from the same replicated outputs, so
a replicated value's gradient must be counted once. The local statistics are
gathered into a [ranks, ...] stack whose every use is replicated: its
cotangent is the same on every rank, and the gather's backward hands each
rank its own slice (mesh.GatherStack). q and the similarity weights enter
the local statistics through an identity whose backward sums the cotangent
across ranks (mesh.SumBackward); `make_cp_attention` takes the time shard of
a replicated h through mesh.TakeShard, whose backward gathers the shards'
cotangents into the full dh. An encoder upstream then gets the same
parameter gradients on every rank, with no further reduction. time_attn
stays sharded: each rank holds its shard's weights, and the losses of the
models read only the replicated outputs.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from fvta_memexqa_torch.ops.fvta_ref import AttentionOutput, focal_finalize
from fvta_memexqa_torch.ops.fvta_stats import fvta_stats_fused
from fvta_memexqa_torch.parallel.mesh import (GatherStack, SumBackward, TakeShard,
                                              rank_sum, sum_across)


class _StackMax(torch.autograd.Function):
    """Max over the rank axis of a gathered stack [ranks, ...]. The max is also
    a logit downstream, so the gradient goes to the ranks that hold it, split
    evenly on exact ties (jnp.max's subgradient, as the JAX _diff_pmax)."""

    @staticmethod
    def forward(ctx, stack):
        mg = stack.amax(0)
        is_max = (stack == mg).to(stack.dtype)
        ctx.save_for_backward(is_max, is_max.sum(0))   # counts: exact in any order
        return mg

    @staticmethod
    def backward(ctx, g):
        is_max, cnt = ctx.saved_tensors
        return is_max * (g / torch.clamp(cnt, min=1.0))


def _diff_pmax(stack: torch.Tensor) -> torch.Tensor:
    """Differentiable cross-rank max of a GatherStack result."""
    return _StackMax.apply(stack)


def fvta_attention_cp(h_shard: torch.Tensor, cm_shard: torch.Tensor, q: torch.Tensor,
                      qm: torch.Tensor, similarity: str, sim_params: dict,
                      group=None) -> AttentionOutput:
    """FVTA attention with the context's time axis sharded over `group`:
    h_shard [N, S, T/cp, D] and cm_shard [N, S, T/cp] are this rank's time
    slice; q [N, J, D], qm [N, J] and sim_params are replicated. Returns
    context, question and seq_attn replicated and time_attn [N, S, T/cp]
    sharded like h. Equal to ops/fvta_ref.fvta_attention of the full context."""
    q_l = SumBackward.apply(q, group)
    p_l = {k: SumBackward.apply(v, group) for k, v in sim_params.items()}
    m, den, v, eq, e = fvta_stats_fused(h_shard, cm_shard, q_l, qm, similarity, p_l)
    n, s, d = v.shape
    j = eq.shape[1]
    flat = torch.cat([m.reshape(-1), den.reshape(-1), v.reshape(-1), eq.reshape(-1)])
    stack = GatherStack.apply(flat, group)                             # [ranks, ...]
    ms, dens, vs, eqs = torch.split(stack, [n * s, n * s, n * s * d, n * j], dim=1)
    ms, dens = ms.reshape(-1, n, s), dens.reshape(-1, n, s)
    vs, eqs = vs.reshape(-1, n, s, d), eqs.reshape(-1, n, j)

    m_g = _diff_pmax(ms)                                               # [N, S]
    scale = torch.exp(ms - m_g)
    den_g = rank_sum(list(dens * scale))
    v_g = rank_sum(list(vs * scale[..., None]))
    eq_g = _diff_pmax(eqs)                                             # [N, J]
    # validity from the CONTEXT mask (any valid t on any rank), not from m_g:
    # an all-masked question also drives m_g to -1e30, and the reference's
    # seq_mask = ctx_mask.any(-1) still counts such sequences
    seq_valid = sum_across(cm_shard.any(-1).to(torch.float32), group) > 0.5
    return focal_finalize(m_g, den_g, v_g, eq_g, e, q, qm, seq_valid)


def make_cp_attention(similarity: str, group=None):
    """CP attention called like the reference attention on the FULL context:
    fn(h [N, S, T, D], cm [N, S, T], q, qm, sim_params). Each rank takes its
    contiguous time shard (T must divide by the group's size; h through
    mesh.TakeShard) and runs fvta_attention_cp."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)

    def fn(h, cm, q, qm, sim_params):
        if h.shape[2] % world:
            raise ValueError(f"context parallelism over {world} ranks needs T "
                             f"({h.shape[2]}) divisible by {world}")
        h_s = TakeShard.apply(h, 2, group)
        cm_s = cm.chunk(world, 2)[rank].contiguous()
        return fvta_attention_cp(h_s, cm_s, q, qm, similarity, sim_params, group)

    return fn
