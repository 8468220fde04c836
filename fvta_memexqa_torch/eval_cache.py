"""Cached-album evaluation (the JAX package's eval_cache.py).

MemexQA has far fewer albums than questions, and a plain evaluation re-encodes
every album for every question that references it. `precompute_album_cache`
runs the album encoder (FVTAModel.encode_context at a1_config's one album per
row, as serve.AlbumStore does) once per album row and keeps the
[R, 6, T, 2H] states on the device; `predict_cached` and `evaluate_cached`
then answer every question from the cache through `gather_cached_context` —
the same logits, with per-question work reduced to the question and choice
encodes, the attention and the scorer. On the card the encodes run K1 and the
attention K2, as everywhere in the model.

`gather_cached_context` is the single definition of how per-question context
rows are read from the cache; the dedup train step uses it too.

Under data parallelism (a mesh.Rank) each data rank answers its rows of every
batch and the results are gathered in rank order. The row-sharded cache
(`shard_album_cache`, `_sharded_cache_setup`): each data rank keeps R/dp rows
of the cache; per batch every rank gathers the rows it owns for the whole
batch's album ids (zeros elsewhere), and each rank receives only its batch
rows of those from every rank, summed in rank order — bitwise the replicated
gather, since every row has exactly one owner and x + 0 = x. Only the
per-batch gathered states move, each row once to the rank that needs it,
never the cache.
"""

from __future__ import annotations

import numpy as np
import torch

from fvta_memexqa_torch.config import Config
from fvta_memexqa_torch.data.device_prepro import SharedTables, assemble_albums
from fvta_memexqa_torch.models.fvta import FVTAModel, a1_config
from fvta_memexqa_torch.parallel import mesh
from fvta_memexqa_torch.utils.metrics import span


def gather_cached_context(cache_h: torch.Tensor, cache_m: torch.Tensor,
                          album_idx: torch.Tensor, album_mask: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-question context states from the album cache: [R, 6, T, 2H] / [R, 6, T]
    + ids [N, A] → (h_ctx [N, A*6, T, 2H], ctx_mask [N, A*6, T])."""
    n, a = album_idx.shape
    idx = album_idx.long()
    h = cache_h[idx]                                   # [N, A, 6, T, 2H]
    m = cache_m[idx] & album_mask[:, :, None, None]
    n_mod, t = h.shape[2], h.shape[3]
    return h.reshape(n, a * n_mod, t, -1), m.reshape(n, a * n_mod, t)


@torch.no_grad()
def precompute_album_cache(cfg: Config, model: FVTAModel, shared: SharedTables,
                           batch_size: int = 64, vocab_table=None, photo_table=None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode every album row once → (h [R, 6, T, 2H], mask [R, 6, T]) on the
    device of `shared`. Row 0 is the pad album (all-masked)."""
    d1 = a1_config(cfg).data
    dev = shared.word_emb.device
    num_rows = int(shared.album_photo_idx.shape[0])
    hs, ms = [], []
    for start in range(0, num_rows, batch_size):
        rows = torch.arange(start, min(start + batch_size, num_rows), dtype=torch.int32,
                            device=dev)
        h, m = model.encode_context(shared, assemble_albums(d1, shared, rows, photo_table),
                                    vocab_table)
        hs.append(h)
        ms.append(m)
    return torch.cat(hs), torch.cat(ms)


def shard_album_cache(rank: mesh.Rank, cache):
    """This data rank's rows of an album cache: R rows padded (all-masked) to a
    multiple of the data-parallel degree dp, then rows [data * R/dp, (data + 1)
    * R/dp). Returns (cache_h, cache_m) of R/dp rows."""
    ch, cm = cache
    dp = rank.layout.data_parallel
    r = int(ch.shape[0])
    rows = -(-r // dp)
    pad = rows * dp - r
    if pad:
        ch = torch.cat([ch, ch.new_zeros((pad, *ch.shape[1:]))])
        cm = torch.cat([cm, cm.new_zeros((pad, *cm.shape[1:]))])
    lo = rank.data * rows
    return ch[lo: lo + rows].clone(), cm[lo: lo + rows].clone()


def sharded_cache_bytes_per_device(rank: mesh.Rank, cache) -> list[int]:
    """Per-rank bytes of a shard_album_cache result, for every data rank."""
    ch, cm = cache
    per = ch.numel() * ch.element_size() + cm.numel() * cm.element_size()
    return [int(per)] * rank.layout.data_parallel


def sharded_gather(rank: mesh.Rank, cache_h, cache_m, album_idx, album_mask):
    """gather_cached_context of this rank's batch rows over a row-sharded
    cache: every rank gathers the rows it owns for the whole batch (zeros
    elsewhere), and each rank receives only its batch rows from every rank,
    summed in rank order (mesh.sum_scatter)."""
    group = rank.data_group()
    rows = cache_h.shape[0]
    idx = torch.cat(mesh.all_gather(album_idx, group)).long()           # [N, A]
    amask = torch.cat(mesh.all_gather(album_mask, group))
    local = idx - rank.data * rows
    hit = (local >= 0) & (local < rows)
    lidx = local.clamp(0, rows - 1)
    h = torch.where(hit[..., None, None, None], cache_h[lidx], 0.0)      # [N, A, 6, T, 2H]
    m = (cache_m[lidx] & hit[..., None, None]) & amask[:, :, None, None]
    h, m = mesh.sum_scatter(h, group), mesh.sum_scatter(m, group)       # [N/dp, ...]
    n, a, n_mod, t = m.shape
    return h.reshape(n, a * n_mod, t, -1), m.reshape(n, a * n_mod, t)


def _sharded_cache_setup(rank: mesh.Rank | None, cache, batch_size: int):
    """Row-shard the cache for the shard_cache paths: (cache_h, cache_m) of
    this rank's rows. batch_size must split over the data ranks."""
    if rank is None:
        raise ValueError("shard_cache requires a device mesh "
                         "(test --data-parallel N --shard-cache)")
    dp = rank.layout.data_parallel
    if batch_size % dp:
        raise ValueError(f"shard_cache: eval batch size {batch_size} must be "
                         f"divisible by the DP degree {dp}")
    return shard_album_cache(rank, cache)


@torch.no_grad()
def _cached_answers(cfg: Config, model: FVTAModel, shared: SharedTables, cache, tables,
                    rank, sharded):
    """answer(host batch) → (this rank's batch rows on the device, logits): the
    answer step over gathered cache rows (the sharded gather when `sharded`
    holds this rank's rows). Builds the per-checkpoint tables (span
    fvta.eval.tables) and the album cache (span fvta.eval.cache) where they
    are not given."""
    from fvta_memexqa_torch.train import make_eval_tables, rank_batch

    dev = shared.word_emb.device
    if tables is None:
        with span("fvta.eval.tables"):
            tables = make_eval_tables(model, shared)
    vt, pt = tables
    if cache is None and sharded is None:
        with span("fvta.eval.cache"):
            cache = precompute_album_cache(cfg, model, shared, vocab_table=vt, photo_table=pt)

    @torch.no_grad()
    def answer(batch):
        b = rank_batch(batch, rank).to(dev)
        if sharded is not None:
            h_ctx, ctx_mask = sharded_gather(rank, *sharded, b.album_idx, b.album_mask)
        else:
            h_ctx, ctx_mask = gather_cached_context(*cache, b.album_idx, b.album_mask)
        return b, model.answer(shared, b, h_ctx, ctx_mask, vt).logits

    return answer


def predict_cached(cfg: Config, model: FVTAModel, shared: SharedTables, dataset,
                   batch_size: int, cache=None, tables=None, rank=None,
                   sharded=None) -> dict:
    """Per-question choice probabilities through the album cache, in dataset
    order: {"qid" [N], "probs" [N, 4], "pred" [N], "label" [N]} (numpy) — the
    per-question view behind per-category reporting (data/categories.py) and
    checkpoint ensembling (train.test_ensemble). cache=None builds the cache;
    tables=None builds train.make_eval_tables(model, shared). rank: each data
    rank answers its rows and every rank returns the whole split's arrays;
    sharded: this rank's rows of a row-sharded cache (_sharded_cache_setup).
    Spans: fvta.eval around the whole, fvta.eval.answer around each batch."""
    probs, labels = [], []
    with span("fvta.eval"):
        answer = _cached_answers(cfg, model, shared, cache, tables, rank, sharded)
        for batch in dataset.get_batches(batch_size, shuffle=False):
            with span("fvta.eval.answer"):
                b, logits = answer(batch)
                p, keep, label = torch.softmax(logits, -1), b.ex_mask, b.label
                if rank is not None:
                    group = rank.data_group()
                    p, keep, label = (torch.cat(mesh.all_gather(x, group))
                                      for x in (p, keep, label))
                keep = keep.cpu().numpy()
                probs.append(p.cpu().numpy()[keep])
                labels.append(label.cpu().numpy()[keep])
    probs = np.concatenate(probs) if probs else np.zeros((0, 4), np.float32)
    labels = np.concatenate(labels) if labels else np.zeros(0, np.int32)
    return {"qid": np.asarray(dataset.qids), "probs": probs,
            "pred": np.argmax(probs, -1), "label": labels}


def evaluate_cached(cfg: Config, model: FVTAModel, shared: SharedTables, dataset,
                    batch_size: int, cache=None, tables=None, rank=None,
                    sharded=None) -> dict:
    """Full-split evaluation through the album cache: {"acc", "loss", "count"},
    building the per-checkpoint tables and the cache of every album where they
    are not given. Sums stay on the device and are fetched once at the end.
    rank: data-parallel, the sums added over the data ranks in rank order;
    sharded: this rank's rows of a row-sharded cache, and
    "cache_bytes_per_device" reports every rank's share. Spans: fvta.eval
    around the whole, fvta.eval.answer around each batch (its move to the
    device, the gather, the answer and its metric sums)."""
    from fvta_memexqa_torch.train import data_sum, masked_choice_metrics

    totals = None
    with span("fvta.eval"):
        answer = _cached_answers(cfg, model, shared, cache, tables, rank, sharded)
        for batch in dataset.get_batches(batch_size, shuffle=False):
            with span("fvta.eval.answer"):
                b, logits = answer(batch)
                m = masked_choice_metrics(logits, b.label, b.ex_mask)
                m = torch.stack([m["correct"], m["count"], m["loss_sum"]])
                totals = m if totals is None else totals + m
        if totals is not None:
            totals = [float(v) for v in data_sum(totals, rank)]
    correct, count, loss_sum = totals if totals is not None else (0.0, 0.0, 0.0)
    out = {"acc": correct / max(count, 1.0), "loss": loss_sum / max(count, 1.0),
           "count": int(count)}
    if sharded is not None:
        out["cache_bytes_per_device"] = sharded_cache_bytes_per_device(rank, sharded)
    return out
