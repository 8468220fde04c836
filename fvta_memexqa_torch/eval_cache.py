"""Cached-album evaluation (the JAX package's eval_cache.py, on one device).

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

The sharded cache (shard_album_cache, _sharded_gather_fn,
sharded_cache_bytes_per_device, _sharded_cache_setup: the cache row-sharded
over a data-parallel mesh) is not ported: train.test and train.test_ensemble
refuse shard_cache and a data-parallel mesh with SHARD_CACHE_NOT_PORTED.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from fvta_memexqa_torch.config import Config
from fvta_memexqa_torch.data.device_prepro import SharedTables, assemble_albums
from fvta_memexqa_torch.models.fvta import FVTAModel, a1_config

SHARD_CACHE_NOT_PORTED = (
    "the sharded album cache (shard_cache, a data-parallel mesh) is not ported yet: it "
    "belongs to the data-parallel slice")


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


@torch.no_grad()
def _cached_logits(model: FVTAModel, shared: SharedTables, cache_h, cache_m, batch,
                   vocab_table) -> torch.Tensor:
    """The answer step over gathered cache rows; reads only the batch's query
    fields and album ids."""
    h_ctx, ctx_mask = gather_cached_context(cache_h, cache_m, batch.album_idx,
                                            batch.album_mask)
    return model.answer(shared, batch, h_ctx, ctx_mask, vocab_table).logits


def predict_cached(cfg: Config, model: FVTAModel, shared: SharedTables, dataset,
                   batch_size: int, cache=None, tables=None) -> dict:
    """Per-question choice probabilities through the album cache, in dataset
    order: {"qid" [N], "probs" [N, 4], "pred" [N], "label" [N]} (numpy) — the
    per-question view behind per-category reporting (data/categories.py) and
    checkpoint ensembling (train.test_ensemble). cache=None builds the cache;
    tables=None builds train.make_eval_tables(model, shared)."""
    from fvta_memexqa_torch.train import make_eval_tables

    vt, pt = tables if tables is not None else make_eval_tables(model, shared)
    if cache is None:
        cache = precompute_album_cache(cfg, model, shared, vocab_table=vt, photo_table=pt)
    cache_h, cache_m = cache
    dev = shared.word_emb.device
    probs, labels = [], []
    for batch in dataset.get_batches(batch_size, shuffle=False):
        logits = _cached_logits(model, shared, cache_h, cache_m, batch.to(dev), vt)
        keep = batch.ex_mask.numpy()
        probs.append(torch.softmax(logits, -1).cpu().numpy()[keep])
        labels.append(batch.label.numpy()[keep])
    probs = np.concatenate(probs) if probs else np.zeros((0, 4), np.float32)
    labels = np.concatenate(labels) if labels else np.zeros(0, np.int32)
    return {"qid": np.asarray(dataset.qids), "probs": probs,
            "pred": np.argmax(probs, -1), "label": labels}


def evaluate_cached(cfg: Config, model: FVTAModel, shared: SharedTables, dataset,
                    batch_size: int, cache=None, tables=None) -> dict:
    """Full-split evaluation through the album cache: {"acc", "loss", "count",
    "cache_s"}, cache_s being the seconds to the cache on the device (the
    per-checkpoint tables and the encode of every album, each where it is not
    given). Sums stay on the device and are fetched once at the end."""
    from fvta_memexqa_torch.train import make_eval_tables, masked_choice_metrics

    dev = shared.word_emb.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    vt, pt = tables if tables is not None else make_eval_tables(model, shared)
    if cache is None:
        cache = precompute_album_cache(cfg, model, shared, vocab_table=vt, photo_table=pt)
    cache_h, cache_m = cache
    sync()
    cache_s = time.perf_counter() - t0
    totals = None
    for batch in dataset.get_batches(batch_size, shuffle=False):
        b = batch.to(dev)
        m = masked_choice_metrics(_cached_logits(model, shared, cache_h, cache_m, b, vt),
                                  b.label, b.ex_mask)
        totals = m if totals is None else {k: totals[k] + m[k] for k in totals}
    totals = ({k: float(v) for k, v in totals.items()} if totals is not None
              else {"correct": 0.0, "count": 0.0, "loss_sum": 0.0})
    return {"acc": totals["correct"] / max(totals["count"], 1.0),
            "loss": totals["loss_sum"] / max(totals["count"], 1.0),
            "count": int(totals["count"]), "cache_s": cache_s}
