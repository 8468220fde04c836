"""Album-cache gather (the JAX package's eval_cache.gather_cached_context).

The single definition of how per-question context rows are read from states
encoded once per album: the dedup train step uses it now; the cached-evaluation
path will share it.
"""

from __future__ import annotations

import torch


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
