"""Host-side batching: packed arrays → fixed-shape id batches.

The JAX package's data/pipeline.py: everything was padded once at pack time, so
a batch is a pure slice of the split's arrays plus, for the final partial batch,
pad-by-repeat with ex_mask=False — shapes never change. The shuffle order is a
function of (seed, epoch) alone (numpy's default_rng), the same order the JAX
package draws, so a resumed run continues the same stream. Batches carry only
small integer id tensors (on the CPU; `Batch.to` moves them); the heavy gathers
run on the device (device_prepro.assemble).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from fvta_memexqa_torch.data.device_prepro import _BATCH_KEYS, Batch
from fvta_memexqa_torch.data.pack import PackedDataset
from fvta_memexqa_torch.utils.metrics import span


class Dataset:
    """One split of a PackedDataset, exposing shuffled fixed-shape batches."""

    def __init__(self, packed: PackedDataset, split: str):
        self.arrays = packed.splits[split]
        self.n = int(self.arrays["label"].shape[0])
        self.split = split

    @property
    def qids(self) -> np.ndarray:
        return self.arrays["qid"]

    def num_batches(self, batch_size: int) -> int:
        return -(-self.n // batch_size)

    def get_batches(self, batch_size: int, shuffle: bool = False, seed: int = 0,
                    epoch: int = 0) -> Iterator[Batch]:
        """Yield Batches of CPU tensors. Deterministic given (seed, epoch).
        Each batch's assembly is the span fvta.loader.batch (the epoch's order
        is drawn inside the first one)."""
        order = None
        for b in range(self.num_batches(batch_size)):
            with span("fvta.loader.batch"):
                if order is None:
                    order = np.arange(self.n)
                    if shuffle:
                        np.random.default_rng((seed, epoch)).shuffle(order)
                idx = order[b * batch_size:(b + 1) * batch_size]
                ex_mask = np.ones(len(idx), dtype=bool)
                if len(idx) < batch_size:  # pad-by-repeat; masked out of loss/metrics
                    pad = np.full(batch_size - len(idx), idx[0] if len(idx) else 0)
                    ex_mask = np.concatenate([ex_mask, np.zeros(len(pad), dtype=bool)])
                    idx = np.concatenate([idx, pad])
                fields = {k: torch.from_numpy(self.arrays[k][idx]) for k in _BATCH_KEYS}
                batch = Batch(ex_mask=torch.from_numpy(ex_mask), **fields)
            yield batch
