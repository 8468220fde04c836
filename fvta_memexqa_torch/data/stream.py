"""Streaming input: memory-bounded sharded split loading + background prefetch
(the JAX package's data/stream.py, for the splits the port streams).

- write_shards(): write a split's arrays as fixed-row-count shard files (npz,
  the JAX package's layout) plus a JSON index;
- StreamingDataset: a pipeline.Dataset-like loader holding at most
  `cache_shards` shards in memory, with a deterministic WINDOWED shuffle —
  shard order and intra-shard order are both drawn from (seed, epoch), the
  same numbers the JAX package draws, so a resumed run re-enters the same
  stream; examples never cross shards;
- Prefetcher: a background thread that prepares (and optionally moves to the
  device) the next batches while the current step runs.

Batches have the fixed shapes of pipeline.Dataset's (pad-by-repeat + ex_mask
for the final partial batch) and carry CPU tensors.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from fvta_memexqa_torch.data.device_prepro import _BATCH_KEYS, Batch


def _index_path(pack_dir: str, base: str) -> str:
    return os.path.join(pack_dir, f"{base}.shards.json")


def _shard_path(pack_dir: str, base: str, i: int) -> str:
    return os.path.join(pack_dir, f"{base}.shard-{i:05d}.npz")


def write_shards(pack_dir: str, base: str, arrays: dict[str, np.ndarray],
                 shard_size: int) -> int:
    """Write `arrays` (equal leading dim) as {base}.shard-NNNNN.npz files of
    `shard_size` rows each (last shard ragged) + a JSON index. Returns the
    number of shards. Overwrites any existing index/shards."""
    if shard_size <= 0:
        raise ValueError(f"shard_size must be positive, got {shard_size}")
    n = int(arrays["label"].shape[0])
    sizes = []
    for i, start in enumerate(range(0, max(n, 1), shard_size)):
        rows = {k: v[start: start + shard_size] for k, v in arrays.items()}
        np.savez_compressed(_shard_path(pack_dir, base, i), **rows)
        sizes.append(int(rows["label"].shape[0]))
    with open(_index_path(pack_dir, base), "w") as f:
        json.dump({"shard_size": shard_size, "sizes": sizes, "total": n}, f)
    return len(sizes)


class StreamingDataset:
    """Loader over sharded split files; at most `cache_shards` decompressed
    shards in memory (LRU). Subclass hooks: FILE_PREFIX names the shard files
    ({prefix}_{split}.shard-NNNNN.npz), KEYS lists the array fields, and
    _make_batch builds the emitted struct from numpy arrays."""

    FILE_PREFIX = "data"
    KEYS: tuple[str, ...] = _BATCH_KEYS

    def _make_batch(self, ex_mask: np.ndarray, fields: dict) -> Batch:
        return Batch(ex_mask=torch.from_numpy(ex_mask),
                     **{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in fields.items()})

    def __init__(self, pack_dir: str, split: str, cache_shards: int = 2):
        base = f"{self.FILE_PREFIX}_{split}"
        with open(_index_path(pack_dir, base)) as f:
            self.index = json.load(f)
        self.pack_dir = pack_dir
        self.split = split
        self._base = base
        self.n = int(self.index["total"])
        self.cache_shards = max(1, cache_shards)
        self._cache: dict[int, dict[str, np.ndarray]] = {}

    def _shard(self, i: int) -> dict[str, np.ndarray]:
        if i in self._cache:
            self._cache[i] = self._cache.pop(i)        # LRU touch
        else:
            if len(self._cache) >= self.cache_shards:
                self._cache.pop(next(iter(self._cache)))  # evict least-recent
            with np.load(_shard_path(self.pack_dir, self._base, i)) as z:
                self._cache[i] = {k: z[k] for k in z.files}
        return self._cache[i]

    @property
    def qids(self) -> np.ndarray:
        """Every example's qid in file order (read past the shard cache)."""
        out = []
        for i in range(len(self.index["sizes"])):
            with np.load(_shard_path(self.pack_dir, self._base, i)) as z:
                out.append(z["qid"])
        return np.concatenate(out)

    def num_batches(self, batch_size: int) -> int:
        return -(-self.n // batch_size)

    def get_batches(self, batch_size: int, shuffle: bool = False, seed: int = 0,
                    epoch: int = 0) -> Iterator:
        """Yield batches of CPU tensors; deterministic given (seed, epoch)."""
        num_shards = len(self.index["sizes"])
        shard_order = np.arange(num_shards)
        if shuffle:
            np.random.default_rng((seed, epoch)).shuffle(shard_order)

        pend: dict[str, list[np.ndarray]] = {k: [] for k in self.KEYS}
        pend_n = 0

        def cat_pending() -> dict[str, np.ndarray]:
            return {k: np.concatenate(v) if len(v) > 1 else v[0] for k, v in pend.items()}

        for si in shard_order:
            shard = self._shard(int(si))
            order = np.arange(len(shard["label"]))
            if shuffle:
                np.random.default_rng((seed, epoch, int(si))).shuffle(order)
            for k in pend:
                pend[k].append(shard[k][order])
            pend_n += len(order)
            while pend_n >= batch_size:
                cat = cat_pending()
                fields = {k: cat[k][:batch_size] for k in self.KEYS}
                for k in pend:
                    pend[k] = [cat[k][batch_size:]] if pend_n > batch_size else []
                pend_n -= batch_size
                yield self._make_batch(np.ones(batch_size, dtype=bool), fields)

        if pend_n:  # final partial batch: pad-by-repeat
            cat = cat_pending()
            ex_mask = np.zeros(batch_size, dtype=bool)
            ex_mask[:pend_n] = True
            fields = {k: np.concatenate([cat[k], np.repeat(cat[k][:1], batch_size - pend_n,
                                                           axis=0)])
                      for k in self.KEYS}
            yield self._make_batch(ex_mask, fields)


class Prefetcher:
    """Background-thread prefetch over any batch iterator: a bounded queue
    (depth) caps host memory; `transfer` (e.g. a move to the device) runs in
    the worker; the worker's exception is re-raised in the consumer. Call
    close() (or leave the `with` block) if iteration may stop early."""

    _DONE = object()

    def __init__(self, it: Iterator, depth: int = 2, transfer=None):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._err: BaseException | None = None
        self._stop = threading.Event()
        self._done = False

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def work():
            try:
                for item in it:
                    if self._stop.is_set() or not put(transfer(item) if transfer else item):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
                self._err = e
            finally:
                put(self._DONE)   # lands unless close() stopped us

        self._t = threading.Thread(target=work, daemon=True)
        self._t.start()

    def close(self):
        """Stop the worker and drop queued batches. Idempotent."""
        self._stop.set()
        while True:  # drain so a blocked put wakes and the worker exits
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._t.join(timeout=5)
        self._done = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is self._DONE:
            self._done = True
            self._t.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
