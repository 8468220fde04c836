"""Serving: album ingestion into a device cache + concurrent question answering.

- AlbumStore.ingest(): tokenize + pack ONE album on the host (ids only), run the
  album encoder (FVTAModel.encode_context) on the device and cache its
  [6, T, 2H] context states there. Pack albums (attach_pack / ingest_pack) are
  encoded in batches straight from the device-resident shared tables, or lazily
  on first use. Albums are encoded once, however many questions hit them.
  The cache is an LRU under an optional byte budget (an evicted album re-encodes
  on demand from its retained host inputs or its pack row), stored as float32,
  bfloat16 or int8 (`cache_dtype`), and saved to / restored from disk.
- QAEngine.ask(): thread-safe; a worker thread collects requests into
  micro-batches (a few ms, or until the batch is full) and answers each batch
  in one query-side call (FVTAModel.answer) over the cached album states.
  Beyond `max_pending` queued requests it sheds load (EngineOverloadedError).
- Over a device mesh (`mesh=parallel.mesh.make_mesh(MeshConfig(data_parallel=
  N))`, `cli serve --dp N`), one process and one engine worker: the store
  keeps a copy of the model, the shared tables and the vocabulary table on
  every distinct device of the layout, the padded micro-batch splits into N
  contiguous shards and shard i runs the answer step on the layout's device i
  (every shard launched before any result is read back). No collective is
  needed: inference has no gradient to sum. `shard_cache` puts each album's
  entry on one home device (crc32 of its id modulo N) instead of the first.
- serve_http(): stdlib ThreadingHTTPServer with GET /healthz, GET /stats,
  POST /ask and POST /albums; bearer-token auth, global and per-client rate
  limits (RateLimiter), a periodic cache saver and optional TLS.

CLI: python -m fvta_memexqa_torch.cli serve <packdir> <rundir> [--port 8777]

On the card every bi-LSTM runs kernel K1 and the attention kernel K2; on the
CPU the same code runs their plain versions. Every encode runs under
torch.no_grad() in the thread that calls it (grad mode is per thread): the
engine's worker, the caller of ingest, an HTTP handler or the saver.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import queue
import threading
import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from fvta_memexqa_torch.checkpoint import CheckpointManager, atomic_torch_save
from fvta_memexqa_torch.config import MODALITIES, NUM_CHOICES, Config, MeshConfig, load_config
from fvta_memexqa_torch.convert import load_rundir
from fvta_memexqa_torch.data.device_prepro import (ModelInputs, SharedTables,
                                                   as_tensor, assemble_albums)
from fvta_memexqa_torch.data.pack import (ALBUM_TEXT_FIELDS, PackedDataset, _album_text,
                                          _encode_text, load_pack)
from fvta_memexqa_torch.data.schema import Album, parse_album_info
from fvta_memexqa_torch.data.tokenize import tokenize
from fvta_memexqa_torch.data.vocab import Vocab
from fvta_memexqa_torch.models.fvta import (FVTAModel, a1_config, make_photo_table,
                                            make_vocab_table)
from fvta_memexqa_torch.parallel.mesh import RankLayout, make_mesh

CACHE_DTYPES = ("float32", "bfloat16", "int8")
CACHE_FILE = "album_cache.pt"    # the saved encodings; album_ids.json lists the ids


def vocab_view(meta: dict) -> Vocab:
    """Tokenization-only Vocab from pack metadata, including the packer's
    extended lexicon (words it saw anywhere resolve to their extended rows)."""
    return Vocab(
        word2idx={**meta["word2idx"], **meta.get("ext_word2idx", {})},
        char2idx=meta["char2idx"],
        num_glove=meta["data_config"]["num_glove_words"],
        emb_init=np.zeros((0, 0), np.float32),
    )


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The entry points' device: "cuda" on a machine without a card raises,
    nothing silently runs on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() is "
                           "False; pass device='cpu' to run the plain versions")
    return dev


def _tensors(device, **arrays) -> dict[str, torch.Tensor]:
    return {k: as_tensor(v, device) for k, v in arrays.items()}


def _single_album_arrays(cfg: Config, vocab: Vocab, album: Album,
                         photo_feats: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Host-side pack of ONE album into the numpy fields of an N=1, A=1
    ModelInputs (query fields zeroed), with pack.py's compaction: photos with
    features first (titles travel with them), then titled slots to the front
    of the title time axis. The store retains these on the host."""
    d = cfg.data
    P, Ts, Tt, W = d.max_photos, d.max_sent_len, d.max_album_text_len, d.max_word_len
    feats = np.zeros((1, 1, P, d.image_feat_dim), np.float32)
    pmask = np.zeros((1, 1, P), bool)
    ptw = np.zeros((1, 1, P, Ts), np.int32)
    ptc = np.zeros((1, 1, P, Ts, W), np.int32)
    ptm = np.zeros((1, 1, P, Ts), bool)
    atw = np.zeros((1, 1, 4, Tt), np.int32)
    atc = np.zeros((1, 1, 4, Tt, W), np.int32)
    atm = np.zeros((1, 1, 4, Tt), bool)
    kept = [(pid, title) for pid, title in zip(album.photo_ids, album.photo_titles)
            if pid in photo_feats][:P]
    for p, (pid, title) in enumerate(kept):
        f = np.asarray(photo_feats[pid], np.float32).reshape(-1)
        if f.shape[0] != d.image_feat_dim:
            raise ValueError(f"photo {pid}: feat dim {f.shape[0]} != {d.image_feat_dim}")
        feats[0, 0, p] = f
        pmask[0, 0, p] = True
        ptw[0, 0, p], ptc[0, 0, p], ptm[0, 0, p] = _encode_text(tokenize(title), vocab, Ts, W)
    t_order = np.argsort(~ptm[0, 0].any(axis=-1), kind="stable")
    ptw[0, 0], ptc[0, 0], ptm[0, 0] = ptw[0, 0, t_order], ptc[0, 0, t_order], ptm[0, 0, t_order]
    for fi, fname in enumerate(ALBUM_TEXT_FIELDS):
        atw[0, 0, fi], atc[0, 0, fi], atm[0, 0, fi] = _encode_text(
            tokenize(_album_text(album, fname)), vocab, Tt, W)
    z = np.zeros
    return dict(
        q_words=z((1, d.max_question_len), np.int32),
        q_chars=z((1, d.max_question_len, W), np.int32),
        q_mask=z((1, d.max_question_len), bool),
        choice_words=z((1, NUM_CHOICES, d.max_answer_len), np.int32),
        choice_chars=z((1, NUM_CHOICES, d.max_answer_len, W), np.int32),
        choice_mask=z((1, NUM_CHOICES, d.max_answer_len), bool),
        photo_feats=feats, photo_mask=pmask,
        photo_title_words=ptw, photo_title_chars=ptc, photo_title_mask=ptm,
        album_text_words=atw, album_text_chars=atc, album_text_mask=atm,
        album_mask=np.ones((1, 1), bool),
        label=z(1, np.int32), ex_mask=np.ones(1, bool))


def _quant_h(h, mode: str):
    """f32 h block → its cached representation (AlbumStore's cache_dtype).

    float32 returns h itself, bfloat16 a cast; int8 a {"q": int8, "s": f32
    per-row scale} dict: s = max|h| over the last axis (127 for an all-padding
    row) / 127, q = clamp(round(h / s), -127, 127), rounding half to even. An
    entry that is already a dict (a restored int8 cache) passes through."""
    if isinstance(h, dict):
        return h
    if mode == "int8":
        s = h.abs().amax(dim=-1, keepdim=True).to(torch.float32)
        # a tensor divisor: on the card torch turns a division by a Python
        # scalar into a product with its reciprocal, which rounds differently
        c127 = torch.full_like(s, 127.0)
        s = torch.where(s == 0, c127, s) / c127
        return {"q": torch.round(h / s).clamp(-127, 127).to(torch.int8), "s": s}
    return h.to(torch.bfloat16 if mode == "bfloat16" else torch.float32)


def _dequant_h(e) -> torch.Tensor:
    """Cached representation → f32 (exact for f32/bf16 entries)."""
    if isinstance(e, dict):
        return e["q"].to(torch.float32) * e["s"]
    return e.to(torch.float32)


def _own(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it when t is a view into a larger block (a batch's
    encode output): a cache entry must not keep its whole batch alive."""
    if t.untyped_storage().nbytes() != t.numel() * t.element_size():
        return t.clone()
    return t


def _leaves(h, m) -> list[torch.Tensor]:
    return [*h.values(), m] if isinstance(h, dict) else [h, m]


def _cpu_copy(x):
    if isinstance(x, dict):
        return {k: v.detach().cpu().clone() for k, v in x.items()}
    return x.detach().cpu().clone()


def _to(x, device):
    """A cache entry's h (a tensor, or an int8 {"q", "s"} dict) or m on `device`."""
    if isinstance(x, dict):
        return {k: v.to(device) for k, v in x.items()}
    return x.to(device)


@dataclass(frozen=True)
class Replica:
    """What one device of a serving mesh answers with: the model, the shared
    tables and the vocabulary table (None without vocab_embed) on that device."""

    model: FVTAModel
    shared: SharedTables
    vocab_table: torch.Tensor | None


class AlbumStore:
    """Thread-safe LRU cache: album_id → encoded context states ([6, T, 2H]
    h in `cache_dtype`, [6, T] bool mask) on the model's device.

    max_bytes: the cache's byte budget (None: unbounded); past it the least
    recently used entry is evicted, preferring ones that can be re-encoded
    (retained host inputs or a pack row) over restored ones that cannot.
    max_retained_inputs: bound on the host-side inputs kept for re-encoding
    (outside the byte budget, LRU). cache_dtype: float32, bfloat16 (half the
    bytes) or int8 (per-row max-abs quantization, ~0.26x); the encode and the
    answer stay float32, only the cached copy is rounded.

    mesh: a parallel.mesh.RankLayout to serve over (QAEngine answers shard i
    of each micro-batch on mesh.devices[i]): the model, the shared tables and
    the vocabulary table get one copy per distinct device of the layout (a
    repeated device shares one). Albums encode on the model's device.
    shard_cache (needs a mesh): each entry lives on its home device, slot
    zlib.crc32(album_id) % data_parallel of the layout, and
    `cache_bytes_per_device` reports each slot's bytes; without it entries
    stay on the model's device and are copied to the answering device per
    question."""

    def __init__(self, cfg: Config, model: FVTAModel, shared: SharedTables, vocab: Vocab,
                 max_bytes: int | None = None, mesh=None, max_retained_inputs: int = 4096,
                 shard_cache: bool = False, cache_dtype: str = "float32"):
        if cache_dtype not in CACHE_DTYPES:
            raise ValueError(f"unknown cache_dtype {cache_dtype!r} "
                             "(expected float32 | bfloat16 | int8)")
        if shard_cache and mesh is None:
            raise ValueError("shard_cache requires a device mesh (--dp N)")
        self.cfg = cfg
        self.model = model
        self.shared = shared
        self.vocab = vocab
        self.device = shared.word_emb.device
        self.max_bytes = max_bytes
        self.max_retained_inputs = max_retained_inputs
        self._cache_mode = cache_dtype
        self.evictions = 0
        self.evictions_unrecoverable = 0  # the victim had no way to re-encode
        self.reencodes = 0
        self._bytes = 0
        # dirty <=> _gen != _saved_gen: save() snapshots under the lock and writes
        # outside it, so an album ingested during the write stays dirty
        self._gen = 0
        self._saved_gen = 0
        self._store: OrderedDict[str, tuple] = OrderedDict()
        self._inputs: OrderedDict[str, dict[str, np.ndarray]] = OrderedDict()
        self._pack_rows: dict[str, int] = {}   # raw album id → shared-table row
        self._photo_table: torch.Tensor | None = None
        self._lock = threading.Lock()
        # parameters are frozen while serving: the vocab embed table is computed
        # once here and reused by every ingest and every query batch
        self.vocab_table = make_vocab_table(model, shared)
        self.mesh: RankLayout | None = mesh
        self.shard_cache = shard_cache
        self.replicas = {self.device: Replica(model, shared, self.vocab_table)}
        if mesh is not None:
            for d in map(torch.device, mesh.devices):
                if d not in self.replicas:
                    self.replicas[d] = Replica(
                        copy.deepcopy(model).to(d),
                        dataclasses.replace(shared, **{
                            f.name: getattr(shared, f.name).to(d)
                            for f in dataclasses.fields(shared)}),
                        None if self.vocab_table is None else self.vocab_table.to(d))
        if shard_cache:
            self._cache_devices = [torch.device(d) for d in mesh.devices]
            self._dev_bytes = [0] * len(self._cache_devices)
            self._home: dict[str, int] = {}

    @torch.no_grad()
    def _encode(self, mi: ModelInputs):
        return self.model.encode_context(self.shared, mi, self.vocab_table)

    def _encode_arrays(self, arrays: dict[str, np.ndarray]):
        return self._encode(ModelInputs(**_tensors(self.device, **arrays)))

    @staticmethod
    def _entry_bytes(h, m) -> int:
        return sum(t.numel() * t.element_size() for t in _leaves(h, m))

    def _home_device(self, album_id: str) -> int:
        """The sharded cache's home slot of an album (the JAX package's hash)."""
        return zlib.crc32(album_id.encode()) % len(self._cache_devices)

    def _forget(self, album_id: str) -> None:
        """Drop an entry and its bytes (under the lock)."""
        nb = self._entry_bytes(*self._store.pop(album_id))
        self._bytes -= nb
        if self.shard_cache:
            self._dev_bytes[self._home.pop(album_id)] -= nb

    def _put(self, album_id: str, h, m: torch.Tensor, mark_dirty: bool = True) -> None:
        """mark_dirty=False for values already reflected on disk (restores, pack
        entries and on-demand re-encodes), so budget churn does not make the
        periodic saver rewrite the cache every period. With shard_cache the
        entry is committed to its home device first."""
        h = _quant_h(h, self._cache_mode)
        di = None
        if self.shard_cache:
            di = self._home_device(album_id)
            h, m = _to(h, self._cache_devices[di]), m.to(self._cache_devices[di])
        h = {k: _own(v) for k, v in h.items()} if isinstance(h, dict) else _own(h)
        m = _own(m)
        with self._lock:
            if album_id in self._store:
                self._forget(album_id)
            self._store[album_id] = (h, m)
            nb = self._entry_bytes(h, m)
            self._bytes += nb
            if di is not None:
                self._home[album_id] = di
                self._dev_bytes[di] += nb
            if mark_dirty:
                self._gen += 1
            while (self.max_bytes is not None and self._bytes > self.max_bytes
                   and len(self._store) > 1):
                # the LRU victim that can be re-encoded (even the new entry);
                # an unrecoverable one only when none is left, and counted
                victim = next((k for k in self._store
                               if k in self._inputs or k in self._pack_rows), None)
                if victim is None:
                    victim = next(iter(self._store))
                    self.evictions_unrecoverable += 1
                self._forget(victim)
                self.evictions += 1
                if victim == album_id:
                    break  # the new entry itself was the only recoverable one

    def ingest(self, album: Album, photo_feats: dict[str, np.ndarray]) -> None:
        arrays = _single_album_arrays(self.cfg, self.vocab, album, photo_feats)
        with self._lock:
            self._inputs.pop(album.album_id, None)
            self._inputs[album.album_id] = arrays          # host copy for re-encode
            while len(self._inputs) > self.max_retained_inputs:
                self._inputs.popitem(last=False)
        h, m = self._encode_arrays(arrays)
        self._put(album.album_id, h[0], m[0])

    # ---- pack-resident albums ------------------------------------------------

    def attach_pack(self, packed: PackedDataset) -> int:
        """Register a pack's albums as addressable by raw album id; returns how
        many (0 for packs from before meta["album_ids"]). A pack album never
        needs retained inputs: it re-encodes from its shared-table row."""
        ids = packed.meta.get("album_ids") or []
        if not ids:
            return 0
        self._pack_rows = {aid: i + 1 for i, aid in enumerate(ids)}
        # one contiguous-row gather per album instead of P raw feature rows
        self._photo_table = make_photo_table(self.model, self.shared)
        return len(ids)

    def _encode_pack_rows(self, rows: list[int]):
        """Encode shared-table rows → (h [n, 6, T, 2H], m [n, 6, T])."""
        ids = torch.tensor(rows, dtype=torch.int32, device=self.device)
        return self._encode(assemble_albums(a1_config(self.cfg).data, self.shared, ids,
                                            self._photo_table))

    def ingest_pack(self, batch_size: int = 64) -> int:
        """Encode every attached pack album not yet cached, `batch_size` albums
        per encode_context call. Pack entries never dirty the saved cache (they
        are reproducible from the pack). Returns the number encoded."""
        with self._lock:
            missing = [a for a in self._pack_rows if a not in self._store]
        for start in range(0, len(missing), batch_size):
            chunk = missing[start : start + batch_size]
            h, m = self._encode_pack_rows([self._pack_rows[a] for a in chunk])
            for i, a in enumerate(chunk):
                self._put(a, h[i], m[i], mark_dirty=False)
        return len(missing)

    def get_stacked(self, album_ids: list[str], device: torch.device | None = None):
        """Cached states for album_ids, padded to max_albums: (h [S, T, 2H] f32,
        m [S, T], number found) on `device` (default: the model's), where the
        referenced entries are brought. Touches each hit (LRU recency, of its
        retained inputs too); an evicted album, or a pack album not cached yet,
        is re-encoded outside the lock (counted in `reencodes`) and served with
        the cache_dtype rounding a hit would have. Unknown ids are skipped."""
        device = self.device if device is None else torch.device(device)
        d = self.cfg.data
        n_mod = len(MODALITIES)
        entries = []
        for a in album_ids[: d.max_albums]:
            with self._lock:
                if a in self._store:
                    self._store.move_to_end(a)
                    if a in self._inputs:
                        self._inputs.move_to_end(a)
                    entries.append(self._store[a])
                    continue
                arrays = self._inputs.get(a)
                if arrays is not None:
                    self._inputs.move_to_end(a)
            if arrays is not None:
                h, m = self._encode_arrays(arrays)
            elif a in self._pack_rows:
                h, m = self._encode_pack_rows([self._pack_rows[a]])
            else:
                continue
            self._put(a, h[0], m[0], mark_dirty=False)
            with self._lock:
                self.reencodes += 1
            entries.append((_quant_h(h[0], self._cache_mode), m[0]))
        t, h2 = d.max_context_time, 2 * self.cfg.model.hidden_dim
        h = torch.zeros((d.max_albums * n_mod, t, h2), device=device)
        m = torch.zeros((d.max_albums * n_mod, t), dtype=torch.bool, device=device)
        # entries live on the model's device unless the cache is sharded
        move = self.shard_cache or device != self.device
        for i, (eh, em) in enumerate(entries):
            h[i * n_mod : (i + 1) * n_mod] = _dequant_h(_to(eh, device) if move else eh)
            m[i * n_mod : (i + 1) * n_mod] = em.to(device) if move else em
        return h, m, len(entries)

    # ---- persistence ---------------------------------------------------------

    def save(self, path: str, only_if_dirty: bool = False) -> bool:
        """Write every cached encoding to <path>/album_cache.pt (CPU tensors,
        int8 entries as their {"q", "s"} dicts; a temporary file renamed over
        the target) and the ids to <path>/album_ids.json. Returns whether it
        wrote: only_if_dirty skips the copy and the write when nothing changed
        since the last save or load."""
        with self._lock:
            if only_if_dirty and self._gen == self._saved_gen:
                return False
            snap_gen = self._gen
            ids = list(self._store)
            entries = [self._store[a] for a in ids]
        os.makedirs(path, exist_ok=True)
        atomic_torch_save({"album_ids": ids, "h": [_cpu_copy(h) for h, _ in entries],
                           "m": [_cpu_copy(m) for _, m in entries]},
                          os.path.join(path, CACHE_FILE))
        tmp = os.path.join(path, f"album_ids.json.{os.getpid()}.tmp")
        with open(tmp, "w") as f:
            json.dump(ids, f)
        os.replace(tmp, os.path.join(path, "album_ids.json"))
        with self._lock:
            # only to the generation the snapshot captured: an ingest that raced
            # the write stays dirty for the next save
            self._saved_gen = max(self._saved_gen, snap_gen)
        return True

    def load(self, path: str) -> int:
        """Restore a saved cache onto this store's device (whichever device saved
        it; with shard_cache each entry goes back to its home device); returns
        the number of albums loaded. An int8 cache loaded into a float32 or
        bfloat16 store is dequantized, a float cache loaded into an int8 store
        quantized. Leaves the dirty state as it was."""
        tree = torch.load(os.path.join(path, CACHE_FILE), map_location="cpu",
                          weights_only=True)
        for a, h, m in zip(tree["album_ids"], tree["h"], tree["m"]):
            if isinstance(h, dict):
                h = {k: v.to(self.device) for k, v in h.items()}
                if self._cache_mode != "int8":
                    h = _dequant_h(h)
            else:
                h = h.to(self.device)
            self._put(a, h, m.to(self.device, torch.bool), mark_dirty=False)
        return len(tree["album_ids"])

    @property
    def num_albums(self) -> int:
        with self._lock:
            return len(self._store)

    @property
    def cache_bytes(self) -> int:
        with self._lock:
            return self._bytes

    @property
    def cache_bytes_per_device(self) -> list[int] | None:
        """Per-device footprint of a sharded cache, one entry per slot of the
        mesh (sums to cache_bytes); None when the cache is not sharded."""
        if not self.shard_cache:
            return None
        with self._lock:
            return list(self._dev_bytes)


@dataclass
class _Pending:
    question: str
    choices: list[str]
    album_ids: list[str]
    event: threading.Event = field(default_factory=threading.Event)
    result: dict | None = None


class EngineOverloadedError(TimeoutError):
    """Raised by ask() when max_pending requests are already queued: an
    immediate, retryable failure (HTTP 503) instead of a wait toward a timeout."""


class QAEngine:
    """Micro-batching concurrent QA over an AlbumStore.

    max_pending: bound on queued requests; beyond it ask() sheds load at once
    with EngineOverloadedError (counted in `shed`). None = unbounded. Over the
    store's mesh the micro-batch is padded to batch_size (which must divide by
    the mesh's data axis) and answered shard by shard on its devices."""

    def __init__(self, store: AlbumStore, batch_size: int = 8,
                 batch_window_ms: float = 3.0, max_pending: int | None = None):
        if store.mesh is not None and batch_size % store.mesh.data_parallel:
            raise ValueError(f"serving batch_size {batch_size} must be divisible by the "
                             f"mesh's data axis ({store.mesh.data_parallel})")
        self.store = store
        self.cfg = store.cfg
        self.batch_size = batch_size
        self.batch_window = batch_window_ms / 1e3
        self.max_pending = max_pending
        self.shed = 0
        self.stats = {"questions": 0, "batches": 0}
        self._latencies: list[float] = []  # rolling, most recent 1000
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def warmup(self) -> float:
        """Run the answer step once on a dummy request before taking traffic
        (builds the kernels on the card; over a mesh the padded batch reaches
        every device). Returns the seconds it took."""
        t0 = time.perf_counter()
        self.answer_batch([("warmup ?", ["a", "b", "c", "d"], [])])
        self.stats["questions"] -= 1  # don't count the dummy
        self.stats["batches"] -= 1
        return time.perf_counter() - t0

    def ask(self, question: str, choices: list[str], album_ids: list[str],
            timeout: float = 30.0) -> dict:
        """The answer {"answer", "answer_index", "probs", "albums_found",
        "seq_attention"}, or {"error": ...} when the answer step failed."""
        if len(choices) != NUM_CHOICES:
            raise ValueError(f"need exactly {NUM_CHOICES} choices")
        if self.max_pending is not None and self._queue.qsize() >= self.max_pending:
            self.shed += 1
            raise EngineOverloadedError(
                f"engine overloaded: {self._queue.qsize()} requests pending")
        p = _Pending(question, list(choices), list(album_ids))
        t0 = time.perf_counter()
        self._queue.put(p)
        if not p.event.wait(timeout):
            raise TimeoutError("inference timed out")
        self._latencies.append(time.perf_counter() - t0)
        if len(self._latencies) > 1000:
            del self._latencies[:-1000]
        return p.result

    def answer_batch(self, requests: list[tuple[str, list[str], list[str]]]) -> list[dict]:
        """Answer (question, choices, album_ids) requests in ONE answer step on the
        calling thread, past the queue and its batching window (warm-up, and
        timing the answer step alone). Results are those of `ask`."""
        pending = [_Pending(q, list(c), list(a)) for q, c, a in requests]
        self._run_batch(pending)
        return [p.result for p in pending]

    def latency_stats(self) -> dict:
        if not self._latencies:
            return {"p50_ms": None, "p95_ms": None}
        s = sorted(self._latencies)
        return {"p50_ms": round(s[len(s) // 2] * 1e3, 3),
                "p95_ms": round(s[int(len(s) * 0.95)] * 1e3, 3)}

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5)

    # ---- worker --------------------------------------------------------------

    def _loop(self):
        if self.store.device.type == "cuda":
            torch.cuda.set_device(self.store.device)
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.batch_window
            while len(batch) < self.batch_size:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                self._run_batch(batch)
            except Exception as e:  # noqa: BLE001 - each asker gets it as its result
                for p in batch:
                    p.result = {"error": repr(e)}
                    p.event.set()

    def _query_inputs(self, pending: list[_Pending], n: int, device) -> ModelInputs:
        """Question/choice ids of a micro-batch on `device`, zero rows past the
        requests up to n rows; the album-side fields (unread by
        FVTAModel.answer) are minimal zeros."""
        d = self.cfg.data
        W = d.max_word_len
        v = self.store.vocab
        qw = np.zeros((n, d.max_question_len), np.int32)
        qc = np.zeros((n, d.max_question_len, W), np.int32)
        qm = np.zeros((n, d.max_question_len), bool)
        cw = np.zeros((n, NUM_CHOICES, d.max_answer_len), np.int32)
        cc = np.zeros((n, NUM_CHOICES, d.max_answer_len, W), np.int32)
        cm = np.zeros((n, NUM_CHOICES, d.max_answer_len), bool)
        for i, p in enumerate(pending):
            qw[i], qc[i], qm[i] = _encode_text(tokenize(p.question), v, d.max_question_len, W)
            for ci, ch in enumerate(p.choices):
                cw[i, ci], cc[i, ci], cm[i, ci] = _encode_text(tokenize(ch), v,
                                                               d.max_answer_len, W)
        z = np.zeros
        return ModelInputs(**_tensors(
            device,
            q_words=qw, q_chars=qc, q_mask=qm,
            choice_words=cw, choice_chars=cc, choice_mask=cm,
            photo_feats=z((n, 1, 1, 1), np.float32), photo_mask=z((n, 1, 1), bool),
            photo_title_words=z((n, 1, 1, 1), np.int32),
            photo_title_chars=z((n, 1, 1, 1, 1), np.int32),
            photo_title_mask=z((n, 1, 1, 1), bool),
            album_text_words=z((n, 1, 4, 1), np.int32),
            album_text_chars=z((n, 1, 4, 1, 1), np.int32),
            album_text_mask=z((n, 1, 4, 1), bool),
            album_mask=np.ones((n, 1), bool),
            label=z(n, np.int32), ex_mask=np.ones(n, bool)))

    def _shards(self, pending: list[_Pending]) -> list[tuple[list[_Pending], int, torch.device]]:
        """(requests, rows, device) per answer step: the whole micro-batch on
        the store's device, or over a mesh the batch padded to batch_size (a
        multiple of the data axis past it) in contiguous shards, shard i on the
        layout's device i."""
        mesh = self.store.mesh
        if mesh is None:
            return [(pending, len(pending), self.store.device)]
        dp = mesh.data_parallel
        per = max(self.batch_size, -(-len(pending) // dp) * dp) // dp
        return [(pending[i * per:(i + 1) * per], per, torch.device(mesh.devices[i]))
                for i in range(dp)]

    @torch.no_grad()
    def _answer_shard(self, pending: list[_Pending], n: int, device):
        """Launch one answer step over n rows on `device` (zero rows past the
        requests): (logits, seq_attn) on the device, and the albums found."""
        d = self.cfg.data
        rep = self.store.replicas[device]
        mi = self._query_inputs(pending, n, device)
        stacked = [self.store.get_stacked(p.album_ids, device) for p in pending]
        if n > len(pending):   # a mesh's padding rows
            h = torch.zeros((d.max_albums * len(MODALITIES), d.max_context_time,
                             2 * self.cfg.model.hidden_dim), device=device)
            stacked += [(h, torch.zeros(h.shape[:2], dtype=torch.bool, device=device), 0)] * (
                n - len(pending))
        h_ctx = torch.stack([s[0] for s in stacked])
        ctx_mask = torch.stack([s[1] for s in stacked])
        out = rep.model.answer(rep.shared, mi, h_ctx, ctx_mask, rep.vocab_table)
        return out.logits, out.attention.seq_attn, [s[2] for s in stacked[:len(pending)]]

    @torch.no_grad()
    def _run_batch(self, pending: list[_Pending]):
        # every shard is launched before any result is read back
        shards = [self._answer_shard(*s) for s in self._shards(pending)]
        logits = np.concatenate([lg.cpu().numpy() for lg, _, _ in shards])
        seq_attn = np.concatenate([sa.cpu().numpy() for _, sa, _ in shards])
        found = [k for _, _, f in shards for k in f]
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs = probs / probs.sum(-1, keepdims=True)
        for i, p in enumerate(pending):
            best = int(np.argmax(logits[i]))
            p.result = {
                "answer": p.choices[best],
                "answer_index": best,
                "probs": [float(x) for x in probs[i]],
                "albums_found": found[i],
                "seq_attention": [float(x) for x in seq_attn[i]],
            }
            p.event.set()
        self.stats["questions"] += len(pending)
        self.stats["batches"] += 1


# ---- HTTP surface ------------------------------------------------------------


class RateLimiter:
    """Thread-safe sliding-window (1 s) request limiter, global AND per client.

    The per-client cap (keyed by the verified bearer token, else the remote
    address) keeps one greedy client from using the whole global budget. None
    = unlimited for either cap. A request is admitted only if both caps pass,
    and consumes budget only when admitted; the client map is pruned of idle
    clients past 4096 entries."""

    def __init__(self, max_per_sec: float | None,
                 max_per_client_per_sec: float | None = None):
        self.max_per_sec = max_per_sec
        self.max_per_client = max_per_client_per_sec
        self._times: list[float] = []
        self._client_times: dict[str, list[float]] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _prune(times: list[float], cutoff: float) -> None:
        while times and times[0] < cutoff:
            times.pop(0)

    def allow(self, client: str | None = None) -> bool:
        if self.max_per_sec is None and self.max_per_client is None:
            return True
        now = time.monotonic()
        cutoff = now - 1.0
        with self._lock:
            self._prune(self._times, cutoff)
            ct = None
            if self.max_per_client is not None and client is not None:
                ct = self._client_times.setdefault(client, [])
                self._prune(ct, cutoff)
                if len(ct) >= self.max_per_client:
                    return False
            if self.max_per_sec is not None and len(self._times) >= self.max_per_sec:
                return False
            self._times.append(now)
            if ct is not None:
                ct.append(now)
            if len(self._client_times) > 4096:
                self._client_times = {k: v for k, v in self._client_times.items()
                                      if v and v[-1] >= cutoff}
            return True


def _check_tls(tls_cert: str | None, tls_key: str | None) -> None:
    """Half-given TLS is a startup error, never a fallback to plaintext."""
    if bool(tls_cert) != bool(tls_key):
        raise ValueError("--tls-cert and --tls-key must be given together "
                         f"(got cert={tls_cert!r}, key={tls_key!r})")


def make_http_server(engine: QAEngine, store: AlbumStore,
                     photo_feats: dict[str, np.ndarray], port: int = 8777,
                     auth_token: str | None = None,
                     max_requests_per_sec: float | None = None,
                     max_rps_per_client: float | None = None,
                     cache_dir: str | None = None,
                     cache_save_period_s: float = 60.0,
                     tls_cert: str | None = None, tls_key: str | None = None):
    """The server serve_http runs, bound to 127.0.0.1:<port> (0: a free port,
    read back from `.server_address`), not yet serving. `server_close()` also
    stops its cache saver. Arguments as serve_http's."""
    import hmac
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    _check_tls(tls_cert, tls_key)
    limiter = RateLimiter(max_requests_per_sec, max_rps_per_client)
    auth_tokens = [t for t in auth_token.split(",") if t] if auth_token else []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _gate(self) -> bool:
            """Auth + rate-limit preamble shared by every endpoint."""
            client = self.client_address[0]
            if auth_tokens:
                got = self.headers.get("Authorization", "")
                ok = False
                for t in auth_tokens:  # constant-time compare against each
                    if hmac.compare_digest(got.encode(), f"Bearer {t}".encode()):
                        ok = True
                        client = got  # the verified token is the client's identity
                if not ok:
                    self._json(401, {"error": "unauthorized"})
                    return False
            if not limiter.allow(client):
                self._json(429, {"error": "rate limit exceeded, retry later"})
                return False
            return True

        def do_GET(self):  # noqa: N802 - the stdlib's handler name
            if self.path == "/healthz":
                # liveness: exempt from auth and the limiter
                self._json(200, {"ok": True})
                return
            if not self._gate():
                return
            if self.path == "/stats":
                self._json(200, {"albums": store.num_albums,
                                 "cache_bytes": store.cache_bytes,
                                 "cache_bytes_per_device": store.cache_bytes_per_device,
                                 "evictions": store.evictions,
                                 "evictions_unrecoverable": store.evictions_unrecoverable,
                                 "reencodes": store.reencodes,
                                 "shed": engine.shed,
                                 **engine.stats, **engine.latency_stats()})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):  # noqa: N802 - the stdlib's handler name
            if not self._gate():
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/ask":
                    res = engine.ask(req["question"], req["choices"],
                                     req.get("album_ids", []))
                    self._json(200, res)
                elif self.path == "/albums":
                    albums, errs = parse_album_info([req["album"]])
                    if errs or not albums:
                        self._json(400, {"error": errs or ["no album"]})
                        return
                    album = next(iter(albums.values()))
                    feats = dict(photo_feats)
                    for pid, vec in (req.get("photo_feats") or {}).items():
                        feats[pid] = np.asarray(vec, np.float32)
                    store.ingest(album, feats)
                    self._json(200, {"ingested": album.album_id,
                                     "albums": store.num_albums})
                else:
                    self._json(404, {"error": "unknown path"})
            except TimeoutError as e:
                # overload or a timed-out answer, not a client error: retryable
                self._json(503, {"error": repr(e)})
            except (KeyError, ValueError) as e:
                self._json(400, {"error": repr(e)})

    class Server(ThreadingHTTPServer):
        # the listen backlog: with socketserver's 5 (or 128) a burst of a few
        # hundred concurrent clients overflows it, and each dropped connection
        # waits ~1 s for its retry or times out
        request_queue_size = 1024

        def server_close(self):
            stopped.set()
            super().server_close()

    stopped = threading.Event()
    httpd = Server(("127.0.0.1", port), Handler)
    if tls_cert:
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(tls_cert, tls_key)
        httpd.socket = ctx.wrap_socket(httpd.socket, server_side=True)
    httpd.scheme = "https" if tls_cert else "http"
    if cache_dir:
        def _saver():
            while not stopped.wait(cache_save_period_s):
                try:
                    if store.save(cache_dir, only_if_dirty=True):
                        print(f"album cache persisted ({store.num_albums} albums)",
                              flush=True)
                except Exception as e:  # noqa: BLE001 - a failed save is retried next period
                    print(f"album cache save failed: {e!r}", flush=True)

        threading.Thread(target=_saver, daemon=True).start()
    return httpd


def serve_http(engine: QAEngine, store: AlbumStore,
               photo_feats: dict[str, np.ndarray], port: int = 8777,
               auth_token: str | None = None,
               max_requests_per_sec: float | None = None,
               max_rps_per_client: float | None = None,
               cache_dir: str | None = None,
               cache_save_period_s: float = 60.0,
               tls_cert: str | None = None, tls_key: str | None = None):
    """Serve GET /healthz, GET /stats, POST /ask and POST /albums on
    127.0.0.1:<port> until interrupted.

    auth_token: if set, every request but /healthz must carry
    `Authorization: Bearer <token>` (constant-time compare) or get 401;
    comma-separated values issue one credential per client.
    max_requests_per_sec / max_rps_per_client: global and per-client sliding
    windows → 429 (the client is the verified token, else the remote address).
    cache_dir: save the album cache there whenever it changed, checked every
    cache_save_period_s. tls_cert/tls_key: PEM cert + key → HTTPS (stdlib ssl);
    one without the other is a ValueError. Status codes: 503 on overload or
    timeout, 400 on a bad request, 404 on an unknown path."""
    httpd = make_http_server(engine, store, photo_feats, port, auth_token,
                             max_requests_per_sec, max_rps_per_client, cache_dir,
                             cache_save_period_s, tls_cert, tls_key)
    print(f"serving on {httpd.scheme}://127.0.0.1:{httpd.server_address[1]}  "
          f"(POST /albums, POST /ask, GET /stats)", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


def build_engine(packdir: str, rundir: str, device: str | torch.device = "cuda",
                 load_best: bool = True, batch_size: int = 8,
                 max_cache_bytes: int | None = None, cache_dir: str | None = None,
                 dp: int = 1, max_pending: int | None = None, preingest: bool = True,
                 shard_cache: bool = False, cache_dtype: str = "float32",
                 devices: list | None = None):
    """Load pack + port run directory onto `device`, restore a saved album cache
    from cache_dir (if it holds one), pre-ingest the pack's albums not already
    cached (preingest=False: they encode lazily on first use), warm up, and
    return (engine, store, packed). load_best=True serves the run's params.pt
    (the best-on-val weights `train` writes); False its latest checkpoint.
    max_cache_bytes: the album cache's byte budget; cache_dtype and shard_cache
    as AlbumStore's; max_pending as QAEngine's. dp > 1 serves over the mesh
    make_mesh(MeshConfig(data_parallel=dp), devices, device): by default one
    card per shard (a ValueError when there are fewer cards than dp) or dp CPU
    slots for a CPU `device`; an explicit `devices` list may repeat a card. The
    model loads onto the mesh's first device."""
    mesh = None
    if dp > 1:
        mesh = make_mesh(MeshConfig(data_parallel=dp), devices, device)
        device = mesh.devices[0]
    dev = resolve_device(device)
    packed = load_pack(packdir)
    cfg = load_config(os.path.join(rundir, "config.json")).replace(data=packed.cfg)
    if load_best:
        _, model = load_rundir(rundir, dev, cfg)
    else:   # as train.restore_model(load_best=False)
        model = FVTAModel(cfg)
        model.load_state_dict(CheckpointManager(rundir).load(best=False)["params"])
        model = model.to(dev).eval()
    shared = SharedTables.from_packed(packed.shared, dev)
    store = AlbumStore(cfg, model, shared, vocab_view(packed.meta),
                       max_bytes=max_cache_bytes, mesh=mesh, shard_cache=shard_cache,
                       cache_dtype=cache_dtype)
    if cache_dir and os.path.exists(os.path.join(cache_dir, "album_ids.json")):
        n = store.load(cache_dir)
        print(f"restored {n} cached album encodings from {cache_dir}", flush=True)
    if store.attach_pack(packed) and preingest:
        n = store.ingest_pack()
        if n:
            print(f"pre-ingested {n} pack albums", flush=True)
    engine = QAEngine(store, batch_size=batch_size, max_pending=max_pending)
    w = engine.warmup()
    print(f"answer step warmed up in {w:.1f}s", flush=True)
    return engine, store, packed


def main(argv) -> int:
    """`cli serve`: build the engine, pre-ingest --raw-albums, save the cache,
    then serve over HTTP until interrupted."""
    import argparse

    p = argparse.ArgumentParser(prog="fvta-torch serve")
    p.add_argument("packdir")
    p.add_argument("rundir")
    p.add_argument("--port", type=int, default=8777)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--load-latest", action="store_true")
    p.add_argument("--max-cache-mb", type=int, default=None,
                   help="byte budget for the album-encoding cache (LRU eviction)")
    p.add_argument("--cache-dir", default=None,
                   help="persist/restore the album-encoding cache here")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel devices for the query step: each micro-batch "
                        "splits into dp shards, one per card (dp CPU slots with "
                        "--device cpu); fewer cards than dp is an error")
    p.add_argument("--shard-cache", action="store_true",
                   help="shard the album-encoding cache over the --dp mesh (each "
                        "album on one hash-chosen device; /stats reports "
                        "cache_bytes_per_device); needs --dp > 1")
    p.add_argument("--auth-token", default=None,
                   help="require 'Authorization: Bearer <token>' on every "
                        "request; comma-separated values issue one credential "
                        "per client (enables identity-keyed per-client limits)")
    p.add_argument("--max-rps", type=float, default=None,
                   help="sliding-window request limit per second (429 beyond)")
    p.add_argument("--max-rps-per-client", type=float, default=None,
                   help="per-client request limit (keyed by bearer token, "
                        "else remote address); a greedy client 429s alone")
    p.add_argument("--tls-cert", default=None, help="PEM certificate: serve HTTPS")
    p.add_argument("--tls-key", default=None, help="PEM private key for --tls-cert")
    p.add_argument("--max-pending", type=int, default=None,
                   help="shed load (immediate 503) beyond this many queued asks")
    p.add_argument("--raw-albums", default=None,
                   help="album_info.json to pre-ingest (with --raw-photo-npz)")
    p.add_argument("--raw-photo-npz", default=None)
    p.add_argument("--cache-dtype", default="float32", choices=list(CACHE_DTYPES),
                   help="dtype of CACHED album encodings: bfloat16 halves the "
                        "cache footprint, int8 (per-row max-abs quantization) "
                        "cuts it ~4x; encode and answer math stay f32")
    p.add_argument("--no-preingest", action="store_true",
                   help="skip batch-encoding the pack's own albums at startup "
                        "(they encode lazily per query instead)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    _check_tls(args.tls_cert, args.tls_key)   # before the engine loads

    engine, store, _ = build_engine(
        args.packdir, args.rundir, device=args.device, load_best=not args.load_latest,
        batch_size=args.batch_size,
        max_cache_bytes=args.max_cache_mb * 1 << 20 if args.max_cache_mb else None,
        cache_dir=args.cache_dir, dp=args.dp, max_pending=args.max_pending,
        preingest=not args.no_preingest, shard_cache=args.shard_cache,
        cache_dtype=args.cache_dtype)
    try:
        feats: dict[str, np.ndarray] = {}
        if args.raw_albums and args.raw_photo_npz:
            albums, _ = parse_album_info(args.raw_albums)
            feats = dict(np.load(args.raw_photo_npz))
            for a in albums.values():
                store.ingest(a, feats)
            print(f"pre-ingested {store.num_albums} albums", flush=True)
        if args.cache_dir and store.save(args.cache_dir, only_if_dirty=True):
            print(f"saved album cache to {args.cache_dir}", flush=True)
        serve_http(engine, store, feats, port=args.port, auth_token=args.auth_token,
                   max_requests_per_sec=args.max_rps,
                   max_rps_per_client=args.max_rps_per_client,
                   cache_dir=args.cache_dir, tls_cert=args.tls_cert, tls_key=args.tls_key)
    finally:
        engine.close()
    return 0
