"""Serving: album ingestion into a device cache + concurrent question answering.

- AlbumStore.ingest(): tokenize + pack ONE album on the host (ids only), run the
  album encoder (FVTAModel.encode_context) on the device and cache its
  [6, T, 2H] context states there. Pack albums (attach_pack / ingest_pack) are
  encoded in batches straight from the device-resident shared tables, or lazily
  on first use. Albums are encoded once, however many questions hit them.
- QAEngine.ask(): thread-safe; a worker thread collects requests into
  micro-batches (a few ms, or until the batch is full) and answers each batch
  in one query-side call (FVTAModel.answer) over the cached album states.

On the card every bi-LSTM runs kernel K1 and the attention kernel K2; on the
CPU the same code runs their plain versions. The cache holds float32.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from fvta_memexqa_torch.checkpoint import CheckpointManager
from fvta_memexqa_torch.config import MODALITIES, NUM_CHOICES, Config, load_config
from fvta_memexqa_torch.convert import load_rundir
from fvta_memexqa_torch.data.device_prepro import (ModelInputs, SharedTables,
                                                   as_tensor, assemble_albums)
from fvta_memexqa_torch.data.pack import (ALBUM_TEXT_FIELDS, PackedDataset, _album_text,
                                          _encode_text, load_pack)
from fvta_memexqa_torch.data.schema import Album
from fvta_memexqa_torch.data.tokenize import tokenize
from fvta_memexqa_torch.data.vocab import Vocab
from fvta_memexqa_torch.models.fvta import (FVTAModel, a1_config, make_photo_table,
                                            make_vocab_table)


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


def _single_album_inputs(cfg: Config, vocab: Vocab, album: Album,
                         photo_feats: dict[str, np.ndarray], device) -> ModelInputs:
    """Host-side pack of ONE album into an N=1, A=1 ModelInputs (query fields
    zeroed), with pack.py's compaction: photos with features first (titles
    travel with them), then titled slots to the front of the title time axis."""
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
    return ModelInputs(**_tensors(
        device,
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
        label=z(1, np.int32), ex_mask=np.ones(1, bool)))


class AlbumStore:
    """Thread-safe cache: album_id → encoded context states ([6, T, 2H] f32,
    [6, T] bool) on the model's device."""

    def __init__(self, cfg: Config, model: FVTAModel, shared: SharedTables, vocab: Vocab):
        self.cfg = cfg
        self.model = model
        self.shared = shared
        self.vocab = vocab
        self.device = shared.word_emb.device
        self._store: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}
        self._pack_rows: dict[str, int] = {}   # raw album id → shared-table row
        self._photo_table: torch.Tensor | None = None
        self._lock = threading.Lock()
        # parameters are frozen while serving: the vocab embed table is computed
        # once here and reused by every ingest and every query batch
        self.vocab_table = make_vocab_table(model, shared)

    @torch.no_grad()
    def _encode(self, mi: ModelInputs):
        return self.model.encode_context(self.shared, mi, self.vocab_table)

    def _put(self, album_id: str, h: torch.Tensor, m: torch.Tensor) -> None:
        with self._lock:
            self._store[album_id] = (h, m)

    def ingest(self, album: Album, photo_feats: dict[str, np.ndarray]) -> None:
        mi = _single_album_inputs(self.cfg, self.vocab, album, photo_feats, self.device)
        h, m = self._encode(mi)
        self._put(album.album_id, h[0], m[0])

    # ---- pack-resident albums ------------------------------------------------

    def attach_pack(self, packed: PackedDataset) -> int:
        """Register a pack's albums as addressable by raw album id; returns how
        many (0 for packs from before meta["album_ids"])."""
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
        per encode_context call. Returns the number encoded."""
        with self._lock:
            missing = [a for a in self._pack_rows if a not in self._store]
        for start in range(0, len(missing), batch_size):
            chunk = missing[start : start + batch_size]
            h, m = self._encode_pack_rows([self._pack_rows[a] for a in chunk])
            for i, a in enumerate(chunk):
                self._put(a, h[i], m[i])
        return len(missing)

    def get_stacked(self, album_ids: list[str]):
        """Cached states for album_ids, padded to max_albums:
        (h [S, T, 2H], m [S, T], number found). A pack album not yet cached is
        encoded from its row on first use; unknown ids are skipped."""
        d = self.cfg.data
        n_mod = len(MODALITIES)
        entries = []
        for a in album_ids[: d.max_albums]:
            with self._lock:
                entry = self._store.get(a)
            if entry is None and a in self._pack_rows:
                h, m = self._encode_pack_rows([self._pack_rows[a]])
                entry = (h[0], m[0])
                self._put(a, *entry)
            if entry is not None:
                entries.append(entry)
        t, h2 = d.max_context_time, 2 * self.cfg.model.hidden_dim
        h = torch.zeros((d.max_albums * n_mod, t, h2), device=self.device)
        m = torch.zeros((d.max_albums * n_mod, t), dtype=torch.bool, device=self.device)
        for i, (eh, em) in enumerate(entries):
            h[i * n_mod : (i + 1) * n_mod] = eh
            m[i * n_mod : (i + 1) * n_mod] = em
        return h, m, len(entries)

    @property
    def num_albums(self) -> int:
        with self._lock:
            return len(self._store)


@dataclass
class _Pending:
    question: str
    choices: list[str]
    album_ids: list[str]
    event: threading.Event = field(default_factory=threading.Event)
    result: dict | None = None


class QAEngine:
    """Micro-batching concurrent QA over an AlbumStore."""

    def __init__(self, store: AlbumStore, batch_size: int = 8,
                 batch_window_ms: float = 3.0):
        self.store = store
        self.cfg = store.cfg
        self.batch_size = batch_size
        self.batch_window = batch_window_ms / 1e3
        self.stats = {"questions": 0, "batches": 0}
        self._latencies: list[float] = []  # rolling, most recent 1000
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def warmup(self) -> float:
        """Run the answer step once on a dummy request before taking traffic
        (builds the kernels on the card). Returns the seconds it took."""
        t0 = time.perf_counter()
        self.answer_batch([("warmup ?", ["a", "b", "c", "d"], [])])
        self.stats["questions"] -= 1  # don't count the dummy
        self.stats["batches"] -= 1
        return time.perf_counter() - t0

    def ask(self, question: str, choices: list[str], album_ids: list[str],
            timeout: float = 30.0) -> dict:
        if len(choices) != NUM_CHOICES:
            raise ValueError(f"need exactly {NUM_CHOICES} choices")
        p = _Pending(question, list(choices), list(album_ids))
        t0 = time.perf_counter()
        self._queue.put(p)
        if not p.event.wait(timeout):
            raise TimeoutError("inference timed out")
        self._latencies.append(time.perf_counter() - t0)
        if len(self._latencies) > 1000:
            del self._latencies[:-1000]
        if "error" in p.result:
            raise RuntimeError(p.result["error"])
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
        return {"p50_ms": s[len(s) // 2] * 1e3, "p95_ms": s[int(len(s) * 0.95)] * 1e3}

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
            except Exception as e:  # noqa: BLE001 - the asker re-raises it
                for p in batch:
                    p.result = {"error": repr(e)}
                    p.event.set()

    def _query_inputs(self, pending: list[_Pending]) -> ModelInputs:
        """Question/choice ids of a micro-batch; the album-side fields (unread by
        FVTAModel.answer) are minimal zeros."""
        d = self.cfg.data
        n = len(pending)
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
            self.store.device,
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

    @torch.no_grad()
    def _run_batch(self, pending: list[_Pending]):
        mi = self._query_inputs(pending)
        stacked = [self.store.get_stacked(p.album_ids) for p in pending]
        h_ctx = torch.stack([s[0] for s in stacked])
        ctx_mask = torch.stack([s[1] for s in stacked])
        out = self.store.model.answer(self.store.shared, mi, h_ctx, ctx_mask,
                                      self.store.vocab_table)
        logits = out.logits.cpu().numpy()
        seq_attn = out.attention.seq_attn.cpu().numpy()
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs = probs / probs.sum(-1, keepdims=True)
        for i, p in enumerate(pending):
            best = int(np.argmax(logits[i]))
            p.result = {
                "answer": p.choices[best],
                "answer_index": best,
                "probs": [float(x) for x in probs[i]],
                "albums_found": stacked[i][2],
                "seq_attention": [float(x) for x in seq_attn[i]],
            }
            p.event.set()
        self.stats["questions"] += len(pending)
        self.stats["batches"] += 1


def build_engine(packdir: str, rundir: str, device: str | torch.device = "cuda",
                 load_best: bool = True, batch_size: int = 8, preingest: bool = True):
    """Load pack + port run directory onto `device`, pre-ingest the pack's albums
    (preingest=False: they encode lazily on first use), warm up, and return
    (engine, store, packed). load_best=True serves the run's params.pt (the
    best-on-val weights `train` writes); False its latest checkpoint."""
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
    store = AlbumStore(cfg, model, shared, vocab_view(packed.meta))
    if store.attach_pack(packed) and preingest:
        store.ingest_pack()
    engine = QAEngine(store, batch_size=batch_size)
    engine.warmup()
    return engine, store, packed
