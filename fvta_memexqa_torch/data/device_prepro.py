"""Device-side preprocessing: id batches + device-resident shared tables → model inputs.

The shared tables (photo-feature matrix, per-album modality tensors, GloVe
matrix) are uploaded once; per step only a few KB of int32 ids cross to the
device, and the full [N, A, P, F] photo-feature batch plus all text tensors
materialize there by gathers.

A batch crosses to a card through stage_to: its host fields are copied into
one slot of a per-device ring of two pinned host buffers, and from there to
fresh device tensors by copies that do not block the host.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from fvta_memexqa_torch.data.pack import PackedShared
from fvta_memexqa_torch.utils.metrics import span

_BATCH_KEYS = (
    "q_words", "q_chars", "q_mask",
    "choice_words", "choice_chars", "choice_mask",
    "album_idx", "album_mask", "label",
)


STAGE_ALIGN = 512   # bytes: each field's offset in a staging slot is a multiple, so every
                    # dtype view is aligned and each copy starts on a 512-byte boundary
STAGE_SLOTS = 2     # batches a device's ring holds: how far the host runs ahead


def slot_layout(fields: dict[str, torch.Tensor]) -> tuple[list[int], int]:
    """Each field's byte offset in a staging slot, in the dict's order, each a
    multiple of STAGE_ALIGN (so every dtype view of the slot is aligned), and
    the bytes the slot needs."""
    offsets, end = [], 0
    for t in fields.values():
        offsets.append(end)
        end += -(-t.nbytes // STAGE_ALIGN) * STAGE_ALIGN
    return offsets, end


class StagingRing:
    """STAGE_SLOTS reusable host buffers ("slots") that batches pass through on
    their way to a device, used in turn. A slot is overwritten only after the
    event recorded behind its last batch's copies has completed, so the device
    reads a slot that no later batch has touched; a slot grows to the largest
    batch it has held and is never allocated again at that size, and keeps its
    views for the fields' dtypes and shapes until a batch brings others.
    alloc(nbytes) makes a uint8 slot (pinned memory for a card); new_event()
    makes an object with record(), query() and synchronize() (torch.cuda.Event
    on a card). Thread-safe: a prefetch worker and the main thread may share a
    ring."""

    def __init__(self, alloc: Callable[[int], torch.Tensor], new_event: Callable):
        self._alloc, self._new_event = alloc, new_event
        self.slots: list[torch.Tensor | None] = [None] * STAGE_SLOTS
        self.events: list = [None] * STAGE_SLOTS
        self._views: list[tuple] = [((), [])] * STAGE_SLOTS   # (signature, views)
        self._next = 0
        self._lock = threading.Lock()

    def _slot_views(self, i: int, fields: dict[str, torch.Tensor]) -> list[torch.Tensor]:
        """Slot i's views for `fields` (the slot grown if they do not fit)."""
        sig = tuple((t.dtype, t.shape) for t in fields.values())
        if self._views[i][0] != sig:
            offsets, size = slot_layout(fields)
            if self.slots[i] is None or self.slots[i].numel() < size:
                self.slots[i] = self._alloc(size)
            slot = self.slots[i]
            self._views[i] = (sig, [slot[o:o + t.nbytes].view(t.dtype).view(t.shape)
                                    for o, t in zip(offsets, fields.values())])
        return self._views[i][1]

    def stage(self, fields: dict[str, torch.Tensor],
              move: Callable[[torch.Tensor], torch.Tensor]) -> dict[str, torch.Tensor]:
        """{name: move(view)}: each field copied into a view of the next slot
        with its dtype and shape, then handed to `move` (an enqueued copy to the
        device); then the slot's event is recorded behind those copies. Counts
        on stage_to."""
        with self._lock:
            i = self._next
            self._next = (i + 1) % STAGE_SLOTS
            event = self.events[i]
            if event is not None and not event.query():
                _STAGE.waits += 1
                event.synchronize()
            out = {}
            for (name, t), view in zip(fields.items(), self._slot_views(i, fields)):
                view.copy_(t)
                out[name] = move(view)
            if event is None:
                event = self.events[i] = self._new_event()
            event.record()
            _STAGE.batches += 1
            _STAGE.bytes += sum(t.nbytes for t in fields.values())
        return out


_RINGS: dict[torch.device, StagingRing] = {}
_RINGS_LOCK = threading.Lock()


def _pinned(nbytes: int) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


def device_ring(device: torch.device) -> StagingRing:
    """The staging ring of one card (made at its first batch)."""
    with _RINGS_LOCK:
        if device not in _RINGS:
            _RINGS[device] = StagingRing(_pinned, torch.cuda.Event)
        return _RINGS[device]


def staged_keys(fields: dict[str, torch.Tensor], device: torch.device) -> list[str]:
    """The fields stage_to stages: host tensors bound for a card. A field
    already on a device, or any field bound for the CPU, takes a plain .to."""
    if device.type != "cuda":
        return []
    return [k for k, t in fields.items() if t.device.type == "cpu"]


def stage_to(fields: dict[str, torch.Tensor], device) -> dict[str, torch.Tensor]:
    """`fields` on `device`: the values, dtypes and shapes of {k: t.to(device)},
    bit for bit, each a tensor of its own. Host tensors bound for a card go
    through the card's StagingRing: a copy into a pinned slot, then a copy to
    a fresh device tensor enqueued on the current stream without a stream
    synchronisation. The caller may overwrite or free its host tensors once
    this returns. Counters: stage_to.batches (calls through a ring),
    stage_to.bytes (the bytes of the fields they staged) and stage_to.waits
    (calls that found their slot's last copies still in flight, i.e. the host
    STAGE_SLOTS batches ahead of the card)."""
    device = torch.device(device)
    staged = staged_keys(fields, device)
    if not staged:
        return {k: t.to(device) for k, t in fields.items()}
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    with torch.cuda.device(device):
        moved = device_ring(device).stage({k: fields[k] for k in staged},
                                          lambda v: v.to(device, non_blocking=True))
    return {k: moved[k] if k in moved else t.to(device) for k, t in fields.items()}


_STAGE = stage_to   # the counters stay on the function a test may wrap
stage_to.batches = stage_to.bytes = stage_to.waits = 0


def as_tensor(x: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a tensor on `device` (same dtype)."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


@dataclass
class SharedTables:
    """Device-resident dedup tables (mirror of pack.py's PackedShared)."""

    word_emb: torch.Tensor           # f32 [V, D]; frozen rows handled by models/embed.py
    vocab_chars: torch.Tensor        # i32 [V, W] char ids per vocab word
    photo_feats: torch.Tensor        # f32 [num_photos+1, F]
    album_photo_idx: torch.Tensor    # i32 [num_albums+1, P]
    album_photo_mask: torch.Tensor   # bool [num_albums+1, P]
    photo_title_words: torch.Tensor  # i32 [num_albums+1, P, Ts]
    photo_title_chars: torch.Tensor  # i32 [num_albums+1, P, Ts, W]
    photo_title_mask: torch.Tensor   # bool [num_albums+1, P, Ts]
    album_text_words: torch.Tensor   # i32 [num_albums+1, 4, Tt]
    album_text_chars: torch.Tensor   # i32 [num_albums+1, 4, Tt, W]
    album_text_mask: torch.Tensor    # bool [num_albums+1, 4, Tt]

    @classmethod
    def from_packed(cls, shared: PackedShared, device) -> "SharedTables":
        f = {k: as_tensor(v, device) for k, v in shared.__dict__.items()}
        f["word_emb"] = f.pop("word_emb_init")
        return cls(**f)


@dataclass
class Batch:
    """Per-question id record (see pack.py for shapes)."""

    q_words: torch.Tensor       # i32 [N, Jq]
    q_chars: torch.Tensor       # i32 [N, Jq, W]
    q_mask: torch.Tensor        # bool [N, Jq]
    choice_words: torch.Tensor  # i32 [N, 4, Ja]
    choice_chars: torch.Tensor  # i32 [N, 4, Ja, W]
    choice_mask: torch.Tensor   # bool [N, 4, Ja]
    album_idx: torch.Tensor     # i32 [N, A] rows into shared album tables (0 = pad)
    album_mask: torch.Tensor    # bool [N, A]
    label: torch.Tensor         # i32 [N]
    ex_mask: torch.Tensor       # bool [N]

    @classmethod
    def from_split(cls, arrays: dict[str, np.ndarray], idx, device) -> "Batch":
        """Rows `idx` of one packed split (no padding: ex_mask all True)."""
        idx = np.asarray(idx)
        f = {k: as_tensor(arrays[k][idx], device) for k in _BATCH_KEYS}
        return cls(ex_mask=torch.ones(len(idx), dtype=torch.bool, device=device), **f)

    def to(self, device) -> "Batch":
        """The same batch with every field on `device`, through stage_to (the
        span fvta.loader.h2d)."""
        with span("fvta.loader.h2d"):
            return Batch(**stage_to(self.__dict__, device))


@dataclass
class ModelInputs:
    """Fully materialized, fixed-shape model inputs (one QA batch).

    photo_feats carries RAW features [N, A, P, F] by default; with
    photo_projected=True it carries already-projected encoder inputs
    [N, A, P, d_emb] gathered from a per-checkpoint photo table — the model then
    skips its photo_proj layer."""

    q_words: torch.Tensor            # i32 [N, Jq]
    q_chars: torch.Tensor            # i32 [N, Jq, W]
    q_mask: torch.Tensor             # bool [N, Jq]
    choice_words: torch.Tensor       # i32 [N, 4, Ja]
    choice_chars: torch.Tensor       # i32 [N, 4, Ja, W]
    choice_mask: torch.Tensor        # bool [N, 4, Ja]
    photo_feats: torch.Tensor        # f32 [N, A, P, F] (or [N, A, P, d_emb])
    photo_mask: torch.Tensor         # bool [N, A, P]
    photo_title_words: torch.Tensor  # i32 [N, A, P, Ts]
    photo_title_chars: torch.Tensor  # i32 [N, A, P, Ts, W]
    photo_title_mask: torch.Tensor   # bool [N, A, P, Ts]
    album_text_words: torch.Tensor   # i32 [N, A, 4, Tt]
    album_text_chars: torch.Tensor   # i32 [N, A, 4, Tt, W]
    album_text_mask: torch.Tensor    # bool [N, A, 4, Tt]
    album_mask: torch.Tensor         # bool [N, A]
    label: torch.Tensor              # i32 [N]
    ex_mask: torch.Tensor            # bool [N]
    photo_projected: bool = False


def _album_side(shared: SharedTables, a_idx: torch.Tensor, amask: torch.Tensor,
                photo_table: torch.Tensor | None) -> dict:
    """Album-side fields for album rows a_idx [N, A] with album mask [N, A]."""
    a = a_idx.long()
    amask = amask[..., None]                                 # [N, A, 1]
    if photo_table is not None:
        pf = photo_table[a]                                  # [N, A, P, d_emb]
    else:
        pf = shared.photo_feats[shared.album_photo_idx[a].long()]  # [N, A, P, F]
    return dict(
        photo_feats=pf,
        photo_projected=photo_table is not None,
        photo_mask=shared.album_photo_mask[a] & amask,
        photo_title_words=shared.photo_title_words[a],
        photo_title_chars=shared.photo_title_chars[a],
        photo_title_mask=shared.photo_title_mask[a] & amask[..., None],
        album_text_words=shared.album_text_words[a],
        album_text_chars=shared.album_text_chars[a],
        album_text_mask=shared.album_text_mask[a] & amask[..., None],
    )


def assemble(shared: SharedTables, batch: Batch,
             photo_table: torch.Tensor | None = None) -> ModelInputs:
    """Pure gather. photo_table: optional album-major pre-projected photo
    features [num_albums+1, P, d_emb] (models/fvta.make_photo_table)."""
    return ModelInputs(
        q_words=batch.q_words,
        q_chars=batch.q_chars,
        q_mask=batch.q_mask,
        choice_words=batch.choice_words,
        choice_chars=batch.choice_chars,
        choice_mask=batch.choice_mask,
        album_mask=batch.album_mask,
        label=batch.label,
        ex_mask=batch.ex_mask,
        **_album_side(shared, batch.album_idx, batch.album_mask, photo_table),
    )


def assemble_albums(d, shared: SharedTables, album_ids: torch.Tensor,
                    photo_table: torch.Tensor | None = None) -> ModelInputs:
    """Album-only inputs for a 1-album-per-row encode: ids [U] → ModelInputs
    with N=U, A=1. Query-side fields are zeros of the configured shapes
    (d: DataConfig) — encode_context never reads them."""
    a_idx = album_ids[:, None]                               # [U, 1]
    u = album_ids.shape[0]
    dev = album_ids.device
    zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)
    zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=dev)
    return ModelInputs(
        q_words=zi(u, d.max_question_len),
        q_chars=zi(u, d.max_question_len, d.max_word_len),
        q_mask=zb(u, d.max_question_len),
        choice_words=zi(u, 4, d.max_answer_len),
        choice_chars=zi(u, 4, d.max_answer_len, d.max_word_len),
        choice_mask=zb(u, 4, d.max_answer_len),
        album_mask=a_idx > 0,
        label=zi(u),
        ex_mask=album_ids > 0,
        **_album_side(shared, a_idx, a_idx > 0, photo_table),
    )
