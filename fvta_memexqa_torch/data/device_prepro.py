"""Device-side preprocessing: id batches + device-resident shared tables → model inputs.

The shared tables (photo-feature matrix, per-album modality tensors, GloVe
matrix) are uploaded once; per step only a few KB of int32 ids cross to the
device, and the full [N, A, P, F] photo-feature batch plus all text tensors
materialize there by gathers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fvta_memexqa_torch.data.pack import PackedShared

_BATCH_KEYS = (
    "q_words", "q_chars", "q_mask",
    "choice_words", "choice_chars", "choice_mask",
    "album_idx", "album_mask", "label",
)


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
        """The same batch with every field on `device`."""
        return Batch(**{k: v.to(device) for k, v in self.__dict__.items()})


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
