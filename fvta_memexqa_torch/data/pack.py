"""Offline packer: raw MemexQA JSON + GloVe + photo features → fixed-shape npz shards.

Everything is padded ONCE to the static maxima in `DataConfig` and stored as
dense arrays. Photo features and per-album text live in a single deduplicated
`shared.npz` table; per-example records carry only integer ids, and the full
gather happens on the device (`device_prepro.py`).

The on-disk format is the JAX package's, array for array, so either package
reads a pack the other wrote:
    out_dir/
      meta.json        # DataConfig (vocab sizes resolved), vocab maps, split sizes
      shared.npz       # word_emb_init, photo_feats, per-album modality tables
      data_train.npz   # per-question id tensors + labels
      data_val.npz
      data_test.npz
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from dataclasses import dataclass

import numpy as np

from fvta_memexqa_torch.config import DataConfig
from fvta_memexqa_torch.data.schema import Album, QAPair, album_where_text
from fvta_memexqa_torch.data.tokenize import (UNK_ID, tokenize, tokenize_many,
                                              word_to_char_ids)
from fvta_memexqa_torch.data.vocab import Vocab

# Album-level text modalities, in table order (axis 1 of album_text_*).
ALBUM_TEXT_FIELDS = ("album_title", "album_desc", "when", "where")


@dataclass
class PackedShared:
    word_emb_init: np.ndarray       # f32 [V, D]
    vocab_chars: np.ndarray         # i32 [V, W] char ids of each vocab word (0-padded)
    photo_feats: np.ndarray         # f32 [num_photos+1, F]; row 0 is the pad photo
    album_photo_idx: np.ndarray     # i32 [num_albums+1, P] rows into photo_feats
    album_photo_mask: np.ndarray    # bool [num_albums+1, P]
    photo_title_words: np.ndarray   # i32 [num_albums+1, P, Ts]
    photo_title_chars: np.ndarray   # i32 [num_albums+1, P, Ts, W]
    photo_title_mask: np.ndarray    # bool [num_albums+1, P, Ts]
    album_text_words: np.ndarray    # i32 [num_albums+1, 4, Tt]
    album_text_chars: np.ndarray    # i32 [num_albums+1, 4, Tt, W]
    album_text_mask: np.ndarray     # bool [num_albums+1, 4, Tt]


@dataclass
class PackedDataset:
    cfg: DataConfig
    shared: PackedShared
    splits: dict[str, dict[str, np.ndarray]]
    meta: dict

    def num_examples(self, split: str) -> int:
        return int(self.splits[split]["label"].shape[0])


def _encode_text(
    text_tokens: list[str], vocab: Vocab, max_len: int, max_word_len: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Token list → (word ids [L], char ids [L, W], mask [L]) padded to max_len.

    Canonical UNK semantics: a token that maps to UNK_ID gets PAD chars, so the
    per-token path stays bit-compatible with the vocab-table path
    (vocab_chars[UNK_ID] is the zero row)."""
    toks = text_tokens[:max_len]
    words = np.zeros(max_len, dtype=np.int32)
    chars = np.zeros((max_len, max_word_len), dtype=np.int32)
    mask = np.zeros(max_len, dtype=bool)
    for i, t in enumerate(toks):
        words[i] = vocab.word_id(t)
        if words[i] != UNK_ID:
            chars[i] = word_to_char_ids(t, vocab.char2idx, max_word_len)
        mask[i] = True
    return words, chars, mask


def _encode_many(texts: list[str], vocab: Vocab, max_len: int, max_word_len: int):
    """→ (words i32 [N, L], chars i32 [N, L, W], mask bool [N, L])."""
    n = len(texts)
    words = np.zeros((n, max_len), dtype=np.int32)
    chars = np.zeros((n, max_len, max_word_len), dtype=np.int32)
    mask = np.zeros((n, max_len), dtype=bool)
    for i, t in enumerate(texts):
        words[i], chars[i], mask[i] = _encode_text(tokenize(t), vocab, max_len,
                                                   max_word_len)
    return words, chars, mask


class BatchEncoder:
    """Encode many raw texts → fixed-shape id tensors (the JAX package's
    BatchEncoder through its Python path; its native scanner is documented
    bit-identical to it, so the outputs are the same)."""

    def __init__(self, vocab: Vocab):
        self.vocab = vocab

    def encode(self, texts: list[str], max_len: int, max_word_len: int):
        """→ (words i32 [N, L], chars i32 [N, L, W], mask bool [N, L])."""
        return _encode_many(texts, self.vocab, max_len, max_word_len)


def _assert_prefix_masks(sh: PackedShared) -> None:
    """Every LSTM time mask must be a contiguous prefix: the fused bi-LSTM
    kernel derives its masking from lengths=sum(mask) and runs the backward
    direction from each row's own last valid step. Pack-time compaction
    guarantees it; this validates the guarantee at the data boundary."""

    def check(m: np.ndarray, name: str) -> None:
        m2 = m.reshape(-1, m.shape[-1])
        lens = m2.sum(axis=-1)
        expect = np.arange(m2.shape[-1])[None, :] < lens[:, None]
        if not np.array_equal(m2, expect):
            raise AssertionError(f"{name}: non-prefix time mask after compaction")

    check(sh.album_photo_mask, "album_photo_mask")
    check(sh.photo_title_mask.any(axis=-1), "photo_title time mask")
    check(sh.photo_title_mask, "photo_title word mask")
    check(sh.album_text_mask, "album_text_mask")


def _album_text(album: Album, field: str) -> str:
    if field == "album_title":
        return album.title
    if field == "album_desc":
        return album.description
    if field == "when":
        return album.when
    if field == "where":
        return album_where_text(album)
    raise ValueError(field)


def split_qas(
    qas: list[QAPair], test_ids: set[str], val_fraction: float, seed: int,
    val_ids: set[str] | None = None,
) -> dict[str, list[QAPair]]:
    """test by official id file; val by explicit id set when given, else carved
    deterministically at random from the remainder."""
    test = [q for q in qas if q.question_id in test_ids]
    rest = [q for q in qas if q.question_id not in test_ids]
    if val_ids is not None:
        val = [q for q in rest if q.question_id in val_ids]
        train = [q for q in rest if q.question_id not in val_ids]
        if len(val) < len(val_ids):
            missing = len(val_ids) - len(val)
            print(f"[pack] WARNING: {missing}/{len(val_ids)} --val-ids not "
                  "found among non-test questions (unknown ids, or ids "
                  "claimed by the test split)", file=sys.stderr)
        return {"train": train, "val": val, "test": test}
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(rest))
    n_val = int(round(len(rest) * val_fraction))
    val_idx = set(perm[:n_val].tolist())
    val = [rest[i] for i in sorted(val_idx)]
    train = [rest[i] for i in range(len(rest)) if i not in val_idx]
    return {"train": train, "val": val, "test": test}


def _train_token_stream(train_qas: list[QAPair], albums: dict[str, Album]):
    """Tokens used to build the vocab: all train QA text + referenced album text."""
    seen_albums: set[str] = set()
    for qa in train_qas:
        yield from tokenize(qa.question)
        for c in qa.choices:
            yield from tokenize(c)
        for aid in qa.album_ids:
            if aid in albums and aid not in seen_albums:
                seen_albums.add(aid)
                a = albums[aid]
                for f in ALBUM_TEXT_FIELDS:
                    yield from tokenize(_album_text(a, f))
                for t in a.photo_titles:
                    yield from tokenize(t)


def pack(
    qas: list[QAPair],
    albums: dict[str, Album],
    photo_feats: dict[str, np.ndarray],
    test_ids: set[str],
    glove: dict[str, np.ndarray] | None,
    out_dir: str,
    cfg: DataConfig,
    val_fraction: float = 0.1,
    seed: int = 0,
    val_ids: set[str] | None = None,
) -> dict:
    """Run the full pack; writes npz shards + meta.json to out_dir, returns meta."""
    os.makedirs(out_dir, exist_ok=True)
    splits = split_qas(qas, test_ids, val_fraction, seed, val_ids=val_ids)
    vocab = Vocab.build(
        _train_token_stream(splits["train"], albums), glove, cfg.word_emb_dim, seed=seed
    )

    # ---- shared tables -------------------------------------------------------
    # Keep only albums actually referenced; row 0 of every table is the pad album.
    used_album_ids = sorted({aid for qa in qas for aid in qa.album_ids if aid in albums})
    album_row = {aid: i + 1 for i, aid in enumerate(used_album_ids)}
    n_alb = len(used_album_ids) + 1

    # Per album: the first max_photos photos WITH features, compacted to the
    # front (every LSTM time mask must be a contiguous prefix). Titles travel
    # with their photos, temporal order preserved.
    album_kept: dict[str, list[tuple[str, str]]] = {}
    used_photo_ids: list[str] = []
    photo_row: dict[str, int] = {}
    for aid in used_album_ids:
        a = albums[aid]
        kept = [(pid, title) for pid, title in zip(a.photo_ids, a.photo_titles)
                if pid in photo_feats][: cfg.max_photos]
        album_kept[aid] = kept
        for pid, _ in kept:
            if pid not in photo_row:
                photo_row[pid] = len(used_photo_ids) + 1
                used_photo_ids.append(pid)
    n_ph = len(used_photo_ids) + 1

    # ---- extended eval-time lexicon -------------------------------------------
    # Every OOV word in any packed text gets an EXTENDED id >= vocab.size whose
    # vocab_chars row holds its real chars; models/embed.py maps extended ids to
    # the UNK word embedding, so the char-CNN keeps its OOV signal.
    title_text_of = {aid: [t for _, t in kept] for aid, kept in album_kept.items()}
    lexicon_texts: list[str] = []
    for aid in used_album_ids:
        lexicon_texts.extend(_album_text(albums[aid], f) for f in ALBUM_TEXT_FIELDS)
        lexicon_texts.extend(title_text_of[aid])
    for name in ("train", "val", "test"):
        for qa in splits[name]:
            lexicon_texts.append(qa.question)
            lexicon_texts.extend(qa.choices)

    ext2idx: dict[str, int] = {}
    for toks in tokenize_many(lexicon_texts):
        for t in toks:
            if t not in vocab.word2idx and t not in ext2idx:
                ext2idx[t] = vocab.size + len(ext2idx)

    cfg = DataConfig(
        **{
            **cfg.__dict__,
            "word_vocab_size": vocab.size,
            "char_vocab_size": vocab.char_size,
            "num_glove_words": vocab.num_glove,
            "extended_vocab_size": vocab.size + len(ext2idx),
        }
    )

    vocab_chars = np.zeros((cfg.extended_vocab_size, cfg.max_word_len), dtype=np.int32)
    for w, wid in vocab.word2idx.items():
        vocab_chars[wid] = word_to_char_ids(w, vocab.char2idx, cfg.max_word_len)
    for w, wid in ext2idx.items():
        vocab_chars[wid] = word_to_char_ids(w, vocab.char2idx, cfg.max_word_len)

    feat_dim = cfg.image_feat_dim
    sh = PackedShared(
        word_emb_init=vocab.emb_init,
        vocab_chars=vocab_chars,
        photo_feats=np.zeros((n_ph, feat_dim), dtype=np.float32),
        album_photo_idx=np.zeros((n_alb, cfg.max_photos), dtype=np.int32),
        album_photo_mask=np.zeros((n_alb, cfg.max_photos), dtype=bool),
        photo_title_words=np.zeros((n_alb, cfg.max_photos, cfg.max_sent_len), dtype=np.int32),
        photo_title_chars=np.zeros(
            (n_alb, cfg.max_photos, cfg.max_sent_len, cfg.max_word_len), dtype=np.int32
        ),
        photo_title_mask=np.zeros((n_alb, cfg.max_photos, cfg.max_sent_len), dtype=bool),
        album_text_words=np.zeros((n_alb, 4, cfg.max_album_text_len), dtype=np.int32),
        album_text_chars=np.zeros(
            (n_alb, 4, cfg.max_album_text_len, cfg.max_word_len), dtype=np.int32
        ),
        album_text_mask=np.zeros((n_alb, 4, cfg.max_album_text_len), dtype=bool),
    )
    for pid, row in photo_row.items():
        f = np.asarray(photo_feats[pid], dtype=np.float32).reshape(-1)
        if f.shape[0] != feat_dim:
            raise ValueError(f"photo {pid}: feat dim {f.shape[0]} != {feat_dim}")
        sh.photo_feats[row] = f

    ext_vocab = dataclasses.replace(vocab, word2idx={**vocab.word2idx, **ext2idx})
    title_texts = ["" for _ in range(n_alb * cfg.max_photos)]
    for aid, row in album_row.items():
        for p, (pid, title) in enumerate(album_kept[aid]):
            sh.album_photo_idx[row, p] = photo_row[pid]
            sh.album_photo_mask[row, p] = True
            title_texts[row * cfg.max_photos + p] = title
    w, ch, m = _encode_many(title_texts, ext_vocab, cfg.max_sent_len, cfg.max_word_len)
    sh.photo_title_words[:] = w.reshape(sh.photo_title_words.shape)
    sh.photo_title_chars[:] = ch.reshape(sh.photo_title_chars.shape)
    sh.photo_title_mask[:] = m.reshape(sh.photo_title_mask.shape)

    # Compact titled slots to the front of the photo_title TIME axis (a kept
    # photo with an empty title would otherwise leave a hole in the title time
    # mask). Temporal order of titled photos preserved.
    t_order = np.argsort(~sh.photo_title_mask.any(axis=-1), axis=1, kind="stable")
    sh.photo_title_words = np.take_along_axis(sh.photo_title_words, t_order[:, :, None], 1)
    sh.photo_title_chars = np.take_along_axis(
        sh.photo_title_chars, t_order[:, :, None, None], 1)
    sh.photo_title_mask = np.take_along_axis(sh.photo_title_mask, t_order[:, :, None], 1)

    for fi, fname in enumerate(ALBUM_TEXT_FIELDS):
        field_texts = ["" for _ in range(n_alb)]
        for aid, row in album_row.items():
            field_texts[row] = _album_text(albums[aid], fname)
        w, ch, m = _encode_many(field_texts, ext_vocab, cfg.max_album_text_len,
                                cfg.max_word_len)
        sh.album_text_words[:, fi] = w
        sh.album_text_chars[:, fi] = ch
        sh.album_text_mask[:, fi] = m

    # ---- per-split records ---------------------------------------------------
    split_arrays: dict[str, dict[str, np.ndarray]] = {}
    for name, split_qas_list in splits.items():
        n = len(split_qas_list)
        arr = {
            "album_idx": np.zeros((n, cfg.max_albums), dtype=np.int32),
            "album_mask": np.zeros((n, cfg.max_albums), dtype=bool),
            "label": np.zeros(n, dtype=np.int32),
            "qid": np.asarray([q.question_id for q in split_qas_list], dtype="U64"),
        }
        arr["q_words"], arr["q_chars"], arr["q_mask"] = _encode_many(
            [qa.question for qa in split_qas_list], ext_vocab,
            cfg.max_question_len, cfg.max_word_len)
        cw, cc, cm = _encode_many([c for qa in split_qas_list for c in qa.choices],
                                  ext_vocab, cfg.max_answer_len, cfg.max_word_len)
        arr["choice_words"] = cw.reshape(n, 4, cfg.max_answer_len)
        arr["choice_chars"] = cc.reshape(n, 4, cfg.max_answer_len, cfg.max_word_len)
        arr["choice_mask"] = cm.reshape(n, 4, cfg.max_answer_len)
        for i, qa in enumerate(split_qas_list):
            slot = 0  # compact known albums to the front (prefix album_mask)
            for aid in qa.album_ids:
                if aid in album_row and slot < cfg.max_albums:
                    arr["album_idx"][i, slot] = album_row[aid]
                    arr["album_mask"][i, slot] = True
                    slot += 1
            arr["label"][i] = qa.label
        split_arrays[name] = arr

    _assert_prefix_masks(sh)

    # ---- write ---------------------------------------------------------------
    np.savez_compressed(os.path.join(out_dir, "shared.npz"), **sh.__dict__)
    for name, arr in split_arrays.items():
        np.savez_compressed(os.path.join(out_dir, f"data_{name}.npz"), **arr)
    meta = {
        "data_config": cfg.__dict__,
        "modalities": list(ALBUM_TEXT_FIELDS),
        "word2idx": vocab.word2idx,
        "char2idx": vocab.char2idx,
        "num_albums": n_alb - 1,
        "num_photos": n_ph - 1,
        # raw album id per shared-table row (row i+1 = album_ids[i]; row 0 is
        # the pad album) — serving addresses packed albums by raw id
        "album_ids": used_album_ids,
        "split_sizes": {k: len(v) for k, v in splits.items()},
        "id_layout": ("0=PAD 1=UNK [2,2+G)=glove-frozen [2+G,V)=trainable "
                      "[V,V_ext)=extended-lexicon (UNK word emb + real chars)"),
        "ext_word2idx": ext2idx,
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return meta


def load_pack(out_dir: str, load_splits: bool = True) -> PackedDataset:
    """load_splits=False reads only meta.json and the shared tables."""
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    cfg = DataConfig(**meta["data_config"])
    with np.load(os.path.join(out_dir, "shared.npz")) as z:
        fields = {k: z[k] for k in z.files}
    if "vocab_chars" not in fields:  # packs from before the per-vocab embed table
        vc = np.zeros((cfg.word_vocab_size, cfg.max_word_len), dtype=np.int32)
        for w, wid in meta["word2idx"].items():
            vc[wid] = word_to_char_ids(w, meta["char2idx"], cfg.max_word_len)
        fields["vocab_chars"] = vc
    shared = PackedShared(**fields)
    splits = {}
    if load_splits:
        for name in ("train", "val", "test"):
            path = os.path.join(out_dir, f"data_{name}.npz")
            if os.path.exists(path):
                with np.load(path) as z:
                    splits[name] = {k: z[k] for k in z.files}
    return PackedDataset(cfg=cfg, shared=shared, splits=splits, meta=meta)
