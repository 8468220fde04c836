"""Seeded inputs at a configuration's shapes.

`synth_shared` and `synth_batch` are frozen copies of
fvta_memexqa_torch/bench_lib.py's generators of the same names (MemexQA v1.1
scale: the photo table, the per-album modality tables, question batches),
returning numpy arrays: the same draws in the same order, so every array equals
bench_lib's at a seed. `split_order` is the shuffle of fvta_memexqa_torch/data/pipeline.py
Dataset.get_batches, so the reference sees the rows the program's loader
delivers.

Every function takes `d`, the configuration's "data" section as attributes.
"""

from __future__ import annotations

import numpy as np


def seed_for(seed: int, stream: int) -> int:
    """An independent 63-bit seed for one stream of a run (weights, data,
    dropout, ...) from the run's --seed, which may exceed 32 bits."""
    return int(np.random.SeedSequence([int(seed) % (1 << 63), stream]).generate_state(
        2, np.uint64)[0] >> np.uint64(1))


def synth_shared(d, num_albums: int, num_photos: int, seed: int) -> dict[str, np.ndarray]:
    """Random shared tables (photo rows, L2-normalised features, then the
    tables), as bench_lib.synth_shared draws them; row 0 is the pad album."""
    rng = np.random.default_rng(seed)
    n_alb, n_ph = num_albums + 1, num_photos + 1

    def words(shape):
        return rng.integers(2, d.word_vocab_size, shape).astype(np.int32)

    def chars(shape):
        return rng.integers(2, d.char_vocab_size, shape).astype(np.int32)

    photo_idx = rng.integers(1, n_ph, (n_alb, d.max_photos)).astype(np.int32)
    feats = rng.normal(0, 1, (n_ph, d.image_feat_dim)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    word_emb = rng.normal(0, 0.5, (d.word_vocab_size, d.word_emb_dim)).astype(np.float32)
    return dict(
        word_emb=word_emb,
        vocab_chars=chars((d.word_vocab_size, d.max_word_len)),
        photo_feats=feats,
        album_photo_idx=photo_idx,
        album_photo_mask=np.ones((n_alb, d.max_photos), bool),
        photo_title_words=words((n_alb, d.max_photos, d.max_sent_len)),
        photo_title_chars=chars((n_alb, d.max_photos, d.max_sent_len, d.max_word_len)),
        photo_title_mask=np.ones((n_alb, d.max_photos, d.max_sent_len), bool),
        album_text_words=words((n_alb, 4, d.max_album_text_len)),
        album_text_chars=chars((n_alb, 4, d.max_album_text_len, d.max_word_len)),
        album_text_mask=np.ones((n_alb, 4, d.max_album_text_len), bool),
    )


def synth_batch(d, batch_size: int, num_albums: int, seed: int,
                num_choices: int = 4) -> dict[str, np.ndarray]:
    """Random questions at the configuration's shapes (bench_lib.synth_batch's
    draws in its order): every question, answer and album slot full."""
    rng = np.random.default_rng(seed)
    albums = d.max_albums
    n = batch_size
    return dict(
        q_words=rng.integers(2, d.word_vocab_size, (n, d.max_question_len)).astype(np.int32),
        q_chars=rng.integers(2, d.char_vocab_size,
                             (n, d.max_question_len, d.max_word_len)).astype(np.int32),
        q_mask=np.ones((n, d.max_question_len), bool),
        choice_words=rng.integers(2, d.word_vocab_size,
                                  (n, num_choices, d.max_answer_len)).astype(np.int32),
        choice_chars=rng.integers(2, d.char_vocab_size,
                                  (n, num_choices, d.max_answer_len, d.max_word_len)
                                  ).astype(np.int32),
        choice_mask=np.ones((n, num_choices, d.max_answer_len), bool),
        album_idx=rng.integers(1, num_albums + 1, (n, albums)).astype(np.int32),
        album_mask=np.ones((n, albums), bool),
        label=rng.integers(0, num_choices, n).astype(np.int32),
        ex_mask=np.ones(n, bool),
    )


def split_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """Row order of one shuffled epoch (data/pipeline.py Dataset.get_batches)."""
    order = np.arange(n)
    np.random.default_rng((seed, epoch)).shuffle(order)
    return order

