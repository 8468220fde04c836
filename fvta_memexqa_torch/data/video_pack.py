"""Video-QA data path: raw TGIF-style files → packed shards → streaming loader
(the JAX package's data/video_pack.py; the same on-disk format, array for array).

Raw schema (generic video QA; TGIF-QA's tsv exports map onto it):

    qas.jsonl        one JSON object per line:
                     {"qa_id", "video_id", "question", "choices": [C strings],
                      "answer_idx": int}      (task mc; count: "answer_count";
                                               frameqa: "answer")
    frame_feats.npz  video_id → f32 [T_i, F] per-frame features
    test_qa.ids      optional: qa_ids of the test split (one per line); val is
                     carved from the remainder

Pack layout (out_dir): meta.json (resolved DataConfig, vocab maps, split sizes),
shared.npz (word_emb_init, vocab_chars) and video_{split} shard files
(data/stream.write_shards); frame features dominate the bytes, so video packs
are always sharded and loaded through StreamingDataset (VideoDataset). Frames
beyond max_frames are uniformly subsampled; shorter videos are zero-padded
with a prefix frame_mask.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from fvta_memexqa_torch.config import DataConfig
from fvta_memexqa_torch.data.device_prepro import SharedTables
from fvta_memexqa_torch.data.pack import BatchEncoder
from fvta_memexqa_torch.data.stream import StreamingDataset, write_shards
from fvta_memexqa_torch.data.tokenize import tokenize, word_to_char_ids
from fvta_memexqa_torch.data.vocab import Vocab
from fvta_memexqa_torch.models.video import VideoInputs

TASKS = ("mc", "count", "frameqa")


def parse_video_qas(path: str, task: str = "mc") -> tuple[list[dict], list[str]]:
    """qas.jsonl → (valid rows, error strings), validated per task: mc rows
    carry >= 2 choices and an in-range answer_idx, count rows an integer
    answer_count >= 0, frameqa rows a non-empty answer string."""
    if task not in TASKS:
        raise ValueError(f"unknown task {task!r} (expected mc | count | frameqa)")
    rows, errs = [], []
    with open(path, encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                r = json.loads(line)
                if not r.get("video_id"):
                    raise ValueError("missing video_id")
                if not r.get("question"):
                    raise ValueError("missing question")
                if task == "mc":
                    ch = r.get("choices") or []
                    if len(ch) < 2:
                        raise ValueError("need >= 2 choices")
                    ai = int(r.get("answer_idx", -1))
                    if not 0 <= ai < len(ch):
                        raise ValueError(f"answer_idx {ai} out of range")
                elif task == "count":
                    if int(r.get("answer_count", -1)) < 0:
                        raise ValueError("missing/negative answer_count")
                elif not str(r.get("answer", "")).strip():
                    raise ValueError("missing answer")
                r.setdefault("qa_id", f"qa{ln}")
                rows.append(r)
            except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
                errs.append(f"line {ln}: {e!r}")
    return rows, errs


def _subsample_frames(feats: np.ndarray, max_frames: int) -> tuple[np.ndarray, np.ndarray]:
    """[T_i, F] → ([max_frames, F], mask [max_frames])."""
    t_i, f_dim = feats.shape
    out = np.zeros((max_frames, f_dim), np.float32)
    mask = np.zeros(max_frames, bool)
    if t_i >= max_frames:
        idx = np.linspace(0, t_i - 1, max_frames).round().astype(int)
        out[:] = feats[idx]
        mask[:] = True
    else:
        out[:t_i] = feats
        mask[:t_i] = True
    return out, mask


def pack_video(qas: list[dict], frame_feats: dict[str, np.ndarray],
               test_ids: set[str], glove: dict[str, np.ndarray] | None,
               out_dir: str, cfg: DataConfig, num_choices: int = 5,
               max_frames: int = 64, shard_size: int = 256,
               val_fraction: float = 0.1, seed: int = 0,
               task: str = "mc") -> dict:
    """Pack raw video QA into streaming shards; returns the meta dict. Rows
    whose video has no features (and, for mc, rows with another choice count)
    are dropped and counted in meta["dropped"]. frameqa builds its answer
    vocabulary from the train split; other splits' unknown answers get label -1."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    feat_dim = int(next(iter(frame_feats.values())).shape[-1])

    no_feats = sum(1 for q in qas if q["video_id"] not in frame_feats)
    bad_choices = 0
    if task == "mc":
        bad_choices = sum(1 for q in qas if q["video_id"] in frame_feats
                          and len(q["choices"]) != num_choices)
        qas = [q for q in qas if q["video_id"] in frame_feats
               and len(q["choices"]) == num_choices]
    else:
        num_choices = 1  # choice arrays unused by the model; minimal shapes
        qas = [q for q in qas if q["video_id"] in frame_feats]
    test = [q for q in qas if q["qa_id"] in test_ids]
    rest = [q for q in qas if q["qa_id"] not in test_ids]
    order = rng.permutation(len(rest))
    n_val = int(len(rest) * val_fraction)
    splits = {"train": [rest[i] for i in order[n_val:]],
              "val": [rest[i] for i in order[:n_val]],
              "test": test}

    answer_vocab: dict[str, int] = {}
    if task == "frameqa":
        for q in splits["train"]:
            answer_vocab.setdefault(str(q["answer"]).strip().lower(), len(answer_vocab))

    def labels(rows) -> np.ndarray:
        if task == "count":
            return np.asarray([int(q["answer_count"]) for q in rows], np.int32)
        if task == "frameqa":
            return np.asarray([answer_vocab.get(str(q["answer"]).strip().lower(), -1)
                               for q in rows], np.int32)
        return np.asarray([q["answer_idx"] for q in rows], np.int32)

    train_tokens = [t for q in splits["train"]
                    for t in tokenize(q["question"])
                    + [t for c in q.get("choices", []) for t in tokenize(c)]]
    vocab = Vocab.build(train_tokens, glove, cfg.word_emb_dim, seed=seed)
    cfg = DataConfig(**{**cfg.__dict__,
                        "word_vocab_size": vocab.size,
                        "char_vocab_size": vocab.char_size,
                        "num_glove_words": vocab.num_glove,
                        "extended_vocab_size": vocab.size,
                        "image_feat_dim": feat_dim})
    vocab_chars = np.zeros((vocab.size, cfg.max_word_len), np.int32)
    for w, wid in vocab.word2idx.items():
        vocab_chars[wid] = word_to_char_ids(w, vocab.char2idx, cfg.max_word_len)
    np.savez_compressed(os.path.join(out_dir, "shared.npz"),
                        word_emb_init=vocab.emb_init, vocab_chars=vocab_chars)

    enc = BatchEncoder(vocab)
    split_sizes = {}
    for name, rows in splits.items():
        n = len(rows)
        split_sizes[name] = n
        qw, qc, qm = enc.encode([q["question"] for q in rows],
                                cfg.max_question_len, cfg.max_word_len)
        cw, cc, cm = enc.encode(
            [c for q in rows for c in (q["choices"] if task == "mc" else [""])],
            cfg.max_answer_len, cfg.max_word_len)
        ff = np.zeros((n, max_frames, feat_dim), np.float32)
        fm = np.zeros((n, max_frames), bool)
        for i, q in enumerate(rows):
            ff[i], fm[i] = _subsample_frames(
                np.asarray(frame_feats[q["video_id"]], np.float32), max_frames)
        arrays = {
            "frame_feats": ff, "frame_mask": fm,
            "q_words": qw, "q_chars": qc, "q_mask": qm,
            "choice_words": cw.reshape(n, num_choices, cfg.max_answer_len),
            "choice_chars": cc.reshape(n, num_choices, cfg.max_answer_len, cfg.max_word_len),
            "choice_mask": cm.reshape(n, num_choices, cfg.max_answer_len),
            "label": labels(rows),
            "qid": np.asarray([q["qa_id"] for q in rows], dtype="U64"),
        }
        write_shards(out_dir, f"video_{name}", arrays, shard_size)

    meta = {
        "data_config": cfg.__dict__,
        "task": task,
        "num_choices": num_choices,
        "answer_vocab": sorted(answer_vocab, key=answer_vocab.get),
        "max_frames": max_frames,
        "word2idx": vocab.word2idx,
        "char2idx": vocab.char2idx,
        "split_sizes": split_sizes,
        "dropped": {"missing_video_feats": no_feats, "wrong_choice_count": bad_choices},
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return meta


def load_video_meta(out_dir: str) -> tuple[DataConfig, dict, dict[str, np.ndarray]]:
    """→ (resolved DataConfig, meta dict, shared arrays {word_emb_init, vocab_chars})."""
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    cfg = DataConfig(**meta["data_config"])
    with np.load(os.path.join(out_dir, "shared.npz")) as z:
        shared = {k: z[k] for k in z.files}
    return cfg, meta, shared


def video_shared_tables(cfg: DataConfig, shared: dict[str, np.ndarray],
                        device="cpu") -> SharedTables:
    """SharedTables for the video model on `device` (the photo-album fields are
    unused one-element placeholders)."""
    z = lambda *s, dt=torch.int32: torch.zeros(s, dtype=dt, device=device)
    return SharedTables(
        word_emb=torch.from_numpy(np.ascontiguousarray(shared["word_emb_init"])).to(device),
        vocab_chars=torch.from_numpy(np.ascontiguousarray(shared["vocab_chars"])).to(device),
        photo_feats=z(1, cfg.image_feat_dim, dt=torch.float32),
        album_photo_idx=z(1, 1), album_photo_mask=z(1, 1, dt=torch.bool),
        photo_title_words=z(1, 1, 1), photo_title_chars=z(1, 1, 1, 1),
        photo_title_mask=z(1, 1, 1, dt=torch.bool),
        album_text_words=z(1, 4, 1), album_text_chars=z(1, 4, 1, 1),
        album_text_mask=z(1, 4, 1, dt=torch.bool))


class VideoDataset(StreamingDataset):
    """Streaming loader over video_{split} shards, yielding VideoInputs of CPU
    tensors (VideoInputs.to moves them)."""

    FILE_PREFIX = "video"
    KEYS = ("frame_feats", "frame_mask", "q_words", "q_chars", "q_mask",
            "choice_words", "choice_chars", "choice_mask", "label")

    def _make_batch(self, ex_mask, fields) -> VideoInputs:
        return VideoInputs(ex_mask=torch.from_numpy(ex_mask),
                           **{k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in fields.items()})


# ---- synthetic raw corpus ----------------------------------------------------------
# The learnable "event" world of models/video.make_synthetic_video, emitted in the
# raw schema so the whole pack → stream → train path runs without real assets.

EVENTS = ["jump", "spin", "wave", "fall", "clap", "run", "nod", "point"]


def make_synthetic_video_raw(num_videos: int = 48, num_frames: int = 32,
                             feat_dim: int = 64, num_choices: int = 5,
                             test_fraction: float = 0.25, seed: int = 0,
                             task: str = "mc"):
    """→ (qas list[dict], frame_feats {video_id: [T, F]}, test_ids set), the
    same numbers as the JAX package's generator for the same arguments. Event
    directions come from a fixed generator, so every seed shares one world."""
    rng = np.random.default_rng(seed)
    dir_rng = np.random.default_rng(20260816)
    dirs = {e: dir_rng.normal(0, 1, feat_dim).astype(np.float32) for e in EVENTS}
    qas, feats = [], {}
    span_w = 2
    for i in range(num_videos):
        vid = f"video{i}"
        if task == "count":
            t_i = num_frames  # fixed length: count is a magnitude readout
        else:
            t_i = int(rng.integers(num_frames // 2, num_frames * 2))
        x = 0.1 * rng.normal(0, 1, (t_i, feat_dim)).astype(np.float32)
        ev_idx = int(rng.integers(len(EVENTS)))
        ev = EVENTS[ev_idx]
        row = {"qa_id": f"qa{i}", "video_id": vid}
        if task == "count":
            count_max = min(10, max(t_i // (2 * span_w) - 1, 2))
            k = int(rng.integers(1, count_max + 1))
            k2 = int(rng.integers(1, count_max + 1))
            # disjoint slots for the asked and the distractor event
            slots = rng.permutation(t_i // span_w)
            other = EVENTS[(ev_idx + 1 + int(rng.integers(len(EVENTS) - 1))) % len(EVENTS)]
            for sl in slots[:k]:
                x[sl * span_w: (sl + 1) * span_w] += dirs[ev]
            for sl in slots[k: k + k2]:
                x[sl * span_w: (sl + 1) * span_w] += dirs[other]
            row |= {"question": f"how many times did the person {ev} ?", "answer_count": k}
        else:
            start = int(rng.integers(0, max(t_i // 2, 1)))
            span = int(rng.integers(2, max(t_i // 2, 3)))
            x[start: start + span] += dirs[ev]
            if task == "frameqa":
                row |= {"question": "what did the person do ?", "answer": ev}
            else:
                others = [e for e in EVENTS if e != ev]
                pick = rng.choice(len(others), num_choices - 1, replace=False)
                choices = [ev] + [others[int(p)] for p in pick]
                order = rng.permutation(num_choices)
                row |= {"question": "what did the person do ?",
                        "choices": [choices[int(o)] for o in order],
                        "answer_idx": int(np.argwhere(order == 0)[0, 0])}
        x /= np.linalg.norm(x, axis=-1, keepdims=True) + 1e-6
        feats[vid] = x
        qas.append(row)
    n_test = int(num_videos * test_fraction)
    test_ids = {f"qa{i}" for i in range(num_videos - n_test, num_videos)}
    return qas, feats, test_ids


def write_raw_video_files(outdir: str, qas: list[dict], frame_feats: dict[str, np.ndarray],
                          test_ids: set[str]) -> None:
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "qas.jsonl"), "w") as f:
        for q in qas:
            f.write(json.dumps(q) + "\n")
    np.savez_compressed(os.path.join(outdir, "frame_feats.npz"), **frame_feats)
    with open(os.path.join(outdir, "test_qa.ids"), "w") as f:
        for qid in sorted(test_ids):
            f.write(qid + "\n")
