"""Deterministic synthetic mini-MemexQA generator (`make_synthetic`) and its
writer to the raw on-disk files (`write_raw_files`).

Emits data in exactly the raw schema the packer consumes, with answers that are
derivable from the album content (location/time/object questions). The same
seed gives the same corpus as the JAX package's generator. The focality
corpus (`make_focal_synthetic`) is not ported yet.
"""

from __future__ import annotations

import json
import os

import numpy as np

from fvta_memexqa_torch.data.schema import Album, QAPair

_CITIES = ["paris", "tokyo", "lisbon", "austin", "oslo", "quito", "seattle", "cairo"]
_YEARS = ["2007", "2009", "2011", "2013", "2015", "2017"]
_MONTHS = ["january", "april", "july", "october"]
_OBJECTS = ["zebra", "castle", "boat", "cactus", "waffle", "lantern", "bridge", "parrot"]
_NAMES = ["sunrise", "harbor", "meadow", "festival", "winter", "garden", "market", "canyon"]


def make_synthetic(
    num_albums: int = 6,
    photos_per_album: int = 4,
    num_questions: int = 24,
    feat_dim: int = 64,
    glove_dim: int = 100,
    seed: int = 0,
    test_fraction: float = 0.25,
):
    """Returns (qas, albums, photo_feats, test_ids, glove) in raw-schema form."""
    rng = np.random.default_rng(seed)
    albums: dict[str, Album] = {}
    photo_feats: dict[str, np.ndarray] = {}

    # Object-specific feature directions so answers are visible in photo features.
    obj_dirs = {o: rng.normal(0, 1, feat_dim).astype(np.float32) for o in _OBJECTS}

    album_meta = []
    for i in range(num_albums):
        name = _NAMES[i % len(_NAMES)]
        city = _CITIES[i % len(_CITIES)]
        year = _YEARS[i % len(_YEARS)]
        month = _MONTHS[i % len(_MONTHS)]
        objs = [_OBJECTS[(i + p) % len(_OBJECTS)] for p in range(photos_per_album)]
        pids = [f"p{i}_{p}" for p in range(photos_per_album)]
        for pid, obj in zip(pids, objs):
            f = (0.3 * rng.normal(0, 1, feat_dim) + obj_dirs[obj]).astype(np.float32)
            photo_feats[pid] = f / np.linalg.norm(f)
        aid = f"album{i}"
        albums[aid] = Album(
            album_id=aid,
            title=f"the {name} trip",
            description=f"our {name} album with a {objs[0]} and more",
            where=city,
            when=f"{month} {year}",
            photo_ids=tuple(pids),
            photo_titles=tuple(f"a photo of a {o}" for o in objs),
            photo_gps=tuple((float(10 + i), float(20 + p)) for p in range(photos_per_album)),
        )
        album_meta.append((aid, name, city, year, objs))

    def distract(pool: list[str], correct: str, k: int, r: np.random.Generator) -> list[str]:
        others = [x for x in pool if x != correct]
        if len(others) < k:
            # pool exhausted (e.g. most objects appear in the album): top up with
            # never-correct reserve words so the question stays unambiguous
            reserve = [w for w in _CITIES + _YEARS if w != correct and w not in others]
            others = others + reserve[: k - len(others)]
        picks = r.choice(len(others), size=k, replace=False)
        return [others[int(j)] for j in picks]

    qas: list[QAPair] = []
    for qi in range(num_questions):
        aid, name, city, year, objs = album_meta[qi % num_albums]
        kind = qi % 3
        r = np.random.default_rng(seed * 7919 + qi)
        if kind == 0:
            question = f"where did we go on the {name} trip ?"
            answer, pool = city, _CITIES
        elif kind == 1:
            question = f"what year was the {name} trip ?"
            answer, pool = year, _YEARS
        else:
            obj = objs[qi % len(objs)]
            question = f"what did we photograph on the {name} trip ?"
            # distractors must NOT also be in the album, or the question is ambiguous
            answer, pool = obj, [o for o in _OBJECTS if o not in objs or o == obj]
        choices = [answer] + distract(pool, answer, 3, r)
        order = r.permutation(4)
        choices = [choices[int(j)] for j in order]
        qas.append(
            QAPair(
                question_id=f"q{qi}",
                question=question,
                answer=answer,
                choices=tuple(choices),
                album_ids=(aid,),
                flickr_user_id="synthuser",
            )
        )

    n_test = int(round(num_questions * test_fraction))
    test_ids = {f"q{qi}" for qi in range(num_questions - n_test, num_questions)}

    # Fake GloVe covering ~70% of the vocab (exercises the frozen/trainable split).
    all_words = sorted(
        {w for a in albums.values() for w in (a.title + " " + a.description).split()}
        | set(_CITIES) | set(_YEARS) | set(_MONTHS) | set(_OBJECTS) | set(_NAMES)
        | {"where", "did", "we", "go", "on", "the", "trip", "what", "year", "was", "photograph"}
    )
    grng = np.random.default_rng(seed + 1)
    glove = {
        w: grng.normal(0, 0.5, glove_dim).astype(np.float32)
        for i, w in enumerate(all_words)
        if i % 10 < 7
    }
    return qas, albums, photo_feats, test_ids, glove


def write_raw_files(outdir, qas, albums, photo_feats, test_ids, glove, val_ids=None):
    """Serialize to the raw on-disk format of the dataset release (qas.json,
    album_info.json, test_question.ids, val_question.ids when given,
    photo_feats.npz, glove.txt), so the synthetic data drives the real CLI path
    (`cli prepro` reads these exact files). The JAX package's writer, byte for
    byte."""
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "qas.json"), "w") as f:
        json.dump([{"question_id": q.question_id, "question": q.question,
                    "answer": q.answer, "multiple_choices_4": list(q.choices),
                    "album_ids": list(q.album_ids), "flickr_user_id": q.flickr_user_id}
                   for q in qas], f)
    with open(os.path.join(outdir, "album_info.json"), "w") as f:
        json.dump([{"album_id": a.album_id, "album_title": a.title,
                    "album_description": a.description, "album_where": a.where,
                    "album_when": a.when, "photo_ids": list(a.photo_ids),
                    "photo_titles": list(a.photo_titles),
                    "photo_gps": [list(g) if g else None for g in a.photo_gps]}
                   for a in albums.values()], f)
    with open(os.path.join(outdir, "test_question.ids"), "w") as f:
        f.write("\n".join(sorted(test_ids)))
    if val_ids:
        with open(os.path.join(outdir, "val_question.ids"), "w") as f:
            f.write("\n".join(sorted(val_ids)))
    np.savez(os.path.join(outdir, "photo_feats.npz"), **photo_feats)
    with open(os.path.join(outdir, "glove.txt"), "w") as f:
        for w, v in glove.items():
            f.write(w + " " + " ".join(f"{x:.5f}" for x in v) + "\n")
