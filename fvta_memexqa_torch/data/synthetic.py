"""Deterministic synthetic mini-MemexQA generators and their writer to the raw
on-disk files (`write_raw_files`).

`make_synthetic` emits data in exactly the raw schema the packer consumes, with
answers that are derivable from the album content (location/time/object
questions). `make_focal_synthetic` and `make_evidence_only_synthetic` build the
focality corpora, on which flat attention is not enough (answers planted at one
photo position behind decoy-saturated text; whole albums held out for test and
val); `focal_kind` names each of their questions' kind. The same arguments give
the same corpus as the JAX package's generators, draw for draw.
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



def focal_kind(qi: int, num_albums: int) -> int:
    """Question kind for make_focal_synthetic's (and make_evidence_only_synthetic's)
    qid index `qi` (qid = f"q{qi}"): 0-1 focal "what" (photo evidence), 2 "what
    did the album say" (the decoy text), 3 where, 4 year. The sweep offset
    (qi // num_albums) decouples kind from the album cycle; its stride keeps
    (num_albums + stride) coprime to 5 — stride 2 where 1 would cancel
    (num_albums ≡ 4 mod 5, e.g. the default 24) and lock every album to one
    kind, else 1."""
    stride = 1 if (num_albums + 1) % 5 else 2
    return (qi + (qi // num_albums) * stride) % 5


def make_focal_synthetic(
    num_albums: int = 24,
    photos_per_album: int = 8,
    num_questions: int = 96,
    feat_dim: int = 64,
    glove_dim: int = 100,
    seed: int = 0,
    test_fraction: float = 0.25,
    decoy_repeats: int = 12,
    return_meta: bool = False,
    noise_scale: float = 0.3,
    albums_per_question: int = 1,
):
    """The corpus on which hierarchical focality is required, not optional.

    "what did we photograph" questions hide the answer object in the features
    of one photo (one time position of the photo modality; the others are
    noise), and the answer word is in no text field; the album description
    and every photo title are saturated with a decoy object, one of the four
    choices. Flat attention normalizes over every (sequence, time) position at
    once, so the decoy text's many positions outweigh the one evidence
    position; focal attention weights each sequence by its max score, so an
    O(1) gap suffices. "where" / "what year" questions keep their answers in
    the where / when text, and "what did the album say" questions are answered
    by the decoy text, so no modality can be suppressed wholesale. Test and
    val hold out whole albums (album identity is visible in the text).

    albums_per_question > 1: each question also gets K-1 distractor albums of
    the owner's split in a shuffled slot order, and the wrong choices come
    from the distractors' own objects / cities / years first. K = 1 draws no
    extra random numbers. noise_scale: the photo noise's scale (the evidence's
    SNR). decoy_repeats: the description's repeats of the decoy phrase.

    Returns (qas, albums, photo_feats, test_ids, glove, val_ids), and the
    per-album evidence meta {album_id: {"evidence_pos", "object", "decoy"}}
    after them with return_meta. The JAX package's generator, draw for draw."""
    rng = np.random.default_rng(seed)
    albums: dict[str, Album] = {}
    photo_feats: dict[str, np.ndarray] = {}
    evidence_meta: dict[str, dict] = {}  # per-album ground truth (return_meta)
    obj_dirs = {o: rng.normal(0, 1, feat_dim).astype(np.float32) for o in _OBJECTS}

    album_meta = []
    for i in range(num_albums):
        name = _NAMES[i % len(_NAMES)]
        city = _CITIES[i % len(_CITIES)]
        year = _YEARS[i % len(_YEARS)]
        month = _MONTHS[i % len(_MONTHS)]
        # The object must be independent of every text field (an index-locked
        # `_OBJECTS[i % 8]` would map the trip name in the question 1:1 to the
        # answer): a random draw leaves unseen-album questions answerable only
        # by localizing the object direction in the photo features.
        obj = _OBJECTS[int(rng.integers(len(_OBJECTS)))]
        non_obj = [o for o in _OBJECTS if o != obj]
        decoy = non_obj[int(rng.integers(len(non_obj)))]
        evidence_pos = int(rng.integers(photos_per_album))
        pids = [f"p{i}_{p}" for p in range(photos_per_album)]
        for p, pid in enumerate(pids):
            # noise_scale is the evidence-SNR knob: lower -> the planted
            # object direction dominates the normalized feature more.
            f = noise_scale * rng.normal(0, 1, feat_dim).astype(np.float32)
            if p == evidence_pos:
                f = f + obj_dirs[obj]
            photo_feats[pid] = (f / np.linalg.norm(f)).astype(np.float32)
        aid = f"album{i}"
        albums[aid] = Album(
            album_id=aid,
            title=f"the {name} trip",
            description=" ".join(["we photograph the", decoy] * decoy_repeats),
            where=city,
            when=f"{month} {year}",
            photo_ids=tuple(pids),
            photo_titles=tuple(f"photograph of the {decoy}"
                               for _ in range(photos_per_album)),
            photo_gps=tuple((float(10 + i), float(20 + p))
                            for p in range(photos_per_album)),
        )
        album_meta.append((aid, name, city, year, obj, decoy))
        evidence_meta[aid] = {"evidence_pos": evidence_pos, "object": obj,
                              "decoy": decoy}

    # Album-holdout split boundaries (used below for the question split AND,
    # in the multi-album regime, to keep distractor albums within the owner's
    # split — a test album appearing as a training distractor would leak its
    # photos/text into the train-time context).
    n_test_albums = max(1, int(round(num_albums * test_fraction)))
    n_val_albums = max(1, int(round(num_albums * 0.125)))
    split_lo_hi = lambda i: (
        (num_albums - n_test_albums, num_albums)
        if i >= num_albums - n_test_albums else
        (num_albums - n_test_albums - n_val_albums, num_albums - n_test_albums)
        if i >= num_albums - n_test_albums - n_val_albums else
        (0, num_albums - n_test_albums - n_val_albums))
    if albums_per_question > 1:
        smallest = min(n_test_albums, n_val_albums,
                       num_albums - n_test_albums - n_val_albums)
        if albums_per_question > smallest:
            raise ValueError(
                f"albums_per_question={albums_per_question} exceeds the "
                f"smallest album split ({smallest}); grow num_albums")

    qas: list[QAPair] = []
    for qi in range(num_questions):
        owner = qi % num_albums
        aid, name, city, year, obj, decoy = album_meta[owner]
        r = np.random.default_rng(seed * 7919 + qi)
        if albums_per_question > 1:
            lo, hi = split_lo_hi(owner)
            # The regime's core invariant ("the evidence object never appears
            # in ANY attached album's text; evidence is the ONLY answer
            # channel") requires that no distractor's DECOY — which saturates
            # that album's description and photo titles — equals the owner's
            # planted object. We also exclude distractors whose own planted
            # OBJECT equals the owner's: such an album would carry the answer
            # direction in its photo features too, letting the model localize
            # the answer in the wrong album. If the object-collision exclusion
            # starves the pool (small splits), it is relaxed first — it is a
            # task-sharpness preference, not the text-leak invariant.
            pool = [j for j in range(lo, hi)
                    if j != owner and album_meta[j][5] != obj
                    and album_meta[j][4] != obj]
            if len(pool) < albums_per_question - 1:
                pool = [j for j in range(lo, hi)
                        if j != owner and album_meta[j][5] != obj]
            if len(pool) < albums_per_question - 1:
                raise ValueError(
                    f"albums_per_question={albums_per_question}: only "
                    f"{len(pool)} leak-free distractor candidates in the "
                    f"owner's split for q{qi}; grow num_albums")
            d_idx = [pool[int(j)] for j in
                     r.choice(len(pool), size=albums_per_question - 1,
                              replace=False)]
            d_meta = [album_meta[j] for j in d_idx]
            slots = [owner] + d_idx
            album_ids = tuple(album_meta[slots[int(j)]][0]
                              for j in r.permutation(len(slots)))
        else:
            d_meta = []
            album_ids = (aid,)

        def fill_wrongs(preferred, pool_words, n, r=r):
            """n distinct wrong choices: distractor-album facts first (they are
            genuinely present in the context — pooled evidence is ambiguous),
            random same-type words to fill."""
            out = []
            for c in preferred:
                if c not in out and len(out) < n:
                    out.append(c)
            rest = [x for x in pool_words if x not in out]
            while len(out) < n:
                out.append(rest.pop(int(r.integers(len(rest)))))
            return out
        # 0-1: focal "what" (the discriminator, 40%); 2: "what did the album
        # say" — the DECOY text is the answer channel, so decoy modalities
        # cannot be suppressed wholesale and any gating must be question-
        # conditioned (that's what makes the focal kind hard for flat);
        # 3: where; 4: year. The sweep offset (qi // num_albums) decouples
        # kind from the album cycle: bare qi % 5 locks every album to ONE
        # kind whenever 5 divides num_albums (e.g. the recorded 240-album
        # corpus), defeating the within-album kind mixing argued above.
        kind = focal_kind(qi, num_albums)
        if kind <= 1:
            question = f"what did we photograph on the {name} trip ?"
            answer = obj
            others = [o for o in _OBJECTS if o not in (obj, decoy)]
            if d_meta:
                d_objs = [m[4] for m in d_meta if m[4] not in (obj, decoy)]
                choices = [answer, decoy] + fill_wrongs(d_objs, others, 2)
            else:
                picks = r.choice(len(others), size=2, replace=False)
                choices = [answer, decoy] + [others[int(j)] for j in picks]
        elif kind == 2:
            question = f"what did the album say we photograph on the {name} trip ?"
            answer = decoy
            others = [o for o in _OBJECTS if o not in (obj, decoy)]
            if d_meta:
                d_decoys = [m[5] for m in d_meta if m[5] not in (obj, decoy)]
                choices = [answer, obj] + fill_wrongs(d_decoys, others, 2)
            else:
                picks = r.choice(len(others), size=2, replace=False)
                choices = [answer, obj] + [others[int(j)] for j in picks]
        elif kind == 3:
            question = f"where did we go on the {name} trip ?"
            answer = city
            others = [x for x in _CITIES if x != city]
            if d_meta:
                d_cities = [m[2] for m in d_meta if m[2] != city]
                choices = [answer] + fill_wrongs(d_cities, others, 3)
            else:
                picks = r.choice(len(others), size=3, replace=False)
                choices = [answer] + [others[int(j)] for j in picks]
        else:
            question = f"what year was the {name} trip ?"
            answer = year
            others = [x for x in _YEARS if x != year]
            if d_meta:
                d_years = [m[3] for m in d_meta if m[3] != year]
                choices = [answer] + fill_wrongs(d_years, others, 3)
            else:
                picks = r.choice(len(others), size=3, replace=False)
                choices = [answer] + [others[int(j)] for j in picks]
        order = r.permutation(4)
        qas.append(QAPair(
            question_id=f"q{qi}",
            question=question,
            answer=answer,
            choices=tuple(choices[int(j)] for j in order),
            album_ids=album_ids,
            flickr_user_id="synthuser",
        ))

    # BOTH test and val hold out whole albums: best-on-val checkpoint selection
    # must track unseen-album generalization, not album→object memorization,
    # which keep-best would otherwise keep. Multi-album questions keep every
    # attached album within the owner's split (enforced above), so membership
    # via album_ids[0] stays exact regardless of slot shuffling.
    test_albums = {f"album{i}" for i in
                   range(num_albums - n_test_albums, num_albums)}
    val_albums = {f"album{i}" for i in
                  range(num_albums - n_test_albums - n_val_albums,
                        num_albums - n_test_albums)}
    test_ids = {q.question_id for q in qas if q.album_ids[0] in test_albums}
    val_ids = {q.question_id for q in qas if q.album_ids[0] in val_albums}

    all_words = sorted(
        {w for a in albums.values()
         for w in (a.title + " " + a.description).split()}
        | set(_CITIES) | set(_YEARS) | set(_MONTHS) | set(_OBJECTS) | set(_NAMES)
        | {"where", "did", "we", "go", "on", "the", "trip", "what", "year",
           "was", "photograph", "of", "a"}
    )
    grng = np.random.default_rng(seed + 1)
    glove = {
        w: grng.normal(0, 0.5, glove_dim).astype(np.float32)
        for i, w in enumerate(all_words)
        if i % 10 < 7
    }
    if return_meta:
        return qas, albums, photo_feats, test_ids, glove, val_ids, evidence_meta
    return qas, albums, photo_feats, test_ids, glove, val_ids


def make_evidence_only_synthetic(
    num_albums: int = 24,
    photos_per_album: int = 8,
    num_questions: int = 120,
    feat_dim: int = 64,
    glove_dim: int = 100,
    seed: int = 0,
    test_fraction: float = 0.25,
    decoy_repeats: int = 12,
    noise_scale: float = 0.3,
    return_meta: bool = False,
):
    """The evidence-only corpus: the planted photo evidence is the only signal
    that lifts any question kind above its text ceiling (~0.53).

    One photo per album is the evidence photo, tagged by a global marker
    direction, with the album's object, true city and true year planted as
    feature directions (shared across albums); two other photos carry two
    other in-album objects. Focal questions choose among the planted object,
    the text decoy and those two; where / year questions among the two
    candidates the album text lists (in a random order) and two out-of-album
    words; "what did the album say" questions are answered by the decoy text.
    Whole albums are held out for test and val, as in make_focal_synthetic;
    one album per question only. Returns what make_focal_synthetic returns,
    the meta with "obj2", "obj3", "city" and "year" as well. The JAX package's
    generator, draw for draw."""
    rng = np.random.default_rng(seed)
    albums: dict[str, Album] = {}
    photo_feats: dict[str, np.ndarray] = {}
    evidence_meta: dict[str, dict] = {}
    obj_dirs = {o: rng.normal(0, 1, feat_dim).astype(np.float32) for o in _OBJECTS}
    city_dirs = {c: rng.normal(0, 1, feat_dim).astype(np.float32) for c in _CITIES}
    year_dirs = {y: rng.normal(0, 1, feat_dim).astype(np.float32) for y in _YEARS}
    marker_dir = rng.normal(0, 1, feat_dim).astype(np.float32)

    album_meta = []
    for i in range(num_albums):
        name = _NAMES[i % len(_NAMES)]
        month = _MONTHS[i % len(_MONTHS)]
        # 4 distinct objects: planted answer, text decoy, 2 extra in-album
        # plants (the focal kind's in-context wrong choices)
        obj, decoy, obj2, obj3 = (
            _OBJECTS[int(j)] for j in rng.choice(len(_OBJECTS), 4, replace=False))
        city, city_alt = (_CITIES[int(j)]
                          for j in rng.choice(len(_CITIES), 2, replace=False))
        year, year_alt = (_YEARS[int(j)]
                          for j in rng.choice(len(_YEARS), 2, replace=False))
        evidence_pos = int(rng.integers(photos_per_album))
        others = [p for p in range(photos_per_album) if p != evidence_pos]
        pos2, pos3 = (others[int(j)]
                      for j in rng.choice(len(others), 2, replace=False))
        pids = [f"p{i}_{p}" for p in range(photos_per_album)]
        for p, pid in enumerate(pids):
            f = noise_scale * rng.normal(0, 1, feat_dim).astype(np.float32)
            if p == evidence_pos:
                f = (f + obj_dirs[obj] + marker_dir
                     + city_dirs[city] + year_dirs[year])
            elif p == pos2:
                f = f + obj_dirs[obj2]
            elif p == pos3:
                f = f + obj_dirs[obj3]
            photo_feats[pid] = (f / np.linalg.norm(f)).astype(np.float32)
        # text lists BOTH candidates in a random order: no residue between
        # word position and truth for any seed
        w_pair = [city, city_alt] if rng.integers(2) else [city_alt, city]
        y_pair = [year, year_alt] if rng.integers(2) else [year_alt, year]
        aid = f"album{i}"
        albums[aid] = Album(
            album_id=aid,
            title=f"the {name} trip",
            description=" ".join(["we photograph the", decoy] * decoy_repeats),
            where=f"{w_pair[0]} or {w_pair[1]}",
            when=f"{month} {y_pair[0]} or {y_pair[1]}",
            photo_ids=tuple(pids),
            photo_titles=tuple(f"photograph of the {decoy}"
                               for _ in range(photos_per_album)),
            photo_gps=tuple((float(10 + i), float(20 + p))
                            for p in range(photos_per_album)),
        )
        album_meta.append((aid, name, city, city_alt, year, year_alt,
                           obj, decoy, obj2, obj3))
        evidence_meta[aid] = {
            "evidence_pos": evidence_pos, "object": obj, "decoy": decoy,
            "obj2": obj2, "obj3": obj3, "city": city, "year": year,
        }

    qas: list[QAPair] = []
    for qi in range(num_questions):
        owner = qi % num_albums
        (aid, name, city, city_alt, year, year_alt,
         obj, decoy, obj2, obj3) = album_meta[owner]
        r = np.random.default_rng(seed * 7919 + qi)
        kind = focal_kind(qi, num_albums)  # same layout as the focal corpus
        if kind <= 1:
            question = f"what did we photograph on the {name} trip ?"
            answer, choices = obj, [obj, decoy, obj2, obj3]
        elif kind == 2:
            question = f"what did the album say we photograph on the {name} trip ?"
            answer, choices = decoy, [decoy, obj, obj2, obj3]
        elif kind == 3:
            question = f"where did we go on the {name} trip ?"
            out = [c for c in _CITIES if c not in (city, city_alt)]
            picks = r.choice(len(out), size=2, replace=False)
            answer = city
            choices = [city, city_alt] + [out[int(j)] for j in picks]
        else:
            question = f"what year was the {name} trip ?"
            out = [y for y in _YEARS if y not in (year, year_alt)]
            picks = r.choice(len(out), size=2, replace=False)
            answer = year
            choices = [year, year_alt] + [out[int(j)] for j in picks]
        order = r.permutation(4)
        qas.append(QAPair(
            question_id=f"q{qi}",
            question=question,
            answer=answer,
            choices=tuple(choices[int(j)] for j in order),
            album_ids=(aid,),
            flickr_user_id="synthuser",
        ))

    # whole-album holdout for test AND val (keep-best must track unseen-album
    # generalization — same rationale as make_focal_synthetic)
    n_test_albums = max(1, int(round(num_albums * test_fraction)))
    n_val_albums = max(1, int(round(num_albums * 0.125)))
    test_albums = {f"album{i}" for i in
                   range(num_albums - n_test_albums, num_albums)}
    val_albums = {f"album{i}" for i in
                  range(num_albums - n_test_albums - n_val_albums,
                        num_albums - n_test_albums)}
    test_ids = {q.question_id for q in qas if q.album_ids[0] in test_albums}
    val_ids = {q.question_id for q in qas if q.album_ids[0] in val_albums}

    all_words = sorted(
        {w for a in albums.values()
         for w in (a.title + " " + a.description).split()}
        | set(_CITIES) | set(_YEARS) | set(_MONTHS) | set(_OBJECTS) | set(_NAMES)
        | {"where", "did", "we", "go", "on", "the", "trip", "what", "year",
           "was", "photograph", "of", "a", "or", "say", "album"}
    )
    grng = np.random.default_rng(seed + 1)
    glove = {
        w: grng.normal(0, 0.5, glove_dim).astype(np.float32)
        for i, w in enumerate(all_words)
        if i % 10 < 7
    }
    if return_meta:
        return qas, albums, photo_feats, test_ids, glove, val_ids, evidence_meta
    return qas, albums, photo_feats, test_ids, glove, val_ids


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
