"""Video training as `train_video.train_video` runs it with prefetch 0 (and
`cli video --encoder bilstm`): each step a CPU `VideoInputs` of fresh,
unpinned tensors, moved to the device by `VideoInputs.to`, then
`train_video.video_train_step` (forward, backward, clip and Adam; dropout on;
torch's deterministic algorithms and `train_video.exact_float32`), on the state
of `train_video.init_video_state` holding the benchmark's weights.

The frames come from a seeded float32 clip pool in host memory (the
configuration's corpus: clips of uniform length, zero past it, as the video
pack pads them), gathered per batch by the question's clip as the video
loader's `VideoDataset._make_batch` builds a batch from gathered arrays; the
pack itself is not used (PERF.md §7: it stores a copy of the clip's frames per
question, zlib-compressed). The questions are a seeded train split of
questions_per_clip questions a clip, shuffled per (seed, epoch) as
`Dataset.get_batches` shuffles; an epoch is the split's whole batches.

Parameters: batch_size, checked_steps, warm_steps, trace_units.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from perfbench import faults_video  # noqa: F401  (registers the kind's faults)
from perfbench.lib import gen
from perfbench.reference import plain, video
from perfbench.traffic import _common as c

FRAMES = 5             # the seed stream of the clip pool (after _common's five)
POOL_CHUNK = 64        # clips drawn at a time on the device
QA_KEYS = ("q_words", "q_chars", "q_mask", "choice_words", "choice_chars", "choice_mask",
           "label")


def _tables(run) -> dict[str, np.ndarray]:
    """The vocabulary's GloVe rows and characters (the pack's shared.npz)."""
    d = run.d
    rng = np.random.default_rng(gen.seed_for(run.seed, c.TABLES))
    return {"word_emb_init": rng.normal(0, 0.5, (d.word_vocab_size, d.word_emb_dim)
                                        ).astype(np.float32),
            "vocab_chars": rng.integers(2, d.char_vocab_size, (d.word_vocab_size,
                                                               d.max_word_len)).astype(np.int32)}


def _words(rng, vocab_chars, rows: tuple, lo: int, hi: int, vocab: int) -> tuple:
    """(words, chars, mask) of `rows` sequences of uniform length in [lo, hi]
    words out of `hi`, zero past each length."""
    mask = np.arange(hi) < rng.integers(lo, hi + 1, rows)[..., None]
    words = rng.integers(2, vocab, (*rows, hi)).astype(np.int32) * mask
    return words, vocab_chars[words] * mask[..., None], mask


def _split(run, vocab_chars) -> dict[str, np.ndarray]:
    """The questions of the train split, the clip of each, and each clip's
    frame mask."""
    d, v, corpus = run.d, run.cfg["video"], run.cfg["corpus"]
    clips, per = corpus["num_clips"], corpus["questions_per_clip"]
    n, ch = clips * per, v["num_choices"]
    rng = np.random.default_rng(gen.seed_for(run.seed, c.SPLIT))
    lengths = rng.integers(v["min_frames"], v["max_frames"] + 1, clips)
    out = {"clip_mask": np.arange(v["max_frames"]) < lengths[:, None],
           "clip": np.arange(n) // per}
    out["q_words"], out["q_chars"], out["q_mask"] = _words(
        rng, vocab_chars, (n,), v["min_question_len"], d.max_question_len, d.word_vocab_size)
    out["choice_words"], out["choice_chars"], out["choice_mask"] = _words(
        rng, vocab_chars, (n, ch), v["min_answer_len"], d.max_answer_len, d.word_vocab_size)
    out["label"] = rng.integers(0, ch, n).astype(np.int32)
    return out


def _pool_chunks(run, clip_mask: np.ndarray):
    """(first clip, frames [c, T, F] on the device) over the pool in order:
    ReLU(N(0, 1)) features, zero past each clip's length."""
    dev = run.device
    g = torch.Generator(device=dev).manual_seed(gen.seed_for(run.seed, FRAMES))
    mask = torch.from_numpy(clip_mask).to(dev)
    clips, t = clip_mask.shape
    for start in range(0, clips, POOL_CHUNK):
        m = mask[start:start + POOL_CHUNK]
        x = torch.randn((m.shape[0], t, run.d.image_feat_dim), generator=g, device=dev)
        yield start, x.relu_() * m[..., None]


def _pool(run, clip_mask: np.ndarray) -> np.ndarray:
    """The whole clip pool in host memory, [clips, T, F] float32."""
    pool = np.empty((*clip_mask.shape, run.d.image_feat_dim), np.float32)
    for start, x in _pool_chunks(run, clip_mask):
        pool[start:start + x.shape[0]] = x.cpu().numpy()
    return pool


def _order(run, epoch: int) -> np.ndarray:
    corpus = run.cfg["corpus"]
    return gen.split_order(corpus["num_clips"] * corpus["questions_per_clip"],
                           gen.seed_for(run.seed, c.ORDER), epoch)


def setup(run) -> c.TrainDriver:
    from fvta_memexqa_torch import train as ftrain
    from fvta_memexqa_torch import train_video as tv
    from fvta_memexqa_torch.data.video_pack import video_shared_tables
    from fvta_memexqa_torch.models.video import VideoInputs
    from fvta_memexqa_torch.optim import Optimizer

    p, dev, v = run.params, run.device, run.cfg["video"]
    bs = p["batch_size"]
    cfg = c.program_config(run, batch_size=bs)
    tables = _tables(run)
    split = _split(run, tables["vocab_chars"])
    pool = _pool(run, split["clip_mask"])
    shared = video_shared_tables(cfg.data, tables, dev)
    record = {"task": v["task"], "encoder": v["temporal_encoder"],
              "num_choices": v["num_choices"], "num_answers": 0, "max_frames": v["max_frames"]}
    state = tv.init_video_state(cfg, record, dev, seed=run.seed)
    weights = plain.make_weights(video.param_spec(run.d, run.m),
                                 gen.seed_for(run.seed, c.WEIGHTS), dev)
    c.load_weights(state.model, weights)
    state.generator.manual_seed(gen.seed_for(run.seed, c.DROPOUT))
    opt = Optimizer(cfg.train)
    contexts = [ftrain.deterministic_algorithms(dev), tv.exact_float32()]

    def batch(idx) -> VideoInputs:
        # fresh, unpinned CPU tensors from gathered arrays, as VideoDataset._make_batch
        clips = split["clip"][idx]
        fields = {"frame_feats": pool[clips], "frame_mask": split["clip_mask"][clips],
                  **{k: split[k][idx] for k in QA_KEYS}}
        return VideoInputs(ex_mask=torch.ones(len(idx), dtype=torch.bool),
                           **{k: torch.from_numpy(a) for k, a in fields.items()})

    def batches():
        for epoch in itertools.count():
            order = _order(run, epoch)
            for b in range(len(order) // bs):
                yield batch(order[b * bs:(b + 1) * bs])

    return c.TrainDriver(state, lambda vi: tv.video_train_step(state, opt, shared, vi.to(dev)),
                         batches(), bs, weights, p["checked_steps"], p["warm_steps"], dev,
                         contexts)


def reference(run, tf32: bool = False) -> dict:
    p, dev, d, m = run.params, run.device, run.d, run.m
    bs, steps = p["batch_size"], p["checked_steps"]
    tables = _tables(run)
    split = _split(run, tables["vocab_chars"])
    rows = _order(run, 0)[:steps * bs]
    want = np.unique(split["clip"][rows])
    frames = {}
    for start, x in _pool_chunks(run, split["clip_mask"]):
        for k in want[(want >= start) & (want < start + x.shape[0])]:
            frames[int(k)] = x[k - start].clone()
    keys = ("q_words", "q_mask", "choice_words", "choice_mask", "label")
    batches = []
    for i in range(steps):
        idx = rows[i * bs:(i + 1) * bs]
        clips = split["clip"][idx]
        b = {k: torch.from_numpy(split[k][idx]).to(dev) for k in keys}
        b["frame_feats"] = torch.stack([frames[int(k)] for k in clips])
        b["frame_mask"] = torch.from_numpy(split["clip_mask"][clips]).to(dev)
        b["ex_mask"] = torch.ones(len(idx), dtype=torch.bool, device=dev)
        batches.append(b)
    shared = {"word_emb": torch.from_numpy(tables["word_emb_init"]).to(dev),
              "vocab_chars": torch.from_numpy(tables["vocab_chars"]).to(dev)}
    t = run.cfg["train"]
    return c.train_reference(video.param_spec(d, m),
                             lambda prm, b, g: video.train_loss(prm, shared, b, d, m, g),
                             batches, run.seed, dev, t["learning_rate"], t["grad_clip_norm"],
                             tf32)


compare = c.train_compare
