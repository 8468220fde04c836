"""Benchmark functions: MemexQA-shaped training, inference and cached-inference
throughput, and long-T video throughput, on one CUDA card.

The port of fvta_memexqa_tpu/bench_lib.py. The real MemexQA v1.1 corpus is not
in the repo, so the inputs are random tensors with the real dataset's shapes
and vocabulary scale (`realistic_config`: 12000 words, 630 albums, 5090
photos, F = 2537, H = 100), drawn from numpy in the JAX package's order, so
every array equals the JAX one at a seed. The graph they drive (embedding
gathers, the album encoders, the FVTA attention, the scorer) is the model's
own, so the throughputs stand for a real checkpoint's; accuracy is the test
suite's business.

Every timed function takes `device` ("cuda" by default; "cpu" runs the plain
versions, as the tests do) and raises on "cuda" without a card. `use_pallas`
is read and selects nothing: on the card the kernels are always the hand
written ones (ROADMAP, north star step 3). FLOPs and bytes come from the
shapes (`step_cost`, `video_step_cost`): the port has no XLA cost model.

Run on the card through chip_smoke.py (its `bench` line), or call the
functions directly: `bench_train(realistic_config())` and so on.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from fvta_memexqa_torch.config import NUM_MODALITIES, Config, DataConfig, ModelConfig
from fvta_memexqa_torch.data.device_prepro import Batch, SharedTables, assemble

# The H100 SXM's FP32 rate outside the tensor cores and its HBM3 rate: the
# yardsticks PERF.md's kernel bounds use.
H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12


def realistic_config(use_pallas: bool = False, dtype: str = "float32") -> Config:
    """MemexQA v1.1-scale shapes (SURVEY.md: ~20.8k QAs, 630 albums, 5090 photos,
    feat dim 2537, GloVe 100d; hidden 100 per direction as in the paper)."""
    cfg = Config()
    return cfg.replace(
        data=DataConfig(
            max_albums=4,
            max_photos=12,
            max_question_len=30,
            max_answer_len=8,
            max_sent_len=10,
            max_album_text_len=24,
            max_word_len=16,
            image_feat_dim=2537,
            word_emb_dim=100,
            word_vocab_size=12000,
            char_vocab_size=70,
            num_glove_words=10000,
        ),
        model=ModelConfig(hidden_dim=100, use_pallas=use_pallas, dtype=dtype),
    )


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for and no CUDA card is available; "
                           "pass device='cpu' to run the plain versions")
    return dev


def synth_shared(cfg: Config, num_albums: int = 630, num_photos: int = 5090,
                 seed: int = 0, device="cuda") -> SharedTables:
    """Random shared tables at the configuration's shapes: the JAX package's
    draws in its order (photo rows, L2-normalised features, then the tables)."""
    dev = _device(device)
    d = cfg.data
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
    arrays = dict(
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
    return SharedTables(**{k: torch.from_numpy(v).to(dev) for k, v in arrays.items()})


def synth_batch(cfg: Config, batch_size: int, num_albums: int = 630, seed: int = 1,
                device="cuda") -> Batch:
    """A random question batch at the configuration's shapes (the JAX package's
    draws in its order)."""
    dev = _device(device)
    d = cfg.data
    rng = np.random.default_rng(seed)
    n = batch_size
    arrays = dict(
        q_words=rng.integers(2, d.word_vocab_size, (n, d.max_question_len)).astype(np.int32),
        q_chars=rng.integers(2, d.char_vocab_size,
                             (n, d.max_question_len, d.max_word_len)).astype(np.int32),
        q_mask=np.ones((n, d.max_question_len), bool),
        choice_words=rng.integers(2, d.word_vocab_size,
                                  (n, 4, d.max_answer_len)).astype(np.int32),
        choice_chars=rng.integers(2, d.char_vocab_size,
                                  (n, 4, d.max_answer_len, d.max_word_len)).astype(np.int32),
        choice_mask=np.ones((n, 4, d.max_answer_len), bool),
        album_idx=rng.integers(1, num_albums + 1, (n, d.max_albums)).astype(np.int32),
        album_mask=np.ones((n, d.max_albums), bool),
        label=rng.integers(0, 4, n).astype(np.int32),
        ex_mask=np.ones(n, bool),
    )
    return Batch(**{k: torch.from_numpy(v).to(dev) for k, v in arrays.items()})


@dataclass
class BenchResult:
    batch_size: int
    qa_pairs_per_sec: float
    p50_latency_ms: float
    compile_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_slope(run, k_small: int, k_large: int, reps: int) -> float:
    """Median slope (time(k_large) - time(k_small)) / (k_large - k_small).

    `run(k)` must issue k dependency-chained steps (each step's output feeds a
    runtime zero into the next step's inputs, so no step can be skipped or
    hoisted) and then synchronize the device. The slope cancels the constant
    cost of a call (the first launch, the final synchronization) and is the
    per-step wall time in steady state. In eager PyTorch the steps are
    host-bound (PERF.md section 5: the device idles most of a step), so this
    slope includes the host's launch work: it is what a user's loop pays per
    step, not the device time. One definition, so every benchmark measures
    the same way."""
    run(k_small)  # warm-up: kernel builds, allocator, cuBLAS handles
    run(k_large)
    slopes = []
    for _ in range(reps):
        run(k_small)  # drain the queue
        t0 = time.perf_counter()
        run(k_small)
        d1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        run(k_large)
        d2 = time.perf_counter() - t0
        slopes.append((d2 - d1) / (k_large - k_small))
    return sorted(slopes)[len(slopes) // 2]


def device_peaks(device="cuda") -> tuple[float, float] | None:
    """(peak FP32 FLOP/s, peak HBM bytes/s) of the card, None where unknown: the
    H100's 67 TFLOP/s (FP32 outside the tensor cores: the port's kernels and
    the products it runs in full float32) and 3.35 TB/s."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    if "H100" in torch.cuda.get_device_name(dev):
        return H100_FP32_FLOPS, H100_HBM_BYTES_PER_S
    return None


# ---------------------------------------------------------------------------
# FLOP and byte accounting from the shapes. XLA's cost model has no PyTorch
# counterpart, so each layer is counted over the padded tensors it is given (as
# XLA counts them): product FLOPs (the matrix products and the char-CNN's
# convolution, 2 per multiply-add, what torch.utils.flop_counter counts over
# the plain forward), and bytes as each input read once and each output written
# once. A train step adds the backward (each product's gradient products: 2x
# its forward, 1x where the input needs no gradient) and the optimizer (Adam:
# each parameter read with its gradient and two moments, three written).
# ---------------------------------------------------------------------------

F32 = 4


def _layer(flops: float = 0.0, bytes_: float = 0.0, grad_flops: float | None = None) -> dict:
    return {"flops": float(flops), "bytes": float(bytes_),
            "grad_flops": float(2 * flops if grad_flops is None else grad_flops)}


def _bilstm(n: int, t: int, d: int, h: int, fin_only: bool = False) -> dict:
    """Both directions: x @ Wx over every position, h @ Wh at every step (the
    first step's h is the zero state, which takes no gradient)."""
    flops = 2 * (2 * n * t * d * 4 * h + 2 * n * t * h * 4 * h)
    weights = 2 * ((d + h) * 4 * h + 4 * h)
    out = n * 2 * h if fin_only else n * t * 2 * h + n * 2 * h
    return _layer(flops, F32 * (n * t * d + weights + out) + n * t,
                  2 * flops - 2 * 2 * n * h * 4 * h)


def _dense(rows: int, d_in: int, d_out: int, input_grad: bool = True) -> dict:
    flops = 2 * rows * d_in * d_out
    return _layer(flops, F32 * (rows * d_in + d_in * d_out + d_out + rows * d_out),
                  2 * flops if input_grad else flops)


def _char_cnn(words: int, cfg: Config) -> dict:
    """The char-CNN over `words` words (im2col then one product)."""
    d, m = cfg.data, cfg.model
    n_pos = d.max_word_len - m.char_cnn_width + 1
    k = m.char_cnn_width * m.char_emb_dim
    flops = 2 * words * n_pos * k * m.char_cnn_filters
    return _layer(flops, F32 * (words * n_pos * k + k * m.char_cnn_filters
                                + m.char_cnn_filters + words * m.char_cnn_filters)
                  + F32 * words * d.max_word_len)


def _highway(rows: int, demb: int, layers: int = 2) -> dict:
    flops = layers * 2 * 2 * rows * demb * demb
    return _layer(flops, F32 * (layers * 2 * (demb * demb + demb) + 2 * rows * demb))


def _gather(rows: int, width: int) -> dict:
    """An embedding-table gather: the ids read, the rows read and written."""
    return _layer(0, F32 * (rows + 2 * rows * width), 0)


def _attention(n: int, s: int, t: int, j: int, d: int) -> dict:
    """The trilinear FVTA attention: C = (h * w_xy) . q + h . w_x + q . w_y, the
    time- and sequence-weighted sums of h (with one sequence the latter is a
    scaling, no product), and q~."""
    flops = (2 * n * s * t * j * d + 2 * n * s * t * d + 2 * n * j * d
             + 2 * n * s * t * d + (2 * n * s * d if s > 1 else 0) + 2 * n * j * d)
    return _layer(flops, F32 * (n * s * t * d + n * s * t + n * j * d + n * j + 3 * d
                                + 2 * n * d + n * s * t + n * s))


def _sum(layers: dict, train: bool, params: int) -> dict:
    flops = sum(v["flops"] for v in layers.values())
    bytes_ = sum(v["bytes"] for v in layers.values())
    out = {"flops": flops, "bytes": bytes_, "product_flops": flops,
           "layers": {k: {"flops": v["flops"], "bytes": v["bytes"]} for k, v in layers.items()}}
    if train:
        back = sum(v["grad_flops"] for v in layers.values())
        adam = {"flops": 12.0 * params, "bytes": 7.0 * F32 * params}
        out["layers"]["backward"] = {"flops": back, "bytes": 2 * bytes_}
        out["layers"]["adam"] = adam
        out["product_flops"] = flops + back
        out["flops"] = flops + back + adam["flops"]
        out["bytes"] = 3 * bytes_ + adam["bytes"]
    return out


@functools.cache
def _memexqa_params(cfg: Config) -> int:
    from fvta_memexqa_torch.models.fvta import FVTAModel

    return sum(p.numel() for p in FVTAModel(cfg).parameters())


def step_cost(cfg: Config, batch_size: int, train: bool = False) -> dict:
    """FLOPs and bytes of ONE MemexQA forward at `batch_size` (train=False: the
    serving forward, the vocabulary and photo tables precomputed once per
    checkpoint as train.make_eval_tables does) or of one train step (the
    tables recomputed every step, the backward and Adam). Returns {"flops",
    "bytes", "product_flops", "layers": {name: {"flops", "bytes"}}}; the count
    depends on the shapes alone."""
    d, m = cfg.data, cfg.model
    n, a, p = batch_size, d.max_albums, d.max_photos
    h, demb = m.hidden_dim, d.word_emb_dim + m.char_cnn_filters
    s, t = a * NUM_MODALITIES, d.max_context_time
    vocab = max(d.word_vocab_size, d.extended_vocab_size)
    title_words = n * a * p * d.max_sent_len
    text_words = n * a * 4 * d.max_album_text_len
    q_words, c_words = n * d.max_question_len, n * 4 * d.max_answer_len
    layers = {}
    if train:   # the tables, recomputed from the parameters at every step
        layers["char_cnn_vocab"] = _char_cnn(vocab, cfg)
        layers["highway_vocab"] = _highway(vocab, demb)
        layers["photo_proj"] = _dense(n * a * p, d.image_feat_dim, demb, input_grad=False)
    layers["embed_gathers"] = _gather(title_words + text_words + q_words + c_words, demb)
    layers["bilstm_photo_title_words"] = _bilstm(n * a * p, d.max_sent_len, demb, h, True)
    layers["bilstm_photo"] = _bilstm(n * a, p, demb, h)
    layers["bilstm_photo_title"] = _bilstm(n * a, p, 2 * h, h)
    for name in ("album_title", "album_desc", "when", "where"):
        layers[f"bilstm_{name}"] = _bilstm(n * a, d.max_album_text_len, demb, h)
    layers["bilstm_question"] = _bilstm(n, d.max_question_len, demb, h)
    layers["bilstm_choices"] = _bilstm(n * 4, d.max_answer_len, demb, h, True)
    layers["attention"] = _attention(n, s, t, d.max_question_len, 2 * h)
    layers["scorer"] = _dense(n * 4, 10 * h, 1)
    return _sum(layers, train, _memexqa_params(cfg) if train else 0)


def video_step_cost(t_frames: int, batch_size: int = 8) -> dict:
    """FLOPs and bytes of ONE video forward (realistic_config, the mc head with
    5 choices, the dilated-conv encoder) at t_frames frames, as `step_cost`
    counts them: the vocabulary table (the forward recomputes it), the frame
    encoder, the question and choice encoders, the attention and the scorer."""
    cfg = realistic_config()
    d, m = cfg.data, cfg.model
    n, h, demb = batch_size, m.hidden_dim, d.word_emb_dim + m.char_cnn_filters
    h2 = 2 * h
    vocab = d.word_vocab_size
    layers = {
        "char_cnn_vocab": _char_cnn(vocab, cfg),
        "highway_vocab": _highway(vocab, demb),
        "embed_gathers": _gather(n * d.max_question_len + n * 5 * d.max_answer_len, demb),
        "frame_in_proj": _dense(n * t_frames, d.image_feat_dim, h2),
    }
    for li in range(4):   # kernel 3, dilation 2^l, 'SAME'
        layers[f"frame_conv{li}"] = _layer(
            2 * n * t_frames * h2 * 3 * h2,
            F32 * (2 * n * t_frames * h2 + 3 * h2 * h2 + h2))
    layers["bilstm_question"] = _bilstm(n, d.max_question_len, demb, h)
    layers["bilstm_choices"] = _bilstm(n * 5, d.max_answer_len, demb, h, True)
    layers["attention"] = _attention(n, 1, t_frames, d.max_question_len, h2)
    layers["scorer"] = _dense(n * 5, 5 * h2, 1)
    return _sum(layers, False, 0)


# ---------------------------------------------------------------------------
# The timed loops. Each step perturbs the inputs of every independent path
# (question and choice words, album ids or frame features) by `fb`, a runtime
# zero on the device computed from the previous step's output, so the steps
# form one dependency chain and none can be skipped.
# ---------------------------------------------------------------------------

def _feedback(x: torch.Tensor) -> torch.Tensor:
    """A runtime int32 zero (one where x is NaN) on x's device."""
    return torch.isnan(x).to(torch.int32)


def _perturbed(batch: Batch, fb: torch.Tensor, albums: bool = True) -> Batch:
    return dataclasses.replace(batch, q_words=batch.q_words + fb,
                               choice_words=batch.choice_words + fb,
                               album_idx=batch.album_idx + fb if albums else batch.album_idx)


def _slice(batch: Batch, sl: slice) -> Batch:
    return Batch(**{k: v[sl] for k, v in batch.__dict__.items()})


def bench_train(cfg: Config, batch_size: int = 64, k_small: int = 10, k_large: int = 60,
                reps: int = 3, seed: int = 0, device="cuda") -> float:
    """Training-step throughput: train.train_step (forward, backward, Adam)
    under torch's deterministic algorithms, as `cli train` runs it. Returns
    QA pairs per second."""
    from fvta_memexqa_torch.optim import Optimizer
    from fvta_memexqa_torch.train import deterministic_algorithms, init_state, train_step

    dev = _device(device)
    shared = synth_shared(cfg, seed=seed, device=dev)
    batch = synth_batch(cfg, batch_size, seed=seed + 1, device=dev)
    state = init_state(cfg, dev)
    opt = Optimizer(cfg.train)

    def run(k):
        fb = torch.zeros((), dtype=torch.int32, device=dev)
        for _ in range(k):
            fb = _feedback(train_step(state, opt, shared, _perturbed(batch, fb))["loss"])
        _sync(dev)

    with deterministic_algorithms(dev):
        return batch_size / _median_slope(run, k_small, k_large, reps)


def bench_train_dedup(cfg: Config, batch_size: int = 64, k_small: int = 10,
                      k_large: int = 60, reps: int = 3, seed: int = 0, device="cuda"):
    """Training-step throughput through the album-dedup step (train.train_step
    with the batch's dedup): the context encode runs over the batch's unique
    albums, sized to this batch's unique count rounded up to 8. Returns
    (qa_pairs_per_sec, unique_frac)."""
    from fvta_memexqa_torch.optim import Optimizer
    from fvta_memexqa_torch.train import (dedup_album_batch, deterministic_algorithms,
                                          init_state, train_step)

    dev = _device(device)
    shared = synth_shared(cfg, seed=seed, device=dev)
    batch = synth_batch(cfg, batch_size, seed=seed + 1, device=dev)
    slots = batch_size * cfg.data.max_albums
    album_idx = batch.album_idx.cpu().numpy()
    n_uniq = len(np.unique(album_idx))
    u_cap = min(-(-n_uniq // 8) * 8, slots)
    uniq, inv = (torch.from_numpy(a).to(dev) for a in dedup_album_batch(album_idx, u_cap))
    state = init_state(cfg, dev)
    opt = Optimizer(cfg.train)

    def run(k):
        fb = torch.zeros((), dtype=torch.int32, device=dev)
        for _ in range(k):
            out = train_step(state, opt, shared, _perturbed(batch, fb, albums=False),
                             (uniq + fb, inv))
            fb = _feedback(out["loss"])
        _sync(dev)

    with deterministic_algorithms(dev):
        qps = batch_size / _median_slope(run, k_small, k_large, reps)
    return qps, n_uniq / slots


def _eval_model(cfg: Config, dev: torch.device, seed: int = 0):
    from fvta_memexqa_torch.models.fvta import FVTAModel

    model = FVTAModel(cfg, generator=torch.Generator().manual_seed(seed)).to(dev)
    return model.eval()


@torch.no_grad()
def bench_cached_inference(cfg: Config, batch_size: int = 64, k_small: int = 25,
                           k_large: int = 250, reps: int = 3, seed: int = 0, prebuilt=None,
                           cache_dtype: str = "float32", n_chunks: int = 1, device="cuda"):
    """Test-set inference throughput through the album-encoding cache
    (eval_cache.py): the same logits as the full forward, each album encoded
    once. Returns (qa_pairs_per_sec, cache_seconds, prebuilt) where prebuilt =
    (model, cache_h, cache_m, vt, pt) can be passed back to reuse the cache
    across a sweep (cache_seconds is then 0).

    cache_dtype="bfloat16" stores the cache in bf16 and casts to f32 right after
    the per-question gather (the answer math stays f32). n_chunks > 1 splits
    each batch into n_chunks sub-batches, gather and answer per chunk."""
    from fvta_memexqa_torch.eval_cache import gather_cached_context, precompute_album_cache
    from fvta_memexqa_torch.train import make_eval_tables

    dev = _device(device)
    shared = synth_shared(cfg, seed=seed, device=dev)
    batch = synth_batch(cfg, batch_size, seed=seed + 1, device=dev)
    if prebuilt is not None:
        model, cache_h, cache_m, vt, pt = prebuilt
        cache_s = 0.0
    else:
        model = _eval_model(cfg, dev)
        _sync(dev)
        t0 = time.perf_counter()
        vt, pt = make_eval_tables(model, shared)
        cache_h, cache_m = precompute_album_cache(cfg, model, shared, vocab_table=vt,
                                                  photo_table=pt)
        _sync(dev)
        cache_s = time.perf_counter() - t0
    if batch_size % n_chunks:
        raise ValueError(f"n_chunks {n_chunks} must divide batch {batch_size}")
    ch = cache_h.to(torch.bfloat16) if cache_dtype == "bfloat16" else cache_h
    csz = batch_size // n_chunks

    def run(k):
        fb = torch.zeros((), dtype=torch.int32, device=dev)
        for _ in range(k):
            b2 = _perturbed(batch, fb)
            s = torch.zeros((), device=dev)
            for c in range(n_chunks):
                bc = _slice(b2, slice(c * csz, (c + 1) * csz))
                h_ctx, ctx_mask = gather_cached_context(ch, cache_m, bc.album_idx,
                                                        bc.album_mask)
                s = s + model.answer(shared, bc, h_ctx.float(), ctx_mask, vt).logits.sum()
            fb = _feedback(s)
        _sync(dev)

    per = _median_slope(run, k_small, k_large, reps)
    return batch_size / per, cache_s, (model, cache_h, cache_m, vt, pt)


def _video_setup(t_frames: int, use_pallas: bool, batch_size: int, seed: int, dev):
    from fvta_memexqa_torch.models.video import VideoFVTAModel, make_synthetic_video

    del use_pallas   # read and unused: the card always runs the hand kernels
    cfg = realistic_config()
    model = VideoFVTAModel(cfg, num_choices=5,
                           generator=torch.Generator().manual_seed(seed)).to(dev).eval()
    shared = synth_shared(cfg, num_albums=2, num_photos=2, seed=seed, device=dev)
    vi, _ = make_synthetic_video(cfg, num_videos=batch_size, num_frames=t_frames, seed=seed)
    return model, shared, vi.to(dev)


@torch.no_grad()
def bench_video(t_frames: int, use_pallas: bool, batch_size: int = 8, reps: int = 3,
                seed: int = 0, min_signal_s: float = 0.6, max_k: int = 20000,
                flops_per_step: float | None = None, peak_flops: float | None = None,
                mfu_cap: float = 0.5, k_small: int = 5, k_large: int = 60,
                device="cuda") -> float | None:
    """Long-T video QA forward throughput in frames per second (the
    dilated-conv encoder, the FVTA attention: K2 below 1024 frames, the
    streaming K4 from 1024 on), in full float32 as `cli video` runs
    (train_video.exact_float32: no TF32 in cuDNN or cuBLAS). `use_pallas` is
    read and selects nothing: on the card the attention always runs the
    hand-written kernels, and on the CPU their plain versions.

    - K calibration: k_large grows until the signal between k_small and
      k_large steps clears min_signal_s (the slope's noise floor).
    - MFU guard: with flops_per_step (video_step_cost) and peak_flops
      (device_peaks), a reading that implies more than mfu_cap of the card's
      peak is implausible for this FP32 work: it is measured again with twice
      the signal, and after 3 such readings None is returned (a null reading
      beats a wrong one). So is a non-positive slope."""
    from fvta_memexqa_torch.train_video import exact_float32

    dev = _device(device)
    model, shared, vi = _video_setup(t_frames, use_pallas, batch_size, seed, dev)
    with exact_float32():
        return _calibrated_fps(model, shared, vi, t_frames, batch_size, reps, min_signal_s,
                               max_k, flops_per_step, peak_flops, mfu_cap, k_small, k_large,
                               dev)


def _calibrated_fps(model, shared, vi, t_frames, batch_size, reps, min_signal_s, max_k,
                    flops_per_step, peak_flops, mfu_cap, k_small, k_large, dev):
    """bench_video's measurement: the K calibration, the median slope and the
    MFU guard."""
    def run(k):
        fb = torch.zeros((), dtype=torch.int32, device=dev)
        for _ in range(k):
            v2 = dataclasses.replace(vi, q_words=vi.q_words + fb,
                                     choice_words=vi.choice_words + fb,
                                     frame_feats=vi.frame_feats + fb.to(torch.float32))
            sh2 = dataclasses.replace(shared, vocab_chars=shared.vocab_chars + fb)
            fb = _feedback(model(sh2, v2).logits.sum())
        _sync(dev)

    run(k_small)
    for _ in range(3):
        for _ in range(8):
            run(k_small)
            t0 = time.perf_counter()
            run(k_small)
            d1 = time.perf_counter() - t0
            t0 = time.perf_counter()
            run(k_large)
            sig = time.perf_counter() - t0 - d1
            if sig >= min_signal_s or k_large >= max_k:
                break
            k_large = min(max_k, int(k_large * max(2.0, 1.5 * min_signal_s / max(sig, 1e-3))))
        per = _median_slope(run, k_small, k_large, reps)
        if per <= 0:
            print(f"bench_video t={t_frames}: non-positive slope ({per:.3e} s), "
                  "measuring again with a larger K", file=sys.stderr, flush=True)
            min_signal_s *= 2.0
            continue
        fps = batch_size * t_frames / per
        if flops_per_step is None or peak_flops is None:
            return fps
        implied = flops_per_step / (per * peak_flops)
        if implied <= mfu_cap:
            return fps
        print(f"bench_video t={t_frames}: rejected {fps:.3e} frames/s (implied MFU "
              f"{implied * 100:.0f}% > {mfu_cap * 100:.0f}%), measuring again with a larger K",
              file=sys.stderr, flush=True)
        min_signal_s *= 2.0
    return None


@torch.no_grad()
def bench_inference(cfg: Config, batch_sizes=(8, 64, 256), k_small: int = 25,
                    k_large: int = 250, reps: int = 3, seed: int = 0,
                    device="cuda") -> list[BenchResult]:
    """Full-forward inference throughput per batch size (the vocabulary and
    photo tables precomputed once, as per checkpoint in evaluation): one
    BenchResult each, p50_latency_ms the per-step slope and compile_s the
    first k_small steps' wall time (kernel builds included on a cold card)."""
    from fvta_memexqa_torch.train import make_eval_tables

    dev = _device(device)
    shared = synth_shared(cfg, seed=seed, device=dev)
    model = _eval_model(cfg, dev)
    vt, pt = make_eval_tables(model, shared)
    results = []
    for bs in batch_sizes:
        batch = synth_batch(cfg, bs, seed=seed + 1, device=dev)

        def run(k, batch=batch):
            fb = torch.zeros((), dtype=torch.int32, device=dev)
            for _ in range(k):
                mi = assemble(shared, _perturbed(batch, fb), pt)
                fb = _feedback(model(shared, mi, vt).logits.sum())
            _sync(dev)

        t0 = time.perf_counter()
        run(k_small)
        compile_s = time.perf_counter() - t0
        per = _median_slope(run, k_small, k_large, reps)
        results.append(BenchResult(batch_size=bs, qa_pairs_per_sec=bs / per,
                                   p50_latency_ms=per * 1e3, compile_s=compile_s))
    return results
