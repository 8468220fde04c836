"""FLOPs and bytes from shapes: the benchmark's frozen arithmetic.

The layer counts (`_layer` ... `_sum`, `step_cost`) are copies of
fvta_memexqa_torch/bench_lib.py's (`_layer`, `_bilstm`, `_dense`, `_char_cnn`,
`_highway`, `_gather`, `_attention`, `_sum`, `step_cost`): product FLOPs over the padded tensors (2 per multiply-add),
bytes as each input read once and each output written once; a train step adds
the backward (each product's gradient products: 2x its forward, 1x where the
input takes no gradient) and Adam. One change: the parameter count is an
argument (the reference's, not the program's).

The kernel bounds (`k1_proj`, `k1_rec`, `k1b`, `k2`) are copies of
chip_smoke.py's `k1_bounds`, its K1b bound and `k2_bound_ms`, returning (flops, bytes) of one call over its valid
positions; a call's least time is max(flops / peak FLOP/s, bytes / peak bytes/s).

`d` and `m` are a configuration's "data" and "model" sections as attributes.
"""

from __future__ import annotations

F32 = 4
NUM_MODALITIES = 6   # photo, photo_title, album_title, album_desc, when, where
NUM_TEXTS = 4        # album_title, album_desc, when, where


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


def _char_cnn(words: int, d, m) -> dict:
    """The char-CNN over `words` words (im2col then one product)."""
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


def demb(d, m) -> int:
    """The token embedding's width: GloVe plus the char-CNN's filters."""
    return d.word_emb_dim + m.char_cnn_filters


def max_context_time(d) -> int:
    return max(d.max_photos, d.max_album_text_len)


def _encode_layers(d, m, rows: int, a: int) -> dict:
    """The album side of one forward over `rows` questions of `a` albums each."""
    h, de = m.hidden_dim, demb(d, m)
    p = d.max_photos
    return {
        "bilstm_photo_title_words": _bilstm(rows * a * p, d.max_sent_len, de, h, True),
        "bilstm_photo": _bilstm(rows * a, p, de, h),
        "bilstm_photo_title": _bilstm(rows * a, p, 2 * h, h),
        **{f"bilstm_text{i}": _bilstm(rows * a, d.max_album_text_len, de, h)
           for i in range(NUM_TEXTS)},
    }


def _answer_layers(d, m, n: int) -> dict:
    """The query side of one forward over n questions."""
    h, de = m.hidden_dim, demb(d, m)
    return {
        "bilstm_question": _bilstm(n, d.max_question_len, de, h),
        "bilstm_choices": _bilstm(n * 4, d.max_answer_len, de, h, True),
        "attention": _attention(n, d.max_albums * NUM_MODALITIES, max_context_time(d),
                                d.max_question_len, 2 * h),
        "scorer": _dense(n * 4, 10 * h, 1),
    }


def step_cost(d, m, batch_size: int, params: int, train: bool = False) -> dict:
    """One MemexQA forward at batch_size (train=False: the vocabulary and photo
    tables precomputed, as per checkpoint) or one train step (the tables
    recomputed at every step, the backward and Adam over `params`)."""
    n, a, p = batch_size, d.max_albums, d.max_photos
    de = demb(d, m)
    vocab = max(d.word_vocab_size, getattr(d, "extended_vocab_size", 0))
    title_words = n * a * p * d.max_sent_len
    text_words = n * a * NUM_TEXTS * d.max_album_text_len
    q_words, c_words = n * d.max_question_len, n * 4 * d.max_answer_len
    layers = {}
    if train:
        layers["char_cnn_vocab"] = _char_cnn(vocab, d, m)
        layers["highway_vocab"] = _highway(vocab, de)
        layers["photo_proj"] = _dense(n * a * p, d.image_feat_dim, de, input_grad=False)
    layers["embed_gathers"] = _gather(title_words + text_words + q_words + c_words, de)
    layers.update(_encode_layers(d, m, n, a))
    layers.update(_answer_layers(d, m, n))
    return _sum(layers, train, params if train else 0)


def eval_cost(d, m, questions: int, album_rows: int, photo_rows: int) -> dict:
    """One checkpoint evaluation through the album cache: the per-checkpoint
    tables (vocabulary: char-CNN + highway; photos: the projection of every
    photo row), the encode of every album row at one album a row, then the
    query side of every question (eval_cache.evaluate_cached with cache=None)."""
    de = demb(d, m)
    layers = {
        "char_cnn_vocab": _char_cnn(d.word_vocab_size, d, m),
        "highway_vocab": _highway(d.word_vocab_size, de),
        "photo_proj": _dense(photo_rows, d.image_feat_dim, de),
        "embed_gathers": _gather(album_rows * (d.max_photos * d.max_sent_len
                                               + NUM_TEXTS * d.max_album_text_len)
                                 + questions * (d.max_question_len + 4 * d.max_answer_len),
                                 de),
    }
    for k, v in _encode_layers(d, m, album_rows, 1).items():
        layers[f"cache_{k}"] = v
    layers.update(_answer_layers(d, m, questions))
    return _sum(layers, False, 0)


# ---- one kernel call's least work: (flops, bytes) -----------------------------------

def k1_proj(n: int, t: int, d: int, h: int) -> tuple[float, float]:
    """lstm_proj: x . [wx_fw | wx_bw] + b over every valid position."""
    steps = n * t
    return 2.0 * steps * d * 8 * h, F32 * (steps * d + 2 * (d * 4 * h + 4 * h) + steps * 8 * h)


def k1_rec(n: int, t: int, h: int, emit_out: bool, train: bool) -> tuple[float, float]:
    """lstm_rec: the recurrence of both directions from the projection; under
    grad it also writes the cells and the pre-activations (in place over the
    projection), and always the per-step outputs."""
    steps = n * t
    outs = (n * t * 2 * h if emit_out or train else 0) + n * 2 * h
    if train:
        outs += n * t * 2 * h + n * t * 8 * h
    return 2.0 * steps * (2 * h * 4 * h + 12 * h), F32 * (steps * 8 * h + n + 2 * h * 4 * h + outs)


def k1b(n: int, t: int, h: int, g_out: bool) -> tuple[float, float]:
    """lstm_rec_bwd: pre-activations, cells, the cotangents and wh in, dgates out."""
    steps = n * t
    g_bytes = 2 * steps * h if g_out else 0
    return (2.0 * steps * (2 * 4 * h * h + 30 * h),
            F32 * (steps * 8 * h + n + 2 * h * 4 * h + 2 * steps * h + g_bytes + n * 2 * h
                   + n * t * 8 * h))


def k2(n: int, s: int, t: int, j: int, d: int, valid_ct: int) -> tuple[float, float]:
    """K2 over n examples of s x t context rows, valid_ct of them valid per
    example, and j question words, all valid."""
    nbytes = F32 * (n * s * t * d + n * s * t + n * j * d + n * j + 3 * d
                    + 2 * n * d + n * s * t + n * s)
    flops = n * (valid_ct * j * 2 * d + valid_ct * 6 * d + valid_ct * j * 4)
    return float(flops), float(nbytes)


def least_seconds(calls, peak_flops: float, peak_bytes: float) -> tuple[float, str]:
    """Sum over calls [(flops, bytes)] of max(flops / peak, bytes / peak), and
    which bound binds most of it ("operations" or "bytes")."""
    total = by_ops = 0.0
    for flops, nbytes in calls:
        t_ops, t_bytes = flops / peak_flops, nbytes / peak_bytes
        total += max(t_ops, t_bytes)
        by_ops += t_ops if t_ops >= t_bytes else 0.0
    return total, "operations" if by_ops >= total / 2 else "bytes"


# ---- the bi-LSTM calls of each unit of work: (n, t, d_in, emit_out, g_out) ----------

def memexqa_lstm_calls(d, m, n: int, a: int) -> list[tuple]:
    """The 9 bi-LSTM calls of one MemexQA forward over n questions of a albums:
    (rows, T, D, out used, fin used) in the order the model runs them."""
    h, de, p = m.hidden_dim, demb(d, m), d.max_photos
    calls = [(n * a * p, d.max_sent_len, de, False, True),
             (n * a, p, de, True, False), (n * a, p, 2 * h, True, False)]
    calls += [(n * a, d.max_album_text_len, de, True, False)] * NUM_TEXTS
    calls += [(n, d.max_question_len, de, True, False),
              (n * 4, d.max_answer_len, de, False, True)]
    return calls


def memexqa_album_calls(d, m, rows: int) -> list[tuple]:
    """The album side's 7 bi-LSTM calls over `rows` album rows (one album a row)."""
    return memexqa_lstm_calls(d, m, rows, 1)[:7]


def memexqa_answer_calls(d, m, n: int) -> list[tuple]:
    """The query side's 2 bi-LSTM calls over n questions."""
    return memexqa_lstm_calls(d, m, n, 1)[7:]


def eval_lstm_calls(d, m, questions: int, album_rows: int, cache_batch: int,
                    eval_batch: int) -> list[tuple]:
    """One evaluation's bi-LSTM calls: the album cache in blocks of cache_batch
    rows, then the answers in batches of eval_batch questions."""
    calls = []
    for start in range(0, album_rows, cache_batch):
        calls += memexqa_album_calls(d, m, min(cache_batch, album_rows - start))
    for _ in range(-(-questions // eval_batch)):
        calls += memexqa_answer_calls(d, m, eval_batch)
    return calls
