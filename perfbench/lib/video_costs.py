"""FLOPs and bytes of the video train step (fvta_memexqa_torch/models/video.py
VideoFVTAModel, temporal_encoder "bilstm", task "mc") from shapes, on the
layer and kernel counts of lib/costs.py.

Every sequence is counted at its expected valid length (the mean of the
configuration's uniform length range: frames, question words, choice words),
not at its padded one: positions past a row's length are masked work that the
inputs do not need. Over the ten traced steps' 1280 rows the mean lies within
~0.3 % of the expectation. The vocabulary table is counted whole (every row
is computed a step).

`d` and `m` are a configuration's "data" and "model" sections as attributes,
`v` its "video" section (a dict).
"""

from __future__ import annotations

from perfbench.lib import costs


def mean_lengths(d, v) -> tuple[float, float, float]:
    """(frames, question words, choice words) a row, expected."""
    return ((v["min_frames"] + v["max_frames"]) / 2,
            (v["min_question_len"] + d.max_question_len) / 2,
            (v["min_answer_len"] + d.max_answer_len) / 2)


def step_cost(d, m, v, n: int, params: int) -> dict:
    """One train step over n questions: the vocabulary table, the frame
    projection (its input takes no gradient), the three bi-LSTMs, the
    attention at S = 1, the scorer, their backward, Adam over `params`."""
    h, de, c = m.hidden_dim, costs.demb(d, m), v["num_choices"]
    t, jq, ja = mean_lengths(d, v)
    layers = {
        "char_cnn_vocab": costs._char_cnn(d.word_vocab_size, d, m),
        "highway_vocab": costs._highway(d.word_vocab_size, de),
        "frame_proj": costs._dense(n * t, d.image_feat_dim, de, input_grad=False),
        "embed_gathers": costs._gather(n * jq + n * c * ja, de),
        "bilstm_frames": costs._bilstm(n, t, de, h),
        "bilstm_question": costs._bilstm(n, jq, de, h),
        "bilstm_choices": costs._bilstm(n * c, ja, de, h, True),
        "attention": costs._attention(n, 1, t, jq, 2 * h),
        "scorer": costs._dense(n * c, 10 * h, 1),
    }
    return costs._sum(layers, True, params)


def lstm_calls(d, m, v, n: int) -> list[tuple]:
    """The step's 3 bi-LSTM calls in the order the model runs them: (rows, T,
    D, out used, fin used) with T the expected valid length."""
    de, c = costs.demb(d, m), v["num_choices"]
    t, jq, ja = mean_lengths(d, v)
    return [(n, t, de, True, False), (n, jq, de, True, False), (n * c, ja, de, False, True)]


def lstm_work(d, m, v, n: int) -> list[tuple[float, float]]:
    """(flops, bytes) of each K1 (projection, recurrence under grad) and K1b
    call of one train step."""
    h = m.hidden_dim
    work = []
    for rows, t, d_in, out_used, _ in lstm_calls(d, m, v, n):
        work += [costs.k1_proj(rows, t, d_in, h), costs.k1_rec(rows, t, h, True, True),
                 costs.k1b(rows, t, h, out_used)]
    return work


def k2_work(d, m, v, n: int) -> tuple[float, float]:
    """(flops, bytes) of the step's one K2 call: S = 1, the valid frames and
    question words."""
    t, jq, _ = mean_lengths(d, v)
    return costs.k2(n, 1, t, jq, 2 * m.hidden_dim, t)
