"""WordEmbed.full_table, joined from slices, against the gather form it
replaced: WordEmbed.forward over arange(num_rows), which gathers oov_emb for
every row (the frozen rows all map to oov_emb[0]) and keeps the frozen value
with torch.where. Under deterministic algorithms, at MemexQA's and TVQA's
vocabulary layouts, without OOV rows, with fewer vocabulary rows than GloVe
rows, and with num_rows above and below vocab_size:

- the table is the gather form's bit for bit;
- oov_emb's gradient is the gather form's bit for bit when the extended rows
  (>= vocab_size) carry no gradient; when they do, it is the same from run to
  run, and its UNK row (one sum over those rows instead of one add per row)
  within 1e-6 of the sum of the addends' magnitudes;
- no index backward lies between the table and oov_emb;
- FVTAModel's and VideoFVTAModel's parameter gradients equal the gather
  form's bit for bit.

The card test runs the first two checks on CUDA; without a card it skips:

    python -m pytest tests/test_torch_embed_table.py -m gpu --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from fvta_memexqa_torch import bench_lib
from fvta_memexqa_torch import train as tr
from fvta_memexqa_torch import train_video as tv
from fvta_memexqa_torch.config import Config, DataConfig, ModelConfig
from fvta_memexqa_torch.data.tokenize import NUM_SPECIAL, UNK_ID
from fvta_memexqa_torch.data.video_pack import video_shared_tables
from fvta_memexqa_torch.models.embed import WordEmbed
from fvta_memexqa_torch.models.video import VideoInputs, video_loss

# name: (vocab_size, GloVe rows, D, num_rows)
LAYOUTS = {
    "memexqa": (12000, 10000, 100, 12000),
    "memexqa-extended": (12000, 10000, 100, 12345),
    "memexqa-cut-in-oov": (12000, 10000, 100, 11000),
    "memexqa-cut-in-glove": (12000, 10000, 100, 5000),
    "tvqa": (20000, 18000, 300, 20000),
    "tvqa-extended": (20000, 18000, 300, 20450),
    "no-oov": (42, 40, 8, 42),
    "no-oov-extended": (42, 40, 8, 57),
    "vocab-below-boundary": (30, 40, 8, 30),
    "vocab-below-boundary-extended": (30, 40, 8, 35),
}
EXTENDED = [k for k, (v, _, _, n) in LAYOUTS.items() if n > v]


def gather_table(emb: WordEmbed, frozen: torch.Tensor, n: int) -> torch.Tensor:
    """The gather form: forward() over every row id."""
    return emb(torch.arange(n, device=frozen.device), frozen)


@pytest.fixture
def deterministic():
    with tr.deterministic_algorithms(torch.device("cpu")):
        yield


def layout(name: str, device="cpu"):
    v, glove, d, n = LAYOUTS[name]
    gen = torch.Generator().manual_seed(v + glove + d + n)
    emb = WordEmbed(glove, v, d, generator=gen).to(device)
    frozen = torch.randn(v, d, generator=gen).to(device)
    return emb, frozen, n


def upstream(name: str, device="cpu", extended: bool = False) -> torch.Tensor:
    """A seeded gradient of the table, zero on the extended rows unless asked."""
    v, _, d, n = LAYOUTS[name]
    g = torch.randn(n, d, generator=torch.Generator().manual_seed(n * d))
    if not extended:
        g[v:] = 0.0
    return g.to(device)


def oov_grad(table_fn, emb, frozen, n, g) -> torch.Tensor:
    (grad,) = torch.autograd.grad(table_fn(emb, frozen, n), emb.oov_emb, g)
    return grad


def slices(emb, frozen, n):
    return emb.full_table(frozen, n)


def index_nodes_to(out: torch.Tensor, param: torch.Tensor) -> set[str]:
    """Names of the index nodes on the autograd paths from out to param."""
    found, leads = set(), {}

    def reaches(fn) -> bool:
        if fn is None:
            return False
        if fn not in leads:
            leads[fn] = False
            hit = getattr(fn, "variable", None) is param
            hit = any([reaches(nxt) for nxt, _ in fn.next_functions]) or hit
            name = type(fn).__name__
            if hit and ("IndexBackward" in name or "IndexPutBackward" in name):
                found.add(name)
            leads[fn] = hit
        return leads[fn]

    assert reaches(out.grad_fn)
    return found


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_table_is_the_gather_form_bit_for_bit(deterministic, name):
    emb, frozen, n = layout(name)
    got, want = emb.full_table(frozen, n), gather_table(emb, frozen, n)
    assert got.shape == want.shape == (n, frozen.shape[1])
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_oov_grad_is_the_gather_forms_bit_for_bit(deterministic, name):
    emb, frozen, n = layout(name)
    g = upstream(name)
    got = oov_grad(slices, emb, frozen, n, g)
    want = oov_grad(gather_table, emb, frozen, n, g)
    assert torch.equal(got, want)
    assert float(want[0].abs().max()) > 0   # the UNK row's gradient


@pytest.mark.parametrize("name", EXTENDED)
def test_oov_grad_with_extended_gradient_is_close_and_repeatable(deterministic, name):
    emb, frozen, n = layout(name)
    g = upstream(name, extended=True)
    got = oov_grad(slices, emb, frozen, n, g)
    again = oov_grad(slices, emb, frozen, n, g)
    want = oov_grad(gather_table, emb, frozen, n, g)
    assert torch.equal(got, again)
    assert torch.equal(got[1:], want[1:])   # only the UNK row takes a sum
    assert_sum_close(got[0], want[0], g, LAYOUTS[name][0])


def assert_sum_close(got, want, g, v) -> None:
    """The UNK row sums the UNK row's and the extended rows' gradients in
    another order: within 1e-6 of the sum of their magnitudes (near a
    cancellation an elementwise rtol would measure the gather form's own
    rounding)."""
    mag = g[1].abs() + g[v:].abs().sum(0)
    assert bool(((got - want).abs() <= 1e-6 * mag).all())


@pytest.mark.parametrize("name", ["memexqa", "memexqa-extended", "memexqa-cut-in-glove",
                                  "no-oov-extended", "vocab-below-boundary-extended"])
def test_no_index_backward_between_the_table_and_oov_emb(name):
    emb, frozen, n = layout(name)
    assert index_nodes_to(emb.full_table(frozen, n), emb.oov_emb) == set()
    # the walk does see one on the gather form's path
    assert "IndexBackward0" in index_nodes_to(gather_table(emb, frozen, n), emb.oov_emb)


def param_grads(model, loss) -> dict:
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: g for k, g in zip(params, grads) if g is not None}


def assert_same_grads(got: dict, want: dict) -> None:
    assert set(got) == set(want) and "word_embed.oov_emb" in got
    assert [k for k in want if not torch.equal(got[k], want[k])] == []


def with_extended_rows(vocab_chars: torch.Tensor, extra: int, seed: int) -> torch.Tensor:
    """vocab_chars with `extra` eval-time rows appended (real chars, word UNK)."""
    rows = torch.randint(NUM_SPECIAL, int(vocab_chars.max()) + 1,
                         (extra, vocab_chars.shape[1]),
                         generator=torch.Generator().manual_seed(seed), dtype=vocab_chars.dtype)
    return torch.cat([vocab_chars, rows])


def fvta_grads(cfg, shared, batch):
    state = tr.init_state(cfg, "cpu", seed=0)
    loss, _ = tr.loss_and_metrics(state.model, shared, batch, True, state.generator)
    return param_grads(state.model, loss)


def test_fvta_model_gradients_equal_the_gather_forms(deterministic, monkeypatch):
    cfg = Config(data=DataConfig(max_albums=2, max_photos=4, max_question_len=10,
                                 max_answer_len=4, max_sent_len=6, max_album_text_len=8,
                                 max_word_len=8, image_feat_dim=64, word_emb_dim=12,
                                 word_vocab_size=60, char_vocab_size=30, num_glove_words=20),
                 model=ModelConfig(hidden_dim=16, char_emb_dim=8, char_cnn_filters=16))
    shared = bench_lib.synth_shared(cfg, 20, 50, seed=3, device="cpu")
    shared = dataclasses.replace(shared, vocab_chars=with_extended_rows(
        shared.vocab_chars, 7, seed=4))
    shared.album_text_words[:, :, 0] = UNK_ID   # synth_shared draws no UNK
    batch = bench_lib.synth_batch(cfg, 8, 20, seed=5, device="cpu")
    got = fvta_grads(cfg, shared, batch)
    monkeypatch.setattr(WordEmbed, "full_table", gather_table)
    assert_same_grads(got, fvta_grads(cfg, shared, batch))


def video_case(seed: int = 20261018):
    n, t, c = 4, 12, 5
    cfg = Config(data=DataConfig(max_question_len=6, max_answer_len=4, max_word_len=7,
                                 image_feat_dim=64, word_emb_dim=12, word_vocab_size=50,
                                 char_vocab_size=20, num_glove_words=30),
                 model=ModelConfig(hidden_dim=16, char_emb_dim=6, char_cnn_filters=10,
                                   char_cnn_width=3))
    d = cfg.data
    rng = np.random.default_rng(seed)
    chars = rng.integers(2, d.char_vocab_size, (d.word_vocab_size, d.max_word_len))
    tables = {"word_emb_init": rng.normal(0, 0.5, (d.word_vocab_size, d.word_emb_dim)
                                          ).astype(np.float32),
              "vocab_chars": chars.astype(np.int32)}
    shared = video_shared_tables(d, tables, "cpu")
    shared = dataclasses.replace(shared, vocab_chars=with_extended_rows(
        shared.vocab_chars, 6, seed=seed + 1))
    qw = rng.integers(0, d.word_vocab_size, (n, d.max_question_len))
    cw = rng.integers(0, d.word_vocab_size, (n, c, d.max_answer_len))
    fm = np.arange(t) < rng.integers(t // 2, t + 1, (n,))[:, None]
    arrays = dict(frame_feats=np.maximum(rng.normal(0, 1, (n, t, d.image_feat_dim)), 0)
                  * fm[..., None],
                  frame_mask=fm, q_words=qw, q_chars=chars[qw], q_mask=qw > 0,
                  choice_words=cw, choice_chars=chars[cw], choice_mask=cw > 0,
                  label=rng.integers(0, c, n), ex_mask=np.ones(n, bool))
    dtypes = {np.dtype(np.float64): torch.float32, np.dtype(np.int64): torch.int32}
    vi = VideoInputs(**{k: torch.from_numpy(a).to(dtypes.get(a.dtype, torch.bool))
                        for k, a in arrays.items()})
    run = {"task": "mc", "encoder": "bilstm", "num_choices": c, "num_answers": 0,
           "max_frames": t}
    return cfg, run, shared, vi


def video_grads(cfg, run, shared, vi):
    state = tv.init_video_state(cfg, run, "cpu", seed=1)
    loss, _ = video_loss(state.model, shared, vi, True, state.generator)
    return param_grads(state.model, loss)


def test_video_model_gradients_equal_the_gather_forms(deterministic, monkeypatch):
    case = video_case()
    got = video_grads(*case)
    monkeypatch.setattr(WordEmbed, "full_table", gather_table)
    assert_same_grads(got, video_grads(*case))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["memexqa", "memexqa-extended", "tvqa"])
def test_table_and_oov_grad_are_the_gather_forms_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    with tr.deterministic_algorithms(dev):
        emb, frozen, n = layout(name, dev)
        assert torch.equal(emb.full_table(frozen, n), gather_table(emb, frozen, n))
        g = upstream(name, dev)
        want = oov_grad(gather_table, emb, frozen, n, g)
        assert torch.equal(oov_grad(slices, emb, frozen, n, g), want)
        if n > LAYOUTS[name][0]:
            g = upstream(name, dev, extended=True)
            got, want = (oov_grad(f, emb, frozen, n, g) for f in (slices, gather_table))
            assert torch.equal(got, oov_grad(slices, emb, frozen, n, g))
            assert torch.equal(got[1:], want[1:])
            assert_sum_close(got[0], want[0], g, LAYOUTS[name][0])
