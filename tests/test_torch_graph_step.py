"""The train step replayed from a CUDA graph (train.StepGraph) against the same
step run eagerly, on the card. Imports neither JAX nor the JAX package, so it
runs on a CUDA machine without JAX:

    python -m pytest tests/test_torch_graph_step.py -m gpu --noconftest -q

Without a card every test skips inside the test. On a small configuration
and at the benchmark's shapes (MemexQA v1.1 widths at batch 64 and 256):
five graphed steps against five eager steps from the same state, parameters,
moments, counters, losses and the dropout generator bit for bit; earlier
steps' losses unchanged by later replays; the bi-LSTM kernels' launch
counters equal; a replaced optimizer state makes one eager step and one new
capture; and a killed `train` run resumes bit-identically on the card.
"""

import copy
import os

import pytest
import torch

from fvta_memexqa_torch import bench_lib
from fvta_memexqa_torch import train as tr
from fvta_memexqa_torch.checkpoint import CheckpointManager
from fvta_memexqa_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from fvta_memexqa_torch.data import load_pack, make_synthetic, pack
from fvta_memexqa_torch.ops import lstm_fused
from fvta_memexqa_torch.optim import Optimizer, state_to

LSTM_COUNTERS = ("lstm_proj", "lstm_rec", "lstm_rec_bwd")
STEPS = 5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    return torch.device("cuda")


def small_config() -> Config:
    return Config(data=DataConfig(max_albums=2, max_photos=4, max_question_len=10,
                                  max_answer_len=4, max_sent_len=6, max_album_text_len=8,
                                  max_word_len=8, image_feat_dim=64, word_emb_dim=100,
                                  word_vocab_size=60, char_vocab_size=30,
                                  num_glove_words=20),
                  model=ModelConfig(hidden_dim=16, char_emb_dim=8, char_cnn_filters=16))


CASES = {"small-b8": (small_config(), 8, 20, 50),
         "v1.1-b64": (bench_lib.realistic_config(), 64, 630, 5090),
         "v1.1-b256": (bench_lib.realistic_config(), 256, 630, 5090)}


def lstm_counts() -> dict:
    return {k: getattr(lstm_fused, k).launches for k in LSTM_COUNTERS}


def path_counts() -> dict:
    return {k: getattr(tr.train_step, k) for k in ("eager_steps", "graph_captures",
                                                   "graph_replays")}


def delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


def setup(case, dev):
    cfg, bs, albums, photos = CASES[case]
    shared = bench_lib.synth_shared(cfg, albums, photos, seed=3, device=dev)
    batches = [bench_lib.synth_batch(cfg, bs, albums, seed=10 + i, device=dev)
               for i in range(STEPS)]
    return cfg, shared, batches


def run(step, cfg, shared, batches, dev):
    """STEPS steps of `step` from seed 0's state: (state, losses as returned,
    their values read right after each step, launch and path counter moves)."""
    state = tr.init_state(cfg, dev, seed=0)
    opt = Optimizer(cfg.train)
    losses, read = [], []
    lstm0, path0 = lstm_counts(), path_counts()
    for b in batches:
        out = step(state, opt, shared, b)
        losses.append(out["loss"])
        read.append(out["loss"].clone())
        torch.cuda.synchronize(dev)
    return state, losses, read, delta(lstm0, lstm_counts()), delta(path0, path_counts())


def assert_same_state(a: tr.TrainState, b: tr.TrainState) -> None:
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    assert [n for n in pa if not torch.equal(pa[n], pb[n])] == []
    for group in ("mu", "nu"):
        ga, gb = a.opt_state[group], b.opt_state[group]
        assert [n for n in ga if not torch.equal(ga[n], gb[n])] == [], group
    assert int(a.opt_state["count"]) == int(b.opt_state["count"]) == a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_graphed_steps_are_the_eager_steps_bit_for_bit(cuda, case):
    cfg, shared, batches = setup(case, cuda)
    with tr.deterministic_algorithms(cuda):
        eager = run(tr.eager_step, cfg, shared, batches, cuda)
        graphed = run(tr.train_step, cfg, shared, batches, cuda)
    (sa, la, _, lstm_a, path_a), (sb, lb, read_b, lstm_b, path_b) = eager, graphed
    assert path_a == {"eager_steps": STEPS, "graph_captures": 0, "graph_replays": 0}
    assert path_b == {"eager_steps": 1, "graph_captures": 1, "graph_replays": STEPS - 1}
    assert_same_state(sa, sb)
    assert [float(x) for x in la] == [float(x) for x in lb]
    # the returned losses are new tensors: later replays leave earlier ones be
    assert all(torch.equal(x, y) for x, y in zip(lb, read_b))
    assert len({x.data_ptr() for x in lb}) == STEPS
    # each replay counts the launches the capture recorded, the capture none
    assert lstm_a == lstm_b and lstm_a["lstm_rec_bwd"] == 9 * STEPS


@pytest.mark.gpu
def test_moments_keep_their_tensors_across_graphed_steps(cuda):
    cfg, shared, batches = setup("small-b8", cuda)
    state = tr.init_state(cfg, cuda, seed=0)
    ids = {g: {n: id(t) for n, t in state.opt_state[g].items()} for g in ("mu", "nu")}
    opt = Optimizer(cfg.train)
    with tr.deterministic_algorithms(cuda):
        for b in batches:
            tr.train_step(state, opt, shared, b)
    assert {g: {n: id(t) for n, t in state.opt_state[g].items()}
            for g in ("mu", "nu")} == ids


@pytest.mark.gpu
def test_a_replaced_optimizer_state_makes_one_eager_step_and_one_capture(cuda):
    cfg, shared, batches = setup("small-b8", cuda)
    state = tr.init_state(cfg, cuda, seed=0)
    opt = Optimizer(cfg.train)
    with tr.deterministic_algorithms(cuda):
        for b in batches[:3]:
            tr.train_step(state, opt, shared, b)
        twin = tr.TrainState(model=copy.deepcopy(state.model),
                             opt_state=copy.deepcopy(state.opt_state), step=state.step,
                             generator=torch.Generator(device=cuda))
        twin.generator.set_state(state.generator.get_state())
        # a resume: the same values in new tensors (checkpoint.restore's state_to)
        state.opt_state = state_to(copy.deepcopy(state_to(state.opt_state, "cpu")), cuda)
        before = path_counts()
        for b in batches[3:]:
            tr.train_step(state, opt, shared, b)
            tr.eager_step(twin, opt, shared, b)
        torch.cuda.synchronize(cuda)
    moved = delta(before, path_counts())
    assert moved == {"eager_steps": 1 + 2, "graph_captures": 1, "graph_replays": 1}
    assert_same_state(state, twin)


def small_pack(workdir: str):
    out = os.path.join(workdir, "pack")
    qas, albums, feats, test_ids, glove = make_synthetic(seed=0)
    pack(qas, albums, feats, test_ids, glove, out,
         DataConfig(max_albums=2, max_photos=4, max_question_len=10, max_answer_len=4,
                    max_sent_len=6, max_album_text_len=8, max_word_len=8,
                    image_feat_dim=64, word_emb_dim=100), seed=0)
    return load_pack(out)


class _Killed(Exception):
    pass


@pytest.mark.gpu
@pytest.mark.parametrize("kill_at", [3, 6])
def test_killed_run_resumes_bit_identically_on_the_card(cuda, tmp_path, monkeypatch, kill_at):
    """tests/test_torch_train.py's killed run on the card, where the steps run
    from the graph: 8 steps straight vs a run killed during step kill_at+1 and
    resumed (a new state: one eager step, then a new capture)."""
    packed = small_pack(str(tmp_path))
    cfg = Config(data=packed.cfg, model=ModelConfig(hidden_dim=16, char_emb_dim=8,
                                                    char_cnn_filters=16),
                 train=TrainConfig(batch_size=4, save_period=1, keep_checkpoints=20,
                                   val_period=5, log_period=2))
    before = path_counts()
    tr.train(cfg, packed, str(tmp_path / "straight"), num_steps=8, echo=False, device="cuda")
    assert delta(before, path_counts()) == {"eager_steps": 1, "graph_captures": 1,
                                            "graph_replays": 7}
    real_step = tr.train_step

    def dying_step(state, *a):
        if state.step == kill_at:
            raise _Killed()
        return real_step(state, *a)

    monkeypatch.setattr(tr, "train_step", dying_step)
    with pytest.raises(_Killed):
        tr.train(cfg, packed, str(tmp_path / "resumed"), num_steps=8, echo=False,
                 device="cuda")
    assert CheckpointManager(str(tmp_path / "resumed")).latest_step() == kill_at
    monkeypatch.setattr(tr, "train_step", real_step)
    tr.train(cfg, packed, str(tmp_path / "resumed"), num_steps=8, echo=False, device="cuda")
    sa, sb = tr.init_state(cfg, cuda, seed=1), tr.init_state(cfg, cuda, seed=2)
    CheckpointManager(str(tmp_path / "straight")).restore(sa, step=8)
    CheckpointManager(str(tmp_path / "resumed")).restore(sb, step=8)
    assert_same_state(sa, sb)
