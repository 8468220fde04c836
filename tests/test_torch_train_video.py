"""The port's video training slice on the CPU: the video pack (pack_video) equal
to the JAX package's array for array for each task, the streaming batch order
equal to the JAX loader's, and the driver contract of train_video (the loss
falls, keep-best and run-dir evaluation, bitwise resume of a killed run,
video-test with the attention dump's schema, the count task's score), the
four video CLI commands end to end, and `video --cp 2` on two CPU ranks
against one."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from fvta_memexqa_tpu.config import DataConfig as JDataConfig
from fvta_memexqa_tpu.data import video_pack as jvp

from fvta_memexqa_torch import cli
from fvta_memexqa_torch import train_video as tv
from fvta_memexqa_torch.checkpoint import CheckpointManager
from fvta_memexqa_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from fvta_memexqa_torch.data import video_pack as vp
from fvta_memexqa_torch.data.stream import Prefetcher


def small_data() -> dict:
    return dict(max_question_len=8, max_answer_len=3, max_word_len=6, word_emb_dim=16)


def small_cfg(**train_kw) -> Config:
    """The JAX suite's small_cfg (tests/test_train_video.py)."""
    kw = dict(batch_size=4, eval_batch_size=4, learning_rate=2e-3, val_period=1000,
              save_period=1000, log_period=100, seed=3)
    kw.update(train_kw)
    return Config(data=DataConfig(**small_data()),
                  model=ModelConfig(hidden_dim=8, char_emb_dim=4, char_cnn_filters=8,
                                    keep_prob=1.0, vocab_embed=True),
                  train=TrainConfig(**kw))


def make_pack(out, task="mc", num_videos=40, feat_dim=32, seed=0):
    qas, feats, test_ids = vp.make_synthetic_video_raw(num_videos=num_videos, num_frames=16,
                                                       feat_dim=feat_dim, seed=seed, task=task)
    vp.pack_video(qas, feats, test_ids, None, out, DataConfig(**small_data()), max_frames=16,
                  shard_size=7, task=task)
    return out


@pytest.fixture(scope="module")
def video_pack(tmp_path_factory):
    return make_pack(str(tmp_path_factory.mktemp("vpack")))


@pytest.fixture(scope="module")
def count_pack(tmp_path_factory):
    return make_pack(str(tmp_path_factory.mktemp("vcount")), task="count", num_videos=24,
                     feat_dim=16, seed=1)


@pytest.mark.parametrize("task", ["mc", "count", "frameqa"])
def test_pack_video_equals_jax(tmp_path, task):
    raw = vp.make_synthetic_video_raw(num_videos=20, num_frames=12, feat_dim=8, seed=4, task=task)
    j_raw = jvp.make_synthetic_video_raw(num_videos=20, num_frames=12, feat_dim=8, seed=4,
                                         task=task)
    assert raw[0] == j_raw[0] and raw[2] == j_raw[2]
    for k in raw[1]:
        np.testing.assert_array_equal(raw[1][k], j_raw[1][k])
    mine, ref = str(tmp_path / "mine"), str(tmp_path / "ref")
    vp.write_raw_video_files(str(tmp_path / "raw"), *raw)
    qas, errs = vp.parse_video_qas(str(tmp_path / "raw" / "qas.jsonl"), task=task)
    j_qas, j_errs = jvp.parse_video_qas(str(tmp_path / "raw" / "qas.jsonl"), task=task)
    assert qas == j_qas and errs == j_errs == []
    meta = vp.pack_video(qas, raw[1], raw[2], None, mine, DataConfig(**small_data()),
                         max_frames=10, shard_size=6, task=task)
    j_meta = jvp.pack_video(j_qas, j_raw[1], j_raw[2], None, ref, JDataConfig(**small_data()),
                            max_frames=10, shard_size=6, task=task)
    assert meta == j_meta
    assert sorted(os.listdir(mine)) == sorted(os.listdir(ref))
    for f in sorted(os.listdir(ref)):
        if f.endswith(".npz"):
            a, b = np.load(os.path.join(mine, f)), np.load(os.path.join(ref, f))
            assert a.files == b.files
            for k in b.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f}:{k}")
        else:
            assert open(os.path.join(mine, f)).read() == open(os.path.join(ref, f)).read()


def test_stream_order_matches_jax(video_pack):
    mine = list(vp.VideoDataset(video_pack, "train").get_batches(5, shuffle=True, seed=3,
                                                                 epoch=2))
    ref = list(jvp.VideoDataset(video_pack, "train").get_batches(5, shuffle=True, seed=3,
                                                                  epoch=2))
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        for k in ("frame_feats", "frame_mask", "q_words", "label", "ex_mask"):
            np.testing.assert_array_equal(getattr(a, k).numpy(), np.asarray(getattr(b, k)))
    ds = vp.VideoDataset(video_pack, "train")
    assert list(ds.qids) == list(jvp.VideoDataset(video_pack, "train").qids)


def test_train_video_loss_falls(video_pack, tmp_path):
    out = str(tmp_path / "run")
    tv.train_video(small_cfg(log_period=1), video_pack, out, num_steps=24, echo=False,
                   metrics_path=os.path.join(out, "metrics.jsonl"), device="cpu")
    losses = [r["loss"] for r in map(json.loads, open(os.path.join(out, "metrics.jsonl")))
              if r["event"] == "train"]
    assert len(losses) == 24 and all(np.isfinite(losses))
    assert np.mean(losses[-8:]) < np.mean(losses[:8])


def test_keep_best_and_run_dir_eval(video_pack, tmp_path):
    out = str(tmp_path / "run")
    r = tv.train_video(small_cfg(val_period=4, log_period=4), video_pack, out, num_steps=8,
                       echo=False, metrics_path=os.path.join(out, "metrics.jsonl"),
                       device="cpu")
    assert r["best_val_score"] > -np.inf and r["steps"] == 8
    assert {"config.json", "video_run.json", "params.pt"} <= set(os.listdir(out))
    ckpt = CheckpointManager(out)
    best = ckpt.load(best=True)
    assert ckpt.best_step() in (4, 8) and best["val_acc"] == pytest.approx(r["best_val_score"])
    m = tv.test_video(out, split="test", echo=False, device="cpu")
    assert 0.0 <= m["acc"] <= 1.0 and m["count"] == 10
    m_latest = tv.test_video(out, split="test", load_best=False, echo=False, device="cpu")
    assert 0.0 <= m_latest["acc"] <= 1.0
    events = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert {"train", "val"} <= {e["event"] for e in events}
    train_ev = next(e for e in events if e["event"] == "train")
    assert {"loss", "acc", "qa_pairs_per_sec", "p50_step_ms"} <= set(train_ev)


class _Killed(Exception):
    pass


@pytest.mark.parametrize("prefetch", [0, 2])
def test_killed_run_resumes_bit_identically(video_pack, tmp_path, monkeypatch, prefetch):
    """8 steps straight vs a run killed during step 6 (checkpoints every step)
    and resumed to 8, with dropout on; the train split of 27 makes 7 batches of
    4 per epoch, so the resumed stream restarts mid-epoch 0."""
    cfg = small_cfg(save_period=1, keep_checkpoints=20)
    cfg = cfg.replace(model=ModelConfig(hidden_dim=8, char_emb_dim=4, char_cnn_filters=8,
                                        keep_prob=0.9))
    run = lambda out: tv.train_video(cfg, video_pack, str(tmp_path / out), num_steps=8,
                                     echo=False, prefetch=prefetch, device="cpu")
    run("straight")
    real = tv.video_train_step

    def dying(state, *a):
        if state.step == 5:
            raise _Killed()
        return real(state, *a)

    monkeypatch.setattr(tv, "video_train_step", dying)
    with pytest.raises(_Killed):
        run("resumed")
    assert CheckpointManager(str(tmp_path / "resumed")).latest_step() == 5
    monkeypatch.setattr(tv, "video_train_step", real)
    run("resumed")
    a = CheckpointManager(str(tmp_path / "straight")).load(step=8)
    b = CheckpointManager(str(tmp_path / "resumed")).load(step=8)
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    for field, v in a["opt_state"].items():
        for k, t in (v.items() if isinstance(v, dict) else [("", v)]):
            other = b["opt_state"][field][k] if isinstance(v, dict) else b["opt_state"][field]
            assert torch.equal(t, other), (field, k)
    assert torch.equal(a["rng"], b["rng"])


def test_attention_dump_schema(video_pack, tmp_path):
    out = str(tmp_path / "adump")
    tv.train_video(small_cfg(), video_pack, out, num_steps=2, echo=False, device="cpu")
    path = os.path.join(out, "attn.npz")
    m = tv.test_video(out, split="test", echo=False, attention_path=path, device="cpu")
    z = np.load(path, allow_pickle=True)
    n = m["count"]
    assert list(z["seq_names"]) == ["frames"]
    assert z["time_attn"].shape[:2] == (n, 1) and z["seq_attn"].shape == (n, 1)
    assert z["probs"].shape[0] == n and len(z["qid"]) == n
    np.testing.assert_allclose(z["seq_attn"], 1.0, atol=1e-6)      # S = 1
    np.testing.assert_allclose(z["time_attn"].sum(-1), 1.0, atol=1e-5)


def test_count_task_driver_and_score(count_pack, tmp_path):
    out = str(tmp_path / "cnt")
    r = tv.train_video(small_cfg(val_period=4), count_pack, out, num_steps=6, echo=False,
                       device="cpu")
    assert r["task"] == "count" and r["best_val_score"] <= 0.0
    m = tv.test_video(out, split="test", echo=False, device="cpu")
    assert m["mse"] >= 0.0 and m["score"] == -m["mse"] and 0.0 <= m["acc"] <= 1.0


def test_empty_train_split_raises(tmp_path):
    qas, feats, _ = vp.make_synthetic_video_raw(num_videos=8, num_frames=8, feat_dim=8, seed=2)
    out = str(tmp_path / "allp")
    vp.pack_video(qas, feats, {q["qa_id"] for q in qas}, None, out, DataConfig(**small_data()),
                  max_frames=8, shard_size=4)
    with pytest.raises(ValueError, match="train split is empty"):
        tv.train_video(small_cfg(), out, str(tmp_path / "r"), num_steps=1, echo=False,
                       device="cpu")


def run_cli(argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_synth_prepro_video_and_video_test(tmp_path):
    raw, pack, run = (str(tmp_path / d) for d in ("raw", "pack", "run"))
    res = run_cli(["synth-video", raw, "--num-videos", "24", "--num-frames", "16",
                   "--feat-dim", "16"])
    assert res["videos"] == 24 and res["test"] == 6
    res = run_cli(["video-prepro", os.path.join(raw, "qas.jsonl"),
                   os.path.join(raw, "frame_feats.npz"), pack, "--test-ids",
                   os.path.join(raw, "test_qa.ids"), "--max-frames", "16", "--shard-size", "5",
                   "--max-question-len", "8", "--max-answer-len", "3", "--max-word-len", "6",
                   "--word-emb-dim", "16"])
    assert res["splits"]["test"] == 6 and res["max_frames"] == 16
    res = run_cli(["video", "--data", pack, "--out", run, "--steps", "4", "--batch-size", "4",
                   "--hidden-dim", "8", "--val-period", "2", "--log-period", "2",
                   "--device", "cpu"])
    assert res["steps"] == 4 and res["test_count"] == 6 and 0.0 <= res["heldout_acc"] <= 1.0
    res = run_cli(["video-test", run, "--split", "val", "--device", "cpu"])
    assert res["split"] == "val" and 0.0 <= res["acc"] <= 1.0
    res = run_cli(["video", "--steps", "2", "--num-videos", "8", "--num-frames", "8",
                   "--hidden-dim", "8", "--task", "count", "--device", "cpu"])
    assert res["task"] == "count" and res["heldout_mse"] >= 0.0


def test_cli_video_context_parallel_matches_one_rank(video_pack, tmp_path):
    """`video --data --out --cp 2` (2 CPU ranks) against --cp 1: the same steps,
    step-1 loss (up to the combine's order) and test count; the run records
    its cp; a frame count that does not divide raises."""
    res, losses = {}, {}
    for cp in (1, 2):
        out = str(tmp_path / f"cp{cp}")
        res[cp] = run_cli(["video", "--data", video_pack, "--out", out, "--steps", "2",
                           "--batch-size", "4", "--hidden-dim", "8", "--val-period", "2",
                           "--log-period", "1", "--cp", str(cp), "--device", "cpu"])
        losses[cp] = [e["loss"] for e in map(json.loads, open(os.path.join(out, "metrics.jsonl")))
                      if e["event"] == "train"]
        assert json.load(open(os.path.join(out, "video_run.json")))["cp"] == cp
    assert res[2]["steps"] == res[1]["steps"] == 2
    assert res[2]["test_count"] == res[1]["test_count"]
    assert losses[2][0] == pytest.approx(losses[1][0], rel=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        tv.train_video(small_cfg(), video_pack, str(tmp_path / "r3"), num_steps=1, cp=3,
                       device="cpu")


def test_prefetcher_reraises_and_closes():
    def items():
        yield 1
        raise RuntimeError("boom")

    it = Prefetcher(items(), depth=1)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)
    with Prefetcher(iter(range(100)), depth=2, transfer=lambda x: x * 2) as p:
        assert [next(p) for _ in range(3)] == [0, 2, 4]
