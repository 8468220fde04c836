"""The port's loader (`cli train --stream-shard-size / --prefetch / --profile`)
on the CPU: the shard files and their index against the JAX package's, file for
file, and each package's StreamingDataset over the other's shards; the port's
training with prefetch against the same run inline, bit for bit (with and
without album dedup); a streamed, prefetched run killed mid-epoch and resumed,
bit for bit; the prefetch worker stopped after an early stop; the profile
window; and the streamed training's loss sequence against the JAX package's
train(datasets=...) from the same initial weights."""

import json
import os
import shutil
import unittest.mock

import jax
import numpy as np
import pytest
import torch

from fvta_memexqa_tpu import train as j_train
from fvta_memexqa_tpu.config import ModelConfig as JModelConfig
from fvta_memexqa_tpu.config import TrainConfig as JTrainConfig
from fvta_memexqa_tpu.data import SharedTables as JSharedTables
from fvta_memexqa_tpu.data import stream as j_stream
from fvta_memexqa_tpu.data.device_prepro import device_put_batch
from fvta_memexqa_tpu.models import FVTAModel as JFVTAModel

from test_torch_train import _Killed, _params_and_opt, port_config

from fvta_memexqa_torch import cli
from fvta_memexqa_torch import train as tr
from fvta_memexqa_torch.checkpoint import CheckpointManager
from fvta_memexqa_torch.config import TrainConfig
from fvta_memexqa_torch.convert import state_dict_from_flax
from fvta_memexqa_torch.data import SharedTables
from fvta_memexqa_torch.data import stream
from fvta_memexqa_torch.data.pack import load_pack
from fvta_memexqa_torch.data.pipeline import Dataset

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


def copy_pack(pack_dir: str, dest) -> str:
    """A copy of the pack whose split files keep their size and mtime_ns
    (shutil.copy2), so both packages' fingerprints of it are equal."""
    dest = str(dest)
    shutil.copytree(pack_dir, dest, copy_function=shutil.copy2,
                    ignore=shutil.ignore_patterns("*.shard-*", "*.shards.json"))
    return dest


def shard_files(pack: str) -> list[str]:
    return sorted(f for f in os.listdir(pack) if ".shard" in f)


def read_json(path):
    with open(path) as f:
        return json.load(f)


# ---- the shard writers vs the JAX package's ------------------------------------------

@pytest.mark.parametrize("split,shard_size", [("train", 5), ("train", 16), ("train", 64),
                                              ("val", 1), ("test", 4)])
def test_shards_and_index_equal_jax(pack_dir, tmp_path, split, shard_size):
    mine, ref = copy_pack(pack_dir, tmp_path / "port"), copy_pack(pack_dir, tmp_path / "jax")
    n = stream.write_split_shards(mine, split, shard_size)
    assert n == j_stream.write_split_shards(ref, split, shard_size)
    assert shard_files(mine) == shard_files(ref)
    for f in shard_files(mine):
        if f.endswith(".json"):
            with open(os.path.join(mine, f), "rb") as a, open(os.path.join(ref, f), "rb") as b:
                assert a.read() == b.read(), f
            continue
        with np.load(os.path.join(mine, f)) as a, np.load(os.path.join(ref, f)) as b:
            assert a.files == b.files
            for k in a.files:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (f, k)
    index = read_json(os.path.join(mine, f"data_{split}.shards.json"))
    st = os.stat(os.path.join(mine, f"data_{split}.npz"))
    assert list(index) == ["shard_size", "sizes", "total", "source"]
    assert index["source"] == [st.st_size, st.st_mtime_ns]
    assert sum(index["sizes"]) == index["total"]


def test_ensure_split_shards_skips_only_a_matching_index(pack_dir, tmp_path):
    pack = copy_pack(pack_dir, tmp_path / "pack")
    assert stream.ensure_split_shards(pack, "train", 5) == 4
    stamps = {f: os.stat(os.path.join(pack, f)).st_mtime_ns for f in shard_files(pack)}
    assert stream.ensure_split_shards(pack, "train", 5) == 4        # nothing rewritten
    assert {f: os.stat(os.path.join(pack, f)).st_mtime_ns for f in shard_files(pack)} == stamps
    # a JAX-written matching index is reused too (same fingerprint of the same file)
    assert j_stream.ensure_split_shards(pack, "train", 5) == 4
    assert {f: os.stat(os.path.join(pack, f)).st_mtime_ns for f in shard_files(pack)} == stamps
    assert stream.ensure_split_shards(pack, "train", 8) == 2         # another size rewrites
    assert read_json(os.path.join(pack, "data_train.shards.json"))["shard_size"] == 8


def test_ensure_split_shards_invalidated_by_a_rewritten_pack(pack_dir, tmp_path):
    pack = copy_pack(pack_dir, tmp_path / "pack")
    stream.ensure_split_shards(pack, "train", 5)
    src = os.path.join(pack, "data_train.npz")
    with np.load(src) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["label"] = (arrays["label"] + 1) % 4            # prepro re-run: new contents
    np.savez(src, **arrays)
    st = os.stat(src)
    os.utime(src, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    stream.ensure_split_shards(pack, "train", 5)
    labels = np.concatenate([b.label.numpy()[b.ex_mask.numpy()] for b in
                             stream.StreamingDataset(pack, "train").get_batches(5)])
    assert np.array_equal(labels, arrays["label"])


def _batches(ds, epoch, shuffle=True, bs=3):
    return [{k: np.asarray(v) for k, v in b.__dict__.items()}
            for b in ds.get_batches(bs, shuffle=shuffle, seed=7, epoch=epoch)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_streaming_datasets_read_each_others_shards(pack_dir, tmp_path, writer):
    pack = copy_pack(pack_dir, tmp_path / "pack")
    (j_stream if writer == "jax" else stream).write_split_shards(pack, "train", 5)
    mine, ref = stream.StreamingDataset(pack, "train"), j_stream.StreamingDataset(pack, "train")
    assert mine.n == ref.n and mine.num_batches(3) == ref.num_batches(3)
    assert np.array_equal(mine.qids, ref.qids)
    for epoch, shuffle in ((0, False), (0, True), (1, True)):
        a, b = _batches(mine, epoch, shuffle), _batches(ref, epoch, shuffle)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert set(x) == set(y)
            for k in x:
                assert np.array_equal(x[k], y[k]), (epoch, k)


# ---- the port's training with the loader ----------------------------------------------

def loader_cfg(small_config, **train):
    return port_config(small_config).replace(train=TrainConfig(
        batch_size=4, eval_batch_size=4, log_period=1, val_period=3, save_period=1,
        keep_checkpoints=20, **train))


def assert_same_run(a_dir, b_dir, step):
    a, rng_a = _params_and_opt(a_dir, step)
    b, rng_b = _params_and_opt(b_dir, step)
    assert set(a) == set(b)
    assert [k for k in a if not torch.equal(a[k], b[k])] == []
    assert torch.equal(rng_a, rng_b)
    va, vb = ([(r["step"], r["acc"], r["loss"]) for r in metrics(d) if r["event"] == "val"]
              for d in (a_dir, b_dir))
    assert va == vb and va


def metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("dedup", [False, True])
def test_prefetch_gives_the_inline_run_bit_for_bit(packed_synth, small_config, tmp_path,
                                                   dedup):
    cfg = loader_cfg(small_config, dedup_albums=dedup)
    for depth in (0, 2):
        d = str(tmp_path / f"p{depth}")
        tr.train(cfg, packed_synth, d, num_steps=6, metrics_path=os.path.join(d, "metrics.jsonl"),
                 echo=False, prefetch=depth, device="cpu")
    assert_same_run(str(tmp_path / "p0"), str(tmp_path / "p2"), 6)


def streamed(pack):
    return (stream.StreamingDataset(pack, "train"), stream.StreamingDataset(pack, "val"))


def test_streamed_prefetched_run_killed_mid_epoch_resumes_bit_identically(
        pack_dir, small_config, tmp_path, monkeypatch):
    """8 steps straight vs a run killed during step 7 (16 train examples in
    batches of 4: it resumes at batch 2 of epoch 1) and resumed to 8, both
    streamed from 5-row shards with prefetch 2 and dropout on."""
    pack = copy_pack(pack_dir, tmp_path / "pack")
    for split in ("train", "val"):
        stream.ensure_split_shards(pack, split, 5)
    packed = load_pack(pack, load_splits=False)
    cfg = loader_cfg(small_config)
    straight, resumed = str(tmp_path / "straight"), str(tmp_path / "resumed")
    tr.train(cfg, packed, straight, num_steps=8, echo=False, datasets=streamed(pack),
             prefetch=2, device="cpu")
    real_step = tr.train_step

    def dying_step(state, *a):
        if state.step == 6:
            raise _Killed()
        return real_step(state, *a)

    monkeypatch.setattr(tr, "train_step", dying_step)
    with pytest.raises(_Killed):
        tr.train(cfg, packed, resumed, num_steps=8, echo=False, datasets=streamed(pack),
                 prefetch=2, device="cpu")
    assert CheckpointManager(resumed).latest_step() == 6
    monkeypatch.setattr(tr, "train_step", real_step)
    tr.train(cfg, packed, resumed, num_steps=8, echo=False, datasets=streamed(pack),
             prefetch=2, device="cpu")
    a, rng_a = _params_and_opt(straight, 8)
    b, rng_b = _params_and_opt(resumed, 8)
    assert [k for k in a if not torch.equal(a[k], b[k])] == [] and set(a) == set(b)
    assert torch.equal(rng_a, rng_b)


def test_streamed_run_consumes_the_jax_stream(pack_dir, small_config, tmp_path):
    """The batches a streamed, prefetched run steps on, across an epoch
    boundary, are the JAX StreamingDataset's for (seed, epoch)."""
    pack = copy_pack(pack_dir, tmp_path / "pack")
    for split in ("train", "val"):
        stream.ensure_split_shards(pack, split, 5)
    seen = []
    real_step = tr.train_step

    def recording_step(state, opt, shared, batch, *a):
        seen.append(batch.label.numpy().copy())
        return real_step(state, opt, shared, batch, *a)

    cfg = loader_cfg(small_config)
    with unittest.mock.patch.object(tr, "train_step", recording_step):
        res = tr.train(cfg, load_pack(pack, load_splits=False), str(tmp_path / "run"),
                       num_steps=6, echo=False, datasets=streamed(pack), prefetch=2,
                       device="cpu")
    ref = j_stream.StreamingDataset(pack, "train")
    want = [b.label for e in (0, 1) for b in ref.get_batches(4, shuffle=True,
                                                              seed=cfg.train.seed, epoch=e)]
    assert res["steps"] == 6 and len(seen) == 6
    assert all(np.array_equal(a, b) for a, b in zip(seen, want[:6]))


def test_prefetcher_stopped_after_an_early_stop(packed_synth, small_config, tmp_path,
                                                monkeypatch):
    made = []

    class Recorded(stream.Prefetcher):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(tr, "Prefetcher", Recorded)
    cfg = loader_cfg(small_config)
    tr.train(cfg, packed_synth, str(tmp_path / "run"), num_steps=2, echo=False, prefetch=1,
             device="cpu")
    # the epoch's iterator (stopped at step 2 of 4) and the validations' ones
    assert len(made) >= 2
    assert not any(p._t.is_alive() for p in made)
    assert all(p._done for p in made)


def test_prefetch_worker_exception_reaches_the_loop(packed_synth, small_config, tmp_path,
                                                    monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("dedup failed in the worker")

    monkeypatch.setattr(tr, "dedup_album_batch", broken)
    cfg = loader_cfg(small_config, dedup_albums=True)
    with pytest.raises(RuntimeError, match="in the worker"):
        tr.train(cfg, packed_synth, str(tmp_path / "run"), num_steps=2, echo=False,
                 prefetch=2, device="cpu")


def test_evaluate_with_prefetch_equals_inline(packed_synth, small_config):
    cfg = port_config(small_config)
    state = tr.init_state(cfg, "cpu")
    shared = SharedTables.from_packed(packed_synth.shared, "cpu")
    step = tr.make_eval_step(state.model)
    ds = Dataset(packed_synth, "test")
    tables = tr.make_eval_tables(state.model, shared)
    assert (tr.evaluate(step, shared, ds, 4, *tables, prefetch=0)
            == tr.evaluate(step, shared, ds, 4, *tables, prefetch=3))


@pytest.mark.parametrize("num_steps,closed_at", [(16, 15), (12, 12)])
def test_profile_window_writes_a_trace(packed_synth, small_config, tmp_path, num_steps,
                                       closed_at):
    """steps 11-15 traced once; a run that ends inside the window closes it at
    its last step."""
    cfg = loader_cfg(small_config)
    d = str(tmp_path / "run")
    prof = os.path.join(d, "profile")
    tr.train(cfg, packed_synth, d, num_steps=num_steps,
             metrics_path=os.path.join(d, "metrics.jsonl"), echo=False, profile_dir=prof,
             device="cpu")
    events = [r for r in metrics(d) if r["event"] == "profile"]
    assert [(r["step"], r["dir"]) for r in events] == [(closed_at, prof)]
    trace = read_json(os.path.join(prof, "trace.json"))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)
    assert {"fvta.loader.batch", "fvta.loader.h2d", "fvta.step", "fvta.forward",
            "fvta.backward", "fvta.optimizer"} <= names


# ---- `cli train`'s flags ------------------------------------------------------------------

def option_strings(main, argv) -> set:
    import contextlib
    import io
    import re

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        main(argv)
    return set(re.findall(r"(--[a-z][a-z0-9-]*)", buf.getvalue()))


def test_cli_train_takes_the_jax_flags():
    from fvta_memexqa_tpu import cli as j_cli

    mine = option_strings(cli.main, ["train", "-h"])
    assert mine - {"--device"} == option_strings(j_cli.main, ["train", "-h"])
    assert {"--prefetch", "--stream-shard-size", "--profile"} <= mine


def test_cli_train_streams_prefetches_and_profiles(pack_dir, tmp_path, capsys):
    pack = copy_pack(pack_dir, tmp_path / "pack")
    run = str(tmp_path / "run")
    argv = ["train", pack, run, "--num-steps", "12", "--batch-size", "4", "--hidden-dim",
            "16", "--char-emb-dim", "8", "--char-cnn-filters", "16", "--val-period", "6",
            "--stream-shard-size", "6", "--prefetch", "2", "--profile", "--device", "cpu"]
    assert cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 12
    for split in ("train", "val"):
        index = read_json(os.path.join(pack, f"data_{split}.shards.json"))
        assert index["shard_size"] == 6
    assert not os.path.exists(os.path.join(pack, "data_test.shards.json"))
    assert [r["step"] for r in metrics(run) if r["event"] == "profile"] == [12]
    assert os.path.exists(os.path.join(run, "profile", "trace.json"))
    stamps = {f: os.stat(os.path.join(pack, f)).st_mtime_ns for f in shard_files(pack)}
    assert cli.main(argv[:4] + ["14"] + argv[5:]) == 0           # resumes; no re-shard
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["steps"] == 14
    assert {f: os.stat(os.path.join(pack, f)).st_mtime_ns for f in shard_files(pack)} == stamps
    assert [r["step"] for r in metrics(run) if r["event"] == "profile"] == [12]


# ---- streamed training vs the JAX package's ------------------------------------------

def test_streamed_losses_match_jax(pack_dir, small_config, tmp_path):
    """The same initial weights (JAX's init, converted and saved as the port's
    step-0 checkpoint), keep_prob 1, 5-row shards, batch 4, prefetch 2: the
    port's per-step losses over 6 steps (crossing an epoch) vs JAX's
    train(datasets=...)."""
    pack = copy_pack(pack_dir, tmp_path / "pack")
    stream.ensure_split_shards(pack, "train", 5)
    jcfg = small_config.replace(
        model=JModelConfig(hidden_dim=16, char_emb_dim=8, char_cnn_filters=16, keep_prob=1.0),
        train=JTrainConfig(batch_size=4, log_period=1, save_period=1000))
    from fvta_memexqa_tpu.data import load_pack as j_load_pack

    jpacked = j_load_pack(pack, load_splits=False)
    jrun = str(tmp_path / "jax")
    j_train.train(jcfg, jpacked, jrun, num_steps=6, metrics_path=os.path.join(jrun, "m.jsonl"),
                  echo=False, datasets=(j_stream.StreamingDataset(pack, "train"), None),
                  prefetch=2)
    j_shared = JSharedTables.from_packed(jpacked.shared)
    first = device_put_batch(next(iter(j_stream.StreamingDataset(pack, "train")
                                       .get_batches(4))))
    j_state = j_train.init_state(jcfg, JFVTAModel(cfg=jcfg), j_shared, first)

    cfg = port_config(jcfg)
    run = str(tmp_path / "port")
    state = tr.init_state(cfg, "cpu")
    state.model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray,
                                                                  j_state.params)))
    CheckpointManager(run, cfg).save(0, state)
    tr.train(cfg, load_pack(pack, load_splits=False), run, num_steps=6,
             metrics_path=os.path.join(run, "metrics.jsonl"), echo=False,
             datasets=(stream.StreamingDataset(pack, "train"), None), prefetch=2, device="cpu")
    with open(os.path.join(jrun, "m.jsonl")) as f:
        want = [json.loads(line)["loss"] for line in f if '"train"' in line]
    got = [r["loss"] for r in metrics(run) if r["event"] == "train"]
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got, want, **LOSS_TOL)
