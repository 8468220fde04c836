"""The port's evaluation path vs the JAX package's, at small_config widths with
one JAX model's weights (carried by convert.py): the album cache (h at 1e-5,
masks equal), predict_cached (probs at 1e-5, pred and label equal),
evaluate_cached (acc equal, loss at 1e-5), the per-category table, the
attention dump (arrays at 1e-5), and `train.test` without the album cache but
with the per-category table — the combination on which the JAX package's
train.test raises — against the JAX package's cached `test`. Then the CLI on
the CPU: synth → prepro (whose pack equals the JAX CLI's, array for array) →
train → test (cached, uncached, by category, attention dump, ensemble) and
ablate."""

import contextlib
import filecmp
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from fvta_memexqa_tpu import cli as j_cli
from fvta_memexqa_tpu import eval_cache as j_eval
from fvta_memexqa_tpu import train as j_train
from fvta_memexqa_tpu.checkpoint import CheckpointManager as JCheckpointManager
from fvta_memexqa_tpu.data import Dataset as JDataset
from fvta_memexqa_tpu.data import SharedTables as JSharedTables
from fvta_memexqa_tpu.data import categories as j_categories
from fvta_memexqa_tpu.data import load_pack as j_load_pack
from fvta_memexqa_tpu.data import synthetic as j_synthetic
from fvta_memexqa_tpu.data.device_prepro import device_put_batch
from fvta_memexqa_tpu.models import FVTAModel as JFVTAModel

from fvta_memexqa_torch import cli, eval_cache
from fvta_memexqa_torch import train as tr
from fvta_memexqa_torch.checkpoint import CheckpointManager
from fvta_memexqa_torch.config import Config, MeshConfig
from fvta_memexqa_torch.convert import model_from_flax
from fvta_memexqa_torch.data import SharedTables, categories, load_pack
from fvta_memexqa_torch.data.pipeline import Dataset

TOL = dict(rtol=1e-5, atol=1e-5)
EVAL_BS = 8


@pytest.fixture(scope="module")
def run(packed_synth, small_config, tmp_path_factory):
    """One JAX model (flax init, seed 0) as a JAX run directory (an orbax
    checkpoint, best at val 0.5) and as a port run directory holding the same
    weights; the port model and tables on the CPU; the JAX album cache."""
    cfg = small_config.replace(train=small_config.train.__class__(eval_batch_size=EVAL_BS))
    j_shared = JSharedTables.from_packed(packed_synth.shared)
    jb = device_put_batch(next(iter(JDataset(packed_synth, "train").get_batches(EVAL_BS))))
    j_model = JFVTAModel(cfg=cfg)
    state = j_train.init_state(cfg, j_model, j_shared, jb)
    root = tmp_path_factory.mktemp("eval_runs")
    jdir, pdir = str(root / "jax"), str(root / "port")
    ck = JCheckpointManager(jdir, cfg)
    ck.save(1, state, val_acc=0.5)
    ck.close()
    params = jax.tree.map(np.asarray, state.params)
    pcfg = Config.from_json(cfg.to_json())
    pstate = tr.init_state(pcfg, "cpu")
    pstate.model.load_state_dict(model_from_flax(pcfg, params).state_dict())
    pstate.step = 1
    CheckpointManager(pdir, pcfg).save(1, pstate, val_acc=0.5)
    j_cache = j_eval.precompute_album_cache(cfg, j_model, state.params, j_shared)
    return dict(cfg=cfg, pcfg=pcfg, j_model=j_model, j_params=state.params,
                j_shared=j_shared, j_cache=j_cache, jdir=jdir, pdir=pdir,
                model=model_from_flax(pcfg, params),
                shared=SharedTables.from_packed(packed_synth.shared, "cpu"))


def test_album_cache_matches_jax(run):
    h, m = eval_cache.precompute_album_cache(run["pcfg"], run["model"], run["shared"],
                                             batch_size=3)
    jh, jm = run["j_cache"]
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert not m[0].any()                      # row 0: the pad album


@pytest.mark.parametrize("split", ["val", "test"])
def test_predict_cached_matches_jax(run, packed_synth, split):
    got = eval_cache.predict_cached(run["pcfg"], run["model"], run["shared"],
                                    Dataset(packed_synth, split), EVAL_BS)
    ref = j_eval.predict_cached(run["cfg"], run["j_model"], run["j_params"], run["j_shared"],
                                JDataset(packed_synth, split), EVAL_BS, cache=run["j_cache"])
    np.testing.assert_allclose(got["probs"], ref["probs"], **TOL)
    for k in ("qid", "pred", "label"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_evaluate_cached_matches_jax_and_the_plain_evaluation(run, packed_synth):
    got = eval_cache.evaluate_cached(run["pcfg"], run["model"], run["shared"],
                                     Dataset(packed_synth, "test"), EVAL_BS)
    ref = j_eval.evaluate_cached(run["cfg"], run["j_model"], run["j_params"], run["j_shared"],
                                 JDataset(packed_synth, "test"), EVAL_BS, cache=run["j_cache"])
    assert got["count"] == ref["count"] and got["acc"] == ref["acc"]
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    assert got["cache_s"] >= 0.0
    tables = tr.make_eval_tables(run["model"], run["shared"])
    cache = eval_cache.precompute_album_cache(run["pcfg"], run["model"], run["shared"],
                                              vocab_table=tables[0], photo_table=tables[1])
    given = eval_cache.evaluate_cached(run["pcfg"], run["model"], run["shared"],
                                       Dataset(packed_synth, "test"), EVAL_BS, cache=cache,
                                       tables=tables)
    assert {k: given[k] for k in ("acc", "loss", "count")} == {
        k: got[k] for k in ("acc", "loss", "count")}
    plain = tr.evaluate(tr.make_eval_step(run["model"]), run["shared"],
                        Dataset(packed_synth, "test"), EVAL_BS,
                        *tr.make_eval_tables(run["model"], run["shared"]))
    assert plain["acc"] == got["acc"] and plain["loss"] == pytest.approx(got["loss"], rel=1e-5)


def test_question_categories_match_jax(packed_synth):
    rng = np.random.default_rng(0)
    for split in ("train", "val", "test"):
        got = categories.question_categories(packed_synth, split)
        ref = j_categories.question_categories(packed_synth, split)
        np.testing.assert_array_equal(got, ref)
        correct = rng.random(len(got)) > 0.5
        assert (categories.accuracy_by_category(got, correct)
                == j_categories.accuracy_by_category(ref, correct))
    for words in (("how", "many"), ("how", "much"), ("who", ""), ("when", "did"),
                  ("where",), ("", "")):
        assert categories.categorize(*words) == j_categories.categorize(*words)


def test_dump_attention_matches_jax(run, packed_synth, tmp_path):
    mine, ref = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    n = tr.dump_attention(run["model"], run["shared"], Dataset(packed_synth, "test"),
                          EVAL_BS, mine)
    assert n == j_train.dump_attention(run["cfg"], run["j_model"], run["j_params"],
                                       run["j_shared"], JDataset(packed_synth, "test"),
                                       EVAL_BS, ref)
    a, b = np.load(mine), np.load(ref)
    assert sorted(a.files) == sorted(b.files)
    for k in ("qid", "pred", "label"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("probs", "time_attn", "seq_attn"):
        np.testing.assert_allclose(a[k], b[k], **TOL, err_msg=k)


def test_uncached_by_category_test_matches_jax_cached_test(run, packed_synth):
    """The port's test(album_cache=False, by_category=True) — which raises in
    the JAX package — against the JAX package's cached test with the table."""
    got = tr.test(run["pcfg"], packed_synth, run["pdir"], album_cache=False, by_category=True,
                  echo=False, device="cpu")
    ref = j_train.test(run["cfg"], packed_synth, run["jdir"], album_cache=True,
                       by_category=True, echo=False)
    assert got["by_category"] == ref["by_category"]
    assert got["acc"] == ref["acc"] and got["count"] == ref["count"]
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    cached = tr.test(run["pcfg"], packed_synth, run["pdir"], by_category=True, echo=False,
                     device="cpu")
    assert cached["by_category"] == got["by_category"] and cached["acc"] == got["acc"]


def test_ensemble_of_one_run_twice_is_the_run(run, packed_synth):
    m = tr.test_ensemble(run["pcfg"], packed_synth, [run["pdir"], run["pdir"]],
                         by_category=True, echo=False, device="cpu")
    single = tr.test(run["pcfg"], packed_synth, run["pdir"], by_category=True, echo=False,
                     device="cpu")
    assert m["acc"] == single["acc"] and m["count"] == single["count"]
    assert [mm["acc"] for mm in m["members"]] == [single["acc"]] * 2
    assert m["by_category"] == single["by_category"]


def test_sharded_cache_and_mesh_raise(run, packed_synth, pack_dir):
    meshed = run["pcfg"].replace(mesh=MeshConfig(data_parallel=2))
    for cfg, kw in ((run["pcfg"], {"shard_cache": True}), (meshed, {})):
        with pytest.raises(NotImplementedError, match="data-parallel"):
            tr.test(cfg, packed_synth, run["pdir"], device="cpu", **kw)
        with pytest.raises(NotImplementedError, match="data-parallel"):
            tr.test_ensemble(cfg, packed_synth, [run["pdir"]], device="cpu", **kw)
    for extra in (["--shard-cache"], ["--data-parallel", "2"]):
        with pytest.raises(NotImplementedError, match="data-parallel"):
            cli.main(["test", pack_dir, run["pdir"], *extra, "--device", "cpu"])


def test_cli_test_on_cuda_needs_a_card(run, pack_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["test", pack_dir, run["pdir"]])


# ---- the CLI on the CPU ---------------------------------------------------------------

WIDTHS = ["--batch-size", "8", "--hidden-dim", "16", "--char-emb-dim", "8",
          "--char-cnn-filters", "16", "--eval-batch-size", "8", "--device", "cpu"]


def cli_json(argv) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """synth → prepro → two 4-step trainings (seeds 0 and 1), all through the
    port's CLI."""
    root = tmp_path_factory.mktemp("cli")
    raw, pack = str(root / "raw"), str(root / "pack")
    synth = cli_json(["synth", raw, "--num-albums", "6", "--num-questions", "48"])
    files = [os.path.join(raw, f) for f in ("qas.json", "album_info.json",
                                            "test_question.ids", "glove.txt",
                                            "photo_feats.npz")]
    prepro = cli_json(["prepro", *files, pack, "--image-feat-dim", "64"])
    runs = [str(root / f"run{s}") for s in (0, 1)]
    for s, rd in enumerate(runs):
        cli_json(["train", pack, rd, "--num-steps", "4", "--val-period", "2", "--seed", str(s),
                  *WIDTHS])
    return dict(root=root, raw=raw, pack=pack, files=files, runs=runs, synth=synth,
                prepro=prepro)


def test_cli_synth_writes_the_jax_raw_files(cli_runs, tmp_path):
    assert cli_runs["synth"] == {"outdir": cli_runs["raw"], "questions": 48, "albums": 6,
                                 "focal": False}
    j_synthetic.write_raw_files(str(tmp_path), *j_synthetic.make_synthetic(
        num_albums=6, num_questions=48))
    for f in cli_runs["files"]:
        if f.endswith(".npz"):
            a, b = np.load(f), np.load(tmp_path / os.path.basename(f))
            assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)
        else:
            assert filecmp.cmp(f, tmp_path / os.path.basename(f), shallow=False), f
    with pytest.raises(NotImplementedError, match="focal"):
        cli.main(["synth", str(tmp_path / "focal"), "--focal"])


def test_cli_prepro_pack_equals_jax_cli_prepro(cli_runs, tmp_path, capsys):
    j_cli.cmd_prepro([*cli_runs["files"], str(tmp_path), "--image-feat-dim", "64"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == cli_runs["prepro"]
    mine, ref = load_pack(cli_runs["pack"]), j_load_pack(str(tmp_path))
    assert mine.meta == ref.meta
    for k, v in ref.shared.__dict__.items():
        np.testing.assert_array_equal(getattr(mine.shared, k), v, err_msg=k)
    assert mine.splits.keys() == ref.splits.keys()
    for split, arrays in ref.splits.items():
        for k, v in arrays.items():
            np.testing.assert_array_equal(mine.splits[split][k], v, err_msg=f"{split}.{k}")


def test_cli_test_cached_uncached_by_category_and_dump(cli_runs):
    pack, rd = cli_runs["pack"], cli_runs["runs"][0]
    cached = cli_json(["test", pack, rd, "--device", "cpu"])
    assert set(cached) == {"split", "accuracy", "loss", "count"}
    assert cached["split"] == "test" and cached["count"] == 12
    uncached = cli_json(["test", pack, rd, "--no-album-cache", "--device", "cpu"])
    assert uncached["accuracy"] == cached["accuracy"]
    assert uncached["loss"] == pytest.approx(cached["loss"], rel=1e-5)
    npz = str(cli_runs["root"] / "attn.npz")
    full = cli_json(["test", pack, rd, "--by-category", "--dump-attention", npz,
                     "--load-latest", "--device", "cpu"])
    bc = full["by_category"]
    assert sum(v["count"] for v in bc.values()) == full["count"]
    n_correct = sum(round(v["acc"] * v["count"]) for v in bc.values())
    assert n_correct == round(full["accuracy"] * full["count"])
    z = np.load(npz)
    assert z["probs"].shape == (12, 4) and z["time_attn"].shape[0] == 12
    assert float((z["pred"] == z["label"]).mean()) == pytest.approx(full["accuracy"])
    events = [json.loads(line)["event"] for line in open(os.path.join(rd, "metrics.jsonl"))]
    assert {"test", "test_by_category", "attention_dump"} <= set(events)


def test_cli_test_ensemble(cli_runs):
    pack, (r0, r1) = cli_runs["pack"], cli_runs["runs"]
    m = cli_json(["test", pack, r0, "--ensemble", r1, "--by-category", "--device", "cpu"])
    assert set(m) == {"split", "accuracy", "count", "members", "by_category"}
    singles = [cli_json(["test", pack, r, "--device", "cpu"])["accuracy"] for r in (r0, r1)]
    assert [mm["dir"] for mm in m["members"]] == [r0, r1]
    assert [mm["acc"] for mm in m["members"]] == pytest.approx(singles)
    assert m["count"] == 12 and 0.0 <= m["accuracy"] <= 1.0


def test_cli_ablate(cli_runs):
    out = str(cli_runs["root"] / "ablate")
    res = cli_json(["ablate", cli_runs["pack"], out, "--num-steps", "2", *WIDTHS])
    assert list(res) == ["fvta", "flat", "none"]
    for variant, r in res.items():
        assert set(r) == {"val_acc", "test_acc", "steps"} and r["steps"] == 2
        saved = Config.from_json(open(os.path.join(out, variant, "config.json")).read())
        assert saved.model.attention == variant
    res = cli_json(["ablate", cli_runs["pack"], out, "--num-steps", "1", "--variants", "flat",
                    "--seeds", "0,1", *WIDTHS])
    assert set(res["flat"]["per_seed"]) == {"0", "1"}
    assert os.path.isdir(os.path.join(out, "flat_s1"))
