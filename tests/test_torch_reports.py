"""The focal corpora and the two report commands of the port against the JAX
package on the CPU: make_focal_synthetic and make_evidence_only_synthetic
record for record and array for array (with return_meta, albums_per_question,
noise_scale and decoy_repeats), focal_kind over a grid, `synth --focal` and
`prepro --val-ids` through both CLIs file for file, and `report` /
`attention-report` on the same files — MemexQA and video attention dumps, a
count dump, run directories and the metrics rows of the JAX suite's report
cases, written by either package — with equal stdout, stderr and return
codes, in text and in --json mode."""

import contextlib
import dataclasses
import io
import json
import os

import jax
import numpy as np
import pytest

from fvta_memexqa_tpu import cli as j_cli
from fvta_memexqa_tpu import train as j_train
from fvta_memexqa_tpu.config import Config as JConfig
from fvta_memexqa_tpu.config import ModelConfig as JModelConfig
from fvta_memexqa_tpu.config import save_config as j_save_config
from fvta_memexqa_tpu.data import Dataset as JDataset
from fvta_memexqa_tpu.data import SharedTables as JSharedTables
from fvta_memexqa_tpu.data import synthetic as j_synth
from fvta_memexqa_tpu.data.device_prepro import device_put_batch
from fvta_memexqa_tpu.models import FVTAModel as JFVTAModel
from fvta_memexqa_tpu.utils.metrics import MetricsLogger as JMetricsLogger

from fvta_memexqa_torch import cli
from fvta_memexqa_torch.data import load_pack
from fvta_memexqa_torch.data import synthetic as synth

CPU = ["--device", "cpu"]
WIDTHS = ["--hidden-dim", "16", "--char-emb-dim", "8", "--char-cnn-filters", "16"]


@pytest.fixture(autouse=True)
def no_jax_compile_cache(monkeypatch):
    monkeypatch.setenv("FVTA_NO_COMPILE_CACHE", "1")


def records(x):
    """A generator's output as plain data: dataclass records as dicts, arrays
    as (dtype, shape, bytes) so that equality is bit for bit."""
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, dict):
        return {k: records(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [records(v) for v in x]
    if isinstance(x, set):
        return sorted(x)
    return x


# ---- the generators --------------------------------------------------------------------

FOCAL_CASES = [
    {},
    dict(num_albums=8, seed=1),
    dict(num_albums=32, seed=3, photos_per_album=5, num_questions=120),
    dict(num_albums=24, seed=2, return_meta=True),
    dict(num_albums=24, seed=0, albums_per_question=2, num_questions=60),
    dict(num_albums=40, seed=5, albums_per_question=3, return_meta=True),
    dict(num_albums=16, seed=4, decoy_repeats=3, noise_scale=0.1, feat_dim=16, glove_dim=8),
    dict(num_albums=29, seed=6, test_fraction=0.4),
]


@pytest.mark.parametrize("kw", FOCAL_CASES, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()) or "defaults")
def test_focal_generator_equals_jax(kw):
    mine, ref = synth.make_focal_synthetic(**kw), j_synth.make_focal_synthetic(**kw)
    assert len(mine) == len(ref) == (7 if kw.get("return_meta") else 6)
    assert [type(v).__name__ for v in mine] == [type(v).__name__ for v in ref]
    for a, b in zip(mine, ref):
        assert records(a) == records(b)
    # dict order too: write_raw_files writes in it
    assert [list(x) for x in mine if isinstance(x, dict)] == [
        list(x) for x in ref if isinstance(x, dict)]


EVIDENCE_CASES = [
    {},
    dict(num_albums=10, seed=4, return_meta=True),
    dict(num_albums=32, seed=1, noise_scale=0.5, decoy_repeats=2, photos_per_album=6,
         num_questions=64),
]


@pytest.mark.parametrize("kw", EVIDENCE_CASES, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()) or "defaults")
def test_evidence_only_generator_equals_jax(kw):
    mine = synth.make_evidence_only_synthetic(**kw)
    ref = j_synth.make_evidence_only_synthetic(**kw)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert records(a) == records(b)


def test_too_many_albums_per_question_raises_as_jax():
    with pytest.raises(ValueError, match="smallest album split") as mine:
        synth.make_focal_synthetic(num_albums=8, albums_per_question=3)
    with pytest.raises(ValueError) as ref:
        j_synth.make_focal_synthetic(num_albums=8, albums_per_question=3)
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("num_albums", [1, 2, 3, 4, 5, 9, 14, 24, 25, 96, 240])
def test_focal_kind_equals_jax(num_albums):
    qis = range(7 * num_albums + 11)
    assert ([synth.focal_kind(q, num_albums) for q in qis]
            == [j_synth.focal_kind(q, num_albums) for q in qis])
    # every album sees more than one kind over five sweeps
    for owner in range(min(num_albums, 8)):
        kinds = {synth.focal_kind(owner + j * num_albums, num_albums) for j in range(5)}
        assert len(kinds) > 1 or num_albums == 1 and len(kinds) == 5


# ---- synth --focal and prepro --val-ids through both CLIs ----------------------------

def run_cli(fn, argv):
    """(return code, stdout, stderr) of an in-process CLI call."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc or 0, out.getvalue(), err.getvalue()


def jax_cmd(name):
    return j_cli.COMMANDS[name]


def port_cmd(name):
    return lambda argv: cli.main([name, *argv])


RAW_TEXT = ("qas.json", "album_info.json", "test_question.ids", "val_question.ids",
            "glove.txt")


@pytest.mark.parametrize("argv", [
    ["--num-albums", "24", "--photos-per-album", "4", "--num-questions", "96",
     "--feat-dim", "32"],
    ["--num-albums", "9", "--num-questions", "30", "--feat-dim", "16", "--seed", "3"],
], ids=["a24", "a9_seed3"])
def test_synth_focal_writes_the_jax_files(tmp_path, argv):
    got = {}
    for who, fn in (("port", port_cmd("synth")), ("jax", jax_cmd("synth"))):
        got[who] = run_cli(fn, [str(tmp_path / who), "--focal", *argv])
        assert got[who][0] == 0
    assert json.loads(got["port"][1].replace(str(tmp_path / "port"), "D")) == json.loads(
        got["jax"][1].replace(str(tmp_path / "jax"), "D"))
    for f in RAW_TEXT:
        with open(tmp_path / "port" / f, "rb") as a, open(tmp_path / "jax" / f, "rb") as b:
            assert a.read() == b.read(), f
    with np.load(tmp_path / "port" / "photo_feats.npz") as a, \
            np.load(tmp_path / "jax" / "photo_feats.npz") as b:
        assert a.files == b.files
        assert all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a.files)


def test_prepro_val_ids_packs_the_focal_corpus_as_jax(tmp_path):
    raw = str(tmp_path / "raw")
    assert run_cli(port_cmd("synth"), [raw, "--focal", "--num-albums", "16",
                                       "--num-questions", "64", "--feat-dim", "16"])[0] == 0
    files = [os.path.join(raw, f) for f in ("qas.json", "album_info.json",
                                            "test_question.ids", "glove.txt",
                                            "photo_feats.npz")]
    flags = ["--val-ids", os.path.join(raw, "val_question.ids"), "--image-feat-dim", "16"]
    outs = {}
    for who, fn in (("port", port_cmd("prepro")), ("jax", jax_cmd("prepro"))):
        rc, out, _ = run_cli(fn, [*files, str(tmp_path / who), *flags])
        assert rc == 0
        outs[who] = json.loads(out)
    assert outs["port"] == outs["jax"]
    mine = load_pack(str(tmp_path / "port"))
    with open(os.path.join(raw, "val_question.ids")) as f:
        val_ids = sorted(line.strip() for line in f if line.strip())
    assert sorted(str(q) for q in mine.splits["val"]["qid"]) == val_ids
    for split in ("train", "val", "test"):
        with np.load(tmp_path / "port" / f"data_{split}.npz") as a, \
                np.load(tmp_path / "jax" / f"data_{split}.npz") as b:
            assert all(np.array_equal(a[k], b[k]) for k in b.files), split


# ---- report and attention-report on the same files -------------------------------------

@pytest.fixture(scope="module")
def inputs(tmp_path_factory, pack_dir):
    """The files both reports read, written by the port and by the JAX package."""
    root = tmp_path_factory.mktemp("reports")
    out = {}
    # the port: a MemexQA run (train, test --by-category, an ensemble) and its dump
    run = str(root / "port_run")
    tiny = ["--batch-size", "4", *WIDTHS, *CPU]
    assert run_cli(port_cmd("train"), [pack_dir, run, "--num-steps", "4", "--val-period", "2",
                                       "--log-period", "2", *tiny])[0] == 0
    out["port_dump"] = str(root / "port_attn.npz")
    assert run_cli(port_cmd("test"), [pack_dir, run, "--by-category", "--dump-attention",
                                      out["port_dump"], *tiny])[0] == 0
    assert run_cli(port_cmd("test"), [pack_dir, run, "--ensemble", run, *tiny])[0] == 0
    out["port_run"] = run
    # the port: video runs (mc and count) and their dumps
    for task in ("mc", "count"):
        raw, vpack = str(root / f"vraw_{task}"), str(root / f"vpack_{task}")
        assert run_cli(port_cmd("synth-video"), [raw, "--num-videos", "12", "--num-frames",
                                                 "8", "--feat-dim", "16", "--task",
                                                 task])[0] == 0
        assert run_cli(port_cmd("video-prepro"), [
            os.path.join(raw, "qas.jsonl"), os.path.join(raw, "frame_feats.npz"), vpack,
            "--test-ids", os.path.join(raw, "test_qa.ids"), "--task", task, "--max-frames",
            "8", "--max-question-len", "8", "--max-answer-len", "3", "--max-word-len", "6",
            "--word-emb-dim", "16"])[0] == 0
        vrun = str(root / f"vrun_{task}")
        assert run_cli(port_cmd("video"), ["--data", vpack, "--out", vrun, "--steps", "2",
                                           "--batch-size", "4", "--hidden-dim", "8",
                                           "--val-period", "1", "--log-period", "1",
                                           *CPU])[0] == 0
        out[f"video_{task}_dump"] = str(root / f"video_{task}.npz")
        assert run_cli(port_cmd("video-test"), [vrun, "--dump-attention",
                                                out[f"video_{task}_dump"], *CPU])[0] == 0
        out[f"video_{task}_run"] = vrun
    # the JAX package: a dump from its own model and dump_attention
    from fvta_memexqa_tpu.data import load_pack as j_load_pack

    jpacked = j_load_pack(pack_dir)
    jcfg = JConfig(data=jpacked.cfg, model=JModelConfig(hidden_dim=16, char_emb_dim=8,
                                                        char_cnn_filters=16))
    sh = JSharedTables.from_packed(jpacked.shared)
    model = JFVTAModel(cfg=jcfg)
    jb = device_put_batch(next(iter(JDataset(jpacked, "train").get_batches(4))))
    params = jax.jit(lambda k: model.init(k, sh, j_train.assemble(sh, jb), train=False))(
        jax.random.key(3))
    out["jax_dump"] = str(root / "jax_attn.npz")
    j_train.dump_attention(jcfg, model, params, sh, JDataset(jpacked, "test"), 4,
                           out["jax_dump"])
    # the JAX package: run directories of metrics rows (its MetricsLogger), a
    # full one with its config.json and the JAX suite's mse and foreign cases
    jrun = root / "jax_run"
    jrun.mkdir()
    j_save_config(jcfg, str(jrun / "config.json"))
    log = JMetricsLogger(str(jrun / "metrics.jsonl"), echo=False)
    for step, loss in ((2, 1.5), (4, 1.25)):
        log.log("train", step=step, epoch=0, loss=loss, acc=0.5, qa_pairs_per_sec=1234.5,
                p50_step_ms=3.2)
        log.log("val", step=step, acc=0.25 * step / 2, loss=loss)
    log.log("test", split="test", acc=0.625, loss=1.1, count=8, wall_s=0.5)
    log.log("test_by_category", split="test", what=0.5, when=0.75)
    log.log("test_ensemble", split="test", acc=0.75, count=8, member_accs=[0.5, 0.75])
    log.close()
    out["jax_run"] = str(jrun)
    for name, rows in (("jax_mse_rows", [
            {"step": 10, "loss": 1.0}, ("val", {"step": 10, "mse": 2.5, "count": 8}),
            ("val", {"step": 20, "mse": 1.5, "count": 8}),
            ("test", {"split": "test", "mse": 1.6, "count": 8})]),
            ("jax_foreign_rows", [
                {"step": 5}, {}, ("val", {"acc": 0.5, "loss": 1.0}), (None, {"note": "rogue"}),
                ("test_ensemble", {"split": "test", "count": 8})])):
        d = root / name
        d.mkdir()
        log = JMetricsLogger(str(d / "metrics.jsonl"), echo=False)
        for row in rows:
            event, fields = row if isinstance(row, tuple) else ("train", row)
            if event is None:   # a row with no event at all
                log.f.write(json.dumps({"time": 0, **fields}) + "\n")
            else:
                log.log(event, **fields)
        log.close()
        out[name] = str(d)
    out["missing_run"] = str(root / "nope")
    return out


def both(name, argv):
    """The port's and the JAX CLI's (rc, stdout, stderr) on the same argv."""
    return run_cli(port_cmd(name), argv), run_cli(jax_cmd(name), argv)


@pytest.mark.parametrize("mode", ["text", "json"])
@pytest.mark.parametrize("run", ["port_run", "jax_run", "video_count_run", "video_mc_run",
                                 "jax_mse_rows", "jax_foreign_rows", "missing_run"])
def test_report_prints_what_jax_prints(inputs, run, mode):
    mine, ref = both("report", [inputs[run], *(["--json"] if mode == "json" else [])])
    assert mine == ref
    assert mine[0] == (1 if run == "missing_run" else 0)
    if mode == "json" and run != "missing_run":
        summary = json.loads(mine[1])
        assert summary["steps"] == {"jax_mse_rows": 10, "jax_foreign_rows": 0,
                                    "jax_run": 4, "port_run": 4}.get(run, summary["steps"])


ATTENTION_ARGS = {
    "text": [],
    "json": ["--json"],
    "top5_all_json": ["--top", "5", "--limit", "0", "--json"],
    "limit2_text": ["--limit", "2", "--top", "1"],
    "wrong_only": ["--wrong-only", "--limit", "0"],
    "wrong_only_json": ["--wrong-only", "--json"],
    "one_qid": ["--qid", None, "--json"],
    "unknown_qid": ["--qid", "no-such-question"],
}


@pytest.mark.parametrize("args", list(ATTENTION_ARGS))
@pytest.mark.parametrize("dump", ["port_dump", "jax_dump", "video_mc_dump",
                                  "video_count_dump"])
def test_attention_report_prints_what_jax_prints(inputs, dump, args):
    path = inputs[dump]
    with np.load(path) as z:
        qids = [str(q) for q in z["qid"]]
        count = len(qids)
    argv = [path, *(qids[-1] if a is None else a for a in ATTENTION_ARGS[args])]
    mine, ref = both("attention-report", argv)
    assert mine == ref
    assert mine[0] == (2 if args == "unknown_qid" else 0)
    if args == "top5_all_json":
        recs = [json.loads(line) for line in mine[1].splitlines()]
        assert len(recs) == count and all(len(r["focus"]) <= 5 for r in recs)
        if dump == "video_count_dump":
            assert all(r["p_pred"] is None or r["pred"] < 1 for r in recs)
