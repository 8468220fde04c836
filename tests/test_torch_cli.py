"""The port's CLI against the JAX CLI on the same argv: what `main` returns,
the keys of `cli video`'s JSON line for each task with and without a pack, and
`predict --load-latest`. The port's commands also get `--device cpu` (the JAX
CLI has no such flag; the port's default device is the card)."""

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from fvta_memexqa_tpu import cli as j_cli
from fvta_memexqa_tpu import train as j_train
from fvta_memexqa_tpu.checkpoint import CheckpointManager as JCheckpointManager
from fvta_memexqa_tpu.data import Dataset as JDataset
from fvta_memexqa_tpu.data import SharedTables as JSharedTables
from fvta_memexqa_tpu.data.device_prepro import device_put_batch
from fvta_memexqa_tpu.models import FVTAModel as JFVTAModel

from fvta_memexqa_torch import cli
from fvta_memexqa_torch import train as tr
from fvta_memexqa_torch.checkpoint import CheckpointManager
from fvta_memexqa_torch.config import Config
from fvta_memexqa_torch.convert import model_from_flax, save_rundir
from fvta_memexqa_torch.serve import build_engine

CPU = ["--device", "cpu"]
TINY_VIDEO = ["--steps", "1", "--batch-size", "4", "--hidden-dim", "8"]


@pytest.fixture(autouse=True)
def no_jax_compile_cache(monkeypatch):
    monkeypatch.setenv("FVTA_NO_COMPILE_CACHE", "1")


def run(main, argv):
    """(return code, the last stdout line as JSON or None)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None)


def write_video_pack(root, task, all_test=False):
    """A tiny synthetic video pack (12 videos x 8 frames) for `task`; all_test
    puts every question in the test split, so the train split is empty."""
    raw, pack = str(root / f"raw_{task}_{all_test}"), str(root / f"pack_{task}_{all_test}")
    run(cli.main, ["synth-video", raw, "--num-videos", "12", "--num-frames", "8",
                   "--feat-dim", "16", "--task", task])
    ids = os.path.join(raw, "test_qa.ids")
    if all_test:
        with open(ids, "w") as f:
            f.write("".join(f"qa{i}\n" for i in range(12)))
    rc, _ = run(cli.main, ["video-prepro", os.path.join(raw, "qas.jsonl"),
                           os.path.join(raw, "frame_feats.npz"), pack, "--test-ids", ids,
                           "--task", task, "--max-frames", "8", "--max-question-len", "8",
                           "--max-answer-len", "3", "--max-word-len", "6", "--word-emb-dim",
                           "16", *(["--val-fraction", "0"] if all_test else [])])
    assert rc == 0
    return pack


@pytest.fixture(scope="module")
def video_packs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_video")
    packs = {task: write_video_pack(root, task) for task in ("mc", "count", "frameqa")}
    packs["empty_train"] = write_video_pack(root, "mc", all_test=True)
    return packs


# ---- main's return code -------------------------------------------------------------

RETURN_CASES = {"no_argv": [], "-h": ["-h"], "--help": ["--help"],
                "unknown_command": ["serve-forever"], "synth_video": "synth",
                "video_empty_train_split": "empty"}


@pytest.mark.parametrize("case", list(RETURN_CASES))
def test_main_returns_what_the_jax_cli_returns(case, video_packs, tmp_path):
    argv = RETURN_CASES[case]
    if argv == "synth":
        argv = ["synth-video", str(tmp_path / "raw"), "--num-videos", "8", "--num-frames", "4",
                "--feat-dim", "8"]
    elif argv == "empty":
        argv = ["video", "--data", video_packs["empty_train"], *TINY_VIDEO]
    extra = CPU if argv and argv[0] == "video" else []
    rc_jax, _ = run(j_cli.main, argv)
    rc_port, _ = run(cli.main, argv + extra)
    expected = {"no_argv": 2, "-h": 0, "--help": 0, "unknown_command": 2, "synth_video": 0,
                "video_empty_train_split": 2}[case]
    assert rc_jax == expected
    assert rc_port == rc_jax


def test_python_m_cli_exits_with_main_s_code():
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for argv, code in ((["--help"], 0), ([], 2)):
        proc = subprocess.run([sys.executable, "-m", "fvta_memexqa_torch.cli", *argv],
                              cwd=root, capture_output=True, timeout=120)
        assert proc.returncode == code, proc.stderr


# ---- cli video's JSON line ----------------------------------------------------------

# keys whose values do not depend on the trained weights
FIXED_KEYS = ("encoder", "task", "num_frames", "cp", "chance", "answer_vocab_size", "data",
              "steps", "test_count")


@pytest.mark.parametrize("mode", ["synthetic", "data"])
@pytest.mark.parametrize("task", ["mc", "count", "frameqa"])
def test_video_json_line_has_the_jax_cli_s_keys(task, mode, video_packs):
    if mode == "synthetic":
        argv = ["video", "--task", task, "--num-videos", "8", "--num-frames", "8",
                *TINY_VIDEO]
    else:
        argv = ["video", "--data", video_packs[task], *TINY_VIDEO]
    rc_jax, ref = run(j_cli.main, argv)
    rc_port, got = run(cli.main, argv + CPU)
    assert rc_jax == rc_port == 0
    assert list(got) == list(ref)
    for k in FIXED_KEYS:
        if k in ref:
            assert got[k] == pytest.approx(ref[k]), k


# ---- predict --load-latest ----------------------------------------------------------

@pytest.fixture(scope="module")
def best_and_latest(pack_dir, packed_synth, small_config, tmp_path_factory):
    """One JAX model as two checkpoints, step 1 (val 0.9, the best) and step 2
    (its weights moved, val 0.1, the latest), in a JAX run directory and, with
    the same weights, in a port run directory whose params.pt holds the best."""
    cfg = small_config
    j_shared = JSharedTables.from_packed(packed_synth.shared)
    jb = device_put_batch(next(iter(JDataset(packed_synth, "train").get_batches(8))))
    state = j_train.init_state(cfg, JFVTAModel(cfg=cfg), j_shared, jb)
    leaves, treedef = jax.tree.flatten(state.params)
    rng = np.random.default_rng(5)
    moved = jax.tree.unflatten(treedef, [np.asarray(x) + rng.normal(0, 0.2, x.shape).astype(
        np.asarray(x).dtype) for x in leaves])
    root = tmp_path_factory.mktemp("predict_runs")
    jdir, pdir = str(root / "jax"), str(root / "port")
    ck = JCheckpointManager(jdir, cfg)
    ck.save(1, state, val_acc=0.9)
    ck.save(2, state.replace(params=moved, step=state.step + 1), val_acc=0.1)
    ck.close()
    pcfg = Config.from_json(cfg.to_json())
    pstate = tr.init_state(pcfg, "cpu")
    pck = CheckpointManager(pdir, pcfg)
    for step, params, val in ((1, state.params, 0.9), (2, moved, 0.1)):
        pstate.model.load_state_dict(
            model_from_flax(pcfg, jax.tree.map(np.asarray, params)).state_dict())
        pstate.step = step
        pck.save(step, pstate, val_acc=val)
    save_rundir(pdir, pcfg, model_from_flax(pcfg, jax.tree.map(np.asarray, state.params)))
    album = packed_synth.meta["album_ids"][1]
    argv = ["predict", pack_dir, None, "--question", "when was the trip ?", "--choices",
            "2007|2009|2011|2013", "--album-ids", album]
    return dict(jdir=jdir, pdir=pdir, pcfg=pcfg, argv=argv)


def test_predict_load_latest_answers_from_the_latest_checkpoint(best_and_latest, pack_dir):
    b = best_and_latest
    probs = {}
    for flag in ([], ["--load-latest"]):
        argv = list(b["argv"])
        rc_jax, ref = run(j_cli.main, [*argv[:2], b["jdir"], *argv[3:], *flag])
        rc_port, got = run(cli.main, [*argv[:2], b["pdir"], *argv[3:], *flag, *CPU])
        assert rc_jax == rc_port == 0
        np.testing.assert_allclose(got["probs"], ref["probs"], rtol=1e-5, atol=1e-5)
        assert got["answer"] == ref["answer"]
        probs[bool(flag)] = np.asarray(got["probs"])
    assert np.abs(probs[True] - probs[False]).max() > 1e-3   # best != latest here
    # the engine holds what train.restore_model(load_best=False) restores
    engine, store, _ = build_engine(pack_dir, b["pdir"], device="cpu", load_best=False,
                                    batch_size=1, preingest=False)
    engine.close()
    latest = tr.restore_model(b["pcfg"].replace(data=store.cfg.data), b["pdir"],
                              load_best=False, device="cpu").state_dict()
    for k, v in store.model.state_dict().items():
        assert torch.equal(v, latest[k]), k
