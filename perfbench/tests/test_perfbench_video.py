"""The video training cell end to end on the CPU at a small size: the sound
run is `correct`, and each planted fault of perfbench/faults_video.py (half a
batch, an unchanged optimizer state) and the program's bf16 path turn it
false; the traced run reads the spans the cell's span metrics name; the
frozen counts of perfbench/lib/video_costs.py."""

import json
from types import SimpleNamespace

import pytest

from perfbench import faults, harness
from perfbench.lib import costs, video_costs

CELL = "tvqa-frames-train-b128"
SEED = 2**31 + 29
TINY = {"config": {
    "data": {"max_question_len": 5, "max_answer_len": 3, "max_word_len": 6,
             "image_feat_dim": 16, "word_emb_dim": 8, "word_vocab_size": 60,
             "char_vocab_size": 20, "num_glove_words": 40},
    "video": {"max_frames": 12, "min_frames": 6, "min_question_len": 2, "min_answer_len": 1},
    "model": {"hidden_dim": 4, "char_emb_dim": 4, "char_cnn_filters": 8, "char_cnn_width": 3},
    "corpus": {"num_clips": 8, "questions_per_clip": 2}},
    "params": {"batch_size": 4}}


def _run(trace=False, **config):
    over = json.loads(json.dumps(TINY))
    for section, values in config.items():
        over["config"].setdefault(section, {}).update(values)
    return harness.run_cell(CELL, SEED, 0.05, trace, "cpu", over)


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    assert set(res["metrics"]) == {"setup_s", "train_qa_per_s"}


def test_the_kind_registers_its_faults():
    import perfbench.traffic.video_train  # noqa: F401

    assert set(faults.FAULTS["video_train"]) == {"half", "unchanged"}


@pytest.mark.parametrize("fault", ["half", "unchanged"])
def test_fault_is_not_correct(fault):
    import perfbench.traffic.video_train  # noqa: F401

    with faults.FAULTS["video_train"][fault]():
        res = _run()
    assert not res["correct"], res["checks"]


def test_bf16_program_is_not_correct():
    res = _run(model={"dtype": "bfloat16"})
    assert not res["correct"], res["checks"]


def test_traced_steps_hold_the_video_spans():
    """The traced stretch's host ranges on the main thread hold each step's
    fvta.loader.h2d, fvta.video.step and fvta.video.frames, which the cell's
    span metrics read (on the CPU no device operation is traced, so those
    metrics read nothing and are left out)."""
    import importlib

    from perfbench.lib import spans, trace

    cell = harness.load_cell(CELL, json.loads(json.dumps(TINY)))
    traffic = importlib.import_module(f"perfbench.traffic.{cell.spec['kind']}")
    drv = traffic.setup(harness.new_run(cell, SEED, "cpu"))
    try:
        tr = trace.profile(drv.step, 2, drv.sync, "cpu")
    finally:
        drv.release()
    for name in ("fvta.loader.h2d", "fvta.video.step", "fvta.video.frames"):
        assert len(spans.named(tr, (name,))) == 2, name
    assert tr.busy == [] and _run(trace=True)["metrics"] == {}


def test_step_counts():
    cell = harness.load_cell(CELL)
    d, m, v = SimpleNamespace(**cell.cfg["data"]), SimpleNamespace(**cell.cfg["model"]), \
        cell.cfg["video"]
    assert video_costs.mean_lengths(d, v) == (225.0, 16.5, 8.5)
    calls = video_costs.lstm_calls(d, m, v, 128)
    assert [(n, t, din) for n, t, din, _, _ in calls] == [(128, 225.0, 400), (128, 16.5, 400),
                                                         (640, 8.5, 400)]
    step = video_costs.step_cost(d, m, v, 128, 1000)
    # the frame projection 2048 -> 400 over the valid frames; its input takes no gradient
    assert step["layers"]["frame_proj"]["flops"] == 2 * 128 * 225 * 2048 * 400
    assert step["flops"] == pytest.approx(step["product_flops"] + 12 * 1000)
    assert len(video_costs.lstm_work(d, m, v, 128)) == 9
    assert video_costs.k2_work(d, m, v, 128) == costs.k2(128, 1, 225.0, 16.5, 200, 225.0)


@pytest.mark.gpu
def test_tf32_control_is_not_correct():
    """The control: the plain reference with TF32 on, in the program's place, at
    the cell's sizes, fails every limit."""
    import importlib

    import torch

    if not torch.cuda.is_available():
        pytest.skip("the TF32 control needs a CUDA card (TF32 exists only there)")
    cell = harness.load_cell(CELL)
    traffic = importlib.import_module(f"perfbench.traffic.{cell.spec['kind']}")
    run = harness.new_run(cell, SEED, "cuda")
    checks = harness.check(traffic, run, traffic.reference(run, tf32=True), cell.spec["limits"])
    assert all(c["value"] > c["limit"] for c in checks.values()), checks
