"""`correct`: true for the program as the configuration states it, false for
the control and for every fault a cell can have, with the timed path broken
underneath a whole run (the chip look skipped: the CPU at a tiny size)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import faults, harness
from perfbench.tests.conftest import tiny

CELLS = ["memexqa-train-b256", "memexqa-eval-b256"]
KINDS = {"memexqa-train-b256": "memexqa_train", "memexqa-eval-b256": "memexqa_eval"}
SEED = 2**31 + 17


def _run(cell, **config):
    return harness.run_cell(cell, SEED, 0.05, False, "cpu", tiny(cell, **config))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks" and set(res["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in faults.FAULTS[KINDS[c]]])
def test_fault_is_not_correct(cell, fault):
    with faults.FAULTS[KINDS[cell]][fault]():
        res = _run(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_bf16_program_is_not_correct(cell):
    """The program's own lower-precision path (ModelConfig.dtype) switched on."""
    res = _run(cell, model={"dtype": "bfloat16"})
    assert not res["correct"], res["checks"]


def test_change_gap_keeps_what_a_later_step_moves():
    """An entry that the first step leaves alone and a later step moves (an
    embedding row absent from the first batch) is compared."""
    import torch

    from perfbench.lib import compare

    g1 = {"a": torch.tensor([1.0, 1.0, 0.0]), "b": torch.ones(3), "c": torch.ones(3)}
    ref = {"losses": [1.0, 1.0, 1.0], "grad1": g1, "grad_max": {**g1, "a": torch.ones(3)},
           "delta3": {n: torch.full((3,), 1e-3) for n in g1}}
    prog = {**ref, "delta3": {**ref["delta3"], "a": torch.tensor([1e-3, 1e-3, 0.0])}}
    assert compare._numbers(ref, ref)[0]["change_gap"] == 0
    assert compare._numbers(prog, ref)[0]["change_gap"] > 0.1


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_is_not_correct(cell):
    """The control: the plain reference with TF32 on, in the program's place, at
    the published widths and a smaller batch than the cell's."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the TF32 control needs a CUDA card (TF32 exists only there)")
    small = {"memexqa-train-b256": {"batch_size": 64, "train_questions": 256},
             "memexqa-eval-b256": {"questions": 2048}}[cell]
    cell_ns = harness.load_cell(cell, {"params": small})
    import importlib

    traffic = importlib.import_module(f"perfbench.traffic.{cell_ns.spec['kind']}")
    run = harness.new_run(cell_ns, SEED, "cuda")
    checks = harness.check(traffic, run, traffic.reference(run, tf32=True),
                           cell_ns.spec["limits"])
    assert any(c["value"] > c["limit"] for c in checks.values()), checks


def test_command_refuses_a_machine_without_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "memexqa-eval-b256",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_command_fails_without_the_program(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "memexqa-eval-b256",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_result_line_is_json_with_nulls_for_inf():
    sys.path.insert(0, str(harness.BENCH))
    import run

    line = json.dumps(run.finite({"checks": {"a": {"value": float("inf"), "limit": 1.0}}}),
                      allow_nan=False)
    assert json.loads(line)["checks"]["a"]["value"] is None
