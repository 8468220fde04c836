"""The port's training slice vs the JAX package on the CPU, at small_config:
the model's loss and every parameter gradient at keep_prob 1 against
jax.value_and_grad(train.loss_and_metrics) with the same weights (carried by
convert.state_dict_from_flax), at the JAX suite's gradient tolerance 1e-4 /
1e-5; the data order and the cache gather against the JAX package's; the
dedup step against the plain step; bitwise resume of a killed run, also across
an epoch boundary; best-checkpoint tracking with its fallback to the latest;
and `cli train` then `cli predict` on a small pack."""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvta_memexqa_tpu import train as j_train
from fvta_memexqa_tpu.config import ModelConfig as JModelConfig
from fvta_memexqa_tpu.data import Dataset as JDataset
from fvta_memexqa_tpu.data import SharedTables as JSharedTables
from fvta_memexqa_tpu.data.device_prepro import device_put_batch
from fvta_memexqa_tpu.eval_cache import gather_cached_context as j_gather
from fvta_memexqa_tpu.models import FVTAModel as JFVTAModel

from fvta_memexqa_torch import cli
from fvta_memexqa_torch import train as tr
from fvta_memexqa_torch.checkpoint import CheckpointManager
from fvta_memexqa_torch.config import Config, MeshConfig, TrainConfig
from fvta_memexqa_torch.convert import model_from_flax, state_dict_from_flax
from fvta_memexqa_torch.data import SharedTables
from fvta_memexqa_torch.data.pipeline import Dataset
from fvta_memexqa_torch.eval_cache import gather_cached_context

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def port_config(cfg) -> Config:
    return Config.from_json(cfg.to_json())


@pytest.fixture(scope="module")
def exact_cfg(small_config):
    """small_config at keep_prob 1 (no dropout: both frameworks compute the
    same function)."""
    return small_config.replace(model=JModelConfig(hidden_dim=16, char_emb_dim=8,
                                                   char_cnn_filters=16, keep_prob=1.0))


@pytest.fixture(scope="module")
def jax_pair(packed_synth, exact_cfg):
    """(flax params, JAX loss, metrics, grads) on train batch 0 of 8 rows."""
    j_shared = JSharedTables.from_packed(packed_synth.shared)
    jb = device_put_batch(next(iter(JDataset(packed_synth, "train").get_batches(8))))
    j_model = JFVTAModel(cfg=exact_cfg)
    params = jax.jit(lambda k: j_model.init(k, j_shared, j_train.assemble(j_shared, jb),
                                            train=False))(jax.random.key(0))
    fn = jax.jit(jax.value_and_grad(
        lambda p: j_train.loss_and_metrics(j_model, p, j_shared, jb, jax.random.key(1),
                                           True), has_aux=True))
    (loss, m), grads = fn(params)
    return (jax.tree.map(np.asarray, params), float(loss),
            jax.tree.map(np.asarray, m), jax.tree.map(np.asarray, grads))


def first_batch(packed, n=8):
    return next(iter(Dataset(packed, "train").get_batches(n)))


def test_loss_and_every_grad_match_jax(packed_synth, exact_cfg, jax_pair):
    params, j_loss, j_m, j_grads = jax_pair
    model = model_from_flax(port_config(exact_cfg), params)
    shared = SharedTables.from_packed(packed_synth.shared, "cpu")
    loss, m = tr.loss_and_metrics(model, shared, first_batch(packed_synth), True,
                                  torch.Generator())
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, [p for _, p in model.named_parameters()])))
    ref = state_dict_from_flax(j_grads)
    assert set(ref) == set(grads)
    assert float(loss.detach()) == pytest.approx(j_loss, rel=1e-5)
    for k in ("correct", "count"):
        assert float(m[k]) == float(j_m[k])
    for name in names:
        torch.testing.assert_close(grads[name], ref[name], **GRAD_TOL, msg=name)


def test_dataset_order_matches_jax(packed_synth):
    mine = list(Dataset(packed_synth, "train").get_batches(5, shuffle=True, seed=3, epoch=2))
    ref = list(JDataset(packed_synth, "train").get_batches(5, shuffle=True, seed=3, epoch=2))
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        for f in ("q_words", "album_idx", "label", "ex_mask"):
            np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)))


def test_gather_cached_context_matches_jax():
    rng = np.random.default_rng(0)
    h = rng.normal(0, 1, (5, 6, 4, 3)).astype(np.float32)
    m = rng.random((5, 6, 4)) > 0.3
    idx = rng.integers(0, 5, (3, 2)).astype(np.int32)
    amask = rng.random((3, 2)) > 0.3
    got = gather_cached_context(*map(torch.from_numpy, (h, m, idx, amask)))
    ref = j_gather(*map(jnp.asarray, (h, m, idx, amask)))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_dedup_helpers_match_jax(exact_cfg):
    a = np.array([[3, 7, 0], [7, 3, 3]], np.int32)
    for got, ref in zip(tr.dedup_album_batch(a, 8), j_train.dedup_album_batch(a, 8)):
        np.testing.assert_array_equal(got, ref)
    assert tr.dedup_album_batch(np.arange(1, 13, dtype=np.int32).reshape(3, 4), 8) is None
    for bs in (3, 64):
        cfg = exact_cfg.replace(train=exact_cfg.train.__class__(batch_size=bs))
        assert tr.dedup_u_cap(port_config(cfg)) == j_train.dedup_u_cap(cfg)


def test_dedup_step_matches_plain_step(packed_synth, exact_cfg, jax_pair):
    """At keep_prob 1 the dedup loss is the same function of the parameters:
    equal loss, and every gradient equal up to summation order."""
    model = model_from_flax(port_config(exact_cfg), jax_pair[0])
    shared = SharedTables.from_packed(packed_synth.shared, "cpu")
    batch = first_batch(packed_synth)
    params = [p for _, p in model.named_parameters()]
    lp, mp = tr.loss_and_metrics(model, shared, batch, True, torch.Generator())
    gp = torch.autograd.grad(lp, params)
    uniq, inv = tr.dedup_album_batch(batch.album_idx.numpy(), tr.dedup_u_cap(model.cfg))
    ld, md = tr.dedup_loss_and_metrics(model, shared, batch, torch.from_numpy(uniq),
                                       torch.from_numpy(inv), True, torch.Generator())
    gd = torch.autograd.grad(ld, params)
    assert float(ld.detach()) == pytest.approx(float(lp.detach()), rel=1e-6)
    assert float(md["correct"]) == float(mp["correct"])
    for (name, _), a, b in zip(model.named_parameters(), gd, gp):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)


def test_dropout_follows_flax_semantics(packed_synth, small_config):
    model = tr.init_state(port_config(small_config), "cpu").model
    x = torch.ones(20000)
    g = torch.Generator().manual_seed(5)
    y = model._dropout(x, True, g)
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert abs(float(kept.float().mean()) - 0.9) < 0.01
    assert torch.equal(model._dropout(x, True, torch.Generator().manual_seed(5)), y)
    assert torch.equal(model._dropout(x, False, None), x)
    with pytest.raises(ValueError, match="Generator"):
        model._dropout(x, True, None)


def _params_and_opt(run_dir, step):
    ck = CheckpointManager(run_dir).load(step=step)
    flat = {f"p.{k}": v for k, v in ck["params"].items()}
    for field, v in ck["opt_state"].items():
        if isinstance(v, dict):
            flat.update({f"o.{field}.{k}": t for k, t in v.items()})
        else:
            flat[f"o.{field}"] = v
    return flat, ck["rng"]


class _Killed(Exception):
    pass


@pytest.mark.parametrize("kill_at", [3, 6])
def test_killed_run_resumes_bit_identically(packed_synth, small_config, tmp_path,
                                            monkeypatch, kill_at):
    """8 steps straight vs a run killed during step kill_at+1 (checkpoints every
    step) and resumed to 8, with dropout on. The train split has 16 examples:
    batches of 4 make 4 per epoch, so the resumed stream crosses an epoch
    boundary (kill_at 3) or restarts mid-epoch 1 (kill_at 6)."""
    cfg = port_config(small_config).replace(train=TrainConfig(
        batch_size=4, save_period=1, keep_checkpoints=20, val_period=5, log_period=2))
    tr.train(cfg, packed_synth, str(tmp_path / "straight"), num_steps=8, echo=False,
             device="cpu")
    real_step = tr.train_step

    def dying_step(state, *a):
        if state.step == kill_at:
            raise _Killed()
        return real_step(state, *a)

    monkeypatch.setattr(tr, "train_step", dying_step)
    with pytest.raises(_Killed):
        tr.train(cfg, packed_synth, str(tmp_path / "resumed"), num_steps=8, echo=False,
                 device="cpu")
    assert CheckpointManager(str(tmp_path / "resumed")).latest_step() == kill_at
    monkeypatch.setattr(tr, "train_step", real_step)
    tr.train(cfg, packed_synth, str(tmp_path / "resumed"), num_steps=8, echo=False,
             device="cpu")
    a, rng_a = _params_and_opt(str(tmp_path / "straight"), 8)
    b, rng_b = _params_and_opt(str(tmp_path / "resumed"), 8)
    assert set(a) == set(b)
    assert [k for k in a if not torch.equal(a[k], b[k])] == []
    assert torch.equal(rng_a, rng_b)


def test_best_checkpoint_tracking_and_latest_fallback(small_config, tmp_path, capsys):
    cfg = port_config(small_config)
    state = tr.init_state(cfg, "cpu")
    mgr = CheckpointManager(str(tmp_path / "run"), cfg, max_to_keep=2)
    for step, acc in ((1, 0.5), (2, 0.75), (3, 0.6), (4, 0.75), (5, None)):
        state.step = step
        with torch.no_grad():
            state.model.scorer.bias.fill_(float(step))
        mgr.save(step, state, val_acc=acc)
    assert mgr.latest_step() == 5
    assert sorted(os.listdir(tmp_path / "run" / "ckpts")) == ["step_4.pt", "step_5.pt"]
    assert mgr.best_step() == 4                      # ties go to the newer checkpoint
    assert sorted(os.listdir(tmp_path / "run" / "best")) == ["best.json", "step_4.pt"]
    restored = tr.init_state(cfg, "cpu")
    CheckpointManager(str(tmp_path / "run")).restore(restored, best=True)
    assert restored.step == 4 and float(restored.model.scorer.bias) == 4.0
    # no validation metric ever recorded: best=True falls back to the latest
    mgr2 = CheckpointManager(str(tmp_path / "noval"), cfg)
    state.step = 7
    mgr2.save(7, state)
    assert mgr2.best_step() is None
    assert mgr2.load(best=True)["step"] == 7
    assert "LATEST" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).load()


def test_train_refuses_a_mesh(packed_synth, small_config, tmp_path):
    cfg = port_config(small_config).replace(mesh=MeshConfig(data_parallel=2))
    with pytest.raises(NotImplementedError):
        tr.train(cfg, packed_synth, str(tmp_path), device="cpu")


def test_evaluate_matches_jax(packed_synth, exact_cfg, jax_pair):
    model = model_from_flax(port_config(exact_cfg), jax_pair[0])
    shared = SharedTables.from_packed(packed_synth.shared, "cpu")
    got = tr.evaluate(tr.make_eval_step(model), shared, Dataset(packed_synth, "val"), 4,
                      *tr.make_eval_tables(model, shared))
    j_model = JFVTAModel(cfg=exact_cfg)
    j_shared = JSharedTables.from_packed(packed_synth.shared)
    ref = j_train.evaluate(j_train.make_eval_step(exact_cfg, j_model), jax_pair[0], j_shared,
                           JDataset(packed_synth, "val"), 4)
    assert got["count"] == ref["count"]
    assert got["acc"] == ref["acc"]
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)


def test_cli_train_then_predict(pack_dir, tmp_path):
    run = str(tmp_path / "run")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["train", pack_dir, run, "--num-steps", "3", "--batch-size", "4",
                  "--hidden-dim", "16", "--char-emb-dim", "8", "--char-cnn-filters", "16",
                  "--val-period", "2", "--log-period", "1", "--use-pallas", "true",
                  "--device", "cpu"])
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["steps"] == 3 and 0.0 <= res["best_val_acc"] <= 1.0
    saved = Config.from_json(open(os.path.join(run, "config.json")).read())
    assert saved.train.dedup_albums is False and saved.model.hidden_dim == 16
    events = [json.loads(line)["event"] for line in open(os.path.join(run, "metrics.jsonl"))]
    assert events.count("val") >= 2 and "train" in events
    meta = json.load(open(os.path.join(pack_dir, "meta.json")))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["predict", pack_dir, run, "--question", "where did we go ?",
                  "--choices", "a|b|c|d", "--album-ids", meta["album_ids"][0],
                  "--device", "cpu"])
    pred = json.loads(out.getvalue().strip().splitlines()[-1])
    assert pred["albums_found"] == 1 and sum(pred["probs"]) == pytest.approx(1.0, abs=1e-5)


def test_debug_nans_switch_and_finite_loss_check(monkeypatch):
    monkeypatch.delenv("FVTA_DEBUG_NANS", raising=False)
    assert not tr.debug_nans_enabled()
    monkeypatch.setenv("FVTA_DEBUG_NANS", "1")
    assert tr.debug_nans_enabled()
    tr.check_finite_loss(1.25, 3)
    with pytest.raises(FloatingPointError, match="step 7"):
        tr.check_finite_loss(float("nan"), 7)
