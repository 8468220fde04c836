"""The port's data and context parallelism (parallel/mesh.py, parallel/cp.py)
against the JAX package's (tests/test_parallel.py's cases) on the CPU. The
port's ranks are gloo processes spawned by mesh.run_ranks (what they run is in
tests/_torch_rank_fns.py, which imports no JAX); the JAX package runs on the 8
virtual devices tests/conftest.py forces. Each launch has a timeout of its
own that kills its ranks, so a hung rendezvous fails one test.

- the layout and its errors; a failing rank's error raised, a hung rank killed;
- the DP-2 train-step gradient against the JAX DP-2 mesh gradient at rtol
  1e-4 / atol 1e-6, plain and through the dedup encode;
- the DP train loop: every rank's parameters, optimizer state and dropout
  generator equal, two identical DP runs bitwise equal, a DP checkpoint
  resumed at world 1 against a same-world continuation at atol 1e-3, and
  evaluated on one rank;
- `test` cached, uncached and with the row-sharded cache against one rank
  (acc within 1e-6, by_category equal); the sharded cache's probabilities
  bitwise the replicated cache's, its per-rank bytes, and its errors;
- CP attention against the JAX make_cp_attention at cp 2 and 4 (outputs at
  rtol 1e-5 / atol 1e-6, gradients at 1e-4 / 1e-5), a dead shard, an exact
  tie across ranks; the small flagship model with CP attention (logits at
  2e-5, gradients at rtol 5e-4 / atol 1e-5);
- `cli train --data-parallel 2`, `cli test --data-parallel 2 --shard-cache`
  and `cli video --cp 2` against the JAX CLI on the same argv;
- maybe_initialize_distributed without torchrun's environment; `cli train`
  under torchrun against the ranks the port launches, and a torchrun group's
  layout over several hosts."""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_rank_fns as rf
from fvta_memexqa_tpu import bench_lib as j_bench
from fvta_memexqa_tpu import cli as j_cli
from fvta_memexqa_tpu import train as j_train
from fvta_memexqa_tpu.config import DataConfig as JDataConfig
from fvta_memexqa_tpu.config import MeshConfig as JMeshConfig
from fvta_memexqa_tpu.config import ModelConfig as JModelConfig
from fvta_memexqa_tpu.data import Dataset as JDataset
from fvta_memexqa_tpu.data import SharedTables as JSharedTables
from fvta_memexqa_tpu.data.device_prepro import assemble as j_assemble
from fvta_memexqa_tpu.data.device_prepro import device_put_batch
from fvta_memexqa_tpu.models import FVTAModel as JFVTAModel
from fvta_memexqa_tpu.parallel.cp import make_cp_attention as j_make_cp, shard_context
from fvta_memexqa_tpu.parallel.mesh import make_mesh as j_make_mesh
from fvta_memexqa_tpu.parallel.mesh import replicated, shard_batch

from fvta_memexqa_torch import bench_lib, cli
from fvta_memexqa_torch import train as tr
from fvta_memexqa_torch.config import Config, MeshConfig, TrainConfig
from fvta_memexqa_torch.convert import model_from_flax, state_dict_from_flax
from fvta_memexqa_torch.data import load_pack
from fvta_memexqa_torch.eval_cache import _sharded_cache_setup
from fvta_memexqa_torch.parallel import mesh

LAUNCH_TIMEOUT_S = 240.0
DP2 = MeshConfig(data_parallel=2)
TC = dict(batch_size=8, eval_batch_size=8, learning_rate=1e-3, num_epochs=1,
          val_period=2, save_period=100, log_period=2, seed=0)


@pytest.fixture(autouse=True)
def launch_timeout(monkeypatch):
    monkeypatch.setattr(mesh, "RANK_TIMEOUT_S", LAUNCH_TIMEOUT_S)


def ranks(fn, cfg_mesh, *args):
    return mesh.run_ranks(fn, mesh.make_mesh(cfg_mesh, device="cpu"), *args)


def port(cfg) -> Config:
    return Config.from_json(cfg.to_json())


@pytest.fixture(scope="module")
def ppack(pack_dir):
    return load_pack(pack_dir)


@pytest.fixture(scope="module")
def exact_cfg(small_config):
    return small_config.replace(model=JModelConfig(hidden_dim=16, char_emb_dim=8,
                                                   char_cnn_filters=16, keep_prob=1.0))


# ---- the layout ---------------------------------------------------------------------

def test_make_mesh_layout():
    lay = mesh.make_mesh(MeshConfig(data_parallel=4, context_parallel=2), device="cpu")
    assert lay.shape == {"data": 4, "ctx": 2} and lay.world == 8
    assert [lay.coords(r) for r in (0, 1, 2, 7)] == [(0, 0), (0, 1), (1, 0), (3, 1)]
    assert lay.backend == "gloo" and lay.devices == ("cpu",) * 8
    shared = mesh.make_mesh(MeshConfig(context_parallel=4), ["cuda"] * 4)
    assert shared.devices == ("cuda:0",) * 4 and shared.backend == "gloo"
    own = mesh.make_mesh(DP2, ["cuda:0", "cuda:1", "cuda:2"])
    assert own.devices == ("cuda:0", "cuda:1") and own.backend == "nccl"


def test_too_few_devices_raises():
    if torch.cuda.device_count() < 16:
        with pytest.raises(ValueError, match="needs 16 devices"):
            mesh.make_mesh(MeshConfig(data_parallel=16))
    with pytest.raises(ValueError, match="needs 4 devices, have 2"):
        mesh.make_mesh(MeshConfig(data_parallel=2, context_parallel=2), ["cpu", "cpu"])


def test_group_devices_place_each_rank_on_its_hosts_card(monkeypatch):
    """A torchrun group's layout (current_rank without devices=): rank r on
    card LOCAL_RANK % cards of its own host, torchrun numbering each host's
    ranks contiguously, with no check of the world against this host's cards:
    2 hosts of 8 cards make 16 ranks, 4 ranks on a host of 2 cards share them."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    devs = mesh.group_devices(16)
    assert devs == [f"cuda:{r % 8}" for r in range(16)]
    lay = mesh.make_mesh(MeshConfig(data_parallel=16), devs)
    assert lay.world == 16 and lay.device(11) == torch.device("cuda:3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert mesh.group_devices(8) == ["cuda:0", "cuda:1"] * 4
    assert mesh.group_devices(3, "cpu") == ["cpu"] * 3


def test_a_failing_rank_raises_its_error_here():
    with pytest.raises(ValueError, match="rank 1 fails"):
        ranks(rf.rank_fails, DP2, 1)


def test_a_hung_rank_is_killed_at_the_timeout():
    with pytest.raises(TimeoutError, match="did not finish"):
        mesh.run_ranks(rf.rank_hangs, mesh.make_mesh(DP2, device="cpu"), timeout=8.0)


def test_maybe_initialize_distributed_is_a_noop_without_torchrun(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.maybe_initialize_distributed() is False
    assert not mesh.in_group() and mesh.is_first_rank()


# ---- the DP train step --------------------------------------------------------------

@pytest.fixture(scope="module")
def dp_grads_pair(packed_synth, ppack, exact_cfg):
    """The JAX DP-2 mesh gradients (plain and dedup, train=False) of train
    batch 0 (8 rows) and the port's step_grads on 2 gloo ranks, same weights."""
    cfg = exact_cfg.replace(mesh=JMeshConfig(data_parallel=2))
    j_shared = JSharedTables.from_packed(packed_synth.shared)
    jb = device_put_batch(next(iter(JDataset(packed_synth, "train").get_batches(8))))
    model = JFVTAModel(cfg=cfg)
    params = jax.jit(lambda k: model.init(k, j_shared, j_assemble(j_shared, jb),
                                          train=False))(jax.random.key(0))
    jmesh = j_make_mesh(cfg.mesh)
    shared_r = jax.device_put(j_shared, replicated(jmesh))
    batch_s = shard_batch(jmesh, jb)
    g_plain = jax.jit(jax.grad(lambda p: j_train.loss_and_metrics(
        model, p, shared_r, batch_s, jax.random.key(7), False)[0]))(params)
    pcfg = port(cfg)
    uniq, inv = j_train.dedup_album_batch(np.asarray(jb.album_idx), tr.dp_u_cap(pcfg))
    put = lambda x: jax.device_put(x, jax.sharding.NamedSharding(
        jmesh, jax.sharding.PartitionSpec("data")))
    a1 = JFVTAModel(cfg=j_train.a1_config(cfg))
    g_dedup = jax.jit(jax.grad(lambda p: j_train.dedup_loss_and_metrics(
        model, a1, p, shared_r, batch_s, put(uniq), put(inv), None, False)[0]))(params)
    sd = model_from_flax(pcfg, jax.tree.map(np.asarray, params)).state_dict()
    got = ranks(rf.dp_grads, pcfg.mesh, pcfg, ppack, sd, 8)
    ref = {"plain": state_dict_from_flax(jax.tree.map(np.asarray, g_plain)),
           "dedup": state_dict_from_flax(jax.tree.map(np.asarray, g_dedup))}
    return got, ref


@pytest.mark.parametrize("path", ["plain", "dedup"])
def test_dp_train_step_gradient_matches_jax_dp_mesh(dp_grads_pair, path):
    got, ref = dp_grads_pair
    assert got[path]["same"], "the ranks hold different gradients"
    assert set(got[path]["grads"]) == set(ref[path])
    for name, g in got[path]["grads"].items():
        torch.testing.assert_close(g, ref[path][name], rtol=1e-4, atol=1e-6, msg=name)


# ---- the DP train loop, resume and checkpoints --------------------------------------

@pytest.fixture(scope="module")
def dp_runs(small_config, ppack, tmp_path_factory):
    """Two identical DP-2 runs of one epoch (dropout on)."""
    root = tmp_path_factory.mktemp("dp_runs")
    cfg = port(small_config).replace(mesh=DP2, train=TrainConfig(**TC))
    dirs = [str(root / "a"), str(root / "b")]
    return cfg, dirs, [ranks(rf.train_ranks, DP2, cfg, ppack, d) for d in dirs]


def test_dp_train_loop_keeps_every_rank_equal(dp_runs):
    _, _, (a, _) = dp_runs
    assert a["steps"] > 0 and 0.0 <= a["best_val_acc"] <= 1.0
    assert a["ranks_equal"]


def test_two_identical_dp_runs_are_bitwise_equal(dp_runs):
    _, dirs, (a, b) = dp_runs
    assert a["steps"] == b["steps"]
    assert [k for k in a["params"] if not torch.equal(a["params"][k], b["params"][k])] == []
    ck = [torch.load(os.path.join(d, "ckpts", f"step_{a['steps']}.pt"), weights_only=True)
          for d in dirs]
    assert torch.equal(ck[0]["rng"], ck[1]["rng"])
    for k, v in ck[0]["opt_state"].items():
        if isinstance(v, dict):
            assert all(torch.equal(t, ck[1]["opt_state"][k][n]) for n, t in v.items()), k


def test_context_ranks_are_replicas_in_memexqa_training(dp_runs, ppack, tmp_path):
    """A (2, 2) mesh trains as DP-2: each ctx column reduces over its data
    ranks, the replicas hold the same rows, and the parameters equal the DP-2
    run's bit for bit."""
    cfg, _, (a, _) = dp_runs
    mesh22 = MeshConfig(data_parallel=2, context_parallel=2)
    got = ranks(rf.train_ranks, mesh22, cfg.replace(mesh=mesh22), ppack,
                str(tmp_path / "dp2cp2"))
    assert got["ranks_equal"] and got["steps"] == a["steps"]
    assert [k for k in a["params"] if not torch.equal(a["params"][k], got["params"][k])] == []


def test_resume_on_a_different_world_size(dp_runs, ppack, tmp_path):
    """A DP-2 checkpoint continued at world 1 against the same checkpoint
    continued at world 2: only the reduction order differs."""
    cfg, dirs, (a, _) = dp_runs
    elastic, same = str(tmp_path / "elastic"), str(tmp_path / "same")
    shutil.copytree(dirs[0], elastic)
    shutil.copytree(dirs[0], same)
    two_epochs = dataclasses.replace(cfg.train, num_epochs=2)
    res_el = tr.train(cfg.replace(mesh=MeshConfig(), train=two_epochs), ppack, elastic,
                      echo=False, device="cpu")
    res_ref = ranks(rf.train_ranks, DP2, cfg.replace(train=two_epochs), ppack, same)
    assert res_el["steps"] == res_ref["steps"] == 2 * a["steps"]
    for k, v in res_el["state"].params.items():
        torch.testing.assert_close(v.detach(), res_ref["params"][k], rtol=0, atol=1e-3,
                                   msg=k)


def test_dp_checkpoint_evaluates_on_one_rank(dp_runs, ppack):
    cfg, dirs, _ = dp_runs
    m = tr.test(cfg.replace(mesh=MeshConfig()), ppack, dirs[0], split="train", echo=False,
                device="cpu")
    assert 0.0 <= m["acc"] <= 1.0 and m["count"] > 0


# ---- DP evaluation and the row-sharded cache ----------------------------------------

@pytest.fixture(scope="module")
def single_run(small_config, ppack, tmp_path_factory):
    cfg = port(small_config).replace(train=TrainConfig(**TC))
    out = str(tmp_path_factory.mktemp("eval_run") / "run")
    tr.train(cfg, ppack, out, echo=False, device="cpu")
    return cfg, out


def test_test_on_dp_ranks_matches_one_rank(single_run, ppack):
    cfg, out = single_run
    ref = tr.test(cfg, ppack, out, split="train", echo=False, by_category=True,
                  device="cpu")
    got = ranks(rf.eval_variants, DP2, cfg.replace(mesh=DP2), ppack, out)
    for name, m in got.items():
        assert m["count"] == ref["count"], name
        assert m["acc"] == pytest.approx(ref["acc"], abs=1e-6), name
    assert got["cached"]["by_category"] == ref["by_category"]
    assert got["sharded"]["by_category"] == ref["by_category"]
    with pytest.raises(ValueError, match="shard-cache"):
        tr.test(cfg.replace(mesh=DP2), ppack, out, split="train", echo=False,
                album_cache=False, shard_cache=True, device="cpu")


def test_sharded_cache_is_bitwise_the_replicated_cache(single_run, ppack):
    cfg, out = single_run
    got = ranks(rf.sharded_cache, DP2, cfg.replace(mesh=DP2), ppack, out, 8)
    np.testing.assert_array_equal(got["probs_sharded"]["probs"], got["probs"]["probs"])
    np.testing.assert_array_equal(got["probs_sharded"]["label"], got["probs"]["label"])
    ev, ev_s = got["eval"], got["eval_sharded"]
    assert set(ev) == {"acc", "loss", "count"}
    assert set(ev_s) == {"acc", "loss", "count", "cache_bytes_per_device"}
    assert ev_s["count"] == ev["count"] and ev_s["acc"] == ev["acc"]
    assert ev_s["loss"] == pytest.approx(ev["loss"], rel=1e-6)
    per = ev_s["cache_bytes_per_device"]
    assert len(per) == 2 and all(b == per[0] > 0 for b in per)
    assert sum(per) < 1.25 * got["full_bytes"]


def test_sharded_cache_setup_needs_a_mesh_and_a_divisible_batch():
    cache = (torch.zeros(5, 6, 3, 4), torch.ones(5, 6, 3, dtype=torch.bool))
    with pytest.raises(ValueError, match="mesh"):
        _sharded_cache_setup(None, cache, 8)
    rank = mesh.Rank(mesh.make_mesh(DP2, device="cpu"), 1)
    with pytest.raises(ValueError, match="divisible"):
        _sharded_cache_setup(rank, cache, 7)
    h, m = _sharded_cache_setup(rank, cache, 8)      # rows 3-5 of 6 (one pad row)
    assert h.shape[0] == 3 and m[:2].all() and not m[2].any()


# ---- context parallelism ------------------------------------------------------------

def cp_case(n=2, s=4, t=32, j=5, d=8, seed=0, dead=False, tie=False):
    """tests/test_parallel.py's TestCPAttention.make_case; dead: the second
    half of T masked; tie: time steps 1 and 17 equal and dominant, so the
    sequence max ties exactly across ranks."""
    rng = np.random.default_rng(seed)
    h = rng.normal(0, 1, (n, s, t, d)).astype(np.float32)
    q = rng.normal(0, 1, (n, j, d)).astype(np.float32)
    t_len = rng.integers(1, t + 1, (n, s))
    j_len = rng.integers(1, j + 1, n)
    cm = np.arange(t)[None, None, :] < t_len[..., None]
    qm = np.arange(j)[None, :] < j_len[:, None]
    params = {k: rng.normal(0, 1, d).astype(np.float32) for k in ("w_x", "w_y", "w_xy")}
    if dead:
        cm[:, :, t // 2:] = False
    if tie:
        cm[:] = True
        h[:, :, 1] *= 3.0
        h[:, :, t // 2 + 1] = h[:, :, 1]
    return (h * cm[..., None], cm, q * qm[..., None], qm, params)


CP_CASES = {"plain": dict(seed=11), "dead_shard": dict(seed=3, dead=True),
            "tie": dict(seed=5, tie=True)}


def jax_cp(case, cp):
    h, cm, q, qm, params = (jnp.asarray(x) if not isinstance(x, dict) else
                            {k: jnp.asarray(v) for k, v in x.items()} for x in case)
    jmesh = j_make_mesh(JMeshConfig(data_parallel=8 // cp, context_parallel=cp))
    attn = j_make_cp(jmesh, "trilinear")
    h_s, cm_s = shard_context(jmesh, h, cm)

    def loss(h_, p_):
        o = attn(h_, cm_s, q, qm, p_)
        return (o.context ** 2).sum() + (o.question ** 2).sum(), o

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        h_s, params)
    return out, [grads[0], *(grads[1][k] for k in ("w_x", "w_y", "w_xy"))]


@pytest.fixture(scope="module", params=[2, 4])
def cp_pair(request):
    cp = request.param
    cases = {k: cp_case(**kw) for k, kw in CP_CASES.items()}
    got = ranks(rf.cp_attention, MeshConfig(context_parallel=cp), list(cases.values()))
    return cp, dict(zip(cases, got)), {k: jax_cp(c, cp) for k, c in cases.items()}


@pytest.mark.parametrize("case", list(CP_CASES))
def test_cp_attention_matches_jax(cp_pair, case):
    cp, got, ref = cp_pair
    g, (out, grads) = got[case], ref[case]
    for f in ("context", "question", "time_attn", "seq_attn"):
        np.testing.assert_allclose(g[f].numpy(), np.asarray(getattr(out, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f"{f} at cp={cp}")
    for name, a, b in zip(("h", "w_x", "w_y", "w_xy"), g["grads"], grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5,
                                   err_msg=f"d{name} at cp={cp}")
    assert g["same"]
    assert np.isfinite(g["context"].numpy()).all()


def test_flagship_cp_matches_jax_small():
    """TestFlagshipCP.test_cp_attention_matches_local_small: the flagship model
    with CP attention over 4 ranks against the JAX model with its CP attention
    on a (2, 4) mesh, same weights and inputs."""
    jcfg = j_bench.realistic_config().replace(
        data=JDataConfig(max_albums=2, max_photos=5, max_question_len=9, max_answer_len=4,
                         max_sent_len=6, max_album_text_len=8, max_word_len=7,
                         image_feat_dim=48, word_emb_dim=36, word_vocab_size=300,
                         char_vocab_size=40, num_glove_words=220),
        model=JModelConfig(hidden_dim=20, char_emb_dim=8, char_cnn_filters=12))
    model = JFVTAModel(cfg=jcfg)
    shared = j_bench.synth_shared(jcfg, num_albums=5, num_photos=15)
    batch = j_bench.synth_batch(jcfg, batch_size=4, num_albums=5)
    mi = j_assemble(shared, batch)
    params = jax.jit(lambda k: model.init(k, shared, mi, train=False))(jax.random.key(0))
    cp = j_make_cp(j_make_mesh(JMeshConfig(data_parallel=2, context_parallel=4)),
                   jcfg.model.similarity)

    def loss(p):
        out = model.apply(p, shared, mi, train=False, cp_attention=cp)
        logp = jax.nn.log_softmax(out.logits)
        return -jnp.mean(jnp.take_along_axis(logp, mi.label[:, None], 1)), out.logits

    (l_ref, lg_ref), g_ref = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    pcfg = port(jcfg)
    sd = model_from_flax(pcfg, jax.tree.map(np.asarray, params)).state_dict()
    got = ranks(rf.flagship_cp, MeshConfig(context_parallel=4), pcfg, sd,
                bench_lib.synth_shared(pcfg, num_albums=5, num_photos=15, device="cpu"),
                bench_lib.synth_batch(pcfg, batch_size=4, num_albums=5, device="cpu"))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(lg_ref), rtol=2e-5,
                               atol=2e-5)
    assert got["loss"] == pytest.approx(float(l_ref), rel=1e-5)
    ref = state_dict_from_flax(jax.tree.map(np.asarray, g_ref))
    for name, g in got["grads"].items():
        torch.testing.assert_close(g, ref[name], rtol=5e-4, atol=1e-5, msg=name)
    assert got["same"]


def test_cp_video_attention_dump_gathers_the_frame_axis(tmp_path):
    """dump_video_attention on 2 CP ranks writes the one-rank dump: every
    rank's time_attn shard gathered along the frame axis."""
    from fvta_memexqa_torch.config import DataConfig, ModelConfig
    from fvta_memexqa_torch.data import video_pack as vp
    from fvta_memexqa_torch import train_video as tv

    pack, run = str(tmp_path / "vpack"), str(tmp_path / "vrun")
    small = dict(max_question_len=8, max_answer_len=3, max_word_len=6, word_emb_dim=16)
    qas, feats, test_ids = vp.make_synthetic_video_raw(num_videos=16, num_frames=16,
                                                       feat_dim=16, seed=2)
    vp.pack_video(qas, feats, test_ids, None, pack, DataConfig(**small), max_frames=16,
                  shard_size=8)
    cfg = Config(data=DataConfig(**small),
                 model=ModelConfig(hidden_dim=8, char_emb_dim=4, char_cnn_filters=8,
                                   keep_prob=1.0, vocab_embed=True),
                 train=TrainConfig(batch_size=4, eval_batch_size=4, val_period=1000,
                                   log_period=100))
    tv.train_video(cfg, pack, run, num_steps=1, echo=False, device="cpu")
    ref = str(tmp_path / "one.npz")
    tv.test_video(run, echo=False, attention_path=ref, device="cpu")
    got = str(tmp_path / "cp")
    n = ranks(rf.cp_video_dump, MeshConfig(context_parallel=2), run, got)
    a, b = np.load(got + ".0.npz"), np.load(ref)
    assert n == len(b["qid"]) and sorted(a.files) == sorted(b.files)
    assert a["time_attn"].shape == b["time_attn"].shape
    for k in ("time_attn", "seq_attn", "probs"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6, err_msg=k)
    for k in ("qid", "pred", "label", "seq_names"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---- the CLI ------------------------------------------------------------------------

WIDTHS = ["--batch-size", "8", "--eval-batch-size", "8", "--hidden-dim", "16",
          "--char-emb-dim", "8", "--char-cnn-filters", "16"]


def run_cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None)


def test_cli_train_and_test_on_dp_ranks_as_the_jax_cli(pack_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("FVTA_NO_COMPILE_CACHE", "1")
    res = {}
    for name, main, extra in (("jax", j_cli.main, []), ("port", cli.main, ["--device", "cpu"])):
        run = str(tmp_path / name)
        rc_t, trained = run_cli(main, ["train", pack_dir, run, "--num-steps", "2",
                                       "--val-period", "2", "--data-parallel", "2",
                                       *WIDTHS, *extra])
        rc_e, tested = run_cli(main, ["test", pack_dir, run, "--data-parallel", "2",
                                      "--shard-cache", "--eval-batch-size", "8", *extra])
        res[name] = (rc_t, trained, rc_e, tested)
    (rc_tj, tj, rc_ej, ej), (rc_tp, tp, rc_ep, ep) = res["jax"], res["port"]
    assert rc_tj == rc_tp == 0 and rc_ej == rc_ep == 0
    assert list(tp) == list(tj) and tp["steps"] == tj["steps"] == 2
    assert list(ep) == list(ej)
    assert ep["count"] == ej["count"] and ep["split"] == ej["split"] == "test"


def test_cli_video_cp_as_the_jax_cli(monkeypatch):
    monkeypatch.setenv("FVTA_NO_COMPILE_CACHE", "1")
    argv = ["video", "--num-videos", "8", "--num-frames", "8", "--steps", "1",
            "--batch-size", "4", "--hidden-dim", "8", "--cp", "2"]
    rc_j, ref = run_cli(j_cli.main, argv)
    rc_p, got = run_cli(cli.main, argv + ["--device", "cpu"])
    assert rc_j == rc_p == 0
    assert list(got) == list(ref)
    for k in ("encoder", "task", "num_frames", "cp", "chance"):
        assert got[k] == ref[k], k


def test_cli_train_under_torchrun_equals_the_launched_ranks(pack_dir, tmp_path):
    """`torchrun --standalone --nproc-per-node 2 -m fvta_memexqa_torch.cli
    train ... --data-parallel 2 --device cpu`: main joins torchrun's group,
    each process runs one rank, rank 0 alone prints, and the run directory's
    parameters are bitwise those of the same command whose ranks the port
    launches itself."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = lambda run: ["train", pack_dir, run, "--num-steps", "2", "--val-period", "2",
                        "--data-parallel", "2", *WIDTHS, "--device", "cpu"]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [repo, *filter(None, [os.environ.get("PYTHONPATH")])]), "OMP_NUM_THREADS": "1"}
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    tr_run, own_run = str(tmp_path / "torchrun"), str(tmp_path / "launched")
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node", "2", "-m", "fvta_memexqa_torch.cli",
                           *argv(tr_run)], env=env, cwd=str(tmp_path), capture_output=True,
                          text=True, timeout=LAUNCH_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    printed = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    rc, launched = run_cli(cli.main, argv(own_run))
    assert rc == 0 and printed == [launched] and launched["steps"] == 2
    a, b = (torch.load(os.path.join(r, "params.pt"), map_location="cpu")
            for r in (tr_run, own_run))
    assert set(a) == set(b) and [k for k in a if not torch.equal(a[k], b[k])] == []
