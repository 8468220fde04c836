"""The port's benchmark functions and capacity probe on the CPU
(fvta_memexqa_torch/bench_lib.py, fvta_memexqa_torch/capacity_probe.py), held
against the JAX package's (fvta_memexqa_tpu/bench_lib.py, capacity_probe.py):

- `realistic_config` field for field, and `synth_shared` / `synth_batch` array
  for array at one seed;
- `_median_slope` with a patched clock;
- `step_cost`'s product FLOPs against torch.utils.flop_counter over the plain
  forward and a train step at a small configuration (the count stays tied to
  the work whatever kernel does it), `video_step_cost` over the video forward;
- each bench function on the CPU at a tiny configuration with k = 1 / 2 returns
  a finite positive rate, and raises on "cuda" without a card;
- tests/test_capacity_probe.py's cases for the port: both paths at T = 64 and
  at T = 1024 (where the kernel path streams), forward and with grad; t_list
  probes exactly the listed points; an OutOfMemoryError is recorded and any
  other error re-raised; the minted inputs against the JAX probe's fill.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from torch.utils.flop_counter import FlopCounterMode

from fvta_memexqa_tpu import bench_lib as jax_bench

from fvta_memexqa_torch import bench_lib, capacity_probe
from fvta_memexqa_torch.data.device_prepro import assemble
from fvta_memexqa_torch.ops import fvta_fused
from fvta_memexqa_torch.train import init_state, loss_and_metrics, make_eval_tables


def tiny_config():
    """realistic_config cut to a few words, photos and units (every shape the
    step costs read stays distinct)."""
    cfg = bench_lib.realistic_config()
    return cfg.replace(
        data=dataclasses.replace(cfg.data, word_vocab_size=300, num_glove_words=200,
                                 image_feat_dim=48, max_photos=5, max_sent_len=4,
                                 max_album_text_len=6, max_question_len=7,
                                 max_answer_len=3, max_word_len=8),
        model=dataclasses.replace(cfg.model, hidden_dim=6, char_cnn_filters=10,
                                  char_emb_dim=4))


TINY = dict(num_albums=9, num_photos=20)


# ---- the synthetic inputs against the JAX package ---------------------------------

def test_realistic_config_is_the_jax_config():
    for pallas in (False, True):
        port = bench_lib.realistic_config(use_pallas=pallas)
        ref = jax_bench.realistic_config(use_pallas=pallas)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_synth_shared_and_batch_equal_the_jax_arrays():
    """At MemexQA v1.1 size (630 albums, 5090 photos, F = 2537, 12000 words)
    and one seed, every array equals the JAX one."""
    cfg, jcfg = bench_lib.realistic_config(), jax_bench.realistic_config()
    shared = bench_lib.synth_shared(cfg, seed=3, device="cpu")
    jshared = jax_bench.synth_shared(jcfg, seed=3)
    for name in jshared.__dataclass_fields__:
        a, b = getattr(shared, name).numpy(), np.asarray(getattr(jshared, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    batch = bench_lib.synth_batch(cfg, 64, seed=4, device="cpu")
    jbatch = jax_bench.synth_batch(jcfg, 64, seed=4)
    for name in jbatch.__dataclass_fields__:
        a, b = getattr(batch, name).numpy(), np.asarray(getattr(jbatch, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name


# ---- timing -----------------------------------------------------------------------

def test_median_slope_with_a_patched_clock(monkeypatch):
    """run(k) costs 0.25 s plus 10 ms a step (+1 ms of jitter on every other
    call): the slope is the per-step time, the constant cancels, and the
    median drops the jittered readings' outlier."""
    clock = [0.0]
    calls = []

    def run(k):
        calls.append(k)
        clock[0] += 0.25 + 0.01 * k + (0.001 if len(calls) % 2 else 0.0)

    monkeypatch.setattr(bench_lib.time, "perf_counter", lambda: clock[0])
    slope = bench_lib._median_slope(run, 2, 12, 3)
    assert calls == [2, 12] + [2, 2, 12] * 3
    assert math.isclose(slope, 0.01, rel_tol=0.11)


def test_bench_functions_need_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("this box has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_lib.synth_shared(tiny_config(), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_lib.bench_train(tiny_config())
    assert bench_lib.device_peaks("cpu") is None


# ---- the step costs against torch's FLOP counter ------------------------------------

def test_step_cost_products_match_the_flop_counter():
    """The serving forward (tables precomputed) and a train step (tables
    recomputed, backward) of the plain model: step_cost's product FLOPs equal
    what FlopCounterMode counts; the totals add Adam; bytes are positive."""
    cfg = tiny_config()
    shared = bench_lib.synth_shared(cfg, **TINY, device="cpu")
    batch = bench_lib.synth_batch(cfg, 3, num_albums=9, device="cpu")
    model = bench_lib._eval_model(cfg, torch.device("cpu"))
    vt, pt = make_eval_tables(model, shared)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(shared, assemble(shared, batch, pt), vt)
    fwd = bench_lib.step_cost(cfg, 3)
    assert fwd["product_flops"] == fwd["flops"] == fc.get_total_flops()
    state = init_state(cfg, "cpu")
    with FlopCounterMode(display=False) as fc:
        loss, _ = loss_and_metrics(state.model, shared, batch, True, state.generator)
        loss.backward()
    step = bench_lib.step_cost(cfg, 3, train=True)
    assert step["product_flops"] == fc.get_total_flops()
    params = sum(p.numel() for p in state.model.parameters())
    assert step["flops"] == step["product_flops"] + 12 * params
    assert step["bytes"] > 3 * fwd["bytes"] > 0
    assert set(step["layers"]) >= {"bilstm_question", "attention", "scorer", "backward", "adam",
                                   "char_cnn_vocab", "highway_vocab", "photo_proj"}


def test_video_step_cost_matches_the_flop_counter():
    """The video forward (realistic_config, mc head, dilated-conv encoder) at a
    short T: video_step_cost's product FLOPs equal FlopCounterMode's."""
    model, shared, vi = bench_lib._video_setup(16, False, 2, 0, torch.device("cpu"))
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(shared, vi)
    assert bench_lib.video_step_cost(16, batch_size=2)["product_flops"] == fc.get_total_flops()


# ---- each bench function on the CPU --------------------------------------------------

FAST = dict(k_small=1, k_large=2, reps=1, device="cpu")


@pytest.fixture
def step_clock(monkeypatch):
    """The bench functions' clock, advanced 1 ms by every timed step (each
    step computes its feedback once) and 1 us by every reading: the CPU's
    wall-clock noise under parallel test workers exceeds a tiny step, and
    the slope itself is tested above."""
    clock = [0.0]
    real = bench_lib._feedback

    def tick():
        clock[0] += 1e-6
        return clock[0]

    def feedback(x):
        clock[0] += 1e-3
        return real(x)

    monkeypatch.setattr(bench_lib.time, "perf_counter", tick)
    monkeypatch.setattr(bench_lib, "_feedback", feedback)


def _rate_ok(x):
    return math.isfinite(x) and x > 0


def test_bench_train_and_dedup_run_on_cpu(step_clock):
    cfg = tiny_config()
    assert _rate_ok(bench_lib.bench_train(cfg, batch_size=4, **FAST))
    qps, frac = bench_lib.bench_train_dedup(cfg, batch_size=4, **FAST)
    assert _rate_ok(qps) and 0 < frac <= 1


@pytest.mark.parametrize("cache_dtype,n_chunks", [("float32", 1), ("bfloat16", 2)])
def test_bench_cached_inference_runs_on_cpu(step_clock, cache_dtype, n_chunks):
    cfg = tiny_config()
    qps, cache_s, prebuilt = bench_lib.bench_cached_inference(
        cfg, batch_size=4, cache_dtype=cache_dtype, n_chunks=n_chunks, **FAST)
    assert _rate_ok(qps) and cache_s > 0
    qps2, cache_s2, _ = bench_lib.bench_cached_inference(cfg, batch_size=4, prebuilt=prebuilt,
                                                         **FAST)
    assert _rate_ok(qps2) and cache_s2 == 0.0
    with pytest.raises(ValueError, match="n_chunks"):
        bench_lib.bench_cached_inference(cfg, batch_size=4, n_chunks=3, prebuilt=prebuilt,
                                         **FAST)


def test_bench_inference_runs_on_cpu(step_clock):
    cfg = tiny_config()
    res = bench_lib.bench_inference(cfg, batch_sizes=(2, 4), **FAST)
    assert [r.batch_size for r in res] == [2, 4]
    for r in res:
        assert _rate_ok(r.qa_pairs_per_sec) and _rate_ok(r.p50_latency_ms) and r.compile_s > 0


def test_bench_video_runs_on_cpu(step_clock):
    fps = bench_lib.bench_video(16, False, batch_size=2, min_signal_s=0.0, **FAST)
    assert _rate_ok(fps)
    # the MFU guard: a reading implying more than mfu_cap of the peak is refused
    assert bench_lib.bench_video(16, True, batch_size=2, min_signal_s=0.0,
                                 flops_per_step=1e30, peak_flops=1.0, **FAST) is None


# ---- the capacity probe ------------------------------------------------------------

def test_mint_is_the_jax_probe_fill():
    shape = (2, 3, 1000, 17)
    i2 = lax.broadcasted_iota(jnp.float32, shape, len(shape) - 2)
    i3 = lax.broadcasted_iota(jnp.float32, shape, len(shape) - 1)
    ref = np.asarray(jnp.sin(i2 * 7.77e-3 + i3 * 0.31))
    got = capacity_probe.mint(shape, "cpu").numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("t", [64, 1024])
def test_both_paths_run_and_the_kernel_path_streams_from_1024(monkeypatch, t, grad):
    """Both paths at the probe's J = 512 (S = 8): the kernel path reaches the
    model's fused attention, which streams (fvta_stats_fused) at T = 1024 and
    not at 64; the plain path never calls it."""
    calls = []
    real = fvta_fused.fvta_stats_fused
    monkeypatch.setattr(fvta_fused, "fvta_stats_fused",
                        lambda *a, **k: calls.append(a[0].shape[2]) or real(*a, **k))
    capacity_probe._run_at_t(t, "plain", batch=1, j=512, d=16, s=8, grad=grad, device="cpu")
    assert calls == []
    capacity_probe._run_at_t(t, "kernel", batch=1, j=512, d=16, s=8, grad=grad, device="cpu")
    assert calls == ([t] if t >= fvta_fused.STREAM_MIN_T else [])


def test_explicit_t_list_replaces_doubling(monkeypatch):
    seen = []
    real = capacity_probe._run_at_t
    monkeypatch.setattr(capacity_probe, "_run_at_t",
                        lambda t, path, *a, **k: seen.append((path, t)) or real(t, path, *a, **k))
    out = capacity_probe.probe_largest_t(batch=1, j=16, d=16, s=8, t_list=[64, 128],
                                         device="cpu")
    assert seen == [("plain", 64), ("plain", 128), ("kernel", 64), ("kernel", 128)]
    assert out["plain"] == {"last_ok_t": 128, "first_oom_t": None}
    assert out["kernel"]["last_ok_t"] == 128


def test_oom_is_recorded_and_any_other_error_reraised(monkeypatch):
    """Doubling from 64: the plain path runs out of memory at 256 (recorded,
    the search stops), the kernel path at 512; a ValueError from a kernel is
    no capacity limit and re-raises."""
    limit = {"plain": 256, "kernel": 512}

    def fake(t, path, *a, **k):
        if t >= limit[path]:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(capacity_probe, "_run_at_t", fake)
    out = capacity_probe.probe_largest_t(batch=1, j=16, d=16, t_start=64, t_cap=4096,
                                         device="cpu")
    assert out["plain"] == {"last_ok_t": 128, "first_oom_t": 256}
    assert out["kernel"] == {"last_ok_t": 256, "first_oom_t": 512}

    def broken(t, path, *a, **k):
        raise ValueError("a kernel refused the shape")

    monkeypatch.setattr(capacity_probe, "_run_at_t", broken)
    with pytest.raises(ValueError, match="refused"):
        capacity_probe.probe_largest_t(batch=1, j=16, d=16, t_start=64, device="cpu")


def test_probe_main_prints_one_json_line(capsys):
    assert capacity_probe.main(["--batch", "1", "--j", "16", "--d", "8", "--t-list", "32",
                                "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and '"largest_t"' in out[0]
