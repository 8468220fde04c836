"""The port's album cache and engine (fvta_memexqa_torch.serve) against the JAX
package's on the same weights: the cache quantizers bit for bit, the LRU byte
budget's counters (bytes, evictions, unrecoverable evictions, re-encodes, the
dirty state of save) over the same operations, probabilities at 1e-5 with a
float32 cache and the same top-1 with bfloat16 and int8 caches; the answer
step's error dict and the rounded latency_stats; and the cases of the JAX
suite's tests/test_serve.py that need no mesh (cache dtypes, QAEngine,
hardening, pack ingestion); tests/test_torch_serve_mesh.py has those that do."""

import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvta_memexqa_tpu import serve as jserve
from fvta_memexqa_tpu.data import Dataset
from fvta_memexqa_tpu.data import SharedTables as JSharedTables
from fvta_memexqa_tpu.data import assemble as j_assemble
from fvta_memexqa_tpu.data.device_prepro import device_put_batch
from fvta_memexqa_tpu.models import FVTAModel as JFVTAModel

from fvta_memexqa_torch import serve
from fvta_memexqa_torch.config import Config
from fvta_memexqa_torch.convert import model_from_flax
from fvta_memexqa_torch.data import SharedTables, make_synthetic
from fvta_memexqa_torch.models import FVTAModel
from fvta_memexqa_torch.serve import (AlbumStore, EngineOverloadedError, QAEngine,
                                      _dequant_h, _quant_h, vocab_view)

N_MOD = 6
PROB_TOL = dict(rtol=1e-5, atol=1e-5)
# the JAX suite's bound on a bf16 / int8 cache's probabilities vs a float32
# cache's (tests/test_serve.py TestCacheDtype, TestCacheDtypeInt8)
DTYPE_PROB_ATOL = 0.05


@pytest.fixture(scope="module")
def pair(packed_synth, small_config):
    """The JAX model and params, the port's model holding the same weights, both
    packages' shared tables and vocab, the synthetic albums, and a float32
    store on each side with every album ingested."""
    j_shared = JSharedTables.from_packed(packed_synth.shared)
    jb = device_put_batch(next(iter(Dataset(packed_synth, "train").get_batches(4))))
    j_model = JFVTAModel(cfg=small_config)
    params = jax.jit(lambda k: j_model.init(k, j_shared, j_assemble(j_shared, jb),
                                            train=False))(jax.random.key(0))
    cfg = Config.from_json(small_config.to_json())
    model = model_from_flax(cfg, jax.tree.map(np.asarray, params))
    shared = SharedTables.from_packed(packed_synth.shared, "cpu")
    vocab = vocab_view(packed_synth.meta)
    _, albums, feats, _, _ = make_synthetic(seed=0)
    p = dict(j_model=j_model, params=params, j_shared=j_shared, j_cfg=small_config,
             model=model, shared=shared, cfg=cfg, vocab=vocab, albums=albums, feats=feats)
    p["jstore"], p["store"] = stores(p)
    for a in albums.values():
        p["jstore"].ingest(a, feats)
        p["store"].ingest(a, feats)
    return p


def stores(p, **kw):
    """(JAX AlbumStore, port AlbumStore) over the pair's weights, same options."""
    return (jserve.AlbumStore(p["j_cfg"], p["j_model"], p["params"], p["j_shared"],
                              p["vocab"], **kw),
            AlbumStore(p["cfg"], p["model"], p["shared"], p["vocab"], **kw))


def port_store(p, **kw) -> AlbumStore:
    return AlbumStore(p["cfg"], p["model"], p["shared"], p["vocab"], **kw)


def counters(s) -> dict:
    return {"num_albums": s.num_albums, "cache_bytes": s.cache_bytes,
            "evictions": s.evictions, "evictions_unrecoverable": s.evictions_unrecoverable,
            "reencodes": s.reencodes, "lru": list(s._store), "inputs": list(s._inputs)}


def same_counters(js, s, what: str) -> None:
    assert counters(s) == counters(js), what


def ask_args(albums, aid):
    a = albums[aid]
    return f"where did we go on {a.title} ?", [a.where, "nowhere", "space", "atlantis"], [aid]


def entry_bytes(store) -> int:
    return AlbumStore._entry_bytes(*next(iter(store._store.values())))


# ---- the quantizers, bit for bit ---------------------------------------------------

def quant_input(kind: str) -> np.ndarray:
    rng = np.random.default_rng(3)
    h = (np.tanh(rng.normal(0, 1, (6, 24, 32))) * rng.uniform(0, 1, (6, 24, 1)))
    h = h.astype(np.float32)
    if kind == "edges":
        h[0, 3] = 0.0                     # an all-padding row: s = 127 / 127
        h[1] = 0.0
        h[2, 0, :5] = [0.5, -0.5, 1.5 / 127, 2.5 / 127, -2.5 / 127]   # ties
        h[3, 1] = np.float32(1e-30)       # tiny rows
    elif kind == "wide":
        h = rng.normal(0, 7.0, (6, 24, 200)).astype(np.float32)
    return h


@pytest.mark.parametrize("kind", ["lstm", "edges", "wide"])
@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
def test_quantizer_matches_jax_bitwise(mode, kind):
    h = quant_input(kind)
    ref, mine = jserve._quant_h(jnp.asarray(h), mode), _quant_h(torch.from_numpy(h), mode)
    if mode == "int8":
        assert mine["q"].dtype == torch.int8 and mine["s"].dtype == torch.float32
        np.testing.assert_array_equal(mine["q"].numpy(), np.asarray(ref["q"]))
        np.testing.assert_array_equal(mine["s"].numpy().view(np.int32),
                                      np.asarray(ref["s"]).view(np.int32))
    else:
        assert mine.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[mode]
        np.testing.assert_array_equal(mine.to(torch.float32).numpy().view(np.int32),
                                      np.asarray(ref.astype(jnp.float32)).view(np.int32))
    np.testing.assert_array_equal(_dequant_h(mine).numpy().view(np.int32),
                                  np.asarray(jserve._dequant_h(ref)).view(np.int32))


# ---- the budget's counters over one sequence of operations ------------------------

@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
def test_same_operations_same_counters(pair, mode, tmp_path):
    """Ingests, hits, re-encodes, saves (only_if_dirty), loads into a tighter
    budget with a bound on retained inputs: every counter, the LRU order and
    each save's return value equal the JAX store's after every step."""
    p = pair
    order = sorted(p["albums"])
    albums, feats = p["albums"], p["feats"]
    js, s = stores(p, cache_dtype=mode)
    both = lambda f: (f(js), f(s))
    both(lambda x: x.ingest(albums[order[0]], feats))
    budget = int(2.5 * s.cache_bytes)
    js.max_bytes = s.max_bytes = budget
    for aid in order[1:3]:
        both(lambda x: x.ingest(albums[aid], feats))
    same_counters(js, s, "after 3 ingests")
    assert s.evictions == 1 and s.cache_bytes <= budget
    (jh, _, jn), (h, _, n) = both(lambda x: x.get_stacked([order[0]]))
    same_counters(js, s, "after a re-encode")
    assert n == jn == 1 and s.reencodes == 1
    atol = 1e-5 if mode == "float32" else 1e-2
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5, atol=atol)
    both(lambda x: x.get_stacked([order[2], order[1]]))
    same_counters(js, s, "after a hit and a re-encode")
    jd, d = str(tmp_path / "jax"), str(tmp_path / "port")
    assert js.save(jd) is s.save(d) is True
    assert js.save(jd, only_if_dirty=True) is s.save(d, only_if_dirty=True) is False
    both(lambda x: x.ingest(albums[order[3]], feats))
    assert js.save(jd, only_if_dirty=True) is s.save(d, only_if_dirty=True) is True
    same_counters(js, s, "after the saves")

    # restored entries have no inputs: a 1.5-entry budget must evict one of them
    # (unrecoverable), and a new ingest is the only recoverable victim
    js2, s2 = stores(p, cache_dtype=mode, max_bytes=int(1.5 * budget / 2.5),
                     max_retained_inputs=2)
    assert js2.load(jd) == s2.load(d) == 2
    same_counters(js2, s2, "after the load")
    assert s2.evictions_unrecoverable == 1
    assert js2.save(jd, only_if_dirty=True) is s2.save(d, only_if_dirty=True) is False
    for aid in (order[4], order[5], order[0]):
        (js2.ingest(albums[aid], feats), s2.ingest(albums[aid], feats))
    same_counters(js2, s2, "after ingests into the restored store")
    js2.get_stacked([order[4], order[5], order[0]])
    s2.get_stacked([order[4], order[5], order[0]])
    same_counters(js2, s2, "after asking about every album")
    assert js2.save(jd, only_if_dirty=True) is s2.save(d, only_if_dirty=True) is True


def test_budgeted_answers_match_jax(pair):
    """Answers through an LRU budget of two entries, re-encoding on demand on
    both sides, match the JAX engine's at 1e-5, and the counters agree."""
    p = pair
    js, s = stores(p, max_bytes=int(2.5 * entry_bytes(p["store"])))
    for a in p["albums"].values():
        js.ingest(a, p["feats"])
        s.ingest(a, p["feats"])
    je, e = jserve.QAEngine(js, batch_size=4, batch_window_ms=1.0), QAEngine(
        s, batch_size=4, batch_window_ms=1.0)
    try:
        ids = sorted(p["albums"])
        for i, aid in enumerate(ids):
            q, ch, _ = ask_args(p["albums"], aid)
            refs = [aid, ids[(i + 3) % len(ids)]]
            ref, got = je.ask(q, ch, refs), e.ask(q, ch, refs)
            assert got["answer_index"] == ref["answer_index"]
            assert got["albums_found"] == ref["albums_found"] == 2
            np.testing.assert_allclose(got["probs"], ref["probs"], **PROB_TOL)
            np.testing.assert_allclose(got["seq_attention"], ref["seq_attention"],
                                       **PROB_TOL)
        assert s.reencodes > 0
        same_counters(js, s, "after the asks")
    finally:
        je.close()
        e.close()


@pytest.mark.parametrize("mode", ["bfloat16", "int8"])
def test_compressed_cache_top1_matches_jax(pair, mode):
    """A bf16 / int8 cache: the same bytes as the JAX store's, the same top-1 as
    the JAX engine with that cache and as the float32 cache, probabilities
    within the JAX suite's bound of the float32 cache's."""
    p = pair
    js, s = stores(p, cache_dtype=mode)
    for a in p["albums"].values():
        js.ingest(a, p["feats"])
        s.ingest(a, p["feats"])
    assert s.cache_bytes == js.cache_bytes
    engines = [jserve.QAEngine(js, batch_size=4, batch_window_ms=1.0),
               QAEngine(s, batch_size=4, batch_window_ms=1.0),
               QAEngine(p["store"], batch_size=4, batch_window_ms=1.0)]
    try:
        for aid in sorted(p["albums"]):
            ref, got, f32 = (e.ask(*ask_args(p["albums"], aid)) for e in engines)
            assert got["answer_index"] == ref["answer_index"] == f32["answer_index"]
            np.testing.assert_allclose(got["probs"], ref["probs"], atol=DTYPE_PROB_ATOL)
            np.testing.assert_allclose(got["probs"], f32["probs"], atol=DTYPE_PROB_ATOL)
    finally:
        for e in engines:
            e.close()


# ---- the two faults: ask's error dict, rounded latency_stats -----------------------

def test_ask_returns_the_error_dict_as_jax_does(pair, monkeypatch):
    """An answer step that raises: both engines return {"error": repr(e)} from
    ask (the HTTP handler sends it with 200, `cli predict` prints it)."""
    p = pair

    def boom(*a, **k):
        raise RuntimeError("answer step failed")

    monkeypatch.setattr(JFVTAModel, "answer", boom)
    monkeypatch.setattr(FVTAModel, "answer", boom)
    je = jserve.QAEngine(p["jstore"], batch_size=2, batch_window_ms=1.0)
    e = QAEngine(p["store"], batch_size=2, batch_window_ms=1.0)
    try:
        args = ask_args(p["albums"], "album0")
        ref, got = je.ask(*args, timeout=30), e.ask(*args, timeout=30)
    finally:
        je.close()
        e.close()
    assert got == ref == {"error": "RuntimeError('answer step failed')"}


def test_latency_stats_rounded_as_jax(pair):
    p = pair
    je = jserve.QAEngine(p["jstore"], batch_size=2, batch_window_ms=1.0)
    e = QAEngine(p["store"], batch_size=2, batch_window_ms=1.0)
    try:
        assert e.latency_stats() == je.latency_stats() == {"p50_ms": None, "p95_ms": None}
        for aid in ("album0", "album1", "album2"):
            je.ask(*ask_args(p["albums"], aid))
            e.ask(*ask_args(p["albums"], aid))
        ref, got = je.latency_stats(), e.latency_stats()
        assert list(got) == list(ref)
        assert all(v == round(v, 3) for v in got.values())
        lat = [0.0123456789, 0.00098765432, 1.23456789e-4, 0.5]
        je._latencies, e._latencies = list(lat), list(lat)
        assert e.latency_stats() == je.latency_stats() == {"p50_ms": 12.346,
                                                           "p95_ms": 500.0}
    finally:
        je.close()
        e.close()


# ---- the JAX suite's cases: cache dtypes ------------------------------------------

@pytest.fixture(scope="module")
def compressed(pair):
    """Port stores with every album ingested, bfloat16 and int8."""
    out = {}
    for mode in ("bfloat16", "int8"):
        s = port_store(pair, cache_dtype=mode)
        for a in pair["albums"].values():
            s.ingest(a, pair["feats"])
        out[mode] = s
    return out


@pytest.mark.parametrize("mode,bound", [("bfloat16", 0.6), ("int8", 0.3)])
def test_compressed_cache_bytes(pair, compressed, mode, bound):
    s = compressed[mode]
    assert s.num_albums == pair["store"].num_albums
    assert s.cache_bytes < bound * pair["store"].cache_bytes


def test_int8_quantization_error_bounded(pair, compressed):
    """Dequantized states within half a quantization step of the f32 truth."""
    for aid in sorted(pair["albums"])[:3]:
        h = pair["store"]._store[aid][0]
        e = compressed["int8"]._store[aid][0]
        assert torch.all((_dequant_h(e) - h).abs() <= 0.5 * e["s"] + 1e-7)


@pytest.mark.parametrize("mode", ["bfloat16", "int8"])
def test_reencode_matches_cached_hit(pair, mode):
    """An entry evicted and re-encoded on demand serves the same rounding a
    cached hit would."""
    s = port_store(pair, cache_dtype=mode)
    aid = sorted(pair["albums"])[0]
    s.ingest(pair["albums"][aid], pair["feats"])
    h_hit, m_hit, n = s.get_stacked([aid])
    with s._lock:   # an eviction
        s._bytes -= s._entry_bytes(*s._store.pop(aid))
    h_re, m_re, n2 = s.get_stacked([aid])
    assert n == n2 == 1 and s.reencodes == 1
    assert torch.equal(h_hit, h_re) and torch.equal(m_hit, m_re)


@pytest.mark.parametrize("mode", ["bfloat16", "int8"])
def test_save_load_keeps_dtype(pair, compressed, mode, tmp_path):
    src = compressed[mode]
    assert src.save(str(tmp_path))
    s = port_store(pair, cache_dtype=mode)
    assert s.load(str(tmp_path)) == src.num_albums
    assert s.cache_bytes == src.cache_bytes
    aid = sorted(pair["albums"])[0]
    if mode == "int8":
        assert s._store[aid][0]["q"].dtype == torch.int8
    assert torch.equal(s.get_stacked([aid])[0], src.get_stacked([aid])[0])


def test_int8_cache_loads_into_other_dtypes(pair, compressed, tmp_path):
    """A saved int8 cache restored into a float32 / bfloat16 store is
    dequantized to the store's dtype (and its bytes); the values are the
    dequantized int8 states."""
    src = compressed["int8"]
    src.save(str(tmp_path))
    aid = sorted(pair["albums"])[0]
    want = _dequant_h(src._store[aid][0])
    for mode, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        s = port_store(pair, cache_dtype=mode)
        assert s.load(str(tmp_path)) == src.num_albums
        h = s._store[aid][0]
        assert not isinstance(h, dict) and h.dtype == dtype
        assert s.cache_bytes > src.cache_bytes
        torch.testing.assert_close(h.to(torch.float32), want, rtol=0,
                                   atol=1e-2 if mode == "bfloat16" else 0.0)


def test_float_cache_loads_into_int8(pair, tmp_path):
    """The reverse: a float32 cache restored into an int8 store is quantized,
    equal to the int8 store's own ingest, counters as the JAX store's."""
    pair["store"].save(str(tmp_path / "port"))
    pair["jstore"].save(str(tmp_path / "jax"))
    js, s = stores(pair, cache_dtype="int8")
    assert s.load(str(tmp_path / "port")) == js.load(str(tmp_path / "jax"))
    same_counters(js, s, "after the load")
    aid = sorted(pair["albums"])[0]
    e = s._store[aid][0]
    ref = _quant_h(pair["store"]._store[aid][0], "int8")
    assert torch.equal(e["q"], ref["q"]) and torch.equal(e["s"], ref["s"])


def test_bad_dtype_and_mesh_rejected(pair):
    """A bad cache dtype and shard_cache without a mesh are the JAX store's
    ValueErrors; an unsharded cache has no per-device bytes."""
    with pytest.raises(ValueError, match="cache_dtype"):
        port_store(pair, cache_dtype="float16")
    with pytest.raises(ValueError, match="shard_cache requires a device mesh"):
        port_store(pair, shard_cache=True)
    with pytest.raises(ValueError, match="shard_cache requires a device mesh"):
        jserve.AlbumStore(pair["j_cfg"], pair["j_model"], pair["params"], pair["j_shared"],
                          pair["vocab"], shard_cache=True)
    assert pair["store"].cache_bytes_per_device is None


# ---- QAEngine ----------------------------------------------------------------------

def test_answers_derivable_question(pair):
    e = QAEngine(pair["store"], batch_size=4, batch_window_ms=1.0)
    try:
        res = e.ask(*ask_args(pair["albums"], "album0"))
        assert res["albums_found"] == 1 and len(res["probs"]) == 4
        assert abs(sum(res["probs"]) - 1.0) < 1e-5
        assert e.ask("where ?", ["a", "b", "c", "d"], ["no_such_album"])["albums_found"] == 0
        with pytest.raises(ValueError):
            e.ask("q", ["only", "three", "choices"], [])
    finally:
        e.close()


def test_concurrent_asks_batched(pair):
    e = QAEngine(pair["store"], batch_size=8, batch_window_ms=20.0)
    try:
        results = [None] * 6

        def worker(i):
            aid = f"album{i % 3}"
            results[i] = e.ask(f"what year was {pair['albums'][aid].title} ?",
                               ["2007", "2009", "2011", "2013"], [aid])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert all(r is not None and "answer" in r for r in results)
        assert e.stats["batches"] < e.stats["questions"]
    finally:
        e.close()


def test_warmup_does_not_count(pair):
    e = QAEngine(pair["store"], batch_size=2)
    try:
        assert e.warmup() > 0.0
        assert e.stats == {"questions": 0, "batches": 0}
        assert "answer" in e.ask(*ask_args(pair["albums"], "album0"))
    finally:
        e.close()


def test_max_pending_sheds_immediately(pair):
    """Beyond max_pending queued asks a new request fails at once with the
    retryable overload error (a TimeoutError), as the JAX engine's does."""
    engines = [jserve.QAEngine(pair["jstore"], batch_size=2, max_pending=1),
               QAEngine(pair["store"], batch_size=2, max_pending=1)]
    try:
        for e, overloaded in zip(engines, (jserve.EngineOverloadedError,
                                           EngineOverloadedError)):
            assert issubclass(overloaded, TimeoutError)
            e._stop.set()                    # freeze the worker: the queue backs up
            e._worker.join(timeout=5)
            th = threading.Thread(target=lambda: pytest.raises(
                TimeoutError, e.ask, "q ?", ["a", "b", "c", "d"], [], timeout=1.0),
                daemon=True)
            th.start()
            time.sleep(0.1)
            t0 = time.perf_counter()
            with pytest.raises(overloaded):
                e.ask("q2 ?", ["a", "b", "c", "d"], [], timeout=30.0)
            assert time.perf_counter() - t0 < 1.0 and e.shed == 1
            th.join(timeout=10)
            assert not th.is_alive()
    finally:
        for e in engines:
            e.close()


def test_timeout_raises(pair):
    e = QAEngine(pair["store"], batch_size=2, batch_window_ms=1.0)
    e._stop.set()
    e._worker.join(timeout=5)
    with pytest.raises(TimeoutError):
        e.ask("q ?", ["a", "b", "c", "d"], [], timeout=0.2)


def test_load_p95_under_bound(pair):
    """8 threads x 5 asks: every request succeeds, p95 under a generous bound."""
    e = QAEngine(pair["store"], batch_size=8, batch_window_ms=3.0)
    errors = []

    def worker(i):
        for j in range(5):
            aid = f"album{(i + j) % 3}"
            try:
                assert "answer" in e.ask(f"what year was {pair['albums'][aid].title} ?",
                                         ["2007", "2009", "2011", "2013"], [aid],
                                         timeout=60.0)
            except Exception as ex:  # noqa: BLE001 - collected for the assert
                errors.append(repr(ex))

    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        assert e.stats["questions"] == 40
        assert e.latency_stats()["p95_ms"] < 30_000
    finally:
        e.close()


# ---- hardening -----------------------------------------------------------------------

def test_lru_eviction_respects_budget_and_reencodes(pair):
    budget = int(entry_bytes(pair["store"]) * 2.5)
    s = port_store(pair, max_bytes=budget)
    order = sorted(pair["albums"])
    for aid in order[:3]:
        s.ingest(pair["albums"][aid], pair["feats"])
    assert s.num_albums == 2 and s.evictions == 1 and s.cache_bytes <= budget
    h, _, found = s.get_stacked([order[0]])
    assert found == 1 and s.reencodes == 1 and s.cache_bytes <= budget
    assert torch.equal(h[:N_MOD], pair["store"]._store[order[0]][0])
    assert {*s._store} == {order[2], order[0]}
    s.get_stacked([order[2]])
    s.ingest(pair["albums"][order[3]], pair["feats"])
    assert {*s._store} == {order[2], order[3]}


def test_reingest_same_album_does_not_grow(pair):
    s = port_store(pair)
    s.ingest(pair["albums"]["album0"], pair["feats"])
    b1 = s.cache_bytes
    s.ingest(pair["albums"]["album0"], pair["feats"])
    assert s.cache_bytes == b1 and s.num_albums == 1


def test_cache_entries_own_their_memory(pair, packed_synth):
    """A pack batch's entries are copies, not views into the batch's output."""
    s = port_store(pair)
    s.attach_pack(packed_synth)
    s.ingest_pack(batch_size=3)
    for h, m in s._store.values():
        for t in (h, m):
            assert t.untyped_storage().nbytes() == t.numel() * t.element_size()


def test_cache_persistence_roundtrip(pair, tmp_path):
    src = pair["store"]
    src.save(str(tmp_path))
    s = port_store(pair)
    assert s.load(str(tmp_path)) == src.num_albums
    assert sorted(os.listdir(tmp_path)) == ["album_cache.pt", "album_ids.json"]
    for aid in pair["albums"]:
        h1, m1, k1 = src.get_stacked([aid])
        h2, m2, k2 = s.get_stacked([aid])
        assert k1 == k2 == 1 and torch.equal(h1, h2) and torch.equal(m1, m2)


def test_eviction_prefers_reencodable_victims(pair, tmp_path):
    order = sorted(pair["albums"])
    src = port_store(pair)
    for aid in order[:2]:
        src.ingest(pair["albums"][aid], pair["feats"])
    src.save(str(tmp_path))
    s = port_store(pair, max_bytes=int(entry_bytes(pair["store"]) * 2.5))
    s.load(str(tmp_path))
    s.ingest(pair["albums"][order[2]], pair["feats"])
    assert order[0] in s._store and order[1] in s._store and order[2] not in s._store
    assert s.evictions_unrecoverable == 0
    assert s.get_stacked([order[2]])[2] == 1 and s.reencodes == 1


def test_failed_save_keeps_dirty(pair, tmp_path, monkeypatch):
    s = port_store(pair)
    s.ingest(pair["albums"]["album0"], pair["feats"])

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(serve, "atomic_torch_save", boom)
    with pytest.raises(OSError):
        s.save(str(tmp_path / "x"), only_if_dirty=True)
    monkeypatch.undo()
    assert s.save(str(tmp_path / "y"), only_if_dirty=True) is True


def test_retained_inputs_bounded_and_refreshed_by_queries(pair):
    order = sorted(pair["albums"])
    s = port_store(pair, max_retained_inputs=2)
    s.ingest(pair["albums"][order[0]], pair["feats"])
    s.ingest(pair["albums"][order[1]], pair["feats"])
    s.get_stacked([order[0]])          # a hit makes order[0] the hottest
    s.ingest(pair["albums"][order[2]], pair["feats"])
    assert list(s._inputs) == [order[0], order[2]]
    assert all(isinstance(v, np.ndarray) for v in s._inputs[order[0]].values())


def test_save_only_if_dirty_skips_unchanged(pair, tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    pair["store"].save(a)
    s = port_store(pair)
    s.load(a)
    assert s.save(b, only_if_dirty=True) is False
    assert not os.path.exists(os.path.join(b, "album_ids.json"))
    s.ingest(pair["albums"]["album0"], pair["feats"])
    assert s.save(b, only_if_dirty=True) is True
    assert s.save(b, only_if_dirty=True) is False


def test_ingest_racing_save_stays_dirty(pair, tmp_path, monkeypatch):
    """An album ingested while a save's write is in flight stays dirty."""
    order = sorted(pair["albums"])
    s = port_store(pair)
    s.ingest(pair["albums"][order[0]], pair["feats"])
    real = serve.atomic_torch_save

    def racing(obj, path):
        s.ingest(pair["albums"][order[1]], pair["feats"])
        real(obj, path)

    monkeypatch.setattr(serve, "atomic_torch_save", racing)
    assert s.save(str(tmp_path / "r"), only_if_dirty=True) is True
    monkeypatch.undo()
    assert s.save(str(tmp_path / "r2"), only_if_dirty=True) is True
    assert set(torch.load(str(tmp_path / "r2" / "album_cache.pt"),
                          weights_only=True)["album_ids"]) == {order[0], order[1]}
    assert s.save(str(tmp_path / "r3"), only_if_dirty=True) is False


def test_concurrent_ingest_and_queries_keep_accounting(pair):
    """More threads than cores ingest and query a budgeted store with a short
    switch interval: the byte count equals the sum over the entries, and the
    budget holds."""
    import sys

    budget = int(entry_bytes(pair["store"]) * 3.5)
    s = port_store(pair, max_bytes=budget)
    ids = sorted(pair["albums"])
    start = threading.Barrier(12)

    def worker(i):
        start.wait()
        for j in range(4):
            aid = ids[(i + j) % len(ids)]
            if (i + j) % 2:
                s.ingest(pair["albums"][aid], pair["feats"])
            else:
                s.get_stacked([aid])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(12)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert s.cache_bytes == sum(s._entry_bytes(*e) for e in s._store.values())
    assert s.cache_bytes <= budget


# ---- pack ingestion ------------------------------------------------------------------

def test_pack_ingest_matches_raw_ingest_and_jax(pair, packed_synth):
    js, s = stores(pair)
    assert s.attach_pack(packed_synth) == js.attach_pack(packed_synth) == len(pair["albums"])
    assert s.ingest_pack() == js.ingest_pack() == len(pair["albums"])
    same_counters(js, s, "after ingest_pack")
    assert s._gen == 0          # pack entries are not dirty
    for aid in pair["albums"]:
        torch.testing.assert_close(s._store[aid][0], pair["store"]._store[aid][0],
                                   rtol=1e-5, atol=1e-5)
        assert torch.equal(s._store[aid][1], pair["store"]._store[aid][1])


def test_lazy_pack_album_answerable(pair, packed_synth):
    s = port_store(pair)
    s.attach_pack(packed_synth)
    assert s.num_albums == 0
    h, _, found = s.get_stacked(["album0"])
    assert found == 1 and s.reencodes == 1 and s.num_albums == 1
    torch.testing.assert_close(h[:N_MOD], pair["store"]._store["album0"][0],
                               rtol=1e-5, atol=1e-5)
    e = QAEngine(s, batch_size=2, batch_window_ms=1.0)
    try:
        assert e.ask(*ask_args(pair["albums"], "album0"))["albums_found"] == 1
    finally:
        e.close()


def test_pack_albums_survive_eviction(pair, packed_synth):
    budget = int(entry_bytes(pair["store"]) * 2.5)
    js, s = stores(pair, max_bytes=budget)
    for x in (js, s):
        x.attach_pack(packed_synth)
        x.ingest_pack()
    same_counters(js, s, "after a budgeted ingest_pack")
    assert s.num_albums == 2 and s.evictions == len(pair["albums"]) - 2
    assert s.evictions_unrecoverable == 0
    for aid in sorted(pair["albums"]):
        assert s.get_stacked([aid])[2] == 1
    assert s.cache_bytes <= budget


def test_attach_pack_without_album_ids_meta(pair, packed_synth):
    import dataclasses

    old = dataclasses.replace(
        packed_synth, meta={k: v for k, v in packed_synth.meta.items() if k != "album_ids"})
    s = port_store(pair)
    assert s.attach_pack(old) == 0 and s.ingest_pack() == 0
    assert s.get_stacked(["album0"])[2] == 0
