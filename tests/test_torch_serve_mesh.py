"""Serving over a device mesh in the port (serve.AlbumStore(mesh=), QAEngine over
the mesh, shard_cache) against the JAX package's mesh engine on its virtual CPU
devices, on the same weights: the cases of the JAX suite's tests/test_serve.py
(TestCacheDtypeInt8.test_composes_with_shard_cache, TestMultiChipServing,
TestShardedCache) with N CPU slots (make_mesh(MeshConfig(data_parallel=N),
device="cpu")): answers at dp = 2 and 4 equal to the JAX mesh engine's and to
the port's dp = 1 (same answer_index, probabilities at 1e-5), the same cache
homes and per-device bytes as JAX for the same album ids."""

import threading

import jax
import numpy as np
import pytest
import torch

from fvta_memexqa_tpu import serve as jserve
from fvta_memexqa_tpu.config import MeshConfig as JMeshConfig
from fvta_memexqa_tpu.data import Dataset
from fvta_memexqa_tpu.data import SharedTables as JSharedTables
from fvta_memexqa_tpu.data import assemble as j_assemble
from fvta_memexqa_tpu.data.device_prepro import device_put_batch
from fvta_memexqa_tpu.models import FVTAModel as JFVTAModel
from fvta_memexqa_tpu.parallel.mesh import make_mesh as j_make_mesh

from fvta_memexqa_torch.config import Config, MeshConfig
from fvta_memexqa_torch.convert import model_from_flax
from fvta_memexqa_torch.data import SharedTables, make_synthetic
from fvta_memexqa_torch.parallel.mesh import make_mesh
from fvta_memexqa_torch.serve import AlbumStore, QAEngine, vocab_view

PROB_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pair(packed_synth, small_config):
    """The JAX model and params, the port's model on the same weights, both
    packages' shared tables, the vocab and the synthetic albums; a float32
    store on each side without a mesh, every album ingested."""
    j_shared = JSharedTables.from_packed(packed_synth.shared)
    jb = device_put_batch(next(iter(Dataset(packed_synth, "train").get_batches(4))))
    j_model = JFVTAModel(cfg=small_config)
    params = jax.jit(lambda k: j_model.init(k, j_shared, j_assemble(j_shared, jb),
                                            train=False))(jax.random.key(0))
    cfg = Config.from_json(small_config.to_json())
    model = model_from_flax(cfg, jax.tree.map(np.asarray, params))
    _, albums, feats, _, _ = make_synthetic(seed=0)
    p = dict(j_model=j_model, params=params, j_shared=j_shared, j_cfg=small_config,
             model=model, shared=SharedTables.from_packed(packed_synth.shared, "cpu"),
             cfg=cfg, vocab=vocab_view(packed_synth.meta), albums=albums, feats=feats)
    p["jstore"], p["store"] = stores(p, 1)
    return p


def stores(p, dp: int, ingest: bool = True, **kw):
    """(JAX AlbumStore, port AlbumStore) over a data-parallel mesh of dp devices
    (none at dp = 1), same options, every album ingested unless told not to."""
    jmesh = j_make_mesh(JMeshConfig(data_parallel=dp)) if dp > 1 else None
    mesh = make_mesh(MeshConfig(data_parallel=dp), device="cpu") if dp > 1 else None
    js = jserve.AlbumStore(p["j_cfg"], p["j_model"], p["params"], p["j_shared"], p["vocab"],
                           mesh=jmesh, **kw)
    s = AlbumStore(p["cfg"], p["model"], p["shared"], p["vocab"], mesh=mesh, **kw)
    if ingest:
        for a in p["albums"].values():
            js.ingest(a, p["feats"])
            s.ingest(a, p["feats"])
    return js, s


@pytest.fixture(scope="module")
def mesh_stores(pair):
    """dp -> (JAX, port) replicated-cache stores over that mesh."""
    return {dp: stores(pair, dp) for dp in (2, 4)}


@pytest.fixture(scope="module")
def sharded(pair):
    """(JAX, port) stores over a 4-device mesh with shard_cache."""
    return stores(pair, 4, shard_cache=True)


def ask_args(albums, aid):
    a = albums[aid]
    return f"where did we go on {a.title} ?", [a.where, "mars", "narnia", "void"], [aid]


def engines(*st, batch_size=4):
    """A QAEngine of its own package per store."""
    return [(jserve.QAEngine if isinstance(s, jserve.AlbumStore) else QAEngine)(
        s, batch_size=batch_size, batch_window_ms=1.0) for s in st]


def same_answers(ref: dict, got: dict, tol=PROB_TOL) -> None:
    assert got["answer_index"] == ref["answer_index"]
    assert got["albums_found"] == ref["albums_found"]
    np.testing.assert_allclose(got["probs"], ref["probs"], **tol)
    np.testing.assert_allclose(got["seq_attention"], ref["seq_attention"], **tol)


@pytest.mark.parametrize("dp", [2, 4])
def test_sharded_answers_match_single_device_and_jax(pair, mesh_stores, dp):
    """A micro-batch of several questions over the mesh: every answer equals the
    port's dp = 1 engine's (rtol 1e-5, atol 1e-6, the JAX suite's) and the JAX
    mesh engine's (1e-5)."""
    js, s = mesh_stores[dp]
    e1, je, e = engines(pair["store"], js, s)
    try:
        reqs = [ask_args(pair["albums"], aid) for aid in ("album0", "album1", "album2")]
        reqs.append(("what year was it ?", ["2007", "2009", "2011", "2013"],
                     ["album1", "album0"]))
        single = e1.answer_batch(reqs)
        mesh = e.answer_batch(reqs)
        for r in reqs:
            same_answers(je.ask(*r), mesh[reqs.index(r)])
        for a, b in zip(single, mesh):
            same_answers(a, b, dict(rtol=1e-5, atol=1e-6))
    finally:
        for x in (e1, je, e):
            x.close()


def test_one_copy_per_distinct_device(pair, mesh_stores):
    """N CPU slots are one device: one replica of the model and tables, the
    store's own; a layout of distinct devices gets one each."""
    _, s = mesh_stores[4]
    assert list(s.replicas) == [torch.device("cpu")]
    rep = s.replicas[torch.device("cpu")]
    assert rep.model is pair["model"] and rep.shared is pair["shared"]


def test_concurrent_load_on_mesh(pair, mesh_stores):
    _, s = mesh_stores[4]
    engine = QAEngine(s, batch_size=8, batch_window_ms=10.0)
    try:
        results = [None] * 8

        def worker(i):
            a = pair["albums"][f"album{i % 3}"]
            results[i] = engine.ask(f"what year was {a.title} ?",
                                    ["2007", "2009", "2011", "2013"], [a.album_id],
                                    timeout=120.0)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert all(r is not None and "answer" in r for r in results)
        assert engine.stats["questions"] == 8
    finally:
        engine.close()


def test_indivisible_batch_rejected(mesh_stores):
    _, s = mesh_stores[4]
    with pytest.raises(ValueError, match="divisible"):
        QAEngine(s, batch_size=3)


def test_shard_cache_requires_mesh(pair):
    with pytest.raises(ValueError, match="mesh"):
        AlbumStore(pair["cfg"], pair["model"], pair["shared"], pair["vocab"], shard_cache=True)


def test_entries_live_on_hash_home_devices(sharded):
    """The same home slot as the JAX store for every album id, each entry on
    its slot's device, per-slot bytes equal to JAX's and summing to
    cache_bytes, more than one slot used."""
    js, s = sharded
    assert s._home == js._home
    for aid, (h, m) in s._store.items():
        want = s._cache_devices[s._home_device(aid)]
        assert h.device == m.device == want
    assert len(set(s._home.values())) >= 2
    assert s.cache_bytes_per_device == js.cache_bytes_per_device
    assert sum(s.cache_bytes_per_device) == s.cache_bytes == js.cache_bytes


def test_answers_match_replicated_store(pair, sharded):
    _, s = sharded
    e1, e2 = engines(pair["store"], s)
    try:
        for aid in ("album0", "album1", "album2"):
            same_answers(e1.ask(*ask_args(pair["albums"], aid)),
                         e2.ask(*ask_args(pair["albums"], aid)), dict(rtol=1e-5, atol=1e-6))
    finally:
        e1.close()
        e2.close()


def test_eviction_accounting_stays_consistent(pair):
    """A budget of ~2 entries over a sharded mesh store: the same evictions
    and per-slot bytes as the JAX store's, the sum equal to cache_bytes, and an
    evicted album still answers (re-encoded on demand)."""
    p = pair
    budget = int(2.5 * AlbumStore._entry_bytes(*next(iter(p["store"]._store.values()))))
    js, s = stores(p, 4, shard_cache=True, max_bytes=budget)
    assert s.evictions == js.evictions > 0 and s.cache_bytes <= budget
    assert s.cache_bytes_per_device == js.cache_bytes_per_device
    assert sum(s.cache_bytes_per_device) == s.cache_bytes
    assert s._home == js._home and len(s._home) == len(s._store)
    (engine,) = engines(s)
    try:
        r = engine.ask(*ask_args(p["albums"], "album0"))
        assert r["albums_found"] == 1
    finally:
        engine.close()


def test_save_load_roundtrip_redistributes(pair, sharded, tmp_path):
    """A saved sharded cache loaded into a new sharded store: every entry back
    on its home slot, bitwise the saved one, the per-slot bytes as before;
    loaded into a 2-slot mesh it redistributes by the same hash modulo 2."""
    _, s = sharded
    path = str(tmp_path / "cache")
    assert s.save(path)
    for dp in (4, 2):
        _, s2 = stores(pair, dp, ingest=False, shard_cache=True)
        assert s2.load(path) == len(pair["albums"])
        for aid, (h, _) in s2._store.items():
            assert s2._home[aid] == s2._home_device(aid) == s._home_device(aid) % dp
            assert torch.equal(h, s._store[aid][0])
        assert sum(s2.cache_bytes_per_device) == s2.cache_bytes == s.cache_bytes
        if dp == 4:
            assert s2.cache_bytes_per_device == s.cache_bytes_per_device


def test_composes_with_int8_cache(pair):
    """int8 entries ({"q", "s"} dicts) commit to their hash home under
    shard_cache and answer as the unsharded int8 store does; the bytes equal
    the JAX sharded int8 store's, slot for slot."""
    js, s = stores(pair, 4, shard_cache=True, cache_dtype="int8")
    _, ref = stores(pair, 1, cache_dtype="int8")
    assert s.cache_bytes_per_device == js.cache_bytes_per_device
    assert sum(s.cache_bytes_per_device) == s.cache_bytes == ref.cache_bytes
    for aid, (h, _) in list(s._store.items()):   # get_stacked reorders the LRU
        assert h["q"].dtype == torch.int8
        assert h["q"].device == h["s"].device == s._cache_devices[s._home_device(aid)]
        h1, m1, _ = ref.get_stacked([aid])
        h2, m2, _ = s.get_stacked([aid])
        assert torch.equal(h1, h2) and torch.equal(m1, m2)
