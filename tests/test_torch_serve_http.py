"""The port's HTTP front end (serve.make_http_server / serve_http, `cli serve`)
against the JAX package's serve_http on the same weights: the same status code
and JSON for every endpoint, auth, rate-limit, overload, timeout, bad-request
and unknown-path case (probabilities at 1e-5); TLS; the `cli serve` flags the
port refuses (--dp past the cards there are, --shard-cache without --dp,
half-given TLS); and `python -m fvta_memexqa_torch.cli serve` on the CPU,
restarted on its saved cache, and over two CPU slots with a sharded cache."""

import dataclasses
import json
import os
import queue
import shutil
import socket
import ssl
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from fvta_memexqa_tpu import serve as jserve
from fvta_memexqa_tpu.data import Dataset
from fvta_memexqa_tpu.data import SharedTables as JSharedTables
from fvta_memexqa_tpu.data import assemble as j_assemble
from fvta_memexqa_tpu.data.device_prepro import device_put_batch
from fvta_memexqa_tpu.models import FVTAModel as JFVTAModel

from fvta_memexqa_torch import cli
from fvta_memexqa_torch.config import Config
from fvta_memexqa_torch.convert import model_from_flax, save_rundir
from fvta_memexqa_torch.data import SharedTables, make_synthetic, write_raw_files
from fvta_memexqa_torch.models import FVTAModel
from fvta_memexqa_torch.serve import (AlbumStore, QAEngine, RateLimiter, build_engine,
                                      make_http_server, vocab_view)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROB_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def sides(packed_synth, small_config):
    """Per side (JAX, port): an AlbumStore on the same weights with every
    synthetic album ingested; plus the port model and the photo features."""
    j_shared = JSharedTables.from_packed(packed_synth.shared)
    jb = device_put_batch(next(iter(Dataset(packed_synth, "train").get_batches(4))))
    j_model = JFVTAModel(cfg=small_config)
    params = jax.jit(lambda k: j_model.init(k, j_shared, j_assemble(j_shared, jb),
                                            train=False))(jax.random.key(0))
    cfg = Config.from_json(small_config.to_json())
    model = model_from_flax(cfg, jax.tree.map(np.asarray, params))
    vocab = vocab_view(packed_synth.meta)
    jstore = jserve.AlbumStore(small_config, j_model, params, j_shared, vocab)
    store = AlbumStore(cfg, model, SharedTables.from_packed(packed_synth.shared, "cpu"),
                       vocab)
    _, albums, feats, _, _ = make_synthetic(seed=0)
    for a in albums.values():
        jstore.ingest(a, feats)
        store.ingest(a, feats)
    return dict(jstore=jstore, store=store, model=model, albums=albums, feats=feats)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def wait_healthy(base: str) -> None:
    for _ in range(100):
        try:
            urllib.request.urlopen(f"{base}/healthz", timeout=1)
            return
        except OSError:
            time.sleep(0.05)
    raise RuntimeError(f"{base} never answered /healthz")


class Servers:
    """A JAX and a port server over the same kind of engine, same options."""

    def __init__(self, sides, engine_kw=None, **kw):
        self.engines = [jserve.QAEngine(sides["jstore"], batch_window_ms=1.0,
                                        **(engine_kw or {})),
                        QAEngine(sides["store"], batch_window_ms=1.0, **(engine_kw or {}))]
        jport = free_port()
        threading.Thread(target=jserve.serve_http,
                         args=(self.engines[0], sides["jstore"], sides["feats"], jport),
                         kwargs=kw, daemon=True).start()
        self.httpd = make_http_server(self.engines[1], sides["store"], sides["feats"],
                                      port=0, **kw)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.bases = [f"http://127.0.0.1:{jport}",
                      f"http://127.0.0.1:{self.httpd.server_address[1]}"]
        for b in self.bases:
            wait_healthy(b)

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        for e in self.engines:
            e.close()

    def both(self, method, path, body=None, token=None):
        return [call(b, method, path, body, token) for b in self.bases]


def call(base, method, path, body=None, token=None, ctx=None):
    """(status code, JSON body) of one request; body: a dict, or raw bytes."""
    data = None
    if body is not None:
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"{base}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=30, context=ctx) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


@pytest.fixture(scope="module")
def authed(sides):
    s = Servers(sides, auth_token="alice,bob")
    yield s
    s.close()


def ask_body(albums, aid, ids=None):
    a = albums[aid]
    return {"question": f"where did we go on {a.title} ?",
            "choices": [a.where, "mars", "narnia", "void"], "album_ids": ids or [aid]}


NEW_ALBUM = {"album_id": "http_album", "album_title": "the lagoon trip",
             "album_where": "lisbon", "album_when": "july 2015", "photo_ids": ["hp1"],
             "photo_titles": ["a photo of a boat"]}


def case_request(name, sides):
    """(method, path, body, token) of each case, run in this order on both."""
    albums = sides["albums"]
    dim = int(np.asarray(next(iter(sides["feats"].values()))).shape[0])
    return {
        "healthz": ("GET", "/healthz", None, None),
        "healthz_with_a_bad_token": ("GET", "/healthz", None, "evil"),
        "stats_without_token": ("GET", "/stats", None, None),
        "stats_wrong_token": ("GET", "/stats", None, "evil"),
        "stats": ("GET", "/stats", None, "alice"),
        "get_unknown_path": ("GET", "/nope", None, "alice"),
        "post_unknown_path": ("POST", "/nope", {}, "alice"),
        "ask": ("POST", "/ask", ask_body(albums, "album1"), "bob"),
        "ask_two_albums_and_an_unknown": (
            "POST", "/ask", ask_body(albums, "album2", ["album2", "album0", "nope"]), "bob"),
        "ask_without_token": ("POST", "/ask", ask_body(albums, "album1"), None),
        "ask_missing_choices": ("POST", "/ask", {"question": "q"}, "alice"),
        "ask_three_choices": ("POST", "/ask", {"question": "q", "choices": ["a", "b", "c"]},
                              "alice"),
        "ask_bad_json": ("POST", "/ask", b"{not json", "alice"),
        "albums": ("POST", "/albums", {"album": NEW_ALBUM,
                                       "photo_feats": {"hp1": [0.1] * dim}}, "alice"),
        "ask_the_new_album": ("POST", "/ask", {
            "question": "where did we go on the lagoon trip ?",
            "choices": ["lisbon", "mars", "narnia", "void"], "album_ids": ["http_album"]},
            "alice"),
        "albums_missing_album": ("POST", "/albums", {}, "alice"),
        "albums_without_id": ("POST", "/albums", {"album": {"album_title": "x"}}, "alice"),
        "albums_wrong_feat_dim": ("POST", "/albums", {
            "album": {**NEW_ALBUM, "album_id": "bad"}, "photo_feats": {"hp1": [0.1] * 3}},
            "alice"),
        "stats_after": ("GET", "/stats", None, "bob"),
    }[name]


CASES = {"healthz": 200, "healthz_with_a_bad_token": 200, "stats_without_token": 401,
         "stats_wrong_token": 401, "stats": 200, "get_unknown_path": 404,
         "post_unknown_path": 404, "ask": 200, "ask_two_albums_and_an_unknown": 200,
         "ask_without_token": 401, "ask_missing_choices": 400, "ask_three_choices": 400,
         "ask_bad_json": 400, "albums": 200, "ask_the_new_album": 200,
         "albums_missing_album": 400, "albums_without_id": 400,
         "albums_wrong_feat_dim": 400, "stats_after": 200}
LATENCY_KEYS = ("p50_ms", "p95_ms")


@pytest.mark.parametrize("case", list(CASES))
def test_endpoint_matches_jax(case, authed, sides):
    (jcode, ref), (code, got) = authed.both(*case_request(case, sides))
    assert code == jcode == CASES[case]
    assert list(got) == list(ref)
    if "probs" in ref:
        assert got["answer_index"] == ref["answer_index"]
        assert got["albums_found"] == ref["albums_found"]
        np.testing.assert_allclose(got["probs"], ref["probs"], **PROB_TOL)
        np.testing.assert_allclose(got["seq_attention"], ref["seq_attention"], **PROB_TOL)
    elif "cache_bytes" in ref:
        assert got["cache_bytes_per_device"] is None
        for k in ("albums", "cache_bytes", "evictions", "evictions_unrecoverable",
                  "reencodes", "shed"):
            assert got[k] == ref[k], k
    else:
        assert got == ref


def test_per_client_limit_isolates_a_greedy_client(sides):
    s = Servers(sides, auth_token="alice,bob", max_rps_per_client=3)
    try:
        codes = [[call(b, "GET", "/stats", token="alice")[0] for _ in range(8)]
                 for b in s.bases]
        assert codes[0] == codes[1] == [200] * 3 + [429] * 5
        for b in s.bases:
            assert call(b, "GET", "/stats", token="bob")[0] == 200
            assert call(b, "GET", "/stats", token="evil")[0] == 401
    finally:
        s.close()


def test_global_limit_and_healthz_exempt(sides):
    s = Servers(sides, max_requests_per_sec=3)
    try:
        codes = [[call(b, "GET", "/stats")[0] for _ in range(8)] for b in s.bases]
        assert codes[0] == codes[1] == [200] * 3 + [429] * 5
        assert [call(b, "GET", "/healthz")[0] for b in s.bases] == [200, 200]
    finally:
        s.close()


def test_rate_limiter_matches_jax():
    """The limiter alone: per client, composed with a global cap, sliding."""
    for cls in (jserve.RateLimiter, RateLimiter):
        lim = cls(None, max_per_client_per_sec=2)
        assert [lim.allow("greedy") for _ in range(3)] + [lim.allow("polite")] == [
            True, True, False, True]
        lim2 = cls(3, max_per_client_per_sec=2)
        assert [lim2.allow(c) for c in "aaabb"] == [True, True, False, True, False]
        rl = cls(2)
        assert [rl.allow() for _ in range(3)] == [True, True, False]
        rl._times = [t - 1.5 for t in rl._times]      # age the window
        assert rl.allow()
        many = cls(None, max_per_client_per_sec=1)
        for i in range(4100):
            many._client_times[f"c{i}"] = [time.monotonic() - 5.0]
        assert many.allow("new") and len(many._client_times) == 1


def test_overload_and_timeout_are_503(sides):
    """A frozen worker with max_pending=1: the request holding the slot times
    out (503), the one behind it is shed at once (503), on both servers."""
    s = Servers(sides, engine_kw={"batch_size": 2, "max_pending": 1})
    try:
        for e in s.engines:
            e._stop.set()
            e._worker.join(timeout=5)
            ask = e.ask
            e.ask = lambda *a, _ask=ask, **k: _ask(*a, timeout=0.5)
        body = {"question": "q", "choices": ["a", "b", "c", "d"], "album_ids": []}
        for base in s.bases:
            held = queue.Queue()
            th = threading.Thread(target=lambda: held.put(call(base, "POST", "/ask", body)))
            th.start()
            time.sleep(0.2)
            t0 = time.perf_counter()
            code, res = call(base, "POST", "/ask", body)
            assert code == 503 and "overloaded" in res["error"]
            assert time.perf_counter() - t0 < 0.4
            th.join(timeout=10)
            assert not th.is_alive()
            code, res = held.get()
            assert code == 503 and "timed out" in res["error"]
        assert [e.shed for e in s.engines] == [1, 1]
    finally:
        s.close()


def test_failed_answer_step_is_200_with_the_error(sides, monkeypatch):
    """An answer step that raises: both servers answer 200 with the engine's
    {"error": ...} (the port's ask used to raise, which drops the connection)."""
    def boom(*a, **k):
        raise RuntimeError("answer step failed")

    monkeypatch.setattr(JFVTAModel, "answer", boom)
    monkeypatch.setattr(FVTAModel, "answer", boom)
    s = Servers(sides, engine_kw={"batch_size": 2})
    try:
        (jcode, ref), (code, got) = s.both("POST", "/ask", ask_body(sides["albums"], "album0"))
        assert code == jcode == 200
        assert got == ref == {"error": "RuntimeError('answer step failed')"}
    finally:
        s.close()


def test_a_burst_of_connections_is_accepted(sides):
    """300 clients connecting at once are all answered: the listen backlog
    holds them (socketserver's default of 5 drops most, which then time out)."""
    import http.client

    e = QAEngine(sides["store"], batch_size=2)
    httpd = make_http_server(e, sides["store"], sides["feats"], port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    codes, start = [], threading.Barrier(300)

    def one():
        start.wait()
        try:
            c = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=8)
            c.request("GET", "/healthz")
            codes.append(c.getresponse().status)
            c.close()
        except OSError as ex:
            codes.append(repr(ex))

    try:
        threads = [threading.Thread(target=one) for _ in range(300)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert codes == [200] * 300, [c for c in codes if c != 200][:3]
    finally:
        httpd.shutdown()
        httpd.server_close()
        e.close()


def test_tls(sides, tmp_path):
    """A self-signed cert: /healthz over HTTPS, plain HTTP refused on that port;
    half-given TLS is a ValueError on both servers."""
    if shutil.which("openssl") is None:
        pytest.skip("openssl not available to mint a test cert")
    cert, key = str(tmp_path / "c.pem"), str(tmp_path / "k.pem")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout",
                    key, "-out", cert, "-days", "1", "-subj", "/CN=127.0.0.1"],
                   check=True, capture_output=True)
    for half in ({"tls_cert": cert}, {"tls_key": key}):
        for fn in (jserve.serve_http, make_http_server):
            with pytest.raises(ValueError, match="together"):
                fn(None, sides["store"], {}, free_port(), **half)
    e = QAEngine(sides["store"], batch_size=2)
    httpd = make_http_server(e, sides["store"], sides["feats"], port=0, tls_cert=cert,
                             tls_key=key)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        base = f"https://127.0.0.1:{httpd.server_address[1]}"
        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE     # self-signed test cert
        assert call(base, "GET", "/healthz", ctx=ctx) == (200, {"ok": True})
        with pytest.raises(OSError):
            urllib.request.urlopen(base.replace("https", "http") + "/healthz", timeout=5)
    finally:
        httpd.shutdown()
        httpd.server_close()
        e.close()


# ---- cli serve ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served_files(sides, tmp_path_factory):
    """A port run directory with the pair's weights and the raw album files."""
    root = tmp_path_factory.mktemp("cli_serve")
    rundir, raw = str(root / "run"), str(root / "raw")
    save_rundir(rundir, sides["model"].cfg, sides["model"])
    qas, albums, feats, test_ids, glove = make_synthetic(num_albums=3, seed=11)
    albums = {f"raw_{k}": dataclasses.replace(v, album_id=f"raw_{k}")
              for k, v in albums.items()}
    write_raw_files(raw, qas, albums, feats, test_ids, glove)
    return dict(root=root, rundir=rundir, albums=albums, feats=feats,
                album_info=os.path.join(raw, "album_info.json"),
                photo_npz=os.path.join(raw, "photo_feats.npz"))


@pytest.mark.parametrize("flags,match", [
    (["--dp", "2"], "mesh needs 2 devices, have 0"),
    (["--shard-cache", "--device", "cpu"], "shard_cache requires a device mesh")],
    ids=["flags0", "flags1"])
def test_cli_serve_refuses_multi_card(flags, match, pack_dir, served_files):
    """--dp past the cards there are (none here), with no device list, is
    make_mesh's ValueError before anything runs on the CPU; --shard-cache
    without --dp is the JAX store's ValueError."""
    with pytest.raises(ValueError, match=match):
        cli.main(["serve", pack_dir, served_files["rundir"], *flags])


@pytest.mark.parametrize("flags", [["--tls-cert", "c.pem"], ["--tls-key", "k.pem"]])
def test_cli_serve_refuses_half_tls(flags, pack_dir, served_files):
    with pytest.raises(ValueError, match="together"):
        cli.main(["serve", pack_dir, served_files["rundir"], *flags, "--device", "cpu"])


def test_build_engine_refuses_multi_card(pack_dir, served_files):
    for kw, match in (({"dp": 2}, "mesh needs 2 devices, have 0"),
                      ({"dp": 2, "devices": ["cpu"]}, "mesh needs 2 devices, have 1"),
                      ({"shard_cache": True, "device": "cpu"}, "requires a device mesh")):
        with pytest.raises(ValueError, match=match):
            build_engine(pack_dir, served_files["rundir"], **kw)


class CliServer:
    """`python -m fvta_memexqa_torch.cli serve ...` on the CPU; its stdout lines."""

    def __init__(self, argv):
        self.port = free_port()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "fvta_memexqa_torch.cli", "serve", *argv, "--port",
             str(self.port), "--device", "cpu"], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.lines = queue.Queue()
        threading.Thread(target=lambda: [self.lines.put(line.rstrip())
                                         for line in self.proc.stdout], daemon=True).start()
        self.seen = []
        while not any(line.startswith("serving on") for line in self.seen):
            try:
                self.seen.append(self.lines.get(timeout=60))
            except queue.Empty:
                self.close()
                raise RuntimeError(f"cli serve did not start: {self.seen}") from None
        self.base = f"http://127.0.0.1:{self.port}"

    def close(self):
        self.proc.terminate()
        self.proc.wait(timeout=30)


def test_cli_serve_over_a_mesh_with_a_sharded_cache(sides, pack_dir, served_files):
    """`cli serve --dp 2 --shard-cache --device cpu` (two CPU slots, one
    process): /ask answers as the in-process dp = 1 engine does, and /stats
    reports the two slots' cache bytes, which sum to cache_bytes."""
    f = served_files
    ref_engine, _, _ = build_engine(pack_dir, f["rundir"], device="cpu")
    bodies = [ask_body(sides["albums"], aid, [aid, other])
              for aid, other in (("album0", "album1"), ("album2", "album0"))]
    try:
        want = [ref_engine.ask(b["question"], b["choices"], b["album_ids"]) for b in bodies]
    finally:
        ref_engine.close()
    srv = CliServer([pack_dir, f["rundir"], "--dp", "2", "--shard-cache", "--batch-size", "4"])
    try:
        for body, ref in zip(bodies, want):
            code, got = call(srv.base, "POST", "/ask", body)
            assert code == 200 and got["answer_index"] == ref["answer_index"]
            np.testing.assert_allclose(got["probs"], ref["probs"], **PROB_TOL)
        code, stats = call(srv.base, "GET", "/stats")
        per = stats["cache_bytes_per_device"]
        assert code == 200 and len(per) == 2 and min(per) > 0
        assert sum(per) == stats["cache_bytes"] > 0
        assert stats["albums"] == len(sides["albums"])
    finally:
        srv.close()


def test_cli_serve_answers_and_restores_its_cache(sides, pack_dir, served_files):
    """The real entry point on the CPU: raw albums pre-ingested and saved, auth
    and limits on, answers equal to an in-process engine on the same weights;
    restarted with --no-preingest on its cache dir it restores every album
    (pack and raw) and answers the same."""
    f = served_files
    cache = str(f["root"] / "cache")
    ref_engine, ref_store, _ = build_engine(pack_dir, f["rundir"], device="cpu")
    raw_id = sorted(f["albums"])[0]
    try:
        ref_store.ingest(f["albums"][raw_id], f["feats"])
        body = ask_body({**sides["albums"], **f["albums"]}, raw_id, [raw_id, "album1"])
        want = ref_engine.ask(body["question"], body["choices"], body["album_ids"])
    finally:
        ref_engine.close()
    n_albums = len(sides["albums"]) + len(f["albums"])
    common = [pack_dir, f["rundir"], "--cache-dir", cache, "--auth-token", "tok",
              "--max-pending", "16", "--max-rps-per-client", "50"]
    runs = [["--raw-albums", f["album_info"], "--raw-photo-npz", f["photo_npz"]],
            ["--no-preingest"]]
    for i, extra in enumerate(runs):
        srv = CliServer([*common, *extra])
        try:
            if i == 0:
                assert f"pre-ingested {len(sides['albums'])} pack albums" in srv.seen
                assert f"saved album cache to {cache}" in srv.seen
            else:
                assert f"restored {n_albums} cached album encodings from {cache}" in srv.seen
            assert srv.seen[-1] == (f"serving on http://127.0.0.1:{srv.port}  "
                                    "(POST /albums, POST /ask, GET /stats)")
            assert call(srv.base, "GET", "/healthz") == (200, {"ok": True})
            assert call(srv.base, "POST", "/ask", body)[0] == 401
            code, got = call(srv.base, "POST", "/ask", body, token="tok")
            assert code == 200 and got["albums_found"] == 2
            np.testing.assert_allclose(got["probs"], want["probs"], **PROB_TOL)
            code, stats = call(srv.base, "GET", "/stats", token="tok")
            assert code == 200 and stats["albums"] == n_albums
            assert stats["questions"] == stats["batches"] == 1
        finally:
            srv.close()
