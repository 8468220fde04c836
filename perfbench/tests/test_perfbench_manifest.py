"""BENCHMARK.json against the rules of its format (keys, names, units, sizes,
bounds), and every file it names found by name."""

import json
import re

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|proj|head|expansion|_dim$|_rank$|"
                    r"experts_per_tok)")


@pytest.fixture(scope="module")
def manifest():
    with open(harness.ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_keys_and_sizes(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(manifest["paths"]) <= 16 and len(manifest["command"]) <= 32
    for p in manifest["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/")
        assert (harness.ROOT / p).is_dir()
    for word in manifest["command"]:
        assert LINE.match(word) and ".." not in word and not word.startswith("/")
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    # a full check of 24 cells at this window fits in 43200 s
    cells = 24
    assert (2 + 14 * cells) * (manifest["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


def test_names_units_and_lines(manifest):
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in manifest[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in manifest["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"]) and LINE.match(w["why"])
    for c in manifest["configs"]:
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTHS.search(key)
    for m in manifest["per_layer"]:
        assert LINE.match(m["layer"])


def test_cells_and_metrics(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    pairs = {(w["config"], w["traffic"]) for w in manifest["workloads"]}
    assert len(pairs) == len(manifest["workloads"])
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert all(w["chips"] in (1, 4) for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)
    used = {w["config"] for w in manifest["workloads"]}
    assert used == {c["name"] for c in manifest["configs"]}
    for m in manifest["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in manifest["workloads"]:
        cell = harness.load_cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer


@pytest.mark.parametrize("kind", ["configs", "workloads", "metrics", "traffic"])
def test_files_found_by_name(manifest, kind):
    import importlib

    if kind == "configs":
        files = [c["file"] for c in manifest["configs"]]
        assert len(files) == len(set(files))
        for c in manifest["configs"]:
            cfg = harness.load_json(harness.ROOT / c["file"])
            assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
            assert cfg["reduced"] == c["reduced"]
    elif kind == "workloads":
        for w in manifest["workloads"]:
            cell = harness.load_cell(w["name"])
            assert cell.spec["rate_metric"] in {m["name"] for m in cell.end_to_end}
            assert cell.spec["limits"]
    elif kind == "metrics":
        for m in manifest["per_layer"]:
            assert callable(harness.load_reader(m["name"]).read)
    else:
        kinds = {harness.load_cell(w["name"]).spec["kind"] for w in manifest["workloads"]}
        for k in kinds:
            mod = importlib.import_module(f"perfbench.traffic.{k}")
            assert all(callable(getattr(mod, f)) for f in ("setup", "reference", "compare"))
