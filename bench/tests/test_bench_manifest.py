"""BENCHMARK.json against the contract's shape: names, units and keys; every
entry resolving to its files by name; every cell's metrics."""
import json
import re

import pytest

from bench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(man):
    data = man.data
    assert set(data) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(data["command"]) <= 32
    assert all(line_ok(w) for w in data["command"])
    assert data["paths"] == ["bench"]
    assert isinstance(data["run_seconds"], int)
    assert 1 <= data["run_seconds"] <= 51
    assert len((man.root / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(man, section):
    entries = man.data[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert line_ok(e[key]), (e["name"], key)


def test_cells_and_metrics(man):
    e2e = {m["name"]: m for m in man.data["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man.data["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in man.end_to_end(cell)}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    pairs = set()
    for cell in man.data["workloads"]:
        assert cell["chips"] == 1
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
        assert (cell["config"], cell["traffic"]) not in pairs
        pairs.add((cell["config"], cell["traffic"]))
        names = {m["name"] for m in man.end_to_end(cell["name"])}
        assert "setup_s" in names and len(names) >= 2
        assert man.per_layer(cell["name"])
    used = {c["config"] for c in man.data["workloads"]}
    assert used == {c["name"] for c in man.data["configs"]}


def test_every_entry_resolves(man):
    files = set()
    for c in man.data["configs"]:
        assert c["file"].startswith("bench/configs/")
        assert c["file"] not in files
        files.add(c["file"])
        cfg = man.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key)
        assert set(cfg["limits"]) >= {"forest_diff"}
        manifest.module("data", cfg["data"]["generator"])
        assert hasattr(manifest.module("systems", cfg["system"]), "System")
    for cell in man.data["workloads"]:
        traffic = man.traffic(cell["traffic"])
        assert hasattr(manifest.module("drivers", traffic["driver"]), "run")
    for m in man.data["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]))


def test_files_named_from_names(man):
    for path in (man.root / "bench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(man.root).as_posix()
        assert re.match(r"^[A-Za-z0-9_./\-]+$", rel), rel


def test_configs_parse_as_json(man):
    for path in (man.root / "bench" / "configs").glob("*.json"):
        json.loads(path.read_text())
