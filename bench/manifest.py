"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
the configuration's entry names its file, the traffic is
``traffic/<traffic>.json``, and the modules a run loads are
``drivers/<driver>.py`` (the traffic's ``driver``), ``data/<generator>.py``
and ``systems/<system>.py`` (the configuration's), and
``metrics/<metric>.py`` for each per-layer metric.  Nothing here knows a
cell, a configuration, a traffic mix or a metric by name.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import re

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


class Manifest:
    def __init__(self, data: dict, root: pathlib.Path = ROOT):
        self.data = data
        self.root = root
        self.cells = {w["name"]: w for w in data["workloads"]}
        self.configs = {c["name"]: c for c in data["configs"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: "
                           f"{sorted(self.cells)})")
        return self.cells[name]

    def config(self, name: str) -> dict:
        return json.loads((self.root / self.configs[name]["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((BENCH / "traffic" / f"{name}.json").read_text())

    def end_to_end(self, cell: str) -> list[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics read in this cell's traced run: those whose
        ``workloads`` list it."""
        return [m for m in self.data["per_layer"] if cell in m["workloads"]]


def load(root: pathlib.Path = ROOT) -> Manifest:
    return Manifest(json.loads((root / "BENCHMARK.json").read_text()), root)


def module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` as a module (kind: drivers, data,
    systems)."""
    if not NAME.match(name) or "." in name:
        raise ValueError(f"bad {kind} name {name!r}")
    return importlib.import_module(f"bench.{kind}.{name}")


def metric_reader(name: str):
    """``read(observation)`` of ``bench/metrics/<name>.py`` (the name may
    hold dots, so the file is loaded by path)."""
    if not NAME.match(name):
        raise ValueError(f"bad metric name {name!r}")
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench.metrics." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
