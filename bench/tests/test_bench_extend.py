"""A later PR adds a configuration, a traffic mix, a per-layer metric and a
cell with new files and new entries only: a throwaway copy of the benchmark
gains all four and runs the new cell, and no file that was there changes."""
import hashlib
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

RUN = r"""
import json, sys, time
sys.path[:0] = ["{root}", "{src}"]
from bench import harness, manifest
man = manifest.load()
out = {{}}
for traced in (False, True):
    r = harness.run_cell(man, "tiny.bulk_p2", 5, 0.3, traced, "cpu",
                         time.perf_counter())
    out[str(traced)] = r
print(json.dumps(out))
"""


def digest(tree: pathlib.Path) -> dict:
    return {p.relative_to(tree).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest() for p in sorted(tree.rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_from_new_files_only(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digest(tmp_path / "bench")
    bench = tmp_path / "bench"

    cfg = json.loads((bench / "configs" / "rpf_mnist784.json").read_text())
    cfg.update(name="tiny", n=1500, n_queries=100, reduced=["n"])
    cfg["forest"]["n_trees"] = 4
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "bulk_p4.json").read_text())
    traffic.update(n_probes=2, batch=32, warmup_batches=1, check_batches=2,
                   trace_batches=2, trace_host_batches=1)
    (bench / "traffic" / "bulk_p2.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "traced_batches.py").write_text(
        "def read(obs):\n    return float(obs.units)\n")

    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny", "source": "a test",
                           "file": "bench/configs/tiny.json",
                           "reduced": ["n"], "why": "a test"})
    man["workloads"].append({"name": "tiny.bulk_p2", "config": "tiny",
                             "traffic": "bulk_p2", "chips": 1,
                             "why": "a test"})
    for m in man["end_to_end"]:
        if m["name"] in ("qps", "batch_p99_ms"):
            m["workloads"].append("tiny.bulk_p2")
    man["per_layer"].append({"name": "traced_batches", "unit": "batches",
                             "better": "higher", "source": "host_clock",
                             "layer": "index API", "moves": "qps",
                             "workloads": ["tiny.bulk_p2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    proc = subprocess.run(
        [sys.executable, "-c", RUN.format(root=tmp_path, src=ROOT / "src")],
        capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    untraced, traced = out["False"], out["True"]
    assert untraced["correct"] and traced["correct"]
    assert set(untraced["metrics"]) == {"qps", "batch_p99_ms", "setup_s"}
    assert traced["metrics"]["traced_batches"]["value"] == 2.0
    after = digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before
