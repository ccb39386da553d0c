"""What a run loads: no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``repro`` (compared whole: the program's ``repro_torch`` begins
with ``repro``), and a reference that loads nothing of the program."""
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

LOAD_ALL = r"""
import json, pathlib, sys, time
sys.path[:0] = [{root!r}, {root!r} + "/src"]
import importlib
from bench import harness, manifest
for path in sorted(pathlib.Path({root!r}, "bench").rglob("*.py")):
    rel = path.relative_to({root!r}).with_suffix("")
    if "tests" in rel.parts or rel.parts[1] == "metrics":
        continue
    if rel.name in ("run", "calibrate", "sets"):
        continue
    importlib.import_module(".".join(rel.parts).replace(".__init__", ""))
man = manifest.load()
for m in man.data["per_layer"]:
    manifest.metric_reader(m["name"])
# a whole run of each cell at a tiny size on the CPU
for cell in man.cells:
    c = man.cell(cell)
    cfg, tr = man.config(c["config"]), man.traffic(c["traffic"])
    cfg.update(n=1500, n_queries=100)
    cfg["forest"] = dict(cfg["forest"], n_trees=4)
    if tr["driver"] == "search":
        tr.update(batch=32, warmup_batches=1, check_batches=2,
                  trace_batches=2, trace_host_batches=1)
    harness.run_cell(man, cell, 3, 0.2, True, "cpu", time.perf_counter(),
                     config=cfg, traffic=tr)
import run
print(json.dumps(run.forbidden_modules()))
"""

REFERENCE_ONLY = r"""
import json, sys
sys.path[:0] = [{root!r}]
import bench.judge, bench.workcount
import bench.reference.control, bench.reference.forest, bench.reference.search
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("repro_torch", "repro", "jax"))))
"""


def run_python(code: str) -> list:
    proc = subprocess.run(
        [sys.executable, "-c", code.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=600,
        cwd=ROOT / "bench")
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_no_jax_package():
    assert run_python(LOAD_ALL) == []


def test_the_reference_loads_nothing_of_the_program():
    assert run_python(REFERENCE_ONLY) == []
    for path in (ROOT / "bench" / "reference").glob("*.py"):
        text = path.read_text()
        assert "repro_torch" not in text.replace("``repro_torch``", ""), path
        assert "import repro" not in text and "from repro" not in text, path


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, str(ROOT / "bench"))
    try:
        import run
    finally:
        sys.path.remove(str(ROOT / "bench"))
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_x"] = sys.modules["json"]
        sys.modules["reprox"] = sys.modules["json"]
        assert "repro_torch_x" not in run.forbidden_modules()
        sys.modules["repro.core"] = sys.modules["json"]
        assert "repro.core" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
