"""The benchmark's own tests (run with ``python -m pytest bench/tests``
from the repository root; the repository's test run does not collect
them).  Tests marked ``chip`` need a CUDA device and skip without one; the
rest run on the CPU at tiny sizes, the kernels replaced by the program's
plain versions."""
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def man():
    from bench import manifest
    return manifest.load(ROOT)


@pytest.fixture(scope="session")
def tiny(man):
    """(config, traffic) of a cell cut to a CPU test's size: 3,000 rows,
    300 queries, 8 trees, batches of 64 (widths as published)."""

    def cut(cell: str):
        c = man.cell(cell)
        cfg = man.config(c["config"])
        tr = man.traffic(c["traffic"])
        cfg.update(n=3000, n_queries=300)
        cfg["forest"] = dict(cfg["forest"], n_trees=8)
        if tr["driver"] == "search":
            tr.update(batch=64, warmup_batches=2, check_batches=4,
                      trace_batches=3, trace_host_batches=2)
        return cfg, tr

    return cut
