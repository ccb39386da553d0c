"""On the card: one short run of every cell through ``bench/run.py``, as the
check runs it, must print a correct result line.  Skips without a CUDA
device (``python -m pytest bench/tests -m chip`` on the chip)."""
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["mnist784.bulk_p4", "iss595.bulk_p4",
                                  "iss595.rebuild"])
@pytest.mark.parametrize("traced", [0, 1])
def test_a_short_run_is_correct(cuda_device, cell, traced):
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed",
         str(2**31 + 17), "--seconds", "4", "--trace", str(traced)],
        capture_output=True, text=True, timeout=360, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
