"""The port's examples at a small size on the CPU: ``examples/
quickstart_torch.py`` and ``ann_serving_torch.py`` at ``--tiny``,
``two_tower_retrieval_torch.py`` at 600 users, 4,000 items and 60 steps.
Each example asserts its own checks (the mutation block's answers, an added
point found at once and a deleted one never, two-tower recall@20 >= 0.8
against exact MIPS); here their returned numbers are checked as well.
Without ``--device`` they run on the GPU and raise without one.
"""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def test_quickstart_tiny():
    out = _example("quickstart_torch").main(["--device", "cpu", "--tiny"])
    rec = out["recall_by_trees"]
    assert list(rec) == [5, 20]
    assert rec[5] < rec[20]                        # recall rises with L
    assert out["tuned"]["recall"] >= rec[5]
    assert 0 < out["int8_waves_trees_used"] <= 20
    assert out["mutated"] == {"n_live": 1999, "n_tombstones": 3,
                              "n_segments": 1}
    assert out["compacted"] == {"n_live": 1999, "n_tombstones": 0,
                                "n_segments": 1}
    assert (out["chi2_ids"][:, 0] == range(8)).all()   # each row its own


def test_ann_serving_tiny():
    out = _example("ann_serving_torch").main(["--device", "cpu", "--tiny"])
    assert out["batcher"]["requests"] == out["clients"] == 32
    assert out["new_id"] == 2000
    assert out["stats"]["n_compactions"] == 1
    assert out["stats"]["n_live"] == 2000


def test_two_tower_small():
    out = _example("two_tower_retrieval_torch").main(
        ["--device", "cpu", "--users", "600", "--items", "4000",
         "--steps", "60"])
    assert len(out["loss"]) == 60
    assert out["recall"] >= 0.9


@pytest.mark.parametrize("name", ["quickstart_torch", "ann_serving_torch",
                                  "two_tower_retrieval_torch"])
def test_examples_raise_without_a_gpu(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main([])
