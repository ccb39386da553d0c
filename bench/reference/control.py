"""The control: the reference put in the program's place, computed in the
precision below the configuration's (its ``control``: "tf32" where the
configuration states float32 with TF32 off, "bf16" for other float32).

``part="rerank"`` rounds the rows and queries the rerank reads (the
forest is the reference's float32 build); ``part="build"`` builds the
forest over the rounded rows (the rerank is the reference's float64 one).
It offers the system's surface (``build``, ``search``, ``forest``), so a run
drives it through the same loop, window and judge as the program.  It
imports nothing of the program.
"""
from __future__ import annotations

import torch

from bench.reference import forest as rforest
from bench.reference import search as rsearch


class Control:
    def __init__(self, config: dict, traffic: dict, part: str):
        if part not in ("rerank", "build"):
            raise ValueError(f"part is rerank or build, not {part!r}")
        self.config, self.traffic, self.part = config, traffic, part
        self.precision = config["control"]

    def build(self, rows: torch.Tensor, seed: int):
        f = self.config["forest"]
        forest = rforest.build(
            rows, f["n_trees"], f["capacity"], f["split_ratio"], seed,
            self.precision if self.part == "build" else "fp32")
        return forest, rows

    def search(self, index, queries: torch.Tensor):
        forest, rows = index
        f, tr = self.config["forest"], self.traffic
        depth, _ = rforest.sizes(rows.shape[0], f["capacity"],
                                 f["split_ratio"])
        d, i, _ = rsearch.query(
            forest, queries, rows, tr["k"], self.config["metric"], depth,
            tr["n_probes"], f["capacity"],
            self.precision if self.part == "rerank" else "fp64")
        return d.float(), i.int()

    @staticmethod
    def forest(index):
        return tuple(index[0])
