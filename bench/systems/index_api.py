"""The system under test: the port's index API (``repro_torch.index``).

``build`` is ``build_index(rows, IndexSpec(backend=..., forest=...,
seed=...))``; ``search`` is ``Index.search(queries, SearchParams(k=,
metric=, n_probes=))``; ``forest`` reads the built forest's arrays, which
only the judge reads, to hold them against the reference's.  The program is
imported when a run starts, never when this module is imported.
"""
from __future__ import annotations


class System:
    def __init__(self, config: dict, traffic: dict):
        from repro_torch.core.forest import ForestConfig
        from repro_torch.index import IndexSpec, SearchParams, build_index

        self._build_index = build_index
        self._spec = IndexSpec
        f = config["forest"]
        self.forest_config = ForestConfig(
            n_trees=f["n_trees"], capacity=f["capacity"],
            split_ratio=f["split_ratio"], n_proj=f["n_proj"])
        self.backend = config["backend"]
        self.params = None
        if "k" in traffic:
            self.params = SearchParams(k=traffic["k"],
                                       metric=config["metric"],
                                       n_probes=traffic["n_probes"])

    def build(self, rows, seed: int):
        return self._build_index(rows, self._spec(
            backend=self.backend, forest=self.forest_config, seed=seed),
            device=rows.device)

    def search(self, index, queries):
        return index.search(queries, self.params)

    @staticmethod
    def forest(index):
        """The forest's arrays (a tuple of tensors) of a pristine index."""
        (segment,) = index._segments
        return tuple(segment.engine.forest)
