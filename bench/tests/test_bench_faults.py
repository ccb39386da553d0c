"""``correct`` against a broken timed path: each fault a cell can have,
planted under a whole run at a tiny size on the CPU, and the control (the
reference in the precision below the configuration's) in the program's
place, must come out not correct; the program itself must come out
correct.  One chip a cell, so no exchange between chips to leave out."""
import time

import pytest
import torch

from bench import harness, manifest


class Fault:
    """The program with one fault planted where it produces its answer."""

    def __init__(self, inner, kind: str):
        self.inner, self.kind = inner, kind
        self.last = self.last_index = None
        self.n = 0

    def build(self, rows, seed):
        self.n = rows.shape[0]
        index = self.inner.build(rows, seed)
        if self.kind == "stale":            # returns the state it had
            index, self.last_index = self.last_index or index, index
        elif self.kind == "altered":       # one leaf's point changed
            perm = self.inner.forest(index)[4]
            perm[0, 0] = (perm[0, 0] + 1) % perm.shape[1]
        return index

    def search(self, index, q):
        d, i = self.inner.search(index, q)
        if self.kind == "stale":            # the previous batch's answers
            out = self.last or (d, i)
            self.last = (d.clone(), i.clone())
            return out
        if self.kind == "half":             # half the batch left out
            h = q.shape[0] // 2
            d = torch.cat([d[:h], d[:q.shape[0] - h]])
            i = torch.cat([i[:h], i[:q.shape[0] - h]])
        elif self.kind == "altered":       # one answer's id changed
            i = i.clone()
            i[0, 0] = (i[0, 0] + 1) % self.n
        return d, i

    def forest(self, index):
        return self.inner.forest(index)


def run(man, tiny, cell, system_of):
    cfg, tr = tiny(cell)
    program = manifest.module("systems", cfg["system"]).System(cfg, tr)
    return harness.run_cell(man, cell, 2**31 + 9, 0.3, False, "cpu",
                            time.perf_counter(), system=system_of(
                                program, cfg, tr),
                            config=cfg, traffic=tr)


SEARCH = ["mnist784.bulk_p4", "iss595.bulk_p4"]


@pytest.mark.parametrize("cell", SEARCH + ["iss595.rebuild"])
def test_the_program_is_correct(man, tiny, cell):
    r = run(man, tiny, cell, lambda p, c, t: p)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
@pytest.mark.parametrize("cell", SEARCH)
def test_search_faults_are_caught(man, tiny, cell, kind):
    r = run(man, tiny, cell, lambda p, c, t: Fault(p, kind))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("kind", ["stale", "altered"])
def test_build_faults_are_caught(man, tiny, kind):
    r = run(man, tiny, "iss595.rebuild", lambda p, c, t: Fault(p, kind))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell,part", [(c, "rerank") for c in SEARCH]
                         + [(c, "build") for c in SEARCH]
                         + [("iss595.rebuild", "build")])
def test_the_control_is_not_correct(man, tiny, cell, part):
    from bench.reference.control import Control
    r = run(man, tiny, cell, lambda p, c, t: Control(c, t, part))
    assert not r["correct"], r["checks"]
