"""Back-to-back index rebuilds over the configuration's rows, already on the
device.

Traffic parameters: ``seed_step`` (build i of the window draws from seed
+ 2 + i x seed_step, so every build is a new forest), ``check_builds``
(the builds the judge compares beside the window's first, drawn from the
seed), ``trace_builds`` (the traced window's length, on the device alone)
and ``trace_host_builds`` (the span traced with the host's ops, for the
idle gaps).  Set-up makes one
build (the seed + 1) to warm the allocator and every shape.

A build is ``System.build`` followed by a device synchronize; the window
starts builds until ``--seconds`` have passed since its start and ends when
the last one has finished.

  build_rows_per_s  builds finished x rows / the window's seconds
  setup_s           process start to the first timed build
"""
from __future__ import annotations

import random

import torch

from bench import trace
from bench.drivers.search import Reservoir
from bench.harness import Outcome, make_data, now
from bench.reference import forest as rforest


def _builds(ctx, rows, seeds, keep=None, spans=False):
    """Build from each seed in turn; (builds, t_start, t_end)."""
    t_start = t_end = now()
    n = 0
    for seed in seeds:
        with trace.span("bench.build", spans):
            index = ctx.system.build(rows, seed)
            ctx.sync()
        t_end = now()
        n += 1
        if keep is not None:
            keep.offer(lambda: (seed, ctx.system.forest(index)))
    return n, t_start, t_end


def run(ctx) -> Outcome:
    tr, cfg = ctx.traffic, ctx.config
    rows, _ = make_data(ctx)
    ctx.mark("data")
    _builds(ctx, rows, [ctx.seed + 1])
    ctx.mark("build")
    setup_s = now() - ctx.t0

    def timed():
        i = 0
        while now() < deadline:
            yield ctx.seed + 2 + i * tr["seed_step"]
            i += 1

    keep = Reservoir(tr["check_builds"], random.Random(ctx.seed))
    deadline = now() + ctx.seconds
    n, t_start, t_end = _builds(ctx, rows, timed(), keep)
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.cuda else 0
    obs = None
    if ctx.trace:
        base = ctx.seed + 2 + n * tr["seed_step"]
        seeds = [base + i * tr["seed_step"] for i in range(tr["trace_builds"])]
        (units, _, _), window, device_ops, _ = trace.profile(
            lambda: _builds(ctx, rows, seeds))
        host_seeds = [seeds[-1] + (i + 1) * tr["seed_step"]
                      for i in range(tr["trace_host_builds"])]
        obs = trace.Observation("build", units, window, device_ops,
                                gaps=trace.profile(lambda: _builds(
                                    ctx, rows, host_seeds, spans=True),
                                    host=True)[1:])

    # the program's forests go to the host before the reference runs
    kept = [(seed, tuple(a.cpu() for a in arrays))
            for seed, arrays in keep.all()]
    keep = None
    if ctx.cuda:
        torch.cuda.empty_cache()
    f = cfg["forest"]
    diff = 0
    for seed, arrays in kept:
        ref = rforest.build(rows, f["n_trees"], f["capacity"],
                            f["split_ratio"], seed)
        diff += rforest.count_diff(ref, arrays)
        del ref
    e2e = {"build_rows_per_s": n * cfg["n"] / (t_end - t_start),
           "setup_s": setup_s}
    return Outcome(e2e=e2e, attempted=n, failed=0,
                   numbers={"forest_diff": diff}, memory_peak_bytes=peak,
                   observation=obs)
