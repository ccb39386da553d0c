"""Closed-loop bulk search: one client sends batches of ``batch`` queries
with at most ``inflight`` in flight.

Traffic parameters: ``batch``, ``k``, ``n_probes``, ``inflight``,
``warmup_batches`` (set-up: the kernels built and loaded, every shape the
window uses run once), ``check_batches`` (the sample of the window's
answers the judge compares, drawn from the seed), ``trace_batches`` (the
traced window's length, on the device alone) and ``trace_host_batches``
(the span traced with the host's ops, for the idle gaps).  The queries come in order from the
configuration's query pool, cycling; a batch that runs past the pool's end
wraps to its start.

A batch is dispatched by ``System.search``; its (distances, ids) are copied
to pinned host memory and it counts as answered once the copy's event has
passed.  Its latency runs from the dispatch to that moment.  The window
dispatches until ``--seconds`` have passed since its first dispatch, then
waits for what is in flight; it ends at the last answer.

  qps            batches answered x batch / the window's seconds
  batch_p99_ms   the 99th percentile (nearest rank) of every batch's latency
  setup_s        process start to the first timed dispatch
"""
from __future__ import annotations

import collections
import math
import random

import torch

from bench import judge, trace, workcount
from bench.harness import Fence, Outcome, make_data, now
from bench.reference import forest as rforest
from bench.reference import search as rsearch


def p99(values: list[float]) -> float:
    s = sorted(values)
    return s[max(0, math.ceil(0.99 * len(s)) - 1)]


class Reservoir:
    """A uniform sample of ``size`` items of a stream, drawn from ``rng``,
    and the stream's first item."""

    def __init__(self, size: int, rng: random.Random):
        self.size, self.rng, self.seen = size, rng, 0
        self.first = None
        self.items: list = []

    def offer(self, make):
        """``make()`` builds the item; called only if it is kept."""
        n = self.seen
        self.seen += 1
        if n == 0:
            self.first = make()
        elif len(self.items) < self.size:
            self.items.append(make())
        else:
            r = self.rng.randrange(n)
            if r < self.size:
                self.items[r] = make()

    def all(self) -> list:
        return ([self.first] if self.first is not None else []) + self.items


class Window:
    def __init__(self):
        self.latencies: list[float] = []
        self.enqueue: list[float] = []
        self.starts: list[int] = []
        self.t_start = self.t_end = 0.0

    @property
    def batches(self) -> int:
        return len(self.latencies)

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start


class Loop:
    """The closed loop over one index; batch numbers carry on from run to
    run, so the pool keeps cycling."""

    def __init__(self, ctx, index, pool: torch.Tensor, batch: int, k: int,
                 inflight: int):
        self.ctx, self.index, self.b, self.inflight = ctx, index, batch, \
            inflight
        self.pool_n = pool.shape[0]
        self.pool = torch.cat([pool, pool[:batch]])
        self.i = 0
        pin = ctx.cuda
        self.ring = [(torch.empty((batch, k), dtype=torch.float32,
                                  pin_memory=pin),
                      torch.empty((batch, k), dtype=torch.int32,
                                  pin_memory=pin))
                     for _ in range(inflight + 1)]

    def queries(self, start: int) -> torch.Tensor:
        return self.pool[start:start + self.b]

    def run(self, count: int | None = None, seconds: float | None = None,
            keep: Reservoir | None = None, spans: bool = False) -> Window:
        w, pending = Window(), collections.deque()
        system, n0 = self.ctx.system, self.i
        w.t_start = now()
        deadline = w.t_start + (seconds if seconds is not None else math.inf)
        while True:
            more = (self.i - n0 < count if count is not None
                    else now() < deadline)
            if more and len(pending) < self.inflight:
                start = (self.i * self.b) % self.pool_n
                slot = self.ring[self.i % len(self.ring)]
                t0 = now()
                with trace.span("bench.search", spans):
                    d, ids = system.search(self.index, self.queries(start))
                t1 = now()
                with trace.span("bench.copy", spans):
                    slot[0].copy_(d, non_blocking=True)
                    slot[1].copy_(ids, non_blocking=True)
                    fence = Fence(self.ctx)
                pending.append((start, t0, fence, slot))
                w.enqueue.append(t1 - t0)
                w.starts.append(start)
                self.i += 1
                continue
            if not pending:
                break
            start, t0, fence, slot = pending.popleft()
            with trace.span("bench.wait", spans):
                fence.wait()
            w.t_end = now()
            w.latencies.append(w.t_end - t0)
            if keep is not None:
                keep.offer(lambda: (start, slot[0].clone(), slot[1].clone()))
        return w


def judge_answers(ctx, rows, loop: Loop, kept: list, forest_arrays,
                  seed: int) -> tuple:
    """Build the reference forest from the rows and the seed, then compare
    the forest and every kept answer."""
    cfg, tr = ctx.config, ctx.traffic
    f = cfg["forest"]
    ref = rforest.build(rows, f["n_trees"], f["capacity"], f["split_ratio"],
                        seed)
    numbers = {"forest_diff": rforest.count_diff(ref, forest_arrays)}
    depth, _ = rforest.sizes(cfg["n"], f["capacity"], f["split_ratio"])
    for start, p_d, p_i in kept:
        q = loop.queries(start)
        r_d, r_i, cand = rsearch.query(ref, q, rows, tr["k"], cfg["metric"],
                                       depth, tr["n_probes"], f["capacity"])
        numbers = judge.merge(numbers, judge.search_numbers(
            p_d.to(rows.device), p_i.to(rows.device), q, rows, r_d, r_i,
            cand, cfg["metric"]))
    return numbers, ref


def work_counts(ctx, rows, loop: Loop, ref, starts: list[int]) -> dict:
    """The traced batches' least times, from the reference's descent and
    candidates (``bench/workcount.py``)."""
    cfg, tr = ctx.config, ctx.traffic
    f = cfg["forest"]
    depth, max_nodes = rforest.sizes(cfg["n"], f["capacity"],
                                     f["split_ratio"])
    rerank = step = 0.0
    for start in starts:
        visited: list = []
        leaves = rsearch.descend(ref, loop.queries(start), depth,
                                 tr["n_probes"], visited)
        cand = rsearch.candidates(ref, leaves, f["capacity"])
        ops, nbytes = workcount.rerank_work(cand, cfg["d"], tr["k"],
                                            cfg["metric"])
        fbytes = workcount.forest_bytes(visited, leaves, ref.leaf_count,
                                        max_nodes, f["capacity"])
        rerank += workcount.least_seconds(ops, nbytes)
        step += workcount.least_seconds(ops, nbytes + fbytes)
    return {"rerank_least_s": rerank, "step_least_s": step}


def run(ctx) -> Outcome:
    tr = ctx.traffic
    rows, pool = make_data(ctx)
    ctx.mark("data")
    build_seed = ctx.seed + 1
    index = ctx.system.build(rows, build_seed)
    ctx.sync()
    ctx.mark("build")
    loop = Loop(ctx, index, pool, tr["batch"], tr["k"], tr["inflight"])
    loop.run(count=tr["warmup_batches"])
    ctx.sync()
    ctx.mark("warm-up")
    setup_s = now() - ctx.t0

    keep = Reservoir(tr["check_batches"], random.Random(ctx.seed))
    w = loop.run(seconds=ctx.seconds, keep=keep)
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.cuda else 0
    obs = None
    if ctx.trace:
        tw, window, device_ops, _ = trace.profile(
            lambda: loop.run(count=tr["trace_batches"]))
        obs = trace.Observation(
            "search", tw.batches, window, device_ops,
            gaps=trace.profile(lambda: loop.run(
                count=tr["trace_host_batches"], spans=True), host=True)[1:],
            host={"enqueue_ms": 1e3 * sum(w.enqueue) / len(w.enqueue)})

    # the program's state goes before the reference runs
    forest_arrays = tuple(a.cpu() for a in ctx.system.forest(index))
    loop.index = index = None
    if ctx.cuda:
        torch.cuda.empty_cache()
    numbers, ref = judge_answers(ctx, rows, loop, keep.all(), forest_arrays,
                                 build_seed)
    if obs is not None:
        obs.work = work_counts(ctx, rows, loop, ref, tw.starts)
    e2e = {"qps": w.batches * tr["batch"] / w.seconds,
           "batch_p99_ms": 1e3 * p99(w.latencies), "setup_s": setup_s}
    return Outcome(e2e=e2e, attempted=w.batches, failed=0, numbers=numbers,
                   memory_peak_bytes=peak, observation=obs)
