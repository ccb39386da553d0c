#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py          # from the repository root, one CUDA GPU

The main path is the paper's query on the ``rpf`` backend at the paper's own
MNIST-784 configuration (N = 60,000 rows, d = 784, L = 80 trees, C = 12,
r = 0.3): ``build_index`` on ``cuda`` and ``Index.search`` for batches of 1,
7 and 1024 queries at k = 10 with 1 and 4 probes per tree.  Phases, each
printing one JSON line:

  card     the card's name and power limit (``nvidia-smi``)
  build    nvcc builds every kernel from ``src/repro_torch/csrc``
  main     the main path, with every launch and plain-version call counted
           from zero: both kernels must have launched, no plain version run
  compare  the same searches under ``mode="ref"``: distances within rtol
           1e-5 / atol 1e-6 (the kernel sums the 784 terms in another order
           and, for cosine, divides by the norms instead of normalizing
           first), ids equal at every rank whose distance is separated from
           its neighbours by more than that, and every returned id scores
           its returned distance
  kernels  each kernel against its plain version on the same inputs at the
           main path's shapes and at edge shapes: the descent bitwise, the
           fused rerank by the rule above, all four metrics
  timing   ms per 1024-query batch (CUDA events, median of 25 after
           warm-up), QPS, recall@1 / @10 against exact k-NN; recall with 4
           probes must not fall below 1 probe (a superset of candidates,
           reranked exactly)
  profile  device time per search by kernel and the device's idle share
           (``torch.profiler`` over 5 searches of 1024 queries)

then the kernels line (each kernel's launches, time, plain time and bound)
and, last, ``{"ok": true, "device": {...}}``.  Any failed check raises, so
the script exits non-zero without that line.
"""
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
K = 10
BATCHES = (1, 7, 1024)
PROBES = (1, 4)
RTOL, ATOL = 1e-5, 1e-6
FP32_FLOPS = 67e12          # H100 SXM, fp32 outside the tensor cores
# device memory rate by card (NVIDIA data sheets); SXM is the default
MEM_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def mem_rate(name):
    for key, rate in MEM_RATE.items():
        if key in name:
            return rate
    return 3.35e12


def compare_topk(torch, got, want, k):
    """Kernel (or kernel-path) top-k ``got`` against plain ``want``, where
    ``want`` holds k + 1 columns so the last rank's lower neighbour is
    known.  Returns the largest absolute distance error."""
    gd, gi = got
    wd_ext, wi_ext = want
    wd, wi = wd_ext[:, :k], wi_ext[:, :k]
    finite = torch.isfinite(wd)
    check(torch.equal(finite, torch.isfinite(gd)), "inf pattern differs")
    check(bool((gi[~finite] == -1).all()), "id of an inf slot is not -1")
    tol = RTOL * wd_ext.abs() + ATOL
    err = (gd - wd).abs()[finite]
    check(bool((err <= tol[:, :k][finite]).all()),
          f"distance error {float(err.max()) if err.numel() else 0.0}")
    gap = (wd_ext[:, 1:] - wd_ext[:, :-1]).nan_to_num(0.0)   # >= 0
    sep = finite.clone()
    sep[:, 1:] &= gap[:, :k - 1] > tol[:, 1:k]
    sep &= gap[:, :k] > tol[:, :k]
    check(torch.equal(gi[sep], wi[sep]), "ids differ at a separated rank")
    return float(err.max()) if err.numel() else 0.0


def check_scores(torch, metrics_fn, q, db, got):
    """Every returned id must score its returned distance."""
    gd, gi = got
    ok = gi >= 0
    cand = db[gi.clamp_min(0).long()]
    d = metrics_fn(q[:, None, :], cand)
    check(bool(((d - gd).abs()[ok] <= (RTOL * gd.abs() + ATOL)[ok]).all()),
          "a returned id does not score its returned distance")


def time_ms(torch, fn, reps, flush=None):
    """Median device time of ``fn()`` over ``reps`` runs after two warm-up
    runs; ``flush()`` (outside the timed region) evicts the L2 cache."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def node_depths(torch, child_base, max_depth):
    """(L, max_nodes) depth of every reachable node (-1 elsewhere)."""
    n_trees, m = child_base.shape
    depth = torch.full((n_trees, m), -1, dtype=torch.long,
                       device=child_base.device)
    depth[:, 0] = 0
    rows = torch.arange(n_trees, device=child_base.device)[:, None]
    cb = child_base.long()
    for t in range(max_depth):
        par = (depth == t) & (cb >= 0)
        if not bool(par.any()):
            break
        r = rows.expand_as(cb)[par]
        depth[r, cb[par]] = t + 1
        depth[r, cb[par] + 1] = t + 1
    return depth


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA GPU; none is available")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import rpf_mnist784 as cfgmod
    from repro_torch.core.distances import METRICS
    from repro_torch.core.knn import exact_knn
    from repro_torch.core.pipeline import candidates
    from repro_torch.core.search import mask_duplicates, recall_at_k
    from repro_torch.data.synthetic import mnist_like
    from repro_torch.index import IndexSpec, SearchParams, build_index
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.common import LAUNCHES, REF_CALLS
    from repro_torch.kernels.forest_traverse_hbm import forest_traverse_hbm
    from repro_torch.kernels.fused_query import fused_gather_topk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)

    # ---- card ------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- build -----------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    regs = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln]
            for n, log in logs.items()}
    emit({"phase": "build", "seconds": build_s, "built": sorted(logs),
          "ptxas": regs})

    # ---- main path ---------------------------------------------------------
    db_np, _, q_np, _ = mnist_like(cfgmod.N_DB, n_test=cfgmod.QUERY_BATCH,
                                   d=cfgmod.DIM, seed=0)
    spec = IndexSpec(backend="rpf", forest=cfgmod.CONFIG, seed=0)
    queries = torch.from_numpy(q_np).to(dev)
    LAUNCHES.clear()
    REF_CALLS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = build_index(db_np, spec, device=dev)
    torch.cuda.synchronize()
    index_build_s = time.perf_counter() - t0
    results = {}
    n_searches = 0
    for p in PROBES:
        for b in BATCHES:
            results[p, b] = index.search(queries[:b],
                                         SearchParams(k=K, n_probes=p))
            n_searches += 1
    torch.cuda.synchronize()
    launches, ref_calls = dict(LAUNCHES), dict(REF_CALLS)
    for name in ("forest_traverse", "fused_gather_topk"):
        check(launches.get(name, 0) > 0, f"{name} never launched")
    check(sum(ref_calls.values()) == 0, f"plain versions ran: {ref_calls}")
    db = index.engine.db
    forest = index.forest
    rc = spec.forest.resolved(db.shape[0])
    emit({"phase": "main", "rows": db.shape[0], "dim": db.shape[1],
          "trees": rc.n_trees, "max_depth": rc.max_depth,
          "max_nodes": rc.max_nodes, "nodes_used_max": int(forest.n_nodes.max()),
          "index_build_s": index_build_s, "searches": n_searches,
          "launches": launches, "ref_calls": ref_calls})

    # ---- compare with the plain path ---------------------------------------
    worst = 0.0
    for (p, b), got in results.items():
        want = index.search(queries[:b], SearchParams(k=K + 1, n_probes=p,
                                                      mode="ref"))
        worst = max(worst, compare_topk(torch, got, want, K))
        check_scores(torch, METRICS["l2"], queries[:b], db, got)
    emit({"phase": "compare", "cases": len(results), "max_abs_err": worst})

    # ---- kernels against their plain versions ------------------------------
    feat = forest.proj_idx[..., 0]
    thresh, child = forest.thresh, forest.child_base
    trav_cases = 0
    for p in (1, 3, 4):
        for b in BATCHES:
            got = forest_traverse_hbm(feat, thresh, child, queries[:b],
                                      rc.max_depth, p)
            want = ref.forest_traverse_ref(feat, thresh, child, queries[:b],
                                           rc.max_depth, p)
            check(torch.equal(got, want), f"descent differs at P={p} B={b}")
            trav_cases += 1
    # more probes than levels: the tail slots must be -1 in both
    got = forest_traverse_hbm(feat, thresh, child, queries[:7], 3, 6)
    want = ref.forest_traverse_ref(feat, thresh, child, queries[:7], 3, 6)
    check(torch.equal(got, want) and bool((got[..., 4:] == -1).all()),
          "descent differs with P > max_depth + 1")
    trav_cases += 1

    cand = {}
    for p in PROBES:
        ids, mask = candidates(forest, queries, rc.max_depth, rc.leaf_pad, p)
        cand[p] = torch.where(mask_duplicates(ids, mask), ids, -1).int()
    gen = torch.Generator(device=dev).manual_seed(1)
    holes = cand[1].clone()
    holes[torch.rand(holes.shape, generator=gen, device=dev) < 0.3] = -1
    fused_cases, fused_err = 0, 0.0
    shapes = [(cand[1], K), (cand[4], K), (cand[1][:1], 1), (cand[1][:7], K),
              (holes[:7], K), (holes, 1), (cand[4][:7, :40], 128)]
    for metric in ("l2", "dot", "chi2", "cosine"):
        for ids, k in shapes:
            q = queries[:ids.shape[0]].contiguous()
            ids = ids.contiguous()
            got = fused_gather_topk(q, ids, db, k, metric)
            # rows are independent: the plain version in 128-row slabs is
            # the same function, with its (B, M, d) gather kept small
            want = [ref.fused_gather_topk_ref(q[i:i + 128], ids[i:i + 128],
                                              db, k + 1, metric)
                    for i in range(0, q.shape[0], 128)]
            want = tuple(torch.cat(w) for w in zip(*want))
            fused_err = max(fused_err, compare_topk(torch, got, want, k))
            fused_cases += 1
    torch.cuda.synchronize()
    emit({"phase": "kernels", "descent_cases": trav_cases,
          "descent_bitwise": True, "fused_cases": fused_cases,
          "fused_max_abs_err": fused_err})

    # ---- timing, recall ----------------------------------------------------
    rate = mem_rate(card)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    _, true_i = exact_knn(queries, db, K)
    cell = {}
    for p in PROBES:
        params = SearchParams(k=K, n_probes=p)
        ms = time_ms(torch, lambda: index.search(queries, params), 25)
        _, ids = results[p, cfgmod.QUERY_BATCH]
        cell[p] = {"ms_per_batch": ms, "qps": cfgmod.QUERY_BATCH / ms * 1e3,
                   "recall_at_1": recall_at_k(ids[:, :1], true_i[:, :1]),
                   "recall_at_10": recall_at_k(ids, true_i)}
    check(cell[4]["recall_at_1"] >= cell[1]["recall_at_1"]
          and cell[4]["recall_at_10"] >= cell[1]["recall_at_10"],
          f"recall fell with more probes: {cell}")
    emit({"phase": "timing", "batch": cfgmod.QUERY_BATCH, "k": K,
          "card": smi, "n_probes": cell})

    # ---- where the time goes: device time by kernel over 5 searches -------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    breakdown = {}
    for p in PROBES:
        params = SearchParams(k=K, n_probes=p)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                index.search(queries, params)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_name, n_events = {}, 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                n_events += 1
                name = e.name.split("(")[0].split("<")[0][:60]
                by_name[name] = by_name.get(name, 0.0) \
                    + e.time_range.elapsed_us() / 1e3
        busy = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        breakdown[p] = {"wall_ms_per_search": wall_ms / 5,
                        "device_ms_per_search": busy / 5,
                        "device_idle_share": 1 - busy / wall_ms,
                        "device_events": n_events,
                        "kernels_ms_per_search": {n: t / 5 for n, t in top}}
    emit({"phase": "profile", "batch": cfgmod.QUERY_BATCH, "card": smi,
          "n_probes": breakdown})

    # descent: bytes are 16 B per (tree, query, level reached) -- child_base,
    # feat, thresh, q[b, feat] -- plus the leaf's child_base and the output
    depth = node_depths(torch, child, rc.max_depth)
    l_idx = torch.arange(rc.n_trees, device=dev)[:, None, None]
    trav_rows = []
    for p in PROBES:
        leaves = forest_traverse_hbm(feat, thresh, child, queries,
                                     rc.max_depth, p).view(rc.n_trees, -1, p)
        ok = leaves >= 0
        levels = torch.where(ok, depth[l_idx, leaves.clamp_min(0).long()], 0)
        n_desc = int(ok.sum())
        nbytes = 16 * int(levels.sum()) + 4 * n_desc + 4 * leaves.numel()
        trav_rows.append({
            "n_probes": p,
            "ms": time_ms(torch, lambda: forest_traverse_hbm(
                feat, thresh, child, queries, rc.max_depth, p), 25, flush),
            "plain_ms": time_ms(torch, lambda: ref.forest_traverse_ref(
                feat, thresh, child, queries, rc.max_depth, p), 5, flush),
            "bound_ms": nbytes / rate * 1e3, "bytes": nbytes,
            "mean_levels": float(levels[ok].float().mean()),
            "max_levels": int(levels.max())})
    # the latency of one level: a single thread descends a synthetic chain
    # of 127 nodes scattered through 3 x 64 MB arrays (thresh +inf sends
    # every step left, to child_base); the time over a 1-level descent,
    # per extra level, is the dependent-load latency the descent pays
    n_chain, hops = 1 << 24, 127
    path = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                      1 + torch.randperm(n_chain - 1, generator=gen,
                                         device=dev)[:hops]])
    c_feat = torch.zeros((1, n_chain), dtype=torch.int32, device=dev)
    c_thresh = torch.full((1, n_chain), float("inf"), device=dev)
    c_child = torch.full((1, n_chain), -1, dtype=torch.int32, device=dev)
    c_child[0, path[:-1]] = path[1:].int()
    q_chain = torch.zeros((1, 1), device=dev)
    t_long, t_short = (time_ms(torch, lambda n=n: forest_traverse_hbm(
        c_feat, c_thresh, c_child, q_chain, n), 25, flush) for n in (hops, 1))
    per_level_us = (t_long - t_short) * 1e3 / (hops - 1)

    # fused rerank: each valid slot reads its row once; ids, q, output once
    fused_rows = []
    for p in PROBES:
        ids = cand[p].contiguous()
        valid = int((ids >= 0).sum())
        b, m = ids.shape
        nbytes = valid * db.shape[1] * 4 + b * m * 4 + queries.numel() * 4 \
            + b * K * 8
        flops = 3 * valid * db.shape[1]
        bound = max(nbytes / rate, flops / FP32_FLOPS) * 1e3
        fused_rows.append({
            "m": m, "valid_slots": valid,
            "ms": time_ms(torch, lambda: fused_gather_topk(
                queries, ids, db, K, "l2"), 25, flush),
            "plain_ms": time_ms(torch, lambda: ref.fused_gather_topk_ref(
                queries, ids, db, K, "l2"), 5, flush),
            "bound_ms": bound, "bytes": nbytes, "flops": flops,
            "bound_by": "bytes" if nbytes / rate >= flops / FP32_FLOPS
            else "operations"})

    per_search = {n: launches[n] / n_searches for n in launches}
    t1, f1 = trav_rows[0], fused_rows[0]
    emit({"kernels": [
        {"name": "forest_traverse", "route": "cuda",
         "source": "src/repro_torch/csrc/forest_traverse.cu",
         "replaces": "src/repro/kernels/forest_traverse_hbm.py:158",
         "launches": launches["forest_traverse"],
         "launches_per_search": per_search["forest_traverse"],
         "max_abs_err": 0.0, "ms": t1["ms"], "plain_ms": t1["plain_ms"],
         "bound_ms": t1["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "latency_per_level_us": per_level_us,
         "latency_floor_ms": per_level_us * t1["max_levels"] / 1e3,
         "shapes": trav_rows},
        {"name": "fused_gather_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_query.cu",
         "replaces": "src/repro/kernels/fused_query.py:146",
         "launches": launches["fused_gather_topk"],
         "launches_per_search": per_search["fused_gather_topk"],
         "max_abs_err": fused_err, "ms": f1["ms"], "plain_ms": f1["plain_ms"],
         "bound_ms": f1["bound_ms"], "bound_by": f1["bound_by"],
         "library_ms": None, "shapes": fused_rows},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
