#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one GPU and check them.

    python3 chip_smoke.py          # from the repository root, one CUDA GPU

Eight paths, each driven through the entry points a user calls, with every
kernel launch and plain-version call counted from zero just before it and
read just after (every kernel of the path must have launched, no plain
version may have run):

  main     the paper's query on the ``rpf`` backend at the paper's own
           MNIST-784 configuration (N = 60,000, d = 784, L = 80, C = 12,
           r = 0.3): ``build_index`` on ``cuda`` and ``Index.search`` for
           batches of 1, 7 and 1024 at k = 10 with 1 and 4 probes per tree
           (kernels A and B)
  int8     the same on ``rpf+int8`` with expand 4 (kernels A, C and B)
  brute    ``ops.topk`` l2 and dot on MNIST-784 (kernel D), the
           ``bruteforce`` backend on MNIST-784 (kernel B at M = N), and
           ``ops.topk`` chi2 on ISS-595 at full size (kernel E); B = 1024
  iss595   ``build_index`` on ``iss_like`` at the paper's ISS-595
           configuration (N = 250,736, d = 595, L = 160, chi2) and 1024
           queries at 1 and 4 probes (kernels A and B at d = 595)
  tree     ``ops.traverse_tree(kernel="smem")`` on every tree of the
           MNIST-784 forest, sliced to its used nodes, for 1, 7 and 1024
           queries at 1 and 4 probes (kernel F); ``kernel="auto"`` on an
           unsliced MNIST tree and an ISS-595 tree, both over the card's
           shared-memory cap, must launch kernel A, and ``kernel="smem"``
           there must raise
  rerank   ``ops.rerank_candidates`` on the ``rpf`` path's own deduplicated
           candidates gathered as db[ids]: MNIST-784 at 1 and 4 probes (M =
           960 / 3840), ISS-595 chi2 at 1 probe (M = 1920), B = 1, 7, 1024
           (kernel G)
  bag      ``ops.embedding_bag`` on the MIND history bag: a 1,000,000 x 64
           f32 table, H = 50, B = 512 and 262,144 (kernel H, with its launch
           shape and an empty kernel of the same grid as its latency floor)
  lsh      ``build_index`` on ``lsh-cascade`` over MNIST-784 at the paper's
           radii and ``Index.search`` for 1, 7 and 1024 queries (the host
           buckets, then kernel B)

Phases, each printing one JSON line:

  card     the card's name and power limit (``nvidia-smi``)
  build    nvcc builds every kernel from ``src/repro_torch/csrc``
  <path>   each path above and its launch counts
  compare  each path's searches against the plain path (``mode="ref"``, or
           the plain versions in 128-query slabs): distances within rtol
           1e-5 / atol 1e-6 (the kernels sum the d terms in another order
           and, for cosine, divide by the norms instead of normalizing
           first) -- for kernel D's l2 / dot within 1e-5 (|q|^2 + |c|^2) +
           1e-6, since the expansion cancels near 0 -- ids equal at every
           rank whose distance is separated from its neighbours by more
           than that, and every returned id scores its returned distance
  kernels  each kernel against its plain version at the paths' shapes and
           at edge shapes: the descents bitwise (kernel F also against
           kernel A), the others by the rule above (kernel G also against
           kernel B on the same ids; kernel H within 1e-5 sum_h |w row| +
           1e-6 of its plain version, at every launch shape it takes;
           kernel E also bitwise, ids equal, against the d-ordered plain
           sum on sparse and dense slabs of ISS-595 with edge rows and an
           edge query)
  timing   ms per 1024-query batch (CUDA events, median after warm-up),
           QPS, recall@1 / @10 against exact k-NN (MNIST) or against kernel
           E's exact chi2 top-1 (ISS-595); recall with 4 probes must not
           fall below 1 probe (a superset of candidates, reranked exactly);
           ``lsh-cascade`` beside ``rpf`` at k = 10: ms per batch, recall,
           mean candidates, build seconds
  profile  device time per search by kernel and the device's idle share
           (``torch.profiler`` over 5 searches of 1024 queries)
  done     the script's wall time

then the kernels line (each kernel's launches, time, plain time and bound)
and, last, ``{"ok": true, "device": {...}}``.  Any failed check raises, so
the script exits non-zero without that line.
"""
import collections
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
K = 10
EXPAND = 4
BATCHES = (1, 7, 1024)
PROBES = (1, 4)
RTOL, ATOL = 1e-5, 1e-6
SLAB = 128                  # queries per slab of a plain version's run
FP32_FLOPS = 67e12          # H100 SXM, fp32 outside the tensor cores
# fp32 instruction issues per chi2 term whose row element is not 0: x - y,
# x + y, + eps, t * t, the IEEE division's fast path (reciprocal, check,
# five FMAs) and the accumulate, as kernel E's SASS shows
# (``sass_per_chi2_term``); a term whose row element is 0 costs kernel E one
# FADD.  An SM issues 128 fp32 lanes a cycle (FP32_FLOPS / 2)
CHI2_ISSUES = 12
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


def compare_topk(torch, got, want, k, tol=None):
    """Kernel (or kernel-path) top-k ``got`` against plain ``want``, where
    ``want`` holds k + 1 columns so the last rank's lower neighbour is
    known; ``tol`` (B, k + 1) defaults to rtol / atol of ``want``'s
    distances.  Returns the largest absolute distance error."""
    gd, gi = got
    wd_ext, wi_ext = want
    wd, wi = wd_ext[:, :k], wi_ext[:, :k]
    finite = torch.isfinite(wd)
    check(torch.equal(finite, torch.isfinite(gd)), "inf pattern differs")
    check(bool((gi[~finite] == -1).all()), "id of an inf slot is not -1")
    if tol is None:
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


def expansion_tol(torch, q, db, ids):
    """The l2 / dot expansion's tolerance at (B, k) result ids: 1e-5
    (|q|^2 + |c|^2) + 1e-6 (+inf where the id is -1)."""
    q_sq = torch.sum(q * q, dim=1)[:, None]
    c_sq = torch.sum(db * db, dim=1)[ids.clamp_min(0).long()]
    return torch.where(ids >= 0, 1e-5 * (q_sq + c_sq) + 1e-6, float("inf"))


def in_slabs(torch, fn, b, size=SLAB):
    """``fn(lo, hi)`` over query slabs, outputs concatenated: a plain
    version run slab by slab is the same function with its gathered block
    kept small."""
    parts = [fn(lo, min(b, lo + size)) for lo in range(0, b, size)]
    return tuple(torch.cat(p) for p in zip(*parts))


def counted(torch, counters, fn):
    """Run ``fn`` with every counter set to zero just before and read just
    after: (fn(), launches, plain-version calls)."""
    for c in counters:
        c.clear()
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    return (out,) + tuple(dict(c) for c in counters)


def require(launches, ref_calls, names, path):
    for name in names:
        check(launches.get(name, 0) > 0, f"{name} never launched on {path}")
    check(sum(ref_calls.values()) == 0,
          f"plain versions ran on {path}: {ref_calls}")


def sass_per_chi2_term(path):
    """Kernel E's fp32-pipe instructions (FADD, FMUL, FFMA, FCHK,
    MUFU.RCP) per chi2 term of its non-zero path as compiled: counted in
    the SASS of ``chi2_scan_kernel`` up to the IEEE division's slow-path
    subroutine, less the zero path's FADDs (the basic blocks that hold
    nothing but FADDs), per FCHK (one per non-zero term).  None where the
    toolkit has no ``cuobjdump``."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    body = sass.split("Function : _Z16chi2_scan_kernel")[1]
    body = body.split("Function :")[0]
    code = [(int(a, 16), op, rest) for a, op, rest in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9.]+)([^;]*);",
        body)]
    calls = [int(t, 16) for _, op, rest in code if op.startswith("CALL")
             for t in re.findall(r"0x([0-9a-f]+)", rest)]
    main = [(a, op, rest) for a, op, rest in code
            if not calls or a < min(calls)]
    targets = {int(t, 16) for _, op, rest in main if op.startswith("BRA")
               for t in re.findall(r"0x([0-9a-f]+)", rest)}
    blocks, block = [], []
    for a, op, _ in main:          # basic blocks: split at branch targets
        if a in targets and block:  # and after every branch
            blocks.append(block)
            block = []
        block.append(op.split(".")[0])
        if op.startswith(("BRA", "CALL", "EXIT", "RET")):
            blocks.append(block)
            block = []
    blocks.append(block)
    zero_fadds = sum(len(b) - (b[-1] == "BRA") for b in blocks
                     if b and set(b) <= {"FADD", "BRA"} and b[0] == "FADD")
    n = collections.Counter(op for b in blocks for op in b)
    fp32 = n["FADD"] + n["FMUL"] + n["FFMA"] + n["FCHK"] \
        + sum(op == "MUFU.RCP" for _, op, _ in main)
    return (fp32 - zero_fadds) / n["FCHK"]


def time_ms(torch, fn, reps, flush=None, warm=2):
    """Median device time of ``fn()`` over ``reps`` runs after ``warm``
    warm-up runs; ``flush()`` (outside the timed region) evicts the L2
    cache."""
    for _ in range(warm):
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
    wall0 = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA GPU; none is available")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import mind_bag as bagcfg
    from repro_torch.configs import rpf_iss595 as isscfg
    from repro_torch.configs import rpf_mnist784 as cfgmod
    from repro_torch.core.distances import METRICS
    from repro_torch.core.knn import exact_knn
    from repro_torch.core.pipeline import candidates
    from repro_torch.core.quantized import quantize_db
    from repro_torch.core.search import mask_duplicates, recall_at_k
    from repro_torch.data.synthetic import iss_like, mnist_like
    from repro_torch.index import IndexSpec, SearchParams, build_index
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.chi2_topk import chi2_topk
    from repro_torch.kernels.common import LAUNCHES, REF_CALLS
    from repro_torch.kernels.distance_topk import distance_topk
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.forest_traverse import (forest_traverse,
                                                     smem_node_cap)
    from repro_torch.kernels.forest_traverse_hbm import forest_traverse_hbm
    from repro_torch.kernels.fused_query import fused_gather_topk
    from repro_torch.kernels.fused_query_int8 import fused_gather_topk_int8
    from repro_torch.kernels.matmul_topk import matmul_topk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    counters = (LAUNCHES, REF_CALLS)
    launches_by_path = {}

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

    # ---- main path: rpf ------------------------------------------------------
    db_np, _, q_np, _ = mnist_like(cfgmod.N_DB, n_test=cfgmod.QUERY_BATCH,
                                   d=cfgmod.DIM, seed=0)
    spec = IndexSpec(backend="rpf", forest=cfgmod.CONFIG, seed=0)
    queries = torch.from_numpy(q_np).to(dev)

    def drive_rpf():
        t0 = time.perf_counter()
        index = build_index(db_np, spec, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        return index, build_s, {
            (p, b): index.search(queries[:b], SearchParams(k=K, n_probes=p))
            for p in PROBES for b in BATCHES}

    (index, index_build_s, results), launches, ref_calls = counted(
        torch, counters, drive_rpf)
    require(launches, ref_calls, ("forest_traverse", "fused_gather_topk"),
            "rpf")
    launches_by_path["rpf"] = launches
    n_searches = len(results)
    db = index.engine.db
    forest = index.forest
    rc = spec.forest.resolved(db.shape[0])
    emit({"phase": "main", "rows": db.shape[0], "dim": db.shape[1],
          "trees": rc.n_trees, "max_depth": rc.max_depth,
          "max_nodes": rc.max_nodes, "nodes_used_max": int(forest.n_nodes.max()),
          "index_build_s": index_build_s, "searches": n_searches,
          "launches": launches, "ref_calls": ref_calls})

    worst = 0.0
    for (p, b), got in results.items():
        want = index.search(queries[:b], SearchParams(k=K + 1, n_probes=p,
                                                      mode="ref"))
        worst = max(worst, compare_topk(torch, got, want, K))
        check_scores(torch, METRICS["l2"], queries[:b], db, got)
    emit({"phase": "compare", "path": "rpf", "cases": len(results),
          "max_abs_err": worst})

    # ---- path: rpf+int8 --------------------------------------------------------
    spec8 = IndexSpec(backend="rpf+int8", forest=cfgmod.CONFIG, seed=0)

    def drive_int8():
        t0 = time.perf_counter()
        index8 = build_index(db_np, spec8, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        return index8, build_s, {
            (p, b): index8.search(queries[:b], SearchParams(
                k=K, n_probes=p, expand=EXPAND))
            for p in PROBES for b in BATCHES}

    (index8, int8_build_s, results8), launches, ref_calls = counted(
        torch, counters, drive_int8)
    require(launches, ref_calls, ("forest_traverse", "fused_gather_topk_int8",
                                  "fused_gather_topk"), "rpf+int8")
    launches_by_path["rpf+int8"] = launches
    qdb = index8.qdb
    emit({"phase": "int8", "index_build_s": int8_build_s,
          "searches": len(results8), "expand": EXPAND,
          "launches": launches, "ref_calls": ref_calls})

    def int8_plain(q, p):
        """The plain path of ``rerank_fused_quantized``, stage by stage,
        with stage 2 widened to K + 1 so the last rank's lower neighbour
        is known."""
        ids, mask = candidates(index8.forest, q, rc.max_depth, rc.leaf_pad,
                               p, mode="ref")
        ids = torch.where(mask_duplicates(ids, mask), ids, -1).int()
        kp = min(EXPAND * K, ids.shape[1])
        _, short = ref.fused_gather_topk_int8_ref(q, ids, qdb.q, qdb.scale,
                                                  kp)
        return ref.fused_gather_topk_ref(q, short, qdb.fp, K + 1)

    worst8 = 0.0
    for (p, b), got in results8.items():
        want = in_slabs(torch, lambda lo, hi: int8_plain(queries[lo:hi], p),
                        b)
        worst8 = max(worst8, compare_topk(torch, got, want, K))
        check_scores(torch, METRICS["l2"], queries[:b], db, got)
    emit({"phase": "compare", "path": "rpf+int8", "cases": len(results8),
          "max_abs_err": worst8})

    # ---- path: brute (kernel D, bruteforce backend, kernel E) --------------
    t0 = time.perf_counter()
    iss_np, _, iss_q_np, _ = iss_like(isscfg.N_DB, n_test=isscfg.QUERY_BATCH,
                                      d=isscfg.DIM, n_models=isscfg.N_MODELS,
                                      seed=1)
    iss_data_s = time.perf_counter() - t0
    iss_db = torch.from_numpy(iss_np).to(dev)
    iss_q = torch.from_numpy(iss_q_np).to(dev)

    def drive_brute():
        out = {m: ops.topk(queries, db, K, m) for m in ("l2", "dot")}
        bidx = build_index(db_np, IndexSpec(backend="bruteforce"),
                           device=dev)
        out["bruteforce"] = bidx.search(queries, SearchParams(k=K))
        out["chi2"] = ops.topk(iss_q, iss_db, K, "chi2")
        return bidx, out

    (bidx, brute), launches, ref_calls = counted(torch, counters, drive_brute)
    require(launches, ref_calls, ("matmul_topk", "fused_gather_topk",
                                  "chi2_topk"), "brute")
    launches_by_path["brute"] = launches
    emit({"phase": "brute", "mnist": list(db.shape),
          "iss595": list(iss_db.shape), "iss_data_s": iss_data_s,
          "launches": launches, "ref_calls": ref_calls})

    brute_err = {}
    for m in ("l2", "dot"):
        want = in_slabs(torch, lambda lo, hi: ref.matmul_topk_ref(
            queries[lo:hi], db, K + 1, m), queries.shape[0])
        brute_err[m] = compare_topk(
            torch, brute[m], want, K,
            tol=expansion_tol(torch, queries, db, want[1]))
    want = exact_knn(queries, db, K + 1)
    brute_err["l2_vs_exact_knn"] = compare_topk(
        torch, brute["l2"], want, K,
        tol=expansion_tol(torch, queries, db, want[1]))
    want = in_slabs(torch, lambda lo, hi: bidx.search(
        queries[lo:hi], SearchParams(k=K + 1, mode="ref")), queries.shape[0])
    brute_err["bruteforce"] = compare_topk(torch, brute["bruteforce"], want,
                                           K)
    check_scores(torch, METRICS["l2"], queries, db, brute["bruteforce"])
    want = in_slabs(torch, lambda lo, hi: ref.chi2_topk_ref(
        iss_q[lo:hi], iss_db, K + 1), iss_q.shape[0])
    brute_err["chi2"] = compare_topk(torch, brute["chi2"], want, K)
    check_scores(torch, METRICS["chi2"], iss_q, iss_db, brute["chi2"])
    emit({"phase": "compare", "path": "brute", "max_abs_err": brute_err,
          "tolerance": {"l2, dot": "1e-5 (|q|^2 + |c|^2) + 1e-6",
                        "bruteforce, chi2": f"rtol {RTOL}, atol {ATOL}"}})

    # ---- path: ISS-595 on rpf ----------------------------------------------
    spec_iss = IndexSpec(backend="rpf", forest=isscfg.CONFIG, seed=0)

    def drive_iss():
        t0 = time.perf_counter()
        idx = build_index(iss_np, spec_iss, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        return idx, build_s, {p: idx.search(iss_q, SearchParams(
            k=K, n_probes=p, metric="chi2")) for p in PROBES}

    (iss_index, iss_build_s, iss_res), launches, ref_calls = counted(
        torch, counters, drive_iss)
    require(launches, ref_calls, ("forest_traverse", "fused_gather_topk"),
            "iss595")
    launches_by_path["iss595"] = launches
    iss_rc = spec_iss.forest.resolved(iss_db.shape[0])
    emit({"phase": "iss595", "rows": iss_db.shape[0], "dim": iss_db.shape[1],
          "trees": iss_rc.n_trees, "max_depth": iss_rc.max_depth,
          "leaf_pad": iss_rc.leaf_pad,
          "nodes_used_max": int(iss_index.forest.n_nodes.max()),
          "index_build_s": iss_build_s, "launches": launches,
          "ref_calls": ref_calls})
    worst_iss = 0.0
    for p, got in iss_res.items():
        want = in_slabs(torch, lambda lo, hi: iss_index.search(
            iss_q[lo:hi], SearchParams(k=K + 1, n_probes=p, metric="chi2",
                                       mode="ref")), iss_q.shape[0])
        worst_iss = max(worst_iss, compare_topk(torch, got, want, K))
        check_scores(torch, METRICS["chi2"], iss_q, iss_db, got)
    emit({"phase": "compare", "path": "iss595", "cases": len(iss_res),
          "max_abs_err": worst_iss})

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

    def dedup_cand(frst, q, cfg, p):
        ids, mask = candidates(frst, q, cfg.max_depth, cfg.leaf_pad, p)
        return torch.where(mask_duplicates(ids, mask), ids, -1).int()

    cand = {p: dedup_cand(forest, queries, rc, p) for p in PROBES}
    iss_cand = dedup_cand(iss_index.forest, iss_q, iss_rc, 1)
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
            want = in_slabs(torch, lambda lo, hi: ref.fused_gather_topk_ref(
                q[lo:hi], ids[lo:hi], db, k + 1, metric), q.shape[0])
            fused_err = max(fused_err, compare_topk(torch, got, want, k))
            fused_cases += 1

    # kernel C: the int8 path's shapes (k' = 40 over M = 960 / 3840), one
    # and seven queries, 30% holes, k' = 512, d = 784 and 595, four metrics
    iss_qdb = quantize_db(iss_db)
    kp = EXPAND * K
    c_shapes = [(queries, qdb, cand[1], kp), (queries, qdb, cand[4], kp),
                (queries, qdb, cand[1][:1], kp), (queries, qdb, cand[1][:7], kp),
                (queries, qdb, holes[:7], kp), (queries, qdb, cand[4][:7], 512),
                (iss_q, iss_qdb, iss_cand[:7], kp),
                (iss_q, iss_qdb, iss_cand[:7], 512)]
    int8_cases, int8_err = 0, 0.0
    for metric in ("l2", "dot", "chi2", "cosine"):
        for qq, qd, ids, k in c_shapes:
            q = qq[:ids.shape[0]].contiguous()
            ids = ids.contiguous()
            got = fused_gather_topk_int8(q, ids, qd.q, qd.scale, k, metric)
            want = in_slabs(torch, lambda lo, hi: ref.fused_gather_topk_int8_ref(
                q[lo:hi], ids[lo:hi], qd.q, qd.scale, k + 1, metric),
                q.shape[0])
            int8_err = max(int8_err, compare_topk(torch, got, want, k))
            int8_cases += 1

    # kernels D and E: one and seven queries, k = 128, k > N (every slot
    # past N is +inf / -1), d = 784 and 595
    scan_cases, d_err, e_err = 0, 0.0, 0.0
    mnist_small, iss_small = db[:5].contiguous(), iss_db[:5].contiguous()
    for b, rows_l2, rows_chi2, k in [
            (1, db, iss_db, K), (7, db, iss_db, K), (7, db, iss_db, 128),
            (7, iss_db, db, K), (7, mnist_small, iss_small, K)]:
        for m in ("l2", "dot"):
            q = (queries if rows_l2.shape[1] == queries.shape[1]
                 else iss_q)[:b].contiguous()
            got = matmul_topk(q, rows_l2, k, m)
            want = ref.matmul_topk_ref(q, rows_l2, k + 1, m)
            d_err = max(d_err, compare_topk(
                torch, got, want, k,
                tol=expansion_tol(torch, q, rows_l2, want[1])))
            scan_cases += 1
        q = (iss_q if rows_chi2.shape[1] == iss_q.shape[1]
             else queries)[:b].contiguous()
        got = chi2_topk(q, rows_chi2, k)
        want = ref.chi2_topk_ref(q, rows_chi2, k + 1)
        e_err = max(e_err, compare_topk(torch, got, want, k))
        if rows_chi2.shape[0] < k:
            check(bool((got[1][:, rows_chi2.shape[0]:] == -1).all()),
                  "slots past N are not -1")
        scan_cases += 1
    # kernel E bitwise against the d-ordered plain sum: 64 queries x 4096
    # rows of ISS-595 at k = 10 and 128, x 4096 dense rows (raised by 2e-3,
    # every 7th element of every other row negated: no element is 0, so
    # the warps take E's copy of the loop for chunks with no zero) at k =
    # 10, and x 128 rows at k = 128 (every score returned).  Every row set
    # ends in three edge rows (every 0 a -0.0; negative elements; -1e-12
    # where query 0 is 0, so that term's denominator is 0 and query 0
    # scores the row +inf), and query 63 is an edge query (-0.0 and
    # negative elements)
    slab_q = iss_q[:64].clone()
    edge = iss_db[:3].clone()
    edge[0][edge[0] == 0] = -0.0
    edge[1, ::7] = -edge[1, ::7]
    edge[2, int(torch.nonzero(slab_q[0] == 0)[0])] = -1e-12
    slab_q[63, ::5] = -0.0
    slab_q[63, 1::11] = -slab_q[63, 1::11]
    dense_rows = iss_db[:4096] + 2e-3
    dense_rows[1::2, ::7] = -dense_rows[1::2, ::7]
    slabs = [(torch.cat([rows, edge]).contiguous(), k)
             for rows, k in ((iss_db[:4096], K), (iss_db[:4096], 128),
                             (dense_rows, K), (iss_db[:125], 128))]
    del dense_rows
    for slab_db, k in slabs:
        got = chi2_topk(slab_q, slab_db, k)
        want = ref.chi2_topk_dordered(slab_q, slab_db, k)
        check(torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)),
              f"kernel E is not bitwise the d-ordered sum ({slab_db.shape[0]} "
              f"rows, k = {k})")
        check(torch.equal(got[1], want[1]), "kernel E's ids differ from the "
              f"d-ordered sum's ({slab_db.shape[0]} rows, k = {k})")
        scan_cases += 1
    check(bool(torch.isinf(got[0][0]).any()), "the edge row's +inf is lost")
    torch.cuda.synchronize()
    emit({"phase": "kernels", "descent_cases": trav_cases,
          "descent_bitwise": True, "fused_cases": fused_cases,
          "fused_max_abs_err": fused_err, "int8_cases": int8_cases,
          "int8_max_abs_err": int8_err, "scan_cases": scan_cases,
          "matmul_max_abs_err": d_err, "chi2_max_abs_err": e_err,
          "chi2_dordered_slabs": [[64, r.shape[0], k] for r, k in slabs],
          "chi2_dordered_bitwise": True})

    # ---- shared by the timings below ----------------------------------------
    rate = mem_rate(card)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    def bound(nbytes, ops, op_rate=FP32_FLOPS):
        by_bytes, by_ops = nbytes / rate, ops / op_rate
        return {"bound_ms": max(by_bytes, by_ops) * 1e3, "bytes": nbytes,
                "operations": ops,
                "bound_by": "bytes" if by_bytes >= by_ops else "operations"}

    depth = node_depths(torch, child, rc.max_depth)

    # ---- path: tree (kernel F through ops.traverse_tree) ---------------------
    # every tree of the MNIST-784 forest, sliced to its used nodes (nodes are
    # allocated as a prefix, so the slice is the same tree)
    used = forest.n_nodes.tolist()
    trees = [(feat[t, :n], thresh[t, :n], child[t, :n])
             for t, n in enumerate(used)]
    cap = smem_node_cap(dev)
    check(max(used) <= cap, f"a used tree of {max(used)} nodes exceeds the "
          f"shared-memory cap of {cap}")

    def drive_tree():
        return {(t, p, b): ops.traverse_tree(*trees[t], queries[:b],
                                             rc.max_depth, n_probes=p,
                                             kernel="smem")
                for t in range(rc.n_trees) for p in PROBES for b in BATCHES}

    tree_res, launches, ref_calls = counted(torch, counters, drive_tree)
    require(launches, ref_calls, ("forest_traverse_smem",), "tree")
    check(set(launches) == {"forest_traverse_smem"},
          f"ops.traverse_tree(kernel='smem') launched {launches}")
    launches_by_path["tree"] = launches
    emit({"phase": "tree", "trees": rc.n_trees, "nodes_used_max": max(used),
          "smem_node_cap": cap, "calls": len(tree_res), "launches": launches,
          "ref_calls": ref_calls})
    a_leaves = {p: forest_traverse_hbm(feat, thresh, child, queries,
                                       rc.max_depth, p) for p in PROBES}
    tree_plain = {(t, p): ref.forest_traverse_tree_ref(
        *trees[t], queries, rc.max_depth, p)
        for t in range(rc.n_trees) for p in PROBES}
    for (t, p, b), got in tree_res.items():
        check(torch.equal(got, tree_plain[t, p][:b]),
              f"kernel F differs from its plain version: tree {t} P={p} B={b}")
        check(torch.equal(got, a_leaves[p][t, :b]),
              f"kernel F differs from kernel A: tree {t} P={p} B={b}")
    # above the cap "auto" must take kernel A and "smem" must raise
    iss_forest = iss_index.forest
    big = {"mnist784_unsliced": (feat[0], thresh[0], child[0], queries,
                                 rc.max_depth, a_leaves[4][0]),
           "iss595": (iss_forest.proj_idx[0, :, 0].contiguous(),
                      iss_forest.thresh[0], iss_forest.child_base[0], iss_q,
                      iss_rc.max_depth, None)}
    auto_launches = collections.Counter()
    for name, (f, th, cb, q, depth_cap, want) in big.items():
        check(f.shape[0] > cap, f"the {name} tree fits the cap")
        got, launches, ref_calls = counted(torch, counters, lambda: (
            ops.traverse_tree(f, th, cb, q, depth_cap, n_probes=4,
                              kernel="auto")))
        check(launches == {"forest_traverse": 1} and not ref_calls,
              f"kernel='auto' on {name} launched {launches}, plain "
              f"{ref_calls}")
        auto_launches.update(launches)
        if want is not None:
            check(torch.equal(got, want), "kernel='auto' differs from A")
        try:
            ops.traverse_tree(f, th, cb, q, depth_cap, kernel="smem")
        except ValueError:
            pass
        else:
            raise RuntimeError(f"check failed: kernel='smem' on {name} "
                               f"({f.shape[0]} nodes) did not raise")
    launches_by_path["tree_auto"] = dict(auto_launches)
    emit({"phase": "compare", "path": "tree", "cases": len(tree_res),
          "bitwise_vs_plain": True, "bitwise_vs_kernel_a": True,
          "auto_above_cap": dict(auto_launches), "smem_above_cap": "raised",
          "allocated_nodes": {n: int(v[0].shape[0]) for n, v in big.items()}})

    # F's time on the largest tree at B = 1024, beside kernel A on the same
    # tree: bytes are the tree once (12 B a node), one q coordinate per
    # (query, level reached) and the output
    t_big = max(range(rc.n_trees), key=lambda t: used[t])
    tf = trees[t_big]
    tf2 = tuple(a[None] for a in tf)
    tree_rows = []
    for p in PROBES:
        leaves = tree_plain[t_big, p].view(queries.shape[0], -1)
        ok = leaves >= 0
        levels = torch.where(ok, depth[t_big, leaves.clamp_min(0).long()], 0)
        nbytes = 12 * used[t_big] + 4 * int(levels.sum()) + 4 * leaves.numel()
        tree_rows.append({
            "n_probes": p, "tree": t_big, "nodes": used[t_big],
            "smem_bytes": 12 * used[t_big],
            "blocks": -(-queries.shape[0] // 128),
            "ms": time_ms(torch, lambda: forest_traverse(
                *tf, queries, rc.max_depth, p), 25, flush),
            "kernel_a_same_tree_ms": time_ms(torch, lambda: forest_traverse_hbm(
                *tf2, queries, rc.max_depth, p), 25, flush),
            "plain_ms": time_ms(torch, lambda: ref.forest_traverse_tree_ref(
                *tf, queries, rc.max_depth, p), 5, flush),
            **bound(nbytes, 0), "max_levels": int(levels.max())})
    del tree_res, tree_plain

    # ---- path: rerank (kernel G through ops.rerank_candidates) --------------
    def rerank_path():
        """The rpf path's own deduplicated candidates, gathered as db[ids]
        (20 GB in all, freed on return): drive, compare, time."""
        gathered = []
        for cell, metric, q, rows, ids in (
                ("rpf_mnist784 P=1", "l2", queries, db, cand[1]),
                ("rpf_mnist784 P=4", "l2", queries, db, cand[4]),
                ("rpf_iss595 P=1", "chi2", iss_q, iss_db, iss_cand)):
            ids = ids.contiguous()
            gathered.append((cell, metric, q, rows, ids, ids >= 0,
                             rows[ids.clamp_min(0).long()]))

        def drive():
            return [{b: ops.rerank_candidates(q[:b], c[:b], ids[:b],
                                              mask[:b], K, metric)
                     for b in BATCHES}
                    for _, metric, q, _, ids, mask, c in gathered]

        res, launches, ref_calls = counted(torch, counters, drive)
        require(launches, ref_calls, ("distance_topk",), "rerank")
        launches_by_path["rerank"] = launches
        emit({"phase": "rerank",
              "shapes": {g[0]: list(g[6].shape) for g in gathered},
              "gathered_gb": sum(g[6].numel() * 4 for g in gathered) / 1e9,
              "launches": launches, "ref_calls": ref_calls})
        err, vs_b_err, cases = 0.0, 0.0, 0
        for (_, metric, q, rows, ids, mask, c), per_b in zip(gathered, res):
            for b, got in per_b.items():
                want = in_slabs(torch, lambda lo, hi: ref.distance_topk_ref(
                    q[lo:hi], c[lo:hi], ids[lo:hi], mask[lo:hi], K + 1,
                    metric), b)
                err = max(err, compare_topk(torch, got, want, K))
                want_b = fused_gather_topk(q[:b].contiguous(), ids[:b], rows,
                                           K + 1, metric)
                vs_b_err = max(vs_b_err, compare_topk(torch, got, want_b, K))
                check_scores(torch, METRICS[metric], q[:b], rows, got)
                cases += 1
        # edges: an all-masked row with k > M, k = 128, and ties, whose ids
        # must come out smallest first
        _, _, _, _, ids1, mask1, c1 = gathered[0]
        mask7 = mask1[:7, :40].clone()
        mask7[3] = False
        for q, c, ids, mask, k in (
                (queries[:7], c1[:7, :40].contiguous(),
                 ids1[:7, :40].contiguous(), mask7, 64),
                (queries[:7], c1[:7], ids1[:7], mask1[:7], 128)):
            got = distance_topk(q, c, ids, mask, k, "l2")
            want = ref.distance_topk_ref(q, c, ids, mask, k + 1, "l2")
            err = max(err, compare_topk(torch, got, want, k))
            cases += 1
            if k == 64:
                check(bool(got[1][3].eq(-1).all())
                      and bool(got[0][3].isinf().all()),
                      "an all-masked row is not +inf / -1")
        tie_ids = torch.stack([torch.randperm(1000, generator=gen,
                                              device=dev)[:300]
                               for _ in range(2)]).int()
        tie = (torch.zeros((2, 784), device=dev),
               torch.ones((2, 300, 784), device=dev), tie_ids,
               torch.ones((2, 300), dtype=torch.bool, device=dev))
        got = distance_topk(*tie, K, "l2")
        want = ref.distance_topk_ref(*tie, K, "l2")
        check(torch.equal(got[1], want[1]) and torch.equal(
            got[1], torch.sort(tie_ids, dim=1).values[:, :K]),
            "tied slots do not come out smallest id first")
        cases += 1
        emit({"phase": "compare", "path": "rerank", "cases": cases,
              "max_abs_err": err, "vs_kernel_b_max_abs_err": vs_b_err,
              "ties": "smallest id first"})

        # G reads each valid slot's row once (a masked slot loads nothing),
        # the ids and the mask once: l2 3 operations per element, chi2
        # CHI2_ISSUES issues per term
        rows_out = []
        for cell, metric, q, rows, ids, mask, c in gathered:
            valid = int(mask.sum())
            b, m, d = c.shape
            nbytes = valid * d * 4 + b * m * 5 + q.numel() * 4 + b * K * 8
            ops_ = ((3 * valid * d, FP32_FLOPS) if metric == "l2" else
                    (CHI2_ISSUES * valid * d, FP32_FLOPS / 2))
            rows_out.append({
                "cell": cell, "metric": metric, "m": m, "valid_slots": valid,
                "ms": time_ms(torch, lambda: distance_topk(
                    q, c, ids, mask, K, metric), 25, flush),
                "kernel_b_same_ids_ms": time_ms(
                    torch, lambda: fused_gather_topk(q, ids, rows, K, metric),
                    25, flush),
                "plain_ms": time_ms(torch, lambda: in_slabs(
                    torch, lambda lo, hi: ref.distance_topk_ref(
                        q[lo:hi], c[lo:hi], ids[lo:hi], mask[lo:hi], K,
                        metric), b), 3, flush),
                **bound(nbytes, *ops_)})
        return err, rows_out

    g_err, rerank_rows = rerank_path()
    torch.cuda.empty_cache()

    # ---- path: bag (kernel H through ops.embedding_bag) ----------------------
    # the MIND history bag: 1M x 64 f32 table, H = 50, ragged histories of 1
    # to 50 items (the tail id 0, weight 0), B = 512 and 262,144
    bgen = torch.Generator(device=dev).manual_seed(2)
    hist = bagcfg.HIST_LEN
    table = torch.randn((bagcfg.ITEM_VOCAB, bagcfg.EMBED_DIM), generator=bgen,
                        device=dev)

    def bag_inputs(b, v=bagcfg.ITEM_VOCAB, h=hist):
        ids = torch.randint(0, v, (b, h), generator=bgen, device=dev,
                            dtype=torch.int32)
        w = torch.rand((b, h), generator=bgen, device=dev)
        tail = torch.arange(h, device=dev)[None, :] >= torch.randint(
            1, h + 1, (b, 1), generator=bgen, device=dev)
        return ids.masked_fill(tail, 0), w.masked_fill(tail, 0.0)

    bags = {name: bag_inputs(b) for name, b in bagcfg.BATCHES.items()}

    def drive_bag():
        return {name: ops.embedding_bag(ids, w, table)
                for name, (ids, w) in bags.items()}

    bag_res, launches, ref_calls = counted(torch, counters, drive_bag)
    require(launches, ref_calls, ("embedding_bag",), "bag")
    launches_by_path["bag"] = launches
    emit({"phase": "bag", "table": list(table.shape), "hist_len": hist,
          "batches": dict(bagcfg.BATCHES), "launches": launches,
          "ref_calls": ref_calls})

    def bag_err(got, ids, w, tab):
        """Largest |kernel - plain| with its tolerance 1e-5 sum |w row| +
        1e-6, in slabs; the NaN and inf pattern must agree."""
        worst = 0.0
        for lo in range(0, ids.shape[0], 32768):
            hi = lo + 32768
            want = ref.embedding_bag_ref(ids[lo:hi], w[lo:hi], tab)
            scale = ref.embedding_bag_ref(ids[lo:hi], w[lo:hi].abs(),
                                          tab.abs())
            g = got[lo:hi]
            check(torch.equal(g.isnan(), want.isnan())
                  and torch.equal(g.isinf(), want.isinf()),
                  "bag NaN / inf pattern differs")
            fin = want.isfinite()
            err = (g - want).abs()[fin]
            check(bool((err <= (RTOL * scale + ATOL)[fin]).all()),
                  f"bag error {float(err.max())}")
            worst = max(worst, float(err.max()) if err.numel() else 0.0)
        return worst

    # the launch shape (warps a bag, blocks) H's C entry takes for (B, H,
    # D), and an empty kernel on the same blocks: H's latency floor
    hlib = build.library("embedding_bag")
    hlib.embedding_bag_shape.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    hlib.embedding_bag_empty.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]

    def bag_shape(b, h, d):
        shape = (ctypes.c_int * 2)()
        build.check_launch(hlib.embedding_bag_shape(b, h, d, shape),
                           "embedding_bag_shape")
        return shape[0], shape[1]

    import torch.nn.functional as F
    h_err = max(bag_err(bag_res[n], *bags[n], table) for n in bags)
    lib_err = max(bag_err(F.embedding_bag(ids, table, per_sample_weights=w,
                                          mode="sum"), ids, w, table)
                  for ids, w in bags.values())
    # edges: one bag, seven bags, H = 1, 600 bags (2 warps a bag), D = 6
    # (the scalar branch) with a NaN in row 0 (every padded slot's 0 * NaN)
    # and an inf in row 5, and the same on a copy of the MIND table (16-byte
    # chunks, a bag split over warps that meet in shared memory)
    small = torch.randn((100, 6), generator=bgen, device=dev)
    small[0, 1], small[5, 2] = float("nan"), float("inf")
    special = table.clone()
    special[0, 1], special[5, 2] = float("nan"), float("inf")
    h_cases = {n: bag_shape(ids.shape[0], hist, table.shape[1])
               for n, (ids, _) in bags.items()}
    for tag, tab, b, h in (("1", table, 1, hist), ("7", table, 7, hist),
                           ("7_h1", table, 7, 1), ("600", table, 600, hist),
                           ("7_d6_nan", small, 7, 9),
                           ("300_d6_nan", small, 300, 50),
                           ("7_nan", special, 7, hist),
                           ("600_nan", special, 600, hist)):
        ids, w = bag_inputs(b, tab.shape[0], h)
        h_err = max(h_err, bag_err(embedding_bag(ids, w, tab), ids, w, tab))
        h_cases[tag] = bag_shape(b, h, tab.shape[1])
    del special
    check(any(wpb == 2 for wpb, _ in h_cases.values())
          and h_cases["7_nan"][0] > 1,
          f"bag cases miss a split launch shape: {h_cases}")
    emit({"phase": "compare", "path": "bag",
          "cases_warps_per_bag_blocks": h_cases,
          "max_abs_err": h_err, "library_max_abs_err": lib_err,
          "tolerance": f"{RTOL} sum_h |w row| + {ATOL}"})

    # H's bytes: each distinct row the bags touch once, ids and weights once,
    # the output once; 2 operations per element
    bag_rows = []
    for name, (ids, w) in bags.items():
        b = ids.shape[0]
        d = table.shape[1]
        distinct = int(torch.unique(ids).numel())
        wpb, blocks = h_cases[name]
        stream = torch.cuda.current_stream(dev).cuda_stream

        def empty():
            build.check_launch(hlib.embedding_bag_empty(b, hist, d, stream),
                               "embedding_bag_empty")

        empty()
        bag_rows.append({
            "cell": name, "batch": b, "distinct_rows": distinct,
            "gathered_bytes": b * hist * d * 4,
            "warps_per_bag": wpb, "blocks": blocks,
            "ms": time_ms(torch, lambda: embedding_bag(ids, w, table), 25,
                          flush),
            "latency_floor_ms": time_ms(torch, empty, 25, flush),
            "plain_ms": time_ms(torch, lambda: torch.cat([
                ref.embedding_bag_ref(ids[lo:lo + 32768], w[lo:lo + 32768],
                                      table)
                for lo in range(0, b, 32768)]), 3, flush),
            "library_ms": time_ms(torch, lambda: F.embedding_bag(
                ids, table, per_sample_weights=w, mode="sum"), 25, flush),
            **bound(distinct * d * 4 + b * hist * 8 + b * d * 4,
                    2 * b * hist * d)})
    del bag_res

    # ---- path: lsh (the lsh-cascade backend, kernel B) -----------------------
    lsh_spec = IndexSpec(backend="lsh-cascade", seed=0)

    def drive_lsh():
        t0 = time.perf_counter()
        idx = build_index(db_np, lsh_spec, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        return idx, build_s, {b: idx.search(queries[:b], SearchParams(k=K))
                              for b in BATCHES}

    (lsh_index, lsh_build_s, lsh_res), launches, ref_calls = counted(
        torch, counters, drive_lsh)
    require(launches, ref_calls, ("fused_gather_topk",), "lsh")
    launches_by_path["lsh"] = launches
    emit({"phase": "lsh", "radii": list(lsh_spec.lsh_radii),
          "tables": lsh_spec.lsh_tables, "bits": lsh_spec.lsh_bits,
          "index_build_s": lsh_build_s,
          "mean_candidates": lsh_index.last_mean_candidates,
          "launches": launches, "ref_calls": ref_calls})
    worst_lsh = 0.0
    for b, got in lsh_res.items():
        want = in_slabs(torch, lambda lo, hi: lsh_index.search(
            queries[lo:hi], SearchParams(k=K + 1, mode="ref")), b)
        worst_lsh = max(worst_lsh, compare_topk(torch, got, want, K))
        check_scores(torch, METRICS["l2"], queries[:b], db, got)
    emit({"phase": "compare", "path": "lsh", "cases": len(lsh_res),
          "max_abs_err": worst_lsh})

    # ---- timing, recall ----------------------------------------------------
    _, true_i = exact_knn(queries, db, K)
    cells = {}
    for name, idx, res in (("rpf", index, results),
                           ("rpf+int8", index8, results8)):
        cell = {}
        for p in PROBES:
            params = SearchParams(k=K, n_probes=p, expand=EXPAND)
            ms = time_ms(torch, lambda: idx.search(queries, params), 25)
            _, ids = res[p, cfgmod.QUERY_BATCH]
            cell[p] = {"ms_per_batch": ms,
                       "qps": cfgmod.QUERY_BATCH / ms * 1e3,
                       "recall_at_1": recall_at_k(ids[:, :1], true_i[:, :1]),
                       "recall_at_10": recall_at_k(ids, true_i)}
        check(cell[4]["recall_at_1"] >= cell[1]["recall_at_1"]
              and cell[4]["recall_at_10"] >= cell[1]["recall_at_10"],
              f"recall fell with more probes on {name}: {cell}")
        cells[name] = cell
    emit({"phase": "timing", "cell": "rpf_mnist784", "batch":
          cfgmod.QUERY_BATCH, "k": K, "card": smi, "n_probes": cells["rpf"]})
    emit({"phase": "timing", "cell": "rpf_mnist784 / rpf+int8",
          "batch": cfgmod.QUERY_BATCH, "k": K, "expand": EXPAND, "card": smi,
          "n_probes": cells["rpf+int8"]})

    e_ms = time_ms(torch, lambda: chi2_topk(iss_q, iss_db, K), 3, warm=1)
    _, exact_iss = brute["chi2"]
    iss_cell = {}
    for p in PROBES:
        params = SearchParams(k=K, n_probes=p, metric="chi2")
        ms = time_ms(torch, lambda: iss_index.search(iss_q, params), 10)
        iss_cell[p] = {"ms_per_batch": ms,
                       "qps": isscfg.QUERY_BATCH / ms * 1e3,
                       "recall_at_1": recall_at_k(iss_res[p][1][:, :1],
                                                  exact_iss[:, :1]),
                       "exact_scan_over_search": e_ms / ms}
    check(iss_cell[4]["recall_at_1"] >= iss_cell[1]["recall_at_1"],
          f"recall fell with more probes on iss595: {iss_cell}")
    emit({"phase": "timing", "cell": "rpf_iss595", "batch":
          isscfg.QUERY_BATCH, "k": K, "card": smi, "exact_scan_ms": e_ms,
          "n_probes": iss_cell})

    # the paper's comparison: lsh-cascade beside rpf at equal k, same run;
    # min_candidates 1 is the paper's cascade (stop at the first radius
    # with a match), 10 k a deeper probe of the same tables
    lsh_cell = {}
    for mc in (1, 10 * K):
        params = SearchParams(k=K, min_candidates=mc)
        ms = time_ms(torch, lambda: lsh_index.search(queries, params), 5,
                     warm=1)
        _, lsh_ids = lsh_index.search(queries, params)
        lsh_cell[mc] = {"ms_per_batch": ms,
                        "qps": cfgmod.QUERY_BATCH / ms * 1e3,
                        "recall_at_1": recall_at_k(lsh_ids[:, :1],
                                                   true_i[:, :1]),
                        "recall_at_10": recall_at_k(lsh_ids, true_i),
                        "mean_candidates": lsh_index.last_mean_candidates}
    emit({"phase": "timing", "cell": "rpf_mnist784 / lsh-cascade",
          "batch": cfgmod.QUERY_BATCH, "k": K, "card": smi,
          "index_build_s": lsh_build_s, "min_candidates": lsh_cell, "rpf": {
              p: dict(cells["rpf"][p], index_build_s=index_build_s)
              for p in PROBES}})

    # ---- where the time goes: device time by kernel over 5 searches -------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def breakdown(idx, q, params):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                idx.search(q, params)
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
        return {"wall_ms_per_search": wall_ms / 5,
                "device_ms_per_search": busy / 5,
                "device_idle_share": 1 - busy / wall_ms,
                "device_events": n_events,
                "kernels_ms_per_search": {n: t / 5 for n, t in top}}

    for cell, idx, q, kw in (
            ("rpf_mnist784", index, queries, {}),
            ("rpf_mnist784 / rpf+int8", index8, queries, {"expand": EXPAND}),
            ("rpf_iss595", iss_index, iss_q, {"metric": "chi2"})):
        emit({"phase": "profile", "cell": cell, "batch": q.shape[0],
              "card": smi, "n_probes": {p: breakdown(
                  idx, q, SearchParams(k=K, n_probes=p, **kw))
                  for p in PROBES}})
    emit({"phase": "profile", "cell": "rpf_mnist784 / lsh-cascade",
          "batch": queries.shape[0], "card": smi,
          "search": breakdown(lsh_index, queries, SearchParams(k=K))})

    # descent: bytes are 16 B per (tree, query, level reached) -- child_base,
    # feat, thresh, q[b, feat] -- plus the leaf's child_base and the output
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
    del c_feat, c_thresh, c_child

    # fused rerank: each valid slot reads its row once; ids, q, output once
    # (l2: 3 operations per element; chi2: CHI2_ISSUES issues per term)
    fused_rows = []
    iss_cand4 = dedup_cand(iss_index.forest, iss_q, iss_rc, 4)
    for cell, metric, q, rows, ids in (
            ("rpf_mnist784", "l2", queries, db, cand[1]),
            ("rpf_mnist784", "l2", queries, db, cand[4]),
            ("rpf_iss595", "chi2", iss_q, iss_db, iss_cand),
            ("rpf_iss595", "chi2", iss_q, iss_db, iss_cand4)):
        ids = ids.contiguous()
        valid = int((ids >= 0).sum())
        b, m = ids.shape
        d = rows.shape[1]
        nbytes = valid * d * 4 + b * m * 4 + q.numel() * 4 + b * K * 8
        ops_ = ((3 * valid * d, FP32_FLOPS) if metric == "l2" else
                (CHI2_ISSUES * valid * d, FP32_FLOPS / 2))
        fused_rows.append({
            "cell": cell, "metric": metric, "m": m, "valid_slots": valid,
            "ms": time_ms(torch, lambda: fused_gather_topk(
                q, ids, rows, K, metric), 25, flush),
            "plain_ms": time_ms(torch, lambda: in_slabs(
                torch, lambda lo, hi: ref.fused_gather_topk_ref(
                    q[lo:hi], ids[lo:hi], rows, K, metric), b, 256),
                5, flush),
            **bound(nbytes, *ops_)})
    # the bruteforce backend: kernel B at M = N.  Its bound reads each
    # input once; were no row reused between queries, every (query, row)
    # pair would read the row from memory
    bq_, bn_, bd_ = queries.shape[0], db.shape[0], db.shape[1]
    brute_row = {
        "search_ms": time_ms(torch, lambda: bidx.search(
            queries, SearchParams(k=K)), 3, flush, warm=1),
        "plain_ms": time_ms(torch, lambda: bidx.search(
            queries, SearchParams(k=K, mode="ref")), 1, flush, warm=1),
        **bound(bn_ * bd_ * 4 + bq_ * bn_ * 4 + bq_ * bd_ * 4 + bq_ * K * 8,
                3 * bq_ * bn_ * bd_),
        "no_reuse_ms": bq_ * bn_ * bd_ * 4 / rate * 1e3}

    # int8 rerank: each valid slot reads d + 4 bytes; dequantize, subtract,
    # multiply-add: 4 operations per element
    int8_rows = []
    for p in PROBES:
        ids = cand[p].contiguous()
        valid = int((ids >= 0).sum())
        b, m = ids.shape
        nbytes = valid * (db.shape[1] + 4) + b * m * 4 + queries.numel() * 4 \
            + b * kp * 8
        int8_rows.append({
            "m": m, "k_prime": kp, "valid_slots": valid,
            "ms": time_ms(torch, lambda: fused_gather_topk_int8(
                queries, ids, qdb.q, qdb.scale, kp, "l2"), 25, flush),
            "plain_ms": time_ms(torch, lambda: in_slabs(
                torch, lambda lo, hi: ref.fused_gather_topk_int8_ref(
                    queries[lo:hi], ids[lo:hi], qdb.q, qdb.scale, kp, "l2"),
                b, 256), 3, flush),
            **bound(nbytes, 4 * valid * db.shape[1])})

    # exact scans: each input read once; D does 2 B N d flops
    d_row = {
        "ms": time_ms(torch, lambda: matmul_topk(queries, db, K, "l2"), 10,
                      flush),
        "dot_ms": time_ms(torch, lambda: matmul_topk(queries, db, K, "dot"),
                          10, flush),
        "plain_ms": time_ms(torch, lambda: ref.matmul_topk_ref(
            queries, db, K, "l2"), 3, flush),
        "cublas_fp32_product_ms": time_ms(torch, lambda: queries @ db.T, 10,
                                          flush),
        **bound((bq_ + bn_) * (bd_ + 1) * 4 + bq_ * K * 8,
                2 * bq_ * bn_ * bd_)}
    ib, in_, id_ = iss_q.shape[0], iss_db.shape[0], iss_db.shape[1]
    # the share of terms whose q and c are both 0 (0 / 1e-12: the IEEE
    # division's slow path)
    # and of db elements that are 0 (kernel E's one-FADD case), and E's time
    # on the same shapes with the queries raised by 1e-3 and the rows by
    # 2e-3, so that no element is 0 (dense data).  E's bound (also
    # ``work_bound_ms``) counts the work this data needs (1 issue a term
    # whose row element is 0, CHI2_ISSUES for the others); the dense one
    # (CHI2_ISSUES every term, the bound of E's earlier row-lane layout)
    # stands beside it
    zero_terms = float(((iss_q == 0).sum(0).double()
                        * (iss_db == 0).sum(0).double()).sum())
    db_zeros = int((iss_db == 0).sum())
    iss_q_d, iss_db_d = iss_q + 1e-3, iss_db + 2e-3
    dense_ms = time_ms(torch, lambda: chi2_topk(iss_q_d, iss_db_d, K), 3,
                       warm=1)
    del iss_q_d, iss_db_d
    e_bytes = (ib + in_) * id_ * 4 + ib * K * 8
    e_work = bound(e_bytes,
                   ib * (db_zeros + CHI2_ISSUES * (in_ * id_ - db_zeros)),
                   FP32_FLOPS / 2)
    e_row = {
        "ms": e_ms,
        "zero_term_share": zero_terms / (ib * in_ * id_),
        "db_zero_share": db_zeros / (in_ * id_),
        "work_bound_ms": e_work["bound_ms"],
        "dense_bound_ms": bound(e_bytes, CHI2_ISSUES * ib * in_ * id_,
                                FP32_FLOPS / 2)["bound_ms"],
        "ms_no_zero_numerator": dense_ms,
        "sass_fp32_issues_per_nonzero_term": sass_per_chi2_term(
            build.library_path("chi2_topk")),
        "plain_ms": time_ms(torch, lambda: ref.chi2_topk_ref(
            iss_q, iss_db, K), 1, warm=0),
        "terms": ib * in_ * id_, "issues_per_nonzero_term": CHI2_ISSUES,
        **e_work}
    torch.cuda.synchronize()
    emit({"phase": "done", "wall_s": time.perf_counter() - wall0})

    def total(name):
        return sum(v.get(name, 0) for v in launches_by_path.values())

    def by_path(name):
        return {k: v[name] for k, v in launches_by_path.items() if name in v}

    t1, f1, c1 = trav_rows[0], fused_rows[0], int8_rows[0]
    tf1, g1, h1 = tree_rows[0], rerank_rows[0], bag_rows[-1]
    per_search = {n: launches_by_path["rpf"][n] / n_searches
                  for n in launches_by_path["rpf"]}
    emit({"kernels": [
        {"name": "forest_traverse", "route": "cuda",
         "source": "src/repro_torch/csrc/forest_traverse.cu",
         "replaces": "src/repro/kernels/forest_traverse_hbm.py:158",
         "launches": total("forest_traverse"),
         "launches_by_path": by_path("forest_traverse"),
         "launches_per_search": per_search["forest_traverse"],
         "max_abs_err": 0.0, "ms": t1["ms"], "plain_ms": t1["plain_ms"],
         "bound_ms": t1["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "latency_per_level_us": per_level_us,
         "latency_floor_ms": per_level_us * t1["max_levels"] / 1e3,
         "shapes": trav_rows},
        {"name": "fused_gather_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_query.cu",
         "replaces": "src/repro/kernels/fused_query.py:146",
         "launches": total("fused_gather_topk"),
         "launches_by_path": by_path("fused_gather_topk"),
         "launches_per_search": per_search["fused_gather_topk"],
         "max_abs_err": fused_err, "ms": f1["ms"], "plain_ms": f1["plain_ms"],
         "bound_ms": f1["bound_ms"], "bound_by": f1["bound_by"],
         "library_ms": None, "shapes": fused_rows,
         "bruteforce": brute_row},
        {"name": "fused_gather_topk_int8", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_query_int8.cu",
         "replaces": "src/repro/kernels/fused_query_int8.py:152",
         "launches": total("fused_gather_topk_int8"),
         "launches_by_path": by_path("fused_gather_topk_int8"),
         "max_abs_err": int8_err, "ms": c1["ms"], "plain_ms": c1["plain_ms"],
         "bound_ms": c1["bound_ms"], "bound_by": c1["bound_by"],
         "library_ms": None, "shapes": int8_rows},
        {"name": "matmul_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/scan_topk.cu",
         "replaces": "src/repro/kernels/matmul_topk.py:79",
         "launches": total("matmul_topk"),
         "launches_by_path": by_path("matmul_topk"),
         "max_abs_err": max(d_err, brute_err["l2"], brute_err["dot"]),
         **d_row, "library_ms": None},
        {"name": "chi2_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/chi2_topk.cu",
         "replaces": "src/repro/kernels/chi2_topk.py:69",
         "launches": total("chi2_topk"),
         "launches_by_path": by_path("chi2_topk"),
         "max_abs_err": max(e_err, brute_err["chi2"]), **e_row,
         "library_ms": None},
        {"name": "forest_traverse_smem", "route": "cuda",
         "source": "src/repro_torch/csrc/forest_traverse_smem.cu",
         "replaces": "src/repro/kernels/forest_traverse.py:118",
         "launches": total("forest_traverse_smem"),
         "launches_by_path": by_path("forest_traverse_smem"),
         "max_abs_err": 0.0, "ms": tf1["ms"], "plain_ms": tf1["plain_ms"],
         "bound_ms": tf1["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "latency_floor_ms": per_level_us * tf1["max_levels"] / 1e3,
         "shapes": tree_rows},
        {"name": "distance_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/distance_topk.cu",
         "replaces": "src/repro/kernels/distance_topk.py:73",
         "launches": total("distance_topk"),
         "launches_by_path": by_path("distance_topk"),
         "max_abs_err": g_err, "ms": g1["ms"], "plain_ms": g1["plain_ms"],
         "bound_ms": g1["bound_ms"], "bound_by": g1["bound_by"],
         "library_ms": None, "shapes": rerank_rows},
        {"name": "embedding_bag", "route": "cuda",
         "source": "src/repro_torch/csrc/embedding_bag.cu",
         "replaces": "src/repro/kernels/embedding_bag.py:54",
         "launches": total("embedding_bag"),
         "launches_by_path": by_path("embedding_bag"),
         "max_abs_err": h_err, "ms": h1["ms"], "plain_ms": h1["plain_ms"],
         "bound_ms": h1["bound_ms"], "bound_by": h1["bound_by"],
         "library_ms": h1["library_ms"],
         "latency_floor_ms": h1["latency_floor_ms"],
         "library": "torch.nn.functional.embedding_bag(mode='sum', "
                    "per_sample_weights=w)", "shapes": bag_rows},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
