"""Quickstart on the PyTorch port: the unified index API over every backend
(the port of ``examples/quickstart.py``).

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu] [--tiny] [--target-recall R]

The paper through the one public surface (``repro_torch.index``): build an
``IndexSpec``, search with ``SearchParams``, watch recall rise with L at a
small search cost; let the recall-targeted tuner pick the cheapest
operating point on one half of the queries and measure it on the other;
compose the int8 shortlist and early-exit waves with the same call; mutate
the index (add, delete, upsert, compact) with its answers asserted; and
search under the chi-square metric.  ``--tiny`` shrinks the corpus.  It
runs on the GPU unless ``--device cpu``, and raises without one.
"""
import argparse

import numpy as np
import torch

from repro_torch.core.forest import ForestConfig
from repro_torch.core.knn import exact_knn
from repro_torch.core.search import recall_at_k
from repro_torch.data.synthetic import mnist_like
from repro_torch.index import IndexSpec, SearchParams, build_index, tune


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu for the plain PyTorch versions")
    ap.add_argument("--tiny", action="store_true",
                    help="a small corpus (seconds, not minutes)")
    ap.add_argument("--target-recall", type=float, default=0.9,
                    help="recall@1 goal handed to repro_torch.index.tune")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "plain PyTorch versions")
    torch.backends.cuda.matmul.allow_tf32 = False   # exact_knn's fp32
    out = {}

    n, n_test = (2_000, 128) if args.tiny else (20_000, 256)
    print(f"generating MNIST-statistics data (offline stand-in, n={n})...")
    db, _, queries, _ = mnist_like(n=n, n_test=n_test)
    q = torch.from_numpy(queries).to(dev)

    print("exact ground truth (the bruteforce backend is the same oracle)...")
    _, true_ids = exact_knn(q, torch.from_numpy(db).to(dev), k=1)

    # ---- one spec per operating point; one search call for all of them ----
    out["recall_by_trees"] = {}
    for n_trees in (5, 20) if args.tiny else (5, 20, 80):
        cfg = ForestConfig(n_trees=n_trees, capacity=12, split_ratio=0.3)
        index = build_index(db, IndexSpec(backend="rpf", forest=cfg, seed=0),
                            device=dev)
        _, ids = index.search(q, SearchParams(k=1))
        rec = recall_at_k(ids, true_ids)
        frac = n_trees * cfg.resolved(n).leaf_pad / n
        out["recall_by_trees"][n_trees] = rec
        print(f"L={n_trees:3d} trees: recall@1 = {rec:.3f}, "
              f"<= {frac * 100:.2f}% of the DB touched per query")

    # ---- or skip the hand-tuning: state a recall target ------------------
    # tune() measures recall against a brute-force oracle on a query
    # sample, walks the probes-vs-trees frontier and keeps the cheapest
    # SearchParams meeting the target as the index default; tuned on the
    # first half of the queries, measured on the held-out second half
    index = build_index(db, IndexSpec(
        backend="rpf", forest=ForestConfig(n_trees=20 if args.tiny else 40,
                                           capacity=12), seed=0), device=dev)
    half = q.shape[0] // 2
    tuned = tune(index, q[:half], target_recall=args.target_recall, k=1)
    _, ids_t = index.search(q[half:])      # tuned params now the default
    out["tuned"] = {"recall": recall_at_k(ids_t, true_ids[half:]),
                    "n_trees": tuned.n_trees or index.spec.forest.n_trees,
                    "n_probes": tuned.n_probes}
    print(f"tuned for recall@1 >= {args.target_recall}: held-out measured "
          f"{out['tuned']['recall']:.3f} with "
          f"n_trees={out['tuned']['n_trees']}, n_probes={tuned.n_probes} "
          f"(persisted: save/load keeps this operating point)")

    # ---- every query-time knob composes with every backend ---------------
    cfg = ForestConfig(n_trees=20 if args.tiny else 40, capacity=12)
    index8 = build_index(db, IndexSpec(backend="rpf+int8", forest=cfg,
                                       seed=0), device=dev)
    _, ids8 = index8.search(q, SearchParams(k=1, expand=4))
    _, ids8w = index8.search(q, SearchParams(k=1, expand=4, adaptive_wave=5,
                                             tol=0.01))
    out["int8_recall"] = recall_at_k(ids8, true_ids)
    out["int8_waves_recall"] = recall_at_k(ids8w, true_ids)
    out["int8_waves_trees_used"] = index8.last_trees_used
    print(f"rpf+int8: recall@1 = {out['int8_recall']:.3f} "
          f"(4x less candidate HBM traffic)")
    print(f"rpf+int8 + early-exit waves: recall@1 = "
          f"{out['int8_waves_recall']:.3f} using "
          f"{index8.last_trees_used}/{cfg.n_trees} trees")

    # ---- mutating an index: add / delete / upsert / compact --------------
    # adds land in a delta buffer, deletes are tombstones masked inside the
    # fused rerank, compact() rebuilds the live set off the writer lock
    index = build_index(db, IndexSpec(
        backend="rpf", forest=ForestConfig(n_trees=20, capacity=12), seed=0),
        device=dev)
    novel = (0.5 * (db[0] + db[1])).astype(np.float32)
    gid = index.add(novel)                      # queryable immediately
    _, ids = index.search(novel[None], SearchParams(k=1))
    assert int(ids[0, 0]) == gid
    index.delete([0, 1])                        # gone from results at once
    index.upsert(2, novel * 0.9)                # replace id 2's vector
    _, ids = index.search(novel[None], SearchParams(k=3))
    assert not np.isin(ids.cpu().numpy(), [0, 1]).any()
    st = index.stats()
    out["mutated"] = {k: st[k] for k in ("n_live", "n_tombstones",
                                         "n_segments")}
    print(f"mutated: {st['n_live']} live rows, {st['n_tombstones']} "
          f"tombstones, {st['n_segments']} segment(s)")
    index.compact()                             # explicit rebuild (off-lock)
    out["compacted"] = {k: index.stats()[k]
                        for k in ("n_live", "n_tombstones", "n_segments")}
    print("compacted:", out["compacted"])

    # ---- k-NN with the chi-square metric (the paper's ISS experiment) ----
    db_h = np.abs(db)
    index_h = build_index(db_h, IndexSpec(
        backend="rpf", forest=ForestConfig(n_trees=20, capacity=12), seed=1),
        device=dev)
    d, ids = index_h.search(db_h[:8], SearchParams(k=3, metric="chi2"))
    out["chi2_ids"] = ids.cpu().numpy()
    print("chi2 3-NN of first db point:", out["chi2_ids"][0],
          "dists", np.round(d[0].cpu().numpy(), 5))
    return out


if __name__ == "__main__":
    main()
