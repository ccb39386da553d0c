"""Roofline terms from the dry run's records (port of
``repro/roofline.py``).

NVIDIA H100 SXM constants (a card):
  peak dense bf16 compute:  989 TFLOP/s
  peak fp32 compute:         67 TFLOP/s (TF32 off, as the port's products
                                         run)
  HBM3 bandwidth:          3.35 TB/s
  HBM3 capacity:             80 GB
  NVLink (per direction):   450 GB/s, between the 8 cards of a node
  NDR InfiniBand:            50 GB/s a card (400 Gb/s), between nodes

The production meshes are 256 and 512 cards of 8-card nodes: (data=16,
model=16) and (pod=2, data=16, model=16), rank r at the row-major
coordinate r, so a node holds 8 consecutive ranks, half of one ``model``
row.  Both axes of 16 (and ``pod``) then cross nodes, and a collective
over any of them runs at the inter-node rate: the collective term of a
mesh record uses ``INTERNODE_BW``, of a record on one node (at most 8
devices) ``NVLINK_BW``.

Terms (seconds; ``launch/dryrun.py`` counts the whole step, on a mesh
what its rank 0 runs):
  compute_s    = counted flops / the peak of the cell's ``compute_dtype``
  memory_s     = (argument + output bytes) / HBM bandwidth: the least
                 traffic of the step's inputs and outputs (the
                 temporaries' traffic is not counted).
  fits_hbm     = a mesh record's ``peak_bytes`` (the arguments and the
                 most storage live at once, ``dryrun.RankCounter``) under
                 80 GB; a one-card record has no peak, and only its
                 arguments are held against 80 GB.  On the card
                 ``torch.cuda.max_memory_allocated`` measures the peak.
  collective_s = collective bytes (the results of a rank's collectives,
                 as the reference's ``collective_bytes`` counts them) /
                 the interconnect's rate (0 on one card, which has none)

MODEL_FLOPS is the analytic useful work of ``launch/steps`` meta, and
MODEL_BYTES (``analytic_model_bytes``) its least traffic, both of the
whole step: ideal_time = max(MODEL_FLOPS / (n_devices x peak),
MODEL_BYTES / (n_devices x HBM)), each card's share of the step;
model_flops_ratio = MODEL_FLOPS / (counted flops x n_devices) catches
recomputation and padded work (remat, full-square attention, an MoE's
cap + 1 slots) and, on a mesh, work repeated on replicas;
roofline_fraction = ideal_time / bound, where bound = max(three terms).
The dry run counts every executed op, loops included, so the reference's
scan-versus-unroll caveat has no counterpart: ``merged_table`` gives one
row a record, of the mesh it is asked for ("card", "single" or
"multipod").
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os

from repro_torch.configs import get_arch
from repro_torch.configs.base import LMConfig, MACEConfig, RecsysConfig
from repro_torch.launch import steps

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12
HBM_BYTES = 80e9
NVLINK_BW = 450e9
INTERNODE_BW = 50e9
NODE_CARDS = 8

ARTIFACT_DIR = os.path.abspath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "../../artifacts/dryrun_torch"))


def load_artifacts(directory: str = ARTIFACT_DIR) -> dict:
    out = {}
    for path in glob.glob(os.path.join(directory, "*.json")):
        with open(path) as f:
            r = json.load(f)
        key = (r["arch"], r["cell"], r["mesh"], r.get("variant", "base"))
        out[key] = r
    return out


def _cut(arch: str, cell_name: str, variant: str):
    """(config, cell) after ``variant``'s keys: an LM's ``nl`` and the
    reference's other keys, and ``batch=N``; a recommender's ``rows`` and
    ``cand=N``; MACE's ``nodes=N``."""
    spec = get_arch(arch)
    cfg = spec.config
    cell = {c.name: c for c in spec.cells}[cell_name]
    if variant == "base":
        return cfg, cell
    if spec.family == "lm":
        rest, batch = steps._lm_batch_variant(variant)
        cfg = steps._apply_lm_variant(cfg, rest)
        if batch:
            cell = dataclasses.replace(cell, global_batch=batch)
    elif spec.family == "recsys":
        cfg, _, n_cand = steps._recsys_variant(cfg, variant)
        cell = dataclasses.replace(
            cell, n_candidates=min(cell.n_candidates, n_cand))
    elif spec.family == "gnn":
        cfg, nodes, _ = steps._gnn_variant(cfg, cell, variant)
        if nodes:
            cell = dataclasses.replace(
                cell, n_nodes=nodes,
                n_edges=cell.n_edges * nodes // cell.n_nodes)
    return cfg, cell


def analytic_model_bytes(arch: str, cell_name: str, kind: str,
                         variant: str = "base") -> int:
    """Analytic minimum HBM bytes for the step: the data that MUST move --
    params/optimizer traffic for training, active params + KV cache for
    decode, catalog rows for retrieval, edge/node features for GNNs.  Used
    for the memory side of the ideal-time floor.  ``variant``'s cuts give
    the cut cell's own floor; at "base" this is the reference's."""
    cfg, cell = _cut(arch, cell_name, variant)
    if isinstance(cfg, LMConfig):
        pb = 2 if cfg.param_dtype == "bfloat16" else 4
        params_b = cfg.param_count() * pb
        act_b = 2 if cfg.compute_dtype == "bfloat16" else 4
        if kind == "train":
            # fwd read + bwd read + grad write + optimizer read/write (~2
            # moments) + stored layer activations (write + read)
            acts = (cell.global_batch * cell.seq_len * cfg.d_model
                    * cfg.n_layers * act_b * 2)
            return 6 * params_b + acts
        cache_b = (cfg.n_layers * cell.global_batch * cell.seq_len
                   * cfg.n_kv_heads * cfg.head_dim * 2 * 2)
        if kind == "prefill":
            return 2 * params_b + cache_b            # params + cache write
        # decode: active params once + the visible cache read
        active_b = params_b
        if cfg.moe:
            # only routed-active experts are read
            active_b = steps._lm_meta(cfg, cell, 1,
                                      "decode")["params_active"] * pb
        vis = sum(min(w, cell.seq_len) if w else cell.seq_len
                  for w in cfg.layer_windows)
        cache_read = (cell.global_batch * vis * cfg.n_kv_heads
                      * cfg.head_dim * 2 * 2)
        return active_b + cache_read
    if isinstance(cfg, MACEConfig):
        # per-edge messages (write+read) dominate
        n_edges = cell.n_edges or (cell.batch_nodes or 0) * 165
        if cell.name == "molecule":
            n_edges = cell.n_edges * cell.n_graphs
        if cell.name == "minibatch_lg":
            n_edges = cell.batch_nodes * 165
        c = cfg.d_hidden
        return int(n_edges) * c * 9 * 4 * 2 * cfg.n_layers * 3
    if isinstance(cfg, RecsysConfig):
        d = cfg.embed_dim
        if kind == "retrieval":
            return cell.n_candidates * d * 4         # scan the catalog once
        rows = cfg.n_sparse if cfg.model != "mind" else cfg.hist_len
        return cell.batch * rows * d * 4 * (3 if kind == "train" else 1)
    return 0


def roofline_terms(record: dict) -> dict:
    """Three terms + bottleneck + model-flops ratio for one record.  The
    cell's ``kind`` (``retrieval`` too, where the meta says ``serve``)
    picks its analytic bytes."""
    flops = record["cost"]["flops"]
    mem = record["memory"]
    n_dev = record.get("n_devices", 1)
    peak = PEAK_FLOPS[record.get("compute_dtype", "float32")]
    compute_s = flops / peak
    memory_s = (mem["argument_bytes"] + mem["output_bytes"]) / HBM_BW
    link = NVLINK_BW if n_dev <= NODE_CARDS else INTERNODE_BW
    collective_s = record["collectives"]["total_bytes"] / link
    bound = max(compute_s, memory_s, collective_s, 1e-12)
    dominant = max(
        (("compute", compute_s), ("memory", memory_s),
         ("collective", collective_s)), key=lambda kv: kv[1])[0]
    model_flops = record["meta"].get("model_flops", 0)
    model_bytes = analytic_model_bytes(
        record["arch"], record["cell"],
        record.get("kind", record["meta"].get("kind", "")),
        record.get("variant", "base"))
    ideal_s = max(model_flops / (n_dev * peak),
                  model_bytes / (n_dev * HBM_BW))
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "bound_s": bound,
        "model_flops": model_flops,
        "model_bytes": model_bytes,
        "ideal_s": ideal_s,
        "counted_flops": flops,
        "model_flops_ratio": (model_flops / (flops * n_dev)
                              if flops else 0.0),
        "roofline_fraction": ideal_s / bound if bound else 0.0,
        "argument_gib": mem["argument_bytes"] / 2**30,
        "collective_gib": record["collectives"]["total_bytes"] / 2**30,
        "n_devices": n_dev,
        # a mesh record's live peak (``dryrun.RankCounter``), else only
        # the arguments
        "peak_gib": mem.get("peak_bytes", mem["argument_bytes"]) / 2**30,
        "fits_hbm": mem.get("peak_bytes", mem["argument_bytes"])
        < HBM_BYTES,
    }


def merged_table(directory: str = ARTIFACT_DIR,
                 mesh: str = "card") -> list[dict]:
    """One row per (arch, cell, variant) record of ``mesh``."""
    rows = []
    for (arch, cell, m, variant), rec in sorted(
            load_artifacts(directory).items()):
        if m != mesh:
            continue
        t = roofline_terms(rec)
        t["arch"], t["cell"], t["mesh"], t["variant"] = (arch, cell, m,
                                                         variant)
        rows.append(t)
    return rows


def format_table(rows: list[dict]) -> str:
    hdr = (f"{'arch':<26} {'cell':<14} {'variant':<22} {'compute':>10} "
           f"{'memory':>10} {'collect':>10} {'ideal':>10} {'dom':>10} "
           f"{'MF-ratio':>8} {'RL-frac':>8} {'args':>9} {'fits':>5}")
    lines = [hdr, "-" * len(hdr)]
    for t in rows:
        lines.append(
            f"{t['arch']:<26} {t['cell']:<14} {t['variant']:<22} "
            f"{t['compute_s'] * 1e3:9.3f}m {t['memory_s'] * 1e3:9.3f}m "
            f"{t['collective_s'] * 1e3:9.3f}m "
            f"{t['ideal_s'] * 1e3:9.3f}m {t['dominant']:>10} "
            f"{t['model_flops_ratio']:8.3f} {t['roofline_fraction']:8.3f} "
            f"{t['argument_gib']:8.2f}G {str(t['fits_hbm']):>5}")
    return "\n".join(lines)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--dir", default=ARTIFACT_DIR)
    p.add_argument("--mesh", default="all",
                   choices=("card", "single", "multipod", "all"))
    args = p.parse_args(argv)
    for mesh in (("card", "single", "multipod") if args.mesh == "all"
                 else (args.mesh,)):
        rows = merged_table(args.dir, mesh)
        if rows:
            print(f"== {mesh}")
            print(format_table(rows))


if __name__ == "__main__":
    main()
