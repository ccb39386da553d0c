#!/usr/bin/env python3
"""Split the time of kernels A, B, C and D on one GPU, variant by variant.

    python3 chip_split.py [--kernels ABCD] [PARENT_CSRC]   # from the repo root

Builds variants of the kernels' sources, each with one part changed,
compiled out or given other compile-time settings, and times each beside
the kernel as it is, at the main path's shapes.  With PARENT_CSRC, a
directory that holds earlier versions of the sources (and the headers they
include), the same for those.  ``--kernels`` picks which kernels run.

Kernel A (``forest_traverse.cu`` + ``descent.cuh``) on the 1024 MNIST-784
queries through the ``rpf`` forest (80 trees) and the 1024 ISS-595
queries through theirs (160 trees), at 1 and 4 probes, with the L2 warm
and flushed before each run; every variant's leaves are checked against
the plain version (bitwise), and on edge inputs (a forest and queries
on one grid of 1/8, so that margins tie and q[feat] == thresh; NaN, +inf
and -inf query elements) at 1, 3, 4, 8 and 9 probes.  Variants of an
earlier descent (one thread a (tree, query), its margins in a per-thread
array, alternates from the root):

  loads together   a level's child_base, feat and thresh loaded before the
                   leaf test
  no margins       the margin array neither written nor filled (1 probe)
  from flip        each alternate starts at its flip (the path's nodes kept
                   in a second per-thread array)

and of the current one: 128 to 1024 queries a block at every P, and one
16-byte record a node (feat, thresh, child_base) read from a packed copy
of the forest.  Also ``csrc/pointer_chase.cu``: the latency of one
dependent load, warm (L2) and flushed.

Kernel B (``fused_query.cu``) on stage 2 of ``rpf+int8`` (M = 40: kernel
C's shortlists at 1 and 4 probes), on the first 64, 96, 128 and 256 slots
of the ``rpf`` path's candidates and on all of them (M = 960 / 3840),
under l2; every variant but "merge out" must equal the earlier source's
output bit for bit.  Variants: the earlier source as it is, with its
survivor test and merge compiled out, and with one warp a query (THREADS
= TILE = 32); the current one as it is, at GROUP = 4, and with its
small-M path up to M = 256.

Kernels D (``scan_topk.cu``) and C (``fused_query_int8.cu``):

  D merge out   the top-k merge compiled out, the sums kept live
  D phases      the kernel as it is with clock64 counts (block thread 0):
                cycles a row tile in the step loop, the test and the merge,
                and the merges of each slice's first tile (all 128 rows
                survive there) over all row tiles (current source only)
  C merge out   the survivor test and the merge compiled out
  C constant    the int8 -> f32 conversion replaced by 1, the row loads
                kept live (earlier source only)
  C d = 768     rows and queries cut to 768 columns
  C SASS        the conversion instructions of the l2 kernel (cuobjdump)

and cuBLAS's bare fp32 ``q @ db.T``.  One JSON line each, after the card's
name and power limit; the patches fail loudly where a source has changed.
"""
import collections
import ctypes
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "build" / "split"


def emit(obj):
    print(json.dumps(obj), flush=True)


def cut(src, start, end, insert=""):
    """``src`` with [start, end) replaced by ``insert``; both markers must
    be present."""
    a = src.index(start)
    return src[:a] + insert + src[src.index(end, a):]


def sub(src, old, new):
    if old not in src:
        raise ValueError(f"marker not found: {old[:60]!r}")
    return src.replace(old, new)


D_SINK = """    {
      float sink = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sink += acc[i][j];
      if (sink == 12345.678f) part_d[0] = sink;
    }
"""


def d_merge_out(src):
    if "merge_query(" in src:         # the current kernel
        return cut(src, "    // ---- warp w merges the survivors",
                   "    __syncthreads();  // tile_s is the next tile's")
    return cut(src, "    // ---- warp w merges the tile's scores",  # earlier
               "  __syncthreads();\n\n  for (int t = tid; t < BQ * k;",
               D_SINK.replace("j < 8", "j < 4").replace("i < 8", "i < 4")
               + "  }\n")


def d_phases(src):
    src = sub(src, "enum Metric { L2 = 0, DOT = 1 };", """enum Metric { L2 = 0, DOT = 1 };
// steps, test, merge, the merge of a slice's first tile, row tiles
__device__ unsigned long long phase_cycles[5];
extern "C" int phase_io(void* out, int reset) {
  unsigned long long z[5] = {0, 0, 0, 0, 0};
  if (reset) return (int)cudaMemcpyToSymbol(phase_cycles, z, sizeof(z));
  return (int)cudaMemcpyFromSymbol(out, phase_cycles, sizeof(z));
}""")
    src = sub(src, "  for (int r0 = lo; r0 < hi; r0 += BN) {\n",
              "  for (int r0 = lo; r0 < hi; r0 += BN) {\n"
              "    const long long t_a = clock64();\n")
    src = sub(src, "    __syncthreads();  // every step is done\n",
              "    __syncthreads();  // every step is done\n"
              "    const long long t_b = clock64();\n")
    src = sub(src, "    // ---- warp w merges the survivors",
              "    const long long t_c = clock64();\n"
              "    // ---- warp w merges the survivors")
    return sub(src, "    __syncthreads();  // tile_s is the next tile's stages\n",
               "    __syncthreads();  // tile_s is the next tile's stages\n"
               "    if (tid == 0) {\n"
               "      atomicAdd(&phase_cycles[0], t_b - t_a);\n"
               "      atomicAdd(&phase_cycles[1], t_c - t_b);\n"
               "      const long long t_d = clock64();\n"
               "      atomicAdd(&phase_cycles[2], t_d - t_c);\n"
               "      if (r0 == lo) atomicAdd(&phase_cycles[3], t_d - t_c);\n"
               "      atomicAdd(&phase_cycles[4], 1ull);\n"
               "    }\n")


def c_merge_out(src):
    return cut(src, "    // ---- keep only finite scores that beat the running",
               "    if (tid == 0) n_surv = 0;\n    __syncthreads();\n  }",
               "    if (tid == 0 && tile_d[0] == 1234.5f) out_d[0] = 0.f;\n")


def c_constant(src):
    if "accum_chunk" in src:          # the current kernel converts elsewhere
        return None
    src = sub(src, "  const float y = __fmul_rn((float)v, s);",
              "  const float y = __fmul_rn(1.0f, s);")
    src = sub(src, "      float a = 0.f, cc = 0.f;",
              "      float a = 0.f, cc = 0.f;\n      int live = 0;")
    src = sub(src, "          const int w[4] = {v.x, v.y, v.z, v.w};",
              "          const int w[4] = {v.x, v.y, v.z, v.w};\n"
              "          live ^= v.x ^ v.y ^ v.z ^ v.w;")
    return sub(src, "      for (int o = 16; o > 0; o >>= 1) {\n"
                    "        a += __shfl_xor_sync(0xffffffffu, a, o);",
               "      a += live == 0x12345678 ? 1.f : 0.f;\n"
               "      for (int o = 16; o > 0; o >>= 1) {\n"
               "        a += __shfl_xor_sync(0xffffffffu, a, o);")


def conversions(build, path):
    """Conversion instructions of the l2 kernel on 16-byte rows."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    body = sass.split("Function : _Z29fused_gather_topk_int8_kernelILi0ELb1E")
    body = body[1].split("Function :")[0]
    ops = collections.Counter(re.findall(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9.]+)", body))
    return {op: n for op, n in sorted(ops.items())
            if op.startswith(("I2F", "PRMT", "FMUL", "FFMA", "FADD"))}


# ---- kernel A: variants of an earlier descent.cuh (one margin array) -----
A_LOADS_OLD = """    const int cb = cb_t[node];
    if (cb < 0) break;  // at a leaf: every deeper level keeps the node
    const float th = th_t[node];
    const float xv = qb[f_t[node]];
"""
A_ALT_OLD = """      const int cb = cb_t[alt];
      if (cb < 0) break;
      const float xv = qb[f_t[alt]];
      bool right = xv >= th_t[alt];
"""


def a_loads_together(src):
    src = sub(src, A_LOADS_OLD, """    const int cb = cb_t[node];
    const float th = th_t[node];
    const int fi = f_t[node];
    if (cb < 0) break;
    const float xv = qb[fi];
""")
    return sub(src, A_ALT_OLD, """      const int cb = cb_t[alt];
      const float th = th_t[alt];
      const int fi = f_t[alt];
      if (cb < 0) break;
      const float xv = qb[fi];
      bool right = xv >= th;
""")


def a_no_margins(src):
    """Right at 1 probe only: the margins are neither written nor filled."""
    src = sub(src, "    margin[t] = fabsf(xv - th);\n",
              "    if (P > 1) margin[t] = fabsf(xv - th);\n")
    return sub(src, "  for (int u = t; u < max_depth; ++u) margin[u] = INFINITY;\n",
               "  if (P > 1)\n"
               "    for (int u = t; u < max_depth; ++u) margin[u] = INFINITY;\n")


def a_from_flip(src):
    src = sub(src, "  float margin[DESCENT_MAX_DEPTH];\n",
              "  float margin[DESCENT_MAX_DEPTH];\n  int path[DESCENT_MAX_DEPTH];\n")
    src = sub(src, "    margin[t] = fabsf(xv - th);\n",
              "    margin[t] = fabsf(xv - th);\n    path[t] = node;\n")
    src = sub(src, "    int alt = 0;\n    for (int u = 0; u < max_depth; ++u) {\n",
              "    int alt = path[flip];\n    for (int u = flip; u < max_depth; ++u) {\n")
    return src


# the current descent at other block sizes
A_THREADS_OF = "#define THREADS_OF(NA) ((NA) == 0 ? 512 : 1024)\n"
A_SETTINGS = {f"{n} queries a block": (A_THREADS_OF,
                                       f"#define THREADS_OF(NA) {n}\n")
              for n in (128, 256, 512, 1024)}
A_SETTINGS["as is: 512 at P = 1, 1024 above"] = (A_THREADS_OF, A_THREADS_OF)
A_PACKED = "as is, packed 16-byte records"


def a_packed(src):
    """Kernel A reading one 16-byte record (feat, thresh, child_base, 0) a
    node from an (L, max_nodes, 4) int32 copy passed as ``feat``."""
    src = sub(src, '#include "descent.cuh"\n', '#include "descent.cuh"\n'
              "struct PackedTree {\n  const int4* r;\n"
              "  __device__ __forceinline__ void node(int n, int& c, float& t,"
              " int& fe) const {\n    const int4 v = __ldg(r + n);\n"
              "    fe = v.x;\n    t = __int_as_float(v.y);\n    c = v.z;\n"
              "  }\n};\n")
    return sub(src, "GlobalTree{feat + off, thresh + off, child_base + off}",
               "PackedTree{reinterpret_cast<const int4*>(feat) + off}")


# ---- kernel B: variants of an earlier fused_query.cu ----------------------
def b_merge_out(src):
    return cut(src, "    // ---- keep only finite scores that beat the running",
               "    if (tid == 0) n_surv = 0;\n    __syncthreads();\n  }",
               "    if (tid == 0 && tile_d[0] == 1234.5f) out_d[0] = 0.f;\n")


def b_one_warp(src):
    src = sub(src, "#define THREADS 256\n", "#define THREADS 32\n")
    return sub(src, "#define TILE 256\n", "#define TILE 32\n")


B_SETTINGS = {"as is": ("#define GROUP 2\n", "#define GROUP 2\n"),
              "GROUP = 4": ("#define GROUP 2\n", "#define GROUP 4\n"),
              "small-M path up to M = 256": ("#define SPREAD_MAX_M 128\n",
                                             "#define SPREAD_MAX_M 256\n")}


def build_variants(build, variants):
    """{key: (source text, include dir)} -> {key: (ctypes lib, .so path)},
    one nvcc each, all at once; key[0] names the kernel's library."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key, (text, inc) in variants.items():
        name = re.sub(r"[^A-Za-z0-9]+", "_", "-".join(key))
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(text)
        procs[key] = so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(inc),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {key}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(so))
        symbol, argtypes = build.SIGNATURES[key[0]]
        getattr(lib, symbol).argtypes = argtypes
        getattr(lib, symbol).restype = ctypes.c_int
        libs[key] = lib, so
        emit({"built": list(key), "ptxas": [ln.strip() for ln in log.splitlines()
                                            if "registers" in ln or "spill" in ln]})
    return libs


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_split.py needs a CUDA GPU; none is available")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (descent_edge_inputs, least_chain_levels,
                            node_depths)
    from repro_torch.configs import rpf_iss595 as isscfg
    from repro_torch.configs import rpf_mnist784 as cfg
    from repro_torch.core.pipeline import candidates
    from repro_torch.core.search import mask_duplicates
    from repro_torch.data.synthetic import iss_like, mnist_like
    from repro_torch.index import IndexSpec, build_index
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.forest_traverse_hbm import forest_traverse_hbm
    from repro_torch.kernels.fused_query import fused_gather_topk
    from repro_torch.kernels.fused_query_int8 import fused_gather_topk_int8
    from repro_torch.kernels.matmul_topk import matmul_topk

    args = sys.argv[1:]
    kernels = "ABCD"
    if args[:1] == ["--kernels"]:
        kernels, args = args[1], args[2:]
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()})
    # the earlier source first: kernel B's outputs are held to its
    trees = {"parent": pathlib.Path(args[0]).resolve()} if args else {}
    trees["current"] = build.CSRC
    variants = {}   # (library, tree, variant) -> (source, include dir)
    for tree, csrc in trees.items():
        if "A" in kernels:
            a_src = (csrc / "forest_traverse.cu").read_text()
            if "DESCENT_MAX_DEPTH" in (csrc / "descent.cuh").read_text():
                head = (csrc / "descent.cuh").read_text()
                for name, fn in (("as is", None),
                                 ("loads together", a_loads_together),
                                 ("no margins", a_no_margins),
                                 ("from flip", a_from_flip)):
                    text = sub(a_src, '#include "descent.cuh"\n',
                               head if fn is None else fn(head))
                    variants["forest_traverse", tree, name] = text, csrc
            else:
                for name, (old, new) in A_SETTINGS.items():
                    variants["forest_traverse", tree, name] = (
                        sub(a_src, old, new), csrc)
                variants["forest_traverse", tree, A_PACKED] = (
                    a_packed(a_src), csrc)
        if "B" in kernels:
            b_src = (csrc / "fused_query.cu").read_text()
            if "SPREAD_MAX_M" in b_src:
                for name, (old, new) in B_SETTINGS.items():
                    variants["fused_query", tree, name] = (
                        sub(b_src, old, new), csrc)
            else:
                variants["fused_query", tree, "as is"] = b_src, csrc
                variants["fused_query", tree, "merge out"] = (
                    b_merge_out(b_src), csrc)
                variants["fused_query", tree, "one warp a query"] = (
                    b_one_warp(b_src), csrc)
        if "D" in kernels:
            d_src = (csrc / "scan_topk.cu").read_text()
            variants["scan_topk", tree, "as is"] = d_src, csrc
            variants["scan_topk", tree, "merge out"] = (d_merge_out(d_src),
                                                        csrc)
            if tree == "current":
                variants["scan_topk", tree, "phases"] = (d_phases(d_src),
                                                         csrc)
        if "C" in kernels:
            c_src = (csrc / "fused_query_int8.cu").read_text()
            variants["fused_query_int8", tree, "as is"] = c_src, csrc
            variants["fused_query_int8", tree, "merge out"] = (
                c_merge_out(c_src), csrc)
            if c_constant(c_src) is not None:
                variants["fused_query_int8", tree, "constant"] = (
                    c_constant(c_src), csrc)
    build.build_all(("forest_traverse", "pointer_chase", "fused_query"))
    libs = build_variants(build, variants)

    dev = torch.device("cuda")
    db_np, _, q_np, _ = mnist_like(cfg.N_DB, n_test=cfg.QUERY_BATCH, d=cfg.DIM,
                                   seed=0)
    q, db = torch.from_numpy(q_np).to(dev), torch.from_numpy(db_np).to(dev)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    def time_ms(fn, reps, cold=True):
        for _ in range(2):
            fn()
        times = []
        for _ in range(reps):
            if cold:
                flush()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def use(key):
        build._loaded[key[0]] = libs[key][0]

    if set(kernels) & set("ABC"):
        index8 = build_index(db_np, IndexSpec(backend="rpf+int8",
                                              forest=cfg.CONFIG, seed=0),
                             device=dev)
        rc = cfg.CONFIG.resolved(db.shape[0])
        cand = {}
        for p in (1, 4):
            ids, mask = candidates(index8.forest, q, rc.max_depth, rc.leaf_pad,
                                   p)
            cand[p] = torch.where(mask_duplicates(ids, mask), ids,
                                  -1).int().contiguous()

    if "A" in kernels:
        iss_np, _, iss_q_np, _ = iss_like(isscfg.N_DB, n_test=isscfg.QUERY_BATCH,
                                          d=isscfg.DIM,
                                          n_models=isscfg.N_MODELS, seed=1)
        iss_q = torch.from_numpy(iss_q_np).to(dev)
        iss_index = build_index(iss_np, IndexSpec(backend="rpf",
                                                  forest=isscfg.CONFIG, seed=0),
                                device=dev)
        iss_rc = isscfg.CONFIG.resolved(iss_np.shape[0])
        forests = {}
        for cell, frst, qq, depth_cap in (
                ("rpf_mnist784", index8.forest, q, rc.max_depth),
                ("rpf_iss595", iss_index.forest, iss_q, iss_rc.max_depth)):
            feat = frst.proj_idx[..., 0].contiguous()
            forests[cell] = (feat, frst.thresh, frst.child_base, qq, depth_cap)
        plain, info = {}, {}
        for cell, (feat, th, cb, qq, depth_cap) in forests.items():
            depth = node_depths(torch, cb, depth_cap)
            for p in (1, 4):
                leaves = ref.forest_traverse_ref(feat, th, cb, qq, depth_cap, p)
                plain[cell, p] = leaves
                lv = leaves.view(leaves.shape[0], leaves.shape[1], -1)
                ok = lv >= 0
                levels = torch.where(ok, depth[torch.arange(
                    lv.shape[0], device=dev)[:, None, None],
                    lv.clamp_min(0).long()], 0)
                info[cell, p] = {
                    "chain_levels_max": int(levels.sum(-1).max()),
                    "least_chain_levels_max": int(least_chain_levels(
                        torch, cb, depth, lv).max()),
                    "max_levels": int(levels.max())}
        packed = {cell: torch.stack(
            [f[0], f[1].view(torch.int32), f[2], torch.zeros_like(f[2])],
            -1).contiguous() for cell, f in forests.items()}
        mf = forests["rpf_mnist784"]
        edges = descent_edge_inputs(torch, mf[0], mf[1], mf[2], q)
        for (kernel, tree, variant), (lib, _) in libs.items():
            if kernel != "forest_traverse":
                continue
            use((kernel, tree, variant))
            probes = (1,) if variant == "no margins" else (1, 4)
            for cell, (feat, th, cb, qq, depth_cap) in forests.items():
                for p in probes:
                    def run(feat=feat, th=th, cb=cb, qq=qq, depth_cap=depth_cap,
                            p=p):
                        if variant != A_PACKED:
                            return forest_traverse_hbm(feat, th, cb, qq,
                                                       depth_cap, p)
                        out = torch.empty((feat.shape[0], qq.shape[0], p),
                                          dtype=torch.int32, device=dev)
                        build.check_launch(lib.forest_traverse(
                            packed[cell].data_ptr(), th.data_ptr(),
                            cb.data_ptr(), qq.data_ptr(), out.data_ptr(),
                            *feat.shape, *qq.shape, depth_cap, p,
                            torch.cuda.current_stream().cuda_stream), "packed")
                        return out[..., 0] if p == 1 else out
                    got = run()
                    emit({"kernel": "A", "tree": tree, "variant": variant,
                          "cell": cell, "n_probes": p, **info[cell, p],
                          "equal_to_plain": bool(torch.equal(got,
                                                             plain[cell, p])),
                          "ms_flushed": [time_ms(run, 25) for _ in range(2)],
                          "ms_warm": [time_ms(run, 25, False)
                                      for _ in range(2)]})
            if variant in ("as is", "as is: 512 at P = 1, 1024 above"):
                diffs = {}
                for name, (feat, th, cb, qq) in edges.items():
                    for p in (1, 3, 4, 8, 9):
                        got = forest_traverse_hbm(feat, th, cb, qq,
                                                  rc.max_depth, p)
                        want = ref.forest_traverse_ref(feat, th, cb, qq,
                                                       rc.max_depth, p)
                        diffs[f"{name}, P = {p}"] = int((got != want).sum())
                emit({"kernel": "A", "tree": tree, "variant": variant,
                      "edge_inputs_slots_differing_from_plain": diffs})
        # one dependent load's latency: a single thread chases 4,096 hops
        # scattered through a 64 MB array (long, so that the host's launch
        # gap before an unflushed run weighs little)
        chase = build.library("pointer_chase").pointer_chase
        n_chain, hops = 1 << 24, 4096
        gen = torch.Generator(device=dev).manual_seed(1)
        path = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                          1 + torch.randperm(n_chain - 1, generator=gen,
                                             device=dev)[:hops]])
        nxt = torch.zeros(n_chain, dtype=torch.int32, device=dev)
        nxt[path[:-1]] = path[1:].int()
        out = torch.empty(1, dtype=torch.int32, device=dev)

        def run_chase(n):
            build.check_launch(chase(nxt.data_ptr(), n, out.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream),
                               "pointer_chase")
        lat = {}
        for name, cold in (("flushed", True), ("warm", False)):
            t_long, t_short = (time_ms(lambda n=n: run_chase(n), 25, cold)
                               for n in (hops, 1))
            lat[name] = (t_long - t_short) * 1e3 / (hops - 1)
        emit({"kernel": "pointer_chase", "latency_us_per_load": lat})

    if "B" in kernels:
        qdb = index8.qdb
        shapes = {f"stage 2 of rpf+int8, P = {p}": (qdb.fp, fused_gather_topk_int8(
            q, cand[p], qdb.q, qdb.scale, 40, "l2")[1].contiguous())
            for p in (1, 4)}
        shapes.update({f"rpf, P = 1, first {m} slots": (
            db, cand[1][:, :m].contiguous()) for m in (64, 96, 128, 256)})
        shapes.update({f"rpf, P = {p}": (db, cand[p]) for p in (1, 4)})
        want = {}
        for (kernel, tree, variant), (lib, _) in libs.items():
            if kernel != "fused_query":
                continue
            use((kernel, tree, variant))
            for name, (rows, ids) in shapes.items():
                got = fused_gather_topk(q, ids, rows, 10, "l2")
                row = {"kernel": "B", "tree": tree, "variant": variant,
                       "shape": name, "m": ids.shape[1],
                       "valid_slots": int((ids >= 0).sum()),
                       "ms": [time_ms(lambda: fused_gather_topk(
                           q, ids, rows, 10, "l2"), 25) for _ in range(2)]}
                if variant != "merge out":
                    want.setdefault(name, got)
                    row["bitwise_as_first"] = bool(
                        torch.equal(got[0].view(torch.int32),
                                    want[name][0].view(torch.int32))
                        and torch.equal(got[1], want[name][1]))
                emit(row)

    for (kernel, tree, variant), (lib, _) in libs.items():
        if kernel != "scan_topk":
            continue
        use((kernel, tree, variant))
        for metric in ("l2", "dot"):
            row = {"kernel": "D", "tree": tree, "variant": variant,
                   "metric": metric, "ms": [time_ms(
                       lambda: matmul_topk(q, db, 10, metric), 10)
                       for _ in range(2)]}
            if variant == "phases":
                out = (ctypes.c_ulonglong * 5)()
                lib.phase_io.argtypes = [ctypes.c_void_p, ctypes.c_int]
                build.check_launch(lib.phase_io(None, 1), "phase_io")
                matmul_topk(q, db, 10, metric)
                torch.cuda.synchronize()
                build.check_launch(lib.phase_io(out, 0), "phase_io")
                row["cycles_per_row_tile"] = {
                    "steps": out[0] / out[4], "test": out[1] / out[4],
                    "merge": out[2] / out[4],
                    "merge_of_first_tiles": out[3] / out[4],
                    "row_tiles": out[4]}
            emit(row)
    if "D" in kernels:
        emit({"kernel": "cuBLAS q @ db.T", "ms": [time_ms(lambda: q @ db.T, 10)
                                                  for _ in range(2)]})

    if "C" in kernels:
        qdb = index8.qdb
        q768, q8_768 = q[:, :768].contiguous(), qdb.q[:, :768].contiguous()
        for p in (1, 4):
            for (kernel, tree, variant), (lib, _) in libs.items():
                if kernel != "fused_query_int8":
                    continue
                use((kernel, tree, variant))
                for metric in ("l2", "dot"):
                    emit({"kernel": "C", "tree": tree, "variant": variant,
                          "metric": metric, "m": cand[p].shape[1], "ms": [
                              time_ms(lambda: fused_gather_topk_int8(
                                  q, cand[p], qdb.q, qdb.scale, 40, metric),
                                  25) for _ in range(2)]})
                if variant == "as is":
                    emit({"kernel": "C", "tree": tree, "variant": "d = 768",
                          "metric": "l2", "m": cand[p].shape[1], "ms": [
                              time_ms(lambda: fused_gather_topk_int8(
                                  q768, cand[p], q8_768, qdb.scale, 40, "l2"),
                                  25) for _ in range(2)]})
        for tree in trees:
            emit({"kernel": "C", "tree": tree, "sass_l2_16byte_rows":
                  conversions(build, libs["fused_query_int8", tree,
                                         "as is"][1])})


if __name__ == "__main__":
    main()
