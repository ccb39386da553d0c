#!/usr/bin/env python3
"""Split the time of kernels D and C on one GPU, phase by phase.

    python3 chip_split.py [PARENT_CSRC]    # from the repository root

Builds variants of ``src/repro_torch/csrc/scan_topk.cu`` (kernel D) and
``fused_query_int8.cu`` (kernel C), each with one phase compiled out or
replaced, so that its output is wrong and only its time counts, and times
each beside the kernel as it is, at the main path's shapes: D on the 1024
MNIST-784 queries against the 60,000 rows at k = 10 (l2 and dot), C on the
``rpf+int8`` path's candidates at 1 and 4 probes (k' = 40).  With
PARENT_CSRC, a directory that holds earlier versions of the two sources
(and the headers they include), the same for those.  Variants:

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


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_split.py needs a CUDA GPU; none is available")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import rpf_mnist784 as cfg
    from repro_torch.core.pipeline import candidates
    from repro_torch.core.search import mask_duplicates
    from repro_torch.data.synthetic import mnist_like
    from repro_torch.index import IndexSpec, build_index
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_query_int8 import fused_gather_topk_int8
    from repro_torch.kernels.matmul_topk import matmul_topk

    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()})
    trees = {"current": build.CSRC}
    if len(sys.argv) > 1:
        trees["parent"] = pathlib.Path(sys.argv[1]).resolve()
    variants = {}   # (kernel, tree, variant) -> source text
    for tree, csrc in trees.items():
        d_src = (csrc / "scan_topk.cu").read_text()
        c_src = (csrc / "fused_query_int8.cu").read_text()
        variants["scan_topk", tree, "as is"] = d_src
        variants["scan_topk", tree, "merge out"] = d_merge_out(d_src)
        if tree == "current":
            variants["scan_topk", tree, "phases"] = d_phases(d_src)
        variants["fused_query_int8", tree, "as is"] = c_src
        variants["fused_query_int8", tree, "merge out"] = c_merge_out(c_src)
        if c_constant(c_src) is not None:
            variants["fused_query_int8", tree, "constant"] = c_constant(c_src)
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key, text in variants.items():
        name = "-".join(key).replace(" ", "_")
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(text)
        procs[key] = so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(trees[key[1]]),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    build.build_all(("forest_traverse",))
    libs = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {key}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(so))
        symbol, argtypes = build.SIGNATURES[key[0]]
        getattr(lib, symbol).argtypes = argtypes
        getattr(lib, symbol).restype = ctypes.c_int
        libs[key] = lib
        emit({"built": list(key), "ptxas": [ln.strip() for ln in log.splitlines()
                                            if "registers" in ln]})

    dev = torch.device("cuda")
    db_np, _, q_np, _ = mnist_like(cfg.N_DB, n_test=cfg.QUERY_BATCH, d=cfg.DIM,
                                   seed=0)
    q, db = torch.from_numpy(q_np).to(dev), torch.from_numpy(db_np).to(dev)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def time_ms(fn, reps):
        for _ in range(2):
            fn()
        times = []
        for _ in range(reps):
            flush_buf.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    for (kernel, tree, variant), lib in libs.items():
        if kernel != "scan_topk":
            continue
        build._loaded[kernel] = lib
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
    emit({"kernel": "cuBLAS q @ db.T", "ms": [time_ms(lambda: q @ db.T, 10)
                                              for _ in range(2)]})

    index = build_index(db_np, IndexSpec(backend="rpf+int8", forest=cfg.CONFIG,
                                         seed=0), device=dev)
    qdb, rc = index.qdb, cfg.CONFIG.resolved(db.shape[0])
    q768, q8_768 = q[:, :768].contiguous(), qdb.q[:, :768].contiguous()
    for p in (1, 4):
        ids, mask = candidates(index.forest, q, rc.max_depth, rc.leaf_pad, p)
        ids = torch.where(mask_duplicates(ids, mask), ids, -1).int().contiguous()
        for (kernel, tree, variant), lib in libs.items():
            if kernel != "fused_query_int8":
                continue
            build._loaded[kernel] = lib
            for metric in ("l2", "dot"):
                emit({"kernel": "C", "tree": tree, "variant": variant,
                      "metric": metric, "m": ids.shape[1], "ms": [time_ms(
                          lambda: fused_gather_topk_int8(
                              q, ids, qdb.q, qdb.scale, 40, metric), 25)
                          for _ in range(2)]})
            if variant == "as is":
                emit({"kernel": "C", "tree": tree, "variant": "d = 768",
                      "metric": "l2", "m": ids.shape[1], "ms": [time_ms(
                          lambda: fused_gather_topk_int8(
                              q768, ids, q8_768, qdb.scale, 40, "l2"), 25)
                          for _ in range(2)]})
    for tree in trees:
        so = procs["fused_query_int8", tree, "as is"][0]
        emit({"kernel": "C", "tree": tree, "sass_l2_16byte_rows":
              conversions(build, so)})


if __name__ == "__main__":
    main()
