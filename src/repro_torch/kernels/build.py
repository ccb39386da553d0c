"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and becomes its own
shared library, ``build/kernels/<name>-<hash>.so`` under the repository
root, where the hash covers the source, the headers under ``csrc/`` and
the flags: an edited source or header rebuilds, an unchanged one loads.
``build_all`` starts one nvcc per source at once and waits for all of
them.  Nothing is compiled when a module is imported; the first launch
builds what it needs.

Every pointer and the stream cross as ``c_void_p`` (a bare Python int would
be cut to 32 bits), every size as ``c_int``; each entry point returns the
``cudaError_t`` of its launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of each source's entry point: (symbol, argtypes)
SIGNATURES = {
    "forest_traverse": ("forest_traverse",
                        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "fused_query": ("fused_gather_topk",
                    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "fused_query_int8": ("fused_gather_topk_int8",
                         [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _P]),
    "scan_topk": ("scan_topk",
                  [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   _P]),
    "forest_traverse_smem": ("forest_traverse_smem",
                             [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "distance_topk": ("distance_topk",
                      [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "embedding_bag": ("embedding_bag",
                      [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "chi2_topk": ("chi2_topk",
                  [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # any source may include one
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, pathlib.Path, pathlib.Path]:
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: pathlib.Path,
            out: pathlib.Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(log)
    return log


def build_all(names=tuple(SIGNATURES)) -> dict[str, str]:
    """Build every library not built yet, one nvcc each, all at once.

    Returns the nvcc log (``-Xptxas -v``: registers, spills, shared
    memory) of each library it built."""
    with _lock:
        todo = [n for n in names if not library_path(n).exists()]
        procs = {n: _start(n) for n in todo}
        return {n: _finish(n, *procs[n]) for n in todo}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
    build_all((name,))
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(str(library_path(name)))
            symbol, argtypes = SIGNATURES[name]
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = lib
        return _loaded[name]


def check_launch(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed with cudaError_t {err}")
