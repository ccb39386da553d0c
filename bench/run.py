"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The program (``src/repro_torch``) is imported
from that checkout; its kernels build into ``build/kernels/`` there, so
only a checkout's first run compiles.  The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
compared number beside its limit, which also end standard error).  Without
a CUDA device, with fewer than the cell's chips, without the program, or
with JAX or the JAX package loaded once the window has closed, it prints no
result and exits with a code other than 0.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def setup_environment() -> None:
    """Caches inside the checkout at fixed paths; the program first on the
    import path; no library loading JAX on its own."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    here = str(ROOT / "bench")     # the script's folder: its modules would
    sys.path[:] = [p for p in sys.path if p != here]   # shadow top names
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def fail(message: str, code: int) -> int:
    print(f"bench: {message}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    args = parse(argv)
    setup_environment()
    from bench import harness, manifest

    man = manifest.load(ROOT)
    cell = man.cell(args.workload)
    import torch
    marks = [("imports", harness.now())]
    if not torch.cuda.is_available():
        return fail("no CUDA device is available", 2)
    if torch.cuda.device_count() < int(cell["chips"]):
        return fail(f"{args.workload} needs {cell['chips']} CUDA devices, "
                    f"{torch.cuda.device_count()} visible", 2)
    try:
        import repro_torch
    except ImportError as err:
        return fail(f"the program is not in this checkout: {err}", 3)
    if not pathlib.Path(repro_torch.__file__).resolve().is_relative_to(
            ROOT / "src"):
        return fail(f"repro_torch comes from {repro_torch.__file__}, not "
                    f"from this checkout", 3)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    torch.zeros(1, device="cuda")          # the CUDA context
    marks.append(("cuda context", harness.now()))

    result = harness.run_cell(man, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T0, marks=marks)
    found = forbidden_modules()
    if found:
        return fail(f"JAX or the JAX package was loaded: {found}", 4)
    for name, check in result["checks"].items():
        print(f"check {name} = {check['value']!r} (limit {check['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
