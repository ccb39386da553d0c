"""Checkpoints in the reference's format (port of
``repro/checkpoint/checkpointer.py``), so either package reads what the
other wrote.

A checkpoint is a directory per step, ``step_<10 digits>``, holding one
``.npy`` per leaf of a tree and ``manifest.json`` (``step``, ``leaves``:
name, shape and dtype in flattening order, ``treedef`` and ``extra``).  A
leaf's name is its '/'-joined tree path (dict keys, NamedTuple field names,
sequence positions); its file replaces '/' with '__'.  Writes go to
``<dir>.tmp``, then an atomic rename, so a crash mid-write never corrupts
the latest checkpoint.

The trees are dicts, NamedTuples, lists and tuples of arrays (numpy, or
torch tensors, copied to the host), ``None`` (no leaf) and ``nn.Module``s
(their parameters' tree), flattened as JAX flattens them (``repro_torch.
tree``): so a ``TrainState``'s leaves are ``step``, ``params/tables/0``,
``opt_state/m/bot_mlp/0/w``, ... in both packages.  A leaf of a dtype
numpy lacks (bfloat16) is stored as f32, a lossless upcast, with its own
dtype in the manifest, as the reference stores it.  ``treedef`` is
informative only: a restore rebuilds the structure from the skeleton it is
given.

``save(..., block=False)`` copies the tree to the host before it returns
and writes on a background thread; ``wait()`` joins it.
``install_preemption_handler`` makes SIGTERM set a flag that ``preempted``
reads and the train loop polls, to checkpoint and exit cleanly.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.tree import (flatten_with_names, leaves, treedef_str,
                              unflatten_like)

__all__ = ["Checkpointer", "flatten_with_names", "install_preemption_handler",
           "preempted", "treedef_str", "unflatten_like"]


def _host(x) -> tuple[np.ndarray, str]:
    """(a host copy of leaf ``x`` numpy can store, ``x``'s dtype name)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.detach().to("cpu", torch.float32).numpy(), "bfloat16"
        a = x.detach().to("cpu", copy=True).numpy()
    else:
        a = np.array(x)
    return a, str(a.dtype)


def _stored_dtype(a: np.ndarray, want: Optional[str]) -> np.ndarray:
    """A loaded array in its saved dtype (left in f32 where numpy has no
    such dtype, as for bfloat16)."""
    if want is None or str(a.dtype) == want:
        return a
    try:
        return a.astype(np.dtype(want))
    except TypeError:
        return a


class Checkpointer:
    """Save and restore trees of arrays under ``directory``, keeping the
    ``keep`` newest steps."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree, block: bool = True,
             extra: Optional[dict] = None) -> str:
        """Write ``tree`` as step ``step`` (its leaves copied to the host
        before this returns; the files written on a background thread
        unless ``block``); returns the step's directory."""
        self.wait()
        host = [(n,) + _host(x) for n, x in flatten_with_names(tree)]
        path = os.path.join(self.dir, f"step_{step:010d}")
        manifest = {
            "step": step,
            "leaves": [{"name": n, "shape": list(a.shape), "dtype": dt}
                       for n, a, dt in host],
            "treedef": treedef_str(tree),
            "extra": extra or {},
        }

        def write():
            tmp = path + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for n, a, _ in host:
                np.save(os.path.join(tmp, n.replace("/", "__") + ".npy"), a)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            shutil.rmtree(path, ignore_errors=True)
            os.rename(tmp, path)
            self._gc()

        if block:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        return path

    def wait(self) -> None:
        """Join the background write of the last ``save``, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    def all_steps(self) -> list[int]:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def manifest(self, step: Optional[int] = None) -> dict:
        """The manifest of ``step`` (the latest when None)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        with open(os.path.join(self.dir, f"step_{step:010d}",
                               "manifest.json")) as f:
            return json.load(f)

    def restore(self, skeleton, step: Optional[int] = None):
        """(``skeleton``'s structure with its leaves read back as numpy
        arrays of their stored dtype, step); leaf values of ``skeleton``
        are ignored, leaves on disk that it lacks are not read."""
        manifest = self.manifest(step)
        step = manifest["step"]
        path = os.path.join(self.dir, f"step_{step:010d}")
        dtypes = {leaf["name"]: leaf["dtype"] for leaf in manifest["leaves"]}
        leaves = {}
        for name, _ in flatten_with_names(skeleton):
            a = np.load(os.path.join(path, name.replace("/", "__") + ".npy"))
            leaves[name] = _stored_dtype(a, dtypes.get(name))
        return unflatten_like(skeleton, leaves), step

    def restore_into(self, tree, step: Optional[int] = None) -> int:
        """Copy step ``step`` (the latest when None) into the tensor leaves
        of ``tree`` in place, each cast to its leaf's dtype and device (a
        module's parameters, a train state's moments); returns the step."""
        restored, step = self.restore(tree, step)
        with torch.no_grad():
            for leaf, a in zip(leaves(tree), leaves(restored)):
                a = np.asarray(a)
                if a.dtype.name == "bfloat16":   # where numpy knows it
                    a = a.astype(np.float32)
                leaf.copy_(torch.from_numpy(a))
        return step


_PREEMPTED = threading.Event()


def install_preemption_handler() -> threading.Event:
    """SIGTERM -> set the flag ``preempted`` reads; the train loop then
    checkpoints and exits cleanly."""
    def _handler(signum, frame):
        _PREEMPTED.set()
    signal.signal(signal.SIGTERM, _handler)
    return _PREEMPTED


def preempted() -> bool:
    return _PREEMPTED.is_set()
