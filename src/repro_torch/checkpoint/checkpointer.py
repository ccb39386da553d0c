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
torch tensors, copied to the host).  They flatten as JAX flattens them:
dict keys sorted, a NamedTuple's fields in declaration order.  ``treedef``
is informative only: a restore rebuilds the structure from the skeleton it
is given.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> list[tuple[str, Any]] | None:
    """(path entry, child) pairs of an inner node in flattening order, or
    None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def flatten_with_names(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """[(leaf name, leaf)] in the reference's flattening order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out.extend(flatten_with_names(child, f"{prefix}/{key}" if prefix
                                      else key))
    return out


def treedef_str(tree) -> str:
    """The tree's structure in the form JAX prints a ``PyTreeDef``."""
    def rec(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"'{k}': {rec(t[k])}"
                                   for k in sorted(t)) + "}"
        if _is_namedtuple(t):
            return (f"CustomNode(namedtuple[{type(t).__name__}], ["
                    + ", ".join(rec(c) for c in t) + "])")
        if isinstance(t, list):
            return "[" + ", ".join(rec(c) for c in t) + "]"
        if isinstance(t, tuple):
            return "(" + ", ".join(rec(c) for c in t) + ")"
        return "*"
    return f"PyTreeDef({rec(tree)})"


def unflatten_like(skeleton, leaves: dict[str, Any], prefix: str = ""):
    """``skeleton``'s structure with each leaf replaced by ``leaves[name]``."""
    kids = _children(skeleton)
    if kids is None:
        return leaves[prefix]
    built = [unflatten_like(child, leaves, f"{prefix}/{key}" if prefix
                            else key) for key, child in kids]
    if isinstance(skeleton, dict):
        return {key: v for (key, _), v in zip(kids, built)}
    if _is_namedtuple(skeleton):
        return type(skeleton)(*built)
    return type(skeleton)(built)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Checkpointer:
    """Save and restore trees of arrays under ``directory``, keeping the
    ``keep`` newest steps."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree, extra: Optional[dict] = None) -> str:
        """Write ``tree`` as step ``step`` (its leaves copied to the host);
        returns the step's directory."""
        host = [(n, _host(x)) for n, x in flatten_with_names(tree)]
        path = os.path.join(self.dir, f"step_{step:010d}")
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {
            "step": step,
            "leaves": [{"name": n, "shape": list(a.shape),
                        "dtype": str(a.dtype)} for n, a in host],
            "treedef": treedef_str(tree),
            "extra": extra or {},
        }
        for n, a in host:
            np.save(os.path.join(tmp, n.replace("/", "__") + ".npy"), a)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(path, ignore_errors=True)
        os.rename(tmp, path)
        self._gc()
        return path

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
            want = dtypes.get(name)
            leaves[name] = (a if want is None or str(a.dtype) == want
                            else a.astype(np.dtype(want)))
        return unflatten_like(skeleton, leaves), step
