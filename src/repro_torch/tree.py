"""Trees of tensors, flattened as JAX flattens the reference's pytrees.

The port's optimizers, train states and checkpoints walk the same trees as
the reference's: dicts (keys sorted), NamedTuples (fields in declaration
order), lists and tuples (in order), and ``None``, an empty subtree with no
leaf; a partition spec (``models.layers.P``, a tuple) is a leaf.  An
``nn.Module`` is a node whose children are those of its parameters' tree (``module_tree``: ``tables.3`` becomes ``["tables"][3]``),
so a model stands where the reference holds its params dict, and a leaf's
name is its '/'-joined path (``params/tables/0``, ``opt_state/m/bot_mlp/0/w``)
in both packages.  Anything else is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable

from torch import nn


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def module_tree(model: nn.Module) -> dict:
    """The reference's params tree of ``model``: nested dicts (and lists
    where the names are 0, 1, ...) of its parameters."""
    tree: dict = {}
    for name, p in model.named_parameters():
        node, parts = tree, name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = p
    return _as_lists(tree)


def _as_lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_as_lists(node[str(i)]) for i in range(len(node))]
    return {k: _as_lists(v) for k, v in node.items()}


def children(tree) -> list[tuple[str, Any]] | None:
    """(path entry, child) pairs of an inner node in flattening order, or
    None for a leaf."""
    if tree is None:
        return []
    if isinstance(tree, nn.Module):
        tree = module_tree(tree)
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def _is_spec(x) -> bool:
    """A partition spec (``models.layers.P``) is a leaf."""
    return getattr(x, "_is_partition_spec", False)


def flatten_with_names(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """[(leaf name, leaf)] in the reference's flattening order."""
    kids = children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out.extend(flatten_with_names(child, f"{prefix}/{key}" if prefix
                                      else key))
    return out


def leaves(tree) -> list:
    """The tree's leaves in flattening order."""
    return [leaf for _, leaf in flatten_with_names(tree)]


def _rebuild(skeleton, built: list):
    """A node of ``skeleton``'s kind over the children ``built`` (a module
    rebuilds as its parameters' tree)."""
    if isinstance(skeleton, nn.Module):
        skeleton = module_tree(skeleton)
    if isinstance(skeleton, dict):
        return dict(zip(sorted(skeleton), built))
    if _is_namedtuple(skeleton):
        return type(skeleton)(*built)
    return type(skeleton)(built)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); ``None`` stays ``None``."""
    if tree is None:
        return None
    kids = children(tree)
    if kids is None:
        return fn(tree, *rest)
    others = [[c for _, c in children(r)] for r in rest]
    return _rebuild(tree, [tree_map(fn, c, *(o[i] for o in others))
                           for i, (_, c) in enumerate(kids)])


def unflatten(skeleton, values: Iterable):
    """``skeleton``'s structure with its leaves replaced, in flattening
    order, by ``values``."""
    it = iter(values)
    return tree_map(lambda _: next(it), skeleton)


def unflatten_like(skeleton, named: dict[str, Any]):
    """``skeleton``'s structure with each leaf replaced by ``named[name]``."""
    return unflatten(skeleton, (named[n] for n, _ in
                                flatten_with_names(skeleton)))


def treedef_str(tree) -> str:
    """The tree's structure in the form JAX prints a ``PyTreeDef``."""
    def rec(t):
        if t is None:
            return "None"
        if isinstance(t, nn.Module):
            t = module_tree(t)
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
