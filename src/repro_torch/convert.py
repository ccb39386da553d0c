"""Carry a forest (and int8 rows) built elsewhere into the port.

``forest_from_numpy`` takes the eight ``Forest`` fields of the reference
package as numpy arrays -- for example ``jax.device_get(index.forest)`` --
and ``index_from_numpy`` wraps them with their rows as a queryable ``rpf``
or ``rpf+int8`` index without building one, so both packages can query the
same forest.  For ``rpf+int8`` it also takes the reference's ``q8`` and
``scale`` and checks that the port's ``quantize_db`` gives the same bits.
An ``lsh-cascade`` index's state is its rows alone: its tables are rebuilt
from (rows, spec), as the reference's ``from_state`` rebuilds them.  A
whole index, segments, tombstones and all, crosses through a saved
manifest instead (``index.load_index``).

``recsys_from_numpy`` takes a recommender's params tree as numpy arrays --
for example ``jax.device_get(init_mind(key, cfg))`` -- and returns the
port's module with the same weights; ``lm_from_numpy`` does the same for
a dense language model's ``init_lm`` tree (bfloat16 leaves included).
``mace_from_numpy`` takes MACE's ``init_mace`` tree so and returns the
port's tree of tensors that require gradients, by name and unchanged.
``train_state_from_numpy`` takes a whole ``TrainState`` so --
``jax.device_get(state)`` -- and returns the port's, its optimizer state an
``AdamState``, a ``FactorState`` or SGDM's momentum tree, so that both
packages can train from one state.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.core.forest import Forest
from repro_torch.device import resolve_device
from repro_torch.index.api import get_backend
from repro_torch.index.params import IndexSpec
from repro_torch.models import recsys as rs
from repro_torch.models import transformer as tr
from repro_torch.train.optimizer import AdamState, FactorState
from repro_torch.train.train_state import TrainState
from repro_torch.tree import tree_map

_DTYPES = {"proj_idx": torch.int32, "proj_coef": torch.float32,
           "thresh": torch.float32, "child_base": torch.int32,
           "perm": torch.int32, "leaf_offset": torch.int32,
           "leaf_count": torch.int32, "n_nodes": torch.int32}


def forest_from_numpy(arrays: Mapping[str, Any] | Any,
                      device: str | torch.device | None = None) -> Forest:
    """The port's ``Forest`` from a mapping (or NamedTuple) of the eight
    field arrays, on ``device`` (the GPU unless ``device="cpu"``)."""
    dev = resolve_device(device)
    if hasattr(arrays, "_asdict"):
        arrays = arrays._asdict()
    missing = set(Forest._fields) - set(arrays)
    if missing:
        raise KeyError(f"forest arrays lack {sorted(missing)}")
    return Forest(**{
        name: torch.tensor(np.asarray(arrays[name]), dtype=_DTYPES[name],
                           device=dev)
        for name in Forest._fields})


def index_from_numpy(db, forest_arrays, spec: IndexSpec,
                     device: str | torch.device | None = None,
                     q8=None, scale=None):
    """A queryable index over rows ``db`` (N, d): ``rpf`` or ``rpf+int8``
    with a forest built over exactly those rows with ``spec.forest``
    (``rpf+int8`` takes the reference's ``q8`` and ``scale`` too), or
    ``lsh-cascade`` with ``forest_arrays`` None, its tables rebuilt from
    (db, spec)."""
    dev = resolve_device(device)
    rows = torch.as_tensor(np.asarray(db, np.float32), device=dev)
    cls = get_backend(spec.backend)
    if spec.backend == "lsh-cascade":
        if forest_arrays is not None:
            raise ValueError("an lsh-cascade index holds no forest")
        return cls._from_engine(cls.engine_cls(spec, rows.contiguous()),
                                spec)
    forest = forest_from_numpy(forest_arrays, dev)
    if forest.perm.shape[1] != rows.shape[0]:
        raise ValueError(f"forest indexes {forest.perm.shape[1]} rows, db "
                         f"holds {rows.shape[0]}")
    if forest.n_trees != spec.forest.n_trees:
        raise ValueError(f"forest has {forest.n_trees} trees, spec says "
                         f"{spec.forest.n_trees}")
    index = cls._from_engine(
        cls.engine_cls(spec, rows.contiguous(), forest=forest), spec)
    if spec.backend == "rpf+int8":
        if q8 is None or scale is None:
            raise ValueError("an rpf+int8 index needs its q8 and scale")
        # the port quantizes the rows itself; the carried arrays must agree
        for name, got, want in (("q8", index.qdb.q, q8),
                                ("scale", index.qdb.scale, scale)):
            want = torch.as_tensor(np.array(want), device=dev)
            if want.dtype != got.dtype or not torch.equal(want, got):
                raise ValueError(f"the port's quantize_db does not "
                                 f"reproduce the carried {name}")
    return index


def recsys_from_numpy(tree: Mapping[str, Any], cfg=None,
                      device: str | torch.device | None = None):
    """The port's recommender with the weights of a reference params tree
    of numpy arrays, on ``device`` (the GPU unless ``device="cpu"``):
    ``DLRM``, ``AutoInt``, ``WideDeep`` or ``MIND`` after ``cfg.model``,
    the two-tower model where ``cfg`` is None."""
    dev = resolve_device(device)

    def leaf(node):
        if isinstance(node, Mapping):
            return {k: leaf(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [leaf(v) for v in node]
        return torch.tensor(np.asarray(node), device=dev)

    params = leaf(tree)
    if cfg is None:
        return rs.TwoTower(params)
    return rs.MODELS[cfg.model](cfg, params)


def _tensor(a, device: torch.device) -> torch.Tensor:
    """A tensor of numpy array ``a`` (bfloat16, which torch cannot take
    from numpy, through a lossless f32)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32),
                            device=device).to(torch.bfloat16)
    return torch.tensor(a, device=device)


def lm_from_numpy(tree: Mapping[str, Any], cfg: LMConfig,
                  device: str | torch.device | None = None) -> tr.LM:
    """The port's dense LM with the weights of a reference ``init_lm``
    params tree of numpy arrays, on ``device`` (the GPU unless
    ``device="cpu"``); leaves keep their dtypes, bfloat16 included."""
    dev = resolve_device(device)
    return tr.LM(cfg, tree_map(lambda a: _tensor(a, dev), dict(tree)))


def mace_from_numpy(tree: Mapping[str, Any],
                    device: str | torch.device | None = None) -> dict:
    """The port's MACE parameters (``models/mace.init_mace``'s tree) from a
    reference ``init_mace`` tree of numpy arrays, on ``device`` (the GPU
    unless ``device="cpu"``): each leaf by name, its values and dtype
    unchanged, requiring gradients."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a, dev).requires_grad_(), dict(tree))


def train_state_from_numpy(state, cfg=None,
                           device: str | torch.device | None = None
                           ) -> TrainState:
    """The port's ``TrainState`` from the reference's with numpy leaves,
    on ``device`` (the GPU unless ``device="cpu"``): the params the
    recommender ``recsys_from_numpy`` builds for ``cfg`` (the LM
    ``lm_from_numpy`` builds for an ``LMConfig``), or where ``cfg``
    is None a tree of tensors that require gradients; the optimizer state an
    ``AdamState`` (fields step, m, v), a ``FactorState`` (step, vr, vc) or
    a momentum tree; the residuals a tree, or None."""
    dev = resolve_device(device)
    step, params, opt_state, residuals = state

    def tensors(tree):
        return tree_map(lambda a: _tensor(a, dev), tree)

    if cfg is None:
        params = tree_map(lambda a: _tensor(a, dev).requires_grad_(), params)
    elif isinstance(cfg, LMConfig):
        params = lm_from_numpy(params, cfg, dev)
    else:
        params = recsys_from_numpy(params, cfg, dev)
    fields = getattr(opt_state, "_fields", None)
    if fields == AdamState._fields:
        opt_state = AdamState(*(tensors(x) for x in opt_state))
    elif fields == FactorState._fields:
        opt_state = FactorState(*(tensors(x) for x in opt_state))
    else:
        opt_state = tensors(opt_state)
    return TrainState(_tensor(step, dev), params, opt_state,
                      tensors(residuals))
