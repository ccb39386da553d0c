"""Optimizers (port of ``repro/train/optimizer.py``): optax-style
``(init, update)`` pairs over the reference's trees (``repro_torch.tree``:
dicts, lists, NamedTuples, and models standing for their params trees).

``update(grads, state, params) -> (updates, state)`` and
``apply_updates(params, updates)`` keep the reference's arithmetic, in f32
whatever the leaves' dtype: AdamW clips by the global norm first
(``max_grad_norm``, 1.0 by default), its bias corrections are
``1 - b**step`` in f32, and its weight decay and moment decay touch every
element of every leaf, tables included (a dense update: a lazy or sparse
one would give another result).  Adafactor factors the second moment of
leaves of rank >= 2.  SGDM reads ``lr(0)`` on every step.  The schedules
compute in f32 tensors.

Where the reference builds new trees, the port writes in place, as XLA
reuses a donated state's buffers: ``update`` writes the new moments into
the state's tensors (the returned state holds them, with a new step) and
``apply_updates`` adds the updates into the parameters; neither changes
``grads``.  The step counters are int32 tensors on the parameters' device,
so a step makes no host round trip.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map

F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable
    update: Callable   # (grads, state, params) -> (updates, state)


def _device(tree) -> torch.device:
    return leaves(tree)[0].device


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device(params))


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> Callable:
    def lr(step):
        step = torch.as_tensor(step, dtype=F32)
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clip((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi
                                                                   * t))
        return torch.where(step < warmup, warm, peak_lr * cos)
    return lr


def constant_schedule(lr_val: float) -> Callable:
    return lambda step: torch.tensor(lr_val, dtype=F32)


# ---------------------------------------------------------------------------
# global-norm clipping
# ---------------------------------------------------------------------------


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def _clip_scale(tree, max_norm: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(the factor ``clip_by_global_norm`` scales ``tree`` by, its norm)."""
    norm = global_norm(tree)
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0), norm


def clip_by_global_norm(tree, max_norm: float):
    scale, norm = _clip_scale(tree, max_norm)
    return tree_map(lambda x: (x * scale).to(x.dtype), tree), norm


def _scaled(g: torch.Tensor, scale) -> torch.Tensor:
    """``g`` clipped leaf by leaf (``clip_by_global_norm``'s rounding),
    as f32."""
    if scale is not None:
        g = (g * scale).to(g.dtype)
    return g.float()


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


class AdamState(NamedTuple):
    step: torch.Tensor
    m: dict
    v: dict


def adamw(lr: Callable, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, state_dtype: torch.dtype = F32,
          max_grad_norm: float = 1.0) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=state_dtype, device=p.device)
        return AdamState(_step0(params), tree_map(zeros, params),
                         tree_map(zeros, params))

    @torch.no_grad()
    def update(grads, state, params):
        scale = (_clip_scale(grads, max_grad_norm)[0] if max_grad_norm
                 else None)
        step = state.step + 1
        stepf = step.float()
        bc1 = 1 - b1 ** stepf
        bc2 = 1 - b2 ** stepf
        rate = lr(step)

        def upd(g, m, v, p):
            gf = _scaled(g, scale)
            mf = b1 * m.float() + (1 - b1) * gf
            vf = b2 * v.float() + (1 - b2) * gf * gf
            m.copy_(mf)
            v.copy_(vf)
            u = (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
            u = u + weight_decay * p.float()
            return (-rate * u).to(p.dtype)

        updates = tree_map(upd, grads, state.m, state.v, params)
        return updates, AdamState(step, state.m, state.v)

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments; the low-memory option for 400B)
# ---------------------------------------------------------------------------


class FactorState(NamedTuple):
    step: torch.Tensor
    vr: dict   # row second-moment (or full v for <2D leaves)
    vc: dict   # col second-moment (zeros for <2D leaves)


def adafactor(lr: Callable, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, weight_decay: float = 0.0
              ) -> Optimizer:
    def _factored(p):
        return p.dim() >= 2

    def init(params):
        def vr0(p):
            shape = p.shape[:-1] if _factored(p) else p.shape
            return torch.zeros(shape, dtype=F32, device=p.device)

        def vc0(p):
            shape = (p.shape[:-2] + p.shape[-1:]) if _factored(p) else (1,)
            return torch.zeros(shape, dtype=F32, device=p.device)

        return FactorState(_step0(params), tree_map(vr0, params),
                           tree_map(vc0, params))

    @torch.no_grad()
    def update(grads, state, params):
        step = state.step + 1
        beta = 1.0 - step.float() ** (-decay)
        rate = lr(step)

        def upd(g, vr, vc, p):
            gf = g.float()
            g2 = gf * gf + eps
            if _factored(p):
                nvr = beta * vr + (1 - beta) * torch.mean(g2, dim=-1)
                nvc = beta * vc + (1 - beta) * torch.mean(g2, dim=-2)
                r = nvr / torch.clamp(torch.mean(nvr, dim=-1, keepdim=True),
                                      min=eps)
                u = gf / (torch.sqrt(r)[..., None]
                          * torch.sqrt(nvc)[..., None, :] + eps)
                vc.copy_(nvc)
            else:
                nvr = beta * vr + (1 - beta) * g2
                u = gf / (torch.sqrt(nvr) + eps)
            vr.copy_(nvr)
            rms = torch.sqrt(torch.mean(u * u) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (-rate * u).to(p.dtype)

        updates = tree_map(upd, grads, state.vr, state.vc, params)
        return updates, FactorState(step, state.vr, state.vc)

    return Optimizer(init, update)


def sgdm(lr: Callable, momentum: float = 0.9,
         max_grad_norm: float = 0.0) -> Optimizer:
    def init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                              device=p.device), params)

    @torch.no_grad()
    def update(grads, state, params):
        scale = (_clip_scale(grads, max_grad_norm)[0] if max_grad_norm
                 else None)
        rate = lr(0)

        def upd(g, m, p):
            m.copy_(momentum * m + _scaled(g, scale))
            return (-rate * m).to(p.dtype)

        return tree_map(upd, grads, state, params), state

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params, updates):
    """``params + updates`` leaf by leaf, written into ``params`` (returned)."""
    for p, u in zip(leaves(params), leaves(updates)):
        p.add_(u.to(p.dtype))
    return params
