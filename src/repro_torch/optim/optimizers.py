"""Optimizers, built from scratch: AdamW, Adafactor, SGDM.

The port's copy of ``repro/optim/optimizers.py``.  State trees mirror the
param tree (more pointer chains for the deep-copy engine: selective
checkpoint restore, host offload).  ``update(grads, state, params, lr)``
is functional: it returns new params and a new state, built from new
tensors, and writes none of its arguments in place — a staged parameter
or moment may be a view of a transfer bucket the engine retains, and an
in-place step would write into the bucket and move its write count.
The moments are float32 whatever the param dtype; the new param is
computed in float32 and cast back.

``axes`` derives the logical axes of every state leaf from the param
axes; ``abstract`` gives the state's shapes and dtypes
(:class:`~repro_torch.core.deepcopy.ShapeDtype` leaves) without data.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..core.deepcopy import ShapeDtype
from ..core.treepath import tree_flatten, tree_leaves, tree_map, tree_unflatten

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]                       # params -> state
    update: Callable[[Any, Any, Any, Any], Any]      # (grads, state, params, lr)
    #   -> (new_params, new_state)
    axes: Callable[[Any], Any]                       # param_axes -> state axes
    abstract: Callable[[Any], Any]                   # abstract params -> abstract state


def _zeros(p, shape=None) -> torch.Tensor:
    return torch.zeros(tuple(p.shape) if shape is None else shape, dtype=F32,
                       device=getattr(p, "device", None))


def _count0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves and hasattr(leaves[0], "device") else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def _sds(shape) -> ShapeDtype:
    return ShapeDtype(tuple(shape), F32)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    def init(params):
        return {"mu": tree_map(_zeros, params), "nu": tree_map(_zeros, params),
                "count": _count0(params)}

    def abstract(params):
        f32 = lambda p: _sds(p.shape)
        return {"mu": tree_map(f32, params), "nu": tree_map(f32, params),
                "count": ShapeDtype((), torch.int32)}

    def update(grads, state, params, lr):
        count = state["count"] + 1
        c = count.to(F32)
        bc1 = 1 - torch.pow(b1, c)
        bc2 = 1 - torch.pow(b2, c)

        def upd(g, m, v, p):
            g = g.to(F32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            mhat = m / bc1
            vhat = v / bc2
            step = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(F32)
            return (p.to(F32) - lr * step).to(p.dtype), m, v

        flat_p, treedef = tree_flatten(params)
        outs = [upd(g, m, v, p) for g, m, v, p in zip(
            tree_leaves(grads), tree_leaves(state["mu"]),
            tree_leaves(state["nu"]), flat_p)]
        return (tree_unflatten(treedef, [o[0] for o in outs]),
                {"mu": tree_unflatten(treedef, [o[1] for o in outs]),
                 "nu": tree_unflatten(treedef, [o[2] for o in outs]),
                 "count": count})

    def axes(param_axes):
        return {"mu": param_axes, "nu": param_axes, "count": ()}

    return Optimizer("adamw", init, update, axes, abstract)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no momentum)
# ---------------------------------------------------------------------------

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _is_v(x) -> bool:
    return isinstance(x, dict) and ("vr" in x or "v" in x)


def adafactor(eps=1e-30, clip_threshold=1.0, weight_decay=0.0,
              decay_rate=0.8) -> Optimizer:
    def _state_for(p, make):
        shape = tuple(p.shape)
        if _factored(shape):
            return {"vr": make(p, shape[:-1]),
                    "vc": make(p, shape[:-2] + shape[-1:])}
        return {"v": make(p, shape)}

    def _v_leaves(tree):
        # per-param v subtrees, in the params' leaf order
        if _is_v(tree):
            return [tree]
        if isinstance(tree, dict):
            return [v for k in sorted(tree) for v in _v_leaves(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [v for c in tree for v in _v_leaves(c)]
        raise TypeError(f"not an adafactor state tree: {type(tree)}")

    def init(params):
        return {"v": tree_map(lambda p: _state_for(p, _zeros), params),
                "count": _count0(params)}

    def abstract(params):
        return {"v": tree_map(lambda p: _state_for(
                    p, lambda _, sh: _sds(sh)), params),
                "count": ShapeDtype((), torch.int32)}

    def update(grads, state, params, lr):
        count = state["count"] + 1
        c = count.to(F32)
        beta = 1.0 - torch.pow(c, -decay_rate)

        def upd(g, v, p):
            g = g.to(F32)
            g2 = torch.square(g) + eps
            if _factored(tuple(p.shape)):
                vr = beta * v["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * v["vc"] + (1 - beta) * g2.mean(dim=-2)
                rfac = torch.rsqrt(
                    vr / torch.clamp_min(vr.mean(-1, keepdim=True), eps))
                cfac = torch.rsqrt(vc)
                u = g * rfac[..., None] * cfac[..., None, :]
                newv = {"vr": vr, "vc": vc}
            else:
                nv = beta * v["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(nv)
                newv = {"v": nv}
            rms = torch.sqrt(torch.square(u).mean() + 1e-12)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            newp = (p.to(F32) - lr * u
                    - lr * weight_decay * p.to(F32)).to(p.dtype)
            return newp, newv

        flat_p, treedef = tree_flatten(params)
        outs = [upd(g, v, p) for g, v, p in zip(
            tree_leaves(grads), _v_leaves(state["v"]), flat_p)]
        return (tree_unflatten(treedef, [o[0] for o in outs]),
                {"v": tree_unflatten(treedef, [o[1] for o in outs]),
                 "count": count})

    def axes(param_axes):
        def ax(a):
            a = tuple(a)
            if len(a) >= 2:
                return {"vr": a[:-1], "vc": a[:-2] + a[-1:]}
            return {"v": a}
        return {"v": _map_axes(ax, param_axes), "count": ()}

    return Optimizer("adafactor", init, update, axes, abstract)


def _map_axes(fn, tree):
    """``fn`` over an axes tree whose leaves are tuples."""
    if isinstance(tree, tuple):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_axes(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_map_axes(fn, c) for c in tree]
    raise TypeError(f"not an axes tree: {type(tree)}")


# ---------------------------------------------------------------------------
# SGD + momentum (baseline)
# ---------------------------------------------------------------------------

def sgdm(momentum=0.9) -> Optimizer:
    def init(params):
        return {"mu": tree_map(_zeros, params)}

    def abstract(params):
        return {"mu": tree_map(lambda p: _sds(p.shape), params)}

    def update(grads, state, params, lr):
        def upd(g, m, p):
            m = momentum * m + g.to(F32)
            return (p.to(F32) - lr * m).to(p.dtype), m
        flat_p, treedef = tree_flatten(params)
        outs = [upd(g, m, p) for g, m, p in zip(
            tree_leaves(grads), tree_leaves(state["mu"]), flat_p)]
        return (tree_unflatten(treedef, [o[0] for o in outs]),
                {"mu": tree_unflatten(treedef, [o[1] for o in outs])})

    def axes(param_axes):
        return {"mu": param_axes}

    return Optimizer("sgdm", init, update, axes, abstract)


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    if name == "sgdm":
        return sgdm(**kw)
    if name == "adamw8bit":
        from .quantized import adamw8bit
        return adamw8bit(**kw)
    raise KeyError(f"unknown optimizer {name!r}")
