"""8-bit optimizer moments, and optimizer state offloaded to the host.

The port's copy of ``repro/optim/quantized.py``.  :func:`adamw8bit` keeps
mu and nu as int8 + per-block float32 scales (2 bytes a param instead of
8); nu is stored in sqrt-space, as in the reference.  Dequantize, update
and requantize happen inside ``update``, so the float32 moments exist only
transiently.

:class:`OffloadedOptimizer` keeps the optimizer state on the HOST and
moves it to the device around every update under a transfer scheme (the
paper's schemes applied to the state tree): ``uvm`` one leaf per copy,
``marshal`` one copy per dtype bucket.  Its ``scheme.ledger`` books the
step's host-to-device motion, field for field the reference's.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from .._device import DeviceLike
from ..core.deepcopy import ShapeDtype
from ..core.treepath import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .optimizers import Optimizer, _count0, _map_axes

BLOCK = 256
F32 = torch.float32


def _blocks(shape) -> int:
    n = math.prod(shape) if shape else 1
    return -(-n // BLOCK)


def _q_abstract(shape) -> Dict[str, Any]:
    b = _blocks(tuple(shape))
    return {"q": ShapeDtype((b * BLOCK,), torch.int8),
            "scale": ShapeDtype((b,), F32)}


def _quantize(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1) / 127.0 + 1e-20
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127
                    ).to(torch.int8)
    return {"q": q.reshape(-1), "scale": scale}


def _dequantize(s: Dict[str, torch.Tensor], shape) -> torch.Tensor:
    n = math.prod(shape) if shape else 1
    blocks = s["q"].reshape(-1, BLOCK).to(F32)
    out = (blocks * s["scale"][:, None]).reshape(-1)[:n]
    return out.reshape(tuple(shape))


def _is_q(x) -> bool:
    return isinstance(x, dict) and "q" in x and "scale" in x


def _q_leaves(tree):
    """The per-param quantized state dicts, in the params' leaf order."""
    if _is_q(tree):
        return [tree]
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _q_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for c in tree for v in _q_leaves(c)]
    raise TypeError(f"not a quantized state tree: {type(tree)}")


def adamw8bit(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    def zeros_q(p):
        return _quantize(torch.zeros(tuple(p.shape), dtype=F32,
                                     device=p.device))

    def init(params):
        return {"mu": tree_map(zeros_q, params),
                "nu": tree_map(zeros_q, params),
                "count": _count0(params)}

    def abstract(params):
        return {"mu": tree_map(lambda p: _q_abstract(p.shape), params),
                "nu": tree_map(lambda p: _q_abstract(p.shape), params),
                "count": ShapeDtype((), torch.int32)}

    def update(grads, state, params, lr):
        count = state["count"] + 1
        c = count.to(F32)
        bc1 = 1 - torch.pow(b1, c)
        bc2 = 1 - torch.pow(b2, c)

        def upd(g, m_q, v_q, p):
            shape = tuple(p.shape)
            g = g.to(F32)
            m = b1 * _dequantize(m_q, shape) + (1 - b1) * g
            v_prev = torch.square(_dequantize(v_q, shape))
            v = b2 * v_prev + (1 - b2) * torch.square(g)
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps) \
                + weight_decay * p.to(F32)
            newp = (p.to(F32) - lr * step).to(p.dtype)
            return newp, _quantize(m), _quantize(torch.sqrt(v))

        flat_p, treedef = tree_flatten(params)
        outs = [upd(g, m, v, p) for g, m, v, p in zip(
            tree_leaves(grads), _q_leaves(state["mu"]),
            _q_leaves(state["nu"]), flat_p)]
        return (tree_unflatten(treedef, [o[0] for o in outs]),
                {"mu": tree_unflatten(treedef, [o[1] for o in outs]),
                 "nu": tree_unflatten(treedef, [o[2] for o in outs]),
                 "count": count})

    def axes(param_axes):
        ax = lambda _: {"q": (None,), "scale": (None,)}
        return {"mu": _map_axes(ax, param_axes),
                "nu": _map_axes(ax, param_axes), "count": ()}

    return Optimizer("adamw8bit", init, update, axes, abstract)


# ---------------------------------------------------------------------------
# host-offloaded optimizer state (the transfer schemes applied to it)
# ---------------------------------------------------------------------------

def _to_host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


class OffloadedOptimizer:
    """Keep optimizer state on the HOST; fetch it around each update.

    ``scheme_name`` is any TransferSpec string: ``uvm`` moves one leaf per
    copy (demand paging, materialized before the update), ``marshal``
    packs the state into per-dtype arenas and moves one buffer each.  A
    fresh scheme (so a fresh ledger) is made per step, as in the
    reference; the new state comes back to the host as plain copies.
    ``device`` is where the update runs (the card unless ``"cpu"``)."""

    def __init__(self, inner: Optimizer, scheme_name: str = "marshal",
                 device: DeviceLike = None):
        from ..core import transfer_scheme
        self.inner = inner
        self.scheme_name = scheme_name
        self.device = device
        self.scheme = transfer_scheme(scheme_name, device=device)
        self._host_state: Any = None

    def init(self, params) -> None:
        self._host_state = tree_map(_to_host, self.inner.init(params))

    def step(self, grads, params, lr):
        from ..core import transfer_scheme
        self.scheme = transfer_scheme(self.scheme_name, device=self.device)
        dev_state = self.scheme.to_device(self._host_state)
        if self.scheme.name == "uvm":
            dev_state = self.scheme.materialize(dev_state)
        new_params, new_state = self.inner.update(grads, dev_state, params,
                                                  lr)
        self._host_state = tree_map(_to_host, new_state)
        return new_params
