"""Op and collective counts of a step: the port's counterpart of
``repro/launch/hlo_analysis.py``.

The reference reads XLA's numbers: ``compiled.cost_analysis()`` for FLOPs
and bytes, and the compiled HLO text for its collectives.  The port emits
no HLO and has no ``cost_analysis``, so this module reads what it does
have:

  * :class:`OpCounter`, a ``TorchDispatchMode`` that records every aten op
    dispatched under it: its calls, its FLOPs (by the formulas of
    ``torch.utils.flop_counter``, which price the matmuls, convolutions
    and fused attentions; every other op counts 0 FLOPs, as XLA's
    elementwise ops count next to nothing beside them), and the bytes of
    its inputs and outputs, each tensor counted once an op.  Eager PyTorch
    dispatches every trip of a Python loop, so a layer stack is counted
    whole, where XLA counts a ``while`` body once;
  * :func:`collective_stats`, the reference's ``per_op`` / ``total_bytes``
    / ``total_count`` shape, filled from deltas of
    ``core.collectives.STATS`` (one position's operand a call): ``psum``
    and ``pmean`` are all-reduce, ``psum_scatter`` reduce-scatter,
    ``all_gather`` all-gather and ``all_to_all`` all-to-all;
  * :func:`memory_dict`, with only the keys the port can read.

The HLO text grammar (``_parse_collective``, ``_shape_bytes``,
``hlo_line_count``) is not carried over: there is no HLO text to parse.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..core import collectives

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

# core.collectives kinds -> the reference's HLO collective names
_KIND_TO_OP = {"psum": "all-reduce", "pmean": "all-reduce",
               "pmax": "all-reduce", "psum_scatter": "reduce-scatter",
               "all_gather": "all-gather", "all_to_all": "all-to-all"}


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Per aten op: ``calls``, ``flops`` and ``bytes`` (inputs + outputs,
    each distinct tensor once an op).  Use as a context manager; it may be
    entered several times and accumulates."""

    def __init__(self):
        super().__init__()
        self.calls: Dict[str, int] = {}
        self.flops: Dict[str, int] = {}
        self.bytes: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func.overloadpacket)
        formula = flop_counter.flop_registry.get(func.overloadpacket)
        flops = int(formula(*args, **kwargs, out_val=out)) if formula else 0
        seen, nbytes = set(), 0
        for t in tree_flatten((args, kwargs, out))[0]:
            if isinstance(t, torch.Tensor) and id(t) not in seen:
                seen.add(id(t))
                nbytes += _bytes(t)
        self.calls[name] = self.calls.get(name, 0) + 1
        self.flops[name] = self.flops.get(name, 0) + flops
        self.bytes[name] = self.bytes.get(name, 0) + nbytes
        return out

    @property
    def total_flops(self) -> int:
        return sum(self.flops.values())

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes.values())


def cost_dict(counter: OpCounter) -> Dict[str, float]:
    """The counter as the reference's flat ``cost_analysis`` keys."""
    return {"flops": float(counter.total_flops),
            "bytes accessed": float(counter.total_bytes)}


def op_census(counter: OpCounter, top: int = 25) -> Dict[str, int]:
    """The most-called ops and their calls (the reference's instruction
    census, over dispatched aten ops)."""
    return dict(sorted(counter.calls.items(), key=lambda kv: -kv[1])[:top])


def stats_snapshot() -> Dict[str, Dict[str, int]]:
    """``core.collectives.STATS`` now, to diff against later."""
    return {"calls": dict(collectives.STATS.calls),
            "bytes": dict(collectives.STATS.bytes)}


def collective_stats(before: Dict[str, Dict[str, int]],
                     after: Optional[Dict[str, Dict[str, int]]] = None
                     ) -> Dict[str, Any]:
    """Per-op-kind count and bytes (one position's operand a call) of the
    collectives run between two :func:`stats_snapshot`\\ s (``after``
    defaults to now), in the reference's shape."""
    after = after or stats_snapshot()
    stats: Dict[str, Dict[str, float]] = {
        op: {"count": 0, "bytes": 0} for op in COLLECTIVE_OPS}
    for kind, op in _KIND_TO_OP.items():
        stats[op]["count"] += after["calls"].get(kind, 0) - \
            before["calls"].get(kind, 0)
        stats[op]["bytes"] += after["bytes"].get(kind, 0) - \
            before["bytes"].get(kind, 0)
    return {"per_op": stats,
            "total_bytes": sum(s["bytes"] for s in stats.values()),
            "total_count": sum(s["count"] for s in stats.values())}


def memory_dict(argument_bytes: Optional[int] = None) -> Dict[str, int]:
    """The memory keys the port can read: ``argument_size_in_bytes`` (one
    position's blocks of the arguments, from their placements).  Meta
    tensors hold no memory, so ``temp_size_in_bytes`` and
    ``peak_memory_in_bytes`` are not given."""
    return {} if argument_bytes is None \
        else {"argument_size_in_bytes": int(argument_bytes)}


__all__ = ["COLLECTIVE_OPS", "OpCounter", "cost_dict", "op_census",
           "stats_snapshot", "collective_stats", "memory_dict"]
