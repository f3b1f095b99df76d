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
  * :class:`MemoryCounter`, a ``TorchDispatchMode`` that books the bytes
    of every new storage an op creates (a storage once, whatever its
    views; an in-place op or a view creates none) and drops them when the
    storage dies, keeping the running and the peak sum: what a caching
    allocator would hold for the same eager schedule, each storage
    rounded up to ``granule`` bytes;
  * :func:`memory_dict`, the reference's ``memory_analysis`` keys but
    ``generated_code_size_in_bytes`` (the port compiles no program).

On meta a kernel wrapper's plain version is counted by :class:`OpCounter`
and not booked, and what the kernel allocates on the card is booked and
not counted (``repro_torch._counting``).

The HLO text grammar (``_parse_collective``, ``_shape_bytes``,
``hlo_line_count``) is not carried over: there is no HLO text to parse.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .. import _counting
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
        if _counting.paused("ops"):
            return out
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


def _storage_key(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage while it lives: torch keeps one
    Python object an untyped storage (the dry run's meta storages all
    have data pointer 0)."""
    return id(t.untyped_storage())


class MemoryCounter(TorchDispatchMode):
    """The bytes of the storages that ops create while it is entered:
    ``live`` (those alive now) and ``peak`` (the largest ``live`` yet).

    An op's output creates a storage when its storage is none of its
    inputs' (views and in-place results share theirs) and is not booked
    yet; the storage's bytes, rounded up to ``granule``, join ``live``
    until it dies (``weakref.finalize`` on the untyped storage, which
    torch keeps as one Python object while the storage lives).  Storages
    made before the counter was entered (the step's arguments) are never
    booked, and neither is what an op allocates inside its kernel (meta
    kernels allocate nothing else).  :meth:`book` books a tensor's storage
    by hand (``repro_torch._counting.book`` in every counter entered)."""

    def __init__(self, granule: int = 1):
        super().__init__()
        self.granule = int(granule)
        self.live = 0
        self.peak = 0
        self._booked: Dict[int, int] = {}

    def nbytes(self, t: torch.Tensor) -> int:
        """The bytes ``t``'s storage is booked at: its size rounded up to
        ``granule``."""
        n = t.untyped_storage().nbytes()
        return -(-n // self.granule) * self.granule

    def book(self, t: torch.Tensor) -> None:
        """Book ``t``'s storage (once) until it dies."""
        storage = t.untyped_storage()
        key = id(storage)
        if key in self._booked:
            return
        n = self.nbytes(t)
        self._booked[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._booked.pop(key)

    def __enter__(self):
        _counting._COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _counting._COUNTERS.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _counting.paused("memory"):
            return out
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if outs:
            ins = {_storage_key(t) for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)}
            for t in outs:
                if _storage_key(t) not in ins:
                    self.book(t)
        return out


class StepMemory(NamedTuple):
    """What a step's trace books: ``output`` (the distinct storages of
    the outputs), ``alias`` (those of them that are arguments' storages)
    and ``peak`` (the largest live sum of the storages allocated during
    the step), in bytes."""

    output: int
    alias: int
    peak: int


def step_memory(counter: MemoryCounter, outputs: Any, arguments: Any
                ) -> StepMemory:
    """:class:`StepMemory` of a step run under ``counter``, from its
    ``outputs`` and its ``arguments`` (trees of tensors)."""
    args = {_storage_key(t) for t in tree_flatten(arguments)[0]
            if isinstance(t, torch.Tensor)}
    seen: Dict[int, int] = {}
    for t in tree_flatten(outputs)[0]:
        if isinstance(t, torch.Tensor):
            seen.setdefault(_storage_key(t), counter.nbytes(t))
    return StepMemory(output=sum(seen.values()),
                      alias=sum(n for k, n in seen.items() if k in args),
                      peak=counter.peak)


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


def memory_dict(argument_bytes: Optional[int] = None,
                step: Optional[StepMemory] = None) -> Dict[str, int]:
    """The reference's ``memory_analysis`` keys, one position's bytes:
    ``argument_size_in_bytes`` (its blocks of the arguments, from their
    placements) and, given the ``step``'s :class:`StepMemory`,
    ``output_size_in_bytes``, ``alias_size_in_bytes`` (outputs that are
    arguments' storages, written in place), ``peak_memory_in_bytes`` (the
    arguments plus the largest live sum during the step) and
    ``temp_size_in_bytes`` (peak less arguments and the outputs that are
    not aliases).  ``generated_code_size_in_bytes`` is not given: the
    port compiles no program."""
    if argument_bytes is None:
        return {}
    out = {"argument_size_in_bytes": int(argument_bytes)}
    if step is not None:
        peak = int(argument_bytes) + step.peak
        out.update(output_size_in_bytes=step.output,
                   alias_size_in_bytes=step.alias,
                   temp_size_in_bytes=peak - int(argument_bytes)
                   - step.output + step.alias,
                   peak_memory_in_bytes=peak)
    return out


__all__ = ["COLLECTIVE_OPS", "OpCounter", "MemoryCounter", "StepMemory",
           "step_memory", "cost_dict", "op_census", "stats_snapshot",
           "collective_stats", "memory_dict"]
