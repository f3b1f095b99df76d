"""What the dry run's two counters skip, and how a kernel wrapper books its
card allocations on meta tensors.

The dry run (``launch/dryrun.py``) runs one position's step on meta
tensors under two ``TorchDispatchMode``\\ s of ``launch/hlo_analysis.py``:
``OpCounter`` (calls, FLOPs and bytes of every aten op) and
``MemoryCounter`` (the bytes of every storage an op creates, while it
lives).  On the card a kernel wrapper launches a CUDA kernel, which
dispatches no aten op and allocates only what the wrapper allocates
around it; on meta it runs its plain version instead, recorded by
autograd as any other ops (so the op counter counts what it always has,
the backward under remat included).  So on meta:

  * the plain version runs under :func:`unbooked`: its ops are counted
    and none of its temporaries is booked, nor anything autograd saves
    of them (the card's autograd Function saves only its inputs);
  * its outputs are booked by hand (:func:`book`): the card's kernel
    writes outputs of the same sizes, which live as long;
  * what the CUDA branch allocates beside them is made under
    :func:`memory_only`: booked, not counted;
  * when autograd records the call, :func:`on_backward` runs the card's
    backward (the Function's: the plain version recomputed in f32 and
    differentiated) under :func:`memory_only` as the backward reaches the
    plain version's outputs, on stand-ins of the saved inputs (shapes,
    strides and dtypes only, so nothing is kept alive that the card would
    free under remat); its storages are booked while they live, and then
    the plain version's own backward ops run, counted and booked, giving
    the gradients.

The collectives' results for positions other than position 0 on meta
are :func:`unbooked` too.  The switches are counts, so they nest; they
change what is counted, never what is computed.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

_PAUSED: Dict[str, int] = {"ops": 0, "memory": 0}
_COUNTERS: List = []        # the memory counters entered now, innermost last

Meta = Tuple[torch.Size, Optional[Tuple[int, ...]], torch.dtype]


def paused(kind: str) -> bool:
    """Whether the counter of ``kind`` (``"ops"`` or ``"memory"``) skips
    what is dispatched now."""
    return _PAUSED[kind] > 0


@contextlib.contextmanager
def _pause(*kinds: str) -> Iterator[None]:
    for k in kinds:
        _PAUSED[k] += 1
    try:
        yield
    finally:
        for k in kinds:
            _PAUSED[k] -= 1


def memory_only() -> contextlib.AbstractContextManager:
    """Book memory, count no ops: a kernel's allocations on the card."""
    return _pause("ops")


def unbooked() -> contextlib.AbstractContextManager:
    """Book no memory, count ops as ever: a plain version standing in for
    a kernel."""
    return _pause("memory")


def book(*tensors: torch.Tensor) -> None:
    """Book each tensor's storage in every memory counter entered now."""
    for counter in _COUNTERS:
        for t in tensors:
            counter.book(t)


def meta_of(t: torch.Tensor) -> Meta:
    """What :func:`standin` needs of ``t``: its shape, strides and
    dtype."""
    return t.size(), t.stride(), t.dtype


def standin(meta: Meta) -> torch.Tensor:
    """A meta tensor of ``meta``'s shape, strides (None: contiguous) and
    dtype, neither counted nor booked: a tensor the card holds anyway (a
    saved input, an incoming gradient)."""
    size, stride, dtype = meta
    with _pause("ops", "memory"):
        if stride is None:
            return torch.empty(size, dtype=dtype, device="meta")
        return torch.empty_strided(size, stride, dtype=dtype, device="meta")


def on_backward(outs: Sequence[torch.Tensor], fn: Callable[[], object]
                ) -> None:
    """Run ``fn`` under :func:`memory_only`, once, when the backward
    first reaches one of ``outs`` (a plain version's outputs), before
    their own backward ops; nothing when autograd did not record them.
    What ``fn`` returns is dropped."""
    nodes = [t.grad_fn for t in outs if t.grad_fn is not None]
    fired: List[bool] = []

    def prehook(grad_outputs):
        if not fired:
            fired.append(True)
            with memory_only():
                fn()

    for node in nodes:
        node.register_prehook(prehook)


__all__ = ["paused", "memory_only", "unbooked", "book", "meta_of",
           "standin", "on_backward"]
