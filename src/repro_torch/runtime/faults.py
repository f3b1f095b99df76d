"""Deterministic fault injection.

The port's counterpart of ``repro/runtime/faults.py`` (the injector half):
a :class:`FaultInjector` raises :class:`InjectedFault` at named points
(:mod:`repro_torch.faultpoints`), once per point, at the configured
arrival (1-based).  Install it with :func:`injected` (tests) or
:func:`install` / :func:`deinstall`; the instrumented paths call
:func:`trip`, a no-op while no injector is installed.  The serve points
(``serve.prefill_pack``, ``serve.decode_step``, ``serve.slot_refill``,
``serve.policy_swap``) are threaded through
:mod:`repro_torch.runtime.serve`.  ``run_elastic`` and ``trajectory_diff``
wait for the training slice.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Mapping, Optional, Tuple, Union

from ..faultpoints import (CKPT_COMMIT, CKPT_GC, CKPT_PACK, CKPT_WRITE,  # noqa: F401
                           POINTS, RESTORE_H2D, SERVE_DECODE_STEP,
                           SERVE_POINTS, SERVE_POLICY_SWAP,
                           SERVE_PREFILL_PACK, SERVE_SLOT_REFILL)

_POINTS = frozenset(POINTS)


class InjectedFault(RuntimeError):
    """The simulated kill: raised by an installed injector at a named point."""

    def __init__(self, point: str, hit: int):
        super().__init__(f"injected fault at {point!r} (arrival {hit})")
        self.point = point
        self.hit = hit


class FaultInjector:
    """Raise :class:`InjectedFault` at named points, deterministically.

    ``FaultInjector("serve.decode_step")`` fires on the first arrival at that
    point; ``FaultInjector({"serve.decode_step": 2})`` on the second.  Each
    point fires at most once per injector.
    """

    def __init__(self, points: Union[str, Mapping[str, int]], at: int = 1):
        if isinstance(points, str):
            points = {points: at}
        for point, hit in points.items():
            if point not in _POINTS:
                raise ValueError(f"unknown injection point {point!r}; "
                                 f"known points: {', '.join(POINTS)}")
            if int(hit) < 1:
                raise ValueError(f"arrival index for {point!r} must be >= 1")
        self._at = {p: int(h) for p, h in points.items()}
        self._lock = threading.Lock()
        self.hits: Dict[str, int] = {}
        self.fired: List[Tuple[str, int]] = []

    def trip(self, point: str) -> None:
        # validated at the call site too: a typo'd point would otherwise
        # count arrivals that can never fire
        if point not in _POINTS:
            raise ValueError(f"unknown injection point {point!r}; "
                             f"known points: {', '.join(POINTS)}")
        with self._lock:
            self.hits[point] = hit = self.hits.get(point, 0) + 1
            want = self._at.get(point)
            if want is None or hit != want:
                return
            self.fired.append((point, hit))
        raise InjectedFault(point, hit)


_ACTIVE: Optional[FaultInjector] = None


def install(injector: FaultInjector) -> FaultInjector:
    """Make ``injector`` the process-wide active injector (one at a time)."""
    global _ACTIVE
    _ACTIVE = injector
    return injector


def deinstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def current() -> Optional[FaultInjector]:
    return _ACTIVE


def trip(point: str) -> None:
    """The hook the instrumented paths call: a no-op unless an injector is
    installed."""
    injector = _ACTIVE
    if injector is not None:
        injector.trip(point)


@contextlib.contextmanager
def injected(points: Union[str, Mapping[str, int]], at: int = 1):
    """``with injected("serve.decode_step") as inj: ...`` — install for a
    block."""
    injector = FaultInjector(points, at)
    install(injector)
    try:
        yield injector
    finally:
        deinstall()
