"""Deterministic fault injection.

The port's counterpart of ``repro/runtime/faults.py``: a
:class:`FaultInjector` raises :class:`InjectedFault` at named points
(:mod:`repro_torch.faultpoints`), once per point, at the configured
arrival (1-based).  Install it with :func:`injected` (tests) or
:func:`install` / :func:`deinstall`; the instrumented paths call
:func:`trip`, a no-op while no injector is installed.  The checkpoint
points (``ckpt.pack``, ``ckpt.write``, ``ckpt.commit``, ``ckpt.gc``) are
threaded through :mod:`repro_torch.checkpoint`, ``restore.h2d`` through
the train loop's restore, the serve points through
:mod:`repro_torch.runtime.serve`.

:func:`run_elastic` drives the elastic restart (train on an n-device mesh,
crash, restore onto m devices through a re-derived state policy), whose
trajectory :func:`trajectory_diff` holds bit for bit against an
uninterrupted run.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

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


# ---------------------------------------------------------------------------
# the elastic restart
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ElasticResult:
    """One elastic-restart episode: the resumed run's result plus the
    restart bookkeeping."""

    result: Any                 # TrainLoopResult of the resumed incarnation
    crash_step: int             # step the kill fired at
    restored_step: int          # durable step the new incarnation resumed from
    n_devices: int              # mesh size the stale policy was derived for
    m_devices: int              # surviving mesh size actually restored onto

    @property
    def restore_split(self) -> Optional[Dict[str, float]]:
        """The resumed run's restore wall split (load / reshard / h2d)."""
        splits = self.result.restore_splits
        return splits[0] if splits else None


class _ElasticCrash(RuntimeError):
    """Process death for ``run_elastic``: NOT a NodeFailure, so the loop
    propagates it instead of restarting in place."""


def run_elastic(train_step: Callable, init_state_fn: Callable[[], Any],
                data_fn: Callable[[int], Dict[str, Any]], num_steps: int, *,
                ckpt_dir: str, crash_step: int, n_devices: int,
                m_devices: int, ckpt_every: int = 4,
                policy_fn: Optional[Callable[[int], Any]] = None,
                max_restarts: int = 3, settle_timeout_s: float = 60.0,
                device: Any = None) -> ElasticResult:
    """Train on an n-device mesh, "crash", restore onto m devices.

    Two incarnations of :func:`repro_torch.runtime.loop.run` over one
    checkpoint directory: the first runs with ``policy_fn(n_devices)`` and
    is killed at ``crash_step`` by an exception the loop does not catch;
    the survivor gets the now-stale n-device policy plus
    ``mesh_size=m_devices``, re-derives the policy, stages the checkpoint
    through one compiled TransferProgram and resumes to ``num_steps``.
    ``device`` is the loop's (:func:`repro_torch.runtime.loop.run`): a
    mesh of positions given as a sequence of devices is the live mesh, so
    m > 1 restores replicate onto its first m positions."""
    from ..checkpoint import latest_step
    from . import loop as loop_lib
    if policy_fn is None:
        from .train import state_transfer_policy
        policy_fn = state_transfer_policy
    restored_step = (crash_step // ckpt_every) * ckpt_every
    if restored_step <= 0:
        raise ValueError(
            f"crash_step={crash_step} precedes the first checkpoint "
            f"(ckpt_every={ckpt_every}): nothing durable to restore")

    crashed = {"done": False}

    def crash(step: int) -> None:
        if step >= crash_step and not crashed["done"]:
            crashed["done"] = True
            raise _ElasticCrash(f"elastic kill at step {step}")

    try:
        loop_lib.run(train_step, init_state_fn, data_fn, num_steps,
                     ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                     failure_injector=crash,
                     state_policy=policy_fn(n_devices),
                     mesh_size=n_devices, max_restarts=max_restarts,
                     device=device)
    except _ElasticCrash:
        pass
    else:
        raise ValueError(f"crash_step={crash_step} >= num_steps={num_steps}: "
                         "the kill never fired")
    # the dead incarnation's writer may still be committing its last save:
    # observe the directory until the step known to be enqueued is durable
    deadline = time.monotonic() + settle_timeout_s
    while (latest_step(ckpt_dir) or -1) < restored_step:
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"checkpoint step {restored_step} never became durable in "
                f"{ckpt_dir} (latest: {latest_step(ckpt_dir)})")
        time.sleep(0.01)

    result = loop_lib.run(train_step, init_state_fn, data_fn, num_steps,
                          ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                          state_policy=policy_fn(n_devices),  # stale: dp{n}
                          mesh_size=m_devices, max_restarts=max_restarts,
                          device=device)
    return ElasticResult(result=result, crash_step=crash_step,
                         restored_step=restored_step,
                         n_devices=n_devices, m_devices=m_devices)


def trajectory_diff(reference_history: List[Dict[str, float]],
                    resumed_history: List[Dict[str, float]],
                    keys: Tuple[str, ...] = ("loss",)) -> List[str]:
    """Bit-exact comparison of the resumed run's metrics against the
    uninterrupted reference, matched per step.  Returns human-readable
    mismatch descriptions (empty == bit-identical trajectory)."""
    ref = {int(r["step"]): r for r in reference_history}
    bad: List[str] = []
    for rec in resumed_history:
        step = int(rec["step"])
        want = ref.get(step)
        if want is None:
            bad.append(f"step {step}: not in the reference run")
            continue
        for key in keys:
            if rec.get(key) != want.get(key):
                bad.append(f"step {step}: {key} {rec.get(key)!r} != "
                           f"reference {want.get(key)!r}")
    return bad
