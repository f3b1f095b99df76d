"""Admission control and request lifecycle for the serving runtime.

The port's copy of ``repro/runtime/admission.py``, unchanged in substance:
the module is pure Python, but the reference's ``repro.runtime`` package
imports JAX, so the port keeps its own copy.

  * :class:`AdmissionQueue` — a bounded queue with a load-shedding
    watermark: ``submit`` answers :data:`ACCEPTED` or :data:`SHED`, and
    queued requests whose deadline lapses before a slot frees are expired
    in place.
  * :class:`LifecycleTracker` — the conservation ledger: every submitted
    request id terminates in **exactly one** of the four terminal states
    (:data:`COMPLETED` / :data:`SHED` / :data:`TIMED_OUT` /
    :data:`FAILED`); a second terminal transition or an untracked rid is a
    :class:`LifecycleError`.
  * :class:`Backoff` — retry-with-exponential-backoff for *transient*
    transfer faults (an :class:`~repro_torch.runtime.faults.InjectedFault`,
    a :class:`~repro_torch.core.TransferTimeout`); permanent errors
    propagate on the first attempt.
  * :class:`RequestTimeout` — the typed expiry a deadline produces,
    carried on the request instead of thrown through the serve loop.
  * :class:`ServeStats` — the degradation ledger: shed/timeout/retry/
    fallback counts the server reports instead of degrading silently.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

# -- admission verdicts and terminal request states -------------------------

ACCEPTED = "accepted"     # admission verdict: queued, will reach a slot
SHED = "shed"             # admission verdict AND terminal state: load shed

QUEUED = "queued"         # waiting for a slot
ACTIVE = "active"         # decoding in a slot
COMPLETED = "completed"   # terminal: finished its tokens (or EOS)
TIMED_OUT = "timed_out"   # terminal: deadline lapsed (queued or active)
FAILED = "failed"         # terminal: non-recoverable fault, typed error set

TERMINAL_STATES = (COMPLETED, SHED, TIMED_OUT, FAILED)


class RequestTimeout(TimeoutError):
    """A request's deadline lapsed before it finished.  Attached as the
    request's typed ``error`` when the tracker moves it to
    :data:`TIMED_OUT` — expiry is a terminal state, not a crash."""

    def __init__(self, rid: int, deadline_s: float, where: str = "queued"):
        super().__init__(
            f"request {rid} exceeded its {deadline_s:.3f}s deadline "
            f"while {where}")
        self.rid = rid
        self.deadline_s = deadline_s
        self.where = where


class LifecycleError(RuntimeError):
    """A broken request-lifecycle invariant: a duplicate rid, a terminal
    transition on an untracked request, or a SECOND terminal transition.
    This error firing in tests is the conservation proof doing its job."""


# -- the bounded queue ------------------------------------------------------

class AdmissionQueue:
    """Bounded FIFO admission queue with a load-shedding watermark.

    ``capacity`` is the hard bound (the queue physically never holds more);
    ``shed_watermark`` (default: capacity) is where backpressure starts —
    ``submit`` answers :data:`SHED` once depth reaches it.  A watermark
    below capacity leaves headroom for in-flight retries without accepting
    new work.  ``high_water`` records the maximum depth ever observed, the
    witness for the "queue never exceeds its bound" property."""

    def __init__(self, capacity: int = 1024,
                 shed_watermark: Optional[int] = None):
        if int(capacity) < 1:
            raise ValueError(f"queue capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        watermark = capacity if shed_watermark is None else int(shed_watermark)
        if watermark < 1:
            raise ValueError(f"shed watermark must be >= 1, got {watermark}")
        self.shed_watermark = min(watermark, self.capacity)
        self.high_water = 0
        self._q: "collections.deque[Any]" = collections.deque()

    def __len__(self) -> int:
        return len(self._q)

    def submit(self, req: Any) -> str:
        """Admit or shed: :data:`ACCEPTED` and enqueued, or :data:`SHED`
        (the request is NOT retained — shedding is the caller's signal to
        terminate it, immediately and typed)."""
        if len(self._q) >= self.shed_watermark:
            return SHED
        self._q.append(req)
        self.high_water = max(self.high_water, len(self._q))
        return ACCEPTED

    def peek(self, n: int) -> List[Any]:
        """The next ``n`` requests WITHOUT removing them — refill stages
        against a peek and only :meth:`pop`\\ s after the transfer commits,
        so an unwound fault loses nothing."""
        return list(itertools.islice(self._q, max(0, n)))

    def pop(self, n: int) -> List[Any]:
        return [self._q.popleft() for _ in range(min(max(0, n), len(self._q)))]

    def expire(self, now: float) -> List[Any]:
        """Remove and return every queued request whose deadline has lapsed
        (``submitted_at + deadline_s < now``); order is preserved for the
        survivors."""
        expired: List[Any] = []
        keep: List[Any] = []
        for req in self._q:
            deadline = getattr(req, "deadline_s", None)
            if deadline is not None and now > req.submitted_at + deadline:
                expired.append(req)
            else:
                keep.append(req)
        if expired:
            self._q = collections.deque(keep)
        return expired

    def snapshot(self) -> List[Any]:
        return list(self._q)


# -- retry with exponential backoff ----------------------------------------

@dataclasses.dataclass
class Backoff:
    """Retry-with-exponential-backoff for transient transfer faults.

    ``call(fn, transient=...)`` runs ``fn`` up to ``1 + max_retries``
    times; only exceptions matching ``transient`` are retried, after
    sleeping ``base_s * factor**attempt`` (``base_s=0`` disables sleeping —
    deterministic tests).  ``on_retry(error, attempt)`` fires before each
    retry so the caller can book it in :class:`ServeStats`.  The final
    transient error propagates typed — never swallowed."""

    max_retries: int = 3
    base_s: float = 1e-4
    factor: float = 2.0
    sleep: Callable[[float], None] = time.sleep

    def call(self, fn: Callable[[], Any],
             transient: Tuple[type, ...],
             on_retry: Optional[Callable[[BaseException, int], None]] = None
             ) -> Any:
        attempt = 0
        while True:
            try:
                return fn()
            except transient as e:
                if attempt >= self.max_retries:
                    raise
                attempt += 1
                if on_retry is not None:
                    on_retry(e, attempt)
                delay = self.base_s * (self.factor ** (attempt - 1))
                if delay > 0:
                    self.sleep(delay)


# -- the conservation ledger ------------------------------------------------

class LifecycleTracker:
    """Every submitted request terminates in exactly one state.

    ``submit`` registers a rid (duplicates raise), ``terminate`` moves it
    to one of :data:`TERMINAL_STATES` — at most once, setting
    ``req.state`` / ``req.error`` / ``req.done`` — and :meth:`finished`
    returns the authoritative terminal list in termination order (what
    ``Server.run`` now returns instead of recomputing from a stale
    ``pending`` snapshot).  :meth:`assert_conserved` is the drained-server
    invariant: no submitted rid left open."""

    def __init__(self):
        self._known: Dict[int, Any] = {}
        self._terminal: "collections.OrderedDict[int, Any]" = \
            collections.OrderedDict()

    def submit(self, req: Any) -> None:
        if req.rid in self._known:
            raise LifecycleError(f"duplicate rid {req.rid}: already submitted")
        self._known[req.rid] = req

    def terminate(self, req: Any, state: str,
                  error: Optional[BaseException] = None) -> None:
        if state not in TERMINAL_STATES:
            raise LifecycleError(
                f"{state!r} is not a terminal state "
                f"(terminal: {', '.join(TERMINAL_STATES)})")
        if req.rid not in self._known:
            raise LifecycleError(
                f"rid {req.rid} was never submitted (lost-request bug)")
        prior = self._terminal.get(req.rid)
        if prior is not None:
            raise LifecycleError(
                f"rid {req.rid} already terminal in state {prior.state!r}; "
                f"refusing a second terminal transition to {state!r} "
                f"(duplicate-completion bug)")
        req.state = state
        req.error = error
        req.done = state == COMPLETED
        self._terminal[req.rid] = req

    def is_terminal(self, rid: int) -> bool:
        return rid in self._terminal

    def finished(self) -> List[Any]:
        return list(self._terminal.values())

    def open_rids(self) -> List[int]:
        return [rid for rid in self._known if rid not in self._terminal]

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {s: 0 for s in TERMINAL_STATES}
        for req in self._terminal.values():
            out[req.state] += 1
        return out

    def assert_conserved(self) -> None:
        """Raise :class:`LifecycleError` unless every submitted rid is in
        exactly one terminal state (exactly-once is already enforced by
        ``terminate``; this closes the no-losses half)."""
        open_ = self.open_rids()
        if open_:
            raise LifecycleError(
                f"{len(open_)} submitted request(s) never reached a "
                f"terminal state: rids {open_[:8]}"
                + ("..." if len(open_) > 8 else ""))


# -- the degradation ledger -------------------------------------------------

@dataclasses.dataclass
class ServeStats:
    """What the server did under pressure — shed, expired, retried, or
    degraded — reported, never silent."""

    submitted: int = 0
    accepted: int = 0
    shed: int = 0
    completed: int = 0
    timed_out: int = 0
    failed: int = 0
    decode_steps: int = 0
    prefill_batches: int = 0
    prefill_requests: int = 0
    tokens_generated: int = 0
    policy_fallbacks: int = 0
    queue_high_water: int = 0
    # transient-fault retries, keyed by fault point (e.g. serve.decode_step)
    retries: Dict[str, int] = dataclasses.field(default_factory=dict)
    # human-readable record of each policy degradation: "requested -> used"
    degradations: List[str] = dataclasses.field(default_factory=list)

    @property
    def terminal(self) -> int:
        return self.completed + self.shed + self.timed_out + self.failed

    @property
    def retries_total(self) -> int:
        return sum(self.retries.values())

    def record_retry(self, point: str) -> None:
        self.retries[point] = self.retries.get(point, 0) + 1

    def as_dict(self) -> Dict[str, Any]:
        out = dataclasses.asdict(self)
        out["terminal"] = self.terminal
        out["retries_total"] = self.retries_total
        return out
