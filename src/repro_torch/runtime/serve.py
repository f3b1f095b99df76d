"""Resilient policy-driven serving: continuous batching over a
TransferProgram-backed ServeState.

The port's counterpart of ``repro/runtime/serve.py``:

  * :func:`serve_transfer_policy` — params in the 128-aligned arena
    (``marshal+align128@dp1``: one device), the KV cache as a delta region,
    the slot table as pointer chains.  The whole ServeState stages through
    ONE compiled :class:`~repro_torch.core.TransferProgram` pass at install
    and swap time.
  * batched prefill through the arena path: a refill batch's prompts,
    lengths and slot ids pack into one program pass (``to_device_async`` +
    bounded ``result(timeout=)``); compute runs per sequence at its exact
    length, so tokens equal those of unbatched prefill; the per-sequence
    caches install into the slot cache with one in-place ``index_copy_`` per
    key on the slot axis.
  * the request lifecycle of :mod:`repro_torch.runtime.admission`: bounded
    admission (``submit`` -> ACCEPTED/SHED), typed deadlines, retry with
    backoff for transient faults, and a loud degradation ladder for a
    policy that cannot execute here.

Where the reference jits ``prefill`` / ``decode_step`` and the cache
install, the port calls them eagerly; on the card the model's norms and
attention run the hand-written kernels of :mod:`repro_torch.kernels`.  The
reference's host mirror (``jax.device_get``) is a CPU copy of the params,
and ``replicate_state`` is the identity on one device.

Fault points (:mod:`repro_torch.runtime.faults`): ``serve.prefill_pack``,
``serve.decode_step``, ``serve.slot_refill``, ``serve.policy_swap``.  Under
any of them every submitted request terminates in exactly one state.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core import engine as engine_lib
from ..core.policy import TransferPolicy, TransferTimeout
from ..core.sharded import live_mesh
from ..core.spec import UnsupportedSpecError
from ..core.treepath import tree_map
from ..models.registry import ModelApi
from . import faults as faults_lib
from .admission import (ACTIVE, COMPLETED, FAILED, QUEUED, SHED, TIMED_OUT,
                        AdmissionQueue, Backoff, LifecycleTracker,
                        RequestTimeout, ServeStats)

# errors worth retrying: an injected kill or a hung transfer barrier — not
# genuine model or shape errors, which propagate on the first attempt
TRANSIENT_FAULTS = (faults_lib.InjectedFault, TransferTimeout)


def serve_transfer_policy(dp_size: int = 1) -> TransferPolicy:
    """The ServeState placement policy: params in the 128-aligned
    persistent arena, the KV cache as a delta region, the slot table (and
    anything else) as declared pointer chains."""
    return TransferPolicy.parse(
        f"params/**=marshal+align128@dp{int(dp_size)}; "
        "cache/**=marshal+delta; **=pointerchain")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32
    max_new_tokens: int = 16
    eos_id: int = -1              # -1: never
    tokens_out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # lifecycle (admission.py): deadline is relative to submit time
    deadline_s: Optional[float] = None
    state: str = QUEUED
    error: Optional[BaseException] = None
    submitted_at: float = 0.0


class Server:
    """Continuous-batching server with admission control and a
    TransferProgram-backed ServeState, on ``device`` (the card unless
    ``"cpu"``).

    ``submit`` answers ``ACCEPTED`` or ``SHED``; ``tick`` runs one
    scheduler round (expire deadlines, refill free slots through the
    batched arena prefill, one batched decode step); ``run`` loops ticks and
    returns the lifecycle tracker's terminal list.  ``stats`` is the
    degradation ledger; ``swap_policy`` re-stages the live state under a new
    transfer policy without dropping requests."""

    def __init__(self, api: ModelApi, params, *, slots: int, max_seq: int,
                 policy: Optional[Any] = None, session=None,
                 max_queue: int = 1024, shed_watermark: Optional[int] = None,
                 max_retries: int = 3, backoff_base_s: float = 1e-4,
                 transfer_timeout_s: float = 30.0,
                 clock=time.monotonic, device: DeviceLike = None):
        self.api = api
        self.slots = slots
        self.max_seq = max_seq
        self.device = resolve_device(device)
        self.session = session if session is not None \
            else engine_lib.get_session()
        self.transfer_timeout_s = transfer_timeout_s
        self._clock = clock
        self.stats = ServeStats()
        self.tracker = LifecycleTracker()
        self._queue = AdmissionQueue(capacity=max_queue,
                                     shed_watermark=shed_watermark)
        self._backoff = Backoff(max_retries=max_retries, base_s=backoff_base_s)
        self.active: List[Optional[Request]] = [None] * slots

        # host-side ServeState mirror: the tree the program compiles
        # against and the snapshot a policy swap re-stages from
        self._host_state: Dict[str, Any] = {
            "params": tree_map(lambda t: t.detach().to("cpu"), params),
            "cache": api.init_cache(slots, max_seq, device="cpu"),
            "slots": {"rid": torch.full((slots,), -1, dtype=torch.int32),
                      "pos": torch.zeros((slots,), dtype=torch.int32)},
        }
        # prompt-pack programs, keyed by (batch, padded length) bucket
        self._pack_programs: Dict[Tuple[int, int], Any] = {}

        self.policy: Optional[TransferPolicy] = None
        self.program = None
        self.params = None
        self.cache = None
        requested = serve_transfer_policy() if policy is None \
            else TransferPolicy.parse(policy)
        self._install_policy(requested)

    # -- admission -----------------------------------------------------------
    def submit(self, req: Request) -> str:
        """Admit or shed.  Shed requests terminate immediately (state
        ``shed``)."""
        self.stats.submitted += 1
        req.submitted_at = self._clock()
        self.tracker.submit(req)
        verdict = self._queue.submit(req)
        if verdict == SHED:
            self.tracker.terminate(req, SHED)
            self.stats.shed += 1
        else:
            self.stats.accepted += 1
        self.stats.queue_high_water = self._queue.high_water
        return verdict

    # -- policy install / swap ----------------------------------------------
    def _stage_state(self, policy: TransferPolicy):
        """One compiled program pass moving the whole ServeState."""
        faults_lib.trip(faults_lib.SERVE_POLICY_SWAP)
        program = self.session.compile(self._host_state, policy,
                                       device=live_mesh(self.device))
        return program, program.to_device(self._host_state)

    def _install_policy(self, requested: TransferPolicy) -> None:
        """Stage ServeState under ``requested``, walking the degradation
        ladder when it cannot execute here: requested -> reshard(the
        visible devices) -> unsharded.  Every rung below the top is counted
        and described in ``stats``."""
        k = torch.cuda.device_count() if self.device.type == "cuda" else 1
        ladder = [requested]
        if requested.num_shards > 1 and requested.num_shards != k:
            ladder.append(requested.reshard(max(1, k)))
        if ladder[-1].num_shards > 1:
            ladder.append(ladder[-1].reshard(1))
        last_err: Optional[BaseException] = None
        for rung, pol in enumerate(ladder):
            try:
                program, dev = self._backoff.call(
                    lambda p=pol: self._stage_state(p),
                    transient=TRANSIENT_FAULTS,
                    on_retry=lambda e, a: self.stats.record_retry(
                        "serve.policy_swap"))
            except (UnsupportedSpecError, NotImplementedError) as e:
                last_err = e
                continue
            if rung > 0:
                self.stats.policy_fallbacks += 1
                self.stats.degradations.append(
                    f"{requested} -> {pol} ({last_err})")
            self.policy = pol
            self.program = program
            self.params = dev["params"]
            self.cache = dev["cache"]
            return
        raise last_err

    def swap_policy(self, policy: Any) -> TransferPolicy:
        """Re-stage the LIVE ServeState under a new transfer policy without
        dropping requests: D2H under the current program, then install the
        new policy (the degradation ladder applies)."""
        requested = TransferPolicy.parse(policy)
        if self.program is not None:
            dev_tree = {"params": self.params, "cache": self.cache,
                        "slots": self._host_state["slots"]}
            self._host_state = self.program.from_device(dev_tree,
                                                        self._host_state)
        self._install_policy(requested)
        return self.policy

    # -- slot refill (batched arena prefill) ---------------------------------
    def _pack_program(self, tree: Dict[str, torch.Tensor]):
        key = tuple(tree["tokens"].shape)
        program = self._pack_programs.get(key)
        if program is None:
            program = self.session.compile(tree, TransferPolicy.of("marshal"),
                                           device=self.device)
            self._pack_programs[key] = program
        return program

    def _install_batch(self, caches: Sequence[Dict[str, torch.Tensor]],
                       slot_ids: torch.Tensor) -> None:
        """Install a refill batch's per-sequence caches into the slot cache
        in place: one ``index_copy_`` per key on the slot axis (axis 0 of
        ``pos``, axis 1 of the ``(L, B, ...)`` caches)."""
        # lint: allow=DC201 -- the refill's slot ids for index_copy_ (the reference scatters at host ints)
        index = slot_ids.to(device=self.device, dtype=torch.long)
        for key, val in self.cache.items():
            axis = 1 if val.dim() >= 2 and val.shape[1] == self.slots else 0
            val.index_copy_(axis, index,
                            torch.cat([c[key] for c in caches], dim=axis))

    def _prefill_pack(self, slot_ids: Sequence[int],
                      reqs: Sequence[Request]) -> List[int]:
        """Stage one refill batch through the arena path and prefill it.

        Prompts pad into a power-of-2 length bucket and ship — tokens,
        lengths and slot ids — as ONE async program pass with a bounded
        wait.  Compute then runs per sequence at its exact length, and the
        caches install in place.  Nothing here mutates server state before
        that install, so an unwound fault retries from a clean slate."""
        n = len(reqs)
        cap = 8
        while cap < max(len(r.prompt) for r in reqs):
            cap *= 2
        tokens = torch.zeros((n, cap), dtype=torch.int32)
        for j, req in enumerate(reqs):
            tokens[j, :len(req.prompt)] = torch.as_tensor(
                np.asarray(req.prompt, dtype=np.int32))
        pack = {"tokens": tokens,
                "lens": torch.tensor([len(r.prompt) for r in reqs],
                                     dtype=torch.int32),
                "slots": torch.tensor(list(slot_ids), dtype=torch.int32)}
        program = self._pack_program(pack)
        faults_lib.trip(faults_lib.SERVE_PREFILL_PACK)
        future = program.to_device_async(pack)
        dev = future.result(timeout=self.transfer_timeout_s)

        firsts: List[int] = []
        caches: List[Dict[str, torch.Tensor]] = []
        for j, req in enumerate(reqs):
            P = len(req.prompt)
            cache1 = self.api.init_cache(1, self.max_seq, device=self.device)
            logits, cache1 = self.api.prefill(
                self.params, dev["tokens"][j:j + 1, :P], cache1)
            firsts.append(int(torch.argmax(logits[0, -1])))
            caches.append(cache1)
        self._install_batch(caches, dev["slots"])
        return firsts

    def _refill(self, slot_ids: Sequence[int],
                reqs: Sequence[Request]) -> List[int]:
        faults_lib.trip(faults_lib.SERVE_SLOT_REFILL)
        return self._prefill_pack(slot_ids, reqs)

    def _fill_slots(self) -> None:
        free = [i for i in range(self.slots) if self.active[i] is None]
        if not free or not len(self._queue):
            return
        # peek, don't pop: the queue only commits after the transfer does
        batch = self._queue.peek(len(free))
        slot_ids = free[:len(batch)]
        try:
            firsts = self._backoff.call(
                lambda: self._refill(slot_ids, batch),
                transient=TRANSIENT_FAULTS,
                on_retry=lambda e, a: self.stats.record_retry(
                    e.point if isinstance(e, faults_lib.InjectedFault)
                    else "transfer.timeout"))
        except TRANSIENT_FAULTS as e:
            # retries exhausted: the implicated requests fail typed and the
            # server keeps serving; nothing was installed
            for req in self._queue.pop(len(batch)):
                self.tracker.terminate(req, FAILED, error=e)
                self.stats.failed += 1
            return
        self._queue.pop(len(batch))
        self.stats.prefill_batches += 1
        self.stats.prefill_requests += len(batch)
        for slot, req, first in zip(slot_ids, batch, firsts):
            req.tokens_out.append(first)
            req.state = ACTIVE
            self.active[slot] = req
            self._host_state["slots"]["rid"][slot] = req.rid
            self._host_state["slots"]["pos"][slot] = len(req.prompt)
            self.stats.tokens_generated += 1

    # -- decode --------------------------------------------------------------
    def _finish_active(self, slot: int, state: str,
                       error: Optional[BaseException] = None) -> None:
        req = self.active[slot]
        self.active[slot] = None
        self._host_state["slots"]["rid"][slot] = -1
        self._host_state["slots"]["pos"][slot] = 0
        self.tracker.terminate(req, state, error=error)

    def _expire(self, now: float) -> None:
        """Deadline pass, queued AND active: expiry is a typed terminal
        state, never a silent drop."""
        for req in self._queue.expire(now):
            self.tracker.terminate(
                req, TIMED_OUT,
                error=RequestTimeout(req.rid, req.deadline_s, "queued"))
            self.stats.timed_out += 1
        for i, req in enumerate(self.active):
            if (req is not None and req.deadline_s is not None
                    and now > req.submitted_at + req.deadline_s):
                self._finish_active(
                    i, TIMED_OUT,
                    error=RequestTimeout(req.rid, req.deadline_s, "active"))
                self.stats.timed_out += 1

    def step(self) -> None:
        """One batched decode step over all slots."""
        tokens = torch.zeros((self.slots, 1), dtype=torch.int32)
        for i, req in enumerate(self.active):
            if req is not None and req.tokens_out:
                tokens[i, 0] = req.tokens_out[-1]

        def dispatch():
            faults_lib.trip(faults_lib.SERVE_DECODE_STEP)
            logits, cache = self.api.decode_step(
                self.params, tokens.to(self.device), self.cache)
            return torch.argmax(logits[:, -1], dim=-1).cpu(), cache

        try:
            # the fault point comes before any write to the cache, so a
            # retried decode recomputes from the same cache
            next_tokens, self.cache = self._backoff.call(
                dispatch, transient=TRANSIENT_FAULTS,
                on_retry=lambda e, a: self.stats.record_retry(
                    "serve.decode_step"))
        except TRANSIENT_FAULTS as e:
            for i, req in enumerate(self.active):
                if req is not None:
                    self._finish_active(i, FAILED, error=e)
                    self.stats.failed += 1
            return
        self.stats.decode_steps += 1
        pos = self.cache["pos"].cpu()
        for i, req in enumerate(self.active):
            if req is None:
                continue
            tok = int(next_tokens[i])
            req.tokens_out.append(tok)
            self.stats.tokens_generated += 1
            if (tok == req.eos_id
                    or len(req.tokens_out) >= req.max_new_tokens
                    or int(pos[i]) >= self.max_seq - 1):
                self._finish_active(i, COMPLETED)
                self.stats.completed += 1

    # -- main loop -----------------------------------------------------------
    def tick(self) -> bool:
        """One scheduler round: expire lapsed deadlines, refill free slots,
        one batched decode step.  Returns True while work remains."""
        self._expire(self._clock())
        self._fill_slots()
        if not any(r is not None for r in self.active):
            return len(self._queue) > 0
        self.step()
        return True

    def run(self, max_steps: int = 1000) -> List[Request]:
        """Drive ticks until drained (or ``max_steps``); returns the
        tracker's terminal-state list, in termination order."""
        for _ in range(max_steps):
            if not self.tick():
                break
        return self.tracker.finished()
