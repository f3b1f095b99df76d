"""Path-scoped transfer policies — per-subtree specs compiled into ONE
program.

Counterpart of ``repro/core/policy.py``:

  * :class:`PolicyRule`      — a frozen (path pattern, TransferSpec) pair.
  * :class:`TransferPolicy`  — an ordered rule set with a required default
    (``**``) rule; the most specific matching pattern wins per leaf.
  * :class:`TransferProgram` — the compiled artifact
    (``TransferSession.compile(tree, policy)``): the tree's leaves
    partitioned into regions (every leaf in exactly one), one scheme
    executor per region over the session's caches, and a ``to_device`` pass
    that enqueues EVERY region's copies before ONE synchronize.

Pattern grammar (the reference's, unchanged)::

    policy  := rule (';' rule)*
    rule    := pattern '=' spec
    pattern := '**' | part ('/' part)* ('/**')?
    part    := name index* | '[' INT ']' | '*'

``*`` matches exactly one path step, a trailing ``**`` any remaining
suffix (including none), and ``kids[2]`` is the two steps ``kids`` then
``[2]``.  ``str``/``parse`` round-trip exactly; a bare spec string parses
as the one-rule policy ``**=<spec>``.  Matching: the longest fixed prefix
wins, then the most literal steps, then an exact pattern over a ``**`` one,
then declaration order.

On the card every region enqueues its copies on its devices' copy streams
without waiting (``begin_pass``); the program then records one CUDA event
on the copy stream of every device the program copies to, after the last
enqueue (stream order makes each complete only after every copy of the
pass on its device), and waits on them as ONE barrier that covers the
whole mesh.  The staging
buffers are fenced per bucket by their own copies' events, so the barrier
is a latency choice, not what keeps staging safe.
:meth:`TransferProgram.to_device_async` returns a :class:`ProgramFuture`
instead of waiting; its ``result(timeout)`` polls the event up to the
deadline (no thread) and raises :class:`TransferTimeout` when it passes.

The bounded candidate grid of the cost model and the autotuner is the
reference's: :func:`candidate_specs`, :func:`enumerate_policies`,
:meth:`TransferPolicy.with_rule` and :meth:`TransferPolicy.neighbors`
give the same specs and policies in the same order.

``@dp1`` rules execute on one device, as in the reference; a sharded rule
(``@dpK``, K > 1) executes on the program's mesh (``device``: the default
mesh, ``"cpu"`` for K positions on the CPU, or a sequence of devices),
its unsharded rules on the mesh's first position (``@devN``: its
position N).  A mesh too short for a rule raises the stale-mesh
:class:`UnsupportedPolicyError`, naming the rule, which
:meth:`TransferPolicy.reshard` recovers from.

The staging race sanitizer sees a pass as the reference's does: the
regions enqueue inside an enqueue half (a barrier there is DC304), the
pass's one barrier reports ``on_sync`` (the blocking pass before it
waits; the future when it first sees the barrier complete, outside any
enqueue half, where the reference's sync thread reports it), and every
materialized pass reports its stats.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from .. import _device
from ..analysis import sanitizer as _sanitizer
from . import sharded as sharded_lib
from .spec import TransferSpec, UnsupportedSpecError
from .treepath import TreeDef, TreePath, _parse as _parse_steps
from .treepath import leaf_paths, tree_flatten, tree_leaves


class UnsupportedPolicyError(UnsupportedSpecError):
    """The canonical error for any invalid policy: unparseable rule text,
    a rule spec off the capability matrix, or a policy-level conflict
    (duplicate patterns, missing ``**`` default, overlapping shard axes)."""


class TransferTimeout(TimeoutError):
    """A bounded wait on an asynchronous program pass expired before its
    copies completed.  The pass is left un-materialized (no finish
    bookkeeping ran), so ``result()`` may simply be retried."""

    def __init__(self, waited_s: float, detail: str = ""):
        msg = (f"async program pass still pending after {waited_s:.3f}s"
               + (f" ({detail})" if detail else ""))
        super().__init__(msg)
        self.waited_s = waited_s


# ---------------------------------------------------------------------------
# patterns
# ---------------------------------------------------------------------------

def _pattern_parse(pattern: str) -> Tuple[Tuple[Any, ...], bool]:
    """``pattern`` -> (fixed steps, has trailing globstar)."""
    text = pattern.strip()
    if not text:
        raise UnsupportedPolicyError("empty path pattern")
    parts = text.split("/")
    globstar = parts[-1] == "**"
    if globstar:
        parts = parts[:-1]
    steps: List[Any] = []
    for part in parts:
        if part == "**":
            raise UnsupportedPolicyError(
                f"cannot parse pattern {pattern!r}: '**' is only allowed as "
                "the trailing part")
        if part == "*":
            steps.append("*")
            continue
        if not part:
            raise UnsupportedPolicyError(
                f"cannot parse pattern {pattern!r}: empty step")
        try:
            steps.extend(_parse_steps(part))
        except ValueError as e:
            raise UnsupportedPolicyError(
                f"cannot parse pattern {pattern!r}: {e}") from None
    if not steps and not globstar:
        raise UnsupportedPolicyError(
            f"cannot parse pattern {pattern!r}: no steps")
    return tuple(steps), globstar


def _pattern_str(steps: Tuple[Any, ...], globstar: bool) -> str:
    """Canonical string form: int steps print attached (``kids[2]``)."""
    out: List[str] = []
    for step in steps:
        if isinstance(step, int):
            if out:
                out[-1] += f"[{step}]"
            else:
                out.append(f"[{step}]")
        else:
            out.append(step)
    if globstar:
        out.append("**")
    return "/".join(out)


@dataclasses.dataclass(frozen=True)
class PolicyRule:
    """One (path pattern -> TransferSpec) point of a policy.  Frozen and
    hashable; the pattern and the spec are canonicalized."""

    pattern: str
    spec: TransferSpec

    def __post_init__(self):
        steps, globstar = _pattern_parse(self.pattern)
        object.__setattr__(self, "pattern", _pattern_str(steps, globstar))
        object.__setattr__(self, "spec", TransferSpec.parse(self.spec))
        object.__setattr__(self, "_steps", steps)
        object.__setattr__(self, "_globstar", globstar)
        object.__setattr__(
            self, "_specificity",
            (len(steps), sum(1 for s in steps if s != "*"),
             0 if globstar else 1))

    def _match_steps(self, got: Tuple[Any, ...]) -> bool:
        steps = self._steps
        if (len(got) < len(steps)) if self._globstar \
                else (len(got) != len(steps)):
            return False
        return all(p == "*" or p == s for p, s in zip(steps, got))

    def matches(self, path: Union[str, TreePath]) -> bool:
        return self._match_steps(TreePath.parse(path).steps)

    def specificity(self) -> Tuple[int, int, int]:
        """(fixed prefix length, literal steps, exactness), larger wins."""
        return self._specificity

    def __str__(self) -> str:
        return f"{self.pattern}={self.spec}"


@dataclasses.dataclass(frozen=True)
class TransferPolicy:
    """An ordered rule set over tree-path regions, validated once."""

    rules: Tuple[PolicyRule, ...]

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))
        if not self.rules:
            raise UnsupportedPolicyError("a policy needs at least one rule")
        seen: Dict[str, PolicyRule] = {}
        for rule in self.rules:
            if not isinstance(rule, PolicyRule):
                raise UnsupportedPolicyError(
                    f"rules must be PolicyRule instances, got {rule!r}")
            if rule.pattern in seen:
                raise UnsupportedPolicyError(
                    f"duplicate pattern {rule.pattern!r} in policy")
            seen[rule.pattern] = rule
        if "**" not in seen:
            raise UnsupportedPolicyError(
                "a policy requires a default rule ('**=<spec>') so every "
                "leaf is covered")
        shard_sizes = {r.spec.num_shards for r in self.rules
                       if r.spec.num_shards > 1}
        if len(shard_sizes) > 1:
            raise UnsupportedPolicyError(
                f"overlapping shard axes: sharded rules must agree on the "
                f"mesh size, got {sorted(shard_sizes)}")

    @classmethod
    def of(cls, spec: Union[str, TransferSpec]) -> "TransferPolicy":
        """The one-rule policy a whole-tree spec becomes (``**=<spec>``)."""
        return cls((PolicyRule("**", TransferSpec.parse(spec)),))

    @classmethod
    def parse(cls, text: "str | TransferPolicy | TransferSpec"
              ) -> "TransferPolicy":
        """Inverse of ``str``; policies pass through, specs become
        one-rule policies, a bare spec string parses as ``**=<spec>``."""
        if isinstance(text, cls):
            return text
        if isinstance(text, TransferSpec):
            return cls.of(text)
        if not isinstance(text, str):
            raise UnsupportedPolicyError(
                f"expected a policy string or TransferPolicy, got {text!r}")
        if "=" not in text:
            return cls.of(TransferSpec.parse(text.strip()))
        rules = []
        for chunk in text.split(";"):
            chunk = chunk.strip()
            if not chunk:
                continue
            pattern, eq, spec = chunk.partition("=")
            if not eq or not pattern.strip() or not spec.strip():
                raise UnsupportedPolicyError(
                    f"cannot parse policy rule {chunk!r}: want "
                    "'<pattern>=<spec>'")
            rules.append(PolicyRule(pattern.strip(), spec.strip()))
        return cls(tuple(rules))

    def __str__(self) -> str:
        return "; ".join(str(r) for r in self.rules)

    def match(self, path: Union[str, TreePath]) -> PolicyRule:
        """The winning rule for one leaf path (most specific)."""
        got = TreePath.parse(path).steps
        best: Optional[PolicyRule] = None
        best_score: Tuple[int, int, int] = (-1, -1, -1)
        for rule in self.rules:
            if rule._match_steps(got):
                score = rule.specificity()
                if score > best_score:
                    best, best_score = rule, score
        assert best is not None  # '**' always matches
        return best

    @property
    def num_shards(self) -> int:
        """The policy's (single, validated) sharded-mesh size, 1 if none."""
        return max((r.spec.num_shards for r in self.rules), default=1)

    def reshard(self, k: int) -> "TransferPolicy":
        """This policy for a mesh of ``k`` devices: every sharded rule's mesh
        size becomes ``k`` (``k == 1`` drops the axis); other rules pass
        through."""
        if int(k) < 1:
            raise UnsupportedPolicyError(
                f"cannot reshard a policy onto {k} devices")
        k = int(k)
        rules = tuple(
            PolicyRule(r.pattern, r.spec.replace(sharding=None if k == 1
                                                 else k))
            if r.spec.num_shards > 1 else r
            for r in self.rules)
        return TransferPolicy(rules)

    def with_rule(self, pattern: str,
                  spec: Union[str, TransferSpec]) -> "TransferPolicy":
        """This policy with ``pattern``'s spec replaced; the pattern must
        already be a rule (the autotuner varies specs, never patterns)."""
        spec = TransferSpec.parse(spec)
        if pattern not in {r.pattern for r in self.rules}:
            raise UnsupportedPolicyError(
                f"pattern {pattern!r} is not a rule of this policy")
        return TransferPolicy(tuple(
            PolicyRule(r.pattern, spec) if r.pattern == pattern else r
            for r in self.rules))

    def neighbors(self, mesh_size: int = 1) -> Tuple["TransferPolicy", ...]:
        """Every policy differing from this one in exactly one rule's spec,
        over :func:`candidate_specs` — the autotuner's local moves."""
        out: List[TransferPolicy] = []
        for rule in self.rules:
            for spec in candidate_specs(mesh_size):
                if spec != rule.spec:
                    out.append(self.with_rule(rule.pattern, spec))
        return tuple(out)


# ---------------------------------------------------------------------------
# the bounded candidate grid (autotuner / DC111 search space)
# ---------------------------------------------------------------------------

def candidate_specs(mesh_size: int = 1) -> Tuple[TransferSpec, ...]:
    """The per-region spec grid the cost-guided search enumerates:
    tight-packed marshal x {plain, delta} x {unsharded, @dp<mesh>} plus
    unsharded pointerchain.  Left out, as in the reference: ``uvm`` (zero
    pass-time bytes would trivially win while changing access semantics),
    device pins (a correctness decision) and ``align>1`` (it only adds
    padding)."""
    mesh_size = int(mesh_size)
    out = [TransferSpec("marshal"),
           TransferSpec("marshal", delta=True),
           TransferSpec("pointerchain")]
    if mesh_size > 1:
        out.append(TransferSpec("marshal", sharding=mesh_size))
        out.append(TransferSpec("marshal", delta=True, sharding=mesh_size))
    return tuple(out)


def enumerate_policies(patterns: Tuple[str, ...], mesh_size: int = 1,
                       specs: Optional[Tuple[TransferSpec, ...]] = None
                       ) -> List[TransferPolicy]:
    """Every assignment of candidate specs to the given rule patterns (which
    must include the ``**`` default), in ``itertools.product`` order:
    ``len(specs) ** len(patterns)`` policies."""
    specs = candidate_specs(mesh_size) if specs is None else tuple(specs)
    return [TransferPolicy(tuple(PolicyRule(p, s)
                                 for p, s in zip(patterns, combo)))
            for combo in itertools.product(specs, repeat=len(patterns))]


# ---------------------------------------------------------------------------
# region partitioning
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Region:
    """One policy region of a concrete tree: the winning rule plus the flat
    leaf indices (and their paths) it covers."""

    rule: PolicyRule
    indices: Tuple[int, ...]
    paths: Tuple[str, ...]

    @property
    def key(self) -> str:
        return self.rule.pattern

    @property
    def spec(self) -> TransferSpec:
        return self.rule.spec


def partition_tree(tree: Any, policy: Union[str, TransferPolicy]
                   ) -> "collections.OrderedDict[str, Region]":
    """The tree's leaves by policy region, in rule declaration order (empty
    regions omitted); every leaf lands in exactly one region."""
    policy = TransferPolicy.parse(policy)
    paths = leaf_paths(tree)
    by_rule: Dict[str, List[int]] = {r.pattern: [] for r in policy.rules}
    for i, path in enumerate(paths):
        by_rule[policy.match(path).pattern].append(i)
    out: "collections.OrderedDict[str, Region]" = collections.OrderedDict()
    for rule in policy.rules:
        idx = by_rule[rule.pattern]
        if idx:
            out[rule.pattern] = Region(
                rule, tuple(idx), tuple(str(paths[i]) for i in idx))
    return out


# ---------------------------------------------------------------------------
# the compiled program
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ProgramStats:
    """One ``to_device`` pass: the copies each region enqueued and the one
    synchronize.  ``sync_s`` is what the caller waited for the barrier,
    ``overlap_s`` (async passes) the time from the enqueue to the moment the
    caller saw the barrier complete, ``finish_s`` the bookkeeping after it.

    The reference runs the barrier on a thread, so its ``overlap_s`` is the
    barrier's own wall.  Here no thread waits: the future sees completion
    only when polled (``done``, ``wait``, ``result``), so ``overlap_s`` ends
    at the first poll that found the copies done, and ``result()`` called
    at once after the enqueue gives ``overlap_s`` close to ``sync_s``."""

    enqueues: Dict[str, int]
    syncs: int
    sync_s: float
    overlap_s: float = 0.0
    finish_s: float = 0.0

    @property
    def enqueue_total(self) -> int:
        return sum(self.enqueues.values())

    @property
    def offloaded_s(self) -> float:
        """Barrier time the caller did not wait: ``overlap_s - sync_s``,
        at least 0 (0 for a blocking pass, about 0 for an async pass
        materialized at once)."""
        return max(0.0, self.overlap_s - self.sync_s)


class ProgramFuture:
    """One in-flight asynchronous program pass.

    Created by :meth:`TransferProgram.to_device_async` after every region
    enqueued its copies.  :meth:`result` waits the pass's barrier event
    (bounded by ``timeout``: polling ``event.query()``, no thread), runs
    every region's finish bookkeeping and returns the staged device tree,
    memoized.  A program keeps at most one un-materialized future."""

    _POLL_S = 1e-4

    def __init__(self, program: "TransferProgram", leaves: List[Any],
                 barrier: Optional[Any], finishes: List[Tuple[Region, Any]],
                 enqueues: Dict[str, int]):
        self._program = program
        self._leaves = leaves
        self._barrier = barrier
        self._finishes = finishes
        self._enqueues = enqueues
        self._started = time.perf_counter()
        self._seen_done: Optional[float] = None
        self._materialized = False
        self._result: Any = None

    def done(self) -> bool:
        """True once every copy of the pass has completed (the pass is not
        yet materialized — ``result()`` still runs the finish stage)."""
        if self._seen_done is None and (self._barrier is None
                                        or self._barrier.query()):
            self._seen_done = time.perf_counter()
            if _sanitizer._ACTIVE is not None:
                _sanitizer._ACTIVE.on_sync("ProgramFuture")
        return self._seen_done is not None

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the pass's copies complete, at most ``timeout``
        seconds (forever if ``None``).  True when done, False on expiry;
        never raises, never materializes."""
        if timeout is None:
            if self._barrier is not None and not self.done():
                self._barrier.synchronize()
            return self.done()
        deadline = time.perf_counter() + timeout
        while not self.done():
            left = deadline - time.perf_counter()
            if left <= 0:
                return False
            time.sleep(min(self._POLL_S, left))
        return True

    def result(self, timeout: Optional[float] = None) -> Any:
        """Materialize the pass: the (bounded) barrier wait, the per-region
        finish bookkeeping and the staged device tree (memoized).  On expiry
        of ``timeout`` raises :class:`TransferTimeout` and leaves the pass
        un-materialized, so a later ``result()`` retries the wait."""
        if self._materialized:
            return self._result
        t0 = time.perf_counter()
        if not self.wait(timeout):
            raise TransferTimeout(
                time.perf_counter() - t0,
                detail="pass not materialized; result() may be retried")
        sync_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        out = self._program._finish(self._leaves, self._finishes)
        program = self._program
        program.last_stats = ProgramStats(
            self._enqueues, 1, sync_s, self._seen_done - self._started,
            time.perf_counter() - t1)
        if _sanitizer._ACTIVE is not None:
            _sanitizer._ACTIVE.on_pass_stats(program.last_stats)
        self._result = out
        self._materialized = True
        if program._inflight is self:
            program._inflight = None
        self._leaves = self._finishes = self._barrier = None
        return out


class TransferProgram:
    """A policy compiled against one tree structure: per-region scheme
    executors over a shared session, executed as ONE transfer pass over
    every device they copy to (:attr:`devices`).  Ledgers stay per region
    (:attr:`ledgers`); :meth:`merged_ledger` sums them."""

    def __init__(self, session: Any, policy: TransferPolicy, treedef: TreeDef,
                 regions: "collections.OrderedDict[str, Region]",
                 device: sharded_lib.MeshLike = None):
        from .schemes import transfer_scheme

        self.session = session
        self.policy = policy
        self.treedef = treedef
        self.regions = regions
        self._schemes = collections.OrderedDict()
        for key, region in regions.items():
            try:
                self._schemes[key] = transfer_scheme(region.spec, session,
                                                     device=device)
            except UnsupportedPolicyError:
                raise
            except UnsupportedSpecError as e:
                raise UnsupportedPolicyError(
                    f"rule {region.rule} cannot execute on this host: {e}"
                ) from e
        self.device = sharded_lib.resolve_one(device)
        # every device a region copies to, in first-use order
        self.devices = tuple(dict.fromkeys(
            d for s in self._schemes.values()
            for d in (s.mesh or (s.device,))))
        self.last_stats: Optional[ProgramStats] = None
        self._inflight: Optional[ProgramFuture] = None

    # -- views ---------------------------------------------------------------
    def scheme(self, key: str):
        return self._schemes[key]

    @property
    def ledgers(self) -> Dict[str, Any]:
        """Region-keyed ledgers (pattern -> TransferLedger)."""
        return {k: s.ledger for k, s in self._schemes.items()}

    def region_ledger(self, key: str):
        return self._schemes[key].ledger

    def merged_ledger(self):
        """One ledger summing every region's, plus the last pass's barrier
        attribution."""
        from .schemes import TransferLedger

        out = TransferLedger().merge(*[s.ledger
                                       for s in self._schemes.values()])
        if self.last_stats is not None:
            out.record_wall(0.0, self.last_stats.sync_s)
            out.record_overlap(self.last_stats.overlap_s)
            out.record_finish(self.last_stats.finish_s)
        return out

    def region_of(self, path: Union[str, TreePath]) -> str:
        """The pattern of the region that holds the leaf at ``path``."""
        return self.policy.match(path).pattern

    def reset_ledgers(self) -> None:
        """Materialize any in-flight pass, then zero every region ledger."""
        self.drain()
        for s in self._schemes.values():
            s.ledger.reset()

    # -- execution -----------------------------------------------------------
    def _flatten(self, tree: Any) -> List[Any]:
        leaves, treedef = tree_flatten(tree)
        if treedef != self.treedef:
            raise ValueError("tree does not match the compiled tree "
                             "structure")
        return leaves

    def drain(self) -> Optional[Any]:
        """Materialize the in-flight async pass, if any (returns its tree)."""
        fut, self._inflight = self._inflight, None
        return fut.result() if fut is not None else None

    def synchronize(self) -> None:
        """Wait for all work queued on every device of the program."""
        for dev in self.devices:
            _device.synchronize(dev)

    def _begin(self, tree: Any):
        """Every region packs and enqueues, in declaration order, without a
        synchronize; then one barrier: an event after the last enqueue on
        each device's copy stream (None on the CPU, where every copy has
        completed)."""
        self.drain()
        leaves = self._flatten(tree)
        finishes: List[Tuple[Region, Any]] = []
        enqueues: Dict[str, int] = {}
        # the enqueue half: the sanitizer (when on) flags any barrier
        # issued inside it (DC304, the one-sync-per-pass contract)
        with _sanitizer.enqueue_half():
            for key, region in self.regions.items():
                sub = [leaves[i] for i in region.indices]
                pending, finish = self._schemes[key].begin_pass(sub)
                enqueues[key] = len(pending)
                finishes.append((region, finish))
        events = []
        for dev in self.devices:
            if dev.type == "cuda":
                events.append(torch.cuda.Event())
                events[-1].record(_device.copy_stream(dev))
        barrier = _device.Barrier(events) if events else None
        return leaves, barrier, finishes, enqueues

    def _finish(self, leaves: List[Any],
                finishes: List[Tuple[Region, Any]]) -> Any:
        out = list(leaves)
        for region, finish in finishes:
            for i, leaf in zip(region.indices, tree_leaves(finish())):
                out[i] = leaf
        return self.treedef.unflatten(out)

    def to_device(self, tree: Any) -> Any:
        """One blocking pass: enqueue every region's copies, ONE
        synchronize, finish."""
        leaves, barrier, finishes, enqueues = self._begin(tree)
        t0 = time.perf_counter()
        if _sanitizer._ACTIVE is not None:
            _sanitizer._ACTIVE.on_sync("TransferProgram.to_device")
        if barrier is not None:
            barrier.synchronize()
        t1 = time.perf_counter()
        out = self._finish(leaves, finishes)
        self.last_stats = ProgramStats(enqueues, 1, t1 - t0,
                                       finish_s=time.perf_counter() - t1)
        if _sanitizer._ACTIVE is not None:
            _sanitizer._ACTIVE.on_pass_stats(self.last_stats)
        return out

    def to_device_async(self, tree: Any) -> ProgramFuture:
        """Pack and enqueue every region now; return a
        :class:`ProgramFuture` whose ``result()`` waits the barrier and
        materializes the tree.  Same motion and ledgers as
        :meth:`to_device`."""
        fut = ProgramFuture(self, *self._begin(tree))
        self._inflight = fut
        return fut

    def from_device(self, device_tree: Any, host_tree: Any) -> Any:
        """D2H per region under each region's spec."""
        self.drain()
        dev_leaves = self._flatten(device_tree)
        host_leaves = self._flatten(host_tree)
        out = list(host_leaves)
        for key, region in self.regions.items():
            sub_dev = [dev_leaves[i] for i in region.indices]
            sub_host = [host_leaves[i] for i in region.indices]
            back = self._schemes[key].from_device(sub_dev, sub_host)
            for i, leaf in zip(region.indices, tree_leaves(back)):
                out[i] = leaf
        return self.treedef.unflatten(out)

    def mark_dirty(self, tree: Any, *paths: Union[str, TreePath]) -> None:
        """Delta API for in-place host mutators: flag the buckets under
        ``paths`` (all delta regions' buckets if none given) in every delta
        region holding leaves below them — an interior path's leaves may
        span several regions.  Materializes any in-flight pass first: a
        mutation racing an enqueued copy must fence, not corrupt."""
        self.drain()
        leaves = self._flatten(tree)
        roots = [str(TreePath.parse(p)) for p in paths]
        for key, region in self.regions.items():
            scheme = self._schemes[key]
            if not getattr(scheme, "delta", False):
                continue
            sub = [leaves[i] for i in region.indices]
            if not roots:
                scheme.mark_dirty(sub)
                continue
            local = [f"[{j}]" for j, gp in enumerate(region.paths)
                     if any(gp == r or gp.startswith(r + ".")
                            or gp.startswith(r + "[") for r in roots)]
            if local:
                scheme.mark_dirty(sub, *local)

    def clear(self) -> None:
        """Release what this program retains on the device (delta state,
        entry references) and reset its ledgers; the next pass is cold."""
        self.drain()
        for scheme in self._schemes.values():
            state = getattr(scheme, "_delta_state", None)
            if state is not None:
                state.clear()
            if hasattr(scheme, "_entry"):
                scheme._entry = None
                scheme.layout = None
            scheme.ledger.reset()
        self.last_stats = None


def compile_program(tree: Any, policy: Union[str, TransferPolicy],
                    session: Any = None,
                    device: sharded_lib.MeshLike = None) -> TransferProgram:
    """Compile ``policy`` against ``tree``'s structure for ``device`` (the
    card, or the default mesh, unless ``"cpu"`` or a mesh is given),
    warming the session's entries (and their staging) for every
    marshalling region."""
    from . import engine as engine_lib

    session = session if session is not None else engine_lib.get_session()
    policy = TransferPolicy.parse(policy)
    leaves, treedef = tree_flatten(tree)
    regions = partition_tree(tree, policy)
    program = TransferProgram(session, policy, treedef, regions, device)
    for key, region in regions.items():
        if region.spec.kind == "marshal":
            program.scheme(key)._entry_for([leaves[i] for i in region.indices])
    return program
