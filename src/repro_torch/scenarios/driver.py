"""Scheme-agnostic Algorithm-2 driver.

Counterpart of ``repro/scenarios/driver.py``.  One straight-line pass for
any spec (on one device, or on a mesh for ``@dpK``), or for a path-scoped
policy compiled into one program:

    stage (transfer under the spec or policy) -> extract declared leaves ->
    kernel (x1.5) -> insert -> from_device -> check (line 7)

:func:`run_scenario` additionally holds the ledger to the scenario's
analytic :class:`~repro_torch.scenarios.base.Motion`,
:func:`run_steady_scenario` warms a delta executor, mutates, and holds
every steady pass to its exact dirty motion, and
:func:`run_policy_scenario` holds every region of a program pass to its
motion (closed form == structural derivation == region ledger).  On a
mesh every motion check is also held per position: the uniform split, a
delta pass's ``by_shard`` split, and ``h2d + skipped == the full sharded
motion`` on every position.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from .._device import synchronize
from ..core import (LazyLeaf, TransferPolicy, TransferSpec, TreePath, declare,
                    extract, get_session, insert, transfer_scheme)
from ..core.arena import as_tensor
from ..core.sharded import MeshLike, ShardedTensor, to_host
from ..core.treepath import tree_leaves
from .base import (Motion, Scenario, derive_policy_motion,
                   derive_steady_motion, derive_steady_policy_motion)


@dataclasses.dataclass
class Measurement:
    scheme: str
    wall_us: float
    kernel_us: float
    h2d_bytes: int
    h2d_calls: int
    ok: bool                              # Algorithm 2 line-7 value check
    motion_ok: Optional[bool] = None      # ledger == analytic expectation
    expected: Optional[Motion] = None
    skipped_bytes: int = 0                # delta path: bytes proven clean
    per_device: Optional[dict] = None     # {device: (bytes, calls)}
    spec: Optional[str] = None            # canonical TransferSpec string
    enqueue_us: float = 0.0               # ledger split of the transfer wall
    sync_us: float = 0.0
    device: Optional[str] = None          # where it ran


def motion_matches(ledger, expected: Motion, num_shards: int = 1) -> bool:
    """Exact ledger == expectation, including the per-device split when the
    expectation declares one (every one of ``num_shards`` positions,
    uniformly)."""
    if (ledger.h2d_bytes, ledger.h2d_calls) != expected.as_tuple():
        return False
    want = expected.per_device_tuple()
    if want is None:
        return True
    per_dev = ledger.per_device()
    return len(per_dev) == num_shards and \
        all(got == want for got in per_dev.values())


def _sync_all(devices) -> None:
    for dev in dict.fromkeys(devices):
        synchronize(dev)


# 1.5 is exactly representable in every float dtype the scenarios use, and
# the product is ONE rounding in every dtype — on the reference too.
_SCALE = 1.5


def scale_kernel(leaves: Sequence[Any]) -> List[Any]:
    """The Algorithm-2 kernel: every declared leaf times 1.5, on whatever
    device the leaf lives on, a sharded leaf piece by piece on each piece's
    device (new tensors; attached views are never written in place)."""
    return [l.map(lambda t: t * _SCALE) if isinstance(l, ShardedTensor)
            else l * _SCALE for l in leaves]


def _check_rtol(leaf: torch.Tensor) -> float:
    """Half-precision payloads (bf16/f16) round the scaled product at ~1e-2."""
    return 2e-2 if leaf.element_size() <= 2 else 1e-5


def run_algorithm2(tree: Any, used_paths: Sequence[str],
                   spec: Union[str, TransferSpec, None] = None, *,
                   uvm_access: Optional[Sequence[str]] = None,
                   kernel_repeats: int = 1,
                   scheme: Optional[Any] = None,
                   device: MeshLike = None,
                   policy: Union[str, TransferPolicy, None] = None,
                   program: Optional[Any] = None) -> Measurement:
    """One full Algorithm-2 pass; returns wall/kernel time + motion stats.

    Pass ``scheme`` to reuse an executor (its cached layouts and staging)
    across repeats; otherwise one is built for ``spec`` on ``device`` (the
    CUDA card unless ``device="cpu"``).  The ledger is reset, so the
    Measurement reports per-pass motion.

    With a path-scoped ``policy`` (or a compiled ``program``) instead, the
    transfer step is ONE program pass (every region enqueued before one
    synchronize), ``from_device`` runs per region, and the Measurement's
    motion is the program's merged ledger (``scheme == "policy"``).
    """
    if policy is not None or program is not None:
        return _run_algorithm2_program(tree, used_paths, policy=policy,
                                       program=program,
                                       kernel_repeats=kernel_repeats,
                                       device=device)
    if scheme is None:
        if spec is None:
            raise ValueError("need a spec or a scheme instance")
        scheme = transfer_scheme(spec, device=device)
    scheme.ledger.reset()
    # chain resolution happens before the region (paper §3)
    refs = declare(tree, *used_paths)

    t0 = time.perf_counter()
    dev, _ = scheme.stage(tree, used_paths, uvm_access=uvm_access,
                          declare_refs=False)
    out_leaves = scale_kernel(extract(dev, refs))
    dev = insert(dev, refs, out_leaves)
    host = scheme.from_device(dev, tree)
    wall = (time.perf_counter() - t0) * 1e6

    ok = _check_line7(tree, host, refs)
    kernel_us = _kernel_only_us(tree, refs, kernel_repeats, scheme.device)
    led = scheme.ledger
    return Measurement(scheme.name, wall, kernel_us, led.h2d_bytes,
                       led.h2d_calls, ok, skipped_bytes=led.skipped_bytes,
                       per_device=led.per_device() or None,
                       spec=str(scheme.spec), enqueue_us=led.enqueue_s * 1e6,
                       sync_us=led.sync_s * 1e6, device=str(scheme.device))


def _check_line7(tree: Any, host: Any, refs) -> bool:
    """Algorithm 2 line 7, per declared leaf."""
    ok = True
    host_leaves = tree_leaves(host)
    orig_leaves = tree_leaves(tree)
    for r in refs:
        want_leaf = as_tensor(orig_leaves[r.flat_index])
        got = as_tensor(host_leaves[r.flat_index]).cpu().to(torch.float64)
        want = want_leaf.to(torch.float64) * _SCALE
        ok &= got.shape == want.shape and bool(
            torch.allclose(got, want, rtol=_check_rtol(want_leaf)))
    return ok


def _kernel_only_us(tree: Any, refs, kernel_repeats: int,
                    device: torch.device) -> float:
    """Kernel time on device-resident leaves: CUDA events on the card (the
    host clock does not wait for the device), the host clock on the CPU."""
    leaves = [as_tensor(l).to(device) for l in extract(tree, refs)]
    reps = max(1, kernel_repeats)
    scale_kernel(leaves)                                   # warm-up
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            scale_kernel(leaves)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps * 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        scale_kernel(leaves)
    return (time.perf_counter() - t0) / reps * 1e6


def _run_algorithm2_program(tree: Any, used_paths: Sequence[str], *,
                            policy: Union[str, TransferPolicy, None],
                            program: Optional[Any], kernel_repeats: int,
                            device: MeshLike) -> Measurement:
    """Algorithm 2 with a compiled TransferProgram as the transfer step."""
    if program is None:
        program = get_session().compile(tree, TransferPolicy.parse(policy),
                                        device=device)
    program.reset_ledgers()
    refs = declare(tree, *used_paths)

    t0 = time.perf_counter()
    dev = program.to_device(tree)
    # uvm regions stage lazily: the kernel's dereference faults those leaves
    # (their copies land in the region's ledger here)
    leaves = [l.get() if isinstance(l, LazyLeaf) else l
              for l in extract(dev, refs)]
    dev = insert(dev, refs, scale_kernel(leaves))
    host = program.from_device(dev, tree)
    wall = (time.perf_counter() - t0) * 1e6

    ok = _check_line7(tree, host, refs)
    kernel_us = _kernel_only_us(tree, refs, kernel_repeats, program.device)
    led = program.merged_ledger()
    return Measurement("policy", wall, kernel_us, led.h2d_bytes,
                       led.h2d_calls, ok, skipped_bytes=led.skipped_bytes,
                       per_device=led.per_device() or None,
                       spec=str(program.policy),
                       enqueue_us=led.enqueue_s * 1e6,
                       sync_us=led.sync_s * 1e6, device=str(program.device))


def run_scenario(sc: Scenario, spec: Union[str, TransferSpec, None] = None, *,
                 scheme: Optional[Any] = None, tree: Any = None,
                 kernel_repeats: int = 1,
                 device: MeshLike = None) -> Measurement:
    """Algorithm 2 over a registry scenario, with the motion check:
    ``motion_ok`` is True iff the ledger equals the scenario's expectation
    exactly, per device too for a sharded scenario."""
    if tree is None:
        tree = sc.build()
    if scheme is None:
        if spec is None:
            raise ValueError("need a spec or a scheme instance")
        scheme = sc.scheme_for(spec, device=device)
    m = run_algorithm2(tree, list(sc.used_paths),
                       uvm_access=list(sc.uvm_access) if sc.uvm_access
                       else None,
                       kernel_repeats=kernel_repeats, scheme=scheme)
    m.expected = sc.expected_motion(
        m.scheme, tree, align_elems=getattr(scheme, "align_elems", 1))
    m.motion_ok = motion_matches(scheme.ledger, m.expected, sc.num_shards)
    return m


@dataclasses.dataclass
class SteadyMeasurement:
    """One steady-state delta pass: what moved, what was proven clean."""

    h2d_bytes: int
    h2d_calls: int
    skipped_bytes: int
    wall_us: float
    ok: bool                     # the attached tree equals the host tree
    motion_ok: bool              # ledger == the steady expectation exactly
    spec: Optional[str] = None
    # on a mesh: the per-position split of the same pass
    h2d_by_device: Optional[Dict[str, int]] = None
    skipped_by_device: Optional[Dict[str, int]] = None


def run_steady_scenario(sc: Scenario, *, passes: int = 3,
                        scheme: Optional[Any] = None,
                        spec: Union[str, TransferSpec, None] = None,
                        device: MeshLike = None
                        ) -> List[SteadyMeasurement]:
    """Warm a delta executor with one full transfer, then repeatedly mutate
    the leaves at ``params['mutate_path(s)']`` (+1) and re-transfer.  Every
    pass must ship EXACTLY the mutated leaves' dtype buckets (on a mesh:
    only the (bucket, position) shards the mutation overlaps, with the
    ``by_shard`` split when declared), with ``h2d_bytes + skipped_bytes``
    equal to the full marshal motion (on a mesh, on every position:
    ``h2d[d] + skipped[d] == full / K``), and the attached tree must equal
    the mutated host tree leaf for leaf."""
    mutate = list(sc.steady_mutate_paths())
    if not mutate:
        raise ValueError(f"{sc.name} is not a steady-state scenario "
                         "(no mutate_path/mutate_paths param)")
    if spec is not None:
        want_spec = TransferSpec.parse(spec)
    elif scheme is not None:
        want_spec = scheme.spec
    else:
        want_spec = sc.steady_spec or TransferSpec.parse("marshal+delta")
    if not want_spec.delta:
        raise ValueError(f"steady harness needs a delta spec, got {want_spec}")
    if scheme is None:
        scheme = sc.scheme_for(want_spec, device=device)
    tree = sc.build()
    scheme.to_device(tree)                      # warm-up: full cold transfer
    full_bytes = sum(scheme.layout.bucket_bytes().values())
    k = max(1, scheme.layout.shard_multiple)
    declared = sc.steady_expected is not None and str(want_spec) == str(
        sc.steady_spec or TransferSpec.parse("marshal+delta"))
    expected = sc.steady_expected if declared else derive_steady_motion(
        tree, mutate, num_shards=k, align_elems=scheme.align_elems)
    devices = scheme.mesh or (scheme.device,)
    tps = [TreePath.parse(p) for p in mutate]
    out: List[SteadyMeasurement] = []
    for _ in range(passes):
        for tp in tps:
            leaf = as_tensor(tp.resolve(tree))
            tree = tp.set(tree, leaf + torch.ones((), dtype=leaf.dtype))
        scheme.ledger.reset()
        t0 = time.perf_counter()
        dev = scheme.to_device(tree)
        _sync_all(devices)
        wall_us = (time.perf_counter() - t0) * 1e6
        led = scheme.ledger
        motion_ok = (led.h2d_bytes, led.h2d_calls) == expected.as_tuple() \
            and led.h2d_bytes + led.skipped_bytes == full_bytes
        if k > 1:
            for s in range(k):
                key = str(s)
                moved = led.h2d_bytes_by_device.get(key, 0)
                # the per-position complement, exact on every position
                motion_ok &= moved + led.skipped_bytes_by_device.get(
                    key, 0) == full_bytes // k
                if expected.by_shard is not None:
                    motion_ok &= (moved, led.h2d_calls_by_device.get(
                        key, 0)) == expected.by_shard[s]
        ok = all(torch.equal(to_host(a), as_tensor(b))
                 for a, b in zip(tree_leaves(dev), tree_leaves(tree)))
        out.append(SteadyMeasurement(
            led.h2d_bytes, led.h2d_calls, led.skipped_bytes, wall_us, ok,
            motion_ok, spec=str(want_spec),
            h2d_by_device=dict(led.h2d_bytes_by_device) or None,
            skipped_by_device=dict(led.skipped_bytes_by_device) or None))
    return out


# -- policy programs: the region-aware harness --------------------------------

@dataclasses.dataclass
class PolicyMeasurement:
    """One TransferProgram pass: per-region motion + program-level checks."""

    policy: str
    wall_us: float
    ok: bool                      # staged values == host tree, leaf for leaf
    motion_ok: bool               # every region ledger == its expectation
    h2d_bytes: int                # merged across regions
    h2d_calls: int
    skipped_bytes: int
    enqueues: int                 # H2D copies enqueued this pass ...
    syncs: int                    # ... behind this many barriers (must be 1)
    regions: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)     # region pattern -> ledger.as_dict()
    expected: Optional[Dict[str, Motion]] = None
    executor: str = "blocking"    # which executor ran the pass
    sync_us: float = 0.0          # what the caller waited at the barrier
    overlap_us: float = 0.0       # async: enqueue to the barrier seen done
    offload_us: float = 0.0       # async: barrier time the caller did not wait
    finish_us: float = 0.0        # bookkeeping after the barrier


def _region_motion_ok(spec: TransferSpec, ledger, expected: Motion,
                      cold: Motion) -> bool:
    """Exact region ledger == expectation; for a delta region also the
    complement ``h2d + skipped == the region's cold bytes``; for a sharded
    region both per position: the uniform split (or a delta pass's
    ``by_shard``) and the complement against ``cold / K``."""
    ok = (ledger.h2d_bytes, ledger.h2d_calls) == expected.as_tuple()
    if spec.delta:
        ok &= ledger.h2d_bytes + ledger.skipped_bytes == cold.h2d_bytes
    k = spec.num_shards
    if k > 1:
        for s in range(k):
            key = str(s)
            moved = ledger.h2d_bytes_by_device.get(key, 0)
            calls = ledger.h2d_calls_by_device.get(key, 0)
            if spec.delta:
                ok &= moved + ledger.skipped_bytes_by_device.get(key, 0) \
                    == cold.h2d_bytes // k
                if expected.by_shard is not None:
                    ok &= (moved, calls) == expected.by_shard[s]
            elif expected.per_device_tuple() is not None:
                ok &= (moved, calls) == expected.per_device_tuple()
    return ok


def _materialized_equal(dev: Any, host: Any) -> bool:
    """Every staged leaf (a uvm leaf's host value, not faulted) equals the
    host tree's leaf: dtype, shape and values."""
    dev_leaves, host_leaves = tree_leaves(dev), tree_leaves(host)
    if len(dev_leaves) != len(host_leaves):
        return False
    for a, b in zip(dev_leaves, host_leaves):
        a = to_host(a._host if isinstance(a, LazyLeaf) else a)
        b = as_tensor(b)
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            return False
    return True


def run_policy_scenario(sc: Scenario,
                        policy: Union[str, TransferPolicy, None] = None, *,
                        tree: Any = None, passes: int = 1,
                        program: Optional[Any] = None,
                        session: Optional[Any] = None,
                        executor: str = "blocking",
                        device: MeshLike = None
                        ) -> List[PolicyMeasurement]:
    """The region-aware harness over a compiled program: pass 0 is cold,
    each later pass first mutates ``params['mutate_paths']`` (+1, out of
    place) when the scenario declares them.

    Per pass, every region's ledger must equal the structural derivation
    (:func:`derive_policy_motion` cold, :func:`derive_steady_policy_motion`
    warm) exactly, and, where the scenario declares closed forms for its
    own policy (``region_expected`` / ``steady_region_expected``), those
    must agree too: closed form == structural == ledger.  Each pass has ONE
    synchronize, as many enqueues as the merged ledger has H2D copies, and
    staged values equal to the (mutated) host tree leaf for leaf.

    ``executor="async"`` runs every pass as ``to_device_async(...).result()``
    under the same checks.  ``policy`` defaults to the declared one; the
    program is compiled on ``device`` (the card unless ``"cpu"``; a sharded
    rule runs on the mesh it names) over ``session`` unless one is passed.
    """
    if executor not in ("blocking", "async"):
        raise ValueError(f"executor must be 'blocking' or 'async', "
                         f"got {executor!r}")
    if tree is None:
        tree = sc.build()
    if policy is None:
        policy = sc.policy()
        if policy is None:
            raise ValueError(f"{sc.name} declares no policy; pass one")
    policy = TransferPolicy.parse(policy)
    if program is None:
        program = (session or get_session()).compile(tree, policy,
                                                     device=device)
    declared = sc.declared_policy is not None and \
        policy == TransferPolicy.parse(sc.declared_policy)
    mutate = [TreePath.parse(p) for p in sc.steady_mutate_paths()]
    cold_expected = derive_policy_motion(tree, policy)
    out: List[PolicyMeasurement] = []
    cur = tree
    for i in range(passes):
        if i:
            for tp in mutate:
                leaf = as_tensor(tp.resolve(cur))
                cur = tp.set(cur, leaf + torch.ones((), dtype=leaf.dtype))
        program.reset_ledgers()
        t0 = time.perf_counter()
        if executor == "async":
            dev = program.to_device_async(cur).result()
        else:
            dev = program.to_device(cur)
        program.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        stats = program.last_stats
        if i == 0:
            expected = cold_expected
            closed = sc.region_expected if declared else None
        else:
            # a delta region ships only what the mutation dirtied (nothing
            # on a clean repeat); the rest re-ship their cold motion
            expected = derive_steady_policy_motion(
                cur, policy, [str(tp) for tp in mutate])
            closed = sc.steady_region_expected \
                if declared and mutate else None
        motion_ok = set(expected) == set(program.ledgers)
        for key, led in program.ledgers.items():
            motion_ok &= _region_motion_ok(program.scheme(key).spec, led,
                                           expected[key], cold_expected[key])
            if closed is not None and key in closed:
                motion_ok &= closed[key].as_tuple() == expected[key].as_tuple()
        merged = program.merged_ledger()
        motion_ok &= stats.syncs == 1
        motion_ok &= stats.enqueue_total == merged.h2d_calls
        out.append(PolicyMeasurement(
            str(policy), wall_us, _materialized_equal(dev, cur), motion_ok,
            merged.h2d_bytes, merged.h2d_calls, merged.skipped_bytes,
            stats.enqueue_total, stats.syncs,
            regions={k: led.as_dict() for k, led in program.ledgers.items()},
            expected=expected, executor=executor,
            sync_us=stats.sync_s * 1e6, overlap_us=stats.overlap_s * 1e6,
            offload_us=stats.offloaded_s * 1e6,
            finish_us=stats.finish_s * 1e6))
    return out
