"""Scheme-agnostic Algorithm-2 driver.

Counterpart of ``repro/scenarios/driver.py`` (the spec/scheme path; the
policy-program path is not yet ported).  One straight-line pass for any
spec:

    stage (transfer under the policy) -> extract declared leaves ->
    kernel (x1.5) -> insert -> from_device -> check (line 7)

:func:`run_scenario` additionally holds the ledger to the scenario's
analytic :class:`~repro_torch.scenarios.base.Motion`, and
:func:`run_steady_scenario` warms a delta executor, mutates, and holds
every steady pass to its exact dirty motion.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional, Sequence, Union

import torch

from .._device import DeviceLike, synchronize
from ..core import TransferSpec, TreePath, declare, extract, insert, transfer_scheme
from ..core.arena import as_tensor
from ..core.treepath import tree_leaves
from .base import Motion, Scenario, derive_steady_motion


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


def motion_matches(ledger, expected: Motion) -> bool:
    """Exact ledger == expectation."""
    return (ledger.h2d_bytes, ledger.h2d_calls) == expected.as_tuple()


# 1.5 is exactly representable in every float dtype the scenarios use, and
# the product is ONE rounding in every dtype — on the reference too.
_SCALE = 1.5


def scale_kernel(leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The Algorithm-2 kernel: every declared leaf times 1.5, on whatever
    device the leaf lives on (new tensors; attached views are never written
    in place)."""
    return [l * _SCALE for l in leaves]


def _check_rtol(leaf: torch.Tensor) -> float:
    """Half-precision payloads (bf16/f16) round the scaled product at ~1e-2."""
    return 2e-2 if leaf.element_size() <= 2 else 1e-5


def run_algorithm2(tree: Any, used_paths: Sequence[str],
                   spec: Union[str, TransferSpec, None] = None, *,
                   uvm_access: Optional[Sequence[str]] = None,
                   kernel_repeats: int = 1,
                   scheme: Optional[Any] = None,
                   device: DeviceLike = None) -> Measurement:
    """One full Algorithm-2 pass; returns wall/kernel time + motion stats.

    Pass ``scheme`` to reuse an executor (its cached layouts and staging)
    across repeats; otherwise one is built for ``spec`` on ``device`` (the
    CUDA card unless ``device="cpu"``).  The ledger is reset, so the
    Measurement reports per-pass motion.
    """
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


def run_scenario(sc: Scenario, spec: Union[str, TransferSpec, None] = None, *,
                 scheme: Optional[Any] = None, tree: Any = None,
                 kernel_repeats: int = 1,
                 device: DeviceLike = None) -> Measurement:
    """Algorithm 2 over a registry scenario, with the motion check:
    ``motion_ok`` is True iff the ledger equals the scenario's expectation
    exactly."""
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
    m.motion_ok = motion_matches(scheme.ledger, m.expected)
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


def run_steady_scenario(sc: Scenario, *, passes: int = 3,
                        scheme: Optional[Any] = None,
                        spec: Union[str, TransferSpec, None] = None,
                        device: DeviceLike = None
                        ) -> List[SteadyMeasurement]:
    """Warm a delta executor with one full transfer, then repeatedly mutate
    the leaves at ``params['mutate_path(s)']`` (+1) and re-transfer.  Every
    pass must ship EXACTLY the mutated leaves' dtype buckets, with
    ``h2d_bytes + skipped_bytes`` equal to the full marshal motion, and the
    attached tree must equal the mutated host tree leaf for leaf."""
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
    declared = sc.steady_expected is not None and str(want_spec) == str(
        sc.steady_spec or TransferSpec.parse("marshal+delta"))
    expected = sc.steady_expected if declared else derive_steady_motion(
        tree, mutate, align_elems=scheme.align_elems)
    tps = [TreePath.parse(p) for p in mutate]
    out: List[SteadyMeasurement] = []
    for _ in range(passes):
        for tp in tps:
            leaf = as_tensor(tp.resolve(tree))
            tree = tp.set(tree, leaf + torch.ones((), dtype=leaf.dtype))
        scheme.ledger.reset()
        t0 = time.perf_counter()
        dev = scheme.to_device(tree)
        synchronize(scheme.device)
        wall_us = (time.perf_counter() - t0) * 1e6
        led = scheme.ledger
        motion_ok = (led.h2d_bytes, led.h2d_calls) == expected.as_tuple() \
            and led.h2d_bytes + led.skipped_bytes == full_bytes
        ok = all(torch.equal(a.cpu(), as_tensor(b))
                 for a, b in zip(tree_leaves(dev), tree_leaves(tree)))
        out.append(SteadyMeasurement(led.h2d_bytes, led.h2d_calls,
                                     led.skipped_bytes, wall_us, ok,
                                     motion_ok, spec=str(want_spec)))
    return out
