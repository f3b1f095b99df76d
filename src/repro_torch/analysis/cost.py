"""Static transfer cost model — DESIGN.md §14.

Counterpart of ``repro/analysis/cost.py``.  Given (tree structure + leaf
signatures, :class:`~repro_torch.core.policy.TransferPolicy`, steady
mutation set), predict — with no transfer — what one compiled
:class:`~repro_torch.core.policy.TransferProgram` will move.  Two halves:

* **Motion half — exact.**  Per-region cold and steady
  :class:`~repro_torch.scenarios.base.Motion` (bytes, copies, per-device
  splits), host staging footprint, arena padding and the sync count come
  from the machinery the runtime executes (``partition_tree`` +
  ``arena.plan`` + the ``derive_*_motion`` derivations), so they equal the
  measured ledger exactly, per region, cold and steady.

* **Wall half — an estimate.**  :class:`CostModel` is a two-parameter
  affine model (per-copy latency + host-link bandwidth); wall =
  ``latency_us * calls + bytes / bandwidth``.  :meth:`CostModel.calibrate`
  fits both from single-copy probes on the card (the only device work in
  this module, opt-in) and :meth:`CostModel.save` persists them
  (``BENCH_torch_costmodel.json``) so later analyses stay static.

On top of :func:`policy_cost` sit the DC11x advisories
(:func:`cost_diagnostics`): DC110 padding waste, DC111 a dominated region
spec, DC112 staging over budget.  A signature tree
(:func:`signature_tree`) prices exactly like the tree it was taken from
and holds no buffer: every signature leaf is read as a meta tensor.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import _device
from ..core import arena, declare, tree_leaves, tree_map
from ..core.policy import TransferPolicy, candidate_specs, partition_tree
from ..core.spec import TransferSpec
from ..scenarios.base import (_nbytes, derive_policy_motion,
                              derive_steady_policy_motion)
from .diagnostics import Diagnostic

#: DC110 threshold: flag a policy predicted to spend more than this
#: fraction of its marshalled arena bytes on padding (alignment + shard
#: tail) every cold pass.
PADDING_WASTE_WARN = 0.25

#: DC111 threshold: an alternative must predict at most this fraction of
#: the declared spec's motion bytes (≥20% less) to count as dominating.
DOMINATED_MARGIN = 0.8

#: Steady-over-cold weighting of the motion objective: one cold pass
#: amortizes over roughly this many steady passes.  Only the ranking uses
#: it; predictions stay exact.
STEADY_WEIGHT = 10

COSTMODEL_FILE = "BENCH_torch_costmodel.json"


# ---------------------------------------------------------------------------
# leaf signatures — shape/dtype stand-ins so no real buffers are needed
# ---------------------------------------------------------------------------

def _torch_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or type, or a dtype
    name (``"bfloat16"`` included, which numpy alone does not know)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    got = getattr(torch, name, None)
    if not isinstance(got, torch.dtype):
        raise TypeError(f"no torch dtype named {name!r}")
    return got


@dataclasses.dataclass(frozen=True)
class LeafSig:
    """A leaf's transfer-relevant signature: shape + dtype, nothing else.
    ``arena.as_tensor`` reads it as a meta tensor, so ``arena.plan`` and
    the motion derivations price it without allocating a byte."""

    shape: Tuple[int, ...]
    dtype: torch.dtype

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "dtype", _torch_dtype(self.dtype))

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) \
            * self.dtype.itemsize


def signature_tree(tree: Any) -> Any:
    """The tree with every leaf replaced by its :class:`LeafSig` — same
    structure, no payload.  ``policy_cost(signature_tree(t), ...)`` equals
    ``policy_cost(t, ...)`` exactly."""
    def sig(leaf: Any) -> LeafSig:
        t = arena.as_tensor(leaf)
        return LeafSig(tuple(t.shape), t.dtype)

    return tree_map(sig, tree)


# ---------------------------------------------------------------------------
# the exact half: per-region predicted motion + footprints
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RegionCost:
    """Predicted cost of ONE policy region: exact cold/steady Motion plus
    the footprints the Motion numbers do not show (host staging bytes,
    padding bytes the arena ships but no leaf owns)."""

    key: str                 # rule pattern (== TransferProgram.ledgers key)
    spec: TransferSpec
    leaves: int
    payload_bytes: int       # live leaf bytes in this region
    cold: Any                # Motion: one cold program pass
    steady: Any              # Motion: one warm pass under the mutation set
    staging_bytes: int       # host staging footprint (0: no arena staging)
    padding_bytes: int       # arena bytes that are alignment/tail padding

    @property
    def arena_bytes(self) -> int:
        """Padded arena bytes (marshal regions; 0 otherwise)."""
        return self.payload_bytes + self.padding_bytes \
            if self.spec.kind == "marshal" else 0


@dataclasses.dataclass(frozen=True)
class PolicyCost:
    """Predicted cost of one (tree structure, policy, mutation set) triple.

    Everything except the walls is exact; totals sum the regions.
    ``syncs`` is always 1 — the program's one-sync-per-pass contract is
    part of what the prediction relies on."""

    policy: TransferPolicy
    regions: Tuple[RegionCost, ...]
    mutate_paths: Tuple[str, ...]
    syncs: int = 1

    def region(self, key: str) -> RegionCost:
        for rc in self.regions:
            if rc.key == key:
                return rc
        raise KeyError(f"no region {key!r} in this cost "
                       f"(have {[r.key for r in self.regions]})")

    # -- exact totals --------------------------------------------------------
    @property
    def cold_bytes(self) -> int:
        return sum(r.cold.h2d_bytes for r in self.regions)

    @property
    def cold_calls(self) -> int:
        return sum(r.cold.h2d_calls for r in self.regions)

    @property
    def steady_bytes(self) -> int:
        return sum(r.steady.h2d_bytes for r in self.regions)

    @property
    def steady_calls(self) -> int:
        return sum(r.steady.h2d_calls for r in self.regions)

    @property
    def staging_bytes(self) -> int:
        return sum(r.staging_bytes for r in self.regions)

    @property
    def padding_bytes(self) -> int:
        return sum(r.padding_bytes for r in self.regions)

    @property
    def payload_bytes(self) -> int:
        return sum(r.payload_bytes for r in self.regions)

    @property
    def arena_bytes(self) -> int:
        return sum(r.arena_bytes for r in self.regions)

    def padding_fraction(self) -> float:
        """Padding share of the marshalled arenas (0.0 when no arena)."""
        total = self.arena_bytes
        return self.padding_bytes / total if total else 0.0

    def motion_objective(self, steady_weight: int = STEADY_WEIGHT) -> int:
        """The ranking scalar of the motion half: one cold pass plus
        ``steady_weight`` steady passes, in bytes."""
        return self.cold_bytes + steady_weight * self.steady_bytes


def _region_cost(key: str, spec: TransferSpec, sub: List[Any],
                 local_mutate: List[str]) -> RegionCost:
    """One region's predicted cost from its sub-leaves: single-rule
    derivations over the sub-tree, which equal the policy-level derivations
    over the whole tree (same arena plan, same shard split)."""
    one = TransferPolicy.of(spec)
    cold = derive_policy_motion(sub, one)["**"]
    steady = derive_steady_policy_motion(sub, one, local_mutate)["**"]
    payload = sum(_nbytes(l) for l in sub)
    staging = padding = 0
    if spec.kind == "marshal":
        layout = arena.plan(sub, spec.align_elems,
                            shard_multiple=spec.num_shards)
        arena_bytes = layout.total_bytes()
        padding = arena_bytes - layout.payload_bytes()
        staging = arena_bytes * (2 if spec.staging == "double_buffered"
                                 else 1)
    return RegionCost(key, spec, len(sub), payload, cold, steady,
                      staging, padding)


def _local_mutations(region: Any, mutated: set) -> List[str]:
    """The mutated leaves of a region, as paths into its sub-leaf list."""
    return [f"[{j}]" for j, i in enumerate(region.indices) if i in mutated]


def policy_cost(tree: Any, policy: Union[str, TransferPolicy],
                mutate_paths: Sequence[str] = ()) -> PolicyCost:
    """The static prediction: partition ``tree`` under ``policy`` and price
    every region — cold Motion, steady Motion under ``mutate_paths``
    (empty = clean warm repeats: delta regions ship nothing, non-delta
    regions re-ship their cold set), staging footprint, padding waste.

    No transfer and no program compilation; ``tree`` may be a real tree
    or a :func:`signature_tree`.
    """
    policy = TransferPolicy.parse(policy)
    leaves = tree_leaves(tree)
    mutate_paths = tuple(mutate_paths)
    mutated = {r.flat_index for r in declare(tree, *mutate_paths)}
    regions = [_region_cost(key, region.spec,
                            [leaves[i] for i in region.indices],
                            _local_mutations(region, mutated))
               for key, region in partition_tree(tree, policy).items()]
    return PolicyCost(policy, tuple(regions), mutate_paths)


# ---------------------------------------------------------------------------
# the estimated half: the calibrated device model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CostModel:
    """Two-parameter affine H2D model: ``wall_us = latency_us * calls +
    bytes / bandwidth``.  The defaults are the reference's nominal
    PCIe-class link, so uncalibrated analyses still rank; ``calibrate()``
    fits both parameters from probe copies to the card and :meth:`save`
    persists them (``BENCH_torch_costmodel.json``, the reference's schema
    1, so either package loads the other's file)."""

    latency_us: float = 20.0
    bandwidth_gbps: float = 8.0      # GB/s on the host->device link
    calibrated: bool = False
    probes: Tuple[Tuple[int, float], ...] = ()   # (bytes, wall_us) fit set

    # -- prediction ----------------------------------------------------------
    def wall_us(self, motion: Any) -> float:
        """Estimated wall of one pass moving ``motion`` (Motion or a
        (bytes, calls) pair) over a serial host link."""
        nbytes, calls = motion if isinstance(motion, tuple) \
            else motion.as_tuple()
        return self.latency_us * calls + nbytes / (self.bandwidth_gbps * 1e3)

    def cold_wall_us(self, cost: PolicyCost) -> float:
        return self.wall_us((cost.cold_bytes, cost.cold_calls))

    def steady_wall_us(self, cost: PolicyCost) -> float:
        return self.wall_us((cost.steady_bytes, cost.steady_calls))

    def objective_us(self, cost: PolicyCost,
                     steady_weight: int = STEADY_WEIGHT) -> float:
        """The autotuner's scalar: one cold pass amortized over
        ``steady_weight`` steady passes."""
        return self.cold_wall_us(cost) \
            + steady_weight * self.steady_wall_us(cost)

    # -- calibration ---------------------------------------------------------
    @classmethod
    def _fit(cls, probes: Sequence[Tuple[int, float]]) -> "CostModel":
        """Least-squares affine fit of (bytes, wall_us) single-copy probes.
        Degenerate fits clamp to floors instead of predicting negative
        walls."""
        pts = [(int(b), float(us)) for b, us in probes]
        if len(pts) < 2:
            raise ValueError("calibration needs at least two probe sizes")
        xs = np.array([b for b, _ in pts], dtype=np.float64)
        ys = np.array([us for _, us in pts], dtype=np.float64)
        slope, intercept = np.polyfit(xs, ys, 1)   # us per byte, us
        latency = max(float(intercept), 0.05)
        # slope us/byte -> GB/s: bytes/us = 1/slope; GB/s = 1/(slope*1e3)
        bandwidth = 1.0 / (max(float(slope), 1e-9) * 1e3)
        return cls(latency_us=round(latency, 3),
                   bandwidth_gbps=round(bandwidth, 3),
                   calibrated=True, probes=tuple(pts))

    @classmethod
    def calibrate(cls, sizes: Sequence[int] = (1 << 16, 1 << 20, 1 << 22),
                  repeats: int = 5,
                  device: _device.DeviceLike = None) -> "CostModel":
        """Fit the model from live probe copies: per probe size, one raw
        host->card copy of a fresh pageable numpy buffer, each ended by a
        synchronize (the minimum over ``repeats``: copy walls are one-sided
        noise), then the affine fit.  ``device`` is the card unless named;
        without one this raises ``NoCudaDeviceError``.  The only device work
        in this module."""
        dev = _device.resolve_device(device)
        if dev.type != "cuda":
            raise ValueError(f"calibration probes the host->card link; "
                             f"{dev} has none")
        probes: List[Tuple[int, float]] = []
        for nbytes in sizes:
            buf = torch.from_numpy(
                np.zeros(max(1, int(nbytes) // 4), dtype=np.float32))
            buf.to(dev)                                   # warm
            # lint: allow=DC201 -- calibration probe must be one raw copy, not a program (as the reference's)
            torch.cuda.synchronize(dev)
            best = float("inf")
            for _ in range(max(1, repeats)):
                t0 = time.perf_counter()
                buf.to(dev)
                # lint: allow=DC201 -- calibration probe must be one raw copy, not a program (as the reference's)
                torch.cuda.synchronize(dev)
                best = min(best, (time.perf_counter() - t0) * 1e6)
            probes.append((buf.numel() * buf.element_size(), best))
        return cls._fit(probes)

    # -- persistence ---------------------------------------------------------
    def as_dict(self) -> Dict[str, Any]:
        return {"schema": 1, "latency_us": self.latency_us,
                "bandwidth_gbps": self.bandwidth_gbps,
                "calibrated": self.calibrated,
                "probes": [list(p) for p in self.probes]}

    def save(self, path: str, **extra: Any) -> None:
        """Write :meth:`as_dict`, plus ``extra`` keys (such as the card's
        name and power limit) that :meth:`load` ignores."""
        body = self.as_dict()
        clash = set(extra) & set(body)
        if clash:
            raise ValueError(f"extra keys {sorted(clash)} would overwrite "
                             f"the model's own")
        with open(path, "w") as f:
            json.dump({**body, **extra}, f, indent=1)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "CostModel":
        with open(path) as f:
            d = json.load(f)
        return cls(latency_us=float(d["latency_us"]),
                   bandwidth_gbps=float(d["bandwidth_gbps"]),
                   calibrated=bool(d.get("calibrated", True)),
                   probes=tuple((int(b), float(us))
                                for b, us in d.get("probes", ())))

    @classmethod
    def load_or_default(cls, path: Optional[str] = None) -> "CostModel":
        """The committed calibration if present, else the nominal model."""
        if path is not None:
            try:
                return cls.load(path)
            except (OSError, ValueError, KeyError):
                pass
        return cls()


# ---------------------------------------------------------------------------
# DC11x — the cost-model advisory diagnostics
# ---------------------------------------------------------------------------

def _dominates(alt: RegionCost, decl: RegionCost,
               steady_known: bool) -> bool:
    """Strict Pareto dominance of one region alternative: ≥20% less
    predicted motion bytes AND no more copies AND no more host staging.
    The staging leg keeps delta (double-buffered rent) from "dominating" a
    non-delta region on bytes alone, and pointerchain's zero staging from
    being dominated by any arena."""
    if steady_known:
        decl_bytes = decl.cold.h2d_bytes + STEADY_WEIGHT * decl.steady.h2d_bytes
        alt_bytes = alt.cold.h2d_bytes + STEADY_WEIGHT * alt.steady.h2d_bytes
        decl_calls = decl.cold.h2d_calls + STEADY_WEIGHT * decl.steady.h2d_calls
        alt_calls = alt.cold.h2d_calls + STEADY_WEIGHT * alt.steady.h2d_calls
    else:
        decl_bytes, alt_bytes = decl.cold.h2d_bytes, alt.cold.h2d_bytes
        decl_calls, alt_calls = decl.cold.h2d_calls, alt.cold.h2d_calls
    if not decl_bytes:
        return False
    return (alt_bytes <= DOMINATED_MARGIN * decl_bytes
            and alt_calls <= decl_calls
            and alt.staging_bytes <= decl.staging_bytes)


def cost_diagnostics(tree: Any, policy: Union[str, TransferPolicy],
                     mutate_paths: Optional[Sequence[str]] = None,
                     mesh_size: int = 1,
                     staging_budget_bytes: Optional[int] = None,
                     where: str = "policy") -> List[Diagnostic]:
    """The DC11x advisory layer over :func:`policy_cost`.

    ``mutate_paths`` declares the steady mutation set (``None`` = steady
    behaviour unknown: DC111 compares cold motion only); ``mesh_size``
    bounds the candidate grid's sharded alternatives;
    ``staging_budget_bytes`` arms DC112.  No transfer.
    """
    policy = TransferPolicy.parse(policy)
    steady_known = mutate_paths is not None
    cost = policy_cost(tree, policy, mutate_paths or ())
    out: List[Diagnostic] = []

    frac = cost.padding_fraction()
    if frac > PADDING_WASTE_WARN:
        out.append(Diagnostic(
            "DC110",
            f"predicted padding waste: {cost.padding_bytes} of "
            f"{cost.arena_bytes} marshalled arena bytes ({frac:.0%}) are "
            f"alignment/shard-tail padding (> {PADDING_WASTE_WARN:.0%}); "
            f"every cold pass ships them",
            where=where))

    leaves = tree_leaves(tree)
    mutated = {r.flat_index for r in declare(tree, *(mutate_paths or ()))}
    for key, region in partition_tree(tree, policy).items():
        spec = region.spec
        if spec.device is not None or spec.kind == "uvm":
            # pins are a placement decision, uvm defers motion to access
            # time — neither is comparable on pass-time motion alone
            continue
        decl = cost.region(key)
        sub = [leaves[i] for i in region.indices]
        local = _local_mutations(region, mutated)
        for alt_spec in candidate_specs(mesh_size):
            if alt_spec == spec:
                continue
            alt = _region_cost(key, alt_spec, sub, local)
            if _dominates(alt, decl, steady_known):
                decl_total = decl.cold.h2d_bytes + (
                    STEADY_WEIGHT * decl.steady.h2d_bytes if steady_known
                    else 0)
                alt_total = alt.cold.h2d_bytes + (
                    STEADY_WEIGHT * alt.steady.h2d_bytes if steady_known
                    else 0)
                out.append(Diagnostic(
                    "DC111",
                    f"region {key!r} ({spec}) is dominated: {alt_spec} "
                    f"predicts {alt_total} motion bytes vs {decl_total} "
                    f"({alt_total / decl_total:.0%}) at no more DMA calls "
                    f"or staging",
                    where=where))
                break   # one dominating witness per region is enough

    if staging_budget_bytes is not None \
            and cost.staging_bytes > staging_budget_bytes:
        out.append(Diagnostic(
            "DC112",
            f"predicted host staging footprint {cost.staging_bytes} bytes "
            f"exceeds the budget ({staging_budget_bytes}); double-buffered "
            f"regions pay 2x their arena",
            where=where))

    out.sort(key=lambda d: d.code)
    return out
