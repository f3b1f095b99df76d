"""Scenario core: the dataclass, the registry, and the analytic data-motion
expectations every scheme is held against.

Counterpart of ``repro/scenarios/base.py``.  A :class:`Scenario` declares
a deterministic function that builds its tree, the pointer chains
its kernel dereferences (``used_paths``), the leaves a demand-paging walk
touches (``uvm_access``) and the exact bytes / copy counts each scheme must
issue (:class:`Motion`).  A policy scenario also declares the path-scoped
policy it is designed for and the exact per-region motion of a cold and a
steady program pass (:func:`derive_policy_motion`,
:func:`derive_steady_policy_motion`).  The derivations price sharded rules
(``@dpK``, K > 1: per-device arenas, :class:`Motion`'s per-device fields).
A sharded scenario (``sharding`` set, at ``num_shards`` = K) runs its
specs with that axis on the caller's mesh.

The reference builds its registry at ``jax.device_count()`` devices.  The
port does not probe: :func:`iter_scenarios` takes the mesh size from its
caller (``devices``, one by default), and the families that depend on it
(registered with ``mesh=True``) build their cases at that size.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

from ..core import (TransferPolicy, TransferSpec, declare, extract,
                    partition_tree, plan, transfer_scheme)
from ..core.arena import as_tensor, itemsize
from ..core.treepath import tree_leaves

SIZE_PRESETS = ("smoke", "quick", "full")
SCHEME_NAMES = ("uvm", "marshal", "marshal_delta", "pointerchain")
# the paper's own three schemes (marshal_delta re-issues nothing on a
# repeat pass by design, so the figures' every-repeat cold motion excludes it)
PAPER_SCHEMES = ("uvm", "marshal", "pointerchain")


@dataclasses.dataclass(frozen=True)
class Motion:
    """Expected H2D data motion of one Algorithm-2 transfer step.

    ``per_device_*`` carry a sharded transfer's uniform per-device split
    (every device of the mesh receives exactly those bytes in those
    copies); ``None`` means a one-device transfer, checked on its totals.
    ``by_shard`` is a non-uniform split, (bytes, calls) per shard in shard
    order, as a per-device delta pass gives (only the shards a mutation
    overlaps ship)."""

    h2d_bytes: int
    h2d_calls: int
    per_device_bytes: Optional[int] = None
    per_device_calls: Optional[int] = None
    by_shard: Optional[Tuple[Tuple[int, int], ...]] = None

    def as_tuple(self) -> Tuple[int, int]:
        return (self.h2d_bytes, self.h2d_calls)

    def per_device_tuple(self) -> Optional[Tuple[int, int]]:
        if self.per_device_bytes is None:
            return None
        return (self.per_device_bytes, self.per_device_calls)


def _nbytes(x: Any) -> int:
    t = as_tensor(x)
    return t.numel() * t.element_size()


def _split(total: int, calls: int, k: int) -> Motion:
    """One transfer of ``total`` bytes in ``calls`` copies, split evenly
    over ``k`` devices (unsplit when ``k == 1``)."""
    if k == 1:
        return Motion(total, calls)
    return Motion(total, calls * k, total // k, calls)


def derive_motion(tree: Any, used_paths: Sequence[str],
                  uvm_access: Optional[Sequence[str]],
                  scheme_name: Union[str, TransferSpec],
                  align_elems: int = 1, num_shards: int = 1) -> Motion:
    """Structural derivation of the expected data motion (no transfers run).

    * marshal / marshal_delta (cold) — every dtype bucket once: bytes = the
      arena plan's bucket bytes, calls = number of buckets.
    * pointerchain — one copy per declared chain (interior chains expand).
    * uvm — one fault per distinct leaf under the access set.

    ``num_shards > 1`` derives the per-device arena motion: marshal buckets
    are tail-padded to a per-device multiple and every copy is split evenly
    over the mesh, so the totals multiply the copies by the device count
    and the per-device fields carry the uniform split.
    """
    scheme_name = TransferSpec.parse(scheme_name).name
    k = int(num_shards)
    if scheme_name in ("marshal", "marshal_delta"):
        layout = plan(tree, align_elems, shard_multiple=k)
        return _split(sum(layout.bucket_bytes().values()),
                      len(layout.bucket_sizes), k)
    if scheme_name == "pointerchain":
        refs = declare(tree, *used_paths)
        return _split(sum(_nbytes(l) for l in extract(tree, refs)),
                      len(refs), k)
    if scheme_name == "uvm":
        refs = declare(tree, *(uvm_access or used_paths))
        leaves = tree_leaves(tree)
        faulted = sorted({r.flat_index for r in refs})
        return _split(sum(_nbytes(leaves[i]) for i in faulted),
                      len(faulted), k)
    raise KeyError(f"unknown scheme {scheme_name!r}; options: {SCHEME_NAMES}")


def derive_steady_motion(tree: Any, mutate_paths: Sequence[str],
                         num_shards: int = 1,
                         align_elems: int = 1) -> Motion:
    """Exact motion of ONE steady-state delta pass after mutating the
    leaves at ``mutate_paths``.

    * ``num_shards == 1`` — each dtype bucket holding a mutated leaf ships
      whole (one copy), every other bucket is skipped.
    * ``num_shards > 1`` — per (bucket, device): only the shard sub-ranges
      the mutated slots overlap ship, one copy per dirty (bucket, shard);
      ``by_shard`` carries the non-uniform per-device split.
    """
    k = int(num_shards)
    layout = plan(tree, align_elems, shard_multiple=k)
    slots = [layout.slots[r.flat_index] for r in declare(tree, *mutate_paths)]
    dirty = {s.bucket for s in slots if s.size}
    if k == 1:
        bb = layout.bucket_bytes()
        return Motion(sum(bb[b] for b in dirty), len(dirty))
    per_shard = [[0, 0] for _ in range(k)]
    for bucket in sorted(dirty):
        step = layout.bucket_sizes[bucket] // k
        size = itemsize(layout.bucket_dtypes[bucket])
        touched: set = set()
        for s in slots:
            if s.bucket == bucket and s.size:
                touched.update(range(s.offset // step,
                                     min((s.offset + s.size - 1) // step,
                                         k - 1) + 1))
        for i in touched:
            per_shard[i][0] += step * size
            per_shard[i][1] += 1
    return Motion(sum(b for b, _ in per_shard),
                  sum(c for _, c in per_shard),
                  by_shard=tuple((b, c) for b, c in per_shard))


def derive_policy_motion(tree: Any, policy: Any) -> Dict[str, Motion]:
    """The exact per-region motion of ONE cold program pass, keyed by rule
    pattern as ``TransferProgram.ledgers`` is: a marshal region (``+db`` and
    ``+delta`` included) ships every dtype bucket of the region's own arena
    (per device when sharded), a pointerchain region one copy per region
    leaf, and a uvm region nothing at pass time (it faults at access)."""
    policy = TransferPolicy.parse(policy)
    leaves = tree_leaves(tree)
    out: Dict[str, Motion] = {}
    for key, region in partition_tree(tree, policy).items():
        spec = region.spec
        sub = [leaves[i] for i in region.indices]
        if spec.kind == "uvm":
            out[key] = Motion(0, 0)
        elif spec.kind == "pointerchain":
            out[key] = _split(sum(_nbytes(l) for l in sub), len(sub),
                              spec.num_shards)
        else:
            out[key] = derive_motion(sub, [], None, spec,
                                     align_elems=spec.align_elems,
                                     num_shards=spec.num_shards)
    return out


def derive_steady_policy_motion(tree: Any, policy: Any,
                                mutate_paths: Sequence[str]
                                ) -> Dict[str, Motion]:
    """Per-region motion of one WARM program pass after mutating the leaves
    at ``mutate_paths``: a delta region ships only the dtype buckets (per
    device: the bucket shards) the mutation reaches (nothing when it holds
    no mutated leaf); every other marshal region (``+db`` included) and
    every pointerchain region re-ships its cold motion; uvm regions stay at
    zero."""
    policy = TransferPolicy.parse(policy)
    leaves = tree_leaves(tree)
    mutated = {r.flat_index for r in declare(tree, *mutate_paths)}
    out: Dict[str, Motion] = {}
    for key, region in partition_tree(tree, policy).items():
        spec = region.spec
        sub = [leaves[i] for i in region.indices]
        if spec.kind == "marshal" and spec.delta:
            local = [f"[{j}]" for j, i in enumerate(region.indices)
                     if i in mutated]
            out[key] = derive_steady_motion(sub, local,
                                            num_shards=spec.num_shards,
                                            align_elems=spec.align_elems)
        elif spec.kind == "uvm":
            out[key] = Motion(0, 0)
        else:
            out[key] = derive_policy_motion(sub, TransferPolicy.of(spec))["**"]
    return out


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One concrete workload cell of the test/benchmark matrix.

    ``build`` is deterministic (seeded), so the expectations stay exact.
    ``used_paths`` resolve to floating leaves (the kernel scales them);
    ``uvm_access`` covers them (``None``: the kernel's own chains);
    ``expected`` holds optional closed-form per-scheme :class:`Motion`;
    ``steady_expected`` the exact motion of one steady delta pass after
    mutating ``params['mutate_path(s)']``.  A policy scenario names the
    policy it is designed for (``declared_policy``, a policy string) and
    may declare closed-form per-region motion, keyed by rule pattern, for
    the cold program pass (``region_expected``) and for one steady pass
    after the mutation (``steady_region_expected``).
    """

    name: str
    family: str
    build: Callable[[], Any]
    used_paths: Tuple[str, ...]
    uvm_access: Optional[Tuple[str, ...]] = None
    expected: Optional[Mapping[str, Motion]] = None
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    steady_expected: Optional[Motion] = None
    steady_spec: Optional[TransferSpec] = None
    declared_policy: Optional[str] = None
    region_expected: Optional[Mapping[str, Motion]] = None
    steady_region_expected: Optional[Mapping[str, Motion]] = None
    # sharded scenarios: the dp axis their specs take (``@dp{sharding}``),
    # the mesh size the closed forms were derived at
    sharding: Optional[int] = None

    @property
    def num_shards(self) -> int:
        return self.sharding or 1

    def steady_mutate_paths(self) -> Tuple[str, ...]:
        paths = self.params.get("mutate_paths")
        if paths is None and "mutate_path" in self.params:
            paths = (self.params["mutate_path"],)
        return tuple(paths or ())

    def policy(self, spec: Union[str, TransferSpec, None] = None
               ) -> Optional[TransferPolicy]:
        """With ``spec``, the one-rule policy it becomes (``**=<spec>``);
        otherwise the scenario's declared policy (None when it has none)."""
        if spec is not None:
            return TransferPolicy.of(TransferSpec.parse(spec))
        if self.declared_policy is not None:
            return TransferPolicy.parse(self.declared_policy)
        return None

    def specs(self) -> Tuple[TransferSpec, ...]:
        """The specs the scenario runs under: the reference's four with the
        scenario's sharding axis applied, plus ``marshal+db`` (the
        double-buffered full transfer) on an unsharded scenario (the
        capability matrix keeps non-delta ``+db`` single-device)."""
        sh = self.sharding
        db = () if sh is not None else (
            TransferSpec("marshal", staging="double_buffered"),)
        return (TransferSpec("uvm", sharding=sh),
                TransferSpec("marshal", sharding=sh),
                *db,
                TransferSpec("marshal", delta=True, sharding=sh),
                TransferSpec("pointerchain", sharding=sh))

    def scheme_for(self, spec: Union[str, TransferSpec], session=None,
                   device=None):
        """Executor for ``spec`` on ``device``: for a sharded spec, the mesh
        ``device`` names (the default mesh, ``"cpu"`` for K positions on the
        CPU, or a sequence of devices)."""
        return transfer_scheme(TransferSpec.parse(spec), session,
                               device=device)

    def expected_motion(self, scheme: Union[str, TransferSpec],
                        tree: Any = None, align_elems: int = 1) -> Motion:
        """Closed form if declared (tight packing only), else the
        structural derivation."""
        name = TransferSpec.parse(scheme).name
        if align_elems == 1 and self.expected and name in self.expected:
            return self.expected[name]
        if tree is None:
            tree = self.build()
        return derive_motion(tree, self.used_paths, self.uvm_access, name,
                             align_elems, num_shards=self.num_shards)

    def validate(self, tree: Any = None) -> None:
        """Check the scenario contract on the built tree."""
        if tree is None:
            tree = self.build()
        used = declare(tree, *self.used_paths)
        leaves = tree_leaves(tree)
        for r in used:
            dt = as_tensor(leaves[r.flat_index]).dtype
            if not dt.is_floating_point:
                raise ValueError(
                    f"{self.name}: used path {r.path} resolves to {dt} — the "
                    "Algorithm-2 kernel scales used leaves, so they must be "
                    "floating point")
        if self.uvm_access is not None:
            access = {r.flat_index for r in declare(tree, *self.uvm_access)}
            missing = [str(r.path) for r in used if r.flat_index not in access]
            if missing:
                raise ValueError(
                    f"{self.name}: uvm_access does not cover used chains "
                    f"{missing} — UVM could not extract them for the kernel")
        if self.num_shards > 1:
            # per-leaf schemes split each moved leaf's dim 0 over the mesh:
            # every accessed leaf must split evenly
            access = declare(tree, *(self.uvm_access or self.used_paths))
            for r in {*used, *access}:
                t = as_tensor(leaves[r.flat_index])
                if t.dim() < 1 or t.shape[0] % self.num_shards:
                    raise ValueError(
                        f"{self.name}: leaf {r.path} (shape "
                        f"{tuple(t.shape)}) does not split into "
                        f"{self.num_shards} shards")


FamilyFn = Callable[..., List[Scenario]]
_REGISTRY: Dict[str, FamilyFn] = {}
_MESH_FAMILIES: set = set()


def register(name: str, mesh: bool = False) -> Callable[[FamilyFn], FamilyFn]:
    """Decorator: register ``fn(size_preset) -> [Scenario, ...]``, or with
    ``mesh=True`` ``fn(size_preset, devices)`` (a family sized by the mesh
    it runs on)."""

    def deco(fn: FamilyFn) -> FamilyFn:
        if name in _REGISTRY:
            raise ValueError(f"scenario family {name!r} already registered")
        _REGISTRY[name] = fn
        if mesh:
            _MESH_FAMILIES.add(name)
        return fn

    return deco


def family_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def get_family(name: str) -> FamilyFn:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown scenario family {name!r}; "
                       f"options: {sorted(_REGISTRY)}")


def iter_scenarios(size: str = "quick",
                   only: Optional[Iterable[str]] = None,
                   devices: int = 1) -> List[Scenario]:
    """Every registered scenario at the size preset, in registration order;
    the mesh-sized families (sharded, sharded_delta, mixed_policy, elastic)
    at a mesh of ``devices`` positions (the caller's, never probed)."""
    if size not in SIZE_PRESETS:
        raise KeyError(f"unknown size preset {size!r}; options: {SIZE_PRESETS}")
    if devices < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    names = list(_REGISTRY) if only is None else list(only)
    out: List[Scenario] = []
    for fam in names:
        fn = get_family(fam)
        out.extend(fn(size, devices) if fam in _MESH_FAMILIES else fn(size))
    seen: Dict[str, str] = {}
    for sc in out:
        if sc.name in seen:
            raise ValueError(f"duplicate scenario name {sc.name!r} "
                             f"(families {seen[sc.name]} and {sc.family})")
        seen[sc.name] = sc.family
    return out
