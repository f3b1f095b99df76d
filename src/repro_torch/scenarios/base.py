"""Scenario core: the dataclass, the registry, and the analytic data-motion
expectations every scheme is held against.

Counterpart of ``repro/scenarios/base.py`` on one device.  A
:class:`Scenario` declares a deterministic tree builder, the pointer chains
its kernel dereferences (``used_paths``), the leaves a demand-paging walk
touches (``uvm_access``) and the exact bytes / copy counts each scheme must
issue (:class:`Motion`).  Not yet ported: the sharded fields and the policy
derivations.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

from ..core import TransferSpec, declare, extract, plan, transfer_scheme
from ..core.arena import as_tensor
from ..core.treepath import tree_leaves

SIZE_PRESETS = ("smoke", "quick", "full")
SCHEME_NAMES = ("uvm", "marshal", "marshal_delta", "pointerchain")


@dataclasses.dataclass(frozen=True)
class Motion:
    """Expected H2D data motion of one Algorithm-2 transfer step."""

    h2d_bytes: int
    h2d_calls: int

    def as_tuple(self) -> Tuple[int, int]:
        return (self.h2d_bytes, self.h2d_calls)


def _nbytes(x: Any) -> int:
    t = as_tensor(x)
    return t.numel() * t.element_size()


def derive_motion(tree: Any, used_paths: Sequence[str],
                  uvm_access: Optional[Sequence[str]],
                  scheme_name: Union[str, TransferSpec],
                  align_elems: int = 1) -> Motion:
    """Structural derivation of the expected data motion (no transfers run).

    * marshal / marshal_delta (cold) — every dtype bucket once: bytes = the
      arena plan's bucket bytes, calls = number of buckets.
    * pointerchain — one copy per declared chain (interior chains expand).
    * uvm — one fault per distinct leaf under the access set.
    """
    scheme_name = TransferSpec.parse(scheme_name).name
    if scheme_name in ("marshal", "marshal_delta"):
        layout = plan(tree, align_elems)
        return Motion(sum(layout.bucket_bytes().values()),
                      len(layout.bucket_sizes))
    if scheme_name == "pointerchain":
        refs = declare(tree, *used_paths)
        return Motion(sum(_nbytes(l) for l in extract(tree, refs)), len(refs))
    if scheme_name == "uvm":
        refs = declare(tree, *(uvm_access or used_paths))
        leaves = tree_leaves(tree)
        faulted = sorted({r.flat_index for r in refs})
        return Motion(sum(_nbytes(leaves[i]) for i in faulted), len(faulted))
    raise KeyError(f"unknown scheme {scheme_name!r}; options: {SCHEME_NAMES}")


def derive_steady_motion(tree: Any, mutate_paths: Sequence[str],
                         align_elems: int = 1) -> Motion:
    """Exact motion of ONE steady-state delta pass after mutating the
    leaves at ``mutate_paths``: each dtype bucket holding a mutated leaf
    ships whole (one copy), every other bucket is skipped."""
    layout = plan(tree, align_elems)
    slots = [layout.slots[r.flat_index] for r in declare(tree, *mutate_paths)]
    dirty = {s.bucket for s in slots if s.size}
    bb = layout.bucket_bytes()
    return Motion(sum(bb[b] for b in dirty), len(dirty))


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One concrete workload cell of the test/benchmark matrix.

    ``build`` is deterministic (seeded), so the expectations stay exact.
    ``used_paths`` resolve to floating leaves (the kernel scales them);
    ``uvm_access`` covers them (``None``: the kernel's own chains);
    ``expected`` holds optional closed-form per-scheme :class:`Motion`;
    ``steady_expected`` the exact motion of one steady delta pass after
    mutating ``params['mutate_path(s)']``.
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

    def steady_mutate_paths(self) -> Tuple[str, ...]:
        paths = self.params.get("mutate_paths")
        if paths is None and "mutate_path" in self.params:
            paths = (self.params["mutate_path"],)
        return tuple(paths or ())

    def specs(self) -> Tuple[TransferSpec, ...]:
        """The specs the scenario runs under: the reference's four plus
        ``marshal+db`` (the double-buffered full transfer)."""
        return (TransferSpec("uvm"),
                TransferSpec("marshal"),
                TransferSpec("marshal", staging="double_buffered"),
                TransferSpec("marshal", delta=True),
                TransferSpec("pointerchain"))

    def scheme_for(self, spec: Union[str, TransferSpec], session=None,
                   device=None):
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
                             align_elems)

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


FamilyFn = Callable[[str], List[Scenario]]
_REGISTRY: Dict[str, FamilyFn] = {}


def register(name: str) -> Callable[[FamilyFn], FamilyFn]:
    """Decorator: register ``fn(size_preset) -> [Scenario, ...]``."""

    def deco(fn: FamilyFn) -> FamilyFn:
        if name in _REGISTRY:
            raise ValueError(f"scenario family {name!r} already registered")
        _REGISTRY[name] = fn
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
                   only: Optional[Iterable[str]] = None) -> List[Scenario]:
    """Every registered scenario at the size preset, in registration order."""
    if size not in SIZE_PRESETS:
        raise KeyError(f"unknown size preset {size!r}; options: {SIZE_PRESETS}")
    names = list(_REGISTRY) if only is None else list(only)
    out: List[Scenario] = []
    for fam in names:
        out.extend(get_family(fam)(size))
    seen: Dict[str, str] = {}
    for sc in out:
        if sc.name in seen:
            raise ValueError(f"duplicate scenario name {sc.name!r} "
                             f"(families {seen[sc.name]} and {sc.family})")
        seen[sc.name] = sc.family
    return out
