"""Static policy/program analyzer (DC1xx) — DESIGN.md §13.1.

Counterpart of ``repro/analysis/check.py``, with the same diagnostics, in
the same order and with the same messages.  Given a concrete tree, a
:class:`~repro_torch.core.policy.TransferPolicy` and a mesh size, predict —
before compiling a program — the policy mistakes the runtime either
silently absorbs or only surfaces deep inside execution:

  DC101  shadowed rule: matches leaves but a more specific rule always wins
  DC102  zero-leaf rule: matches nothing in this tree structure
  DC103  shard tail padding: per-device padding dominates a region's bytes
  DC104  mixed-device region set: device pins disagree / pin + dp-shard mix
  DC105  delta region without steady-state reuse (pays double-buffer rent)
  DC106  policy sharded wider than the mesh (ERROR: compile would raise)
  DC110  cost model predicts heavy padding waste across the policy's arenas
  DC111  dominated policy: a candidate-grid alternative predicts >=20% less
         motion at no more copies or staging (analysis.cost)
  DC112  predicted host staging footprint exceeds the declared budget

Everything here is host-side analysis over ``partition_tree`` and
``arena.plan`` (plus :mod:`.cost`'s exact motion predictions): no transfer,
no program compilation.  The mesh is the caller's ``mesh_size``, or the
live CUDA device count; without a card and without ``mesh_size`` the
analysis raises ``NoCudaDeviceError`` rather than guess one.

    python -m repro_torch.analysis.check --mesh-size 1
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List, Optional, Union

import torch

from .._device import NoCudaDeviceError
from ..core.arena import plan
from ..core.policy import TransferPolicy, partition_tree
from ..core.treepath import leaf_paths, tree_leaves
from .cost import cost_diagnostics
from .diagnostics import Diagnostic

# a sharded region whose tail padding exceeds this fraction of its padded
# arena moves mostly padding bytes per pass — flag it (DC103).
TAIL_PADDING_WARN = 0.25


def _live_device_count() -> Optional[int]:
    """The host's CUDA device count, None when CUDA is unavailable —
    DC106's message names it whenever it disagrees with the analyzed mesh,
    so a ``--mesh-size`` what-if can't be mistaken for the live verdict."""
    return torch.cuda.device_count() if torch.cuda.is_available() else None


def _mesh_size(mesh_size: Optional[int]) -> int:
    if mesh_size is not None:
        return int(mesh_size)
    live = _live_device_count()
    if not live:
        raise NoCudaDeviceError(
            "the live mesh is the CUDA device count, and "
            "torch.cuda.is_available() is False; pass mesh_size to analyze "
            "a mesh without a card")
    return live


def check_policy(tree: Any, policy: Union[str, TransferPolicy],
                 mesh_size: Optional[int] = None,
                 steady_reuse: Optional[bool] = None,
                 where: str = "policy",
                 mutate_paths: Optional[List[str]] = None,
                 staging_budget_bytes: Optional[int] = None
                 ) -> List[Diagnostic]:
    """All DC1xx diagnostics for one (tree, policy, mesh) triple.

    ``steady_reuse`` declares whether the workload re-ships this tree
    steadily with partial mutation (the condition under which a delta
    region earns its double-buffer rent); ``None`` means unknown and
    skips DC105.  ``mutate_paths`` is the steady mutation set for the
    DC11x cost layer (``None`` = unknown: DC111 compares cold motion
    only); ``staging_budget_bytes`` arms DC112.  Returns diagnostics in
    code order; empty means clean.
    """
    policy = TransferPolicy.parse(policy)
    out: List[Diagnostic] = []
    mesh = _mesh_size(mesh_size)

    if policy.num_shards > mesh:
        live = _live_device_count()
        live_note = "" if live is None or live == mesh else (
            f" (analyzed mesh {mesh} != live torch.cuda.device_count()="
            f"{live})")
        out.append(Diagnostic(
            "DC106",
            f"policy shards over {policy.num_shards} devices but the "
            f"mesh has {mesh}; compiling would raise at executor "
            f"construction" + live_note,
            where=where))

    paths = leaf_paths(tree)
    matches: Dict[str, int] = {r.pattern: 0 for r in policy.rules}
    wins: Dict[str, int] = {r.pattern: 0 for r in policy.rules}
    for path in paths:
        for rule in policy.rules:
            if rule._match_steps(path.steps):
                matches[rule.pattern] += 1
        wins[policy.match(path).pattern] += 1

    for rule in policy.rules:
        if rule.pattern == "**":
            # the required default legitimately idles when every leaf has
            # a more specific home; it can't be "dead" in the DC101/102
            # sense.
            continue
        if matches[rule.pattern] == 0:
            out.append(Diagnostic(
                "DC102",
                f"rule {rule} matches no leaf of this treedef",
                where=where))
        elif wins[rule.pattern] == 0:
            out.append(Diagnostic(
                "DC101",
                f"rule {rule} is shadowed: it matches "
                f"{matches[rule.pattern]} leaves but more specific rules "
                f"win every one",
                where=where))

    regions = partition_tree(tree, policy)
    leaves = tree_leaves(tree)

    for pattern, region in regions.items():
        spec = region.rule.spec
        k = spec.num_shards
        if k > 1:
            sub = [leaves[i] for i in region.indices]
            padded = plan(sub, align_elems=spec.align_elems,
                          shard_multiple=k)
            tight = plan(sub, align_elems=spec.align_elems)
            total = padded.total_bytes()
            pad = total - tight.total_bytes()
            if total and pad / total > TAIL_PADDING_WARN:
                out.append(Diagnostic(
                    "DC103",
                    f"region {pattern!r} @dp{k}: {pad} of {total} arena "
                    f"bytes ({pad / total:.0%}) are shard tail padding "
                    f"(> {TAIL_PADDING_WARN:.0%}); pad leaf sizes toward "
                    f"a multiple of the mesh or shrink the mesh",
                    where=where))
        if spec.delta and steady_reuse is False:
            out.append(Diagnostic(
                "DC105",
                f"region {pattern!r} uses a delta spec ({spec}) but the "
                f"workload declares no steady-state reuse; every pass "
                f"re-ships all buckets while paying double-buffer rent",
                where=where))

    pinned = {r.pattern: r.spec.device for r in
              (rg.rule for rg in regions.values())
              if r.spec.device is not None}
    sharded = [rg.rule.pattern for rg in regions.values()
               if rg.rule.spec.num_shards > 1]
    if len(set(pinned.values())) > 1:
        detail = ", ".join(f"{p}→dev{d}" for p, d in sorted(pinned.items()))
        out.append(Diagnostic(
            "DC104",
            f"regions pin different devices ({detail}); one program pass "
            f"will interleave H2D streams across devices",
            where=where))
    elif pinned and sharded:
        out.append(Diagnostic(
            "DC104",
            f"regions mix a device pin ({sorted(pinned)}) with dp-sharded "
            f"regions ({sorted(sharded)}); the pinned region serializes "
            f"against one device of the mesh",
            where=where))

    # the DC11x cost-model layer (predicted waste / dominance / footprint)
    out.extend(cost_diagnostics(tree, policy, mutate_paths=mutate_paths,
                                mesh_size=mesh,
                                staging_budget_bytes=staging_budget_bytes,
                                where=where))

    out.sort(key=lambda d: d.code)
    return out


def check_scenario(sc: Any, mesh_size: Optional[int] = None,
                   staging_budget_bytes: Optional[int] = None
                   ) -> List[Diagnostic]:
    """DC1xx diagnostics for one registry scenario's declared policy
    (empty when it declares none).  Steady reuse is read off the scenario:
    ``params['mutate_paths']`` or a declared steady region expectation
    signal a steady-state loop, and the scenario's steady mutation set
    feeds the DC11x cost layer."""
    policy = sc.policy()
    if policy is None:
        return []
    mutate = list(sc.steady_mutate_paths())
    steady_reuse = bool(mutate) or sc.steady_region_expected is not None
    return check_policy(sc.build(), policy, mesh_size=mesh_size,
                        steady_reuse=steady_reuse, where=sc.name,
                        mutate_paths=mutate if steady_reuse else None,
                        staging_budget_bytes=staging_budget_bytes)


def check_registry(size: str = "quick", mesh_size: Optional[int] = None,
                   staging_budget_bytes: Optional[int] = None
                   ) -> Dict[str, List[Diagnostic]]:
    """:func:`check_scenario` over every registry scenario that declares a
    policy.  Keys are scenario names; clean scenarios map to empty lists
    (so the caller can also assert coverage)."""
    from ..scenarios import iter_scenarios

    out: Dict[str, List[Diagnostic]] = {}
    for sc in iter_scenarios(size):
        if sc.declared_policy is None:
            continue
        out[sc.name] = check_scenario(
            sc, mesh_size=mesh_size,
            staging_budget_bytes=staging_budget_bytes)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.check",
        description="Static DC1xx analysis of every declared scenario "
                    "policy in the registry.")
    ap.add_argument("--size", default="quick",
                    choices=("smoke", "quick", "full"))
    ap.add_argument("--mesh-size", type=int, default=None,
                    help="analyze as if the mesh had this many devices "
                         "(default: torch.cuda.device_count(); required "
                         "without a card)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on warnings too, not just errors")
    ap.add_argument("--staging-budget-mb", type=float, default=None,
                    help="arm DC112: warn when a policy's predicted host "
                         "staging footprint exceeds this many MB")
    args = ap.parse_args(argv)

    budget = None if args.staging_budget_mb is None \
        else int(args.staging_budget_mb * 1e6)
    results = check_registry(args.size, mesh_size=args.mesh_size,
                             staging_budget_bytes=budget)
    n_diags = n_errors = 0
    for name in sorted(results):
        for diag in results[name]:
            n_diags += 1
            n_errors += diag.is_error
            print(diag)
    print(f"checked {len(results)} declared policies "
          f"(mesh={_mesh_size(args.mesh_size)}): "
          f"{n_errors} errors, {n_diags - n_errors} warnings")
    return 1 if (n_errors or (args.strict and n_diags)) else 0


if __name__ == "__main__":
    sys.exit(main())
