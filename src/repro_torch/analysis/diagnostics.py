"""Structured diagnostic codes of the transfer analysis suite.

Counterpart of ``repro/analysis/diagnostics.py``: the same registry, codes,
severities and meanings, so a diagnostic reads the same from either
package.  One taxonomy across the checking layers (DESIGN.md §13.1):

    DC1xx  static — policy/program analysis before any transfer (check, cost)
    DC2xx  lint   — AST checks over the port's source (lint)
    DC3xx  runtime — the staging race sanitizer (sanitizer)

DC1xx and DC2xx are reported as :class:`Diagnostic` values; DC3xx are
raised as typed exceptions (``StagingRaceError`` / ``SyncDisciplineError``)
whose ``.code`` indexes this table.  Only the standard library here: the
sanitizer is importable from the core engine without a cycle.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

ERROR = "error"
WARNING = "warning"

#: code -> (severity, one-line meaning).  THE registry: every diagnostic
#: the suite can emit appears here, and tests assert the mutant corpus
#: covers each DC3xx entry.
CODES = {
    # -- static policy/program analysis (DC1xx) -----------------------------
    "DC101": (WARNING, "rule is shadowed: every leaf it matches is won by a "
                       "more specific rule"),
    "DC102": (WARNING, "rule matches zero leaves of this tree"),
    "DC103": (WARNING, "sharded rule pads a bucket's tail heavily "
                       "(wasted per-device bytes)"),
    "DC104": (WARNING, "regions target mixed devices (explicit device "
                       "pins disagree, or pin against a sharded mesh)"),
    "DC105": (WARNING, "delta spec on a tree with no steady-state reuse "
                       "(retained state can never be hit)"),
    "DC106": (ERROR, "stale mesh: policy shards over more devices than "
                     "the mesh has"),
    "DC110": (WARNING, "cost model predicts heavy padding waste: most "
                       "arena bytes shipped are alignment/shard-tail "
                       "padding"),
    "DC111": (WARNING, "dominated policy: a candidate-grid alternative "
                       "predicts >=20% less motion at no more DMA calls "
                       "or staging"),
    "DC112": (WARNING, "predicted host staging footprint exceeds the "
                       "declared budget"),
    # -- repo lint (DC2xx) --------------------------------------------------
    "DC201": (ERROR, "raw transfer/sync primitive (synchronize, "
                     "non_blocking, .cuda(), pin_memory, .to(device)) "
                     "outside the engine/schemes/driver allowlist"),
    "DC202": (ERROR, "fault-point string literal not in faults.POINTS"),
    "DC203": (ERROR, "spec/policy string literal fails parse"),
    "DC204": (ERROR, "in-place write to an arena-managed buffer without a "
                     "reachable mark_dirty/bump_version"),
    # -- runtime staging race sanitizer (DC3xx) -----------------------------
    "DC301": (ERROR, "staging buffer rewritten while its fence is pending "
                     "(mutate-before-drain)"),
    "DC302": (ERROR, "enqueued array is not the bucket's active staging "
                     "buffer (stale/drained buffer reuse, double rotate)"),
    "DC303": (ERROR, "fence leak: fence group count exceeds FENCE_DEPTH"),
    "DC304": (ERROR, "sync discipline: barrier inside an enqueue half, or "
                     "a pass with syncs != 1"),
    "DC305": (ERROR, "staging bytes mutated while the DMA was in flight "
                     "(enqueue/drain checksum mismatch)"),
    "DC306": (ERROR, "identity-trusted leaf no longer matches its staged "
                     "bytes (missing mark_dirty after in-place mutation)"),
}

STATIC_CODES = tuple(c for c in CODES if c.startswith("DC1"))
LINT_CODES = tuple(c for c in CODES if c.startswith("DC2"))
RUNTIME_CODES = tuple(c for c in CODES if c.startswith("DC3"))


def severity_of(code: str) -> str:
    return CODES[code][0]


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One reported finding: a code from :data:`CODES`, the concrete
    message, and where it points (a rule pattern, or ``file:line``)."""

    code: str
    message: str
    where: Optional[str] = None

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unknown diagnostic code {self.code!r}")

    @property
    def severity(self) -> str:
        return severity_of(self.code)

    @property
    def is_error(self) -> bool:
        return self.severity == ERROR

    def __str__(self) -> str:
        loc = f"{self.where}: " if self.where else ""
        return f"{loc}{self.code} [{self.severity}] {self.message}"


def errors(diags) -> list:
    """The error-severity subset (what CI and the registry test gate on)."""
    return [d for d in diags if d.is_error]
