"""repro_torch.analysis — the transfer analysis suite (DESIGN.md §13–§14).

Counterpart of ``repro.analysis``, over one diagnostic-code taxonomy
(:mod:`.diagnostics`):

  * :mod:`.check` — static policy/program analyzer (DC1xx): shadowed
                    rules, zero-leaf rules, shard tail padding, mixed-device
                    regions, delta without reuse, stale meshes — runnable
                    over the whole scenario registry
                    (``python -m repro_torch.analysis.check``).
  * :mod:`.cost`  — static transfer cost model: exact per-region cold and
                    steady Motion and footprints
                    (:func:`~repro_torch.analysis.cost.policy_cost`), the
                    calibrated wall estimator
                    (:class:`~repro_torch.analysis.cost.CostModel`) and the
                    DC11x advisories ``check`` surfaces.
  * :mod:`.sanitizer` — opt-in runtime staging race sanitizer (DC3xx): a
                    happens-before shadow state machine per (bucket,
                    buffer) hooked into the arena engine, the schemes and
                    the programs (``REPRO_SANITIZE=1`` /
                    ``TransferSession(sanitize=True)``).
  * :mod:`.lint`  — AST lint of the port's sources (DC2xx): raw torch
                    transfer / sync primitives, unknown fault-point
                    literals, unparseable spec / policy literals, in-place
                    arena writes without ``mark_dirty``
                    (``python -m repro_torch.analysis.lint --strict``).

``check``, ``cost`` and ``lint`` import the core; they load lazily here,
so the core engine can import :mod:`.sanitizer` without a cycle.
"""
from . import diagnostics, sanitizer
from .diagnostics import Diagnostic, errors
from .sanitizer import StagingRaceError, SyncDisciplineError

__all__ = ["CostModel", "Diagnostic", "StagingRaceError",
           "SyncDisciplineError", "check", "check_policy", "check_registry",
           "cost", "cost_diagnostics", "diagnostics", "errors", "lint",
           "lint_paths", "lint_repo", "policy_cost", "sanitizer"]

_LAZY = {
    "check": ("repro_torch.analysis.check", None),
    "check_policy": ("repro_torch.analysis.check", "check_policy"),
    "check_registry": ("repro_torch.analysis.check", "check_registry"),
    "cost": ("repro_torch.analysis.cost", None),
    "CostModel": ("repro_torch.analysis.cost", "CostModel"),
    "cost_diagnostics": ("repro_torch.analysis.cost", "cost_diagnostics"),
    "policy_cost": ("repro_torch.analysis.cost", "policy_cost"),
    "lint": ("repro_torch.analysis.lint", None),
    "lint_paths": ("repro_torch.analysis.lint", "lint_paths"),
    "lint_repo": ("repro_torch.analysis.lint", "lint_repo"),
}


def __getattr__(name: str):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    module = importlib.import_module(target[0])
    value = module if target[1] is None else getattr(module, target[1])
    globals()[name] = value
    return value
