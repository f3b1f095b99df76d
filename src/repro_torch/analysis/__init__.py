"""repro_torch.analysis — the static transfer analysis (DESIGN.md §13–§14).

Counterpart of ``repro.analysis`` for its static layers, over one
diagnostic-code taxonomy (:mod:`.diagnostics`):

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

Not yet ported: the runtime staging race sanitizer and the repo lint.
``check`` and ``cost`` import the core and the scenario registry; they
load lazily here, so importing the package costs nothing.
"""
from . import diagnostics
from .diagnostics import Diagnostic, errors

__all__ = ["CostModel", "Diagnostic", "check", "check_policy",
           "check_registry", "cost", "cost_diagnostics", "diagnostics",
           "errors", "policy_cost"]

_LAZY = {
    "check": ("repro_torch.analysis.check", None),
    "check_policy": ("repro_torch.analysis.check", "check_policy"),
    "check_registry": ("repro_torch.analysis.check", "check_registry"),
    "cost": ("repro_torch.analysis.cost", None),
    "CostModel": ("repro_torch.analysis.cost", "CostModel"),
    "cost_diagnostics": ("repro_torch.analysis.cost", "cost_diagnostics"),
    "policy_cost": ("repro_torch.analysis.cost", "policy_cost"),
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
