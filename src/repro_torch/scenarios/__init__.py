"""repro_torch.scenarios — the registry-driven workload matrix.

Counterpart of ``repro.scenarios`` for the families linear, dense, ragged,
mixed_dtype, sweep and steady_reuse, and for the Algorithm-2 driver.
"""
from .base import (Motion, SCHEME_NAMES, SIZE_PRESETS,
                   Scenario, derive_motion, derive_steady_motion,
                   family_names, get_family, iter_scenarios, register)
from .driver import (Measurement, SteadyMeasurement, motion_matches,
                     run_algorithm2, run_scenario, run_steady_scenario,
                     scale_kernel)
from .families import (LINEAR_LAYOUTS, chain_access_set, deep_narrow_case,
                       deep_narrow_chain, deep_narrow_tree, dense_case,
                       dense_chain, dense_expected, dense_tree,
                       dense_uvm_access_set, linear_case, linear_chain,
                       linear_expected, linear_tree, linear_used_paths,
                       mixed_dtype_case, mixed_dtype_tree, ragged_case,
                       ragged_tree, steady_reuse_case, steady_reuse_tree,
                       wide_shallow_case, wide_shallow_tree)

__all__ = [
    "Motion", "SCHEME_NAMES", "SIZE_PRESETS", "Scenario",
    "derive_motion", "derive_steady_motion", "family_names", "get_family",
    "iter_scenarios", "register",
    "Measurement", "SteadyMeasurement", "motion_matches", "run_algorithm2",
    "run_scenario", "run_steady_scenario", "scale_kernel",
    "LINEAR_LAYOUTS", "chain_access_set", "deep_narrow_case",
    "deep_narrow_chain", "deep_narrow_tree", "dense_case", "dense_chain",
    "dense_expected", "dense_tree", "dense_uvm_access_set", "linear_case",
    "linear_chain", "linear_expected", "linear_tree", "linear_used_paths",
    "mixed_dtype_case", "mixed_dtype_tree", "ragged_case", "ragged_tree",
    "steady_reuse_case", "steady_reuse_tree", "wide_shallow_case",
    "wide_shallow_tree",
]
