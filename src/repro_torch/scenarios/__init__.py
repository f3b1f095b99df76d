"""repro_torch.scenarios — the registry-driven workload matrix.

Counterpart of ``repro.scenarios``: the families linear, dense, ragged,
mixed_dtype, sweep, model_state, sharded, sharded_delta, mixed_policy,
elastic and steady_reuse (the mesh-sized ones at the caller's
``iter_scenarios(devices=k)``), the Algorithm-2 driver (spec, scheme or
policy program), the steady delta harness (per device on a mesh) and the
region-aware policy harness.
"""
from .base import (Motion, PAPER_SCHEMES, SCHEME_NAMES, SIZE_PRESETS,
                   Scenario, derive_motion, derive_policy_motion,
                   derive_steady_motion, derive_steady_policy_motion,
                   family_names, get_family, iter_scenarios, register)
from .driver import (Measurement, PolicyMeasurement, SteadyMeasurement,
                     motion_matches, run_algorithm2, run_policy_scenario,
                     run_scenario, run_steady_scenario, scale_kernel)
from .families import (LINEAR_LAYOUTS, chain_access_set, deep_narrow_case,
                       deep_narrow_chain, deep_narrow_tree, dense_case,
                       dense_chain, dense_expected, dense_tree,
                       dense_uvm_access_set, elastic_case, elastic_tree,
                       linear_case, linear_chain, linear_expected,
                       linear_tree, linear_used_paths, mixed_dtype_case,
                       mixed_dtype_tree, mixed_policy_case,
                       mixed_policy_tree, model_state_case, ragged_case,
                       ragged_tree, sharded_case, sharded_delta_case,
                       sharded_delta_expected, sharded_delta_steady_expected,
                       sharded_delta_tree, sharded_expected, sharded_tree,
                       steady_reuse_case, steady_reuse_tree,
                       wide_shallow_case, wide_shallow_tree)

__all__ = [
    "Motion", "PAPER_SCHEMES", "SCHEME_NAMES", "SIZE_PRESETS", "Scenario",
    "derive_motion", "derive_policy_motion", "derive_steady_motion",
    "derive_steady_policy_motion", "family_names", "get_family",
    "iter_scenarios", "register",
    "Measurement", "PolicyMeasurement", "SteadyMeasurement",
    "motion_matches", "run_algorithm2", "run_policy_scenario",
    "run_scenario", "run_steady_scenario", "scale_kernel",
    "LINEAR_LAYOUTS", "chain_access_set", "deep_narrow_case",
    "deep_narrow_chain", "deep_narrow_tree", "dense_case", "dense_chain",
    "dense_expected", "dense_tree", "dense_uvm_access_set", "elastic_case",
    "elastic_tree", "linear_case", "linear_chain", "linear_expected",
    "linear_tree", "linear_used_paths", "mixed_dtype_case",
    "mixed_dtype_tree", "mixed_policy_case", "mixed_policy_tree",
    "model_state_case", "ragged_case", "ragged_tree", "sharded_case",
    "sharded_delta_case", "sharded_delta_expected",
    "sharded_delta_steady_expected", "sharded_delta_tree",
    "sharded_expected", "sharded_tree", "steady_reuse_case",
    "steady_reuse_tree", "wide_shallow_case", "wide_shallow_tree",
]
