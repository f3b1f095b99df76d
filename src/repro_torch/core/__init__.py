"""repro_torch.core — deep-copy semantics, the pointerchain directive,
marshalling arenas and the three transfer schemes, on PyTorch.

Counterpart of ``repro.core`` on one device, with path-scoped policies
compiled into one-synchronize programs (``policy``) and the autotuner's
candidate grid (``candidate_specs``, ``enumerate_policies``), and the
staging race sanitizer's hooks (``repro_torch.analysis.sanitizer``).  Not
yet ported: sharded (``@dpK``, K > 1) execution.
"""
from .treepath import (TreeDef, TreePath, leaf_items, leaf_paths,
                       max_chain_depth, tree_flatten, tree_leaves, tree_map,
                       tree_structure, tree_unflatten)
from .chainref import ChainRef, Region, declare, extract, insert, region
from .arena import (ArenaLayout, LeafSlot, alloc_buffers, datasize_dense,
                    datasize_linear, dtype_name, pack, pack_into, plan,
                    repack_into, unpack)
from .engine import (ArenaEntry, DeltaState, TransferSession, cache_stats,
                     cached_plan, clear_cache, get_entry, get_session,
                     pack_traced, repack_traced, set_cache_limits,
                     unpack_traced)
from .spec import PAPER_SPECS, TransferSpec, UnsupportedSpecError
from .schemes import (LazyLeaf, MarshalScheme, PointerChainScheme,
                      SCHEME_NAMES, SCHEMES, TransferLedger, TransferScheme,
                      UVMScheme, make_scheme, transfer_scheme)
from .policy import (PolicyRule, ProgramFuture, ProgramStats,
                     TransferPolicy, TransferProgram, TransferTimeout,
                     UnsupportedPolicyError, candidate_specs, compile_program,
                     enumerate_policies, partition_tree)
from .deepcopy import (ShapeDtype, full_deepcopy, host_skeleton,
                       selective_deepcopy, tree_bytes)

__all__ = [
    "TreeDef", "TreePath", "leaf_items", "leaf_paths", "max_chain_depth",
    "tree_flatten", "tree_leaves", "tree_map", "tree_structure",
    "tree_unflatten",
    "ChainRef", "Region", "declare", "extract", "insert", "region",
    "ArenaLayout", "LeafSlot", "alloc_buffers", "datasize_dense",
    "datasize_linear", "dtype_name", "pack", "pack_into", "plan",
    "repack_into", "unpack",
    "ArenaEntry", "DeltaState", "TransferSession", "cache_stats",
    "cached_plan", "clear_cache", "get_entry", "get_session", "pack_traced",
    "repack_traced", "set_cache_limits", "unpack_traced",
    "PAPER_SPECS", "TransferSpec", "UnsupportedSpecError",
    "LazyLeaf", "MarshalScheme", "PointerChainScheme", "SCHEME_NAMES",
    "SCHEMES", "TransferLedger", "TransferScheme", "UVMScheme", "make_scheme",
    "transfer_scheme",
    "PolicyRule", "ProgramFuture", "ProgramStats", "TransferPolicy",
    "TransferProgram", "TransferTimeout", "UnsupportedPolicyError",
    "candidate_specs", "compile_program", "enumerate_policies",
    "partition_tree",
    "ShapeDtype", "full_deepcopy", "host_skeleton", "selective_deepcopy",
    "tree_bytes",
]
