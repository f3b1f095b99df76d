"""repro_torch.core — deep-copy semantics, the pointerchain directive,
marshalling arenas and the three transfer schemes, on PyTorch.

Counterpart of ``repro.core``, with path-scoped policies compiled into
one-synchronize programs (``policy``), the autotuner's candidate grid
(``candidate_specs``, ``enumerate_policies``), the staging race
sanitizer's hooks (``repro_torch.analysis.sanitizer``), sharded
execution (``@dpK``, K > 1) on a mesh of K positions (``sharded``) and
single-controller collectives over a named mesh (``collectives``).
"""
from .treepath import (TreeDef, TreePath, leaf_items, leaf_paths,
                       max_chain_depth, tree_flatten, tree_leaves, tree_map,
                       tree_structure, tree_unflatten)
from .chainref import (ChainRef, Region, ShardSlice, chain_call, chain_jit,
                       declare, extract, insert, region, resolve_shards)
from .arena import (ArenaLayout, LeafSlot, alloc_buffers, datasize_dense,
                    datasize_linear, dtype_name, pack, pack_into, plan,
                    repack_into, shard_ranges, unpack)
from .engine import (ArenaEntry, DeltaState, TransferSession, cache_stats,
                     cached_plan, clear_cache, get_entry, get_session,
                     num_shards_of, pack_traced, repack_traced,
                     set_cache_limits, unpack_traced)
from .sharded import Piece, ShardedTensor, resolve_mesh, to_host
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
    "ChainRef", "Region", "ShardSlice", "chain_call", "chain_jit", "declare",
    "extract", "insert", "region", "resolve_shards",
    "ArenaLayout", "LeafSlot", "alloc_buffers", "datasize_dense",
    "datasize_linear", "dtype_name", "pack", "pack_into", "plan",
    "repack_into", "shard_ranges", "unpack",
    "ArenaEntry", "DeltaState", "TransferSession", "cache_stats",
    "cached_plan", "clear_cache", "get_entry", "get_session",
    "num_shards_of", "pack_traced", "repack_traced", "set_cache_limits",
    "unpack_traced",
    "Piece", "ShardedTensor", "resolve_mesh", "to_host",
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
