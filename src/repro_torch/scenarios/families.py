"""Scenario families — the paper's two workloads plus nine more.

Counterpart of ``repro/scenarios/families.py``: the families linear,
dense, ragged, mixed_dtype, sweep, model_state, sharded, sharded_delta,
mixed_policy, elastic and steady_reuse, registered in the reference's
order, with the same seeds, the same sizes and the same closed forms.
Payloads are drawn with numpy's ``default_rng`` exactly as the reference
draws them, then wrapped with
``torch.from_numpy``; a bf16 leaf is the float32 array cast with
``.to(torch.bfloat16)`` (bit-equal to the reference's ``astype``); header
scalars are 0-d int32 tensors.

model_state's trees are the port's own smoke params (``torch.Generator``
seeded with 0): the same paths, shapes and dtypes as the reference's, not
its values, which ``jax.random`` draws.  Motion depends on structure only.

sharded, sharded_delta, mixed_policy and elastic are sized by a mesh of k
positions.  The reference reads ``jax.device_count()`` when it builds
them; here k comes from the caller (``iter_scenarios(devices=k)``).
"""
from __future__ import annotations

import functools
from typing import Any, List, Optional

import numpy as np
import torch

from ..core import TransferSpec, TreePath
from .base import Motion, Scenario, register

LINEAR_LAYOUTS = ("allinit-allused", "allinit-LLused", "LLinit-LLused")

_I32 = 4  # header field bytes (int32)
_F32 = 4  # payload element bytes (float32)


def _i32(v: int) -> torch.Tensor:
    """A header scalar: the reference's ``np.int32(v)``."""
    return torch.tensor(v, dtype=torch.int32)


def _f32(rng: np.random.Generator, n: int) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(n).astype(np.float32))


def _bf16(rng: np.random.Generator, n: int) -> torch.Tensor:
    return torch.from_numpy(
        rng.standard_normal(n).astype(np.float32)).to(torch.bfloat16)


def chain_access_set(tree: Any, *paths: str,
                     header_fields=("nA", "nL")) -> List[str]:
    """The leaves a demand-paging dereference of ``paths`` touches: every
    node header along each chain, plus the final leaf."""
    out: List[str] = []
    seen = set()

    def add(p: str) -> None:
        if p not in seen:
            seen.add(p)
            out.append(p)

    for path in paths:
        tp = TreePath.parse(path)
        for i in range(1, tp.depth):
            prefix = TreePath(tp.steps[:i])
            for h in header_fields:
                hp = prefix.child(h)
                if hp.exists(tree):
                    add(str(hp))
        add(str(tp))
    return out


# -- linear (paper Fig. 3) ---------------------------------------------------

def linear_tree(k: int, n: int, layout: str) -> Any:
    """Fig. 3: L1 -> ... -> Lk, each level with header + payload A[n]."""
    all_init = layout.startswith("allinit")
    tree = None
    for level in range(k, 0, -1):
        init = all_init or level == k
        node = {"nA": _i32(n), "nL": _i32(level),
                "pad": torch.zeros(4, dtype=torch.int32),
                "A": _f32(np.random.default_rng(level), n if init else 1)}
        if tree is not None:
            node["Lnext"] = tree
        tree = node
    return {"L1": tree}


def linear_chain(k: int) -> str:
    return "L1" + ".Lnext" * (k - 1) + ".A"


def linear_used_paths(k: int, layout: str) -> List[str]:
    if layout.endswith("allused"):
        return ["L1" + ".Lnext" * (i - 1) + ".A" for i in range(1, k + 1)]
    return [linear_chain(k)]


def linear_expected(k: int, n: int, layout: str) -> dict:
    """Paper Eq. 1-2 at this repo's field widths: a 24-byte int32 header
    per level and a float32 payload of n (initialized) or 1 elements."""
    header = 6 * _I32
    all_init = layout.startswith("allinit")
    payload_elems = n * k if all_init else n + (k - 1)
    marshal = Motion(header * k + _F32 * payload_elems, 2)
    used = Motion(_F32 * n * k, k) if layout.endswith("allused") \
        else Motion(_F32 * n, 1)
    return {"marshal": marshal, "uvm": used, "pointerchain": used}


def linear_case(k: int, n: int, layout: str) -> Scenario:
    return Scenario(
        name=f"linear_k{k}_n{n}_{layout}",
        family="linear",
        build=functools.partial(linear_tree, k, n, layout),
        used_paths=tuple(linear_used_paths(k, layout)),
        expected=linear_expected(k, n, layout),
        params=dict(k=k, n=n, layout=layout))


@register("linear")
def _linear_family(size: str) -> List[Scenario]:
    k, n = {"smoke": (4, 64), "quick": (6, 1000), "full": (6, 1000)}[size]
    return [linear_case(k, n, layout) for layout in LINEAR_LAYOUTS]


# -- dense (paper Fig. 4) ----------------------------------------------------

def dense_tree(q: int, n: int, depth: int = 3, seed: int = 0) -> Any:
    """Fig. 4: each level is an ARRAY of q structures; every node carries
    A[n] of seeded nonzero randoms."""
    rng = np.random.default_rng(seed)

    def build(d):
        node = {"nA": _i32(n), "A": _f32(rng, n)}
        if d > 0:
            node["nL"] = _i32(q)
            node["Lnext"] = [build(d - 1) for _ in range(q)]
        return node

    return {"a0": build(depth)}


def dense_chain(q: int, depth: int = 3) -> str:
    return "a0" + "".join(f".Lnext[{q - 1}]" for _ in range(depth)) + ".A"


def dense_uvm_access_set(q: int, depth: int = 3) -> List[str]:
    """The headers of every node along the chain, plus the final A."""
    out = []
    prefix = "a0"
    for _ in range(depth):
        out.append(prefix + ".nA")
        out.append(prefix + ".nL")
        prefix += f".Lnext[{q - 1}]"
    out.append(prefix + ".nA")
    out.append(prefix + ".A")
    return out


def dense_expected(q: int, n: int, depth: int) -> dict:
    """Paper Eq. 3 at this repo's field widths: interior nodes carry 8-byte
    headers (nA + nL), leaf nodes 4 (nA), every node a float32 A[n]."""
    interior = sum(q ** i for i in range(depth))
    leaves = q ** depth
    marshal = Motion(interior * (2 * _I32 + _F32 * n)
                     + leaves * (_I32 + _F32 * n), 2)
    uvm = Motion(2 * _I32 * depth + _I32 + _F32 * n, 2 * depth + 2)
    return {"marshal": marshal, "uvm": uvm, "pointerchain": Motion(_F32 * n, 1)}


def dense_case(q: int, n: int, depth: int = 3) -> Scenario:
    return Scenario(
        name=f"dense_q{q}_n{n}_d{depth}",
        family="dense",
        build=functools.partial(dense_tree, q, n, depth),
        used_paths=(dense_chain(q, depth),),
        uvm_access=tuple(dense_uvm_access_set(q, depth)),
        expected=dense_expected(q, n, depth),
        params=dict(q=q, n=n, depth=depth))


@register("dense")
def _dense_family(size: str) -> List[Scenario]:
    if size == "smoke":
        return [dense_case(2, 64, 2)]
    if size == "quick":
        return [dense_case(4, 1000, 3)]
    return [dense_case(4, 1000, 3), dense_case(8, 1000, 3)]


# -- ragged — uneven fanout, uneven payloads ---------------------------------

def ragged_tree(n: int, seed: int = 7) -> Any:
    """Uneven fanout (3/0/1 children at level 1) and per-branch payload
    sizes from n//4 to 3n."""
    rng = np.random.default_rng(seed)

    def node(size: int, kids: Optional[list] = None) -> dict:
        out = {"nA": _i32(size), "A": _f32(rng, size)}
        if kids:
            out["nL"] = _i32(len(kids))
            out["kids"] = kids
        return out

    return {"root": node(n, [
        node(2 * n, [node(n // 4, []), node(3 * n, [])]),
        node(n // 2, []),
        node(n, [node(2 * n, [node(n, [])])]),
    ])}


def ragged_case(n: int) -> Scenario:
    used = ("root.kids[2].kids[0].kids[0].A",   # deepest branch
            "root.kids[0].kids[1].A",           # biggest payload
            "root.kids[1].A")                   # shallow small leaf
    skel = ragged_tree(4)   # access paths depend only on the structure
    return Scenario(
        name=f"ragged_n{n}",
        family="ragged",
        build=functools.partial(ragged_tree, n),
        used_paths=used,
        uvm_access=tuple(chain_access_set(skel, *used)),
        params=dict(n=n))


@register("ragged")
def _ragged_family(size: str) -> List[Scenario]:
    return [ragged_case(32 if size == "smoke" else 512)]


# -- mixed_dtype — multiple marshalling buckets ------------------------------

def mixed_dtype_tree(n: int, seed: int = 11) -> Any:
    """f32 / i32 / bf16 leaves: one marshalling bucket per dtype."""
    rng = np.random.default_rng(seed)
    return {
        "meta": {"count": _i32(n),
                 "ids": torch.arange(2 * n, dtype=torch.int32)},
        "f32": {"a": _f32(rng, n), "b": _f32(rng, n // 2)},
        "bf16": {"w": _bf16(rng, n)},
    }


def mixed_dtype_case(n: int) -> Scenario:
    used = ("f32.a", "bf16.w")
    return Scenario(
        name=f"mixed_dtype_n{n}",
        family="mixed_dtype",
        build=functools.partial(mixed_dtype_tree, n),
        used_paths=used,
        uvm_access=tuple(["meta.count"] + list(used)),
        params=dict(n=n))


@register("mixed_dtype")
def _mixed_dtype_family(size: str) -> List[Scenario]:
    return [mixed_dtype_case(48 if size == "smoke" else 1024)]


# -- sweep — the depth/width extremes ----------------------------------------

def deep_narrow_tree(depth: int, n: int, seed: int = 3) -> Any:
    """A depth-k chain of single-child nodes with one payload at the end."""
    rng = np.random.default_rng(seed)
    tree: dict = {"nA": _i32(n), "A": _f32(rng, n)}
    for level in range(depth - 1, 0, -1):
        tree = {"nA": _i32(level), "next": tree}
    return {"root": tree}


def deep_narrow_chain(depth: int) -> str:
    return "root" + ".next" * (depth - 1) + ".A"


def wide_shallow_tree(width: int, n: int, seed: int = 5) -> Any:
    """One level, ``width`` siblings: fanout with no nesting."""
    rng = np.random.default_rng(seed)
    return {"root": {"nL": _i32(width),
                     "kids": [{"nA": _i32(n), "A": _f32(rng, n)}
                              for _ in range(width)]}}


def deep_narrow_case(depth: int, n: int) -> Scenario:
    used = (deep_narrow_chain(depth),)
    skel = deep_narrow_tree(depth, 1)
    return Scenario(
        name=f"deep_narrow_d{depth}_n{n}",
        family="sweep",
        build=functools.partial(deep_narrow_tree, depth, n),
        used_paths=used,
        uvm_access=tuple(chain_access_set(skel, *used)),
        params=dict(depth=depth, n=n))


def wide_shallow_case(width: int, n: int) -> Scenario:
    used = tuple(f"root.kids[{i}].A" for i in range(width))
    skel = wide_shallow_tree(width, 1)
    return Scenario(
        name=f"wide_shallow_w{width}_n{n}",
        family="sweep",
        build=functools.partial(wide_shallow_tree, width, n),
        used_paths=used,
        uvm_access=tuple(chain_access_set(skel, *used)),
        params=dict(width=width, n=n))


@register("sweep")
def _sweep_family(size: str) -> List[Scenario]:
    if size == "smoke":
        return [deep_narrow_case(6, 16), wide_shallow_case(8, 16)]
    return [deep_narrow_case(24, 64), wide_shallow_case(64, 256)]


# -- model_state — real parameter trees at smoke scale -----------------------

@functools.lru_cache(maxsize=None)
def _model_params(arch_id: str) -> Any:
    """The arch's smoke params on the host, from a generator seeded with 0.
    Cached per process and read-only: no scheme writes a host leaf."""
    from ..models import registry as model_registry

    api = model_registry.get(arch_id, smoke=True)
    return api.init(torch.Generator().manual_seed(0), device="cpu")


def model_state_case(arch_id: str) -> Scenario:
    slug = arch_id.replace("-", "_").replace(".", "_")
    return Scenario(
        name=f"model_state_{slug}",
        family="model_state",
        build=functools.partial(_model_params, arch_id),
        # interior chains: declare() expands them to every leaf below
        used_paths=("embed", "final_norm"),
        uvm_access=None,
        params=dict(arch=arch_id))


@register("model_state")
def _model_state_family(size: str) -> List[Scenario]:
    archs = ["llama3.2-1b"] if size == "smoke" \
        else ["llama3.2-1b", "mamba2-1.3b"]
    return [model_state_case(a) for a in archs]


# -- sharded — per-device arenas over the whole mesh -------------------------

def sharded_tree(n: int, k: int, seed: int = 13) -> Any:
    """Two f32 payloads and an i32 id table, all 1-D with sizes divisible by
    the mesh size ``k``, so every copy splits evenly per device."""
    rng = np.random.default_rng(seed)
    return {"w": _f32(rng, n), "v": _f32(rng, 3 * n),
            "ids": torch.arange(4 * k, dtype=torch.int32)}


def _sharded_motion(marshal_bytes: int, used_bytes: int, k: int) -> dict:
    """Two buckets (marshal) or two used leaves (per-leaf schemes), each
    one copy per device; a delta transfer's COLD pass is marshal's."""
    if k == 1:
        marshal, per_leaf = Motion(marshal_bytes, 2), Motion(used_bytes, 2)
    else:
        marshal = Motion(marshal_bytes, 2 * k, marshal_bytes // k, 2)
        per_leaf = Motion(used_bytes, 2 * k, used_bytes // k, 2)
    return {"marshal": marshal, "marshal_delta": marshal,
            "uvm": per_leaf, "pointerchain": per_leaf}


def sharded_expected(n: int, k: int) -> dict:
    """Closed-form per-device Motion on a k-device mesh: marshal ships one
    contiguous sub-range per (bucket, device) of the f32 bucket (w + v, 4n
    elements) and the i32 bucket (4k); the per-leaf schemes split w and v
    k ways."""
    return _sharded_motion(_F32 * 4 * n + _I32 * 4 * k, _F32 * 4 * n, k)


def sharded_case(n: int, k: int) -> Scenario:
    used = ("w", "v")
    return Scenario(
        name=f"sharded_n{n}_dev{k}",
        family="sharded",
        build=functools.partial(sharded_tree, n, k),
        used_paths=used,
        uvm_access=used,
        expected=sharded_expected(n, k),
        sharding=k,
        params=dict(n=n, devices=k))


@register("sharded", mesh=True)
def _sharded_family(size: str, k: int) -> List[Scenario]:
    return [sharded_case((16 if size == "smoke" else 256) * k, k)]


# -- sharded_delta — per-device incremental transfers (marshal+delta@dpk) ----

def sharded_delta_tree(n: int, k: int, seed: int = 19) -> Any:
    """Two hot f32 leaves that mutate every pass, a cold f32 leaf that never
    does, and a frozen i32 id table.  Dict keys flatten in sorted order, so
    the f32 bucket is ``cold[2n] | hot.a[n] | hot.b[n]``: mutating the hot
    leaves dirties exactly the trailing ``ceil(k/2)`` shards of it."""
    rng = np.random.default_rng(seed)
    return {"hot": {"a": _f32(rng, n), "b": _f32(rng, n)},
            "cold": _f32(rng, 2 * n),
            "ids": torch.arange(4 * k, dtype=torch.int32)}


def sharded_delta_expected(n: int, k: int) -> dict:
    """Cold-pass closed forms: the f32 bucket is 4n elements and the i32
    bucket 4k (marshal); the used leaves hot.a and cold are 3n f32."""
    return _sharded_motion(_F32 * 4 * n + _I32 * 4 * k, _F32 * 3 * n, k)


def sharded_delta_steady_expected(n: int, k: int) -> Motion:
    """ONE steady pass after mutating hot.a and hot.b: the mutated region is
    elements [2n, 4n) of the f32 bucket, whose shard is 4n/k elements, so
    exactly the shards overlapping it ship (one copy each, a full shard of
    bytes) and every other (bucket, device) shard is skipped."""
    if k == 1:
        return Motion(_F32 * 4 * n, 1)    # the whole f32 bucket, one copy
    step = (4 * n) // k
    first_dirty = (2 * n) // step
    by_shard = tuple((step * _F32, 1) if s >= first_dirty else (0, 0)
                     for s in range(k))
    dirty = k - first_dirty               # == ceil(k/2)
    return Motion(dirty * step * _F32, dirty, by_shard=by_shard)


def sharded_delta_case(n: int, k: int) -> Scenario:
    used = ("hot.a", "cold")
    return Scenario(
        name=f"sharded_delta_n{n}_dev{k}",
        family="sharded_delta",
        build=functools.partial(sharded_delta_tree, n, k),
        used_paths=used,
        uvm_access=used,
        expected=sharded_delta_expected(n, k),
        sharding=k,
        steady_expected=sharded_delta_steady_expected(n, k),
        steady_spec=TransferSpec("marshal", delta=True, sharding=k),
        params=dict(n=n, devices=k, mutate_paths=("hot.a", "hot.b")))


@register("sharded_delta", mesh=True)
def _sharded_delta_family(size: str, k: int) -> List[Scenario]:
    return [sharded_delta_case((4 if size == "smoke" else 64) * k, k)]


# -- mixed_policy — path-scoped policies over model-shaped state -------------

def _params_cold(n: int, k: int) -> Motion:
    """The params region: one f32 bucket of 3n elements (w + b), 12n bytes
    in one copy (per device 12n/k bytes, one copy each on a k-mesh)."""
    return Motion(12 * n, 1) if k == 1 else Motion(12 * n, k, 12 * n // k, 1)


def mixed_policy_tree(n: int, seed: int = 23) -> Any:
    """Sharded params, hot optimizer state, and metadata: three regions no
    single whole-tree spec serves well."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": _f32(rng, 2 * n), "b": _f32(rng, n)},
        "opt": {"m": _f32(rng, n), "v": _f32(rng, n), "t": _i32(0)},
        "meta": {"ids": torch.arange(2 * n, dtype=torch.int32),
                 "scale": _f32(rng, n)},
    }


def mixed_policy_case(n: int, k: int) -> Scenario:
    """Closed-form per-region Motion for the declared policy
    ``params/**=marshal@dp{k}; opt/**=marshal+delta; **=pointerchain``:

    * params — one f32 bucket of 3n elements (w + b): 12n bytes, 1 copy
      (per device 12n/k bytes, one copy each on a k-mesh).
    * opt — f32 bucket (m + v, 8n bytes) + i32 bucket (t, 4 bytes): cold
      8n + 4 bytes in 2 copies; steady after mutating ``opt.m`` the f32
      bucket ships whole (8n, 1) and the i32 bucket is skipped.
    * default (meta) — pointerchain, one copy per leaf every pass: ids
      (8n) + scale (4n) = 12n bytes in 2 copies.
    """
    pol = f"params/**=marshal@dp{k}; opt/**=marshal+delta; **=pointerchain"
    params_cold = _params_cold(n, k)
    meta = Motion(12 * n, 2)
    return Scenario(
        name=f"mixed_policy_n{n}_dev{k}",
        family="mixed_policy",
        build=functools.partial(mixed_policy_tree, n),
        used_paths=("params.w", "opt.m", "meta.scale"),
        uvm_access=None,
        declared_policy=pol,
        region_expected={"params/**": params_cold,
                         "opt/**": Motion(8 * n + 4, 2),
                         "**": meta},
        steady_region_expected={"params/**": params_cold,
                                "opt/**": Motion(8 * n, 1),
                                "**": meta},
        params=dict(n=n, devices=k, mutate_paths=("opt.m",)))


@register("mixed_policy", mesh=True)
def _mixed_policy_family(size: str, k: int) -> List[Scenario]:
    return [mixed_policy_case((8 if size == "smoke" else 128) * k, k)]


# -- elastic — the restore-onto-a-changed-mesh state shape -------------------

def elastic_tree(n: int, seed: int = 29) -> Any:
    """The train state an elastic restart restores: dp-sharded params,
    delta optimizer state and a marshalled step counter."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": _f32(rng, 2 * n), "b": _f32(rng, n)},
        "opt": {"mu": _f32(rng, 2 * n), "nu": _f32(rng, n), "t": _i32(0)},
        "step": _i32(0),
    }


def elastic_case(n: int, k: int) -> Scenario:
    """Closed-form per-region Motion for the restore policy
    ``params/**=marshal@dp{k}; opt/**=marshal+delta; **=marshal``:

    * params — one f32 bucket of 3n elements (w + b): 12n bytes, 1 copy
      (per device 12n/k bytes, one copy each on a k-mesh): the bytes an
      n -> m restore re-ships per surviving device.
    * opt — f32 bucket (mu + nu, 12n bytes) + i32 bucket (t, 4): cold
      12n + 4 bytes in 2 copies; steady after mutating ``opt.mu`` the f32
      bucket ships whole (12n, 1), the i32 bucket is skipped.
    * default (step) — 4 bytes, 1 copy, every pass.
    """
    pol = f"params/**=marshal@dp{k}; opt/**=marshal+delta; **=marshal"
    params_cold = _params_cold(n, k)
    return Scenario(
        name=f"elastic_n{n}_dev{k}",
        family="elastic",
        build=functools.partial(elastic_tree, n),
        used_paths=("params.w", "opt.mu"),
        uvm_access=None,
        declared_policy=pol,
        region_expected={"params/**": params_cold,
                         "opt/**": Motion(12 * n + 4, 2),
                         "**": Motion(4, 1)},
        steady_region_expected={"params/**": params_cold,
                                "opt/**": Motion(12 * n, 1),
                                "**": Motion(4, 1)},
        params=dict(n=n, devices=k, mutate_paths=("opt.mu",)))


@register("elastic", mesh=True)
def _elastic_family(size: str, k: int) -> List[Scenario]:
    return [elastic_case((8 if size == "smoke" else 128) * k, k)]


# -- steady_reuse — the delta transfer steady state --------------------------

def steady_reuse_tree(n: int, seed: int = 17) -> Any:
    """A hot f32 part that changes every step, frozen bf16 weights and an
    i32 id table that never do; each dtype is its own bucket."""
    rng = np.random.default_rng(seed)
    return {
        "hot": {"a": _f32(rng, n), "b": _f32(rng, n // 2)},
        "frozen": {"w": _bf16(rng, 4 * n)},
        "meta": {"ids": torch.arange(2 * n, dtype=torch.int32)},
    }


def steady_reuse_case(n: int) -> Scenario:
    used = ("hot.a", "frozen.w")
    f32_bucket = _F32 * (n + n // 2)      # hot.a + hot.b share the f32 bucket
    return Scenario(
        name=f"steady_reuse_n{n}",
        family="steady_reuse",
        build=functools.partial(steady_reuse_tree, n),
        used_paths=used,
        uvm_access=tuple(["meta.ids"] + list(used)),
        # mutating hot.a dirties ONLY the f32 bucket: one copy of its bytes
        steady_expected=Motion(f32_bucket, 1),
        steady_spec=TransferSpec("marshal", delta=True),
        params=dict(n=n, mutate_path="hot.a"))


@register("steady_reuse")
def _steady_reuse_family(size: str) -> List[Scenario]:
    return [steady_reuse_case(64 if size == "smoke" else 2048)]
