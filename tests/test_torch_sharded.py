"""Sharded deep copy (``@dpK``, K > 1) on the port, held to the JAX package.

The port runs a K-position mesh on the CPU with ``device="cpu"`` (the
counterpart of the reference's forced host device count).  Held here:

  * ``shard_ranges`` / ``resolve_shards`` equal the reference's on the same
    layouts at K = 1, 2, 4 and 8, the divisibility error included;
  * K = 1 in process: ``uvm@dp1`` and ``pointerchain@dp1`` values and
    ledgers against the reference; ``marshal@dp1`` and ``marshal+delta@dp1``
    against the closed forms (the reference's marshal Algorithm 2 fails at
    ``@dpK`` for every K: ROADMAP R1);
  * K = 2 and 4: the reference's closed forms and structural derivations,
    the port's per-position ledgers equal to both, values equal to
    ``copy.deepcopy`` of the host tree;
  * the reference's own 4-device run (one subprocess per test module, with
    ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` set in the child
    only): Algorithm 2 under ``uvm@dp4`` / ``pointerchain@dp4`` and the
    ``mixed_policy`` / ``elastic`` programs over three passes under both
    executors, per-device ledgers equal;
  * the mesh rules (the default mesh's stale-mesh error, explicit meshes),
    ``full_deepcopy(sharding=)``, ``chain_call`` / ``chain_jit``.
"""
import copy
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import ml_dtypes  # noqa: F401  (registers numpy's bfloat16 for the reference)
import numpy as np
import pytest
import torch

from repro import scenarios as RS
from repro.core import arena as r_arena
from repro.core import chainref as r_chainref
from repro.core import clear_cache as r_clear_cache
from repro.core import declare as r_declare
from repro.core import extract as r_extract
from repro.core import insert as r_insert
from repro.core import transfer_scheme as r_transfer_scheme
from repro.core.treepath import leaf_paths as r_leaf_paths
from repro.scenarios import driver as r_driver
from repro.scenarios import families as r_families

from repro_torch import NoCudaDeviceError
from repro_torch import scenarios as PS
from repro_torch.convert import from_reference_tree, to_reference_tree
from repro_torch.core import (ShardedTensor, TransferSession, TransferSpec,
                              UnsupportedSpecError, chain_call, chain_jit,
                              declare, extract, full_deepcopy, insert, plan,
                              resolve_mesh,
                              resolve_shards, selective_deepcopy,
                              shard_ranges, to_host, transfer_scheme,
                              tree_leaves)

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]
SHARDED = ("sharded", "sharded_delta")

# -- the reference's own 4-device run ----------------------------------------

_CHILD = r'''
import json
import jax
from repro.scenarios import (iter_scenarios, run_policy_scenario,
                             run_scenario, run_steady_scenario)

assert jax.device_count() == 4, jax.device_count()


def regions(m):
    return {k: {f: r[f] for f in ("h2d_bytes", "h2d_calls", "skipped_bytes",
                                   "h2d_bytes_by_device",
                                   "h2d_calls_by_device",
                                   "skipped_bytes_by_device")}
            for k, r in m.regions.items()}


out = {"alg2": {}, "steady": {}, "policy": {}}
for size in ("smoke", "quick"):
    for sc in iter_scenarios(size, only=["sharded", "sharded_delta"]):
        for spec in ("uvm@dp4", "pointerchain@dp4"):
            m = run_scenario(sc, spec)
            out["alg2"][f"{sc.name}/{spec}"] = dict(
                ok=m.ok, motion_ok=m.motion_ok, h2d_bytes=m.h2d_bytes,
                h2d_calls=m.h2d_calls,
                per_device={d: list(v) for d, v in m.per_device.items()})
    for sc in iter_scenarios(size, only=["sharded_delta"]):
        out["steady"][sc.name] = [
            dict(ok=m.ok, motion_ok=m.motion_ok, h2d_bytes=m.h2d_bytes,
                 h2d_calls=m.h2d_calls, skipped_bytes=m.skipped_bytes,
                 h2d_by_device=m.h2d_by_device,
                 skipped_by_device=m.skipped_by_device)
            for m in run_steady_scenario(sc, passes=3)]
    for sc in iter_scenarios(size, only=["mixed_policy", "elastic"]):
        for executor in ("blocking", "async"):
            out["policy"][f"{sc.name}/{executor}"] = [
                dict(ok=m.ok, motion_ok=m.motion_ok, syncs=m.syncs,
                     regions=regions(m))
                for m in run_policy_scenario(sc, passes=3,
                                             executor=executor)]
print(json.dumps(out))
'''


@functools.lru_cache(maxsize=None)
def reference_four_devices() -> dict:
    """The reference on a forced 4-device host, run once per process."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _CHILD], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ref4():
    return reference_four_devices()


def _mt(m):
    """A Motion of either package as plain data."""
    return m.as_tuple() + (m.per_device_tuple(), m.by_shard)


def _sizes(family, k):
    return {size: PS.iter_scenarios(size, only=[family], devices=k)[0]
            for size in ("smoke", "quick")}


# -- shard ranges and per-shard chains ---------------------------------------

def _layout_trees():
    trees = {sc.name: sc.build()
             for sc in RS.iter_scenarios("smoke", only=[
                 "dense", "ragged", "mixed_dtype", "mixed_policy",
                 "sharded_delta"])}
    trees["odd"] = {"a": np.arange(7, dtype=np.float32),
                    "b": np.arange(5, dtype=np.int32),
                    "c": np.float32(1.5)}
    return trees


_TREES = _layout_trees()


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("name", sorted(_TREES))
def test_shard_ranges_and_resolve_shards_equal_the_reference(name, k):
    ref_tree = _TREES[name]
    tree = from_reference_tree(ref_tree)
    want_layout = r_arena.plan(ref_tree, shard_multiple=k)
    got_layout = plan(tree, shard_multiple=k)
    assert got_layout.bucket_sizes == want_layout.bucket_sizes
    assert shard_ranges(got_layout) == r_arena.shard_ranges(want_layout)
    all_paths = [str(p) for p in r_leaf_paths(ref_tree)]
    for r_ref, p_ref in zip(r_declare(ref_tree, *all_paths),
                            declare(tree, *all_paths)):
        want = r_chainref.resolve_shards(r_ref, want_layout)
        got = resolve_shards(p_ref, got_layout)
        assert [(s.shard, s.bucket, s.lo, s.hi, s.local_lo, s.size)
                for s in got] == \
            [(s.shard, s.bucket, s.lo, s.hi, s.local_lo, s.size)
             for s in want]


@pytest.mark.parametrize("k", [2, 4, 8])
def test_shard_ranges_divisibility_error_equals_the_reference(k):
    ref_tree = _TREES["odd"]
    with pytest.raises(ValueError) as want:
        r_arena.shard_ranges(r_arena.plan(ref_tree), k)
    with pytest.raises(ValueError) as got:
        shard_ranges(plan(from_reference_tree(ref_tree)), k)
    assert str(got.value) == str(want.value)


# -- K = 1: the reference in process ------------------------------------------

_DP1 = [(f, s) for f in SHARDED for s in ("uvm@dp1", "pointerchain@dp1")]


@pytest.mark.parametrize("family,spec", _DP1)
def test_dp1_per_leaf_values_and_ledgers_equal_the_reference(family, spec):
    r_clear_cache()
    ref_sc = RS.iter_scenarios("smoke", only=[family])[0]
    sc = PS.iter_scenarios("smoke", only=[family])[0]
    assert sc.name == ref_sc.name and sc.num_shards == 1
    assert [str(s) for s in sc.specs()] == [str(s) for s in ref_sc.specs()]
    ref_tree = ref_sc.build()
    want = RS.run_scenario(ref_sc, spec, tree=ref_tree)
    got = PS.run_scenario(sc, spec, tree=from_reference_tree(ref_tree),
                          device=CPU)
    assert want.ok and want.motion_ok and got.ok and got.motion_ok
    assert (got.h2d_bytes, got.h2d_calls, got.skipped_bytes) == \
        (want.h2d_bytes, want.h2d_calls, want.skipped_bytes)
    assert got.per_device == {d: tuple(v)
                              for d, v in want.per_device.items()}
    # the copied-back host tree: bit for bit the reference's
    scheme = r_transfer_scheme(spec)
    refs = r_declare(ref_tree, *ref_sc.used_paths)
    dev, _ = scheme.stage(ref_tree, list(ref_sc.used_paths),
                          uvm_access=list(ref_sc.uvm_access),
                          declare_refs=False)
    ref_host = scheme.from_device(
        r_insert(dev, refs, r_driver._KERNEL(*r_extract(dev, refs))),
        ref_tree)
    port = transfer_scheme(spec, device=CPU)
    tree = from_reference_tree(ref_tree)
    prefs = declare(tree, *sc.used_paths)
    pdev, _ = port.stage(tree, list(sc.used_paths),
                         uvm_access=list(sc.uvm_access), declare_refs=False)
    host = port.from_device(
        insert(pdev, prefs, PS.scale_kernel(extract(pdev, prefs))), tree)
    for g, w in zip(jax.tree_util.tree_leaves(to_reference_tree(host)),
                    jax.tree_util.tree_leaves(ref_host)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("spec", ["marshal@dp1", "marshal+delta@dp1"])
@pytest.mark.parametrize("family", SHARDED)
def test_dp1_marshal_equals_the_closed_forms(family, spec):
    sc = PS.iter_scenarios("smoke", only=[family])[0]
    ref_sc = RS.iter_scenarios("smoke", only=[family])[0]
    m = PS.run_scenario(sc, spec, device=CPU)
    want = ref_sc.expected[m.scheme]
    assert m.ok and m.motion_ok and (m.h2d_bytes, m.h2d_calls) == \
        want.as_tuple()
    assert m.per_device == {"0": want.as_tuple()}


# -- K = 2, 4: closed forms, derivations, ledgers, values ---------------------

_SPECS = ("uvm", "marshal", "marshal+delta", "pointerchain")
_KCELLS = [(f, k, s) for f in SHARDED for k in (2, 4) for s in _SPECS]


@pytest.mark.parametrize("family,k,spec", _KCELLS,
                         ids=[f"{f}-dev{k}-{s}" for f, k, s in _KCELLS])
def test_sharded_algorithm2_equals_closed_forms_derivations_and_deepcopy(
        family, k, spec):
    for size, sc in _sizes(family, k).items():
        n = sc.params["n"]
        ref_sc = getattr(r_families, f"{family}_case")(n, k)
        assert sc.name == ref_sc.name and sc.num_shards == k
        closed = getattr(r_families, f"{family}_expected")(n, k)
        spec_k = f"{spec}@dp{k}"
        name = TransferSpec.parse(spec_k).name
        ref_tree = ref_sc.build()
        tree = sc.build()
        for g, w in zip(jax.tree_util.tree_leaves(to_reference_tree(tree)),
                        jax.tree_util.tree_leaves(ref_tree)):
            np.testing.assert_array_equal(g, np.asarray(w))
        derived = RS.derive_motion(ref_tree, ref_sc.used_paths,
                                   ref_sc.uvm_access, name, num_shards=k)
        assert {key: _mt(v) for key, v in sc.expected.items()} == \
            {key: _mt(v) for key, v in closed.items()}
        assert closed[name] == derived
        assert _mt(PS.derive_motion(tree, sc.used_paths, sc.uvm_access,
                                    name, num_shards=k)) == _mt(derived)
        host = copy.deepcopy(tree)
        m = PS.run_scenario(sc, spec_k, tree=tree, device=CPU)
        assert m.ok and m.motion_ok, (size, m)
        assert m.per_device == {str(s): derived.per_device_tuple()
                                for s in range(k)}
        # the staged values are the host tree's, and staging left it whole
        scheme = sc.scheme_for(spec_k, device=CPU)
        dev = scheme.to_device(tree)
        if spec == "uvm":
            dev = scheme.materialize(dev)
        for a, b in zip(tree_leaves(dev), tree_leaves(host)):
            assert isinstance(a, ShardedTensor)
            assert torch.equal(to_host(a), b)
        for a, b in zip(tree_leaves(tree), tree_leaves(host)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("family", SHARDED)
@pytest.mark.parametrize("k", [2, 4, 8])
def test_registry_at_k_equals_the_reference_closed_forms(family, k):
    for size in ("smoke", "quick", "full"):
        sc = PS.iter_scenarios(size, only=[family], devices=k)[0]
        n = (({"smoke": 16, "quick": 256, "full": 256} if family == "sharded"
              else {"smoke": 4, "quick": 64, "full": 64})[size]) * k
        ref_sc = getattr(r_families, f"{family}_case")(n, k)
        assert (sc.name, sc.used_paths, sc.uvm_access, dict(sc.params)) == \
            (ref_sc.name, ref_sc.used_paths, ref_sc.uvm_access,
             dict(ref_sc.params))
        # the reference's specs carry its (lazy) mesh; the axis is @dp{k}
        assert [str(s) for s in sc.specs()] == \
            [str(TransferSpec(s.kind, delta=s.delta, sharding=k))
             for s in ref_sc.specs()]
        if ref_sc.steady_expected is not None:
            want = ref_sc.steady_expected
            assert (sc.steady_expected.as_tuple(),
                    sc.steady_expected.by_shard) == \
                (want.as_tuple(), want.by_shard)
            assert str(sc.steady_spec) == f"marshal+delta@dp{k}"


def test_sharded_pointerchain_moves_only_declared_chains_per_position():
    sc = PS.sharded_case(64, 4)
    tree = sc.build()
    scheme = transfer_scheme("pointerchain@dp4", device=CPU)
    dev = scheme.to_device(tree, paths=["w"])
    assert isinstance(dev["w"], ShardedTensor)
    assert [(p.position, p.lo, p.hi) for p in dev["w"].pieces] == \
        [(s, 16 * s, 16 * (s + 1)) for s in range(4)]
    assert dev["v"] is tree["v"] and dev["ids"] is tree["ids"]
    assert scheme.ledger.per_device() == {str(s): (64, 1) for s in range(4)}


def test_marshal_leaf_straddling_a_shard_boundary_has_two_pieces():
    tree = {"a": torch.arange(6, dtype=torch.float32),
            "b": torch.arange(10, dtype=torch.float32)}
    scheme = transfer_scheme("marshal@dp4", device=CPU)
    dev = scheme.to_device(tree)
    # f32 bucket: a [0, 6) | b [6, 16), shards of 4 elements
    assert [(p.position, p.lo, p.hi) for p in dev["a"].pieces] == \
        [(0, 0, 4), (1, 4, 6)]
    assert [(p.position, p.lo, p.hi) for p in dev["b"].pieces] == \
        [(1, 0, 2), (2, 2, 6), (3, 6, 10)]
    back = scheme.from_device(dev, tree)
    assert all(torch.equal(back[k], tree[k]) for k in tree)
    assert scheme.ledger.d2h_calls == 1 and scheme.ledger.d2h_bytes == 64


# -- the reference's 4-device run ----------------------------------------------

_A2 = [(f, size, s) for f in SHARDED for size in ("smoke", "quick")
       for s in ("uvm@dp4", "pointerchain@dp4")]


@pytest.mark.parametrize("family,size,spec", _A2,
                         ids=[f"{f}-{z}-{s}" for f, z, s in _A2])
def test_four_device_algorithm2_equals_the_reference_run(
        family, size, spec, ref4):
    sc = PS.iter_scenarios(size, only=[family], devices=4)[0]
    want = ref4["alg2"][f"{sc.name}/{spec}"]
    m = PS.run_scenario(sc, spec, device=CPU)
    assert want["ok"] and want["motion_ok"] and m.ok and m.motion_ok
    assert (m.h2d_bytes, m.h2d_calls) == \
        (want["h2d_bytes"], want["h2d_calls"])
    assert {d: list(v) for d, v in m.per_device.items()} == \
        want["per_device"]


_POL = [(f, size, ex) for f in ("mixed_policy", "elastic")
        for size in ("smoke", "quick") for ex in ("blocking", "async")]


def _regions(m):
    return {k: {f: r[f] for f in ("h2d_bytes", "h2d_calls", "skipped_bytes",
                                   "h2d_bytes_by_device",
                                   "h2d_calls_by_device",
                                   "skipped_bytes_by_device")}
            for k, r in m.regions.items()}


@pytest.mark.parametrize("family,size,executor", _POL,
                         ids=[f"{f}-{z}-{e}" for f, z, e in _POL])
def test_four_device_policy_passes_equal_the_reference_run(
        family, size, executor, ref4):
    sc = PS.iter_scenarios(size, only=[family], devices=4)[0]
    want = ref4["policy"][f"{sc.name}/{executor}"]
    got = PS.run_policy_scenario(sc, passes=3, executor=executor,
                                 device=CPU, session=TransferSession())
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert w["ok"] and w["motion_ok"] and w["syncs"] == 1
        assert g.ok and g.motion_ok and g.syncs == 1
        assert _regions(g) == w["regions"]
    # every region's per-position ledger is its closed form on the cold pass
    for key, motion in sc.region_expected.items():
        led = got[0].regions[key]
        if motion.per_device_tuple() is not None:
            assert {d: (led["h2d_bytes_by_device"][d],
                        led["h2d_calls_by_device"][d])
                    for d in led["h2d_bytes_by_device"]} == \
                {str(s): motion.per_device_tuple() for s in range(4)}


# -- programs and policies at K > 1 -------------------------------------------

def test_compile_sharded_policy_on_cpu_positions():
    tree = {"a": torch.arange(8, dtype=torch.float32),
            "b": torch.arange(3, dtype=torch.int32)}
    prog = TransferSession().compile(tree, "**=marshal@dp2", device=CPU)
    assert prog.devices == (torch.device("cpu"),)
    out = prog.to_device(tree)
    assert all(torch.equal(to_host(out[k]), tree[k]) for k in tree)
    assert prog.last_stats.syncs == 1
    # f32 8 -> 4 + 4 elements, i32 3 padded to 4 -> 2 + 2
    assert prog.merged_ledger().per_device() == {"0": (24, 2), "1": (24, 2)}
    back = prog.from_device(out, tree)
    assert all(torch.equal(back[k], tree[k]) for k in tree)
    for k in (2, 4):
        for case in (PS.mixed_policy_case(16, k), PS.elastic_case(16, k)):
            for m in PS.run_policy_scenario(case, passes=2, device=CPU,
                                            session=TransferSession()):
                assert m.ok and m.motion_ok and m.syncs == 1


def test_resharded_policy_executes():
    sc = PS.mixed_policy_case(16, 4)
    policy = sc.policy().reshard(2)
    assert str(policy).startswith("params/**=marshal@dp2")
    ms = PS.run_policy_scenario(sc, policy, passes=2, device=CPU,
                                session=TransferSession())
    assert all(m.ok and m.motion_ok for m in ms)
    assert ms[0].regions["params/**"]["h2d_calls_by_device"] == \
        {"0": 1, "1": 1}


def test_full_deepcopy_sharded_and_by_policy():
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(4, 3),
            "s": torch.tensor(3, dtype=torch.int32),
            "odd": torch.arange(5, dtype=torch.float32)}
    out = full_deepcopy(tree, device=CPU, sharding=4)
    assert [(p.position, p.lo, p.hi) for p in out["w"].pieces] == \
        [(s, 3 * s, 3 * (s + 1)) for s in range(4)]
    # what the 1-D split cannot divide is replicated on every position
    assert [(p.lo, p.hi) for p in out["odd"].pieces] == [(0, 5)] * 4
    assert [(p.lo, p.hi) for p in out["s"].pieces] == [(0, 1)] * 4
    assert all(torch.equal(to_host(out[k]), tree[k]) for k in tree)
    by_policy = full_deepcopy(tree, device=CPU,
                              policy="w=marshal@dp2; **=marshal")
    assert isinstance(by_policy["w"], ShardedTensor)
    assert isinstance(by_policy["odd"], torch.Tensor)
    assert all(torch.equal(to_host(by_policy[k]), tree[k]) for k in tree)
    sel = selective_deepcopy(tree, ["w"], device=CPU, sharding=2)
    assert isinstance(sel["w"], ShardedTensor) and sel["odd"] is tree["odd"]
    with pytest.raises(ValueError, match="exclusive"):
        full_deepcopy(tree, device=CPU, policy="**=marshal", sharding=2)


# -- the mesh rules ------------------------------------------------------------

def test_meshes_resolve_as_declared(monkeypatch):
    assert resolve_mesh(CPU, 3) == (torch.device("cpu"),) * 3
    assert resolve_mesh([CPU, CPU, CPU], 2) == (torch.device("cpu"),) * 2
    with pytest.raises(UnsupportedSpecError, match="stale") as ei:
        resolve_mesh([CPU], 2)
    assert isinstance(ei.value, ValueError)
    s = transfer_scheme("pointerchain@dp4", device=[CPU] * 4)
    assert s.mesh == (torch.device("cpu"),) * 4
    # an unsharded spec on a mesh runs on its first position (@devN: N)
    assert transfer_scheme("marshal", device=[CPU]).device.type == "cpu"
    if not torch.cuda.is_available():
        # no card and no explicit CPU: raise, never fall back
        with pytest.raises(NoCudaDeviceError):
            transfer_scheme("marshal@dp2")
        # a short default mesh raises the reference's stale-mesh error
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="stale for this") as ei:
            transfer_scheme("marshal@dp2")
        assert "dp2 mesh, but only 1 device(s)" in str(ei.value)
        with pytest.raises(ValueError, match="stale for this"):
            TransferSession().compile({"a": torch.ones(4)},
                                      "**=marshal+delta@dp4")
        assert resolve_mesh(None, 1) == (torch.device("cuda", 0),)


def test_the_stale_mesh_message_is_the_reference_one():
    from repro.core.schemes import _default_dp_sharding

    with pytest.raises(ValueError) as want:
        _default_dp_sharding(jax.device_count() + 1)
    with pytest.raises(ValueError) as got:
        resolve_mesh([CPU] * jax.device_count(), jax.device_count() + 1)
    assert str(got.value) == str(want.value)


def test_num_shards_of_equals_the_reference():
    from repro.core import num_shards_of as r_num_shards_of
    from repro_torch.core import num_shards_of

    for target in (None, 1, 4, True):
        assert num_shards_of(target) == r_num_shards_of(target)
    assert num_shards_of((CPU,) * 4) == 4
    for bad in ("x", 2.0):
        with pytest.raises(TypeError):
            r_num_shards_of(bad)
        with pytest.raises(TypeError):
            num_shards_of(bad)


# -- chain_call / chain_jit ------------------------------------------------------

def _chain_tree():
    rng = np.random.default_rng(3)
    return {"a": {"x": rng.standard_normal(6).astype(np.float32),
                  "y": rng.standard_normal(4).astype(np.float32)},
            "b": np.arange(5, dtype=np.int32)}


def test_chain_call_and_chain_jit_equal_the_reference():
    ref_tree = _chain_tree()
    tree = from_reference_tree(ref_tree)

    def fn(x, y, s):
        return x * s, y + s

    want = r_chainref.chain_call(fn, ref_tree, ["a.x", "a.y"], 2.0, jit=True)
    got = chain_call(fn, tree, ["a.x", "a.y"], 2.0, jit=True)
    for g, w in zip(jax.tree_util.tree_leaves(to_reference_tree(got)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert chain_call(lambda x: None, tree, ["b"]) is tree
    with pytest.raises(ValueError, match="returned 1 leaves for 2"):
        chain_call(lambda x, y: x, tree, ["a.x", "a.y"])
    r_run = r_chainref.chain_jit(lambda x, y: (x * 3, y * 3), ["a"])
    run = chain_jit(lambda x, y: (x * 3, y * 3), ["a"], donate=True)
    for _ in range(2):          # the second call reuses the cached refs
        want, got = r_run(ref_tree), run(tree)
        for g, w in zip(jax.tree_util.tree_leaves(to_reference_tree(got)),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(g, np.asarray(w))
