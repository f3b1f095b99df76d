"""The port's policy scenarios held against the JAX package.

  * ``derive_policy_motion`` / ``derive_steady_policy_motion`` equal the
    reference's over the one-device policies of tests/test_torch_policy.py's
    matrix on five smoke trees (uvm, pointerchain, delta, ``+db``, aligned
    and ``@dev0`` regions) and several mutation sets, and on the declared
    policies of mixed_policy and elastic;
  * the port-only one-rule ``marshal+db`` policy is held to the structural
    form (marshal's motion, re-shipped every pass);
  * ``run_policy_scenario`` gives the reference's region ledgers, checks,
    syncs and enqueues pass for pass, under both executors;
  * ``run_algorithm2(policy=...)`` and ``(program=...)`` equal the
    reference's;
  * ``full_deepcopy(policy=...)`` is the value oracle of a program pass;
  * ``region_of``, ``region_ledger``, ``reset_ledgers`` and
    ``ProgramStats.offloaded_s`` behave as the reference's do.

Everything runs with ``device="cpu"``; the reference runs under
``JAX_PLATFORMS=cpu`` on its numpy trees, which the port takes with
``from_reference_tree``.
"""
import jax
import ml_dtypes  # noqa: F401  (registers numpy's bfloat16 for the reference)
import numpy as np
import pytest
import torch

from repro import scenarios as RS
from repro.core import ProgramStats as RProgramStats
from repro.core import TransferLedger as RTransferLedger
from repro.core import TransferSession as RTransferSession
from repro.core import clear_cache as r_clear_cache
from repro.core import full_deepcopy as r_full_deepcopy
from repro.core import leaf_paths as r_leaf_paths

from repro_torch import scenarios as PS
from repro_torch.convert import from_reference_tree
from repro_torch.core import (LazyLeaf, ProgramStats, TransferLedger,
                              TransferPolicy, TransferSession,
                              UnsupportedSpecError, full_deepcopy,
                              leaf_paths, tree_leaves)
from test_torch_policy import _LEDGER_FIELDS, _MATRIX

CPU = "cpu"
FAMILIES = ("linear", "dense", "ragged", "mixed_dtype", "sweep",
            "model_state", "mixed_policy", "elastic", "steady_reuse")
_REF = {sc.name: sc for size in ("smoke", "quick")
        for sc in RS.iter_scenarios(size, only=FAMILIES)}
_PORT = {sc.name: sc for size in ("smoke", "quick")
         for sc in PS.iter_scenarios(size)}
_SMOKE = [sc.name for sc in RS.iter_scenarios("smoke", only=FAMILIES)]
_DECLARED = [name for name, sc in _REF.items() if sc.declared_policy]
# the matrix's policies whose every rule runs on one device (no @dp4/@dp8)
_ONE_DEVICE = [t for t in _MATRIX if TransferPolicy.parse(t).num_shards == 1]


def _pattern_tree():
    """A tree every pattern of the matrix reaches: a/*/c, opt/m,
    opt/layers[3]/**, */w, params/** and root/kids[0]/A, in f32, i32 and
    bf16."""
    rng = np.random.default_rng(31)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"a": {"b": {"c": f32(5), "d": np.arange(3, dtype=np.int32)},
                  "x": {"c": np.arange(4, dtype=np.int32)}},
            "opt": {"m": f32(6), "t": np.int32(3),
                    "layers": [{"w": f32(2, 3)} for _ in range(5)]},
            "params": {"w": f32(8), "b": f32(4).astype("bfloat16")},
            "root": {"kids": [{"A": f32(7)}, {"A": f32(2)}]}}


def _ref_tree(name):
    if name == "pattern":
        return _pattern_tree()
    return _REF[name].build()


_TREES = ("pattern", "mixed_policy_n8_dev1", "elastic_n8_dev1", "ragged_n32",
          "model_state_llama3_2_1b")


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name in _TREES:
        ref = _ref_tree(name)
        out[name] = (ref, from_reference_tree(ref))
    return out


def _mutation_sets(ref_tree):
    """No mutation, the first leaf, the last, two leaves, and an interior
    chain (every leaf under the first top-level key)."""
    paths = [str(p) for p in r_leaf_paths(ref_tree)]
    first = paths[0].split(".")[0].split("[")[0]
    return [(), (paths[0],), (paths[-1],), (paths[0], paths[len(paths) // 2]),
            (first,)]


def _as_tuples(motions):
    return [(k, v.as_tuple()) for k, v in motions.items()]


# -- structural derivations --------------------------------------------------

_SAMPLE = _ONE_DEVICE[::4]


def test_one_device_sample_is_nontrivial():
    assert len(_SAMPLE) > 40
    assert any(t.count(";") == 2 for t in _SAMPLE)
    text = " ".join(_SAMPLE)
    for word in ("uvm", "pointerchain", "marshal+delta", "marshal+db",
                 "align64", "@dev0"):
        assert word in text, word


@pytest.mark.parametrize("policy", _SAMPLE)
def test_policy_derivations_equal_the_reference(policy, trees):
    for name, (ref_tree, port_tree) in trees.items():
        assert _as_tuples(PS.derive_policy_motion(port_tree, policy)) == \
            _as_tuples(RS.derive_policy_motion(ref_tree, policy)), name
        for mutate in _mutation_sets(ref_tree):
            want = RS.derive_steady_policy_motion(ref_tree, policy, mutate)
            got = PS.derive_steady_policy_motion(port_tree, policy, mutate)
            assert _as_tuples(got) == _as_tuples(want), (name, mutate)


@pytest.mark.parametrize("name", _DECLARED)
def test_declared_closed_forms_equal_both_derivations(name):
    ref_sc, sc = _REF[name], _PORT[name]
    tree = sc.build()
    assert str(sc.policy()) == str(ref_sc.policy()) == sc.declared_policy
    cold = PS.derive_policy_motion(tree, sc.policy())
    assert _as_tuples(cold) == _as_tuples(sc.region_expected) == \
        _as_tuples(RS.derive_policy_motion(ref_sc.build(), ref_sc.policy()))
    mutate = sc.steady_mutate_paths()
    assert mutate == ref_sc.steady_mutate_paths()
    steady = PS.derive_steady_policy_motion(tree, sc.policy(), mutate)
    assert _as_tuples(steady) == _as_tuples(sc.steady_region_expected)


@pytest.mark.parametrize("name", _SMOKE)
def test_marshal_db_policy_is_held_to_the_structural_form(name):
    """The port's ``marshal+db`` is marshal without delta: a cold pass and
    every warm pass ship marshal's motion, and the ledger equals it."""
    sc = _PORT[name]
    tree = sc.build()
    policy = sc.policy("marshal+db")
    assert str(policy) == "**=marshal+db"
    want = PS.derive_motion(tree, [], None, "marshal").as_tuple()
    assert PS.derive_policy_motion(tree, policy)["**"].as_tuple() == want
    mutate = sc.steady_mutate_paths()
    assert PS.derive_steady_policy_motion(tree, policy, mutate)[
        "**"].as_tuple() == want
    ms = PS.run_policy_scenario(sc, policy, tree=tree, passes=2, device=CPU,
                                session=TransferSession())
    for m in ms:
        assert m.ok and m.motion_ok and m.syncs == 1
        assert (m.h2d_bytes, m.h2d_calls) == want and m.skipped_bytes == 0


def test_db_region_beside_delta_and_uvm_regions():
    sc = _PORT["mixed_policy_n8_dev1"]
    policy = "params/**=marshal+db; opt/**=marshal+delta; **=uvm"
    ms = PS.run_policy_scenario(sc, policy, passes=3, device=CPU,
                                session=TransferSession())
    assert all(m.ok and m.motion_ok for m in ms)
    assert [m.regions["params/**"]["h2d_bytes"] for m in ms] == [96] * 3
    assert [m.regions["**"]["h2d_bytes"] for m in ms] == [0] * 3
    assert [m.regions["opt/**"]["h2d_bytes"] for m in ms] == [68, 64, 64]


# -- run_policy_scenario -----------------------------------------------------

_ALT = ("params/**=uvm; opt/**=marshal+delta+align64; **=marshal",
        "opt/**=pointerchain; **=marshal+delta")


def _policy_cells():
    cells = [(name, None) for name in _DECLARED]
    cells += [(name, alt) for name in _DECLARED if "_n8_" in name
              for alt in _ALT]
    return cells


@pytest.mark.parametrize("executor", ["blocking", "async"])
@pytest.mark.parametrize("name,policy", _policy_cells())
def test_run_policy_scenario_equals_the_reference(name, policy, executor):
    r_clear_cache()
    ref_tree = _REF[name].build()
    want = RS.run_policy_scenario(_REF[name], policy, tree=ref_tree,
                                  passes=3, executor=executor)
    got = PS.run_policy_scenario(_PORT[name], policy,
                                 tree=from_reference_tree(ref_tree),
                                 passes=3, executor=executor, device=CPU,
                                 session=TransferSession())
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.ok and g.motion_ok and w.ok and w.motion_ok
        assert g.policy == w.policy and g.executor == w.executor == executor
        assert (g.syncs, g.enqueues) == (w.syncs, w.enqueues)
        assert g.syncs == 1
        assert (g.h2d_bytes, g.h2d_calls, g.skipped_bytes) == \
            (w.h2d_bytes, w.h2d_calls, w.skipped_bytes)
        assert list(g.regions) == list(w.regions)
        for key, led in w.regions.items():
            assert {f: g.regions[key][f] for f in _LEDGER_FIELDS} == \
                {f: led[f] for f in _LEDGER_FIELDS}, key
        assert _as_tuples(g.expected) == _as_tuples(w.expected)
        if executor == "blocking":
            assert g.offload_us == 0.0 and g.overlap_us == 0.0
        assert g.offload_us >= 0.0


@pytest.mark.parametrize("name", _DECLARED)
def test_policy_passes_book_the_closed_forms(name):
    sc = _PORT[name]
    ms = PS.run_policy_scenario(sc, passes=3, device=CPU,
                                session=TransferSession())
    cold = sc.region_expected
    steady = sc.steady_region_expected
    assert [(k, (r["h2d_bytes"], r["h2d_calls"]))
            for k, r in ms[0].regions.items()] == _as_tuples(cold)
    for m in ms[1:]:
        assert [(k, (r["h2d_bytes"], r["h2d_calls"]))
                for k, r in m.regions.items()] == _as_tuples(steady)
        # the steady opt region skips exactly its clean i32 bucket
        assert m.regions["opt/**"]["skipped_bytes"] == 4 == m.skipped_bytes


def test_run_policy_scenario_rejects_what_it_cannot_check():
    sc = _PORT["mixed_policy_n8_dev1"]
    with pytest.raises(ValueError, match="executor"):
        PS.run_policy_scenario(sc, executor="threads", device=CPU)
    with pytest.raises(ValueError, match="declares no policy"):
        PS.run_policy_scenario(_PORT["ragged_n32"], device=CPU)
    # a sharded rule cannot be checked on a mesh it does not fit: the
    # compile raises the stale-mesh error instead of running unsharded
    with pytest.raises(UnsupportedSpecError, match="stale for this"):
        PS.run_policy_scenario(
            sc, "params/**=marshal@dp2; **=marshal", device=[CPU])
    # the derivation prices @dpK (per-device arenas: 48 f32 and 17 -> 24
    # i32 elements over 8 devices), and a K-position mesh executes it
    assert PS.derive_policy_motion(sc.build(), "**=marshal+delta@dp8")[
        "**"].per_device_tuple() == (36, 2)
    m, = PS.run_policy_scenario(sc, "**=marshal+delta@dp8", device=CPU,
                                session=TransferSession())
    assert m.ok and m.motion_ok and m.regions["**"]["h2d_bytes_by_device"] \
        == {str(s): 36 for s in range(8)}
    case = PS.mixed_policy_case(16, 2)
    assert case.region_expected["params/**"].per_device_tuple() == (96, 1)


# -- Algorithm 2 over a program ----------------------------------------------

_A2_POLICIES = (None, "params/**=uvm; opt/**=marshal+delta; **=pointerchain")


@pytest.mark.parametrize("policy", _A2_POLICIES)
@pytest.mark.parametrize("name", [n for n in _DECLARED if "_n8_" in n])
def test_algorithm2_over_a_policy_equals_the_reference(name, policy):
    r_clear_cache()
    ref_sc, sc = _REF[name], _PORT[name]
    policy = policy or sc.declared_policy
    ref_tree = ref_sc.build()
    tree = from_reference_tree(ref_tree)
    used = list(sc.used_paths)
    want = RS.run_algorithm2(ref_tree, used, policy=policy)
    got = PS.run_algorithm2(tree, used, policy=policy, device=CPU)
    assert got.ok and want.ok and got.scheme == want.scheme == "policy"
    assert got.spec == want.spec == str(TransferPolicy.parse(policy))
    assert (got.h2d_bytes, got.h2d_calls, got.skipped_bytes) == \
        (want.h2d_bytes, want.h2d_calls, want.skipped_bytes)
    assert got.device == "cpu"
    if policy == sc.declared_policy:
        assert got.h2d_bytes == sum(v.h2d_bytes
                                    for v in sc.region_expected.values())

    # a compiled program, reused: the second pass is the steady repeat
    ref_prog = RTransferSession().compile(ref_tree, policy)
    port_prog = TransferSession().compile(tree, policy, device=CPU)
    for _ in range(2):
        want = RS.run_algorithm2(ref_tree, used, program=ref_prog)
        got = PS.run_algorithm2(tree, used, program=port_prog)
        assert got.ok and want.ok
        assert (got.h2d_bytes, got.h2d_calls, got.skipped_bytes) == \
            (want.h2d_bytes, want.h2d_calls, want.skipped_bytes)
        for key, led in ref_prog.ledgers.items():
            assert {f: getattr(port_prog.region_ledger(key), f)
                    for f in _LEDGER_FIELDS} == \
                {f: getattr(led, f) for f in _LEDGER_FIELDS}, key


def test_algorithm2_line7_catches_a_lost_region():
    """A program whose from_device drops one region's kernel output fails
    line 7: the check is not vacuous on the program path."""
    sc = _PORT["elastic_n8_dev1"]
    tree = sc.build()
    program = TransferSession().compile(tree, sc.policy(), device=CPU)
    real = program.from_device

    def lossy(dev, host):
        out = real(dev, host)
        out["opt"]["mu"] = host["opt"]["mu"]
        return out

    program.from_device = lossy
    assert not PS.run_algorithm2(tree, list(sc.used_paths),
                                 program=program).ok


# -- the value oracle --------------------------------------------------------

@pytest.mark.parametrize("name", _DECLARED)
def test_full_deepcopy_policy_is_a_program_pass(name):
    sc = _PORT[name]
    tree = sc.build()
    led, r_led = TransferLedger(), RTransferLedger()
    ref = full_deepcopy(tree, device=CPU, ledger=led, policy=sc.policy())
    r_full_deepcopy(_REF[name].build(), ledger=r_led,
                    policy=_REF[name].policy())
    assert (led.h2d_bytes, led.h2d_calls) == \
        (r_led.h2d_bytes, r_led.h2d_calls)
    dev = TransferSession().compile(tree, sc.policy(),
                                    device=CPU).to_device(tree)
    for a, b, h in zip(tree_leaves(ref), tree_leaves(dev), tree_leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.uint8) if a.dim() else a,
                           b.view(torch.uint8) if b.dim() else b)
        assert a.data_ptr() != h.data_ptr()        # a copy, not the host leaf


def test_full_deepcopy_policy_excludes_a_device():
    tree = _PORT["elastic_n8_dev1"].build()
    with pytest.raises(ValueError, match="exclusive"):
        full_deepcopy(tree, device="cuda", policy="**=marshal")
    with pytest.raises(ValueError):
        r_full_deepcopy(_REF["elastic_n8_dev1"].build(),
                        device=jax.devices()[0], policy="**=marshal")


# -- the program's views -----------------------------------------------------

@pytest.mark.parametrize("policy", [None] + list(_ALT))
def test_region_of_and_region_ledger_equal_the_reference(policy, trees):
    ref_tree, tree = trees["mixed_policy_n8_dev1"]
    policy = policy or _REF["mixed_policy_n8_dev1"].declared_policy
    ref_prog = RTransferSession().compile(ref_tree, policy)
    prog = TransferSession().compile(tree, policy, device=CPU)
    for path in leaf_paths(tree):
        assert prog.region_of(path) == prog.region_of(str(path)) == \
            ref_prog.region_of(str(path))
    ref_prog.to_device(ref_tree)
    prog.to_device(tree)
    for key in ref_prog.ledgers:
        assert prog.region_ledger(key) is prog.ledgers[key]
        assert {f: getattr(prog.region_ledger(key), f)
                for f in _LEDGER_FIELDS} == \
            {f: getattr(ref_prog.region_ledger(key), f)
             for f in _LEDGER_FIELDS}
    with pytest.raises(KeyError):
        prog.region_ledger("nope/**")


def test_program_one_sync_and_enqueue_counts():
    sc = _PORT["mixed_policy_n8_dev1"]
    tree = sc.build()
    prog = TransferSession().compile(tree, sc.policy(), device=CPU)
    prog.to_device(tree)
    assert prog.last_stats.syncs == 1
    assert prog.last_stats.enqueues == {"params/**": 1, "opt/**": 2, "**": 2}
    assert prog.last_stats.enqueue_total == prog.merged_ledger().h2d_calls


@pytest.mark.parametrize("name", _DECLARED)
def test_declared_regions_have_their_own_staging_entries(name):
    """No two regions of a declared policy share an ArenaEntry (their leaf
    signatures differ), so one region's pass never bumps another's staging
    versions and the steady delta region ships only its dirty bucket."""
    sc = _PORT[name]
    prog = TransferSession().compile(sc.build(), sc.policy(), device=CPU)
    entries = [prog.scheme(k)._entry for k in prog.regions
               if prog.regions[k].spec.kind == "marshal"]
    assert len(entries) >= 2 and all(e is not None for e in entries)
    assert len({id(e) for e in entries}) == len(entries)


def test_reset_ledgers_drains_the_in_flight_pass():
    sc = _PORT["elastic_n8_dev1"]
    tree = sc.build()
    prog = TransferSession().compile(tree, sc.policy(), device=CPU)
    ref_prog = RTransferSession().compile(_REF[sc.name].build(),
                                          sc.declared_policy)
    fut = prog.to_device_async(tree)
    ref_fut = ref_prog.to_device_async(_REF[sc.name].build())
    assert prog._inflight is fut
    prog.reset_ledgers()
    ref_prog.reset_ledgers()
    assert prog._inflight is None and ref_prog._inflight is None
    assert fut._materialized and prog.last_stats.syncs == 1
    assert prog.merged_ledger().h2d_bytes == \
        ref_prog.merged_ledger().h2d_bytes == 0
    out = fut.result()                              # memoized, not re-run
    for a, b in zip(tree_leaves(out), tree_leaves(tree)):
        assert torch.equal(a, b)
    assert ref_fut.result() is not None
    prog.to_device(tree)                            # warm: delta ships opt's
    assert prog.region_ledger("opt/**").h2d_bytes == 0    # nothing, clean


@pytest.mark.parametrize("sync_s,overlap_s", [(0.0, 0.0), (0.2, 0.5),
                                              (0.5, 0.2), (0.25, 0.25)])
def test_offloaded_s_equals_the_reference(sync_s, overlap_s):
    got = ProgramStats({"**": 1}, 1, sync_s, overlap_s, 0.1)
    want = RProgramStats({"**": 1}, 1, sync_s, overlap_s, 0.1)
    assert got.offloaded_s == want.offloaded_s == max(0.0,
                                                      overlap_s - sync_s)


def test_offloaded_s_of_real_passes():
    tree = _PORT["mixed_policy_n8_dev1"].build()
    prog = TransferSession().compile(tree, "**=marshal", device=CPU)
    prog.to_device(tree)
    assert prog.last_stats.overlap_s == 0.0
    assert prog.last_stats.offloaded_s == 0.0
    prog.to_device_async(tree).result()
    stats = prog.last_stats
    assert stats.overlap_s >= 0.0 and stats.syncs == 1
    assert stats.offloaded_s == max(0.0, stats.overlap_s - stats.sync_s)


def test_uvm_region_stages_lazily():
    tree = {"hot": torch.arange(4, dtype=torch.float32),
            "cold": torch.arange(8, dtype=torch.float32)}
    prog = TransferSession().compile(tree, "hot=marshal; **=uvm", device=CPU)
    dev = prog.to_device(tree)
    assert prog.last_stats.enqueues == {"hot": 1, "**": 0}
    led = prog.region_ledger("**")
    assert led.h2d_bytes == 0                     # nothing moved at pass time
    assert isinstance(dev["cold"], LazyLeaf)
    assert torch.equal(dev["cold"].get(), tree["cold"])
    assert led.h2d_bytes == 32                    # the fault, on access
