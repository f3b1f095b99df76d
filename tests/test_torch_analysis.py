"""The port's static policy analysis held against the JAX package.

  * the diagnostic registry: codes, severities, meanings and
    ``str(Diagnostic)`` equal the reference's;
  * ``check_policy``: ``(code, message, where)`` equal over every hand case
    of tests/test_analysis_check.py, and over each smoke scenario's tree x
    its declared policy and every ``enumerate_policies`` candidate at mesh
    1 and 8 (DC106 compared up to its live-device-count note);
  * ``policy_cost``: every ``RegionCost`` field (Motion with its per-device
    split and ``by_shard``, staging, padding) and ``motion_objective``
    equal, ``@dp2/4/8`` and mutation sets included; a signature tree (and a
    tree of meta tensors) prices exactly like its tree, with no buffer;
  * the grid and the layouts: ``candidate_specs``, ``enumerate_policies``,
    ``neighbors`` and ``with_rule``; ``plan(shard_multiple=k)`` and the
    sharded derivations for k in {2, 4, 8};
  * ``CostModel``: the same fit on the same probes, files load across the
    packages;
  * ``check_registry`` at mesh 1 and 8 and the CLI;
  * the three-way differential on the port at ``smoke``: static ==
    structural == the ledger of ``run_policy_scenario(device="cpu")``;
  * no fallback: without a card the live mesh and the calibration raise
    ``NoCudaDeviceError``; ``@dpK`` executes on a K-position mesh (booking
    per position what the cost model prices) and raises the stale-mesh
    error on a narrower one.

The reference runs under ``JAX_PLATFORMS=cpu`` on its numpy trees, which
the port takes with ``from_reference_tree``.
"""
import dataclasses
import json

import ml_dtypes  # noqa: F401  (registers numpy's bfloat16 for the reference)
import numpy as np
import pytest
import torch

from repro import scenarios as RS
from repro.analysis import check as r_check
from repro.analysis import cost as r_cost
from repro.analysis import diagnostics as r_diag
from repro.core import TransferPolicy as RTransferPolicy
from repro.core import UnsupportedPolicyError as RUnsupportedPolicyError
from repro.core import arena as r_arena
from repro.core import candidate_specs as r_candidate_specs
from repro.core import enumerate_policies as r_enumerate_policies
from repro.core import leaf_paths as r_leaf_paths
from repro.core import partition_tree as r_partition_tree

from repro_torch import scenarios as PS
from repro_torch._device import NoCudaDeviceError
from repro_torch.analysis import check as p_check
from repro_torch.analysis import cost as p_cost
from repro_torch.analysis import diagnostics as p_diag
from repro_torch.convert import from_reference_tree
from repro_torch.core import (TransferPolicy, TransferSession,
                              UnsupportedPolicyError, UnsupportedSpecError,
                              candidate_specs,
                              enumerate_policies, partition_tree,
                              transfer_scheme, tree_map)
from repro_torch.core import arena as p_arena
from test_torch_policy import _MATRIX
from test_torch_policy_scenarios import _mutation_sets, _pattern_tree

CPU = "cpu"
_SMOKE = [sc.name for sc in RS.iter_scenarios("smoke")
          if sc.name in {p.name for p in PS.iter_scenarios("smoke")}]
_REF = {sc.name: sc for sc in RS.iter_scenarios("smoke")}
_PORT = {sc.name: sc for sc in PS.iter_scenarios("smoke")}
_TREE_CACHE = {}


def _trees(name):
    """(reference tree, port tree) of a smoke scenario or the pattern tree;
    the port's is the reference's carried across, so both hold the same
    paths, shapes, dtypes and values."""
    if name not in _TREE_CACHE:
        ref = _pattern_tree() if name == "pattern" else _REF[name].build()
        _TREE_CACHE[name] = (ref, from_reference_tree(ref))
    return _TREE_CACHE[name]


def _motion(m):
    return (m.h2d_bytes, m.h2d_calls, m.per_device_bytes,
            m.per_device_calls, m.by_shard)


def _region(rc):
    return (rc.key, str(rc.spec), rc.leaves, rc.payload_bytes,
            _motion(rc.cold), _motion(rc.steady), rc.staging_bytes,
            rc.padding_bytes, rc.arena_bytes)


def _cost(c):
    return ([_region(r) for r in c.regions], tuple(c.mutate_paths), c.syncs,
            c.cold_bytes, c.cold_calls, c.steady_bytes, c.steady_calls,
            c.staging_bytes, c.padding_bytes, c.payload_bytes,
            c.arena_bytes, c.padding_fraction(), c.motion_objective(),
            c.motion_objective(steady_weight=0))


_LIVE_NOTE = " (analyzed mesh"


def _diags(diags):
    """(code, message, where) triples, DC106's live-count note cut off (it
    names jax's device count in the reference, CUDA's in the port)."""
    return [(d.code, d.message.split(_LIVE_NOTE)[0] if d.code == "DC106"
             else d.message, d.where) for d in diags]


# -- the diagnostic registry -------------------------------------------------

def test_codes_and_severities_equal_the_reference():
    assert list(p_diag.CODES) == list(r_diag.CODES)
    for code, (sev, meaning) in r_diag.CODES.items():
        assert p_diag.CODES[code][0] == sev == r_diag.severity_of(code)
        assert p_diag.severity_of(code) == sev
        if code in r_diag.STATIC_CODES:
            assert p_diag.CODES[code][1] == meaning
    assert p_diag.STATIC_CODES == r_diag.STATIC_CODES
    assert p_diag.LINT_CODES == r_diag.LINT_CODES
    assert p_diag.RUNTIME_CODES == r_diag.RUNTIME_CODES
    assert (p_diag.ERROR, p_diag.WARNING) == (r_diag.ERROR, r_diag.WARNING)


@pytest.mark.parametrize("code", ["DC101", "DC106", "DC111", "DC304"])
@pytest.mark.parametrize("where", [None, "sc1"])
def test_diagnostic_str_equals_the_reference(code, where):
    p = p_diag.Diagnostic(code, "boom", where=where)
    r = r_diag.Diagnostic(code, "boom", where=where)
    assert str(p) == str(r)
    assert (p.severity, p.is_error) == (r.severity, r.is_error)
    assert p_diag.errors([p]) == ([p] if r.is_error else [])
    with pytest.raises(ValueError, match="unknown diagnostic code"):
        p_diag.Diagnostic("DC999", "x")


# -- check_policy: the hand cases of tests/test_analysis_check.py -----------

def _hand_tree():
    return {"params": {"w": np.zeros(64, np.float32),
                       "b": np.zeros(8, np.float32)},
            "opt": {"m": np.zeros(64, np.float32)}}


_HAND = [
    ("clean", _hand_tree, "params/**=marshal+db; **=marshal",
     dict(mesh_size=1, steady_reuse=True)),
    ("dc101", _hand_tree,
     "params/*=marshal+db; params/**=marshal+align8; **=marshal",
     dict(mesh_size=1)),
    ("dc102", _hand_tree, "embeddings/**=marshal+db; **=marshal",
     dict(mesh_size=1)),
    ("default_exempt", _hand_tree,
     "params/**=marshal+db; opt/**=marshal; **=marshal", dict(mesh_size=1)),
    ("dc103", lambda: {"tiny": np.zeros(3, np.float32)}, "**=marshal@dp8",
     dict(mesh_size=8)),
    ("dc103_silent", lambda: {"big": np.zeros(4096, np.float32)},
     "**=marshal@dp8", dict(mesh_size=8)),
    ("dc104_pins", _hand_tree,
     "params/**=marshal@dev0; opt/**=marshal@dev1; **=marshal",
     dict(mesh_size=1)),
    ("dc104_pin_shard", _hand_tree,
     "params/**=marshal@dp8; opt/**=marshal@dev0; **=marshal",
     dict(mesh_size=8)),
    ("dc105", _hand_tree, "opt/**=marshal+delta; **=marshal",
     dict(mesh_size=1, steady_reuse=False)),
    ("dc105_unknown", _hand_tree, "opt/**=marshal+delta; **=marshal",
     dict(mesh_size=1, steady_reuse=None)),
    ("dc106", _hand_tree, "params/**=marshal@dp8; **=marshal",
     dict(mesh_size=2)),
    ("dc106_wide", _hand_tree, "params/**=marshal@dp9; **=marshal",
     dict(mesh_size=2, where="sc1")),
    ("dc110_dc111", _hand_tree, "**=marshal+align512", dict(mesh_size=1)),
    ("dc111_silent", _hand_tree, "params/**=marshal; **=marshal",
     dict(mesh_size=1, steady_reuse=True)),
    ("dc111_delta_rent", _hand_tree, "params/**=marshal; **=marshal+delta",
     dict(mesh_size=1, steady_reuse=True, mutate_paths=["opt.m"])),
    ("dc112_over", _hand_tree, "**=marshal",
     dict(mesh_size=1, staging_budget_bytes=100)),
    ("dc112_under", _hand_tree, "**=marshal",
     dict(mesh_size=1, staging_budget_bytes=10_000)),
    ("dc112_unarmed", _hand_tree, "**=marshal", dict(mesh_size=1)),
]


@pytest.mark.parametrize("name,build,policy,kw", _HAND,
                         ids=[c[0] for c in _HAND])
def test_hand_cases_equal_the_reference(name, build, policy, kw):
    ref_tree = build()
    want = _diags(r_check.check_policy(ref_tree, policy, **kw))
    got = _diags(p_check.check_policy(from_reference_tree(ref_tree), policy,
                                      **kw))
    assert got == want


def test_hand_cases_fire_what_the_reference_tests_expect():
    """The codes tests/test_analysis_check.py pins, from the port."""
    codes = {name: [d.code for d in p_check.check_policy(
        from_reference_tree(build()), policy, **kw)]
        for name, build, policy, kw in _HAND}
    assert codes["clean"] == codes["default_exempt"] == []
    assert codes["dc101"] == ["DC101"] and codes["dc102"] == ["DC102"]
    assert codes["dc103"] == ["DC103", "DC110", "DC111"]
    assert codes["dc103_silent"] == []
    assert codes["dc104_pins"] == codes["dc104_pin_shard"] == ["DC104"]
    assert codes["dc105"] == ["DC105"] and codes["dc105_unknown"] == []
    assert "DC106" in codes["dc106"]
    assert {"DC110", "DC111"} <= set(codes["dc110_dc111"])
    assert "DC111" not in codes["dc111_silent"] + codes["dc111_delta_rent"]
    assert "DC112" in codes["dc112_over"]
    assert "DC112" not in codes["dc112_under"] + codes["dc112_unarmed"]


def test_dc106_note_names_the_live_cuda_count(monkeypatch):
    tree = from_reference_tree(_hand_tree())
    policy = "params/**=marshal@dp8; **=marshal"
    # no card here: the live count is unknown and the note is left out
    assert p_check._live_device_count() is None
    [d] = [d for d in p_check.check_policy(tree, policy, mesh_size=2)
           if d.code == "DC106"]
    assert d.is_error and "mesh has 2" in d.message
    assert _LIVE_NOTE not in d.message
    monkeypatch.setattr(p_check, "_live_device_count", lambda: 1)
    [d] = [d for d in p_check.check_policy(tree, policy, mesh_size=2)
           if d.code == "DC106"]
    assert d.message.endswith(
        " (analyzed mesh 2 != live torch.cuda.device_count()=1)")
    # analyzing at the live mesh: no note
    monkeypatch.setattr(p_check, "_live_device_count", lambda: 2)
    [d] = [d for d in p_check.check_policy(tree, policy, mesh_size=2)
           if d.code == "DC106"]
    assert _LIVE_NOTE not in d.message


# -- check_policy over the registry's smoke trees x the candidate grid -------

def _grid(name, mesh):
    """The scenario's declared policy (resharded to ``mesh``) and every
    candidate over its patterns (``**`` alone when it declares none)."""
    declared = _REF[name].policy()
    patterns = tuple(r.pattern for r in declared.rules) if declared \
        else ("**",)
    out = [str(declared.reshard(mesh))] if declared else []
    out += [str(p) for p in r_enumerate_policies(patterns, mesh_size=mesh)]
    return out


@pytest.mark.parametrize("mesh", [1, 8])
@pytest.mark.parametrize("name", _SMOKE)
def test_check_policy_over_the_grid_equals_the_reference(name, mesh):
    ref_tree, port_tree = _trees(name)
    sc = _REF[name]
    mutate = list(sc.steady_mutate_paths())
    steady = bool(mutate) or sc.steady_region_expected is not None
    settings = [dict(steady_reuse=steady,
                     mutate_paths=mutate if steady else None),
                dict(steady_reuse=False, staging_budget_bytes=64)]
    policies = _grid(name, mesh)
    assert len(policies) >= (3 if mesh == 1 else 5)
    fired = set()
    for policy in policies:
        for kw in settings:
            want = r_check.check_policy(ref_tree, policy, mesh_size=mesh,
                                        where=name, **kw)
            got = p_check.check_policy(port_tree, policy, mesh_size=mesh,
                                       where=name, **kw)
            assert _diags(got) == _diags(want), (policy, kw)
            fired.update(d.code for d in got)
    assert "DC112" in fired


def test_the_grid_matrix_reaches_the_sharded_codes():
    """At mesh 8 the candidates shard; the small smoke trees pad, so the
    matrix above compares DC103, DC105, DC110 and DC111 messages too."""
    name = "mixed_policy_n8_dev1"
    _, port_tree = _trees(name)
    fired = set()
    for policy in _grid(name, 8):
        fired.update(d.code for d in p_check.check_policy(
            port_tree, policy, mesh_size=8, steady_reuse=False))
    assert {"DC103", "DC105", "DC110", "DC111"} <= fired


# -- policy_cost -------------------------------------------------------------

_COST_POLICIES = (
    "**=marshal", "**=marshal+db", "**=marshal+delta", "**=pointerchain",
    "**=uvm", "**=marshal@dp1", "**=marshal@dp2", "**=marshal+align128@dp2",
    "**=marshal+delta@dp4", "**=pointerchain@dp4", "**=uvm@dp8",
    "**=marshal+delta@dp8",
    "params/**=marshal+delta; **=marshal@dp4",
    "params/**=marshal@dp8; opt/**=marshal+delta@dp8; **=pointerchain",
    "params/**=marshal@dev0; **=marshal+align64",
)


@pytest.mark.parametrize("name", ["pattern"] + _SMOKE)
def test_policy_cost_equals_the_reference(name):
    ref_tree, port_tree = _trees(name)
    policies = list(_COST_POLICIES)
    if name == "pattern":
        policies += _MATRIX
    for policy in policies:
        for mutate in _mutation_sets(ref_tree):
            want = r_cost.policy_cost(ref_tree, policy, list(mutate))
            got = p_cost.policy_cost(port_tree, policy, list(mutate))
            assert _cost(got) == _cost(want), (policy, mutate)
            assert str(got.policy) == str(want.policy)


def test_sharded_costs_carry_the_per_device_split():
    _, tree = _trees("elastic_n8_dev1")
    cost = p_cost.policy_cost(tree, "params/**=marshal+delta@dp4; "
                              "**=marshal@dp4", ["params.w"])
    params, rest = cost.region("params/**"), cost.region("**")
    # params: w (16) + b (8) f32 = 24 elements, 6 a device: one copy each
    assert params.cold.as_tuple() == (96, 4)
    assert params.cold.per_device_tuple() == (24, 1)
    # sorted keys put b (elements 0-7) before w (8-23): mutating w dirties
    # shards 1-3, and shard 0 (b's first six elements) stays clean
    assert params.steady.by_shard == ((0, 0), (24, 1), (24, 1), (24, 1))
    assert rest.steady.as_tuple() == rest.cold.as_tuple()
    with pytest.raises(KeyError, match="no region"):
        cost.region("meta/**")


def _bf16_tree():
    rng = np.random.default_rng(3)
    return {"w": rng.standard_normal(48).astype(np.float32)
            .astype("bfloat16"),
            "b": rng.standard_normal(5).astype(np.float32),
            "t": np.int32(7), "e": np.zeros(0, np.float32)}


@pytest.mark.parametrize("policy", _COST_POLICIES[:12])
def test_signature_tree_prices_exactly(policy):
    for ref_tree in (_bf16_tree(), _trees("pattern")[0],
                     _trees("model_state_llama3_2_1b")[0]):
        tree = from_reference_tree(ref_tree)
        paths = [str(p) for p in r_leaf_paths(ref_tree)][:2]
        real = p_cost.policy_cost(tree, policy, paths)
        sig = p_cost.policy_cost(p_cost.signature_tree(tree), policy, paths)
        meta = p_cost.policy_cost(
            tree_map(lambda t: t.to("meta"), tree), policy, paths)
        ref_sig = r_cost.policy_cost(r_cost.signature_tree(ref_tree), policy,
                                     paths)
        assert _cost(real) == _cost(sig) == _cost(meta) == _cost(ref_sig)


def test_leafsig_and_a_leaf_no_host_could_hold():
    assert p_cost.LeafSig((4, 4), torch.float32).nbytes == 64
    assert p_cost.LeafSig((), np.float64).nbytes == 8
    assert p_cost.LeafSig((0,), "float32").nbytes == 0
    assert p_cost.LeafSig((3,), "bfloat16").dtype == torch.bfloat16
    assert p_cost.LeafSig((3,), np.dtype("bfloat16")).nbytes == 6
    with pytest.raises(TypeError):
        p_cost.LeafSig((3,), "complex_nonsense")
    # 2^40 f32 elements (4 TiB): priced from the signature alone, so no
    # buffer exists anywhere
    tree = {"huge": p_cost.LeafSig((1 << 40,), torch.float32),
            "t": p_cost.LeafSig((), torch.int32)}
    cost = p_cost.policy_cost(tree, "huge=marshal+delta@dp8; **=marshal",
                              ["huge"])
    huge = cost.region("huge")
    assert huge.cold.as_tuple() == (1 << 42, 8)
    assert huge.cold.per_device_tuple() == (1 << 39, 1)
    assert huge.staging_bytes == 2 << 42
    assert huge.steady.by_shard == ((1 << 39, 1),) * 8
    assert cost.region("**").cold.as_tuple() == (4, 1)
    assert p_arena.plan(tree).total_bytes() == (1 << 42) + 4
    # and a signature tree of a real tree holds signatures only
    sig = p_cost.signature_tree(from_reference_tree(_bf16_tree()))
    assert sig["w"] == p_cost.LeafSig((48,), torch.bfloat16)


def test_policy_cost_footprints_as_the_reference_states_them():
    tree = from_reference_tree({"tiny": np.arange(3, dtype=np.float32)})
    sharded = p_cost.policy_cost(tree, "**=marshal@dp8")
    assert (sharded.payload_bytes, sharded.padding_bytes,
            sharded.arena_bytes, sharded.staging_bytes) == (12, 20, 32, 32)
    assert sharded.padding_fraction() == pytest.approx(20 / 32)
    assert sharded.padding_fraction() > p_cost.PADDING_WASTE_WARN
    delta = p_cost.policy_cost(tree, "**=marshal+delta")
    assert delta.staging_bytes == 2 * delta.arena_bytes
    chain = p_cost.policy_cost(tree, "**=pointerchain")
    assert chain.staging_bytes == chain.arena_bytes == 0
    assert (p_cost.PADDING_WASTE_WARN, p_cost.DOMINATED_MARGIN,
            p_cost.STEADY_WEIGHT) == (r_cost.PADDING_WASTE_WARN,
                                      r_cost.DOMINATED_MARGIN,
                                      r_cost.STEADY_WEIGHT)
    assert p_check.TAIL_PADDING_WARN == r_check.TAIL_PADDING_WARN
    assert p_cost.COSTMODEL_FILE == "BENCH_torch_costmodel.json"


# -- the candidate grid ------------------------------------------------------

@pytest.mark.parametrize("mesh", [1, 2, 4, 8])
def test_candidate_grid_equals_the_reference(mesh):
    assert [str(s) for s in candidate_specs(mesh)] == \
        [str(s) for s in r_candidate_specs(mesh)]
    for patterns in (("**",), ("params/**", "**"),
                     ("params/**", "opt/**", "**")):
        got = [str(p) for p in enumerate_policies(patterns, mesh_size=mesh)]
        want = [str(p) for p in r_enumerate_policies(patterns,
                                                     mesh_size=mesh)]
        assert got == want
        assert len(got) == len(candidate_specs(mesh)) ** len(patterns)
    specs = candidate_specs(mesh)[1:2]
    assert [str(p) for p in enumerate_policies(("**",), specs=specs)] == \
        [str(p) for p in r_enumerate_policies(
            ("**",), specs=r_candidate_specs(mesh)[1:2])]


@pytest.mark.parametrize("mesh", [1, 8])
@pytest.mark.parametrize("text", _MATRIX[::7])
def test_neighbors_and_with_rule_equal_the_reference(text, mesh):
    port, ref = TransferPolicy.parse(text), RTransferPolicy.parse(text)
    try:
        want = [str(p) for p in ref.neighbors(mesh)]
    except RUnsupportedPolicyError as e:
        # a @dp4 rule beside a @dp8 candidate: both refuse the mixed mesh
        with pytest.raises(UnsupportedPolicyError) as got:
            port.neighbors(mesh)
        assert str(got.value) == str(e)
    else:
        assert [str(p) for p in port.neighbors(mesh)] == want
    for rule in port.rules:
        assert str(port.with_rule(rule.pattern, "pointerchain")) == \
            str(ref.with_rule(rule.pattern, "pointerchain"))
    with pytest.raises(UnsupportedPolicyError, match="not a rule"):
        port.with_rule("nowhere/**", "marshal")


def test_rule_matches_and_region_keys_equal_the_reference():
    ref_tree, tree = _trees("pattern")
    paths = [str(p) for p in r_leaf_paths(ref_tree)]
    for text in _MATRIX[::5]:
        port, ref = TransferPolicy.parse(text), RTransferPolicy.parse(text)
        for pr, rr in zip(port.rules, ref.rules):
            assert [pr.matches(p) for p in paths] == \
                [rr.matches(p) for p in paths]
        assert [r.key for r in partition_tree(tree, port).values()] == \
            [r.key for r in r_partition_tree(ref_tree, ref).values()]


# -- sharded layouts and derivations -----------------------------------------

@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("name", ["pattern"] + _SMOKE)
def test_sharded_plan_and_derivations_equal_the_reference(name, k):
    ref_tree, tree = _trees(name)
    for align in (1, 64):
        want = r_arena.plan(ref_tree, align, shard_multiple=k)
        got = p_arena.plan(tree, align, shard_multiple=k)
        assert [(s.bucket, s.offset, s.size, s.shape) for s in got.slots] \
            == [(s.bucket, s.offset, s.size, s.shape) for s in want.slots]
        assert list(got.bucket_sizes.items()) == \
            list(want.bucket_sizes.items())
        assert all(n % k == 0 for n in got.bucket_sizes.values())
        assert (got.shard_multiple, got.total_bytes(), got.payload_bytes()) \
            == (want.shard_multiple, want.total_bytes(),
                want.payload_bytes())
        for scheme in ("marshal", "marshal_delta", "pointerchain", "uvm"):
            used = [str(p) for p in r_leaf_paths(ref_tree)][::2]
            assert _motion(PS.derive_motion(tree, used, None, scheme, align,
                                            num_shards=k)) == \
                _motion(RS.derive_motion(ref_tree, used, None, scheme, align,
                                         num_shards=k))
        for mutate in _mutation_sets(ref_tree):
            assert _motion(PS.derive_steady_motion(
                tree, mutate, num_shards=k, align_elems=align)) == \
                _motion(RS.derive_steady_motion(
                    ref_tree, mutate, num_shards=k, align_elems=align))
    for policy in (f"**=marshal+delta@dp{k}", f"**=pointerchain@dp{k}",
                   f"**=uvm@dp{k}", f"**=marshal+align128@dp{k}"):
        for mutate in _mutation_sets(ref_tree)[:3]:
            got = PS.derive_steady_policy_motion(tree, policy, mutate)
            want = RS.derive_steady_policy_motion(ref_tree, policy, mutate)
            assert {key: _motion(m) for key, m in got.items()} == \
                {key: _motion(m) for key, m in want.items()}
        assert {key: _motion(m) for key, m in
                PS.derive_policy_motion(tree, policy).items()} == \
            {key: _motion(m) for key, m in
             RS.derive_policy_motion(ref_tree, policy).items()}


def test_one_device_motion_keeps_its_defaults():
    _, tree = _trees("elastic_n8_dev1")
    for m in PS.derive_policy_motion(tree, _PORT["elastic_n8_dev1"]
                                     .policy()).values():
        assert m.per_device_tuple() is None and m.by_shard is None
    assert PS.Motion(4, 1) == PS.Motion(4, 1, None, None, None)


# -- the cost model ----------------------------------------------------------

_PROBES = (
    [(n, 5.0 + n / 1e3) for n in (1 << 16, 1 << 20, 1 << 22)],
    [(65536, 31.2), (1048576, 170.9), (4194304, 581.44)],
    [(1000, 1.0), (2000, 0.5)],                    # negative slope: clamps
    [(1 << 16, 30.0), (1 << 20, 150.0)],
)


@pytest.mark.parametrize("probes", _PROBES)
def test_fit_equals_the_reference(probes):
    got, want = p_cost.CostModel._fit(probes), r_cost.CostModel._fit(probes)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.latency_us > 0 and got.bandwidth_gbps > 0 and got.calibrated
    with pytest.raises(ValueError, match="two probe sizes"):
        p_cost.CostModel._fit(probes[:1])


def test_costmodel_files_load_across_the_packages(tmp_path):
    ref = r_cost.CostModel._fit(_PROBES[1])
    ref.save(str(tmp_path / "ref.json"))
    port = p_cost.CostModel.load(str(tmp_path / "ref.json"))
    assert dataclasses.astuple(port) == dataclasses.astuple(ref)
    port.save(str(tmp_path / "port.json"), card="an H100", power_limit="700")
    with open(tmp_path / "port.json") as f:
        body = json.load(f)
    assert body["schema"] == 1 and body["card"] == "an H100"
    assert p_cost.CostModel.load(str(tmp_path / "port.json")) == port
    assert dataclasses.astuple(r_cost.CostModel.load(
        str(tmp_path / "port.json"))) == dataclasses.astuple(ref)
    with pytest.raises(ValueError, match="overwrite"):
        port.save(str(tmp_path / "bad.json"), latency_us=1.0)
    assert p_cost.CostModel.load_or_default(str(tmp_path / "missing.json")) \
        == p_cost.CostModel()
    committed = "BENCH_costmodel.json"
    assert dataclasses.astuple(p_cost.CostModel.load_or_default(committed)) \
        == dataclasses.astuple(r_cost.CostModel.load_or_default(committed))


def test_walls_and_objective_equal_the_reference():
    ref_tree, tree = _trees("mixed_policy_n8_dev1")
    models = [(p_cost.CostModel(), r_cost.CostModel()),
              (p_cost.CostModel._fit(_PROBES[1]),
               r_cost.CostModel._fit(_PROBES[1]))]
    for policy in _grid("mixed_policy_n8_dev1", 1):
        got = p_cost.policy_cost(tree, policy, ["opt.m"])
        want = r_cost.policy_cost(ref_tree, policy, ["opt.m"])
        for pm, rm in models:
            assert (pm.cold_wall_us(got), pm.steady_wall_us(got),
                    pm.objective_us(got), pm.objective_us(got, 3)) == \
                (rm.cold_wall_us(want), rm.steady_wall_us(want),
                 rm.objective_us(want), rm.objective_us(want, 3))
            assert pm.wall_us(got.regions[0].cold) == \
                rm.wall_us(want.regions[0].cold)
    assert p_cost.CostModel(10.0, 1.0).wall_us((1000, 2)) == \
        pytest.approx(21.0)


# -- check_registry and the CLI ----------------------------------------------

@pytest.mark.parametrize("mesh", [1, 8])
@pytest.mark.parametrize("size", ["smoke", "quick"])
def test_check_registry_equals_the_reference(size, mesh):
    got = p_check.check_registry(size, mesh_size=mesh,
                                 staging_budget_bytes=1000)
    want = r_check.check_registry(size, mesh_size=mesh,
                                  staging_budget_bytes=1000)
    assert set(got) <= set(want)
    assert set(got) == {sc.name for sc in PS.iter_scenarios(size)
                        if sc.declared_policy}
    assert len(got) == 2
    for name in got:
        assert _diags(got[name]) == _diags(want[name])
    assert not any(d.is_error for ds in got.values() for d in ds)
    assert p_check.check_scenario(_PORT["ragged_n32"], mesh_size=mesh) == []


@pytest.mark.parametrize("argv", [
    ["--mesh-size", "1"], ["--mesh-size", "8", "--size", "smoke"],
    ["--mesh-size", "1", "--staging-budget-mb", "0.001"],
    ["--mesh-size", "1", "--staging-budget-mb", "0.001", "--strict"]])
def test_cli_equals_the_reference(argv, capsys):
    rc = p_check.main(argv)
    got = capsys.readouterr().out
    assert rc == r_check.main(argv)
    assert got == capsys.readouterr().out
    assert got.splitlines()[-1].startswith("checked 2 declared policies")


# -- the three-way differential on the port ----------------------------------

@pytest.mark.parametrize("name", _SMOKE)
def test_static_equals_structural_equals_the_ledger(name):
    sc = _PORT[name]
    tree = sc.build()
    policy = sc.policy() or TransferPolicy.of("marshal")
    mutate = list(sc.steady_mutate_paths())
    cost = p_cost.policy_cost(p_cost.signature_tree(tree), policy, mutate)
    cold = PS.derive_policy_motion(tree, policy)
    steady = PS.derive_steady_policy_motion(tree, policy, mutate)
    assert [r.key for r in cost.regions] == list(cold)
    for rc in cost.regions:
        assert _motion(rc.cold) == _motion(cold[rc.key])
        assert _motion(rc.steady) == _motion(steady[rc.key])
    first, warm = PS.run_policy_scenario(sc, policy, tree=tree, passes=2,
                                         session=TransferSession(),
                                         device=CPU)
    assert first.ok and first.motion_ok and warm.ok and warm.motion_ok
    assert (cost.cold_bytes, cost.cold_calls) == \
        (first.h2d_bytes, first.h2d_calls)
    assert (cost.steady_bytes, cost.steady_calls) == \
        (warm.h2d_bytes, warm.h2d_calls)
    for rc in cost.regions:
        assert (first.regions[rc.key]["h2d_bytes"],
                first.regions[rc.key]["h2d_calls"]) == rc.cold.as_tuple()
        assert (warm.regions[rc.key]["h2d_bytes"],
                warm.regions[rc.key]["h2d_calls"]) == rc.steady.as_tuple()


# -- no fallback, and what still raises --------------------------------------

def test_the_live_mesh_and_calibration_need_a_card():
    tree = from_reference_tree(_hand_tree())
    with pytest.raises(NoCudaDeviceError):
        p_check.check_policy(tree, "**=marshal")
    with pytest.raises(NoCudaDeviceError):
        p_check.check_registry("smoke")
    with pytest.raises(NoCudaDeviceError):
        p_check.main([])
    with pytest.raises(NoCudaDeviceError):
        p_cost.CostModel.calibrate()
    with pytest.raises(ValueError, match="host->card link"):
        p_cost.CostModel.calibrate(device=CPU)


def test_sharded_execution_still_raises():
    """What the cost model prices for a sharded rule is what executing it
    on a K-position mesh books, per position; on a mesh narrower than the
    rule, execution raises the stale-mesh error (DC106's condition)."""
    sc = _PORT["mixed_policy_n8_dev1"]
    tree = sc.build()
    policy = "params/**=marshal@dp2; **=marshal"
    cost = p_cost.policy_cost(tree, policy)
    assert cost.region("params/**").cold.per_device_tuple() == (48, 1)
    m, = PS.run_policy_scenario(sc, policy, device=CPU,
                                session=TransferSession())
    assert m.ok and m.motion_ok
    for rc in cost.regions:
        led = m.regions[rc.key]
        assert (led["h2d_bytes"], led["h2d_calls"]) == rc.cold.as_tuple()
        if rc.cold.per_device_tuple() is not None:
            assert {d: (led["h2d_bytes_by_device"][d],
                        led["h2d_calls_by_device"][d])
                    for d in led["h2d_bytes_by_device"]} == \
                {"0": (48, 1), "1": (48, 1)}
    assert [d.code for d in p_check.check_policy(tree, policy,
                                                 mesh_size=1)] == ["DC106"]
    for run in (lambda: TransferSession().compile(tree, policy,
                                                  device=[CPU]),
                lambda: transfer_scheme("marshal+delta@dp8",
                                        device=[CPU] * 4)):
        with pytest.raises(UnsupportedSpecError, match="stale for this"):
            run()
    for case in (PS.mixed_policy_case(16, 2), PS.elastic_case(16, 4)):
        assert all(mm.ok and mm.motion_ok for mm in PS.run_policy_scenario(
            case, passes=2, device=CPU, session=TransferSession()))
