"""Algorithm 2 on the port held against the JAX package, scheme by scheme.

Every scenario of the nine ported families at the smoke preset runs under
uvm, marshal, marshal+db, marshal+delta and pointerchain in both packages
on the same trees (the reference's numpy trees, carried across with
``from_reference_tree``).  The port must pass line 7, book a ledger equal
to the reference's (byte and call fields) and to ``expected_motion``, and
copy back a host tree equal to the reference's bit for bit: x1.5 is one
IEEE multiply with round-to-nearest-even in both, bf16 included.

Also here: the delta engine's contracts (as tests/test_delta.py states them
for the reference), the checks that must discriminate (a lying fingerprint,
a dropped leaf, stale bf16 data), and the rule that nothing falls back to
the CPU unless the caller asked for it.
"""
import copy
import re
from pathlib import Path

import jax
import ml_dtypes  # noqa: F401  (registers numpy's bfloat16 for the reference)
import numpy as np
import pytest
import torch

from repro import scenarios as RS
from repro.core import clear_cache as r_clear_cache
from repro.core import declare as r_declare
from repro.core import extract as r_extract
from repro.core import insert as r_insert
from repro.core import transfer_scheme as r_transfer_scheme
from repro.scenarios import driver as r_driver

from repro_torch import NoCudaDeviceError
from repro_torch import scenarios as PS
from repro_torch.convert import from_reference_tree, to_reference_tree
from repro_torch.core import (MarshalScheme, ShapeDtype, TransferSession,
                              TransferSpec, TreePath, UnsupportedSpecError,
                              declare, extract, full_deepcopy,
                              host_skeleton, insert, selective_deepcopy,
                              transfer_scheme, tree_bytes, tree_leaves,
                              tree_map)
from repro_torch.kernels.marshal_pack import ops as p_ops

CPU = "cpu"
FAMILIES = ("linear", "dense", "ragged", "mixed_dtype", "sweep",
            "model_state", "mixed_policy", "elastic", "steady_reuse")
SPECS = ("uvm", "marshal", "marshal+db", "marshal+delta", "pointerchain")
_REF = {sc.name: sc for sc in RS.iter_scenarios("smoke", only=FAMILIES)}
_PORT = {sc.name: sc for sc in PS.iter_scenarios("smoke")}
_CELLS = [(name, spec) for name in _REF for spec in SPECS]
_LEDGER_FIELDS = ("h2d_bytes", "h2d_calls", "d2h_bytes", "d2h_calls",
                  "skipped_bytes", "delta_calls", "h2d_bytes_by_device",
                  "h2d_calls_by_device", "skipped_bytes_by_device")


@pytest.fixture(scope="module")
def ref_trees():
    return {name: sc.build() for name, sc in _REF.items()}


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(f"u{a.dtype.itemsize}")


def _ref_pass(sc, spec, tree):
    """The reference's Algorithm-2 pass, returning its copied-back host
    tree and its ledger."""
    scheme = r_transfer_scheme(spec)
    refs = r_declare(tree, *sc.used_paths)
    dev, _ = scheme.stage(tree, list(sc.used_paths),
                          uvm_access=list(sc.uvm_access) if sc.uvm_access
                          else None, declare_refs=False)
    out = r_driver._KERNEL(*r_extract(dev, refs))
    host = scheme.from_device(r_insert(dev, refs, out), tree)
    return host, scheme.ledger.as_dict()


def _port_pass(sc, spec, tree):
    scheme = transfer_scheme(spec, device=CPU)
    refs = declare(tree, *sc.used_paths)
    dev, _ = scheme.stage(tree, list(sc.used_paths),
                          uvm_access=list(sc.uvm_access) if sc.uvm_access
                          else None, declare_refs=False)
    out = PS.scale_kernel(extract(dev, refs))
    host = scheme.from_device(insert(dev, refs, out), tree)
    return host, scheme.ledger.as_dict()


@pytest.mark.parametrize("name,spec", _CELLS,
                         ids=[f"{n}-{s}" for n, s in _CELLS])
def test_algorithm2_parity_with_reference(name, spec, ref_trees):
    r_clear_cache()
    ref_tree = ref_trees[name]
    tree = from_reference_tree(ref_tree)
    m = PS.run_scenario(_PORT[name], spec, tree=tree, device=CPU)
    assert m.ok, f"line-7 check failed for {name}/{spec}"
    assert m.motion_ok
    want = _REF[name].expected_motion(spec, ref_tree)
    assert (m.h2d_bytes, m.h2d_calls) == want.as_tuple()
    assert m.device == "cpu" and m.spec == spec

    ref_host, ref_ledger = _ref_pass(_REF[name], spec, ref_tree)
    host, ledger = _port_pass(_PORT[name], spec, tree)
    assert {f: ledger[f] for f in _LEDGER_FIELDS} == \
        {f: ref_ledger[f] for f in _LEDGER_FIELDS}
    got = jax.tree_util.tree_leaves(to_reference_tree(host))
    want_leaves = jax.tree_util.tree_leaves(ref_host)
    assert len(got) == len(want_leaves)
    for g, w in zip(got, want_leaves):
        w = np.asarray(w)
        assert g.dtype.name == w.dtype.name and g.shape == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_steady_state_parity_with_reference():
    r_clear_cache()
    name = next(n for n in _REF if _REF[n].family == "steady_reuse")
    want = RS.run_steady_scenario(_REF[name], passes=3)
    got = PS.run_steady_scenario(_PORT[name], passes=3, device=CPU)
    for g, w in zip(got, want):
        assert g.ok and g.motion_ok and w.ok and w.motion_ok
        assert (g.h2d_bytes, g.h2d_calls, g.skipped_bytes) == \
            (w.h2d_bytes, w.h2d_calls, w.skipped_bytes)
        assert (g.h2d_bytes, g.h2d_calls) == \
            _PORT[name].steady_expected.as_tuple()


def test_steady_derivation_for_an_undeclared_spec():
    sc = next(s for s in _PORT.values() if s.family == "steady_reuse")
    for m in PS.run_steady_scenario(sc, passes=2, spec="marshal+delta+align64",
                                    device=CPU):
        assert m.ok and m.motion_ok and m.h2d_calls == 1


# -- delta engine contracts --------------------------------------------------

def _tree(seed=0, n=64):
    rng = np.random.default_rng(seed)
    return from_reference_tree(
        {"f32": {"a": rng.standard_normal(n).astype(np.float32),
                 "b": rng.standard_normal(2 * n).astype(np.float32)},
         "i32": np.arange(n, dtype=np.int32),
         "bf16": rng.standard_normal(4 * n).astype(np.float32)
         .astype("bfloat16")})


def _plus_one(tree):
    return tree_map(lambda x: x + torch.ones((), dtype=x.dtype), tree)


def _leaves_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.cpu(), y.cpu())


def test_clean_repeat_ships_nothing():
    tree = _tree()
    s = transfer_scheme("marshal+delta", TransferSession(), device=CPU)
    s.to_device(tree)
    full = sum(s.layout.bucket_bytes().values())
    assert s.ledger.h2d_bytes == full
    s.ledger.reset()
    dev = s.to_device(tree)
    assert (s.ledger.h2d_bytes, s.ledger.h2d_calls) == (0, 0)
    assert s.ledger.skipped_bytes == full and s.ledger.delta_calls == 1
    _leaves_equal(dev, tree)


def test_one_leaf_mutation_ships_only_its_bucket():
    tree = _tree()
    s = transfer_scheme("marshal+delta", TransferSession(), device=CPU)
    s.to_device(tree)
    bb = s.layout.bucket_bytes()
    t2 = dict(tree, bf16=tree["bf16"] + torch.ones((), dtype=torch.bfloat16))
    s.ledger.reset()
    dev = s.to_device(t2)
    assert (s.ledger.h2d_bytes, s.ledger.h2d_calls) == (bb["bfloat16"], 1)
    assert s.ledger.skipped_bytes == sum(bb.values()) - bb["bfloat16"]
    _leaves_equal(s.from_device(dev, t2), copy.deepcopy(t2))


def test_in_place_mutation_needs_mark_dirty():
    tree = _tree()
    s = transfer_scheme("marshal+delta", TransferSession(), device=CPU)
    s.to_device(tree)
    bb = s.layout.bucket_bytes()
    tree["f32"]["a"][:] = -7.0               # in place: identity unchanged
    s.ledger.reset()
    stale = s.to_device(tree)
    assert s.ledger.h2d_bytes == 0           # the documented hazard
    assert not torch.allclose(stale["f32"]["a"], torch.full((64,), -7.0))
    s.mark_dirty(tree, "f32.a")
    s.ledger.reset()
    dev = s.to_device(tree)
    assert (s.ledger.h2d_bytes, s.ledger.h2d_calls) == (bb["float32"], 1)
    assert torch.equal(dev["f32"]["a"], torch.full((64,), -7.0))


# -- in-place writes to a delta pass's leaves (the returned tree is views of
# the retained device buckets) ---------------------------------------------

def test_write_to_a_returned_leaf_is_not_served_again():
    """The memo path: nothing changed on the host, but the caller scaled a
    leaf of the returned tree in place.  The next pass re-ships that
    bucket alone (booked as H2D) and returns the host's values; the pass
    after it is clean again and ships nothing."""
    tree = _tree()
    s = transfer_scheme("marshal+delta", TransferSession(), device=CPU)
    dev = s.to_device(tree)
    bb = s.layout.bucket_bytes()
    dev["f32"]["a"].mul_(1.5)
    s.ledger.reset()
    again = s.to_device(tree)
    _leaves_equal(again, tree)
    assert (s.ledger.h2d_bytes, s.ledger.h2d_calls) == (bb["float32"], 1)
    assert s.ledger.skipped_bytes == sum(bb.values()) - bb["float32"]
    s.ledger.reset()
    _leaves_equal(s.to_device(tree), tree)
    assert (s.ledger.h2d_bytes, s.ledger.h2d_calls) == (0, 0)
    assert s.ledger.skipped_bytes == sum(bb.values())


def test_write_on_a_partly_dirty_pass_is_not_served_again():
    """The host changed the bf16 bucket and the caller wrote into the i32
    bucket through ``index_copy_``: the pass re-ships both, skips only the
    untouched f32 bucket, and returns the new host tree."""
    tree = _tree()
    s = transfer_scheme("marshal+delta", TransferSession(), device=CPU)
    dev = s.to_device(tree)
    bb = s.layout.bucket_bytes()
    dev["i32"].index_copy_(0, torch.tensor([0, 5]),
                           torch.tensor([-9, -9], dtype=torch.int32))
    t2 = dict(tree, bf16=tree["bf16"] + torch.ones((), dtype=torch.bfloat16))
    s.ledger.reset()
    _leaves_equal(s.to_device(t2), t2)
    assert (s.ledger.h2d_bytes, s.ledger.h2d_calls) == \
        (bb["bfloat16"] + bb["int32"], 2)
    assert s.ledger.skipped_bytes == bb["float32"]


def test_write_to_a_delta_region_of_a_program_is_not_served_again():
    """A program whose delta region's leaf was written in place: the next
    pass returns the host's values and re-ships that region's written
    bucket alone; with no write, every repeat ships exactly nothing of the
    region and the other regions' closed forms are unchanged."""
    from repro_torch.core import TransferPolicy

    host = {"cache": _tree(seed=2), "params": _tree(seed=3, n=32),
            "slots": {"rid": torch.arange(4, dtype=torch.int32)}}
    prog = TransferSession().compile(
        host, TransferPolicy.parse("params/**=marshal; "
                                   "cache/**=marshal+delta; **=pointerchain"),
        device=CPU)
    dev = prog.to_device(host)
    cache = prog.ledgers["cache/**"]
    full = (cache.h2d_bytes, cache.h2d_calls)
    bb = prog._schemes["cache/**"].layout.bucket_bytes()
    assert full == (sum(bb.values()), len(bb))

    def shipped():
        return {k: (l.h2d_bytes, l.h2d_calls)
                for k, l in prog.ledgers.items()}

    before = shipped()
    _leaves_equal(prog.to_device(host), host)        # no write: steady
    after = shipped()
    assert after["cache/**"] == before["cache/**"]
    for key in ("params/**", "**"):
        assert after[key][0] == 2 * before[key][0]
    dev = prog.to_device(host)
    dev["cache"]["f32"]["b"].mul_(1.5)
    before = shipped()
    _leaves_equal(prog.to_device(host), host)
    got = shipped()["cache/**"]
    assert (got[0] - before["cache/**"][0], got[1] - before["cache/**"][1]) \
        == (bb["float32"], 1)


def test_bump_version_forces_reship():
    tree = _tree()
    s = transfer_scheme("marshal+delta", TransferSession(), device=CPU)
    s.to_device(tree)
    bb = s.layout.bucket_bytes()
    s._entry.bump_version("float32")
    s.ledger.reset()
    s.to_device(tree)
    assert (s.ledger.h2d_bytes, s.ledger.h2d_calls) == (bb["float32"], 1)


def test_nan_payload_stays_clean_on_repeat():
    """The staged-vs-new compare is on raw bytes: a NaN leaf repacked from
    a NEW object with the same bits must not count as changed."""
    tree = _tree()
    tree["f32"]["a"][3] = float("nan")
    s = transfer_scheme("marshal+delta", TransferSession(), device=CPU)
    s.to_device(tree)
    s.ledger.reset()
    s.to_device(tree_map(lambda x: x.clone(), tree))
    assert (s.ledger.h2d_bytes, s.ledger.h2d_calls) == (0, 0)


@pytest.mark.parametrize("spec", ["marshal+delta", "marshal+db"])
def test_double_buffer_preserves_previous_device_trees(spec):
    """A rewrite goes to the OTHER staging buffer, and device values from
    earlier passes keep their bytes."""
    t1 = _tree(seed=1)
    s = transfer_scheme(spec, TransferSession(), device=CPU)
    dev1 = s.to_device(t1)
    t2 = _plus_one(t1)
    dev2 = s.to_device(t2)
    t3 = _plus_one(t2)
    dev3 = s.to_device(t3)                   # rotates back onto dev1's buffer
    _leaves_equal(dev1, t1)
    _leaves_equal(dev2, t2)
    _leaves_equal(dev3, t3)


def test_device_buffers_never_alias_staging():
    """Blocking marshal: rewriting the staging buffers after to_device must
    not reach the device tree (on the CPU every copy is a real copy)."""
    tree = _tree()
    s = transfer_scheme("marshal", TransferSession(), device=CPU)
    dev = s.to_device(tree)
    for buf in s._entry._bufs.values():
        for b in buf:
            b.fill_(-1)
    _leaves_equal(dev, tree)


def test_delta_schemes_do_not_share_shipped_state():
    session = TransferSession()
    tree = _tree()
    transfer_scheme("marshal+delta", session, device=CPU).to_device(tree)
    b = transfer_scheme("marshal+delta", session, device=CPU)
    b.to_device(tree)
    assert b.ledger.h2d_bytes == sum(b.layout.bucket_bytes().values())


class _StaleFingerprintDelta(MarshalScheme):
    """A broken delta engine whose version counters freeze after warm-up,
    so every later pass claims every bucket is clean."""

    def __init__(self, session):
        super().__init__("marshal+delta", session, device=CPU)

    def _entry_for(self, tree):
        entry = super()._entry_for(tree)
        if not hasattr(entry, "_frozen"):
            entry._frozen = None
            orig_pack = entry.pack_host

            def lying_pack(t, **kw):
                out = orig_pack(t, **kw)
                if entry._frozen is None:
                    entry._frozen = dict(entry.versions)
                else:
                    entry.versions.update(entry._frozen)
                return out

            entry.pack_host = lying_pack
        return entry


def test_stale_fingerprint_fails_algorithm2_check():
    sc = next(s for s in _PORT.values() if s.family == "mixed_dtype")
    honest = transfer_scheme("marshal+delta", TransferSession(), device=CPU)
    assert PS.run_scenario(sc, scheme=honest).ok
    assert PS.run_scenario(sc, scheme=honest).ok
    liar = _StaleFingerprintDelta(TransferSession())
    assert PS.run_scenario(sc, scheme=liar).ok          # warm-up ships
    tree2 = tree_map(lambda x: x + 1 if x.dtype.is_floating_point else x,
                     sc.build())
    assert not PS.run_scenario(sc, scheme=liar, tree=tree2).ok


class _LeafDroppingMarshal(MarshalScheme):
    def stage(self, tree, used_paths, uvm_access=None, declare_refs=True):
        dev, refs = super().stage(tree, used_paths, uvm_access)
        leaves = extract(dev, refs)
        leaves[0] = torch.zeros_like(leaves[0])
        return insert(dev, refs, leaves), refs


class _StaleBf16Marshal(MarshalScheme):
    def from_device(self, device_tree, host_tree, paths=None):
        out = super().from_device(device_tree, host_tree, paths)
        return TreePath.parse("bf16.w").set(out, host_tree["bf16"]["w"])


@pytest.mark.parametrize("family", ["dense", "linear"])
def test_corrupting_scheme_fails_the_check(family):
    sc = next(s for s in _PORT.values() if s.family == family)
    assert PS.run_scenario(sc, scheme=MarshalScheme(device=CPU)).ok
    assert not PS.run_scenario(sc, scheme=_LeafDroppingMarshal(device=CPU)).ok


def test_bf16_check_is_not_vacuous():
    sc = next(s for s in _PORT.values() if s.family == "mixed_dtype")
    assert PS.run_scenario(sc, scheme=MarshalScheme(device=CPU)).ok
    assert not PS.run_scenario(sc, scheme=_StaleBf16Marshal(device=CPU)).ok


def test_run_scenario_honors_scheme_alignment():
    sc = next(s for s in _PORT.values() if s.family == "dense")
    m = PS.run_scenario(sc, scheme=transfer_scheme("marshal+align64",
                                                   device=CPU))
    assert m.ok and m.motion_ok
    assert m.expected.h2d_bytes > sc.expected_motion("marshal").h2d_bytes


# -- deep copy, sessions -----------------------------------------------------

def test_deepcopy_oracle_copies_and_books():
    from repro_torch.core import TransferLedger

    tree = _tree()
    led = TransferLedger()
    full = full_deepcopy(tree, device=CPU, ledger=led)
    assert (led.h2d_bytes, led.h2d_calls) == (tree_bytes(tree), 4)
    for a, b in zip(tree_leaves(full), tree_leaves(tree)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    led.reset()
    part = selective_deepcopy(tree, ["f32"], device=CPU, ledger=led)
    assert led.h2d_calls == 2 and part["i32"] is tree["i32"]
    skel = host_skeleton(tree)
    assert skel["bf16"] == ShapeDtype((256,), torch.bfloat16)
    assert len(tree_leaves(skel)) == len(tree_leaves(tree))


def test_session_cache_is_bounded_and_clearable():
    session = TransferSession(entry_max=2)
    schemes = [transfer_scheme("marshal+delta", session, device=CPU)
               for _ in range(3)]
    for s, n in zip(schemes, (8, 16, 32)):
        s.to_device({"a": torch.zeros(n)})
    stats = session.cache_stats()
    assert stats["entry_size"] == 2 and stats["entry_evictions"] == 1
    assert stats["retained_device_buckets"] == 3
    session.clear()
    assert session.cache_stats()["retained_device_buckets"] == 0


# -- no hidden fallback ------------------------------------------------------

def test_default_device_is_cuda_or_raises():
    """Entry points run on the card unless the caller asks for the CPU;
    without a card they raise instead of running on the CPU."""
    tree = _tree()
    sc = next(iter(_PORT.values()))
    calls = [lambda: transfer_scheme("marshal"),
             lambda: transfer_scheme("uvm@dev0"),
             lambda: p_ops.pack_tree({"a": torch.zeros(8)}),
             lambda: PS.run_scenario(sc, "pointerchain"),
             lambda: PS.run_algorithm2(tree, ["f32.a"], "marshal"),
             lambda: full_deepcopy(tree)]
    if torch.cuda.is_available():
        assert transfer_scheme("marshal").device.type == "cuda"
        return
    for call in calls:
        with pytest.raises(NoCudaDeviceError):
            call()


def test_sharded_specs_parse_but_do_not_execute():
    """A sharded spec parses anywhere, but executes only on a mesh of K
    positions: on a shorter one it raises the stale-mesh error, and
    without a card the default mesh raises like every other default."""
    spec = TransferSpec.parse("marshal@dp2")
    assert spec.num_shards == 2
    with pytest.raises(UnsupportedSpecError, match="stale for this"):
        transfer_scheme(spec, device=[CPU])
    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDeviceError):
            transfer_scheme(spec)
    scheme = transfer_scheme(spec, device=CPU)
    assert scheme.mesh == (torch.device("cpu"),) * 2
    tree = {"a": torch.arange(6, dtype=torch.float32)}
    out = scheme.to_device(tree)
    assert [(p.position, p.lo, p.hi) for p in out["a"].pieces] == \
        [(0, 0, 3), (1, 3, 6)]
    assert torch.equal(scheme.from_device(out, tree)["a"], tree["a"])
    assert scheme.ledger.per_device() == {"0": (12, 1), "1": (12, 1)}
    assert transfer_scheme("marshal@dev0", device=CPU).device.type == "cpu"


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\s|\.|,|$)"
    r"|from\s+repro(\.|\s))", re.M)


def test_port_imports_neither_jax_nor_the_reference():
    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        hit = _FORBIDDEN.search(f.read_text())
        assert hit is None, f"{f}: {hit.group(0).strip()}"
