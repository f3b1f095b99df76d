"""Per-device incremental transfers (``marshal+delta@dpK``) on the port.

Held to the JAX package on a CPU mesh (``device="cpu"``: K positions):

  * the steady harness against the reference's own 4-device run (three
    passes after mutating ``hot.a`` / ``hot.b``: per-device h2d and skipped
    bytes equal), and against the closed form and the structural
    derivation at K = 2, 4 and 8;
  * shard granularity: a partial-bucket mutation ships only the shards it
    overlaps, a clean repeat ships nothing and books every shard skipped on
    its position, earlier device trees keep their bytes;
  * the in-place write check per shard: a write through a leaf's piece
    on shard s re-ships shard s, and only it;
  * the staging race sanitizer on sharded passes: a clean drive (blocking,
    delta, a program under both executors) has no finding, and the DC301
    mutant (staging rewritten while a shard copy is held) is caught.
"""
import copy

import numpy as np
import pytest
import torch

from repro import scenarios as RS
from repro.scenarios import families as r_families

from repro_torch import scenarios as PS
from repro_torch.analysis import sanitizer
from repro_torch.analysis.sanitizer import StagingRaceError
from repro_torch.core import (MarshalScheme, ShardedTensor, TransferSession,
                              TransferSpec, TreePath, plan, to_host,
                              transfer_scheme, tree_leaves)
from repro_torch.core.engine import ArenaEntry
from test_torch_sharded import _mt, reference_four_devices

CPU = "cpu"
SPEC = "marshal+delta@dp4"


@pytest.fixture(scope="module")
def ref4():
    return reference_four_devices()


@pytest.fixture
def san():
    prev = sanitizer._ACTIVE
    machine = sanitizer.enable(fresh=True)
    yield machine
    sanitizer._ACTIVE = prev


def _mutate(tree, paths):
    for p in paths:
        tp = TreePath.parse(p)
        leaf = tp.resolve(tree)
        tree = tp.set(tree, leaf + torch.ones((), dtype=leaf.dtype))
    return tree


# -- the steady harness ---------------------------------------------------------

@pytest.mark.parametrize("size", ["smoke", "quick"])
def test_steady_passes_equal_the_reference_four_device_run(size, ref4):
    sc = PS.iter_scenarios(size, only=["sharded_delta"], devices=4)[0]
    want = ref4["steady"][sc.name]
    got = PS.run_steady_scenario(sc, passes=3, device=CPU)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert w["ok"] and w["motion_ok"] and g.ok and g.motion_ok
        assert (g.h2d_bytes, g.h2d_calls, g.skipped_bytes) == \
            (w["h2d_bytes"], w["h2d_calls"], w["skipped_bytes"])
        assert g.h2d_by_device == w["h2d_by_device"]
        assert g.skipped_by_device == w["skipped_by_device"]
        assert g.spec == SPEC


@pytest.mark.parametrize("k", [2, 4, 8])
def test_steady_closed_form_equals_derivation_and_ledger(k):
    sc = PS.iter_scenarios("quick", only=["sharded_delta"], devices=k)[0]
    n = sc.params["n"]
    want = r_families.sharded_delta_steady_expected(n, k)
    derived = RS.derive_steady_motion(r_families.sharded_delta_tree(n, k),
                                      ["hot.a", "hot.b"], num_shards=k)
    assert _mt(sc.steady_expected) == _mt(want) == _mt(derived)
    assert _mt(PS.derive_steady_motion(sc.build(), ["hot.a", "hot.b"],
                                       num_shards=k)) == _mt(want)
    full = sum(plan(sc.build(), shard_multiple=k).bucket_bytes().values())
    for m in PS.run_steady_scenario(sc, passes=2, device=CPU):
        assert m.ok and m.motion_ok
        assert (m.h2d_bytes, m.h2d_calls) == want.as_tuple()
        assert {d: m.h2d_by_device.get(d, 0) + m.skipped_by_device[d]
                for d in m.skipped_by_device} == \
            {str(s): full // k for s in range(k)}


def test_steady_derivation_for_an_undeclared_sharded_spec():
    """Any delta spec drives any steady scenario: marshal+delta@dp4 over
    steady_reuse is held to the structural derivation per position."""
    sc = PS.iter_scenarios("smoke", only=["steady_reuse"])[0]
    for m in PS.run_steady_scenario(sc, passes=2, spec=SPEC, device=CPU):
        assert m.ok and m.motion_ok and m.h2d_calls >= 1


# -- shard granularity -----------------------------------------------------------

def test_cold_pass_equals_plain_sharded_marshal():
    tree = PS.sharded_delta_tree(64, 4)
    plain = transfer_scheme("marshal@dp4", device=CPU)
    delta = transfer_scheme(SPEC, device=CPU)
    plain.to_device(tree)
    delta.to_device(tree)
    assert plain.ledger.per_device() == delta.ledger.per_device()
    assert (plain.ledger.h2d_bytes, plain.ledger.h2d_calls) == \
        (delta.ledger.h2d_bytes, delta.ledger.h2d_calls)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_partial_bucket_mutation_ships_only_overlapped_shards(k):
    n = 8 * k
    rng = np.random.default_rng(3)
    # sorted key order: a_hot | b_cold, the hot leaf the first quarter of
    # the f32 bucket, so exactly ceil(k/4) shards are dirty
    tree = {"a_hot": torch.from_numpy(rng.standard_normal(n).astype(np.float32)),
            "b_cold": torch.from_numpy(
                rng.standard_normal(3 * n).astype(np.float32))}
    scheme = transfer_scheme(f"marshal+delta@dp{k}", device=CPU)
    scheme.to_device(tree)
    step = scheme.layout.bucket_sizes["float32"] // k
    dirty = -(-n // step)
    assert dirty < k
    t2 = dict(tree, a_hot=tree["a_hot"] + 1.0)
    scheme.ledger.reset()
    dev = scheme.to_device(t2)
    assert (scheme.ledger.h2d_bytes, scheme.ledger.h2d_calls) == \
        (dirty * step * 4, dirty)
    assert scheme.ledger.h2d_bytes_by_device == \
        {str(s): step * 4 for s in range(dirty)}
    assert scheme.ledger.skipped_bytes_by_device == \
        {str(s): step * 4 for s in range(dirty, k)}
    for a, b in zip(tree_leaves(dev), tree_leaves(t2)):
        assert torch.equal(to_host(a), b)


def test_clean_repeat_ships_nothing_and_returns_the_memo():
    sc = PS.sharded_delta_case(16, 4)
    tree = sc.build()
    scheme = sc.scheme_for(sc.steady_spec, device=CPU)
    first = scheme.to_device(tree)
    scheme.ledger.reset()
    again = scheme.to_device(tree)
    assert again is first
    assert (scheme.ledger.h2d_bytes, scheme.ledger.h2d_calls) == (0, 0)
    assert scheme.ledger.skipped_bytes_by_device == \
        {str(s): 80 for s in range(4)}
    assert scheme.ledger.delta_calls == 1


def test_device_trees_survive_later_passes():
    sc = PS.sharded_delta_case(16, 4)
    scheme = sc.scheme_for(sc.steady_spec, device=CPU)
    trees = [sc.build()]
    devs = [scheme.to_device(trees[0])]
    for _ in range(3):
        trees.append(_mutate(copy.deepcopy(trees[-1]),
                             sc.params["mutate_paths"]))
        devs.append(scheme.to_device(trees[-1]))
    for t, d in zip(trees, devs):
        for a, b in zip(tree_leaves(d), tree_leaves(t)):
            assert torch.equal(to_host(a), b)


def test_retained_shards_are_counted_and_released():
    session = TransferSession()
    tree = PS.sharded_delta_tree(16, 4)
    scheme = MarshalScheme(TransferSpec.parse(SPEC), session, device=CPU)
    scheme.to_device(tree)
    # two buckets, four shards each, all retained
    assert session.cache_stats()["retained_device_buckets"] == 8
    session.clear()
    assert session.cache_stats()["retained_device_buckets"] == 0


# -- the in-place write check, per shard -------------------------------------

def test_in_place_write_through_a_piece_reships_that_shard_only():
    sc = PS.sharded_delta_case(16, 4)
    tree = sc.build()
    scheme = sc.scheme_for(sc.steady_spec, device=CPU)
    dev = scheme.to_device(tree)
    # cold[32] packs first: its pieces are shard 0 [0, 16) and 1 [16, 32)
    piece = next(p for p in dev["cold"].pieces if p.position == 1)
    piece.tensor.mul_(2.0)              # a caller writes the device value
    assert not torch.equal(to_host(dev["cold"]), tree["cold"])
    scheme.ledger.reset()
    again = scheme.to_device(tree)
    assert scheme.ledger.h2d_bytes_by_device == {"1": 64}
    assert scheme.ledger.h2d_calls == 1
    assert scheme.ledger.skipped_bytes_by_device == \
        {"0": 80, "1": 16, "2": 80, "3": 80}
    for a, b in zip(tree_leaves(again), tree_leaves(tree)):
        assert torch.equal(to_host(a), b)


def test_mark_dirty_after_an_in_place_host_write():
    sc = PS.sharded_delta_case(16, 4)
    tree = sc.build()
    scheme = sc.scheme_for(sc.steady_spec, device=CPU)
    scheme.to_device(tree)
    tree["hot"]["b"][0] += 1.0          # the host leaf written in place
    scheme.mark_dirty(tree, "hot.b")
    scheme.ledger.reset()
    dev = scheme.to_device(tree)
    # hot.b is elements [48, 64) of the f32 bucket: shard 3 only
    assert scheme.ledger.h2d_bytes_by_device == {"3": 64}
    assert torch.equal(to_host(dev["hot"]["b"]), tree["hot"]["b"])


# -- the staging race sanitizer on sharded passes ---------------------------------

def test_clean_sharded_drive_has_no_finding(san):
    sc = PS.sharded_delta_case(16, 4)
    for spec in sc.specs():
        m = PS.run_scenario(sc, spec, device=CPU)
        assert m.ok and m.motion_ok
    for m in PS.run_steady_scenario(sc, passes=3, device=CPU):
        assert m.ok and m.motion_ok
    pol = PS.mixed_policy_case(16, 4)
    for executor in ("blocking", "async"):
        for m in PS.run_policy_scenario(pol, passes=3, device=CPU,
                                        executor=executor,
                                        session=TransferSession()):
            assert m.ok and m.motion_ok and m.syncs == 1
    for event in ("enqueue", "drain", "sync", "add_fence", "staging_write"):
        assert san.events.get(event, 0) > 0, event


class _SkipFenceWaitEntry(ArenaEntry):
    """Seeded bug: rewrites staging without waiting the buffer's fence."""

    def _wait_fence(self, bucket: str, buf_idx: int) -> None:
        pass  # the bug: no event wait, no clear, no on_fence_wait


class _SkipFenceWaitScheme(MarshalScheme):
    """A sharded delta executor over the seeded entry."""

    def _entry_for(self, tree):
        if self._entry is None:
            base = self.session.get_entry(tree, self.align_elems,
                                          num_shards=len(self.mesh))
            self._entry = _SkipFenceWaitEntry(base.layout)
            self.layout = base.layout
        return self._entry


def _drive_sharded_passes(scheme):
    sc = PS.sharded_delta_case(16, 4)
    tree = sc.build()
    for _ in range(3):
        tree = _mutate(tree, sc.params["mutate_paths"])
        scheme.begin_pass(tree)[1]()


def test_dc301_mutant_caught_on_a_sharded_pass(san):
    bad = _SkipFenceWaitScheme(TransferSpec.parse(SPEC), TransferSession(),
                               device=CPU)
    with pytest.raises(StagingRaceError) as ei:
        _drive_sharded_passes(bad)
    assert ei.value.code == "DC301"
    # the clean twin: each shard copy's fence waited before the rewrite
    good = MarshalScheme(TransferSpec.parse(SPEC), TransferSession(),
                         device=CPU)
    _drive_sharded_passes(good)
    assert san.events["fence_wait"] >= 2


def test_dc305_mutant_caught_on_a_sharded_pass(san):
    scheme = MarshalScheme(TransferSpec.parse("marshal@dp4"),
                           TransferSession(), device=CPU)
    _, finish = scheme.begin_pass(PS.sharded_tree(64, 4))
    # the bug: staging scribbled while the shard copies are in flight
    scheme._entry.staging["float32"][0] += 1.0  # lint: allow=DC204 -- seeded bug
    with pytest.raises(StagingRaceError) as ei:
        finish()
    assert ei.value.code == "DC305"


def test_sharded_leaves_are_sharded_tensors():
    out = transfer_scheme(SPEC, device=CPU).to_device(
        PS.sharded_delta_tree(16, 4))
    assert all(isinstance(l, ShardedTensor) for l in tree_leaves(out))
