"""The port's structure modules held against the JAX package.

Same inputs (the reference registry's numpy trees, carried across with
``from_reference_tree``) must give the same leaf order and paths, the same
chain indices, the same spec strings and errors, and the same arena
layouts.  Both packages run on the CPU here; nothing needs a card.
"""
import itertools

import jax
import ml_dtypes  # noqa: F401  (registers numpy's bfloat16 for the reference)
import numpy as np
import pytest
import torch

from repro import scenarios as RS
from repro.core import arena as r_arena
from repro.core import chainref as r_chainref
from repro.core import spec as r_spec
from repro.core import treepath as r_treepath

from repro_torch import scenarios as PS
from repro_torch.convert import from_reference_tree, to_reference_tree
from repro_torch.core import arena as p_arena
from repro_torch.core import chainref as p_chainref
from repro_torch.core import spec as p_spec
from repro_torch.core import treepath as p_treepath

# the port's families in its registration order: the reference's, all of
# them (the mesh-sized ones at one device, the reference's device count
# in this process)
FAMILIES = ("linear", "dense", "ragged", "mixed_dtype", "sweep",
            "model_state", "sharded", "sharded_delta", "mixed_policy",
            "elastic", "steady_reuse")
_REF = {sc.name: sc for size in ("smoke", "quick")
        for sc in RS.iter_scenarios(size, only=FAMILIES)}
_PORT = {sc.name: sc for size in ("smoke", "quick")
         for sc in PS.iter_scenarios(size)}
_NAMES = sorted(_REF)
_SMOKE = [sc.name for sc in RS.iter_scenarios("smoke", only=FAMILIES)]


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(f"u{a.dtype.itemsize}") if a.dtype.itemsize in (1, 2, 4, 8) \
        else a


def _assert_bit_equal(ref_tree, port_tree):
    ref_leaves = jax.tree_util.tree_leaves(ref_tree)
    port_leaves = jax.tree_util.tree_leaves(to_reference_tree(port_tree))
    assert len(ref_leaves) == len(port_leaves)
    for want, got in zip(ref_leaves, port_leaves):
        want = np.asarray(want)
        assert got.dtype.name == want.dtype.name and got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))


def _port_input(name, ref_tree):
    """The port's tree for the value comparisons: its own build, except for
    model_state, whose values the reference draws with jax.random; there
    the same input is the reference's tree carried across."""
    if _REF[name].family == "model_state":
        return from_reference_tree(ref_tree)
    return _PORT[name].build()


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name in _NAMES:
        ref_tree = _REF[name].build()
        out[name] = (ref_tree, _port_input(name, ref_tree))
    return out


def _assert_same_structure(ref_tree, port_tree):
    """Leaf for leaf the same paths, shapes and dtypes (not values)."""
    want = [(str(p), np.asarray(l).shape, np.asarray(l).dtype.name)
            for p, l in zip(r_treepath.leaf_paths(ref_tree),
                            jax.tree_util.tree_leaves(ref_tree))]
    got = [(str(p), l.shape, l.dtype.name)
           for p, l in zip(p_treepath.leaf_paths(port_tree),
                           jax.tree_util.tree_leaves(
                               to_reference_tree(port_tree)))]
    assert got == want


# -- registry and trees ------------------------------------------------------

@pytest.mark.parametrize("size", ["smoke", "quick", "full"])
def test_registry_names_and_closed_forms_match(size):
    ref = RS.iter_scenarios(size, only=FAMILIES)
    port = PS.iter_scenarios(size)
    assert [s.name for s in port] == [s.name for s in ref]
    for r, p in zip(ref, port):
        assert p.used_paths == r.used_paths and p.uvm_access == r.uvm_access
        assert dict(p.params) == dict(r.params)
        if r.expected:
            assert {k: v.as_tuple() for k, v in p.expected.items()} == \
                {k: v.as_tuple() for k, v in r.expected.items()}
        if r.steady_expected:
            assert p.steady_expected.as_tuple() == r.steady_expected.as_tuple()
        assert p.declared_policy == r.declared_policy
        for field in ("region_expected", "steady_region_expected"):
            want, got = getattr(r, field), getattr(p, field)
            assert (got is None) == (want is None), (r.name, field)
            if want is not None:
                assert {k: v.as_tuple() for k, v in got.items()} == \
                    {k: v.as_tuple() for k, v in want.items()}
                assert all(v.per_device_tuple() is None
                           for v in want.values())


@pytest.mark.parametrize("name", _NAMES)
def test_port_trees_equal_reference_trees_bit_for_bit(name, trees):
    ref_tree, _ = trees[name]
    own = _PORT[name].build()
    if _REF[name].family == "model_state":
        # the reference draws these values with jax.random; the motion
        # depends on paths, shapes and dtypes only
        _assert_same_structure(ref_tree, own)
    else:
        _assert_bit_equal(ref_tree, own)
    # and carrying the reference's tree across gives the same host tree
    _assert_bit_equal(ref_tree, from_reference_tree(ref_tree))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b"])
def test_model_state_values_are_the_ports_own(arch):
    """model_state builds the port's smoke params from a generator seeded
    with 0, leaf for leaf."""
    from repro_torch.models import registry

    sc = next(s for s in _PORT.values()
              if s.family == "model_state" and s.params["arch"] == arch)
    want = registry.get(arch, smoke=True).init(
        torch.Generator().manual_seed(0), device="cpu")
    got = sc.build()
    assert got is sc.build()                      # cached per process
    assert [str(p) for p in p_treepath.leaf_paths(got)] == \
        [str(p) for p in p_treepath.leaf_paths(want)]
    for a, b in zip(p_treepath.tree_leaves(got),
                    p_treepath.tree_leaves(want)):
        assert a.device.type == "cpu" and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_bf16_from_f32_is_the_reference_cast():
    """A port bf16 leaf is f64 -> f32 -> bf16 (torch); the reference casts
    f64 -> bf16 with ml_dtypes.  Both round the f64 to f32 first, so they
    agree bit for bit, ties and subnormals included."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(200_000),
                        rng.standard_normal(1000) * 1e-39,
                        np.float32([1 + 2 ** -8, 1 + 3 * 2 ** -8, -2.5, 0.0,
                                    np.inf, -np.inf]).astype(np.float64)])
    want = x.astype("bfloat16").view(np.uint16)
    got = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                  want)


def test_convert_roundtrip_keeps_containers_and_scalars():
    tree = {"b": [np.float32([1, 2]), (np.int32(3), None)],
            "a": np.arange(4, dtype=np.int32).astype("bfloat16")}
    port = from_reference_tree(tree)
    assert list(port) == ["a", "b"] and isinstance(port["b"][1], tuple)
    assert port["b"][1][0].shape == () and port["b"][1][1] is None
    assert port["a"].dtype == torch.bfloat16
    back = to_reference_tree(port)
    assert back["a"].dtype.name == "bfloat16"
    _assert_bit_equal(tree, port)


# -- treepath ----------------------------------------------------------------

def test_flatten_order_is_jax_order():
    tree = {"b": 1, "a": 2, "c": [3, (4, None, {"z": 5, "y": 6})], "n": None}
    assert p_treepath.tree_leaves(tree) == jax.tree_util.tree_leaves(tree)
    assert [str(p) for p in p_treepath.leaf_paths(tree)] == \
        [str(p) for p in r_treepath.leaf_paths(tree)]
    leaves, treedef = p_treepath.tree_flatten(tree)
    assert treedef.unflatten(leaves) == tree
    assert treedef == p_treepath.tree_structure(dict(tree))
    assert hash(treedef) == hash(p_treepath.tree_structure(tree))


def test_root_leaf_path_is_the_reference_empty_path():
    """A bare leaf's path is TreePath(()) with string "" — which
    TreePath.parse rejects — exactly as the reference does today."""
    for mod, leaf in ((p_treepath, torch.zeros(1)), (r_treepath, np.zeros(1))):
        (path,) = mod.leaf_paths(leaf)
        assert path == mod.TreePath(()) and str(path) == ""
        with pytest.raises(ValueError, match="empty tree path"):
            mod.TreePath.parse(str(path))


@pytest.mark.parametrize("name", _SMOKE)
def test_leaf_paths_and_depth_match(name, trees):
    ref_tree, port_tree = trees[name]
    assert [str(p) for p in p_treepath.leaf_paths(port_tree)] == \
        [str(p) for p in r_treepath.leaf_paths(ref_tree)]
    assert p_treepath.max_chain_depth(port_tree) == \
        r_treepath.max_chain_depth(ref_tree)


def test_treepath_set_resolve_exists():
    tree = {"a": [{"b": torch.ones(2)}, (torch.zeros(1),)]}
    tp = p_treepath.TreePath.parse("a[0].b")
    assert torch.equal(tp.resolve(tree), torch.ones(2))
    new = tp.set(tree, torch.full((2,), 3.0))
    assert torch.equal(new["a"][0]["b"], torch.full((2,), 3.0))
    assert torch.equal(tree["a"][0]["b"], torch.ones(2))    # input untouched
    assert isinstance(p_treepath.TreePath.parse("a[1][0]").set(tree, 1)["a"][1],
                      tuple)
    assert not p_treepath.TreePath.parse("a[2]").exists(tree)
    assert str(p_treepath.TreePath.parse("a[0].b")) == "a[0].b"


# -- chainref ----------------------------------------------------------------

@pytest.mark.parametrize("name", _SMOKE)
def test_declare_extract_insert_match(name, trees):
    ref_tree, port_tree = trees[name]
    sc = _REF[name]
    paths = list(sc.used_paths) + list(sc.uvm_access or ())
    # interior chains expand to every leaf below them
    paths.append(str(r_treepath.leaf_paths(ref_tree)[0].steps[0]))
    r_refs = r_chainref.declare(ref_tree, *paths)
    p_refs = p_chainref.declare(port_tree, *paths)
    assert [(str(r.path), r.flat_index) for r in p_refs] == \
        [(str(r.path), r.flat_index) for r in r_refs]
    got = p_chainref.extract(port_tree, p_refs)
    want = r_chainref.extract(ref_tree, r_refs)
    for g, w in zip(got, want):
        _assert_bit_equal(np.asarray(w), g)
    marked = p_chainref.insert(port_tree, p_refs, list(range(len(p_refs))))
    last = {r.flat_index: i for i, r in enumerate(p_refs)}
    leaves = p_treepath.tree_leaves(marked)
    assert all(leaves[idx] == i for idx, i in last.items())


def test_declare_unknown_chain_raises():
    with pytest.raises(KeyError, match="does not resolve"):
        p_chainref.declare({"a": torch.ones(1)}, "b.c")


def test_region_writes_back_through_chains():
    tree = {"x": {"a": torch.ones(3), "b": torch.zeros(2)}}
    refs = p_chainref.declare(tree, "x.a")
    with p_chainref.region(tree, refs) as r:
        r[0] = r[0] * 2
    assert torch.equal(r.result["x"]["a"], torch.full((3,), 2.0))
    assert torch.equal(r.result["x"]["b"], torch.zeros(2))
    assert str(refs[0]) == "x.a@0"


# -- spec --------------------------------------------------------------------

def _combos(kind):
    return itertools.product((kind,), (False, True),
                             (None, "blocking", "double_buffered"),
                             (None, 1, 2, 8), (1, 64), (None, 0, 3))


@pytest.mark.parametrize("kind", ["marshal", "pointerchain", "uvm"])
def test_spec_matrix_matches_reference(kind):
    """The capability matrix and canonical strings, point for point over
    the grammar-expressible matrix of tests/test_spec.py."""
    valid = 0
    for k, delta, staging, sharding, align, device in _combos(kind):
        kw = dict(kind=k, delta=delta, staging=staging, sharding=sharding,
                  align_elems=align, device=device)
        try:
            want = str(r_spec.TransferSpec(**kw))
        except r_spec.UnsupportedSpecError:
            with pytest.raises(p_spec.UnsupportedSpecError):
                p_spec.TransferSpec(**kw)
            continue
        got = p_spec.TransferSpec(**kw)
        assert str(got) == want
        assert p_spec.TransferSpec.parse(want) == got
        assert got.name == r_spec.TransferSpec.parse(want).name
        valid += 1
    assert valid > 0


@pytest.mark.parametrize("text", [
    "", "bogus", "marshal+nope", "marshal@qq8", "marshal@dp", "marshal@dp8@dp4",
    "uvm+delta", "marshal+delta+blocking", "marshal@dev0@dev1",
    "marshal+db+blocking", "marshal+blocking+db", "marshal+align4+align8",
    "marshal+delta+delta", "marshal_delta", "marshal+delta@dp8",
    "marshal+align64+db@dev3", "pointerchain@dp2",
])
def test_spec_parse_matches_reference(text):
    try:
        want = str(r_spec.TransferSpec.parse(text))
    except r_spec.UnsupportedSpecError:
        with pytest.raises(p_spec.UnsupportedSpecError):
            p_spec.TransferSpec.parse(text)
        return
    assert str(p_spec.TransferSpec.parse(text)) == want


# -- arena -------------------------------------------------------------------

@pytest.mark.parametrize("align", [1, 64])
@pytest.mark.parametrize("name", _SMOKE)
def test_plan_equals_reference_layout(name, align, trees):
    ref_tree, port_tree = trees[name]
    want = r_arena.plan(ref_tree, align)
    got = p_arena.plan(port_tree, align)
    assert [(s.bucket, s.offset, s.size, s.shape) for s in got.slots] == \
        [(s.bucket, s.offset, s.size, s.shape) for s in want.slots]
    assert list(got.bucket_sizes.items()) == list(want.bucket_sizes.items())
    assert got.bucket_bytes() == want.bucket_bytes()
    assert got.align_elems == want.align_elems
    assert got.shard_multiple == want.shard_multiple == 1
    assert got.total_bytes() == want.total_bytes()
    assert got.payload_bytes() == want.payload_bytes()
    assert got.treedef.num_leaves == want.treedef.num_leaves


@pytest.mark.parametrize("name", _SMOKE)
def test_pack_unpack_equal_reference_buffers(name, trees):
    ref_tree, port_tree = trees[name]
    want, _ = r_arena.pack(ref_tree, use_numpy=True)
    got, layout = p_arena.pack(port_tree)
    assert list(got) == list(want)
    for b in want:
        _assert_bit_equal(want[b], got[b])
    _assert_bit_equal(ref_tree, p_arena.unpack(got, layout))


def test_datasize_model_matches_reference():
    for args in ((6, 1000, True), (6, 1000, False), (3, 7, True)):
        assert p_arena.datasize_linear(*args) == r_arena.datasize_linear(*args)
    for args in ((4, 1000, 3), (8, 1000, 3), (2, 5, 0)):
        assert p_arena.datasize_dense(*args) == r_arena.datasize_dense(*args)


def test_session_counts_no_pinned_staging_for_a_cpu_target():
    """``pinned_bytes`` counts page-locked staging only; a CPU target's
    entries stage in pageable memory."""
    from repro_torch.core import TransferSession

    session = TransferSession()
    tree = {"a": torch.ones(300), "b": torch.zeros(7, dtype=torch.int32)}
    program = session.compile(tree, "**=marshal", device="cpu")
    program.to_device(tree)
    assert session.cache_stats()["entry_size"] == 1
    assert session.pinned_bytes() == 0
