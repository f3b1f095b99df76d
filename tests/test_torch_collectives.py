"""The port's named mesh, its single-controller collectives and the
logical-axis rules, on CPU positions.

  * each collective against its plain single-device equivalent (a sum, a
    max, a mean, a slice of the sum, a concatenation, a transpose of
    tiles), bit for bit, over meshes (4, 1), (2, 2) and (2, 2, 1) with
    ``pod``, on one axis and on a tuple of axes; sums in position order,
    so a reduce-scatter + all-gather equals an all-reduce bit for bit in
    bf16 too;
  * ``all_to_all`` is its own inverse with the axes swapped, and its
    gradient (autograd through the plain ops) is the inverse all-to-all;
  * a piece that changes position is a copy, one that stays is not;
  * ``STATS`` counts one call a collective, one position's operand bytes;
  * ``launch/mesh.py``'s ``default_rules``, ``rules_for`` (train, prefill,
    decode for every registry config), ``adapt_batch_rule`` and
    ``pspec.logical_to_spec`` equal the reference's on the same meshes
    (the reference's rule functions read only the mesh's axis names and
    shape, so they take the port's mesh as it is);
  * ``pspec.activate`` nests and restores; ``constrain`` is the identity;
  * the mesh's position rules: ``"cpu"`` positions, a sequence as given,
    the stale-mesh error for too short a sequence.
"""
import itertools

import pytest
import torch

from repro.launch import mesh as r_mesh
from repro.models import pspec as r_pspec
from repro.models import registry as r_registry

from repro_torch.core import UnsupportedSpecError
from repro_torch.core import collectives as C
from repro_torch.launch import mesh as p_mesh
from repro_torch.models import pspec as p_pspec

CPU = torch.device("cpu")
MESHES = {"4x1": dict(data=4, model=1), "2x2": dict(data=2, model=2),
          "pod": dict(pod=2, data=2, model=1)}
AXES = {"4x1": ["data"], "2x2": ["data", "model", ("data", "model")],
        "pod": [("pod", "data"), "data"]}
CASES = [(m, a) for m in MESHES for a in AXES[m]]


def _mesh(name):
    return p_mesh.make_debug_mesh(**MESHES[name], device="cpu")


def _xs(mesh, shape=(8, 6), dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype)
            for _ in range(mesh.size)]


@pytest.mark.parametrize("name,axes", CASES)
def test_reductions_equal_their_plain_versions(name, axes):
    mesh = _mesh(name)
    xs = _xs(mesh)
    outs = {"psum": C.psum(xs, mesh, axes), "pmax": C.pmax(xs, mesh, axes),
            "pmean": C.pmean(xs, mesh, axes)}
    for g in mesh.groups(axes):
        stack = torch.stack([xs[p] for p in g])
        total = xs[g[0]]
        for p in g[1:]:
            total = total + xs[p]            # position order
        for p in g:
            assert torch.equal(outs["psum"][p], total)
            assert torch.equal(outs["pmax"][p], stack.amax(0))
            assert torch.equal(outs["pmean"][p], total / len(g))


@pytest.mark.parametrize("name,axes", CASES)
def test_scatter_gather_and_all_to_all_equal_their_plain_versions(name,
                                                                  axes):
    mesh = _mesh(name)
    xs = _xs(mesh)
    parts = C.psum_scatter(xs, mesh, axes)
    gathered = C.all_gather(parts, mesh, axes)
    summed = C.psum(xs, mesh, axes)
    a2a = C.all_to_all(xs, mesh, axes, split_axis=0, concat_axis=1)
    back = C.all_to_all(a2a, mesh, axes, split_axis=1, concat_axis=0)
    for g in mesh.groups(axes):
        n = len(g)
        for i, p in enumerate(g):
            assert torch.equal(parts[p], summed[p].chunk(n)[i])
            assert torch.equal(gathered[p], summed[p])
            assert torch.equal(a2a[p], torch.cat(
                [xs[q].chunk(n, 0)[i] for q in g], dim=1))
            assert torch.equal(back[p], xs[p])


def test_reduce_scatter_all_gather_is_an_all_reduce_in_bf16():
    mesh = _mesh("4x1")
    xs = _xs(mesh, shape=(1024,), dtype=torch.bfloat16, seed=3)
    rs_ag = C.all_gather(C.psum_scatter(xs, mesh, "data"), mesh, "data")
    for a, b in zip(rs_ag, C.psum(xs, mesh, "data")):
        assert torch.equal(a, b)


def test_all_to_all_gradient_is_the_inverse_all_to_all():
    mesh = _mesh("2x2")
    xs = [x.requires_grad_() for x in _xs(mesh, shape=(4, 6))]
    out = C.all_to_all(xs, mesh, "data", split_axis=0, concat_axis=1)
    cts = _xs(mesh, shape=(2, 12), seed=1)
    torch.autograd.backward(out, cts)
    want = C.all_to_all(cts, mesh, "data", split_axis=1, concat_axis=0)
    for x, w in zip(xs, want):
        assert torch.equal(x.grad, w)


def test_pieces_that_move_are_copies_and_stats_count_calls():
    mesh = _mesh("4x1")
    xs = _xs(mesh)
    C.STATS.reset()
    out = C.psum(xs, mesh, "data")
    assert out[1].data_ptr() != out[0].data_ptr()
    alone = C.psum(xs, mesh, "model")      # groups of one: nothing moves
    assert all(a is b for a, b in zip(alone, xs))
    assert C.STATS.snapshot() == {"psum": 2}
    assert C.STATS.bytes["psum"] == 2 * 8 * 6 * 4   # one operand a call
    with pytest.raises(ValueError, match="one tensor per mesh position"):
        C.psum(xs[:3], mesh, "data")
    with pytest.raises(ValueError, match="not one of"):
        C.psum(xs, mesh, "expert")
    with pytest.raises(ValueError, match="does not split"):
        C.psum_scatter(_xs(mesh, shape=(6, 2)), mesh, "data")


def test_mesh_groups_are_row_major_as_jax_lays_out_devices():
    mesh = _mesh("2x2")
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.devices.shape == (2, 2)
    assert mesh.groups("data") == [[0, 2], [1, 3]]
    assert mesh.groups("model") == [[0, 1], [2, 3]]
    assert mesh.groups(("data", "model")) == [[0, 1, 2, 3]]
    assert [mesh.index(p, "data") for p in range(4)] == [0, 0, 1, 1]
    pod = _mesh("pod")
    assert pod.groups(("pod", "data")) == [[0, 1, 2, 3]]
    assert pod.groups("data") == [[0, 1], [2, 3]]


def test_mesh_positions_follow_the_sharded_mesh_rules():
    assert _mesh("2x2").positions == (CPU,) * 4
    six = p_mesh.make_debug_mesh(2, 2, device=(CPU,) * 6)
    assert six.positions == (CPU,) * 4
    with pytest.raises(UnsupportedSpecError, match="stale"):
        p_mesh.make_debug_mesh(2, 2, device=(CPU,) * 3)
    with pytest.raises(ValueError, match="needs 4 positions"):
        C.NamedMesh((CPU,) * 3, (2, 2), ("data", "model"))


@pytest.mark.parametrize("name", list(MESHES))
def test_rules_equal_the_reference(name):
    mesh = _mesh(name)
    assert p_mesh.default_rules(mesh) == r_mesh.default_rules(mesh)
    for arch in r_registry.ARCH_IDS:
        cfg = r_registry.get(arch, smoke=True).cfg
        for mode in ("train", "prefill", "decode"):
            rules = p_mesh.rules_for(cfg, mesh, mode)
            assert rules == r_mesh.rules_for(cfg, mesh, mode), (arch, mode)
            for b in (1, 2, 3, 4, 8):
                assert p_mesh.adapt_batch_rule(rules, mesh, b) == \
                    r_mesh.adapt_batch_rule(rules, mesh, b)


@pytest.mark.parametrize("name", list(MESHES))
def test_logical_to_spec_equals_the_reference(name):
    rules = p_mesh.default_rules(_mesh(name))
    names = [None, "batch", "embed", "vocab", "heads", "mlp", "expert",
             "expert_mlp", "layers", "seq"]
    for axes in itertools.permutations(names, 3):
        assert p_pspec.logical_to_spec(axes, rules) == \
            tuple(r_pspec.logical_to_spec(axes, rules)), axes


def test_activate_nests_and_constrain_is_the_identity():
    m1, m2 = _mesh("4x1"), _mesh("2x2")
    assert p_pspec.active_rules() is None and p_pspec.active_mesh() is None
    with p_pspec.activate(m1, {"expert": ("data",)}):
        with p_pspec.activate(m2, {"expert": None}):
            assert p_pspec.active_mesh() is m2
            assert p_pspec.active_rules() == {"expert": None}
        assert p_pspec.active_mesh() is m1
        x = torch.ones(2)
        assert p_pspec.constrain(x, "batch") is x
    assert p_pspec.active_rules() is None
