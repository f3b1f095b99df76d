"""The port's placements on a named mesh, held to the JAX package's
``NamedSharding``s.

One child process with ``XLA_FLAGS=--xla_force_host_platform_device_count=
512`` (set in the child only) gives every oracle value that needs
devices: on the production meshes, (16, 16) and (2, 16, 16), for every
arch at full size, each leaf's spec and ``shard_shape`` under
``tree_shardings`` of the train state (train rules) and of the params and
caches of every runnable serve shape (its rules, the batch rule adapted);
the shards that ``addressable_shards`` gives each device of a (2, 4) mesh
after the reference's reshard test (``tests/test_distributed.py``: an
8 x 8 leaf saved 8-way and restored with ``P("model", "data")``), and of a
(2, 2, 2) mesh under a tuple entry ``P(("pod", "data"), "model")``; and
the message of the reference's restore onto a mismatched tree.

Checked, exactly (these are shapes, names and bit patterns):

  * every arch's ``axes`` / ``input_axes`` / ``cache_axes`` /
    ``train_state_axes`` and abstract trees (paths, shapes, dtypes) equal
    the reference's (in this process: they need no devices);
  * every leaf's spec and ``shard_shape`` equal the reference's, on both
    production meshes (arctic's 56 heads and granite's 49155-row vocab
    demoted to replicated, the tied embedding a true 2-D block);
  * ``_demote_spec`` and ``adapt_batch_rule`` on ``test_launch.py``'s
    cases;
  * each position's block after the reshard equals the shard of the
    device at the same mesh coordinates, bit for bit;
  * the mismatched restore raises the reference's message, naming
    ``opt.mu``;
  * ``constrain`` checks rank under a context only; the production mesh's
    shape, names, positions and its stale-mesh error without the cards.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.shapes import SHAPES as R_SHAPES
from repro.configs.shapes import skip_reason as r_skip
from repro.launch import mesh as r_mesh
from repro.models import registry as r_registry
from repro.optim import make_optimizer as r_make_optimizer
from repro.runtime import train as r_train

from repro_torch import checkpoint as p_ckpt
from repro_torch.configs.shapes import SHAPES
from repro_torch.core import UnsupportedSpecError
from repro_torch.core.placement import (Placement, block_of, gather_blocks,
                                        place, position_bytes)
from repro_torch.core.treepath import leaf_items, tree_leaves
from repro_torch.launch import mesh as p_mesh
from repro_torch.models import pspec as p_pspec
from repro_torch.models import registry as p_registry
from repro_torch.optim import make_optimizer
from repro_torch.runtime import train as p_train

ROOT = Path(__file__).resolve().parent.parent
ARCHS = p_registry.ARCH_IDS
MESH_NAMES = ("single", "multi")
SERVE_SHAPES = ("prefill_32k", "decode_32k", "long_500k")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module runs: the suite runs in
    several processes on one host, and more threads than cores spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(2, n))
    yield
    torch.set_num_threads(n)

_CHILD = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import checkpoint as ckpt
from repro.configs.shapes import SHAPES, skip_reason
from repro.launch.mesh import (adapt_batch_rule, make_production_mesh,
                               rules_for, tree_shardings)
from repro.models import registry
from repro.optim import make_optimizer
from repro.runtime.train import abstract_train_state, train_state_axes

def entry(e):
    return list(e) if isinstance(e, tuple) else e

def dump(shs, abs_tree):
    out = []
    for sh, a in zip(jax.tree_util.tree_leaves(shs),
                     jax.tree_util.tree_leaves(abs_tree)):
        spec = [entry(e) for e in sh.spec]
        spec += [None] * (len(a.shape) - len(spec))
        out.append([spec, list(sh.shard_shape(a.shape))])
    return out

out = {"trees": {}}
for mname in ("single", "multi"):
    mesh = make_production_mesh(multi_pod=mname == "multi")
    for arch in registry.ARCH_IDS:
        api = registry.get(arch)
        cfg = api.cfg
        opt = make_optimizer(cfg.optimizer)
        rules = rules_for(cfg, mesh, "train")
        st = abstract_train_state(api, opt)
        out["trees"]["%s|%s|train" % (arch, mname)] = dump(
            tree_shardings(mesh, train_state_axes(api, opt), rules, st), st)
        for sname in SERVE_SHAPES:
            if skip_reason(cfg, sname):
                continue
            shape = SHAPES[sname]
            rules = adapt_batch_rule(rules_for(cfg, mesh, shape.mode), mesh,
                                     shape.global_batch)
            p = api.abstract()
            out["trees"]["%s|%s|%s|params" % (arch, mname, sname)] = dump(
                tree_shardings(mesh, api.axes(), rules, p), p)
            c = api.abstract_cache(shape)
            out["trees"]["%s|%s|%s|cache" % (arch, mname, sname)] = dump(
                tree_shardings(mesh, api.cache_axes(shape), rules, c), c)

# the reshard of tests/test_distributed.py, every device's shard
w = np.arange(64, dtype=np.float32).reshape(8, 8)
mesh_a = jax.make_mesh((8,), ("data",))
ckpt.save({"w": jax.device_put(w, NamedSharding(mesh_a, P("data")))},
          sys.argv[2], 1)
mesh_b = jax.make_mesh((2, 4), ("data", "model"))
sh_b = NamedSharding(mesh_b, P("model", "data"))
got = ckpt.restore(sys.argv[2], 1, shardings={"w": sh_b})["w"]
by_dev = {s.device.id: np.asarray(s.data) for s in got.addressable_shards}
out["reshard"] = [by_dev[d.id].tolist() for d in mesh_b.devices.flat]
mesh_c = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
x = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
arr = jax.device_put(x, NamedSharding(mesh_c, P(("pod", "data"), "model")))
by_dev = {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}
out["tuple"] = [by_dev[d.id].tolist() for d in mesh_c.devices.flat]

# the restore onto a mismatched tree
state = {"opt": {"mu": w, "nu": w}, "params": w}
ckpt.save(state, sys.argv[2], 2)
rep = NamedSharding(mesh_b, P())
try:
    ckpt.restore(sys.argv[2], 2, shardings={"opt": {"mv": rep, "nu": rep},
                                            "params": rep})
except ValueError as e:
    out["mismatch"] = str(e)
json.dump(out, open(sys.argv[1], "w"))
print("ok")
'''


@functools.lru_cache(maxsize=None)
def reference_placements(path: str, ckpt_dir: str) -> dict:
    """The reference's oracle values on a forced 512-device host, run once
    per process."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c",
         _CHILD.replace("SERVE_SHAPES", repr(SERVE_SHAPES)), path,
         ckpt_dir], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("placement_reference")
    return reference_placements(str(d / "ref.json"), str(d / "ckpt"))


def _spec(pl: Placement, ndim: int):
    spec = [list(e) if isinstance(e, tuple) else e for e in pl.spec]
    return spec + [None] * (ndim - len(spec))


def _dump(shardings, abstract):
    return [[_spec(pl, len(a.shape)), list(pl.shard_shape(a.shape))]
            for pl, a in zip(tree_leaves(shardings), tree_leaves(abstract))]


@functools.lru_cache(maxsize=None)
def _meta_mesh(name):
    return p_mesh.make_production_mesh(multi_pod=name == "multi",
                                       device="meta")


def _ref_items(tree, is_leaf=None):
    import jax
    return [(jax.tree_util.keystr(k), v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]]


def _axes_items(tree):
    leaves, treedef = p_mesh.axes_flatten(tree)
    wrapped = treedef.unflatten([i for i in range(len(leaves))])
    return [(str(p), leaves[i]) for p, i in leaf_items(wrapped)]


def _same_axes(port_tree, ref_tree):
    is_axes = lambda x: isinstance(x, tuple)
    want = [tuple(v) for _, v in _ref_items(ref_tree, is_axes)]
    assert [a for _, a in _axes_items(port_tree)] == want


def _same_abstract(port_tree, ref_tree):
    want = [(tuple(v.shape), str(v.dtype)) for _, v in _ref_items(ref_tree)]
    got = [(tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for v in tree_leaves(port_tree)]
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_and_abstract_trees_equal_the_references(arch):
    p_api, r_api = p_registry.get(arch), r_registry.get(arch)
    cfg = p_api.cfg
    _same_axes(p_api.axes(), r_api.axes())
    _same_abstract(p_api.abstract(), r_api.abstract())
    p_opt, r_opt = make_optimizer(cfg.optimizer), \
        r_make_optimizer(cfg.optimizer)
    _same_axes(p_train.train_state_axes(p_api, p_opt),
               r_train.train_state_axes(r_api, r_opt))
    _same_abstract(p_train.abstract_train_state(p_api, p_opt),
                   r_train.abstract_train_state(r_api, r_opt))
    for name in SHAPES:
        if r_skip(r_api.cfg, name):
            continue
        shape, r_shape = SHAPES[name], R_SHAPES[name]
        assert p_api.input_axes(shape) == r_api.input_axes(r_shape)
        _same_abstract(p_api.input_specs(shape), r_api.input_specs(r_shape))
        assert p_api.cache_axes(shape) == r_api.cache_axes(r_shape)
        _same_abstract(p_api.abstract_cache(shape),
                       r_api.abstract_cache(r_shape))


@pytest.mark.parametrize("mname", MESH_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_tree_shardings_equal_the_references(ref, arch, mname):
    mesh = _meta_mesh(mname)
    api = p_registry.get(arch)
    cfg = api.cfg
    opt = make_optimizer(cfg.optimizer)
    st = p_train.abstract_train_state(api, opt)
    got = _dump(p_mesh.tree_shardings(
        mesh, p_train.train_state_axes(api, opt),
        p_mesh.rules_for(cfg, mesh, "train"), st), st)
    assert got == ref["trees"][f"{arch}|{mname}|train"]
    for sname in SERVE_SHAPES:
        key = f"{arch}|{mname}|{sname}"
        if f"{key}|params" not in ref["trees"]:
            continue
        shape = SHAPES[sname]
        rules = p_mesh.adapt_batch_rule(
            p_mesh.rules_for(cfg, mesh, shape.mode), mesh, shape.global_batch)
        p = api.abstract()
        assert _dump(p_mesh.tree_shardings(mesh, api.axes(), rules, p),
                     p) == ref["trees"][f"{key}|params"]
        c = api.abstract_cache(shape)
        assert _dump(p_mesh.tree_shardings(mesh, api.cache_axes(shape),
                                           rules, c),
                     c) == ref["trees"][f"{key}|cache"]


def test_non_dividing_leaves_replicate_and_the_tied_embedding_is_2d():
    single = _meta_mesh("single")
    for arch, path, want in (
            ("arctic-480b", "params.blocks.attn.wq", (None, "data", None,
                                                      None)),
            ("granite-3-8b", "params.embed.tok", (None, "data")),
            ("llama3.2-1b", "params.embed.tok", ("model", "data"))):
        api = p_registry.get(arch)
        opt = make_optimizer(api.cfg.optimizer)
        sh = p_mesh.tree_shardings(
            single, p_train.train_state_axes(api, opt),
            p_mesh.rules_for(api.cfg, single, "train"),
            p_train.abstract_train_state(api, opt))
        got = dict((str(k), v) for k, v in leaf_items(sh))[path]
        assert got.spec == want, (arch, got)


def test_demote_spec_and_adapt_batch_rule_cases():
    single, multi = _meta_mesh("single"), _meta_mesh("multi")
    for spec, shape, mesh in (((None, "model", None), (35, 56, 7168), single),
                              (("data", "model"), (64, 32), single),
                              ((("pod", "data"), None), (2, 10), multi),
                              ((("pod", "data"), "model"), (64, 48), multi)):
        want = tuple(r_mesh._demote_spec(P(*spec), shape, mesh))
        assert p_mesh._demote_spec(spec, shape, mesh) == want
    assert p_mesh._demote_spec((None, "model", None), (35, 56, 7168),
                               single) == (None, None, None)
    assert p_mesh._demote_spec((("pod", "data"), None), (2, 10),
                               multi) == ("pod", None)
    rules = dict(p_mesh.default_rules(single))
    assert p_mesh.adapt_batch_rule(rules, single, 1)["batch"] is None
    assert p_mesh.adapt_batch_rule(rules, single, 256)["batch"] == ("data",)
    for b in (1, 2, 32, 256):
        r = dict(p_mesh.default_rules(multi))
        assert p_mesh.adapt_batch_rule(r, multi, b) == \
            r_mesh.adapt_batch_rule(r, multi, b)
    with pytest.raises(ValueError, match="does not match"):
        p_mesh.tree_shardings(single, {"a": ("embed",), "b": ("mlp",)},
                              rules, {"a": torch.ones(4)})


def test_reshard_restore_blocks_equal_addressable_shards(ref, tmp_path):
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    mesh_a = p_mesh.NamedMesh((torch.device("cpu"),) * 8, (8,), ("data",))
    placed = place(w, Placement(mesh_a, ("data",)))
    p_ckpt.save({"w": placed}, str(tmp_path), 1)
    mesh_b = p_mesh.make_debug_mesh(2, 4, device="cpu")
    sh_b = Placement(mesh_b, ("model", "data"))
    out = p_ckpt.restore(str(tmp_path), 1, shardings={"w": sh_b})["w"]
    assert out.placement == sh_b
    assert torch.equal(out.gather(), w)
    for p, want in enumerate(ref["reshard"]):
        assert torch.equal(out.blocks[p], torch.tensor(want)), p
    # a tuple entry: its first axis major, as the reference's blocks
    mesh_c = p_mesh.make_debug_mesh(2, 2, pod=2, device="cpu")
    x = torch.arange(48, dtype=torch.float32).reshape(8, 6)
    xc = place(x, Placement(mesh_c, (("pod", "data"), "model")))
    for p, want in enumerate(ref["tuple"]):
        assert torch.equal(xc.blocks[p], torch.tensor(want)), p
    # each position's whole value, and its block cut back out, by the
    # collectives
    whole = gather_blocks(xc)
    for p in range(mesh_c.size):
        assert torch.equal(whole[p], x)
        assert torch.equal(block_of(whole[p], xc.placement, p), xc.blocks[p])
    rows = gather_blocks(xc, keep=("pod", "data"))
    assert rows[3].shape == (2, 6)
    assert position_bytes([((8, 6), torch.float32, xc.placement)]) == \
        xc.blocks[0].numel() * 4 == 2 * 3 * 4


def test_restore_onto_a_mismatched_tree_names_the_path(ref, tmp_path):
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    p_ckpt.save({"opt": {"mu": w, "nu": w}, "params": w}, str(tmp_path), 2)
    mesh = p_mesh.make_debug_mesh(2, 4, device="cpu")
    rep = p_mesh.replicated(mesh)
    with pytest.raises(ValueError) as e:
        p_ckpt.restore(str(tmp_path), 2, shardings={
            "opt": {"mv": rep, "nu": rep}, "params": rep})
    assert str(e.value) == ref["mismatch"]
    assert "opt.mu" in str(e.value)
    # device= keeps its meaning without shardings
    host = p_ckpt.restore(str(tmp_path), 2, device="cpu")
    assert torch.equal(host["params"], w)


def test_constrain_checks_rank_under_a_context_only():
    x = torch.ones(2, 3)
    assert p_pspec.constrain(x, "batch") is x
    mesh = p_mesh.make_debug_mesh(2, 2, device="cpu")
    with p_pspec.activate(mesh, p_mesh.default_rules(mesh)):
        assert p_pspec.constrain(x, "batch", None) is x
        with pytest.raises(ValueError, match="rank-2"):
            p_pspec.constrain(x, "batch")


def test_production_mesh_positions_and_stale_error(monkeypatch):
    single, multi = _meta_mesh("single"), _meta_mesh("multi")
    assert single.shape == {"data": 16, "model": 16}
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.positions[0].type == "meta" and multi.size == 512
    cpu = p_mesh.make_production_mesh(device="cpu")
    assert cpu.size == 256 and cpu.positions[255].type == "cpu"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    with pytest.raises(UnsupportedSpecError, match="dp256"):
        p_mesh.make_production_mesh()
    with pytest.raises(UnsupportedSpecError, match="dp512"):
        p_mesh.make_production_mesh(multi_pod=True)
    # "meta" only when passed: the default never resolves to it
    from repro_torch import resolve_device
    assert resolve_device("meta").type == "meta"
    np.testing.assert_equal(single.devices.shape, (16, 16))
