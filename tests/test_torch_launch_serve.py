"""The serve CLI and the small API gaps, against the reference, on the CPU.

* The reference saves a smoke llama3.2-1b train state with
  ``repro.checkpoint``; ``repro.launch.serve`` and
  ``repro_torch.launch.serve`` (``--device cpu``) then serve it from that
  ``--ckpt-dir``: the same served / completed / shed counts printed, the
  same tokens for every request, the served params equal to the saved
  ones bit for bit.  Without ``--device`` and without a card the port's
  CLI raises ``NoCudaDeviceError``.
* The module-level engine helpers (``get_entry``, ``set_cache_limits``,
  ``cache_stats``) mirror the reference's on the default session; the new
  ``repro_torch.core`` exports exist; ``abstract_train_state`` gives the
  reference's paths, shapes and dtypes.
"""
from __future__ import annotations

import re

import jax
import ml_dtypes  # noqa: F401  (registers numpy's bfloat16 for the reference)
import numpy as np
import pytest
import torch

import repro.core as r_core
from repro import checkpoint as r_ckpt
from repro.launch import serve as r_serve
from repro.models import registry as r_registry
from repro.optim import make_optimizer as r_make
from repro.runtime import train as r_train

import repro_torch.core as p_core
from repro_torch import NoCudaDeviceError
from repro_torch.core import leaf_items
from repro_torch.launch import serve as p_serve
from repro_torch.models import registry as p_registry
from repro_torch.optim import make_optimizer
from repro_torch.runtime import abstract_train_state

ARGS = ["--arch", "llama3.2-1b", "--smoke", "--requests", "6", "--slots",
        "3", "--max-seq", "64", "--max-new", "5"]


def _counts(out: str):
    served = re.search(r"served (\d+)/(\d+) requests, (\d+) tokens", out)
    stats = re.search(r"completed (\d+) shed (\d+) timed-out (\d+) "
                      r"failed (\d+) retries (\d+)", out)
    return served.groups(), stats.groups()


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    api = r_registry.get("llama3.2-1b", smoke=True)
    state = r_train.train_state(api, r_make("adamw"), jax.random.PRNGKey(7))
    d = tmp_path_factory.mktemp("serve_ckpt")
    r_ckpt.save(state, str(d), 3)
    return str(d), jax.device_get(state["params"])


def test_both_clis_serve_the_reference_checkpoint_alike(ckpt_dir, capsys,
                                                       monkeypatch):
    d, saved = ckpt_dir
    finished = []

    class Recording(r_serve.Server):
        def run(self, *a, **kw):
            finished.extend(super().run(*a, **kw))
            return finished

    monkeypatch.setattr(r_serve, "Server", Recording)
    r_serve.main(ARGS + ["--ckpt-dir", d])
    r_out = capsys.readouterr().out
    server, done = p_serve.main(ARGS + ["--ckpt-dir", d, "--device", "cpu"])
    p_out = capsys.readouterr().out

    assert _counts(p_out) == _counts(r_out), (p_out, r_out)
    restored = re.search(r"restored (\d+) param chains", r_out).group(0)
    assert restored in p_out
    (n_done, n_req, _), (completed, shed, *_rest) = _counts(p_out)
    assert n_done == n_req == completed == "6" and shed == "0"
    want = {r.rid: list(map(int, r.tokens_out)) for r in finished}
    got = {r.rid: list(map(int, r.tokens_out)) for r in done}
    assert got == want and all(len(t) == 5 for t in got.values())
    # the served params are the saved ones, bit for bit
    ref = dict(jax.tree_util.tree_flatten_with_path(saved)[0])
    served = leaf_items(server.params)
    assert len(served) == len(ref)
    for (path, leaf), want_leaf in zip(served, jax.tree_util.tree_leaves(
            saved)):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want_leaf),
                                      err_msg=str(path))


def test_cli_params_without_ckpt_come_from_seed_zero(capsys):
    server, done = p_serve.main(ARGS + ["--device", "cpu", "--requests",
                                        "2"])
    api = p_registry.get("llama3.2-1b", smoke=True)
    want = api.init(torch.Generator().manual_seed(0), device="cpu")
    for a, b in zip(p_core.tree_leaves(server.params),
                    p_core.tree_leaves(want)):
        assert torch.equal(a, b)
    assert [len(r.tokens_out) for r in done] == [5, 5]
    assert "served 2/2 requests" in capsys.readouterr().out


def test_cli_needs_a_card_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(NoCudaDeviceError):
        p_serve.main(ARGS)


# ------------------------------------------------------------ API gaps

def test_core_exports_the_reference_names():
    for name in ("pack_traced", "unpack_traced", "repack_traced",
                 "repack_into", "PAPER_SPECS", "SCHEMES", "get_entry",
                 "set_cache_limits", "cache_stats"):
        assert name in p_core.__all__ and hasattr(p_core, name), name
    assert [str(s) for s in p_core.PAPER_SPECS] == [
        str(s) for s in r_core.PAPER_SPECS]
    assert sorted(p_core.SCHEMES) == sorted(r_core.SCHEMES)
    for name, factory in p_core.SCHEMES.items():
        scheme = factory(device="cpu")
        assert str(scheme.spec) == str(r_core.SCHEMES[name]().spec), name


def test_engine_helpers_mirror_the_reference_on_the_default_session():
    tree = {"a": np.arange(6, dtype=np.float32),
            "b": np.ones((2, 3), np.int32)}
    sessions = (r_core.get_session(), p_core.get_session())
    saved = [(s.layout_max, s.entry_max) for s in sessions]
    try:
        r_core.clear_cache()
        p_core.clear_cache()
        r_entry = r_core.get_entry(tree)
        p_entry = p_core.get_entry(tree)
        assert r_core.get_entry(tree) is r_entry
        assert p_core.get_entry(tree) is p_entry
        assert r_core.get_session().get_entry(tree) is r_entry
        assert p_core.get_session().get_entry(tree) is p_entry
        assert p_entry.layout.bucket_sizes == r_entry.layout.bucket_sizes
        keys = ("hits", "misses", "layout_size", "entry_size",
                "layout_evictions", "entry_evictions")
        r_stats, p_stats = r_core.cache_stats(), p_core.cache_stats()
        assert {k: p_stats[k] for k in keys} == {k: r_stats[k] for k in keys}
        other = {"c": np.zeros(4, np.float32)}
        r_core.get_entry(other)
        p_core.get_entry(other)
        r_core.set_cache_limits(entry_max=1)
        p_core.set_cache_limits(entry_max=1)
        r_stats, p_stats = r_core.cache_stats(), p_core.cache_stats()
        assert {k: p_stats[k] for k in keys} == {k: r_stats[k] for k in keys}
        assert p_stats["entry_size"] == 1 and p_stats["entry_evictions"] == 1
    finally:
        for s, (lm, em) in zip(sessions, saved):
            s.set_cache_limits(lm, em)
            s.clear()


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b"])
def test_abstract_train_state_equals_the_reference(arch):
    r_abs = r_train.abstract_train_state(r_registry.get(arch, smoke=True),
                                         r_make("adamw"))
    p_abs = abstract_train_state(p_registry.get(arch, smoke=True),
                                 make_optimizer("adamw"))
    r_items = jax.tree_util.tree_flatten_with_path(r_abs)[0]
    p_items = leaf_items(p_abs)
    assert len(p_items) == len(r_items)
    for (p_path, p_leaf), (r_path, r_leaf) in zip(p_items, r_items):
        assert str(p_path) == jax.tree_util.keystr(r_path).replace(
            "['", ".").replace("']", "").lstrip("."), (p_path, r_path)
        assert tuple(p_leaf.shape) == tuple(r_leaf.shape), p_path
        assert str(p_leaf.dtype).replace("torch.", "") == str(
            np.dtype(r_leaf.dtype)), p_path
    assert p_abs["step"].shape == () and p_abs["step"].dtype == torch.int32
