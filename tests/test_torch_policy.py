"""Transfer policies and compiled programs of the port, held against the
JAX package.

  * ``str(parse(s))`` of the port equals the reference's over the pattern x
    spec matrix of tests/test_policy.py, and every invalid policy raises
    the one canonical error in both;
  * ``partition_tree`` gives the reference's regions (indices and paths);
  * a program's region ledgers equal the reference's on the serving state
    tree (params + KV cache + slot table), cold and on a steady repeat;
  * one synchronize per pass: every region enqueues without waiting and
    ``ProgramStats.syncs == 1`` with one enqueue per booked copy;
  * ``ProgramFuture.result(timeout)`` raises ``TransferTimeout`` on a hung
    barrier, stays retryable, then materializes.
"""
import itertools

import jax
import ml_dtypes  # noqa: F401  (registers numpy's bfloat16 for the reference)
import numpy as np
import pytest
import torch

from repro.core import PolicyRule as RPolicyRule
from repro.core import TransferPolicy as RTransferPolicy
from repro.core import TransferSession as RTransferSession
from repro.core import UnsupportedPolicyError as RUnsupportedPolicyError
from repro.core import UnsupportedSpecError as RUnsupportedSpecError
from repro.core import partition_tree as r_partition_tree
from repro.models import registry as r_registry
from repro.runtime import serve_transfer_policy as r_serve_policy

from repro_torch.convert import from_reference_tree
from repro_torch.core import (PolicyRule, TransferPolicy, TransferSession,
                              TransferTimeout, UnsupportedPolicyError,
                              UnsupportedSpecError, partition_tree,
                              to_host, transfer_scheme, tree_leaves)
from repro_torch.core import schemes as p_schemes
from repro_torch.runtime import serve_transfer_policy

CPU = "cpu"
_PATTERNS = ("**", "params/**", "opt/m", "opt/layers[3]/**", "a/*/c",
             "root/kids[0]/A", "*/w")
_SPECS = ("marshal", "marshal+delta", "marshal+align64", "marshal+db",
          "pointerchain", "uvm", "marshal+delta@dp8", "marshal@dev0",
          "pointerchain@dp4")
_LEDGER_FIELDS = ("h2d_bytes", "h2d_calls", "d2h_bytes", "d2h_calls",
                  "skipped_bytes", "delta_calls")


def _reference_matrix():
    """The reference's valid 1/2/3-rule policies over the pools, as
    strings (the matrix of tests/test_policy.py)."""
    out = []
    singles = [("**", s) for s in _SPECS]
    pairs = list(itertools.product(_PATTERNS[1:], _SPECS))
    for default in singles:
        out.append((default,))
        out.extend((a, default) for a in pairs)
    for a, b in itertools.combinations(pairs[::3], 2):
        if a[0] != b[0]:
            out.append((a, b, ("**", "marshal")))
    texts = []
    for rules in out:
        try:
            texts.append(str(RTransferPolicy(
                tuple(RPolicyRule(p, s) for p, s in rules))))
        except RUnsupportedPolicyError:
            pass
    return texts


_MATRIX = _reference_matrix()


def test_matrix_is_nontrivial():
    assert len(_MATRIX) > 60
    assert any(t.count(";") == 2 for t in _MATRIX)


@pytest.mark.parametrize("text", _MATRIX)
def test_policy_string_equals_the_reference(text):
    port = TransferPolicy.parse(text)
    assert str(port) == text == str(RTransferPolicy.parse(text))
    assert TransferPolicy.parse(str(port)) == port
    assert port.num_shards == RTransferPolicy.parse(text).num_shards
    for k in (1, 2):
        assert str(port.reshard(k)) == str(RTransferPolicy.parse(text)
                                           .reshard(k))


@pytest.mark.parametrize("text", [
    "",
    "params/**=marshal",
    "**=marshal; **=pointerchain",
    "a/**=marshal@dp4; b/**=marshal@dp8; **=marshal",
    "**=uvm+delta",
    "**=bogus",
    "params/**",
    "params/**/w=marshal; **=marshal",
    "a//b=marshal; **=marshal",
    "=marshal",
    "**=",
])
def test_invalid_policies_raise_in_both(text):
    with pytest.raises(RUnsupportedSpecError) as ref:
        RTransferPolicy.parse(text)
    with pytest.raises(UnsupportedSpecError) as port:
        TransferPolicy.parse(text)
    assert isinstance(port.value, UnsupportedPolicyError) \
        == isinstance(ref.value, RUnsupportedPolicyError)


def test_canonical_forms_and_matching_equal_the_reference():
    assert PolicyRule("opt/layers/[3]/w", "marshal").pattern \
        == RPolicyRule("opt/layers/[3]/w", "marshal").pattern
    assert str(TransferPolicy.parse("marshal+delta")) == "**=marshal+delta"
    pol = "a/**=marshal; a/b/**=pointerchain; a/*/c=uvm; **=marshal+delta"
    port, ref = TransferPolicy.parse(pol), RTransferPolicy.parse(pol)
    for path in ("a.x", "a.b.c", "a.q.c", "a.b.d.e", "z", "a[0]", "a.b"):
        assert port.match(path).pattern == ref.match(path).pattern, path


# ----------------------------------------------------------- serve state

@pytest.fixture(scope="module")
def serve_state():
    """The reference's ServeState on the smoke llama (host numpy) and the
    same tree as the port's host tree."""
    api = r_registry.get("llama3.2-1b", smoke=True)
    params = jax.device_get(api.init(jax.random.PRNGKey(0)))
    host = {"params": params,
            "cache": jax.device_get(api.init_cache(2, 64)),
            "slots": {"rid": np.full((2,), -1, np.int32),
                      "pos": np.zeros((2,), np.int32)}}
    return host, from_reference_tree(host)


def test_partition_equals_the_reference(serve_state):
    ref_host, port_host = serve_state
    pol = str(r_serve_policy())
    assert pol == str(serve_transfer_policy())
    want = r_partition_tree(ref_host, pol)
    got = partition_tree(port_host, pol)
    assert list(got) == list(want)
    for key in want:
        assert got[key].indices == want[key].indices
        assert got[key].paths == want[key].paths
        assert got[key].spec == TransferPolicy.parse(pol).match(
            got[key].paths[0]).spec


@pytest.mark.parametrize("policy", [
    str(r_serve_policy()),
    "params/**=marshal+delta; cache/**=marshal+align64; **=uvm",
    "**=marshal",
])
def test_program_ledgers_equal_the_reference(serve_state, policy):
    ref_host, port_host = serve_state
    ref_prog = RTransferSession().compile(ref_host, policy)
    port_prog = TransferSession().compile(port_host, policy, device=CPU)
    for _ in range(2):                     # cold, then the steady repeat
        ref_prog.to_device(ref_host)
        out = port_prog.to_device(port_host)
        assert set(port_prog.ledgers) == set(ref_prog.ledgers)
        for key, led in ref_prog.ledgers.items():
            mine = port_prog.ledgers[key]
            for f in _LEDGER_FIELDS:
                assert getattr(mine, f) == getattr(led, f), (key, f)
        assert port_prog.last_stats.enqueues == ref_prog.last_stats.enqueues
    merged = port_prog.merged_ledger()
    assert merged.h2d_bytes == ref_prog.merged_ledger().h2d_bytes
    if "uvm" not in policy:
        for a, b in zip(tree_leaves(out), tree_leaves(port_host)):
            assert torch.equal(a, b)


def test_serve_policy_install_ledger(serve_state):
    _, port_host = serve_state
    prog = TransferSession().compile(port_host, serve_transfer_policy(),
                                     device=CPU)
    prog.to_device(port_host)
    assert {k: (l.h2d_bytes, l.h2d_calls) for k, l in prog.ledgers.items()} \
        == {"params/**": (313088, 1), "cache/**": (65544, 2), "**": (16, 2)}


def test_one_synchronize_per_pass(serve_state, monkeypatch):
    _, port_host = serve_state
    syncs = []
    real = p_schemes.TransferScheme._put_batch

    def spy(self, xs, sync=True):
        syncs.append(sync)
        return real(self, xs, sync)

    monkeypatch.setattr(p_schemes.TransferScheme, "_put_batch", spy)
    prog = TransferSession().compile(port_host, serve_transfer_policy(),
                                     device=CPU)
    for _ in range(2):
        before = prog.merged_ledger().h2d_calls
        prog.to_device(port_host)
        assert prog.last_stats.syncs == 1
        assert prog.last_stats.enqueue_total \
            == prog.merged_ledger().h2d_calls - before
    # every region enqueued without a synchronize of its own
    assert syncs and not any(syncs)
    # the steady repeat re-ships nothing of the delta cache region
    assert prog.last_stats.enqueues["cache/**"] == 0


def test_async_pass_equals_blocking_pass(serve_state):
    _, port_host = serve_state
    a = TransferSession().compile(port_host, serve_transfer_policy(),
                                  device=CPU)
    b = TransferSession().compile(port_host, serve_transfer_policy(),
                                  device=CPU)
    blocking = a.to_device(port_host)
    fut = b.to_device_async(port_host)
    assert fut.wait(timeout=1.0) and fut.done()
    got = fut.result(timeout=1.0)
    assert fut.result() is got             # memoized
    for x, y in zip(tree_leaves(got), tree_leaves(blocking)):
        assert torch.equal(x, y)
    for key in a.ledgers:
        assert a.ledgers[key].as_dict()["h2d_bytes"] \
            == b.ledgers[key].as_dict()["h2d_bytes"]
    back = b.from_device(got, port_host)
    for x, y in zip(tree_leaves(back), tree_leaves(port_host)):
        assert torch.equal(x, y)
    b.clear()
    assert b.merged_ledger().h2d_bytes == 0


class _HungBarrier:
    """A pass barrier that completes only when released."""

    def __init__(self):
        self.released = False

    def query(self):
        return self.released

    def synchronize(self):
        assert self.released


def test_result_timeout_is_typed_and_retryable():
    tree = {"a": torch.arange(64, dtype=torch.float32)}
    prog = TransferSession().compile(tree, "**=marshal", device=CPU)
    fut = prog.to_device_async(tree)
    hung = fut._barrier = _HungBarrier()
    assert fut.wait(timeout=0.01) is False
    with pytest.raises(TransferTimeout):
        fut.result(timeout=0.02)
    assert not fut.done()
    assert issubclass(TransferTimeout, TimeoutError)
    hung.released = True
    out = fut.result(timeout=1.0)
    assert torch.equal(out["a"], tree["a"])
    assert fut.result(timeout=0.0) is out
    assert prog.last_stats.syncs == 1


def test_dp1_runs_on_one_device_and_dpk_is_not_ported():
    """@dp1 runs unsharded on one device; @dpK runs on a mesh of K
    positions and nowhere narrower: on a one-position mesh the compile
    raises the stale-mesh policy error, naming the rule."""
    scheme = transfer_scheme("marshal+align128@dp1", device=CPU)
    assert scheme.device.type == "cpu" and scheme.mesh is None
    tree = {"a": torch.ones(4)}
    with pytest.raises(UnsupportedPolicyError, match=r"\*\*=marshal@dp2"):
        TransferSession().compile(tree, "**=marshal@dp2", device=[CPU])
    prog = TransferSession().compile(tree, "**=marshal@dp2", device=CPU)
    out = prog.to_device(tree)
    assert torch.equal(to_host(out["a"]), tree["a"])
    assert prog.scheme("**").mesh == (torch.device("cpu"),) * 2
