"""The port's checkpointer against the JAX package's, on the CPU.

The reference's tests/test_checkpoint.py, case for case, on the port
(round trip, one ``.bin`` per dtype, latest step and GC, the atomic
commit, selective restore, the async checkpointer and its snapshot arena,
the torn-commit matrix over every fault point, a failed async save
surfacing on the next call, the commit-window re-save), plus the two
cross-package restores: a checkpoint either package writes restores in
the other bit for bit, bf16 buckets included, and the files are the same
bytes.
"""
import json
import os

import jax
import ml_dtypes  # noqa: F401  (registers numpy's bfloat16 for the reference)
import numpy as np
import pytest
import torch

from repro import checkpoint as r_ckpt

from repro_torch import checkpoint as ckpt
from repro_torch.convert import from_reference_tree, to_reference_tree
from repro_torch.core import tree_leaves, tree_map
from repro_torch.runtime import faults


def _np_state():
    rng = np.random.default_rng(1)
    return {"params": {"layers": {"w": rng.standard_normal((16, 8)).astype(np.float32),
                                  "scale": np.ones(8, np.float32)},
                       "embed": rng.integers(0, 5, (10, 4)).astype(np.int32)},
            "opt": {"mu": np.zeros((16, 8), np.float32)},
            "step": np.int32(42)}


@pytest.fixture()
def state():
    return from_reference_tree(_np_state())


def _with_step(state, n):
    return dict(state, step=torch.tensor(n, dtype=torch.int32))


def _assert_tree_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_save_load_roundtrip(state, tmp_path):
    ckpt.save(state, str(tmp_path), 42)
    out = ckpt.load(str(tmp_path), 42)
    _assert_tree_equal(state, out)
    assert int(out["step"]) == 42


def test_one_bin_file_per_dtype(state, tmp_path):
    d = ckpt.save(state, str(tmp_path), 0)
    bins = sorted(f for f in os.listdir(d) if f.endswith(".bin"))
    assert bins == ["float32.bin", "int32.bin"]  # marshalled: one per bucket


def test_latest_step_and_gc(state, tmp_path):
    for s in (1, 5, 3):
        ckpt.save(state, str(tmp_path), s)
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert ckpt.available_steps(str(tmp_path)) == [1, 3, 5]


def test_atomic_commit_no_tmp_left(state, tmp_path):
    ckpt.save(state, str(tmp_path), 7)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_selective_restore_reads_only_named_chains(state, tmp_path):
    ckpt.save(state, str(tmp_path), 0)
    out = ckpt.selective_restore(str(tmp_path), ["params.layers.scale"], 0)
    assert list(out) == ["params.layers.scale"]
    assert torch.equal(out["params.layers.scale"],
                       state["params"]["layers"]["scale"])
    out2 = ckpt.selective_restore(str(tmp_path), ["params.layers"], 0)
    assert set(out2) == {"params.layers.scale", "params.layers.w"}
    with pytest.raises(KeyError, match="not in checkpoint"):
        ckpt.selective_restore(str(tmp_path), ["params.nope"], 0)


def test_restore_places_on_the_cpu_and_needs_a_card_otherwise(state, tmp_path):
    from repro_torch import NoCudaDeviceError

    ckpt.save(state, str(tmp_path), 0)
    _assert_tree_equal(state, ckpt.restore(str(tmp_path), 0, device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDeviceError):
            ckpt.restore(str(tmp_path), 0, device=None)
        with pytest.raises(NoCudaDeviceError):
            ckpt.restore(str(tmp_path), 0)


def test_async_checkpointer(state, tmp_path):
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        ac.save(state, s)
    ac.wait()
    assert ckpt.available_steps(str(tmp_path)) == [20, 30]  # GC keeps 2
    _assert_tree_equal(state, ckpt.load(str(tmp_path), 30))


def test_corrupt_tmp_dir_is_ignored(state, tmp_path):
    os.makedirs(tmp_path / "step_00000099.tmp")
    ckpt.save(state, str(tmp_path), 1)
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_torn_checkpoint_restores_previous_step(state, tmp_path):
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep=3)
    ac.save(state, 1)
    ac.wait()

    class WriterKilled(RuntimeError):
        pass

    def torn_commit(tmp, final):
        raise WriterKilled(f"killed before renaming {tmp}")

    ac._commit = torn_commit
    ac.save(_with_step(state, 2), 2)
    with pytest.raises(ckpt.CheckpointWriteError, match="step 2") as ei:
        ac.wait()
    assert isinstance(ei.value.__cause__, WriterKilled)
    assert ei.value.step == 2
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    assert ckpt.available_steps(str(tmp_path)) == [1]
    out = ckpt.load(str(tmp_path))
    _assert_tree_equal(state, out)
    assert int(out["step"]) == 42


def test_failed_async_save_surfaces_on_next_save(state, tmp_path):
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep=3)

    def torn_commit(tmp, final):
        raise OSError("disk full")

    ac._commit = torn_commit
    ac.save(state, 1)
    with pytest.raises(ckpt.CheckpointWriteError, match="step 1"):
        ac.save(state, 2)


@pytest.mark.parametrize("point,latest_after", [
    ("ckpt.pack", 1), ("ckpt.write", 1), ("ckpt.commit", 1), ("ckpt.gc", 2)])
def test_torn_checkpoint_matrix(state, tmp_path, point, latest_after):
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep=1)  # keep=1: GC runs
    ac.save(state, 1)
    ac.wait()
    torn = _with_step(state, 2)
    with faults.injected(point) as inj:
        ac.save(torn, 2)
        with pytest.raises(ckpt.CheckpointWriteError, match="step 2") as ei:
            ac.wait()
    assert isinstance(ei.value.__cause__, faults.InjectedFault)
    assert inj.fired == [(point, 1)]
    assert ckpt.available_steps(str(tmp_path)) == (
        [1, 2] if latest_after == 2 else [1])
    out = ckpt.load(str(tmp_path))
    _assert_tree_equal(torn if latest_after == 2 else state, out)
    ac2 = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    ac2.save(torn, 2)
    ac2.wait()
    assert ckpt.latest_step(str(tmp_path)) == 2
    _assert_tree_equal(torn, ckpt.load(str(tmp_path), 2))


def test_commit_window_crash_keeps_committed_resave(state, tmp_path):
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep=3)
    ac.save(state, 1)
    ac.wait()
    resave = _with_step(state, 43)
    with faults.injected("ckpt.commit"):
        ac.save(resave, 1)
        with pytest.raises(ckpt.CheckpointWriteError):
            ac.wait()
    assert ckpt.available_steps(str(tmp_path)) == [1]
    assert int(ckpt.load(str(tmp_path), 1)["step"]) == 42
    ac.save(resave, 1)
    ac.wait()
    assert int(ckpt.load(str(tmp_path), 1)["step"]) == 43
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".old")]


def test_available_steps_ignores_foreign_names(state, tmp_path):
    ckpt.save(state, str(tmp_path), 3)
    os.makedirs(tmp_path / "step_00000009.tmp")
    os.makedirs(tmp_path / "step_x")
    os.makedirs(tmp_path / "step_5extra")
    assert ckpt.available_steps(str(tmp_path)) == [3]


def test_save_snapshots_a_host_state_before_returning(state, tmp_path):
    """The caller may write its tensors in place right after save(): the
    snapshot was staged before save returned."""
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep=3)
    live = tree_map(lambda t: t.clone(), state)
    ac.save(live, 5)
    for t in tree_leaves(live):
        t.add_(1)
    ac.wait()
    _assert_tree_equal(state, ckpt.load(str(tmp_path), 5))


def test_snapshot_arena_double_buffers(state, tmp_path):
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep=5)
    for s in (1, 2, 3):
        ac.save(state, s)
    ac.wait()
    assert len(ac._snapshot._bufs) == 2
    assert ac.saves == 3 and ac.stall_s >= ac.last_stall_s >= 0.0
    for s in (1, 2, 3):
        _assert_tree_equal(state, ckpt.load(str(tmp_path), s))
    ac.close()
    assert ac._snapshot.nbytes() == 0


# ------------------------------------------------ across the two packages

def _mixed_np_state():
    rng = np.random.default_rng(7)
    bf = ml_dtypes.bfloat16
    return {"params": {"blocks": {"w": rng.standard_normal((3, 5, 7)).astype(bf),
                                  "scale": rng.standard_normal((3, 5)).astype(bf)},
                       "embed": rng.standard_normal((11, 6)).astype(np.float32)},
            "opt": {"count": np.int32(9),
                    "mu": rng.standard_normal((3, 5, 7)).astype(np.float32)},
            "step": np.int32(9)}


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d)) if f.endswith(".bin")}


def test_a_reference_checkpoint_restores_in_the_port(tmp_path):
    ref_state = _mixed_np_state()
    d = r_ckpt.save(ref_state, str(tmp_path), 9)
    assert sorted(_files(d)) == ["bfloat16.bin", "float32.bin", "int32.bin"]
    out = ckpt.load(str(tmp_path), 9)
    _assert_tree_equal(from_reference_tree(ref_state), out)
    assert out["params"]["blocks"]["w"].dtype == torch.bfloat16
    part = ckpt.selective_restore(str(tmp_path), ["params.blocks.w"], 9)
    assert torch.equal(part["params.blocks.w"], out["params"]["blocks"]["w"])


def test_a_port_checkpoint_restores_in_the_reference(tmp_path):
    ref_state = _mixed_np_state()
    d = ckpt.save(from_reference_tree(ref_state), str(tmp_path / "p"), 9)
    out = r_ckpt.load(str(tmp_path / "p"), 9)
    for a, b in zip(jax.tree_util.tree_leaves(ref_state),
                    jax.tree_util.tree_leaves(out)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    # the same bytes on disk and the same manifest, up to the wall time
    rd = r_ckpt.save(ref_state, str(tmp_path / "r"), 9)
    assert _files(d) == _files(rd)
    man = [json.load(open(os.path.join(x, "manifest.json"))) for x in (d, rd)]
    for m in man:
        m.pop("wall_s")
    assert man[0] == man[1]


def test_an_async_port_checkpoint_restores_in_the_reference(tmp_path):
    ref_state = _mixed_np_state()
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    ac.save(from_reference_tree(ref_state), 9)
    ac.close()
    out = r_ckpt.load(str(tmp_path), 9)
    got = from_reference_tree(out)
    _assert_tree_equal(from_reference_tree(ref_state), got)
    assert to_reference_tree(got)["params"]["blocks"]["w"].dtype.name == "bfloat16"
