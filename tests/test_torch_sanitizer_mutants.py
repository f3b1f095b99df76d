"""Seeded-bug ("mutant") validation of the port's staging race sanitizer.

The port of ``tests/test_sanitizer_mutants.py``: each mutant re-introduces
one class of arena bug — a skipped fence wait, a stale-buffer enqueue, a
fence leak, a double sync, a mid-flight staging write, a forgotten
``mark_dirty`` — over the port's ``ArenaEntry`` / ``MarshalScheme`` on the
CPU, and must be caught by its own DC3xx code, while the equivalent clean
drive stays silent.  On the CPU a copy has completed when it returns, and
the engine fences the staging buffer with a completed stand-in, so the
fence discipline (and DC301 / DC303) is exercised as on the card.
"""
import ast
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.analysis import sanitizer
from repro_torch.analysis.sanitizer import StagingRaceError, SyncDisciplineError
from repro_torch.core import arena as arena_lib
from repro_torch.core import engine as engine_lib
from repro_torch.core.engine import ArenaEntry, TransferSession
from repro_torch.core.policy import ProgramStats
from repro_torch.core.schemes import MarshalScheme
from repro_torch.core.spec import TransferSpec

CPU = "cpu"


@pytest.fixture
def san():
    """A fresh shadow machine, restoring whatever was active before (so a
    suite-wide REPRO_SANITIZE=1 run is not silently disabled mid-suite)."""
    prev = sanitizer._ACTIVE
    machine = sanitizer.enable(fresh=True)
    yield machine
    sanitizer._ACTIVE = prev


def _tree(seed: int = 0, n: int = 32):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal(n).astype(np.float32),
            "b": rng.standard_normal(n // 4).astype(np.float32)}


def _scheme(spec: str) -> MarshalScheme:
    return MarshalScheme(TransferSpec.parse(spec), TransferSession(),
                         device=CPU)


# ---------------------------------------------------------------------------
# mutant entries / schemes
# ---------------------------------------------------------------------------

class SkipFenceWaitEntry(ArenaEntry):
    """Seeded bug: rewrites staging without waiting the buffer's fence."""

    def _wait_fence(self, bucket: str, buf_idx: int) -> None:
        pass  # the bug: no event wait, no clear, no on_fence_wait


class LeakyFenceEntry(ArenaEntry):
    """Seeded bug: registers fences without the FENCE_DEPTH trim."""

    def add_fence(self, bucket: str, event) -> None:
        fence = self._fences[bucket][self._active[bucket]]
        fence.append(engine_lib.COMPLETED if event is None else event)
        # the bug: no trim loop
        if sanitizer._ACTIVE is not None:
            sanitizer._ACTIVE.on_add_fence(
                self, bucket, self._active[bucket], len(fence),
                engine_lib.FENCE_DEPTH)


class DoubleSyncScheme(MarshalScheme):
    """Seeded bug: synchronizes inside the enqueue half (per-region
    barrier), breaking the program's one-sync-per-pass contract."""

    def _begin_pipelined(self, tree):
        entry = self._entry_for(tree)
        buffers = entry.pack_host(tree)
        names = list(buffers)
        dev, _ = self._put_batch([buffers[b] for b in names], sync=True)  # bug
        return dev, lambda: entry.unpack(dict(zip(names, dev)))


class ReuseDrainedBufferScheme(MarshalScheme):
    """Seeded bug: enqueues the bucket's INACTIVE (previously drained)
    buffer instead of the active one carrying the newest bytes."""

    def _begin_pipelined(self, tree):
        entry = self._entry_for(tree)
        entry.pack_host(tree)
        names = list(entry.staging)
        stale = {b: entry._bufs[b][1 - entry._active[b]] for b in names}
        dev, _ = self._put_batch([stale[b] for b in names], sync=False)
        self._san_enqueued(entry, stale, names)   # reports the actual tensors

        def finish():
            self._san_drained(entry, names)
            return entry.unpack(dict(zip(names, dev)))

        return dev, finish


# ---------------------------------------------------------------------------
# the six mutants, each with its own code
# ---------------------------------------------------------------------------

def _drive_fenced_packs(entry: ArenaEntry) -> None:
    """Three packs of changing data, fencing the active buffer after each
    — the pipelined executor's steady rhythm.  By pack 3 rotation returns
    to a buffer whose fence only a real ``_wait_fence`` cleared."""
    for seed in range(3):
        buffers = entry.pack_host(_tree(seed=seed))
        for b in buffers:
            entry.add_fence(b, None)      # a CPU copy's (completed) fence


def test_mutant_skip_fence_wait_raises_dc301(san):
    entry = SkipFenceWaitEntry(arena_lib.plan(_tree()))
    with pytest.raises(StagingRaceError) as ei:
        _drive_fenced_packs(entry)
    assert ei.value.code == "DC301"


def test_clean_fenced_packs_silent(san):
    _drive_fenced_packs(ArenaEntry(arena_lib.plan(_tree())))
    assert san.events["fence_wait"] >= 2


def test_mutant_reuse_drained_buffer_raises_dc302(san):
    scheme = ReuseDrainedBufferScheme(TransferSpec.parse("marshal+db"),
                                      TransferSession(), device=CPU)
    with pytest.raises(StagingRaceError) as ei:
        scheme.begin_pass(_tree())
    assert ei.value.code == "DC302"


def test_mutant_leaky_fence_raises_dc303(san):
    entry = LeakyFenceEntry(arena_lib.plan(_tree()))
    entry.pack_host(_tree())
    with pytest.raises(StagingRaceError) as ei:
        for _ in range(engine_lib.FENCE_DEPTH + 1):
            entry.add_fence("float32", None)
    assert ei.value.code == "DC303"


def test_clean_fence_depth_trim_silent(san):
    entry = ArenaEntry(arena_lib.plan(_tree()))
    entry.pack_host(_tree())
    for _ in range(engine_lib.FENCE_DEPTH + 3):
        entry.add_fence("float32", None)  # the trim keeps the depth legal
    assert san.events["add_fence"] == engine_lib.FENCE_DEPTH + 3


def test_mutant_double_sync_raises_dc304(san):
    session = TransferSession()
    tree = _tree()
    program = session.compile(tree, "**=marshal+db", device=CPU)
    key = next(iter(program._schemes))
    program._schemes[key] = DoubleSyncScheme(TransferSpec.parse("marshal+db"),
                                             session, device=CPU)
    with pytest.raises(SyncDisciplineError) as ei:
        program.to_device(tree)
    assert ei.value.code == "DC304"


def test_mutant_pass_stats_double_sync_raises_dc304(san):
    with pytest.raises(SyncDisciplineError) as ei:
        san.on_pass_stats(ProgramStats({"**": 1}, 2, 0.0))
    assert ei.value.code == "DC304"


def test_mutant_mutate_staging_mid_flight_raises_dc305(san):
    scheme = _scheme("marshal+db")
    _, finish = scheme.begin_pass(_tree())
    # the bug: a host writer scribbles on staging while the copy is in
    # flight (before the pass's barrier and finish drained it)
    scheme._entry.staging["float32"][0] += 1.0  # lint: allow=DC204 -- seeded bug
    with pytest.raises(StagingRaceError) as ei:
        finish()
    assert ei.value.code == "DC305"


def test_clean_begin_finish_silent(san):
    scheme = _scheme("marshal+db")
    tree = _tree()
    pending, finish = scheme.begin_pass(tree)
    assert len(pending) == 1
    out = finish()
    assert san.events["drain"] >= 1
    assert torch.equal(out["w"], torch.from_numpy(tree["w"]))


def test_mutant_forgot_mark_dirty_raises_dc306(san):
    scheme = _scheme("marshal+delta")
    tree = _tree()
    scheme.to_device(tree)
    scheme.to_device(tree)           # identity-trusted clean repeat: fine
    tree["w"][0] += 42.0             # in-place mutation, mark_dirty forgot
    with pytest.raises(StagingRaceError) as ei:
        scheme.to_device(tree)
    assert ei.value.code == "DC306"


def test_clean_mark_dirty_after_inplace_mutation_silent(san):
    scheme = _scheme("marshal+delta")
    tree = _tree()
    scheme.to_device(tree)
    scheme.to_device(tree)
    tree["w"][0] += 42.0
    scheme.mark_dirty(tree)          # the fix the mutant above forgot
    dev = scheme.to_device(tree)
    assert float(dev["w"][0]) == float(tree["w"][0])


# ---------------------------------------------------------------------------
# suite-level properties
# ---------------------------------------------------------------------------

def test_mutants_cover_six_distinct_codes():
    """The six seeded bugs map onto six distinct DC3xx codes — no two
    mutants collapse onto the same diagnosis."""
    src = pathlib.Path(__file__).read_text()
    codes = {node.value for node in ast.walk(ast.parse(src))
             if isinstance(node, ast.Constant)
             and isinstance(node.value, str)
             and re.fullmatch(r"DC3\d\d", node.value)}
    assert codes == {"DC301", "DC302", "DC303", "DC304", "DC305", "DC306"}


def test_clean_program_all_paths_silent(san):
    """A full clean program drive — blocking, async, delta steady state —
    trips no diagnostic while exercising every hook."""
    session = TransferSession()
    # opt is structurally distinct from params on purpose: regions of one
    # signature share one ArenaEntry (ROADMAP F2)
    tree = {"params": _tree(seed=1),
            "opt": {"m": np.arange(16, dtype=np.float32)}}
    program = session.compile(
        tree, "params/**=marshal+db; opt/**=marshal+delta; **=marshal+db",
        device=CPU)
    program.to_device(tree)
    tree["params"]["w"] = tree["params"]["w"] + 1.0
    program.to_device(tree)
    fut = program.to_device_async(tree)
    fut.result()
    for event in ("staging_write", "rotate", "enqueue", "sync", "drain",
                  "add_fence", "pass"):
        assert san.events.get(event, 0) >= 1, event
    assert san.events.get("identity_skip", 0) >= 1
