"""The port's staging race sanitizer against the reference's, on the CPU.

The same seeded numpy tree and the same drive go through ``repro`` (under
``repro.analysis.sanitizer``) and ``repro_torch`` (under
``repro_torch.analysis.sanitizer``, ``device="cpu"``): the scheme-level
drives (blocking marshal, marshal+db, marshal+delta on a clean repeat and
after ``mark_dirty``, pointerchain, uvm), a three-region program driven
blocking and async, and faulty drives that must raise the same DC code at
the same step.  Each drive's ``events`` dict must equal the reference's,
with one documented divergence:

  * ``add_fence``: the reference fences each bucket twice a pass, with the
    copy's arrays and with the attach's gather outputs (a device array of
    XLA's CPU client may alias the staging buffer it was put from); the
    port's attach returns views of the device bucket, which never aliases
    staging, so the copy's event is the whole fence and it fences each
    enqueued bucket once.  So the port's ``add_fence`` equals its
    ``enqueue``, and the reference's exceeds its ``enqueue`` by the
    buckets its non-memo passes attached (given per drive below).

Barriers the reference does not report are not reported by the port
either: ``_get_batch``'s D2H synchronize and the fence trim's wait.  The
blocking marshal path reports its barrier (``sync``) and no enqueue or
drain, as the reference's does.
"""
from __future__ import annotations

import types

import numpy as np
import pytest

from repro.analysis import sanitizer as r_san
from repro.core import engine as r_engine
from repro.core import schemes as r_schemes

from repro_torch.analysis import sanitizer as p_san
from repro_torch.core import engine as p_engine
from repro_torch.core import schemes as p_schemes

CPU = "cpu"

REF = types.SimpleNamespace(
    name="reference", san=r_san, session=r_engine.TransferSession,
    scheme=lambda spec, session: r_schemes.transfer_scheme(spec, session),
    compile=lambda session, tree, policy: session.compile(tree, policy))
PORT = types.SimpleNamespace(
    name="port", san=p_san, session=p_engine.TransferSession,
    scheme=lambda spec, session: p_schemes.transfer_scheme(
        spec, session, device=CPU),
    compile=lambda session, tree, policy: session.compile(
        tree, policy, device=CPU))

POLICY = "params/**=marshal+db; opt/**=marshal+delta; meta/**=pointerchain; **=marshal"


def _tree(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal(64).astype(np.float32),
            "b": rng.standard_normal(16).astype(np.float32),
            "ids": rng.integers(0, 9, 8).astype(np.int32)}


def _program_tree(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"params": _tree(seed),
            "opt": {"m": rng.standard_normal(24).astype(np.float32),
                    "t": np.arange(4, dtype=np.int32)},
            "meta": {"scale": rng.standard_normal(8).astype(np.float32)}}


# ---------------------------------------------------------------- drives
# each takes a package and a ``step`` callback, called before every pass

def _marshal(spec):
    def drive(pkg, step):
        s = pkg.scheme(spec, pkg.session())
        tree = _tree(0)
        for t in (tree, tree, _tree(0), _tree(1)):
            step()
            s.to_device(t)
        step()
        t = dict(tree, ids=tree["ids"] + 1)     # one bucket changes
        s.to_device(t)
    return drive


def _delta_clean(pkg, step):
    s = pkg.scheme("marshal+delta", pkg.session())
    tree = _tree(0)
    for _ in range(6):                          # the skip streak's verifies
        step()
        s.to_device(tree)


def _delta_mark_dirty(pkg, step):
    s = pkg.scheme("marshal+delta", pkg.session())
    tree = _tree(0)
    for _ in range(2):
        step()
        s.to_device(tree)
    tree["w"][3] += 1.0
    s.mark_dirty(tree, "w")
    step()
    s.to_device(tree)
    step()
    s.to_device(tree)
    tree["ids"][0] += 1
    s.mark_dirty(tree)
    step()
    s.to_device(tree)


def _pointerchain(pkg, step):
    s = pkg.scheme("pointerchain", pkg.session())
    tree = _tree(0)
    for paths in (["w"], ["w", "ids"], None):
        step()
        s.to_device(tree, paths)


def _uvm(pkg, step):
    s = pkg.scheme("uvm", pkg.session())
    tree = _tree(0)
    step()
    s.materialize(s.to_device(tree), paths=["w", "ids"])
    step()
    s.materialize(s.to_device(tree))


def _program(run):
    def drive(pkg, step):
        program = pkg.compile(pkg.session(), _program_tree(0), POLICY)
        tree = _program_tree(0)
        for mutate in (None, "params", None, "opt", "all"):
            if mutate == "params":
                tree["params"] = dict(tree["params"],
                                      w=tree["params"]["w"] * 2)
            elif mutate == "opt":
                tree["opt"] = dict(tree["opt"], m=tree["opt"]["m"] + 1)
            elif mutate == "all":
                tree = _program_tree(1)
            step()
            if run == "blocking":
                program.to_device(tree)
            else:
                program.to_device_async(tree).result()
    return drive


def _forgot_mark_dirty(pkg, step):
    """A leaf mutated in place before pass 4 without mark_dirty: its skip
    streak is then 3, which VERIFY_EVERY (4) lets through unverified, so
    both packages catch it at pass 5."""
    s = pkg.scheme("marshal+delta", pkg.session())
    tree = _tree(0)
    for i in range(6):
        if i == 3:
            tree["w"][0] += 42.0                # no mark_dirty
        step()
        s.to_device(tree)


def _scribble_mid_flight(pkg, step):
    s = pkg.scheme("marshal+db", pkg.session())
    for seed in range(3):
        step()
        _, finish = s.begin_pass(_tree(seed))
        if seed == 2:
            s._entry._bufs["int32"][s._entry._active["int32"]][0] += 1
        finish()


# drive -> the buckets the reference's non-memo passes attached (its
# add_fence beyond its enqueue)
CLEAN = {
    "marshal": (_marshal("marshal"), 0),
    "marshal+db": (_marshal("marshal+db"), 10),
    "marshal+delta-clean-repeat": (_delta_clean, 2),
    "marshal+delta-mark-dirty": (_delta_mark_dirty, 6),
    "pointerchain": (_pointerchain, 0),
    "uvm": (_uvm, 0),
    "program-blocking": (_program("blocking"), 16),
    "program-async": (_program("async"), 16),
}

FAULTY = {
    "forgot-mark-dirty": (_forgot_mark_dirty, "DC306", 5),
    "scribble-mid-flight": (_scribble_mid_flight, "DC305", 3),
}


def _run(pkg, drive):
    """The drive under a fresh sanitizer: (events, the DC code raised or
    None, the step it was raised at)."""
    steps = [0]

    def step():
        steps[0] += 1

    with pkg.san.sanitize() as san:
        try:
            drive(pkg, step)
        except pkg.san.StagingRaceError as e:
            return dict(san.events), e.code, steps[0]
    return dict(san.events), None, steps[0]


def _without_fences(events):
    return {k: v for k, v in events.items() if k != "add_fence"}


@pytest.mark.parametrize("name", list(CLEAN))
def test_clean_drive_events_equal_the_reference(name):
    drive, attached = CLEAN[name]
    r_events, r_code, _ = _run(REF, drive)
    p_events, p_code, _ = _run(PORT, drive)
    assert r_code is None and p_code is None, (r_code, p_code)
    assert _without_fences(p_events) == _without_fences(r_events), (
        p_events, r_events)
    # the documented divergence: one fence per enqueued bucket in the port
    assert p_events.get("add_fence", 0) == p_events.get("enqueue", 0)
    assert (r_events.get("add_fence", 0) - r_events.get("enqueue", 0)
            == attached), r_events


@pytest.mark.parametrize("name", list(FAULTY))
def test_faulty_drive_raises_the_reference_code_at_the_same_step(name):
    drive, code, at = FAULTY[name]
    r_events, r_code, r_step = _run(REF, drive)
    p_events, p_code, p_step = _run(PORT, drive)
    assert (p_code, p_step) == (r_code, r_step) == (code, at)
    assert _without_fences(p_events) == _without_fences(r_events), (
        p_events, r_events)


def test_sanitizer_names_and_switches_mirror_the_reference():
    """The same public names, ``VERIFY_EVERY`` and the enable / disable /
    sanitize switches, each restoring the previous machine."""
    for name in ("StagingRaceError", "SyncDisciplineError", "Sanitizer",
                 "enable", "disable", "active", "sanitize", "enqueue_half",
                 "IDLE", "PACKING", "ENQUEUED", "IN_FLIGHT", "DRAINED"):
        assert hasattr(p_san, name), name
    assert p_san.Sanitizer.VERIFY_EVERY == r_san.Sanitizer.VERIFY_EVERY == 4
    assert issubclass(p_san.SyncDisciplineError, p_san.StagingRaceError)
    prev = p_san._ACTIVE
    try:
        p_san.disable()
        assert p_san.active() is None
        first = p_san.enable()
        assert p_san.enable() is first and p_san.enable(fresh=True) is not first
        with p_san.sanitize() as inner:
            assert p_san.active() is inner
        assert p_san.active() is not inner
        p_san.disable()
        p_engine.TransferSession(sanitize=True)
        assert p_san.active() is not None
    finally:
        p_san._ACTIVE = prev


def test_fingerprint_folds_any_dtype_and_sees_one_flipped_bit():
    import torch

    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.uint8):
        t = torch.arange(37).to(dtype)
        before = p_san._fingerprint(t)
        assert p_san._fingerprint(t.clone()) == before
        raw = t.view(torch.uint8)
        raw[raw.numel() // 2] ^= 1
        assert p_san._fingerprint(t) != before, dtype
