"""Checkpoints ARE marshalled deep copies (paper Alg. 1 applied to I/O).

The port's counterpart of ``repro/checkpoint/ckpt.py``, with the same
format on disk, so a checkpoint that either package writes restores in
the other bit for bit:

    <dir>/step_<N>/
        manifest.json      the requestList: per-leaf (path, bucket, offset,
                           size, shape, dtype) + tree template + metadata
        <bucket>.bin       ONE contiguous buffer per dtype bucket, raw
                           little-endian words

Buckets and dtypes carry numpy's names (``float32``, ``int32``,
``bfloat16``); a bf16 bucket is written and read as its raw 2-byte words,
so neither side needs ``ml_dtypes`` to move it.  Host trees hold torch CPU
tensors (0-d for scalars).

Save   = arena-pack the state tree, stream each bucket to
         ``step_<N>.tmp``, fsync, commit by renaming (a committed step is
         renamed aside first and removed after, see :func:`_commit`).
Restore= attach: rebuild leaf views from offsets.  ``selective_restore``
         reads ONLY the byte ranges of the requested chains (``np.memmap``).
         ``restore(device=...)`` places the tree on a device leaf by leaf,
         ``restore(shardings=...)`` in per-dim blocks on a named mesh;
         ``runtime.loop`` stages it through a TransferProgram instead.

:class:`AsyncCheckpointer` snapshots device state without stalling the
step: see its docstring for how the snapshot is ordered after the step
that produced it.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import sys
import threading
import time
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core import arena as arena_lib
from ..core.placement import PlacedTensor, place_tree
from ..core.sharded import replica
from ..core.treepath import TreePath, leaf_paths, tree_flatten, tree_map
from ..faultpoints import CKPT_COMMIT, CKPT_GC, CKPT_PACK, CKPT_WRITE

_FLAG = "manifest.json"
_OLD_SUFFIX = ".old"
_STEP_RE = re.compile(r"^step_(\d+)$")

# bucket name -> (numpy dtype of its words on disk, torch dtype)
_WORDS = {"bfloat16": (np.dtype(np.int16), torch.bfloat16)}


class CheckpointWriteError(RuntimeError):
    """An async checkpoint save failed on the writer thread.  Carries the
    step number; the original failure is ``__cause__``.  Raised by the next
    ``save()``/``wait()`` so a silent stale "latest" checkpoint is
    impossible."""

    def __init__(self, step: int, cause: BaseException):
        super().__init__(
            f"async checkpoint save of step {step} failed on the writer "
            f"thread: {cause!r}; the latest durable checkpoint is an "
            f"EARLIER step")
        self.step = step


def _trip(point: str) -> None:
    """Fault-injection hook, looked up through ``sys.modules`` so the
    checkpoint layer never imports the runtime package (an injector can
    only be installed by importing it)."""
    faults = sys.modules.get("repro_torch.runtime.faults")
    if faults is not None:
        faults.trip(point)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _tree_to_template(tree: Any) -> Any:
    """JSON-serializable skeleton with leaf slots marked by index."""
    counter = [0]

    def mark(_):
        i = counter[0]
        counter[0] += 1
        return {"__leaf__": i}

    return tree_map(mark, tree)


def _is_marked(x) -> bool:
    return isinstance(x, dict) and "__leaf__" in x


def _rebuild(template: Any, leaves: Dict[int, Any]) -> Any:
    if _is_marked(template):
        return leaves[template["__leaf__"]]
    if isinstance(template, dict):
        return {k: _rebuild(v, leaves) for k, v in template.items()}
    if isinstance(template, list):
        return [_rebuild(v, leaves) for v in template]
    return template


def _words(buf: torch.Tensor) -> np.ndarray:
    """A CPU bucket as numpy words (bf16 as its int16 bit patterns)."""
    if buf.dtype == torch.bfloat16:
        return buf.view(torch.int16).numpy()
    return buf.numpy()


def _from_words(words: np.ndarray, bucket: str) -> torch.Tensor:
    if bucket in _WORDS:
        return torch.from_numpy(words).view(_WORDS[bucket][1])
    return torch.from_numpy(words)


def _disk_dtype(bucket: str) -> np.dtype:
    return _WORDS[bucket][0] if bucket in _WORDS else np.dtype(bucket)


def _fsync_dir(path: str) -> None:
    """Flush a directory entry (the rename itself) to the storage device."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - e.g. platforms without dir fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _commit(tmp: str, final: str) -> None:
    """The atomic commit: a checkpoint either fully exists or it doesn't.

    A committed step being re-saved is renamed aside (``step_N.old``), the
    new one renamed in, the parent directory fsynced, and only then the
    aside copy removed; a crash inside the window leaves ``step_N.old``,
    which :func:`available_steps` recovers."""
    old = final + _OLD_SUFFIX
    if os.path.exists(final):
        if os.path.exists(old):
            shutil.rmtree(old)            # stale leftover of a prior crash
        os.rename(final, old)
    _trip(CKPT_COMMIT)                  # the commit window: old aside,
    os.rename(tmp, final)                 # new not yet in place
    _fsync_dir(os.path.dirname(final) or ".")
    if os.path.isdir(old):
        shutil.rmtree(old, ignore_errors=True)


def _write_step(host_state: Any, buffers: Dict[str, torch.Tensor],
                layout: Any, directory: str, step: int,
                extra_meta: Optional[dict], t0: float,
                commit=_commit) -> str:
    """Stream the staged arena to ``<dir>/step_<N>.tmp`` then commit.

    Restore ignores ``.tmp`` and manifest-less directories, so a writer
    killed before the commit leaves the previous step as the latest.
    Every bucket file and the manifest are fsynced before the commit."""
    tmp = _step_dir(directory, step) + ".tmp"
    final = _step_dir(directory, step)
    os.makedirs(tmp, exist_ok=True)
    for bucket, buf in buffers.items():
        with open(os.path.join(tmp, f"{bucket}.bin"), "wb") as f:
            _words(buf).tofile(f)
            f.flush()
            os.fsync(f.fileno())
    _trip(CKPT_WRITE)                   # buckets on disk, no manifest yet

    manifest = {
        "step": step,
        "paths": [str(p) for p in leaf_paths(host_state)],
        "slots": [{"bucket": s.bucket, "offset": s.offset, "size": s.size,
                   "shape": list(s.shape),
                   "dtype": arena_lib.dtype_name(s.dtype)}
                  for s in layout.slots],
        "template": _tree_to_template(host_state),
        "buckets": {b: int(n) for b, n in layout.bucket_sizes.items()},
        "wall_s": time.perf_counter() - t0,
        "meta": extra_meta or {},
    }
    with open(os.path.join(tmp, _FLAG), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    commit(tmp, final)
    return final


def _one_copy(leaf: Any) -> torch.Tensor:
    """A leaf as one tensor: position 0's copy of a replicated leaf (a
    replicated state saves once, as the reference's ``device_get`` of a
    replicated array reads one copy), a placed leaf's blocks assembled on
    position 0's device."""
    if isinstance(leaf, PlacedTensor):
        return leaf.gather(leaf.blocks[0].device)
    return arena_lib.as_tensor(replica(leaf, 0))


def _host(leaf: Any) -> torch.Tensor:
    if isinstance(leaf, PlacedTensor):
        return leaf.gather()
    return _one_copy(leaf).detach().cpu()


def save(state: Any, directory: str, step: int, *,
         extra_meta: Optional[dict] = None) -> str:
    """Synchronous marshalled save with atomic commit."""
    t0 = time.perf_counter()
    host_state = tree_map(_host, state)
    buffers, layout = arena_lib.pack(host_state)
    return _write_step(host_state, buffers, layout, directory, step,
                       extra_meta, t0)


def _recover_aside(directory: str) -> None:
    """Finish an interrupted :func:`_commit`: a ``step_N.old`` whose
    ``step_N`` is missing IS the committed step — rename it back."""
    for name in os.listdir(directory):
        if not name.endswith(_OLD_SUFFIX):
            continue
        stem = name[:-len(_OLD_SUFFIX)]
        if not _STEP_RE.match(stem):
            continue
        final = os.path.join(directory, stem)
        aside = os.path.join(directory, name)
        if not os.path.exists(final) \
                and os.path.exists(os.path.join(aside, _FLAG)):
            try:
                os.rename(aside, final)
            except OSError:  # pragma: no cover - lost a benign race
                pass


def available_steps(directory: str) -> list[int]:
    """Durable steps: strictly ``step_<N>`` directories holding a
    manifest (never ``.tmp`` staging, ``.old`` aside copies or foreign
    names)."""
    if not os.path.isdir(directory):
        return []
    _recover_aside(directory)
    out = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name, _FLAG)):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = available_steps(directory)
    return steps[-1] if steps else None


def _load_manifest(directory: str, step: int) -> dict:
    with open(os.path.join(_step_dir(directory, step), _FLAG)) as f:
        return json.load(f)


def _resolve_step(directory: str, step: Optional[int]) -> int:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    return step


def load(directory: str, step: Optional[int] = None) -> Any:
    """Full restore to a host tree of torch CPU tensors (attach over the
    on-disk arena: every leaf a view of its bucket)."""
    step = _resolve_step(directory, step)
    man = _load_manifest(directory, step)
    d = _step_dir(directory, step)
    buffers = {b: _from_words(np.fromfile(os.path.join(d, f"{b}.bin"),
                                          dtype=_disk_dtype(b)), b)
               for b in man["buckets"]}
    leaves = {}
    for i, s in enumerate(man["slots"]):
        flat = buffers[s["bucket"]][s["offset"]: s["offset"] + s["size"]]
        leaves[i] = flat.view(s["shape"])
    return _rebuild(man["template"], leaves)


def selective_restore(directory: str, paths: Sequence[Union[str, TreePath]],
                      step: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """pointerchain over the manifest: read ONLY the named chains' bytes
    (a chain names a leaf or every leaf below it)."""
    step = _resolve_step(directory, step)
    man = _load_manifest(directory, step)
    d = _step_dir(directory, step)
    index = {p: i for i, p in enumerate(man["paths"])}
    out: Dict[str, torch.Tensor] = {}
    mmaps: Dict[str, np.memmap] = {}
    for p in paths:
        key = str(TreePath.parse(p))
        hits = [k for k in index if k == key or k.startswith(key + ".")
                or k.startswith(key + "[")]
        if not hits:
            raise KeyError(f"chain {key!r} not in checkpoint manifest")
        for h in hits:
            s = man["slots"][index[h]]
            b = s["bucket"]
            if b not in mmaps:
                mmaps[b] = np.memmap(os.path.join(d, f"{b}.bin"),
                                     dtype=_disk_dtype(b), mode="r")
            flat = np.array(mmaps[b][s["offset"]: s["offset"] + s["size"]])
            out[h] = _from_words(flat, b).view(s["shape"])
    return out


def _tree_mismatch(host: Any, shardings: Any) -> Optional[str]:
    """None when the trees match, else the reference's description of
    their first divergence."""
    tdef_h = tree_flatten(host)[1]
    tdef_s = tree_flatten(shardings)[1]
    if tdef_s == tdef_h:
        return None
    # leaf-count equality is NOT structural equality: a different tree
    # with the same number of leaves would silently zip shardings onto
    # the wrong arrays.  Name the first diverging path.
    paths_h = [str(p) for p in leaf_paths(host)]
    paths_s = [str(p) for p in leaf_paths(shardings)]
    diverge = next(
        (f"checkpoint has {a!r}, shardings have {b!r}"
         for a, b in zip(paths_h, paths_s) if a != b), None)
    if diverge is None:
        if len(paths_h) != len(paths_s):
            longer = paths_h if len(paths_h) > len(paths_s) else paths_s
            side = "checkpoint" if longer is paths_h else "shardings"
            diverge = (f"{side} side has extra leaf "
                       f"{longer[min(len(paths_h), len(paths_s))]!r}")
        else:  # same printed paths, different containers (dict vs list)
            diverge = (f"same leaf paths but different container "
                       f"structure ({tdef_h} vs {tdef_s})")
    return diverge


def restore(directory: str, step: Optional[int] = None, *,
            shardings: Optional[Any] = None,
            device: DeviceLike = None) -> Any:
    """Load a step and place it: with ``shardings`` (a tree of
    :class:`~repro_torch.core.placement.Placement`s matching the
    checkpoint's tree, the reference's reshard onto the current mesh)
    every leaf cut into its placement's blocks on the mesh positions; a
    tree that differs raises ``ValueError`` naming the first diverging
    path.  Without, every leaf on ``device``: the card unless the caller
    passes ``"cpu"`` (then the host tree itself)."""
    host = load(directory, step)
    if shardings is not None:
        diverge = _tree_mismatch(host, shardings)
        if diverge is not None:
            raise ValueError(
                f"sharding tree does not match checkpoint tree: first "
                f"divergence — {diverge}")
        return place_tree(host, shardings)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return host
    return tree_map(lambda t: t.to(dev), host)


class SnapshotArena:
    """Dedicated host staging for checkpoint snapshots: per layout, up to
    two persistent per-bucket buffer sets (page-locked when the state is on
    the card), the second allocated on the second save.  The background
    writer streams one set while the next save stages into the other; with
    the checkpointer's depth-1 pipeline (the previous save joined before
    the next begins) the set :meth:`acquire` hands out is always idle."""

    def __init__(self):
        self._layout = None
        self._pinned = False
        self._bufs: list = []
        self._turn = 0

    def acquire(self, tree: Any, pin_memory: bool = False):
        """The spare buffer set (+ layout) for one snapshot; rotates."""
        layout = arena_lib.plan(tree)
        if (self._layout is None or self._layout.slots != layout.slots
                or self._layout.treedef != layout.treedef
                or self._pinned != pin_memory):
            self._layout, self._pinned = layout, pin_memory
            self._bufs, self._turn = [], 0
        if len(self._bufs) <= self._turn:
            # lint: allow=DC201 -- the snapshot's pinned host buffers, the D2H side no program moves
            self._bufs.append(arena_lib.alloc_buffers(
                self._layout, pin_memory=pin_memory))
        bufs = self._bufs[self._turn]
        self._turn ^= 1
        return bufs, self._layout

    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size()
                   for bufs in self._bufs for b in bufs.values())

    def release(self) -> None:
        """Drop the buffer sets (the next save allocates anew)."""
        self._layout, self._bufs, self._turn = None, [], 0


class AsyncCheckpointer:
    """Zero-stall checkpointing: the snapshot is queued on the card, the
    copy to the host and the write run off the caller's thread.

    ``save(state, step)`` joins the previous save, then, for a state on
    the card:

    1. packs every leaf into fresh device buckets ON THE COMPUTE STREAM
       (the device-side marshal, one copy per leaf): stream order places
       the pack after the step that produced the state, and the buckets
       belong to the checkpointer, so a later step that writes or frees
       the state's tensors cannot touch the snapshot;
    2. records an event after the pack; a side stream waits on it and
       copies each bucket into a page-locked :class:`SnapshotArena` buffer
       (``non_blocking``: one D2H per dtype bucket, which needs pinned
       memory to be asynchronous at all), then records a second event;
    3. hands the buckets and the event to the writer thread, which waits
       the event, drops the device buckets (their memory returns to the
       allocator only after every copy reading it has completed) and
       writes the staged buffers.

    A host state is packed into the (pageable) snapshot buffers before
    ``save`` returns, so the caller may write its tensors at once.
    Caller-side cost is ``stall_s`` / ``last_stall_s``."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._snapshot = SnapshotArena()
        self._stream: Optional[torch.cuda.Stream] = None
        self.last_error: Optional[BaseException] = None
        self.last_error_step: Optional[int] = None
        self.saves = 0
        self.stall_s = 0.0       # cumulative caller-visible save cost
        self.last_stall_s = 0.0

    # the commit hook the torn-checkpoint test kills: everything before it
    # is discardable staging, everything after is a durable checkpoint.
    _commit = staticmethod(_commit)

    def _stage_on_card(self, state: Any, bufs, layout, device):
        """Steps 1 and 2: returns (the device buckets, the copies' event)."""
        dev_bufs = arena_lib.alloc_buffers(layout, device=device)
        arena_lib.pack_into(dev_bufs, layout, state)
        packed = torch.cuda.Event()
        packed.record(torch.cuda.current_stream(device))
        if self._stream is None or self._stream.device != device:
            self._stream = torch.cuda.Stream(device)
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(packed)
            for b, buf in dev_bufs.items():
                # lint: allow=DC201 -- snapshot D2H on the side stream (the reference's restore fallback waiver)
                bufs[b].copy_(buf, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._stream)
        return dev_bufs, copied

    def save(self, state: Any, step: int, extra_meta: Optional[dict] = None):
        t0 = time.perf_counter()
        self.wait()  # depth-1 pipeline: the join doubles as the buffer fence
        leaves = tree_flatten(state)[0]
        tensors = [_one_copy(l) for l in leaves]
        cuda = [t.device for t in tensors if t.device.type == "cuda"]
        device = cuda[0] if cuda else None
        # lint: allow=DC201 -- the snapshot's pinned host buffers, the D2H side no program moves
        bufs, layout = self._snapshot.acquire(state,
                                              pin_memory=device is not None)
        held = event = None
        if device is not None:
            held, event = self._stage_on_card(tensors, bufs, layout, device)
        else:
            arena_lib.pack_into(bufs, layout, tensors)
        del tensors, leaves

        def work():
            nonlocal held
            try:
                if event is not None:
                    # lint: allow=DC201 -- the writer thread waits its snapshot's D2H (as the reference's waiver)
                    event.synchronize()     # the snapshot is in host memory
                    held = None
                host = arena_lib.unpack(bufs, layout)
                _trip(CKPT_PACK)    # snapshot staged, nothing written yet
                _write_step(host, bufs, layout, self.directory, step,
                            extra_meta, t0, commit=self._commit)
                self._gc()
            except BaseException as e:
                # never swallowed: parked with the step number and raised
                # by the NEXT save()/wait() as CheckpointWriteError
                self.last_error = e
                self.last_error_step = step

        self._thread = threading.Thread(
            target=work, name="checkpoint-writer", daemon=True)
        self._thread.start()
        self.saves += 1
        self.last_stall_s = time.perf_counter() - t0
        self.stall_s += self.last_stall_s

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            step, self.last_error_step = self.last_error_step, None
            raise CheckpointWriteError(step, err) from err

    def close(self) -> None:
        """Join the in-flight save and drop the snapshot buffers."""
        self.wait()
        self._snapshot.release()

    def _gc(self):
        steps = available_steps(self.directory)
        for s in steps[:-self.keep]:
            _trip(CKPT_GC)          # about to retire a durable step
            shutil.rmtree(_step_dir(self.directory, s), ignore_errors=True)
