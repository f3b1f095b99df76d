"""Fault-tolerant training loop.

The port's counterpart of ``repro/runtime/loop.py``:

  * periodic **async marshalled checkpoints** with atomic commit + GC
    (:class:`~repro_torch.checkpoint.AsyncCheckpointer`),
  * **auto-restart**: on :class:`NodeFailure` the loop restores the latest
    checkpoint and resumes at its step with the deterministic data stream
    replayed; a restore stages the whole state through ONE compiled
    TransferProgram when a ``state_policy`` is given (params, optimizer
    state and metadata each under their own spec, one synchronize),
  * a **stale state policy** (derived for another mesh than the live one)
    is re-derived with ``TransferPolicy.reshard``, at restore and when a
    mesh change is observed mid-run,
  * **straggler watchdog**: per-step wall-time outlier flags.

The loop runs on ``device`` (the card unless ``"cpu"``); the live mesh is
``torch.cuda.device_count()`` cards there and one device on the CPU, or
the positions of a mesh given as a sequence of devices (``(cpu,) * 4``,
``(cuda:0,) * 4``).  A restore onto m > 1 positions replicates the staged
state over them (``runtime.train.replicate_state``), and the step runs on
every copy.  A step's wall ends when its loss is read on the host.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..checkpoint import AsyncCheckpointer, latest_step, load, restore
from ..core.sharded import MeshLike, live_mesh, to_host
from ..core.treepath import tree_map
from . import faults as faults_lib


class NodeFailure(RuntimeError):
    """Raised by the failure injector to simulate a lost node/pod."""


class RestoreError(RuntimeError):
    """A checkpoint restored cleanly but cannot resume THIS loop: its state
    schema does not match what the loop needs."""


def _restored_step(host: Any) -> int:
    """The resume step of a restored state tree, validated: a missing or
    non-scalar ``step`` is a schema mismatch, named as such."""
    if not isinstance(host, dict) or "step" not in host:
        restored = (f"available keys: {sorted(host)}" if isinstance(host, dict)
                    else f"restored a {type(host).__name__}, not a dict")
        raise RestoreError(
            f"checkpoint/state schema mismatch: the restored state has no "
            f"'step' entry ({restored}); the checkpoint was written from a "
            f"different state schema — run metadata belongs in extra_meta, "
            f"which does not restore into the state tree")
    try:
        arr = np.asarray(to_host(host["step"]))
        if arr.size != 1:
            raise ValueError(f"shape {arr.shape} is not a scalar")
        return int(arr.reshape(-1)[0])
    except (TypeError, ValueError) as e:
        raise RestoreError(
            f"checkpoint/state schema mismatch: 'step' must restore as a "
            f"scalar step counter, got {host['step']!r} ({e})") from e


@dataclasses.dataclass
class StragglerWatchdog:
    """Flags steps slower than mean + k*std over a sliding window."""

    window: int = 50
    k_sigma: float = 3.0
    times: List[float] = dataclasses.field(default_factory=list)
    flagged: List[int] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        ts = self.times[-self.window:]
        is_straggler = False
        if len(ts) >= 10:
            mu, sd = float(np.mean(ts)), float(np.std(ts))
            if dt > mu + self.k_sigma * max(sd, 1e-9) and dt > 1.5 * mu:
                is_straggler = True
                self.flagged.append(step)
        self.times.append(dt)
        return is_straggler


@dataclasses.dataclass
class TrainLoopResult:
    state: Any
    metrics_history: List[Dict[str, float]]
    restarts: int
    straggler_steps: List[int]
    ckpt_stall_s: float = 0.0   # total caller-visible checkpoint save cost
    ckpt_saves: int = 0
    policy_reshards: int = 0    # stale state policies re-derived
    # one dict per restore (phase "restore") or mid-run mesh change (phase
    # "run"): {step, policy, resharded, load_s, reshard_s, h2d_s, phase}
    restore_splits: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)


def live_devices(device: torch.device) -> int:
    """The live mesh size: the visible cards, or 1 on the CPU."""
    return 1 if device.type == "cpu" else torch.cuda.device_count()


def run(train_step: Callable, init_state_fn: Callable[[], Any],
        data_fn: Callable[[int], Dict[str, Any]], num_steps: int, *,
        ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
        failure_injector: Optional[Callable[[int], None]] = None,
        max_restarts: int = 3,
        state_shardings: Optional[Any] = None,
        state_policy: Optional[Any] = None,
        mesh_size: Optional[Any] = None,
        watchdog: Optional[StragglerWatchdog] = None,
        log_every: int = 0,
        device: MeshLike = None) -> TrainLoopResult:
    """Run ``num_steps`` of training with checkpoint/restart semantics.

    ``state_policy`` (a :class:`~repro_torch.core.TransferPolicy` or policy
    string, e.g. ``runtime.train.state_transfer_policy()``) stages
    restored checkpoints host -> device as ONE compiled TransferProgram
    through a :class:`~repro_torch.runtime.train.StatePrefetcher`; without
    it a restore moves the tree leaf by leaf.  ``mesh_size`` is the
    surviving mesh's device count (default: :func:`live_devices`), an int
    or a zero-arg callable polled every step; a policy derived for a
    different mesh is re-derived (``result.policy_reshards``).  Each
    restore's wall is split into load (disk -> host) / reshard (policy
    re-derivation + program compile) / h2d (program pass and the
    replication onto the survivors) in
    ``result.restore_splits``.  ``state_shardings`` (a tree of
    :class:`~repro_torch.core.placement.Placement`s, as
    ``launch.mesh.tree_shardings`` gives them) restores through
    ``checkpoint.restore(shardings=)`` instead, every leaf in its blocks
    on the mesh; it is exclusive with ``state_policy``."""
    if isinstance(device, (list, tuple)):
        mesh = tuple(resolve_device(d) for d in device)
        dev, n_live = mesh[0], len(mesh)
    else:
        dev = resolve_device(device)
        mesh, n_live = live_mesh(dev), live_devices(dev)
    if state_policy is not None and state_shardings is not None:
        raise ValueError("state_policy and state_shardings are exclusive")
    watchdog = watchdog or StragglerWatchdog()
    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    restarts = 0
    policy_reshards = 0
    restore_splits: List[Dict[str, Any]] = []
    history: List[Dict[str, float]] = []

    def observe_mesh() -> Optional[int]:
        return mesh_size() if callable(mesh_size) else mesh_size

    mesh_now = observe_mesh()

    def compile_restore_program(host):
        """Compile the state policy for the surviving mesh, re-deriving a
        stale one instead of dying."""
        nonlocal policy_reshards
        from ..core import TransferPolicy, UnsupportedSpecError, get_session

        policy = TransferPolicy.parse(state_policy)
        resharded = False
        k = mesh_now if mesh_now is not None else n_live
        if policy.num_shards > 1 and policy.num_shards != k:
            policy, resharded = policy.reshard(max(1, k)), True
            policy_reshards += 1
        try:
            return (policy, get_session().compile(host, policy,
                                                device=mesh),
                    resharded)
        except (UnsupportedSpecError, NotImplementedError):
            survivors = max(1, min(k, n_live))
            if policy.num_shards <= survivors:
                raise      # not a stale-mesh failure; don't mask it
            policy = policy.reshard(survivors)
            policy_reshards += 1
            return (policy, get_session().compile(host, policy,
                                                device=mesh),
                    True)

    def fresh_or_restored():
        if not (ckpt_dir and latest_step(ckpt_dir) is not None):
            return init_state_fn(), 0
        from .train import StatePrefetcher, replicate_state

        t0 = time.perf_counter()
        if state_shardings is not None:
            # the checkpoint layer places every leaf in its blocks
            state = restore(ckpt_dir, shardings=state_shardings)
            step0 = _restored_step(state)
            restore_splits.append(dict(
                step=step0, policy="", resharded=False,
                load_s=time.perf_counter() - t0, reshard_s=0.0, h2d_s=0.0,
                phase="restore"))
            return state, step0
        host = load(ckpt_dir)
        step0 = _restored_step(host)
        t_load = time.perf_counter() - t0
        if state_policy is not None:
            # a fresh program per restore (a cold pass): the session's
            # caches make recompiling cheap, and the whole state stages
            # behind ONE synchronize
            t1 = time.perf_counter()
            policy, program, resharded = compile_restore_program(host)
            t_reshard = time.perf_counter() - t1
            t2 = time.perf_counter()
            prefetch = StatePrefetcher(program)
            prefetch.schedule(host)
            faults_lib.trip(faults_lib.RESTORE_H2D)   # mid-restore kill point
            state = replicate_state(prefetch.take(), policy.num_shards,
                                    device=mesh)
            restore_splits.append(dict(
                step=step0, policy=str(policy), resharded=resharded,
                load_s=t_load, reshard_s=t_reshard,
                h2d_s=time.perf_counter() - t2, phase="restore"))
        else:
            t2 = time.perf_counter()
            state = tree_map(lambda t: t.to(dev), host)
            restore_splits.append(dict(
                step=step0, policy="", resharded=False, load_s=t_load,
                reshard_s=0.0, h2d_s=time.perf_counter() - t2,
                phase="restore"))
        return state, step0

    def on_mesh_change(state: Any, step: int, observed: Optional[int]) -> Any:
        """A mesh change observed mid-run: re-derive the state policy (so
        later restores compile for the live mesh) and re-place the state
        on the survivors — a copy, so the trajectory is unchanged."""
        nonlocal policy_reshards, state_policy
        from ..core import TransferPolicy
        from .train import replicate_state

        t1 = time.perf_counter()
        k = observed if observed is not None else n_live
        survivors = max(1, min(k, n_live))
        resharded = False
        if state_policy is not None:
            policy = TransferPolicy.parse(state_policy)
            if policy.num_shards > 1 and policy.num_shards != survivors:
                state_policy = policy.reshard(survivors)
                policy_reshards += 1
                resharded = True
        t2 = time.perf_counter()
        state = replicate_state(state, survivors, device=mesh)
        restore_splits.append(dict(
            step=step, policy=str(state_policy or ""), resharded=resharded,
            load_s=0.0, reshard_s=t2 - t1,
            h2d_s=time.perf_counter() - t2, phase="run"))
        return state

    state, step = fresh_or_restored()
    while step < num_steps:
        try:
            observed = observe_mesh()
            if observed != mesh_now:
                state = on_mesh_change(state, step, observed)
                mesh_now = observed
            t0 = time.perf_counter()
            if failure_injector is not None:
                failure_injector(step)
            batch = data_fn(step)
            state, metrics = train_step(state, batch)
            # the step boundary: reading the metrics waits for the step
            rec = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            straggler = watchdog.observe(step, dt)
            rec.update(step=step, wall_s=dt, straggler=float(straggler))
            history.append(rec)
            if log_every and step % log_every == 0:
                print(f"step {step:6d} loss {rec.get('loss', float('nan')):.4f} "
                      f"({dt*1e3:.1f} ms)")
            step += 1
            if ckpt and step % ckpt_every == 0:
                ckpt.save(state, step)  # snapshot queued, written off-thread
                rec["ckpt_stall_s"] = ckpt.last_stall_s
        except NodeFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            if ckpt:
                ckpt.wait()
            state, step = fresh_or_restored()
    if ckpt:
        ckpt.save(state, step)
        ckpt.close()
    return TrainLoopResult(state, history, restarts, watchdog.flagged,
                           ckpt_stall_s=(ckpt.stall_s if ckpt else 0.0),
                           ckpt_saves=(ckpt.saves if ckpt else 0),
                           policy_reshards=policy_reshards,
                           restore_splits=restore_splits)
