"""Training step builders and the train state's transfer policy.

The port's counterpart of ``repro/runtime/train.py``, on one device:

``make_train_step``     — gradients of ``api.loss_fn`` by autograd, an
                          optional micro-batch loop (gradients summed in
                          float32, then averaged), the optimizer update.
``make_dp_train_step``  — the explicit data-parallel step whose gradient
                          collective is the paper's transfer-scheme choice:
                          ``pertensor`` (one collective per gradient leaf),
                          ``arena`` (gradients packed into per-dtype
                          buckets on the device, one collective per
                          bucket), optionally int8 + error feedback.  At
                          dp 1, the only degree ported, every collective is
                          the identity, so the three agree with the plain
                          step up to the compression.

Both are functional: a step returns a new state and writes none of its
arguments in place.  Gradients are taken with ``torch.autograd.grad`` on
``detach().requires_grad_()`` aliases of the param leaves, so a param that
is a view of a retained transfer bucket (a restored state) is read, never
written, and its bucket's write count does not move.  A batch is numpy or
tensors; the step moves it to the params' device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..core import engine as engine_lib
from ..core.deepcopy import ShapeDtype
from ..core.spec import TransferSpec
from ..core.treepath import tree_flatten, tree_leaves, tree_map, tree_unflatten
from ..models.registry import ModelApi
from ..optim import compression
from ..optim.optimizers import Optimizer

F32 = torch.float32


def train_state(api: ModelApi, optimizer: Optimizer,
                generator: torch.Generator,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Fresh params drawn from ``generator`` on ``device`` (the card
    unless ``"cpu"``; the generator must live there), the optimizer's
    initial state and a 0-d int32 step counter."""
    dev = resolve_device(device)
    params = api.init(generator, device=dev)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def abstract_train_state(api: ModelApi, optimizer: Optimizer
                         ) -> Dict[str, Any]:
    """The train state's shapes and dtypes without data
    (:class:`~repro_torch.core.deepcopy.ShapeDtype` leaves): the params',
    the optimizer state's and a 0-d int32 step."""
    params = api.abstract()
    return {"params": params, "opt": optimizer.abstract(params),
            "step": ShapeDtype((), torch.int32)}


def _device_of(tree: Any) -> torch.device:
    return tree_leaves(tree)[0].device


def _batch_on(batch: Dict[str, Any], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def value_and_grad(loss_fn: Callable, params: Any, batch: Any
                   ) -> Tuple[torch.Tensor, Dict[str, Any], Any]:
    """``(loss, metrics), grads`` of ``loss_fn(params, batch)`` with
    respect to every param leaf, in the leaf's dtype (zeros for a leaf the
    loss does not reach).  Nothing of ``params`` is written."""
    leaves, treedef = tree_flatten(params)
    alias = [leaf.detach().requires_grad_() for leaf in leaves]
    with torch.enable_grad():
        loss, metrics = loss_fn(treedef.unflatten(alias), batch)
        grads = torch.autograd.grad(loss, alias, allow_unused=True)
    grads = [torch.zeros_like(a) if g is None else g
             for a, g in zip(alias, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            treedef.unflatten(grads))


def _grad_norm(grads: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                          for g in tree_leaves(grads)))


def make_train_step(api: ModelApi, optimizer: Optimizer,
                    lr_schedule: Callable) -> Callable:
    """``train_step(state, batch) -> (new_state, {"loss", "lr",
    "grad_norm"})``.  With ``cfg.micro_batches = m > 1`` the batch is split
    into m equal slices along its first axis, each slice's gradients are
    summed in float32 and the sum divided by m; the loss is the slices'
    mean."""
    m = api.cfg.micro_batches

    def train_step(state, batch):
        params = state["params"]
        batch = _batch_on(batch, _device_of(params))
        if m > 1:
            treedef = tree_flatten(params)[1]
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                  device=p.device), params)
            lsum = torch.zeros((), dtype=F32, device=_device_of(params))
            for i in range(m):
                mb = {k: v.reshape((m, v.shape[0] // m) + v.shape[1:])[i]
                      for k, v in batch.items()}
                loss, _, g = value_and_grad(api.loss_fn, params, mb)
                gsum = tree_unflatten(treedef, [
                    a + b for a, b in zip(tree_leaves(gsum), tree_leaves(g))])
                lsum = lsum + loss
            grads = tree_map(lambda g: g / m, gsum)
            loss = lsum / m
            metrics = {"loss": loss}
        else:
            loss, metrics, grads = value_and_grad(api.loss_fn, params, batch)
        lr = lr_schedule(state["step"])
        new_params, new_opt = optimizer.update(grads, state["opt"], params,
                                               lr)
        out = {"loss": metrics.get("loss", loss), "lr": lr,
               "grad_norm": _grad_norm(grads)}
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}, out)

    return train_step


# ---------------------------------------------------------------------------
# the explicit data-parallel step: the schemes as collective schedules
# ---------------------------------------------------------------------------

def _check_dp(dp_size: int) -> int:
    dp_size = int(dp_size)
    if dp_size < 1:
        raise ValueError(f"dp_size must be >= 1, got {dp_size}")
    if dp_size > 1:
        raise NotImplementedError(
            f"data parallelism over {dp_size} devices (its gradient "
            f"collectives) is not yet ported to the PyTorch package; dp 1 "
            f"runs")
    return dp_size


def make_dp_train_step(api: ModelApi, optimizer: Optimizer,
                       lr_schedule: Callable, dp_size: int = 1, *,
                       grad_scheme: str = "arena",
                       compress: bool = False) -> Callable:
    """``step(state, batch, error_state) -> (new_state, {"loss", "lr"},
    new_error_state)`` with an explicit gradient collective.

    grad_scheme:
      ``pertensor``  one all-reduce per gradient leaf (the per-leaf deep
                     copy);
      ``arena``      gradients packed into per-dtype buckets planned by
                     :func:`grad_arena_spec` (128-element aligned), one
                     reduce-scatter + all-gather per bucket;
    compress=True    int8 + error feedback on the arena payload with one
                     shared per-chunk scale (arena only).

    At dp 1 every collective (sum, max, reduce-scatter, all-gather) is the
    identity; the packing, the compression and the error feedback run as
    in the reference.  ``dp_size > 1`` raises ``NotImplementedError``."""
    if compress and grad_scheme != "arena":
        raise ValueError("compression requires the arena scheme")
    if grad_scheme not in ("pertensor", "arena"):
        raise ValueError(f"unknown grad_scheme {grad_scheme!r}")
    grad_spec = grad_arena_spec(_check_dp(dp_size))

    def grad_sync(grads, error_state):
        if grad_scheme == "pertensor":
            return grads, error_state       # one identity all-reduce a leaf
        layout = engine_lib.get_session().plan(grads, grad_spec)
        buffers = engine_lib.pack_traced(grads, layout)
        if not compress:
            # reduce-scatter + all-gather per bucket: identities at dp 1
            return engine_lib.unpack_traced(buffers, layout), error_state
        C = compression.CHUNK
        synced, new_err = {}, {}
        for bucket, buf in buffers.items():
            if bucket not in error_state:
                synced[bucket] = buf
                continue
            n = buf.shape[0]
            corrected = compression._pad_to(buf.to(F32), C) \
                + error_state[bucket]
            chunks = corrected.reshape(-1, C)
            scale = chunks.abs().amax(dim=1) / 127.0 + 1e-12
            q = torch.clamp(torch.round(chunks / scale[:, None]), -127, 127)
            qsum = q.to(torch.int32)        # the int8 all-reduce
            out = (qsum.to(F32) * scale[:, None]).reshape(-1)
            synced[bucket] = out[:n].to(buf.dtype)
            new_err[bucket] = (chunks - q * scale[:, None]).reshape(-1)
        return engine_lib.unpack_traced(synced, layout), new_err

    def step_fn(state, batch, error_state):
        params = state["params"]
        batch = _batch_on(batch, _device_of(params))
        loss, _, grads = value_and_grad(api.loss_fn, params, batch)
        grads, error_state = grad_sync(grads, error_state)
        lr = lr_schedule(state["step"])
        new_params, new_opt = optimizer.update(grads, state["opt"], params,
                                               lr)
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}, {"loss": loss, "lr": lr},
                error_state)

    return step_fn


def grad_arena_spec(dp_size: int = 1) -> TransferSpec:
    """The gradient arena's policy point: one spec shared by the dp train
    step and the error-feedback state so their plans are the same session
    cache entry."""
    return TransferSpec("marshal", align_elems=128, sharding=int(dp_size))


def state_transfer_policy(dp_size: int = 1):
    """The train state's placement policy as ONE path-scoped policy:
    params in the 128-aligned arena the gradient collective also uses,
    optimizer state moved incrementally (delta: after a restore or a
    host-side edit only the touched buckets re-ship), everything else
    (step counters, metadata) plainly marshalled."""
    from ..core.policy import TransferPolicy

    return TransferPolicy.parse(
        f"params/**=marshal+align128@dp{int(dp_size)}; "
        "opt/**=marshal+delta; **=marshal")


def replicate_state(state: Any, num_devices: int) -> Any:
    """The elastic-restore hand-off onto ``num_devices`` devices: the
    identity on one device (the staged tree is already one consistent
    placement); more devices raise ``NotImplementedError`` until
    multi-device training is ported."""
    if num_devices <= 1:
        return state
    raise NotImplementedError(
        f"replicating the train state over {num_devices} devices is not yet "
        f"ported to the PyTorch package")


def compile_state_program(state: Dict[str, Any], dp_size: int = 1,
                          session=None, device: DeviceLike = None):
    """Compile the state policy against a concrete train-state tree for
    ``device`` (the card unless ``"cpu"``) — the single program
    ``runtime.loop`` stages restored checkpoints through."""
    session = session if session is not None else engine_lib.get_session()
    return session.compile(state, state_transfer_policy(dp_size),
                           device=device)


class StatePrefetcher:
    """Step-level state prefetch over a compiled TransferProgram.

    :meth:`schedule` packs and enqueues the host state's (dirty) buckets
    at once (``TransferProgram.to_device_async``); :meth:`take`
    materializes the staged device tree when the step needs it, waiting
    only the residual copy.  Pass ``dirty_paths`` to re-ship only the
    buckets a host-side mutator touched in delta regions."""

    def __init__(self, program):
        self.program = program
        self._future = None

    @property
    def scheduled(self) -> bool:
        return self._future is not None

    def schedule(self, host_state: Any, *dirty_paths: str):
        """Begin staging ``host_state`` (only ``dirty_paths``' buckets for
        delta regions, everything if none given); returns the future."""
        if dirty_paths:
            self.program.mark_dirty(host_state, *dirty_paths)
        self._future = self.program.to_device_async(host_state)
        return self._future

    def take(self) -> Any:
        """The staged device tree for the step about to run."""
        if self._future is None:
            raise RuntimeError("StatePrefetcher.take() with nothing "
                               "scheduled — call schedule() first")
        future, self._future = self._future, None
        return future.result()


def init_error_state(api: ModelApi, compress: bool, dp_size: int = 1,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """Zero error-feedback buffers, one per gradient bucket, padded to
    whole compression chunks, on ``device`` (the card unless ``"cpu"``);
    empty without compression."""
    if not compress:
        return {}
    dev = resolve_device(device)
    layout = engine_lib.get_session().plan(api.abstract(),
                                           grad_arena_spec(_check_dp(dp_size)))
    pad = lambda n: -(-n // compression.CHUNK) * compression.CHUNK
    return {b: torch.zeros((pad(n),), dtype=F32, device=dev)
            for b, n in layout.bucket_sizes.items()}
