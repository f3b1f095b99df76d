"""Training step builders and the train state's transfer policy.

The port's counterpart of ``repro/runtime/train.py``:

``make_train_step``     — gradients of ``api.loss_fn`` by autograd, an
                          optional micro-batch loop (gradients summed in
                          float32, then averaged), the optimizer update; a
                          replicated state steps on every position.
``make_dp_train_step``  — the explicit data-parallel step whose gradient
                          collective is the paper's transfer-scheme choice:
                          ``pertensor`` (one all-reduce per gradient leaf),
                          ``arena`` (gradients packed into per-dtype
                          buckets on the device, one reduce-scatter and
                          one all-gather per bucket), optionally int8 +
                          error feedback.  It runs single-controller over
                          a mesh of K positions (``launch/mesh.py``), its
                          collectives those of ``core/collectives.py``; at
                          dp 1 every collective is the identity.
``make_sharded_train_step`` — the production-mesh step: the state in 2-D
                          placements on a named mesh (the reference's
                          jitted step under ``tree_shardings``), params
                          gathered, every family tensor-parallel over
                          the model axis (the MoE's per-expert d_ff, the
                          Mamba2 mixers' heads, the encoder-decoder's
                          self- and cross-attentions),
                          gradients summed over the
                          batch axes, each position updating its own
                          blocks (:class:`ShardedTrainStep`).

All are functional: a step returns a new state and writes none of its
arguments in place.  Gradients are taken with ``torch.autograd.grad`` on
``detach().requires_grad_()`` aliases of the param leaves, so a param that
is a view of a retained transfer bucket (a restored state) is read, never
written, and its bucket's write count does not move.  A batch is numpy or
tensors; the step moves it (or each position's slice) to the params'
device.  ``replicate_state`` places a state on K positions, one real copy
each.
"""
from __future__ import annotations

import contextlib
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import torch

from .._device import DeviceLike, resolve_device
from ..core import collectives
from ..core import engine as engine_lib
from ..core.collectives import NamedMesh
from ..core.deepcopy import ShapeDtype
from ..core.placement import (PlacedTensor, block_of, entry_axes,
                              gather_blocks, place_tree)
from ..core.sharded import (MeshLike, ShardedTensor, replica, replica_count,
                            replicated, resolve_mesh)
from ..core.spec import TransferSpec
from ..core.treepath import tree_flatten, tree_leaves, tree_map, tree_unflatten
from ..models import tp as TP
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


def train_state_axes(api: ModelApi, optimizer: Optimizer) -> Dict[str, Any]:
    """The train state's logical axes: the params', the optimizer
    state's (``optimizer.axes``) and ``()`` for the step."""
    axes = api.axes()
    return {"params": axes, "opt": optimizer.axes(axes), "step": ()}


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
    losses, metrics, grads = _members_value_and_grad(
        lambda ps, bs: tuple([v] for v in loss_fn(ps[0], bs[0])), [params],
        [batch])
    return losses[0], metrics[0], grads[0]


def _members_value_and_grad(fn: Callable, params: List[Any],
                            batches: List[Any]):
    """:func:`value_and_grad` over members that compute together (the
    positions of a tensor-parallel model group in lock step, or one):
    ``fn(params, batches)`` gives one loss and one metrics dict a member,
    and the backward is seeded with each loss (every member's copy of the
    loss flows back through its own graph, the group's sums joining
    them).  Returns the losses, the metrics and the gradient trees, one a
    member."""
    flat = [tree_flatten(p) for p in params]
    alias = [[leaf.detach().requires_grad_() for leaf in leaves]
             for leaves, _ in flat]
    with torch.enable_grad():
        losses, metrics = fn([d.unflatten(a)
                              for (_, d), a in zip(flat, alias)], batches)
        grads = torch.autograd.grad(
            losses, [a for al in alias for a in al],
            grad_outputs=[torch.ones_like(x) for x in losses],
            allow_unused=True)
    out, i = [], 0
    for (_, treedef), al in zip(flat, alias):
        gs = grads[i:i + len(al)]
        i += len(al)
        out.append(treedef.unflatten([torch.zeros_like(a) if g is None
                                      else g for a, g in zip(al, gs)]))
    return ([x.detach() for x in losses],
            [{k: v.detach() for k, v in mt.items()} for mt in metrics], out)


def _replicas(state: Any) -> Optional[List[Any]]:
    """Each position's copy of a replicated state; None for a plain one."""
    leaves, treedef = tree_flatten(state)
    k = replica_count(leaves)
    if not k:
        return None
    return [treedef.unflatten([replica(leaf, p) for leaf in leaves])
            for p in range(k)]


def _grad_norm(grads: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                          for g in tree_leaves(grads)))


def make_train_step(api: ModelApi, optimizer: Optimizer,
                    lr_schedule: Callable) -> Callable:
    """``train_step(state, batch) -> (new_state, {"loss", "lr",
    "grad_norm"})``.  With ``cfg.micro_batches = m > 1`` the batch is split
    into m equal slices along its first axis, each slice's gradients are
    summed in float32 and the sum divided by m; the loss is the slices'
    mean.  A replicated state (:func:`replicate_state`) is stepped on every
    position's copy with the whole batch (replicated compute, as a jitted
    step on a replicated array) and comes back replicated; the metrics are
    position 0's."""
    m = api.cfg.micro_batches

    def train_step(state, batch):
        copies = _replicas(state)
        if copies is None:
            return one_step(state, batch)
        outs = [one_step(c, batch) for c in copies]
        return from_positions([o[0] for o in outs]), outs[0][1]

    def one_step(state, batch):
        params = state["params"]
        batch = _batch_on(batch, _device_of(params))
        (loss, grads), = loss_and_grads(api, [params], [batch])
        lr = lr_schedule(state["step"])
        new_params, new_opt = optimizer.update(grads, state["opt"], params,
                                               lr)
        out = {"loss": loss, "lr": lr, "grad_norm": _grad_norm(grads)}
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}, out)

    return train_step


def loss_and_grads(api: ModelApi, params: List[Any],
                   batches: List[Dict[str, Any]],
                   weights: Optional[List[torch.Tensor]] = None,
                   aux_weight: float = 0.0, group: Any = None
                   ) -> List[Tuple[torch.Tensor, Any]]:
    """The loss and the gradients of a batch on each member that computes
    it: one position (``group`` None: ``params`` and ``batches`` hold one
    entry) or the computed members of a model's tensor-parallel model
    group in lock step (``models/tp.py``: one entry a member, the
    same rows on each).  Returns each member's (loss, gradients): under a
    group its copy of the loss and its blocks of the split leaves'
    gradients, the other leaves' whole.

    Under the config's micro-batch loop, with ``micro_batches = m > 1``
    the batch splits into m equal slices along its first axis, the slices'
    gradients are summed in float32 and divided by m, and the loss is the
    slices' mean.

    With ``weights`` (one a member, m values each) the objective is
    instead the sum over the slices of ``weights[j]`` x slice j's
    cross-entropy (``loss_fn``'s ``"loss"``) plus ``aux_weight`` x what
    the model adds to it (its first value less the cross-entropy: 0.01 x
    the MoE aux loss), and nothing is divided by m.  The loss returned is
    then the weighted cross-entropy at m = 1 and the objective at
    m > 1."""
    m = max(1, api.cfg.micro_batches)
    if group is None and len(params) != 1:
        raise ValueError(f"{len(params)} members without a model group")

    def loss_fn(ps, bs):
        if group is not None:
            return api.loss_fn(ps, bs, group=group)
        return tuple([v] for v in api.loss_fn(ps[0], bs[0]))

    def fn(j):
        if weights is None:
            return loss_fn

        def weighted(ps, bs):
            totals, metrics = loss_fn(ps, bs)
            return [w[j] * mt["loss"] + aux_weight * (t - mt["loss"])
                    for w, t, mt in zip(weights, totals, metrics)], metrics
        return weighted

    if m == 1:
        losses, metrics, grads = _members_value_and_grad(fn(0), params,
                                                         batches)
        if weights is None:
            return [(mt.get("loss", x), g)
                    for x, mt, g in zip(losses, metrics, grads)]
        return [(w[0] * mt["loss"], g)
                for w, mt, g in zip(weights, metrics, grads)]
    treedef = tree_flatten(params[0])[1]
    gsum = [tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                           device=p.device), ps)
            for ps in params]
    lsum = [torch.zeros((), dtype=F32, device=_device_of(ps))
            for ps in params]
    for i in range(m):
        mbs = [{k: v.reshape((m, v.shape[0] // m) + v.shape[1:])[i]
                for k, v in b.items()} for b in batches]
        losses, _, gs = _members_value_and_grad(fn(i), params, mbs)
        gsum = [tree_unflatten(treedef, [
            a + b for a, b in zip(tree_leaves(s), tree_leaves(g))])
            for s, g in zip(gsum, gs)]
        lsum = [a + x for a, x in zip(lsum, losses)]
    if weights is not None:
        return list(zip(lsum, gsum))
    return [(x / m, tree_map(lambda t: t / m, g)) for x, g in zip(lsum, gsum)]


# ---------------------------------------------------------------------------
# the explicit data-parallel step: the schemes as collective schedules
# ---------------------------------------------------------------------------

def _check_dp(dp_size: int) -> int:
    dp_size = int(dp_size)
    if dp_size < 1:
        raise ValueError(f"dp_size must be >= 1, got {dp_size}")
    return dp_size


def dp_mesh(dp_size: Union[int, NamedMesh] = 1,
            device: MeshLike = None) -> Optional[NamedMesh]:
    """The mesh a dp step runs on: ``dp_size`` itself when it is a
    :class:`NamedMesh` (it needs a ``data`` axis), else a (dp, 1) mesh over
    ``dp_size`` positions of ``device`` (``"cpu"``, a sequence of devices,
    or the default mesh ``cuda:0 ... cuda:dp-1``; a shorter mesh raises
    the stale-mesh ``ValueError``).  None at dp 1 without a device: the
    step then runs where the state lives."""
    if isinstance(dp_size, NamedMesh):
        if "data" not in dp_size.axis_names:
            raise ValueError(f"a dp mesh needs a 'data' axis: {dp_size!r}")
        return dp_size
    dp = _check_dp(dp_size)
    if dp == 1 and device is None:
        return None
    from ..launch.mesh import make_debug_mesh
    return make_debug_mesh(data=dp, model=1, device=device)


def _one_position(tree: Any) -> NamedMesh:
    return NamedMesh((_device_of(tree),), (1, 1), ("data", "model"))


def per_position(tree: Any, mesh: NamedMesh) -> List[Any]:
    """``tree`` as each position of ``mesh`` holds it: a replicated leaf's
    copy on that position, a plain leaf moved to the position's device
    (not copied where it already lies)."""
    leaves, treedef = tree_flatten(tree)
    k = mesh.size
    out = []
    for p, dev in enumerate(mesh.positions):
        mine = []
        for leaf in leaves:
            if isinstance(leaf, ShardedTensor):
                if len(leaf.pieces) != k:
                    raise ValueError(
                        f"a leaf replicated over {len(leaf.pieces)} "
                        f"positions on a {k}-position mesh")
                mine.append(replica(leaf, p))
            else:
                mine.append(torch.as_tensor(leaf).to(dev))
        out.append(treedef.unflatten(mine))
    return out


def from_positions(trees: Sequence[Any]) -> Any:
    """K per-position trees as one replicated tree (one tree as itself)."""
    if len(trees) == 1:
        return trees[0]
    leaves = [tree_leaves(t) for t in trees]
    treedef = tree_flatten(trees[0])[1]
    return treedef.unflatten([replicated(copies) for copies in zip(*leaves)])


def _split_batch(batch: Dict[str, Any], mesh: NamedMesh,
                 axes: Any = "data") -> List[Dict[str, torch.Tensor]]:
    """The global batch split along dim 0 over ``axes`` (the reference's
    ``P("data")`` by default; no axes: the whole batch on every
    position), each position's slice on its device."""
    n = mesh.axis_size(axes)
    out = []
    for p, dev in enumerate(mesh.positions):
        i = mesh.index(p, axes)
        part = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if t.shape[0] % n:
                raise ValueError(f"batch {k!r} of {t.shape[0]} rows does not "
                                 f"split over a data axis of {n}")
            rows = t.shape[0] // n
            part[k] = t[i * rows:(i + 1) * rows].to(dev)
        out.append(part)
    return out


def sync_gradients(grads: List[Any], errors: List[Dict[str, torch.Tensor]],
                   mesh: NamedMesh, grad_scheme: str, compress: bool
                   ) -> Tuple[List[Any], List[Dict[str, torch.Tensor]]]:
    """The dp step's gradient collective over the mesh's ``data`` axis:
    each position's gradient tree in, each position's synced tree (the
    sum over the axis, as in the reference) and error-feedback buffers
    out.  ``pertensor``: one all-reduce a leaf.  ``arena``: the leaves
    packed by :func:`grad_arena_spec`'s plan, one reduce-scatter and one
    all-gather a bucket over the per-position ranges the plan pads to;
    with ``compress`` a ``pmax`` of each chunk's scale, an int32 all-reduce
    of the int8 payload and the residual into the error buffers.  The
    lists are consumed: each local gradient and old error buffer is
    released as soon as it is used, and the compression runs position by
    position, so one position's float32 temporaries are alive at a
    time."""
    k = mesh.size
    if grad_scheme == "pertensor":
        leaves = [tree_flatten(g)[0] for g in grads]
        treedef = tree_flatten(grads[0])[1]
        grads[:] = [None] * k
        synced: List[List[torch.Tensor]] = [[] for _ in range(k)]
        for i in range(len(leaves[0])):
            out = collectives.psum([leaves[p][i] for p in range(k)], mesh,
                                   "data")
            for p in range(k):
                leaves[p][i] = None
                synced[p].append(out[p])
        return [treedef.unflatten(s) for s in synced], errors
    layout = engine_lib.get_session().plan(
        grads[0], grad_arena_spec(mesh.shape["data"]))
    buffers = [engine_lib.pack_traced(g, layout) for g in grads]
    grads[:] = [None] * k
    out_bufs: List[Dict[str, torch.Tensor]] = [{} for _ in range(k)]
    new_err: List[Dict[str, torch.Tensor]] = [{} for _ in range(k)]
    C = compression.CHUNK
    for bucket in layout.bucket_sizes:
        bufs = [b.pop(bucket) for b in buffers]
        if not compress:
            parts = collectives.psum_scatter(bufs, mesh, "data")
            del bufs
            synced_b = collectives.all_gather(parts, mesh, "data")
        elif bucket not in errors[0]:
            synced_b = collectives.psum(bufs, mesh, "data")
        else:
            n, dtype = bufs[0].shape[0], bufs[0].dtype

            def corrected(p):
                return (compression._pad_to(bufs[p].to(F32), C)
                        + errors[p][bucket]).reshape(-1, C)

            scale = collectives.pmax(
                [corrected(p).abs().amax(dim=1) for p in range(k)], mesh,
                "data")
            scale = [s / 127.0 + 1e-12 for s in scale]
            payload = []
            for p in range(k):
                chunks = corrected(p)
                q = torch.clamp(torch.round(chunks / scale[p][:, None]),
                                -127, 127)
                new_err[p][bucket] = (chunks - q * scale[p][:, None]
                                      ).reshape(-1)
                payload.append(q.to(torch.int32))
                del chunks, q
                bufs[p] = None
                errors[p].pop(bucket)
            qsum = collectives.psum(payload, mesh, "data")
            del payload
            synced_b = []
            for p in range(k):
                synced_b.append((qsum[p].to(F32) * scale[p][:, None])
                                .reshape(-1)[:n].to(dtype))
                qsum[p] = None
        for p in range(k):
            out_bufs[p][bucket] = synced_b[p]
    if compress:
        errors = new_err
    return ([engine_lib.unpack_traced(b, layout) for b in out_bufs],
            errors)


def make_dp_train_step(api: ModelApi, optimizer: Optimizer,
                       lr_schedule: Callable,
                       dp_size: Union[int, NamedMesh] = 1, *,
                       device: MeshLike = None,
                       grad_scheme: str = "arena",
                       compress: bool = False) -> Callable:
    """``step(state, batch, error_state) -> (new_state, {"loss", "lr"},
    new_error_state)``: replicated-params data parallelism with an explicit
    gradient collective, single-controller over a mesh (:func:`dp_mesh`:
    ``dp_size`` positions of ``device``, or a :class:`NamedMesh` with a
    ``data`` axis, as the reference's ``mesh`` argument).

    grad_scheme:
      ``pertensor``  one all-reduce per gradient leaf (the per-leaf deep
                     copy);
      ``arena``      gradients packed into per-dtype buckets planned by
                     :func:`grad_arena_spec`, one reduce-scatter + one
                     all-gather per bucket (marshalling on the wire);
    compress=True    int8 + error feedback on the arena payload with one
                     shared per-chunk scale (arena only).

    The global batch splits along dim 0 over the ``data`` axis; each
    position takes the gradient of its own copy of the params on its
    slice, the gradients are summed over the axis (not averaged, as in the
    reference) by :func:`sync_gradients`, the loss is the ``pmean``, and
    each position applies the update to its own copy, dropping its
    references to that position's old state once it is updated (a caller
    that hands over its only references to the state and the error state
    then holds one state and one position's update at a time, not two
    states).  On a mesh of K > 1
    positions the state and the error buffers come back replicated
    (:func:`~repro_torch.core.sharded.replicated`, every position's params
    and optimizer state equal bit for bit; each position keeps its own
    error buffers, as the reference's unchecked replicated outputs do); a
    plain state is accepted and moved to every position.  The metrics are
    position 0's (every position's loss is the same pmean)."""
    if compress and grad_scheme != "arena":
        raise ValueError("compression requires the arena scheme")
    if grad_scheme not in ("pertensor", "arena"):
        raise ValueError(f"unknown grad_scheme {grad_scheme!r}")
    fixed = dp_mesh(dp_size, device)

    def step_fn(state, batch, error_state):
        mesh = fixed or _one_position(state["params"])
        states = per_position(state, mesh)
        batches = _split_batch(batch, mesh)
        errors = per_position(error_state, mesh)
        del state, error_state     # the positions' trees hold the leaves
        losses, grads = [], []
        for st, b in zip(states, batches):
            loss, _, g = value_and_grad(api.loss_fn, st["params"], b)
            losses.append(loss)
            grads.append(g)
        grads, errors = sync_gradients(grads, errors, mesh, grad_scheme,
                                       compress)
        loss = collectives.pmean(losses, mesh, "data")
        out, lrs = [], []
        for p in range(mesh.size):
            st, states[p] = states[p], None
            lr = lr_schedule(st["step"])
            new_params, new_opt = optimizer.update(grads[p], st["opt"],
                                                   st["params"], lr)
            grads[p] = None
            out.append({"params": new_params, "opt": new_opt,
                        "step": st["step"] + 1})
            lrs.append(lr)
            del st, new_params, new_opt
        return (from_positions(out), {"loss": loss[0], "lr": lrs[0]},
                {b: from_positions([e[b] for e in errors])
                 for b in errors[0]})

    return step_fn


# ---------------------------------------------------------------------------
# the production-mesh step: the state in 2-D placements on a named mesh
# ---------------------------------------------------------------------------

# optimizers whose update of a leaf is elementwise: a block's update is the
# whole leaf's update cut to the block
_ELEMENTWISE = ("adamw", "sgdm")


class ShardedTrainStep:
    """``step(state, batch) -> (new_state, {"loss", "lr", "grad_norm"})``
    on a named mesh, the state held in the placements of
    ``tree_shardings(mesh, train_state_axes(...), rules, abstract)``
    (:attr:`shardings`; a plain state is placed on the first call): the
    port's counterpart of the reference's ``jax.jit(make_train_step(...),
    in_shardings=tree_shardings(...))``.

    A step, single-controller over the mesh's positions:

      * each position gathers the params from their blocks
        (``core.collectives.all_gather``, one a sharded dim): the leaves
        the step splits over the model axis (below) over the data axes
        only, keeping its ``model`` block, the others whole;
      * each position takes the loss and gradients of its rows of the
        batch (the batch rule adapted to its size, ``adapt_batch_rule``),
        each of its micro-slices weighted so that their sum over the
        positions is the reference's masked mean (:func:`_label_weights`);
      * the weighted losses and gradients are summed over the batch axes
        with ``psum`` in position order;
      * each position updates only its own blocks of the params and the
        optimizer state (an elementwise optimizer, AdamW or SGD-momentum,
        on the blocks; another, Adafactor, on the whole leaves, the split
        ones gathered over the model axis too for it, cut to the block
        after), dropping its old blocks as it goes.

    Tensor parallelism (:attr:`tp`, ``models/tp.py``), as GSPMD
    partitions the reference's step: for every family (``dense``,
    ``vlm``, ``moe``, ``ssm``, ``hybrid``, ``encdec``), where the
    placements block ``heads`` (``wq``, ``bq``, ``wo`` of every self- and
    cross-attention), ``mlp`` (``w_gate``, ``w_up``, ``b_up``,
    ``w_down``; the hybrid's shared block's and both encdec stacks'
    too), ``vocab`` (``tok``, ``lm_head``), the experts' ``expert_mlp``
    (``moe``'s ``w_gate``, ``w_up``, ``w_down``) or the Mamba2 mixers'
    ``ssm_heads`` and ``ssm_inner`` (``wz``, ``wx``, ``wdt``,
    ``conv_*``, ``out_norm``, ``dt_bias``, ``A_log``, ``D``, ``wo``)
    over ``model``, the positions of each model group run their rows in
    lock step, each on its block of those leaves: its query heads against
    the kv heads they read (``wk`` / ``wv`` stay whole, their gradients
    summed over the group; a cross-attention's projected from the whole
    encoder memory, whose gradient is summed over the group once for the
    decoder stack), its share of d_ff (``b_down`` added once after the
    sum) and of every expert's d_ff, its share of each mixer's heads and
    their channels (``wB`` / ``wC`` whole, their gradients summed; the
    gated norm over the group's sum of squares), its vocab rows of the
    embedding and of the head's logits and cross-entropy; the norms, the
    residual streams, a vlm's patch projection and the MoE router (its
    gates and aux loss) run on every position's copy.  A region whose
    leaves do not all split (arctic's 56 heads over 16) runs whole on
    every position of the group, as does the step on a mesh without a
    ``model`` axis of 2 or more, and a batch whose rows split over
    ``model``: there the model axis replicates compute and shards only
    the state.  A position's
    blocks of a leaf the spec replicates over ``model`` stay bit-equal
    over its group when the backward is deterministic
    (``torch.use_deterministic_algorithms``: the embedding's index
    backward accumulates in a racy order otherwise).

    The cross-entropy is the reference's, however the masked labels
    (below 0) fall over the row blocks: the mean over the batch's
    ``micro_batches`` slices, in the reference's slicing, of each slice's
    masked mean, from the label counts known before any forward pass.
    The reported loss is the reference's metric: the masked mean at one
    micro-batch, the slices' mean of loss + 0.01 x aux at more.  What the
    model adds to the cross-entropy (the MoE aux loss, 0.01 x aux) is
    taken per micro-slice of a row block and averaged over them, as is
    MoE capacity, where the reference routes the global batch: a
    documented divergence.
    """

    def __init__(self, api: ModelApi, optimizer: Optimizer,
                 lr_schedule: Callable, mesh: NamedMesh,
                 rules: Optional[Dict] = None):
        from ..launch.mesh import rules_for, tree_shardings

        self.api, self.optimizer, self.lr_schedule = api, optimizer, \
            lr_schedule
        self.mesh = mesh
        self.rules = dict(rules) if rules is not None \
            else rules_for(api.cfg, mesh, "train")
        self.shardings = tree_shardings(
            mesh, train_state_axes(api, optimizer), self.rules,
            abstract_train_state(api, optimizer))
        self.tp = TP.plan(api.cfg, mesh, self.shardings["params"],
                          self.rules.get("batch"))

    def place(self, state: Any) -> Any:
        """``state`` in :attr:`shardings` (placed leaves already there are
        kept)."""
        return place_tree(state, self.shardings)

    def batch_axes(self, global_batch: int) -> Tuple[str, ...]:
        """The mesh axes the batch's rows split over at this size."""
        from ..launch.mesh import adapt_batch_rule

        rule = adapt_batch_rule(self.rules, self.mesh, global_batch)["batch"]
        return entry_axes(rule)

    def __call__(self, state: Any, batch: Dict[str, Any]):
        return self._step(state, batch, traced=False,
                          count=contextlib.nullcontext)

    def trace(self, state: Any, batch: Dict[str, Any],
              count: Callable = contextlib.nullcontext):
        """The dry run's step: the gathers and sums over every position,
        but one position's (position 0's) loss, gradients and update,
        each under ``count()``; the other positions' slots of the sums
        take position 0's gradients (on meta positions there are no
        values to differ).  Under tensor parallelism position 0's model
        group runs with position 0 alone computed, its tensor standing in
        for the other members' in the group's sums (``stand_in``), which
        count as collectives.  Returns position 0's blocks of the new
        state (a tree of tensors shaped as the state) and its metrics."""
        return self._step(state, batch, traced=True, count=count)

    def _units(self, traced: bool) -> List[Tuple[List[int], Any]]:
        """What the step computes at once, as (positions, model group):
        each position alone (no group), or the members of each model
        group in lock step (a :class:`tp.ModelGroup`); traced, position 0
        or its group with member 0 computed."""
        if self.tp is None:
            return [([p], None)
                    for p in ([0] if traced else range(self.mesh.size))]
        units = []
        for g in self.mesh.groups(TP.AXIS):
            if traced and 0 not in g:
                continue
            group = self.tp.group(self.mesh, g, stand_in=traced)
            units.append(([group.members[r] for r in group.ranks], group))
        return units

    def gathered_param_bytes(self) -> int:
        """The bytes of params one position gathers for its step: its
        blocks of the split leaves, whole over the data axes, and the
        other leaves whole."""
        return TP.gathered_param_bytes(self.api.abstract(), self.tp,
                                       self.mesh)

    def _step(self, state, batch, *, traced: bool, count: Callable):
        mesh, opt = self.mesh, self.optimizer
        k = mesh.size
        state = self.place(state)
        p_leaves, p_def = tree_flatten(state["params"])
        o_leaves, o_def = tree_flatten(state["opt"])
        step = state["step"]
        del state
        p_meta = [(x.shape, x.dtype, x.placement) for x in p_leaves]
        o_meta = [(x.shape, x.dtype, x.placement) for x in o_leaves]
        p_pl = [m[2] for m in p_meta]
        o_pl = [m[2] for m in o_meta]
        elementwise = opt.name in _ELEMENTWISE
        tp = self.tp
        keep = [tp.keep(i) if tp else () for i in range(len(p_leaves))]
        full = TP.gather_params(p_leaves, tp)
        full_opt = None if elementwise else [gather_blocks(x)
                                             for x in o_leaves]
        rows = next(iter(batch.values())).shape[0]
        axes = self.batch_axes(rows)
        n = mesh.axis_size(axes)
        m = max(1, self.api.cfg.micro_batches)
        weights = _label_weights(torch.as_tensor(batch["labels"]), n, m)
        batches = _split_batch(batch, mesh, axes)
        losses: List[Any] = [None] * k
        grads: List[Any] = [None] * k
        for mine, group in self._units(traced):
            b = mesh.index(mine[0], axes)
            w = [weights[b * m:(b + 1) * m].to(batches[p]["labels"].device)
                 for p in mine]
            params = [p_def.unflatten([f[p] for f in full]) for p in mine]
            with count():
                out = loss_and_grads(self.api, params,
                                     [batches[p] for p in mine], w,
                                     1.0 / (n * m), group)
                out = [(loss, tree_leaves(g)) for loss, g in out]
            for p, (loss, g) in zip(mine, out):
                losses[p], grads[p], batches[p] = loss, g, None
                if elementwise:
                    for f in full:
                        f[p] = None
            del params, out
        if traced:
            losses = [losses[0]] * k
            grads = [grads[0]] * k
        if axes:
            loss = collectives.psum(losses, mesh, axes)
            for i in range(len(p_leaves)):
                out = collectives.psum([g[i] for g in grads], mesh, axes)
                for p in range(k):
                    grads[p][i] = out[p]
        else:
            loss = losses
        metrics = {"loss": loss[0],
                   "grad_norm": _grad_norm(grads[0]) if tp is None
                   else _split_grad_norm(grads, mesh, tp.dims)}
        if tp is not None and not elementwise:
            # the update runs on whole leaves: the split ones gathered
            # over the model axis too, params and gradients
            for i, d in enumerate(tp.dims):
                if d is None:
                    continue
                full[i] = collectives.all_gather(full[i], mesh, TP.AXIS, d)
                out = collectives.all_gather([g[i] for g in grads], mesh,
                                             TP.AXIS, d)
                for p in range(k):
                    grads[p][i] = out[p]
        old_p = [list(x.blocks) for x in p_leaves]
        old_o = [list(x.blocks) for x in o_leaves]
        del p_leaves, o_leaves
        new_p: List[List[Any]] = [[None] * k for _ in p_pl]
        new_o: List[List[Any]] = [[None] * k for _ in o_pl]
        new_step: List[Any] = [None] * k
        for p in ([0] if traced else range(k)):
            with count():
                lr = self.lr_schedule(step.blocks[p])
                if elementwise:
                    g = [block_of(t, pl, p, kp)
                         for t, pl, kp in zip(grads[p], p_pl, keep)]
                    params = [b[p] for b in old_p]
                    ostate = [b[p] for b in old_o]
                else:
                    g = grads[p]
                    params = [f[p] for f in full]
                    ostate = [f[p] for f in full_opt]
                new_params, new_opt = opt.update(
                    p_def.unflatten(g), o_def.unflatten(ostate),
                    p_def.unflatten(params), lr)
                new_params, new_opt = (tree_leaves(new_params),
                                       tree_leaves(new_opt))
                if not elementwise:
                    new_params = [block_of(t, pl, p).clone() for t, pl in
                                  zip(new_params, p_pl)]
                    new_opt = [block_of(t, pl, p).clone() for t, pl in
                               zip(new_opt, o_pl)]
                    for f in full + full_opt:
                        f[p] = None
            grads[p] = None
            for i, t in enumerate(new_params):
                new_p[i][p], old_p[i][p] = t, None
            for i, t in enumerate(new_opt):
                new_o[i][p], old_o[i][p] = t, None
            new_step[p] = step.blocks[p] + 1
            if p == 0:
                metrics["lr"] = lr
            del g, params, ostate, new_params, new_opt
        if traced:
            return ({"params": p_def.unflatten([b[0] for b in new_p]),
                     "opt": o_def.unflatten([b[0] for b in new_o]),
                     "step": new_step[0]}, metrics)

        def placed(blocks, meta):
            shape, dtype, pl = meta
            return PlacedTensor(shape, dtype, pl, blocks)

        return ({"params": p_def.unflatten([placed(b, m) for b, m in
                                            zip(new_p, p_meta)]),
                 "opt": o_def.unflatten([placed(b, m) for b, m in
                                         zip(new_o, o_meta)]),
                 "step": placed(new_step, (step.shape, step.dtype,
                                           step.placement))}, metrics)


def _split_grad_norm(grads: List[List[torch.Tensor]], mesh: NamedMesh,
                     dims: Sequence[Optional[int]]) -> torch.Tensor:
    """The global gradient norm from each position's gradient leaves
    under tensor parallelism: the squares of the split leaves' blocks
    summed over the model axis, then the whole leaves' added (position
    0's)."""
    def squares(gs):
        return sum((torch.sum(torch.square(g.to(F32))) for g in gs),
                   torch.zeros((), dtype=F32, device=gs[0].device))
    split = collectives.psum(
        [squares([g for g, d in zip(gr, dims) if d is not None])
         for gr in grads], mesh, TP.AXIS)
    return torch.sqrt(split[0] + squares(
        [g for g, d in zip(grads[0], dims) if d is None]))


def _label_weights(labels: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """The reference's masked mean as weights on groups of rows.

    The batch's rows, cut in order into ``n * m`` equal groups, are the
    micro-slices of the ``n`` row blocks: block b's slice j is group
    ``g = b * m + j``, and it lies inside the reference's micro-slice
    ``i = g // n`` (its ``m`` equal slices of the whole batch).  Group g's
    masked mean, weighted by ``max(T_g, 1) / (m * max(T_i, 1))`` (T the
    unmasked labels, ``labels >= 0``, of the group and of its slice), sums
    over the groups to the mean over the reference's slices of each
    slice's masked mean.  Returns the ``n * m`` float32 weights on
    ``labels``' device."""
    t = (labels >= 0).reshape(n * m, -1).sum(1).to(F32)
    per_slice = t.reshape(m, n).sum(1).clamp(min=1)
    return t.clamp(min=1) / (m * per_slice).repeat_interleave(n)


def make_sharded_train_step(api: ModelApi, optimizer: Optimizer,
                            lr_schedule: Callable, mesh: NamedMesh,
                            rules: Optional[Dict] = None
                            ) -> ShardedTrainStep:
    """The production-mesh train step (:class:`ShardedTrainStep`) over
    ``mesh`` with ``rules`` (default: ``rules_for(cfg, mesh, "train")``)."""
    return ShardedTrainStep(api, optimizer, lr_schedule, mesh, rules)


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


def replicate_state(state: Any, num_devices: int,
                    device: MeshLike = None) -> Any:
    """The elastic-restore hand-off: every leaf becomes ``num_devices``
    real copies, one on each of the first ``num_devices`` positions of
    ``device``'s mesh (``"cpu"``, a sequence of devices, or by default the
    CPU when the state lies there and the default card mesh otherwise), as
    a :class:`~repro_torch.core.sharded.ShardedTensor` whose pieces each
    cover the whole leaf.  A sharded leaf (a policy's staged params) is
    assembled from its pieces.  The identity on one device.  Replication
    is a copy, not arithmetic, so a resumed trajectory stays
    bit-identical."""
    if num_devices <= 1:
        return state
    leaves, treedef = tree_flatten(state)
    if device is None:
        first = leaves[0]
        first = first.pieces[0].tensor if isinstance(first, ShardedTensor) \
            else torch.as_tensor(first)
        device = "cpu" if first.device.type == "cpu" else None
    mesh = resolve_mesh(device, num_devices)

    def whole(leaf, dev: torch.device) -> torch.Tensor:
        if not isinstance(leaf, ShardedTensor):
            return torch.as_tensor(leaf).to(dev, copy=True)
        out = torch.empty(leaf.numel(), dtype=leaf.dtype, device=dev)
        for p in leaf.covering():
            # lint: allow=DC201 -- replication assembles device pieces on each position (the reference's device_put to a replicated sharding)
            out[p.lo:p.hi].copy_(p.tensor.reshape(-1), non_blocking=True)
        return out.view(leaf.shape)

    return treedef.unflatten([replicated([whole(leaf, dev) for dev in mesh])
                              for leaf in leaves])


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


def init_error_state(api: ModelApi, compress: bool,
                     dp_size: Union[int, NamedMesh] = 1,
                     device: MeshLike = None) -> Dict[str, Any]:
    """Zero error-feedback buffers, one per gradient bucket, padded to
    whole compression chunks (the plan padded for the dp degree, as the
    step plans it), on ``device`` (the card unless ``"cpu"``); replicated
    over the mesh's positions when it has more than one (``dp_size`` as
    in :func:`make_dp_train_step`).  Empty without compression."""
    if not compress:
        return {}
    mesh = dp_mesh(dp_size, device)
    dp = mesh.shape["data"] if mesh is not None else 1
    layout = engine_lib.get_session().plan(api.abstract(),
                                           grad_arena_spec(dp))
    pad = lambda n: -(-n // compression.CHUNK) * compression.CHUNK
    positions = mesh.positions if mesh is not None \
        else (resolve_device(device),)
    return {b: from_positions([torch.zeros((pad(n),), dtype=F32, device=d)
                               for d in positions])
            for b, n in layout.bucket_sizes.items()}
