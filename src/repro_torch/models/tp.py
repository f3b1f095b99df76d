"""Tensor parallelism over a mesh's ``model`` axis for the decoder-only
families (``dense``, ``vlm``, ``moe``, ``ssm`` and ``hybrid``) and the
encoder-decoder (``encdec``), in the train step and in placed prefill and
decode (``lm.serve_tp``, ``encdec.serve_tp``: the serve rules put the
same regions on ``model``, and the decode rules the cache's ``kv_seq``
too).

The reference never writes this out: its jitted train step puts ``heads``,
``mlp``, ``vocab``, the experts' ``expert_mlp`` and the Mamba2 mixer's
``ssm_inner`` and ``ssm_heads`` on ``model`` (``launch/mesh.py``'s
rules), keeps the residual stream at ``("batch", None, None)`` and the
logits at ``("batch", None, "vocab")``, and GSPMD partitions every
projection, the MLP, each expert's d_ff, each Mamba2 mixer's heads and
inner channels, the head and the cross-entropy over the model axis
(Megatron-style tensor parallelism; per-expert tensor parallelism for the
experts, whose router stays replicated; the mixer's ``wB`` / ``wC``,
``ssm_state``, stay whole; so do the kv projections, ``kv_heads``, of
every self- and cross-attention, the encoder's and the decoder's).
Here one controller drives the T members of a model group
(:class:`ModelGroup`) in lock step: every value is a list with one
tensor a computed member, on that member's device, and the members meet
in ``core.collectives.psum`` / ``pmax`` over the group, in position
order.

  * :func:`enter`, at a tensor-parallel region's entry: the identity
    forward, the ``psum`` of the replicated input's gradient backward
    (Megatron's f);
  * :func:`leave`, at its exit: the ``psum`` of the partial outputs forward,
    the identity backward (g);
  * :func:`total`, a partial sum that every member's share reads on (the
    gated RMSNorm's sum of squares over d_inner): :func:`leave`, then
    :func:`enter`, so its gradient, partial on each member, is summed
    too;
  * :func:`embed`: each member looks up the tokens in its vocab rows and
    gives zeros elsewhere, then :func:`leave` (exact: one term is
    nonzero);
  * :func:`cross_entropy`: the row max by ``pmax``, ``sum(exp)`` and the
    target logit (taken by the member that owns it) by :func:`leave`; the
    full logits never exist on a member.

Each takes whether its region splits over the group (``split``, or
``group.vocab``): a region that does not runs whole on every member, and
the operators then leave each member's values and gradients as they are
(``ModelGroup.share`` gives such a member the whole: (0, 1)).

Every member computes the norms and the residual stream on its own copy
and seeds the backward with its own copy of the loss; the operators above
make the members' replicated activations and gradients equal bit for bit,
and each member's gradient of a split leaf is its block of the whole
gradient.  The dry run computes member 0 alone (``stand_in``): the other
members' slots of a collective take member 0's tensor (on meta positions
there are no values to differ).

:func:`plan` reads which regions split from the params' placements.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import torch

from ..core import collectives
from ..core.collectives import NamedMesh
from ..core.placement import entry_axes, gather_blocks
from ..core.treepath import tree_flatten_with_path, tree_leaves

AXIS = "model"
# the families whose train step and placed prefill and decode split over
# the model axis: every family
FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")
# the param subtrees stacked on a leading layer dim
STACKED = ("blocks", "enc_blocks", "dec_blocks")
# the attention sublayers and the MLPs: (subtree, sublayer), the hybrid's
# ``shared_attn`` one block, unstacked
_ATTNS = (("blocks", "attn"), ("enc_blocks", "attn"), ("dec_blocks", "attn"),
          ("dec_blocks", "xattn"), ("shared_attn", "attn"))
_MLPS = (("blocks", "mlp"), ("enc_blocks", "mlp"), ("dec_blocks", "mlp"),
         ("shared_attn", "mlp"))


def _leaves(sublayers, dims):
    """The (path, dim) of each named leaf of each sublayer, the dim one
    more in a stacked subtree (its dim 0 is the layer)."""
    return tuple(((tree, sub, name), d + (tree in STACKED))
                 for tree, sub in sublayers for name, d in dims)


# per region, the leaves it splits and the dim of each that ``model``
# must block.  ``ssm`` holds the Mamba2 mixer's head leaves and its
# channel leaves together, so a member's block of d_inner is exactly its
# heads' channels
REGIONS = {
    "heads": _leaves(_ATTNS, (("wq", 1), ("wo", 0), ("bq", 0))),
    "mlp": _leaves(_MLPS, (("w_gate", 1), ("w_up", 1), ("w_down", 0),
                           ("b_up", 0))),
    "vocab": ((("embed", "tok"), 0), (("embed", "lm_head"), 1)),
    "experts": ((("blocks", "moe", "w_gate"), 3),
                (("blocks", "moe", "w_up"), 3),
                (("blocks", "moe", "w_down"), 2)),
    "ssm": tuple((("blocks", "ssm", n), d) for n, d in (
        ("wz", 2), ("wx", 2), ("wdt", 2), ("conv_w", 2), ("conv_b", 1),
        ("out_norm", 1), ("dt_bias", 1), ("A_log", 1), ("D", 1),
        ("wo", 1))),
}


class ModelGroup:
    """The T members of one model group of ``mesh`` (``members``: flat
    positions ordered by their index over ``model``), driven in lock step,
    and which regions of the block split over them (``heads``, ``mlp``,
    ``vocab``, ``experts``: each expert's d_ff, ``ssm``: each Mamba2
    mixer's heads and their channels).  :attr:`ranks` are the
    computed members' indices: all of them, or member 0 alone with
    ``stand_in``."""

    def __init__(self, mesh: NamedMesh, members: Sequence[int], *,
                 heads: bool, mlp: bool, vocab: bool, experts: bool = False,
                 ssm: bool = False, stand_in: bool = False):
        self.members = tuple(members)
        self.size = len(self.members)
        self.mesh = NamedMesh([mesh.positions[p] for p in self.members],
                              (self.size,), (AXIS,))
        self.ranks = (0,) if stand_in else tuple(range(self.size))
        self.heads, self.mlp, self.vocab = heads, mlp, vocab
        self.experts, self.ssm = experts, ssm

    def _reduce(self, xs: Sequence[torch.Tensor], op) -> List[torch.Tensor]:
        if len(xs) != len(self.ranks):
            raise ValueError(f"{len(xs)} tensors for {len(self.ranks)} "
                             f"computed members")
        full = list(xs) if len(xs) == self.size else [xs[0]] * self.size
        out = op(full, self.mesh, AXIS)
        return [out[r] for r in self.ranks]

    def share(self, split: bool, rank: int) -> Tuple[int, int]:
        """Member ``rank``'s (index, count) of a region: its place in the
        group where the region splits, else (0, 1), the whole."""
        return (rank, self.size) if split else (0, 1)

    def psum(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return self._reduce(xs, collectives.psum)

    def pmax(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return self._reduce(xs, collectives.pmax)

    def exchange(self, pieces: Sequence[Sequence[torch.Tensor]], axis: int
                 ) -> List[torch.Tensor]:
        """Each computed member's pieces from every member, concatenated
        along ``axis`` in member order: ``pieces`` holds one list a
        computed member, its piece for each member of the group
        (``collectives.all_to_allv``; with ``stand_in`` member 0's
        pieces stand in for every member's)."""
        if len(pieces) != len(self.ranks):
            raise ValueError(f"{len(pieces)} piece lists for "
                             f"{len(self.ranks)} computed members")
        full = list(pieces) if len(pieces) == self.size \
            else [pieces[0]] * self.size
        out = collectives.all_to_allv(full, self.mesh, AXIS, axis)
        return [out[r] for r in self.ranks]


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(ctx.group.psum(list(grads)))


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        return tuple(group.psum(list(xs)))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + grads


def enter(group: ModelGroup, xs: Sequence[torch.Tensor], split: bool = True
          ) -> List[torch.Tensor]:
    """A region's replicated input: as it is; its gradient summed over
    the group where the region splits."""
    return list(_Enter.apply(group, *xs)) if split else list(xs)


def leave(group: ModelGroup, xs: Sequence[torch.Tensor], split: bool = True
          ) -> List[torch.Tensor]:
    """A region's partial outputs summed over the group where the region
    splits (else its whole outputs, as they are); each partial takes its
    member's gradient of the sum as it is."""
    return list(_Leave.apply(group, *xs)) if split else list(xs)


def total(group: ModelGroup, xs: Sequence[torch.Tensor], split: bool = True
          ) -> List[torch.Tensor]:
    """The members' partial sums summed over the group where ``split``,
    forward and backward: a value each member's share goes on to read,
    whose gradient each member holds only its part of."""
    return enter(group, leave(group, xs, split), split)


def _local(ids: torch.Tensor, rank: int, rows: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ids`` as rows of member ``rank``'s block of ``rows`` (clamped
    into it) and whether each lies there."""
    local = ids.to(torch.long) - rank * rows
    inside = (local >= 0) & (local < rows)
    return local.clamp(0, rows - 1), inside


def embed(group: ModelGroup, tables: Sequence[torch.Tensor],
          tokens: Sequence[torch.Tensor], dtype: torch.dtype
          ) -> List[torch.Tensor]:
    """Vocab-parallel embedding where ``group.vocab``: ``tables`` are the
    members' row blocks of ``tok``; each looks up its own tokens and the
    group sums.  Else each member's whole table."""
    outs = []
    for r, w, t in zip(group.ranks, tables, tokens):
        local, inside = _local(t, group.share(group.vocab, r)[0], w.shape[0])
        e = w[local].to(dtype)
        outs.append(torch.where(inside[..., None], e, torch.zeros_like(e)))
    return leave(group, outs, group.vocab)


def cross_entropy(group: ModelGroup, logits: Sequence[torch.Tensor],
                  labels: Sequence[torch.Tensor]):
    """``lm.cross_entropy``, vocab-parallel where ``group.vocab``, over
    the members' f32 logits blocks (B, S, V/T; else whole): each member's
    masked mean NLL (equal over the group) and count of unmasked
    labels."""
    f32 = torch.float32
    split = group.vocab
    logits = [x.to(f32) for x in logits]
    with torch.no_grad():
        top = [x.amax(dim=-1) for x in logits]
        top = group.pmax(top) if split else top
    sums = leave(group, [torch.exp(x - m[..., None]).sum(-1)
                         for x, m in zip(logits, top)], split)
    picked = []
    for r, x, y in zip(group.ranks, logits, labels):
        local, inside = _local(y.clamp_min(0), group.share(split, r)[0],
                               x.shape[-1])
        t = torch.gather(x, -1, local[..., None])[..., 0]
        picked.append(torch.where(inside, t, torch.zeros_like(t)))
    target = leave(group, picked, split)
    out = []
    for y, s, m, t in zip(labels, sums, top, target):
        mask = (y >= 0).to(f32)
        nll = torch.log(s) + m - t
        loss = torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
        out.append((loss, torch.sum(mask)))
    return out


@dataclasses.dataclass(frozen=True)
class Plan:
    """Which regions split over ``model`` and, per param leaf (flat
    order), the dim ``model`` blocks, or None for a leaf every member
    holds whole."""

    heads: bool
    mlp: bool
    vocab: bool
    dims: Tuple[Optional[int], ...]
    experts: bool = False
    ssm: bool = False

    def keep(self, i: int) -> Tuple[str, ...]:
        """The axes leaf ``i`` keeps its block over when gathered."""
        return (AXIS,) if self.dims[i] is not None else ()

    def group(self, mesh: NamedMesh, members: Sequence[int],
              stand_in: bool = False) -> ModelGroup:
        return ModelGroup(mesh, members, heads=self.heads, mlp=self.mlp,
                          vocab=self.vocab, experts=self.experts,
                          ssm=self.ssm, stand_in=stand_in)

    def stand_in(self, mesh: NamedMesh) -> ModelGroup:
        """Position 0's group with member 0 alone computed (the dry
        run's)."""
        return self.group(mesh, next(g for g in mesh.groups(AXIS)
                                     if 0 in g), stand_in=True)

    def member_shapes(self, abstract: Any, size: int) -> List[Tuple]:
        """The (path, shape, dtype) of each leaf of the params'
        ``abstract`` tree as a member of a group of ``size`` holds it."""
        out = []
        for (path, v), d in zip(tree_flatten_with_path(abstract),
                                self.dims):
            shape = list(v.shape)
            if d is not None:
                shape[d] //= size
            out.append((path, tuple(shape), v.dtype))
        return out


def plan(cfg, mesh: NamedMesh, placements: Any, batch_rule: Any
         ) -> Optional[Plan]:
    """The model's tensor-parallel plan over ``mesh``'s ``model`` axis
    from the params' ``placements``: a region splits where each of its
    leaves' placements blocks its dim (:data:`REGIONS`) over ``model``
    alone (arctic's 56 heads over 16 stay whole, as the reference's
    ``_demote_spec`` leaves them; so does a Mamba2 mixer whose heads do
    not divide, even where its d_inner does).  None where nothing splits,
    the family is not one of :data:`FAMILIES`, the axis is missing or of
    size 1, or the batch's rows (``batch_rule``) split over it."""
    if cfg.family not in FAMILIES or AXIS not in mesh.axis_names \
            or mesh.shape[AXIS] == 1 or AXIS in entry_axes(batch_rule):
        return None
    items = tree_flatten_with_path(placements)
    by_path = {path: pl for path, pl in items}
    split = {}
    for region, leaves in REGIONS.items():
        present = [(path, d) for path, d in leaves if path in by_path]
        split[region] = bool(present) and all(
            by_path[path].spec[d:d + 1] == (AXIS,) for path, d in present)
    if not any(split.values()):
        return None
    dims = {path: d for region, leaves in REGIONS.items() if split[region]
            for path, d in leaves}
    return Plan(heads=split["heads"], mlp=split["mlp"], vocab=split["vocab"],
                dims=tuple(dims.get(path) for path, _ in items),
                experts=split["experts"], ssm=split["ssm"])


def gather_params(leaves: Sequence[Any], plan: Optional[Plan]
                  ) -> List[List[torch.Tensor]]:
    """Each position's view of the placed param ``leaves`` (flat order):
    the leaves ``plan`` splits gathered over every axis but ``model``
    (each position keeps its block), the others whole; every leaf whole
    without a plan."""
    return [gather_blocks(x, plan.keep(i) if plan is not None else ())
            for i, x in enumerate(leaves)]


def gathered_param_bytes(abstract: Any, plan: Optional[Plan],
                         mesh: NamedMesh) -> int:
    """The bytes of params one position holds once it has gathered them
    (:func:`gather_params`) from the params' ``abstract`` tree."""
    out = 0
    for i, v in enumerate(tree_leaves(abstract)):
        n = math.prod(v.shape)
        if plan is not None and plan.dims[i] is not None:
            n //= mesh.shape[AXIS]
        out += n * torch.empty((), dtype=v.dtype).element_size()
    return out


__all__ = ["AXIS", "FAMILIES", "gather_params",
           "gathered_param_bytes", "STACKED", "REGIONS", "ModelGroup", "Plan",
           "plan", "enter", "leave", "total", "embed", "cross_entropy"]
