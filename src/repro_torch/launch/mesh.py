"""Named meshes, the logical-axis sharding rules and placements over them.

The port's counterpart of ``repro/launch/mesh.py``: a mesh is a
:class:`~repro_torch.core.collectives.NamedMesh` (axis names, sizes and a
grid of ``torch.device`` positions) that one controller drives
(:mod:`repro_torch.core.collectives`), and the rule tables map logical
axis names to mesh axes exactly as the reference's do.  Where the
reference builds ``NamedSharding``s, :func:`tree_shardings` and
:func:`replicated` build :class:`~repro_torch.core.placement.Placement`s,
with the reference's per-leaf demotion (:func:`_demote_spec`).

``make_debug_mesh`` and ``make_production_mesh`` resolve their positions
as the sharded deep copy does
(:func:`~repro_torch.core.sharded.resolve_mesh`): ``device="cpu"`` gives
positions on the CPU, ``"meta"`` meta positions (the dry run), ``None``
the default mesh ``cuda:0 ... cuda:K-1`` (fewer visible cards raise the
stale-mesh error, as ``jax.make_mesh`` fails without the devices; no mesh
is shrunk), a sequence the mesh as given, such as ``(torch.device("cuda",
0),) * 4`` for four positions on one card.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..core.collectives import NamedMesh
from ..core.placement import Placement, entry_axes
from ..core.sharded import MeshLike, _stale, resolve_mesh
from ..core.treepath import tree_flatten, tree_leaves
from ..models.pspec import logical_to_spec


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
          device: MeshLike) -> NamedMesh:
    k = 1
    for s in shape:
        k *= int(s)
    return NamedMesh(resolve_mesh(device, k), shape, names)


def make_production_mesh(*, multi_pod: bool = False,
                         device: MeshLike = None) -> NamedMesh:
    """The reference's production mesh: (16, 16) positions named
    ("data", "model"), or (2, 16, 16) named ("pod", "data", "model") with
    ``multi_pod`` (the "pod" axis carries only data parallelism)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    k = 2 * 16 * 16 if multi_pod else 16 * 16
    if device is None and torch.cuda.device_count() < k:
        # the default mesh of cards, counted before any card is touched:
        # fewer than it needs (none on a host without one) is the
        # stale-mesh error, as jax.make_mesh fails without the devices
        raise _stale(k, torch.cuda.device_count())
    return _mesh(shape, names, device)


def make_debug_mesh(data: int = 2, model: int = 2, pod: int = 0,
                    device: MeshLike = None) -> NamedMesh:
    """A (data, model) mesh, or (pod, data, model) with ``pod``, over
    ``data * model * (pod or 1)`` positions of ``device``."""
    shape = (pod, data, model) if pod else (data, model)
    names = ("pod", "data", "model") if pod else ("data", "model")
    return _mesh(shape, names, device)


def default_rules(mesh) -> Dict[str, Optional[Tuple[str, ...]]]:
    multi = "pod" in mesh.axis_names
    dp = ("pod", "data") if multi else ("data",)
    return {
        # activations
        "batch": dp,
        "seq": None,
        # dense params: 2-D sharded (FSDP over data x TP over model)
        "embed": dp,
        "embed_out": None,
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": None,
        "head_dim": None,
        "mlp": ("model",),
        # MoE: expert parallelism over data, per-expert TP over model
        "expert": dp,
        "expert_router": ("model",),
        "expert_embed": None,
        "expert_mlp": ("model",),
        # SSM
        "ssm_inner": ("model",),
        "ssm_state": None,
        "ssm_heads": ("model",),
        "conv": None,
        # stacking / caches
        "layers": None,
        "kv_seq": None,
        "frame": None,
    }


def rules_for(cfg, mesh, mode: str = "train"
              ) -> Dict[str, Optional[Tuple[str, ...]]]:
    """The default rules with the config's overrides (and, outside
    training, the embed dim replicated unless ``inference_embed_fsdp``;
    when decoding, the config's decode overrides)."""
    rules = default_rules(mesh)
    if mode != "train" and not cfg.inference_embed_fsdp:
        rules["embed"] = None
    for k, v in cfg.rules:
        rules[k] = tuple(v) if isinstance(v, (list, tuple)) else v
    if mode == "decode":
        for k, v in cfg.decode_rules:
            rules[k] = tuple(v) if isinstance(v, (list, tuple)) else v
    return rules


def adapt_batch_rule(rules: Dict, mesh, global_batch: int) -> Dict:
    """Keep only the batch rule's axes, in order, whose sizes divide what
    is left of ``global_batch`` (a batch of 1 shards over nothing)."""
    dp = rules.get("batch")
    if not dp:
        return rules
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    keep = []
    for ax in dp:
        if global_batch % sizes[ax] == 0:
            keep.append(ax)
            global_batch //= sizes[ax]
    out = dict(rules)
    out["batch"] = tuple(keep) if keep else None
    return out


def _demote_spec(spec: Tuple[Any, ...], shape, mesh) -> Tuple[Any, ...]:
    """Drop mesh axes that do not evenly divide their tensor dim: each
    entry keeps, in order, every axis whose size divides what is left of
    the dim (the reference's rule: an argument's blocks must divide
    exactly, so arctic's 56 heads or granite's 49155 vocab rows do not
    shard 16-way)."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    entries = []
    for dim, entry in zip(shape, tuple(spec)
                          + (None,) * (len(shape) - len(spec))):
        if entry is None:
            entries.append(None)
            continue
        keep = []
        rem = int(dim)
        for ax in entry_axes(entry):
            if rem % sizes[ax] == 0:
                keep.append(ax)
                rem //= sizes[ax]
        entries.append(tuple(keep) if len(keep) > 1
                       else (keep[0] if keep else None))
    return tuple(entries)


class _Axes:
    """An axes tuple held as one leaf while an axes tree is flattened
    (the reference flattens with ``is_leaf=lambda x: isinstance(x,
    tuple)``)."""

    __slots__ = ("axes",)

    def __init__(self, axes):
        self.axes = tuple(axes)


def _wrap_axes(tree: Any) -> Any:
    if isinstance(tree, tuple):
        return _Axes(tree)
    if isinstance(tree, dict):
        return {k: _wrap_axes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_wrap_axes(v) for v in tree]
    raise TypeError(f"not an axes tree: {type(tree).__name__}")


def axes_flatten(axes_tree: Any):
    """An axes tree's tuples in leaf order, and the treedef that puts
    leaves back in their places."""
    leaves, treedef = tree_flatten(_wrap_axes(axes_tree))
    return [leaf.axes for leaf in leaves], treedef


def tree_shardings(mesh: NamedMesh, axes_tree: Any, rules: Dict,
                   abstract_tree: Any = None) -> Any:
    """Map a logical-axes tree to :class:`Placement`s.  With
    ``abstract_tree`` (the arguments' shapes: ``ShapeDtype``s or tensors)
    each leaf's spec is demoted to divide its shape; a tree whose leaf
    count differs raises ``ValueError``."""
    axes_leaves, treedef = axes_flatten(axes_tree)
    if abstract_tree is None:
        return treedef.unflatten([Placement(mesh, logical_to_spec(a, rules))
                                  for a in axes_leaves])
    abs_leaves = tree_leaves(abstract_tree)
    if len(abs_leaves) != len(axes_leaves):
        raise ValueError(f"axes tree ({len(axes_leaves)} leaves) does not "
                         f"match abstract tree ({len(abs_leaves)} leaves)")
    return treedef.unflatten([
        Placement(mesh, _demote_spec(logical_to_spec(a, rules),
                                     tuple(v.shape), mesh))
        for a, v in zip(axes_leaves, abs_leaves)])


def replicated(mesh: NamedMesh) -> Placement:
    """Every position holds the whole value (``P()``)."""
    return Placement(mesh, ())


__all__ = ["NamedMesh", "Placement", "make_debug_mesh",
           "make_production_mesh", "default_rules", "rules_for",
           "adapt_batch_rule", "axes_flatten", "tree_shardings",
           "replicated"]
