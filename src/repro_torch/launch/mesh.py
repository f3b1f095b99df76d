"""Named meshes and the logical-axis sharding rules.

The port's counterpart of the plain-data half of ``repro/launch/mesh.py``:
a mesh is a :class:`~repro_torch.core.collectives.NamedMesh` (axis names,
sizes and a grid of ``torch.device`` positions) that one controller drives
(:mod:`repro_torch.core.collectives`), and the rule tables map logical
axis names to mesh axes exactly as the reference's do.

``make_debug_mesh`` resolves its positions as the sharded deep copy does
(:func:`~repro_torch.core.sharded.resolve_mesh`): ``device="cpu"`` gives
positions on the CPU, ``None`` the default mesh ``cuda:0 ... cuda:K-1``
(fewer visible cards raise the stale-mesh error), a sequence the mesh as
given, such as ``(torch.device("cuda", 0),) * 4`` for four positions on
one card.  The reference's ``make_production_mesh``, ``tree_shardings``,
``_demote_spec`` and ``replicated`` build XLA ``NamedSharding``s and are
not ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..core.collectives import NamedMesh
from ..core.sharded import MeshLike, resolve_mesh


def make_debug_mesh(data: int = 2, model: int = 2, pod: int = 0,
                    device: MeshLike = None) -> NamedMesh:
    """A (data, model) mesh, or (pod, data, model) with ``pod``, over
    ``data * model * (pod or 1)`` positions of ``device``."""
    shape = (pod, data, model) if pod else (data, model)
    names = ("pod", "data", "model") if pod else ("data", "model")
    k = 1
    for s in shape:
        k *= int(s)
    return NamedMesh(resolve_mesh(device, k), shape, names)


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


__all__ = ["NamedMesh", "make_debug_mesh", "default_rules", "rules_for",
           "adapt_batch_rule"]
