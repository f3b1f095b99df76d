"""Per-layer cost probes: the port's counterpart of
``repro/launch/probe.py``.

The reference lowers one layer body a kind because XLA's
``cost_analysis`` counts a ``while`` body once whatever its trip count,
and corrects the step's terms by ``(trips - 1) * body``.  Eager PyTorch
dispatches every trip of the layer loop, so the port's step count is
already whole.  :func:`layer_bodies` still runs each distinct layer body
once, on meta tensors at one position's shapes (its rows of the batch;
for a step that splits over the model axis, train or serve, its blocks
of the split leaves, and of the cache, with its group's other members
standing in, as the step's trace runs them, ``models/tp.py``; else at
full width), under
the op counter (``hlo_analysis.OpCounter``): forward and backward with
the config's remat for a train shape, the forward with the per-layer
cache traffic for prefill and decode.  The dry run uses the bodies as a
check: the step's FLOPs equal the sum of trips times each body's plus the
FLOPs of the same step with the layers removed (:func:`layer_free_flops`).

Kinds, as the reference's: ``attn_block`` (dense, moe, vlm), ``ssm_block``
and, for the hybrid, ``shared_attn`` (one a shared-block application),
``enc_block`` and ``dec_block`` for the encoder-decoder.  One divergence:
a train step's first encoder block takes no input gradient (the frames
take none), so it is its own kind, ``enc_block_in``, and ``enc_block``
has ``enc_layers - 1`` trips (tensor-parallel, that block's attention
entry still sums its normed input's gradient, which ``ln1`` reads).
The port gathers the stacked params once a step, outside the layer
loop; a tensor-parallel body's sums over its
model group are counted with the step's collectives, not the body's
(its ``collective_*`` are 0).  :func:`corrected_terms` is the reference's
pure function, kept for its callers; the dry run reports the raw count as
``corrected``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional

import torch

from ..configs.base import InputShape
from ..core.placement import entry_axes
from ..core.treepath import tree_leaves, tree_map
from ..models import encdec as encdec_mod
from ..models import lm as lm_mod
from ..models import registry
from ..models import tp as TP
from ..models.registry import ModelApi
from ..models.specs import abstract_params, torch_dtype
from . import hlo_analysis

META = torch.device("meta")


def _meta(shape, dtype, grad: bool = False) -> torch.Tensor:
    t = torch.empty(tuple(shape), dtype=dtype, device=META)
    return t.requires_grad_() if grad else t


def _meta_tree(abstract: Any, grad: bool = False) -> Any:
    return tree_map(lambda s: _meta(s.shape, s.dtype, grad), abstract)


def position_rows(shape: InputShape, mesh, rules: Dict) -> int:
    """One position's rows of the batch (the batch rule as given, already
    adapted to the batch size)."""
    return shape.global_batch // mesh.axis_size(
        entry_axes(rules.get("batch")))


def _cost(fn: Callable, *args) -> Dict[str, Any]:
    counter = hlo_analysis.OpCounter()
    with counter:
        fn(*args)
    return {"flops": float(counter.total_flops),
            "bytes": float(counter.total_bytes),
            "collective_bytes": 0.0, "collective_count": 0}


def _grad_probe(apply_fn: Callable, cfg, n_grad: int) -> Callable:
    """Forward and backward of a body under the config's remat: the
    gradients of the summed output (and the MoE aux loss) with respect to
    the params and the first ``n_grad - 1`` tensor arguments."""
    apply_fn = lm_mod._remat(cfg, apply_fn)

    def probe(p, *args):
        out = apply_fn(p, *args)
        y, aux = out if isinstance(out, tuple) else (out, None)
        loss = torch.sum(y.to(torch.float32))
        if aux is not None:
            loss = loss + aux
        wrt = tree_leaves(p) + list(args[:n_grad - 1])
        torch.autograd.grad(loss, wrt, allow_unused=True)
    return probe


def tp_plan(api: ModelApi, mesh, rules: Dict):
    """The tensor-parallel plan (``models/tp.py``) of ``api``'s train
    step, or of its placed serving (``runtime/placed.py``) under the
    prefill or decode rules, on ``mesh`` under ``rules``, or None."""
    from .mesh import tree_shardings

    return TP.plan(api.cfg, mesh, tree_shardings(
        mesh, api.axes(), rules, api.abstract()), rules.get("batch"))


def _member_tree(api: ModelApi, plan, mesh, grad: bool = False,
                 under: Optional[str] = None) -> Any:
    """Member 0's params on meta tensors at its blocks of the split
    leaves (with ``under``, the subtree there alone: one layer of the
    stacked ``"blocks"``, ``"enc_blocks"`` or ``"dec_blocks"``, or the
    hybrid's ``"shared_attn"``)."""
    tree: Dict[Any, Any] = {}
    for path, shape, dtype in plan.member_shapes(api.abstract(),
                                                 mesh.shape[TP.AXIS]):
        if under is not None:
            if path[0] != under:
                continue
            path = path[1:]
            if under in TP.STACKED:
                shape = shape[1:]
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _meta(shape, dtype, grad)
    return tree


def layer_bodies(api: ModelApi, shape: InputShape, mesh, rules: Dict
                 ) -> List[Dict[str, Any]]:
    """Each distinct layer body run once on meta tensors; returns
    ``[{kind, trips, flops, bytes, collective_bytes, collective_count}]``
    (one position's counts)."""
    cfg = api.cfg
    mode = shape.mode
    train = mode == "train"
    B = position_rows(shape, mesh, rules)
    S = 1 if mode == "decode" else shape.seq_len
    S_cache = shape.seq_len
    cdt = torch_dtype(cfg.compute_dtype)
    pdt = cfg.param_dtype
    out: List[Dict[str, Any]] = []

    def record(kind, trips, fn, *args):
        out.append({"kind": kind, "trips": trips, **_cost(fn, *args)})

    def x_in(grad=train):
        return _meta((B, S, cfg.d_model), cdt, grad)

    def positions():
        return _meta((B, S), torch.int64)

    def kv_cache(rows=S_cache):
        kv = (B, rows, cfg.num_kv_heads, cfg.resolved_head_dim)
        return {"k": _meta(kv, cdt), "v": _meta(kv, cdt)}

    def ssm_cache(parts=1):
        return {"state": _meta((B, cfg.ssm_heads // parts, cfg.ssm_head_dim,
                                cfg.ssm_state), torch.float32),
                "conv": _meta((B, cfg.ssm_conv_width - 1,
                               cfg.d_inner // parts), cdt)}

    def valid():
        return _meta((B,), torch.int32)

    def attn_body(kind, spec, trips):
        p = _meta_tree(abstract_params(spec, pdt), train)
        block = functools.partial(lm_mod._attn_block, cfg)
        if train:
            record(kind, trips, _grad_probe(
                lambda p, x, pos: block(p, x, positions=pos, cache=None,
                                        kv_valid_len=None), cfg, 2),
                p, x_in(), positions())
        else:
            record(kind, trips, lambda p, x, pos, c, v: block(
                p, x, positions=pos, cache=c, kv_valid_len=v),
                p, x_in(), positions(), kv_cache(), valid())

    plan = tp_plan(api, mesh, rules)
    kv_split, kv_rows = False, S_cache
    if plan is not None and not train:
        # the member's block of the cache: its rows of the k / v sequence
        # where it splits
        from ..runtime.placed import PlacedServe

        kv_split = PlacedServe(api, mesh, rules).kv_split(
            shape.global_batch, S_cache)
        kv_rows = S_cache // mesh.shape[TP.AXIS] if kv_split else S_cache
    if cfg.is_encdec:
        tree = encdec_mod.spec_tree(cfg)
        unstack = lambda t: tree_map(
            lambda s: dataclasses.replace(s, shape=s.shape[1:],
                                          axes=s.axes[1:]), t)
        src = max(1, S_cache // cfg.src_ratio)
        xe = lambda grad: _meta((B, src, cfg.d_model), cdt, grad)
        spos = lambda: _meta((1, src), torch.int64)
        if plan is not None:
            # member 0's blocks, its group's other members standing in;
            # the memory enters the decoder's regions once, outside the
            # blocks (``encdec._decode_stack_tp``)
            group = plan.stand_in(mesh)
            enc_tp = functools.partial(encdec_mod._enc_block_tp, cfg, group)
            dec_tp = functools.partial(encdec_mod._dec_block_tp, cfg, group)
            enc_fn = lambda p, x, pos: enc_tp([p], [x], positions=[pos])[0]
            dec_fn = lambda p, x, e, pos, c=None, v=None: dec_tp(
                [p], [x], [e], positions=[pos],
                caches=None if c is None else [c], kv_split=kv_split,
                kv_valid_len=None if v is None else [v])[0]
            enc_p = lambda: _member_tree(api, plan, mesh, train,
                                         under="enc_blocks")
            dec_p = lambda: _member_tree(api, plan, mesh, train,
                                         under="dec_blocks")
        else:
            enc = functools.partial(encdec_mod._enc_block, cfg)
            dec = functools.partial(encdec_mod._dec_block, cfg)
            enc_fn = lambda p, x, pos: enc(p, x, positions=pos)
            dec_fn = lambda p, x, e, pos, c=None, v=None: dec(
                p, x, e, positions=pos, cache=c, kv_valid_len=v)
            enc_p = lambda: _meta_tree(abstract_params(
                unstack(tree["enc_blocks"]), pdt), train)
            dec_p = lambda: _meta_tree(abstract_params(
                unstack(tree["dec_blocks"]), pdt), train)
        if train:
            record("enc_block_in", 1, _grad_probe(enc_fn, cfg, 1),
                   enc_p(), xe(False), spos())
            record("enc_block", cfg.enc_layers - 1,
                   _grad_probe(enc_fn, cfg, 2), enc_p(), xe(True), spos())
            record("dec_block", cfg.num_layers, _grad_probe(dec_fn, cfg, 3),
                   dec_p(), x_in(), xe(True), positions())
        else:
            if mode == "prefill":
                # the encoder runs once at prefill; decode never re-runs it
                record("enc_block", cfg.enc_layers, enc_fn, enc_p(),
                       xe(False), spos())
            record("dec_block", cfg.num_layers, dec_fn, dec_p(), x_in(),
                   xe(False), positions(), kv_cache(kv_rows), valid())
    elif plan is not None:
        group = plan.stand_in(mesh)
        attn = functools.partial(lm_mod._attn_block_tp, cfg, group)
        mixer = functools.partial(lm_mod._ssm_block_tp, cfg, group)
        if train:
            attn_probe = _grad_probe(lambda p, x, pos: tuple(
                out[0] for out in attn([p], [x], positions=[pos])), cfg, 2)
            mixer_probe = _grad_probe(lambda p, x: mixer([p], [x])[0],
                                      cfg, 2)
            attn_args = lambda: (x_in(), positions())
            mixer_args = lambda: (x_in(),)
        else:
            # the member's heads' state and their channels' conv tail
            # where the mixers split
            t = mesh.shape[TP.AXIS]
            attn_probe = lambda p, x, pos, c, v: attn(
                [p], [x], positions=[pos], caches=[c], kv_split=kv_split,
                kv_valid_len=[v])
            mixer_probe = lambda p, x, c: mixer([p], [x], [c])
            attn_args = lambda: (x_in(), positions(), kv_cache(kv_rows),
                                 valid())
            mixer_args = lambda: (x_in(), ssm_cache(t if plan.ssm else 1))
        if cfg.family in lm_mod.ATTN_STACKS:
            record("attn_block", cfg.num_layers, attn_probe,
                   _member_tree(api, plan, mesh, train, under="blocks"),
                   *attn_args())
        else:
            record("ssm_block", cfg.num_layers, mixer_probe,
                   _member_tree(api, plan, mesh, train, under="blocks"),
                   *mixer_args())
        if cfg.family == "hybrid":
            record("shared_attn", lm_mod._n_shared_apps(cfg), attn_probe,
                   _member_tree(api, plan, mesh, train, under="shared_attn"),
                   *attn_args())
    elif cfg.family in lm_mod.ATTN_STACKS:
        attn_body("attn_block", lm_mod._attn_block_specs(cfg),
                  cfg.num_layers)
    elif cfg.family in ("ssm", "hybrid"):
        p = _meta_tree(abstract_params(lm_mod._ssm_block_specs(cfg), pdt),
                       train)
        block = functools.partial(lm_mod._ssm_block, cfg)
        if train:
            record("ssm_block", cfg.num_layers, _grad_probe(
                lambda p, x: block(p, x, cache=None)[0], cfg, 2), p, x_in())
        else:
            record("ssm_block", cfg.num_layers,
                   lambda p, x, c: block(p, x, cache=c), p, x_in(),
                   ssm_cache())
        if cfg.family == "hybrid":
            attn_body("shared_attn", lm_mod._attn_block_specs(cfg),
                      lm_mod._n_shared_apps(cfg))
    return out


def layer_free_flops(api: ModelApi, shape: InputShape, mesh, rules: Dict
                     ) -> int:
    """The FLOPs of one position's step with the layers removed: the
    embedding, the final norm, the unembedding and the loss (and their
    gradients for a train shape; the optimizer's elementwise update counts
    none), on meta tensors at the position's rows.  A prefill or decode
    shape traces the placed step itself as the dry run does
    (``PlacedServe``, ``traced=True``: tensor-parallel where its plan
    splits, so at the member's widths)."""
    from ..core.placement import place_tree
    from ..runtime.placed import PlacedServe
    from ..runtime.train import loss_and_grads

    # no blocks and no encoder blocks, so no shared-block applications
    free = registry.get_model(dataclasses.replace(api.cfg, num_layers=0,
                                                  enc_layers=0))
    counter = hlo_analysis.OpCounter()
    if shape.mode != "train":
        serve = PlacedServe(free, mesh, rules)
        cache = place_tree(free.abstract_cache(shape), serve.cache_shardings(
            shape.global_batch, shape.seq_len))
        inputs = {k: _meta(v.shape, v.dtype)
                  for k, v in free.input_specs(shape).items()}
        fn = serve.prefill if shape.mode == "prefill" else serve.decode_step
        fn(place_tree(free.abstract(), serve.param_shardings),
           inputs.pop("tokens"), cache, traced=True, count=lambda: counter,
           **inputs)
        return counter.total_flops
    local = dataclasses.replace(shape, global_batch=position_rows(
        shape, mesh, rules))
    params = _meta_tree(free.abstract())
    inputs = {k: _meta(v.shape, v.dtype)
              for k, v in free.input_specs(local).items()}
    plan = tp_plan(free, mesh, rules)
    with counter:
        if plan is not None:
            weights = _meta((max(1, free.cfg.micro_batches),), torch.float32)
            loss_and_grads(free, [_member_tree(free, plan, mesh)], [inputs],
                           [weights], 0.0, plan.stand_in(mesh))
        else:
            loss_and_grads(free, [params], [inputs])
    return counter.total_flops


def corrected_terms(raw: Dict[str, Any], bodies: List[Dict[str, Any]]
                    ) -> Dict[str, float]:
    """The reference's correction: ``raw + (trips - 1) * body`` a term."""
    out = {"flops": float(raw.get("flops", 0.0)),
           "bytes": float(raw.get("bytes_accessed", 0.0)),
           "collective_bytes": float(
               raw.get("collectives", {}).get("total_bytes", 0.0))}
    for b in bodies:
        extra = max(0, b["trips"] - 1)
        out["flops"] += extra * b["flops"]
        out["bytes"] += extra * b["bytes"]
        out["collective_bytes"] += extra * b["collective_bytes"]
    return out


__all__ = ["layer_bodies", "layer_free_flops", "corrected_terms",
           "position_rows"]
