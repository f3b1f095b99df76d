"""Prefill and decode with the params and the cache in placements on a
named mesh: the port's counterpart of the reference's jitted
``api.prefill`` / ``api.decode_step`` under ``tree_shardings`` (the dry
run's serve cells, ``src/repro/launch/dryrun.py``).

Single-controller over the mesh's positions, as the sharded train step
(:class:`~repro_torch.runtime.train.ShardedTrainStep`).  Where the
params' placements split a region over the mesh's ``model`` axis (the
serve rules put ``heads``, ``mlp``, ``vocab``, ``expert_mlp``,
``ssm_inner`` and ``ssm_heads`` there: :attr:`PlacedServe.plan`,
``models/tp.py``), the members of each model group compute tensor-parallel
in lock step (``lm.serve_tp``; the encoder-decoder's ``encdec.serve_tp``),
as GSPMD partitions the reference's prefill and decode:

  * each position gathers its blocks of the split leaves over the data
    axes only, the other leaves whole (``tp.gather_params``, as the train
    step);
  * each position keeps its block of the cache: its rows of the batch,
    its block of the k / v sequence (``kv_seq`` on ``model`` under the
    decode rules; the whole sequence under the prefill rules), and its
    heads' Mamba2 ``state`` and their channels' ``conv`` tail where the
    mixers split; it writes the new tokens' k / v that fall in its
    block in place, and gathers over ``model`` only the kv heads its
    query heads read (``lm._kv_seqs``); the encoder-decoder's memory,
    ``enc_out``, is whole on every member of a group (its rows), and a
    prefill given ``frames`` runs the encoder once, each member on its
    query heads and its block of d_ff, before the decoder;
  * each sublayer runs on its share between the group's ``enter`` and
    ``leave`` (a ``psum``); the embedding and the head are
    vocab-parallel, so the logits come back placed ``(batch axes, None,
    "model")``, the reference's ``constrain(logits, "batch", None,
    "vocab")``.

Where nothing splits (a ``model`` axis of size 1 or none, arctic's 56
heads over 16, which the reference's demotion leaves whole),
:attr:`PlacedServe.plan` is None and the model axis replicates compute:

  * each position gathers the whole params from their blocks, and each
    cache leaf over every sharded dim but the batch dim
    (:func:`~repro_torch.core.placement.gather_blocks` with the batch axes
    kept): its rows of the cache at full extent;
  * each position runs the model on its rows of the inputs;
  * each position keeps its own block of the new cache.

``prefill(..., slot=r)`` prefills one request into row ``r`` of the
batch cache (as the server fills a slot): only the positions that hold
row ``r`` compute.  A cache dim that no axis gathers is the position's
block itself, written in place, as the reference's donated cache is.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..core.collectives import NamedMesh
from ..core.placement import (Placement, PlacedTensor, block_of, entry_axes,
                              gather_blocks, place_tree)
from ..core.treepath import tree_flatten
from ..models import encdec, lm
from ..models import tp as TP
from ..models.registry import ModelApi
from ..configs.base import InputShape


def _seq_split(placement: Placement) -> bool:
    """Whether a k / v cache leaf's placement blocks its sequence dim
    (``(layers, batch, kv_seq, kv_heads, head_dim)``) over ``model``."""
    return entry_axes(placement._entries(5)[2]) == (TP.AXIS,)


def _new_block(new: torch.Tensor, mine: torch.Tensor, view: torch.Tensor,
               placement: Placement, p: int, keep: Tuple[str, ...],
               slot: Optional[int]) -> torch.Tensor:
    """Position ``p``'s new block of a cache leaf from the value its model
    returned, ``new``, for the cache it was given, ``mine``: its gathered
    ``view`` of the leaf (over every axis but ``keep``), or with a
    ``slot`` the row of it, which ``new`` overwrites (unless written in
    place) before the block is cut from the whole view.  A cut of a
    gathered view is copied out, so the view goes."""
    if slot is not None:
        if new is not mine:
            mine.copy_(new)
        new = view
    block = block_of(new, placement, p, keep)
    return block.clone() if block.shape != new.shape else block


class PlacedServe:
    """Placed prefill and decode for ``api`` on ``mesh`` under ``rules``
    (a rule table, its batch rule already adapted to the batch size:
    ``launch.mesh.adapt_batch_rule``)."""

    def __init__(self, api: ModelApi, mesh: NamedMesh, rules: Dict):
        from ..launch.mesh import tree_shardings

        self.api, self.mesh, self.rules = api, mesh, dict(rules)
        self.batch_axes = entry_axes(self.rules.get("batch"))
        self.param_shardings = tree_shardings(mesh, api.axes(), self.rules,
                                              api.abstract())
        self.plan = TP.plan(api.cfg, mesh, self.param_shardings,
                            self.rules.get("batch"))

    def gathered_param_bytes(self) -> int:
        """The bytes of params one position gathers for a prefill or a
        decode step: its blocks of the split leaves, whole over the data
        axes, and the other leaves whole (all of them whole without a
        :attr:`plan`)."""
        return TP.gathered_param_bytes(self.api.abstract(), self.plan,
                                       self.mesh)

    def cache_shardings(self, batch: int, max_seq: int) -> Dict[str,
                                                                Placement]:
        """The placements of a ``(batch, max_seq)`` cache."""
        from ..launch.mesh import tree_shardings

        shape = InputShape("cache", seq_len=max_seq, global_batch=batch,
                           mode="decode")
        return tree_shardings(self.mesh, self.api.cache_axes(shape),
                              self.rules, self.api.abstract_cache(shape))

    def kv_split(self, batch: int, max_seq: int) -> bool:
        """Whether a ``(batch, max_seq)`` cache's k / v sequence splits
        over the model groups (the decode rules' ``kv_seq``), so that a
        tensor-parallel member holds its block of it."""
        pl = self.cache_shardings(batch, max_seq).get("k")
        return pl is not None and _seq_split(pl)

    def place_params(self, params: Any) -> Any:
        return place_tree(params, self.param_shardings)

    def place_cache(self, cache: Dict[str, Any]) -> Dict[str, Any]:
        """A cache (tensors or placed leaves) in :meth:`cache_shardings`
        of its size."""
        max_seq = cache["k"].shape[2] if "k" in cache else 1
        return place_tree(cache, self.cache_shardings(cache["pos"].shape[0],
                                                      max_seq))

    # ------------------------------------------------------------------
    def _batch_dims(self) -> Dict[str, int]:
        """Each cache leaf's batch dim."""
        shape = InputShape("cache", seq_len=1, global_batch=1, mode="decode")
        return {k: axes.index("batch")
                for k, axes in self.api.cache_axes(shape).items()}

    def _rows(self, inputs: Dict[str, torch.Tensor], p: int, n: int,
              dev: torch.device) -> Dict[str, torch.Tensor]:
        i = self.mesh.index(p, self.batch_axes)
        out = {}
        for k, v in inputs.items():
            rows = v.shape[0] // n
            out[k] = v[i * rows:(i + 1) * rows].to(dev)
        return out

    def _cache_keep(self, key: str) -> Tuple[str, ...]:
        """The axes cache leaf ``key`` keeps its block over when gathered:
        the batch axes, and under a :attr:`plan` ``model`` for the k / v
        (the attention gathers what it reads itself) and for the Mamba2
        ``state`` / ``conv`` where the mixers split.  The encoder-decoder's
        ``enc_out`` keeps the batch axes alone: it is whole on every
        member."""
        plan = self.plan
        if plan is not None and (key in ("k", "v") or plan.ssm and key in (
                "state", "conv")):
            return self.batch_axes + (TP.AXIS,)
        return self.batch_axes

    def _run_tp(self, params: Any, cache: Dict[str, Any],
                inputs: Dict[str, torch.Tensor], *, slot: Optional[int],
                traced: bool, count: Callable):
        """:meth:`_run` tensor-parallel over each model group of the
        positions that compute (``lm.serve_tp``, or ``encdec.serve_tp``
        for the encoder-decoder, given its ``frames``)."""
        mesh, plan, axes, cfg = self.mesh, self.plan, self.batch_axes, \
            self.api.cfg
        serve_tp = encdec.serve_tp if cfg.is_encdec else lm.serve_tp
        p_leaves, p_def = tree_flatten(self.place_params(params))
        full = TP.gather_params(p_leaves, plan)
        c_keys = sorted(cache)
        placements = {k: cache[k].placement for k in c_keys}
        keeps = {k: self._cache_keep(k) for k in c_keys}
        local = {k: gather_blocks(cache[k], keeps[k]) for k in c_keys}
        n = mesh.axis_size(axes)
        bdims = self._batch_dims()
        b_local = cache["pos"].shape[0] // n
        kv_split = "k" in cache and _seq_split(placements["k"])
        groups = [g for g in mesh.groups(TP.AXIS) if slot is None
                  or mesh.index(g[0], axes) == slot // b_local]
        groups = groups[:1] if traced else groups
        logits: List[Optional[torch.Tensor]] = [None] * mesh.size
        new_blocks = {k: list(cache[k].blocks) for k in c_keys}
        for g in groups:
            group = plan.group(mesh, g, stand_in=traced)
            mine = [group.members[r] for r in group.ranks]
            devs = [mesh.positions[p] for p in mine]
            params_g = [p_def.unflatten([f[p] for f in full]) for p in mine]
            if slot is None:
                caches = [{k: local[k][p] for k in c_keys} for p in mine]
                inp = [self._rows(inputs, p, n, d) for p, d in zip(mine,
                                                                   devs)]
            else:
                r = slot % b_local
                caches = [{k: local[k][p].narrow(bdims[k], r, 1)
                           for k in c_keys} for p in mine]
                inp = [{k: v.to(d) for k, v in inputs.items()} for d in devs]
            extra = {k: [i[k] for i in inp] for k in inputs if k != "tokens"}
            with count():
                outs, new_caches = serve_tp(
                    cfg, group, params_g, [i["tokens"] for i in inp], caches,
                    kv_split=kv_split, **extra)
            for p, out, c, new_c in zip(mine, outs, caches, new_caches):
                logits[p] = out
                for k in c_keys:
                    new_blocks[k][p] = _new_block(
                        new_c[k], c[k], local[k][p], placements[k], p,
                        keeps[k], slot)
                for f in full:
                    f[p] = None
        if traced:
            p = groups[0][0]
            return logits[p], {k: new_blocks[k][p] for k in c_keys}
        new_cache = {k: PlacedTensor(cache[k].shape, cache[k].dtype,
                                     placements[k], new_blocks[k])
                     for k in c_keys}
        if slot is not None:
            parts = [logits[p] for p in groups[0]]
            if plan.vocab:
                return torch.cat([t.to(parts[0].device) for t in parts],
                                 dim=-1), new_cache
            return parts[0], new_cache
        return self._placed_logits(logits, plan.vocab), new_cache

    def _run(self, fn: Callable, params: Any, cache: Dict[str, Any],
             inputs: Dict[str, torch.Tensor], *, slot: Optional[int],
             traced: bool, count: Callable):
        if self.plan is not None:
            return self._run_tp(params, cache, inputs, slot=slot,
                                traced=traced, count=count)
        mesh, keep = self.mesh, self.batch_axes
        params = self.place_params(params)
        p_leaves, p_def = tree_flatten(params)
        full = [gather_blocks(x) for x in p_leaves]
        c_keys = sorted(cache)
        placements = {k: cache[k].placement for k in c_keys}
        local = {k: gather_blocks(cache[k], keep) for k in c_keys}
        n = mesh.axis_size(keep)
        bdims = self._batch_dims()
        b_local = cache[c_keys[0]].shape[bdims[c_keys[0]]] // n
        if slot is None:
            computed = [0] if traced else list(range(mesh.size))
        else:
            computed = [p for p in range(mesh.size)
                        if mesh.index(p, keep) == slot // b_local]
            computed = computed[:1] if traced else computed
        logits: List[Optional[torch.Tensor]] = [None] * mesh.size
        new_blocks = {k: list(cache[k].blocks) for k in c_keys}
        for p in computed:
            dev = mesh.positions[p]
            params_p = p_def.unflatten([f[p] for f in full])
            if slot is None:
                cache_p = {k: local[k][p] for k in c_keys}
                inp = self._rows(inputs, p, n, dev)
            else:
                r = slot % b_local
                cache_p = {k: local[k][p].narrow(bdims[k], r, 1)
                           for k in c_keys}
                inp = {k: v.to(dev) for k, v in inputs.items()}
            with count():
                out, new_cache = fn(params_p, inp.pop("tokens"), cache_p,
                                    **inp)
            logits[p] = out
            for k in c_keys:
                new_blocks[k][p] = _new_block(
                    new_cache[k], cache_p[k], local[k][p], placements[k], p,
                    keep, slot)
            for f in full:
                f[p] = None
        if traced:
            p = computed[0]
            return logits[p], {k: new_blocks[k][p] for k in c_keys}
        new_cache = {k: PlacedTensor(cache[k].shape, cache[k].dtype,
                                     placements[k], new_blocks[k])
                     for k in c_keys}
        if slot is not None:
            return logits[computed[0]], new_cache
        return self._placed_logits(logits), new_cache

    def _placed_logits(self, logits: List[torch.Tensor],
                       vocab: bool = False) -> PlacedTensor:
        """The positions' logits as one value placed over the batch
        axes (positions that share a batch index hold equal rows), and
        with ``vocab`` its last dim over ``model`` (each position's block
        of the vocab)."""
        t = logits[0]
        shape = [t.shape[0] * self.mesh.axis_size(self.batch_axes)] \
            + list(t.shape[1:])
        spec = (self.batch_axes or None,)
        if vocab:
            shape[-1] *= self.mesh.shape[TP.AXIS]
            spec += (None, TP.AXIS)
        return PlacedTensor(shape, t.dtype, Placement(self.mesh, spec),
                            logits)

    # ------------------------------------------------------------------
    def prefill(self, params: Any, tokens: torch.Tensor,
                cache: Dict[str, Any], *, slot: Optional[int] = None,
                traced: bool = False,
                count: Callable = contextlib.nullcontext, **extra):
        """``(logits, new_cache)`` of a placed prefill: ``tokens`` (B, S)
        for the whole batch cache, or (1, S) into row ``slot``; ``extra``
        the vlm's ``patches`` / the encdec's ``frames``.  The logits are
        a :class:`PlacedTensor` over the batch axes, its last dim over
        ``model`` where the :attr:`plan` splits the vocab (a slot's: the
        whole (1, 1, V) tensor on its first holder).  ``traced``:
        position 0 alone (or the slot's first holder; under a
        :attr:`plan` its model group with member 0 computed, the others
        standing in) computes, under ``count()``, and its logits and its
        new blocks of the cache come back as tensors (the dry run, on
        meta positions)."""
        inputs = {"tokens": tokens, **extra}
        return self._run(self.api.prefill, params, cache, inputs, slot=slot,
                         traced=traced, count=count)

    def decode_step(self, params: Any, tokens: torch.Tensor,
                    cache: Dict[str, Any], *, traced: bool = False,
                    count: Callable = contextlib.nullcontext):
        """One token a row, (B, 1), against the placed cache."""
        return self._run(self.api.decode_step, params, cache,
                         {"tokens": tokens}, slot=None, traced=traced,
                         count=count)


__all__ = ["PlacedServe"]
