"""Prefill and decode with the params and the cache in placements on a
named mesh: the port's counterpart of the reference's jitted
``api.prefill`` / ``api.decode_step`` under ``tree_shardings`` (the dry
run's serve cells, ``src/repro/launch/dryrun.py``).

Single-controller over the mesh's positions, as the sharded train step
(:class:`~repro_torch.runtime.train.ShardedTrainStep`):

  * each position gathers the whole params from their blocks, and each
    cache leaf over every sharded dim but the batch dim
    (:func:`~repro_torch.core.placement.gather_blocks` with the batch axes
    kept): its rows of the cache at full extent;
  * each position runs the model on its rows of the inputs;
  * each position keeps its own block of the new cache.

The model axis replicates compute here: positions that share a batch
index compute the same rows at full width.  (The production-mesh train
step is tensor-parallel over it, ``models/tp.py``; placed prefill and
decode are not yet: the decode rules put the cache's ``kv_seq``, not the
heads, on ``model``.)  ``prefill(..., slot=r)`` prefills one request into row
``r`` of the batch cache (as the server fills a slot): only the
positions that hold row ``r`` compute.  A cache dim that no axis gathers
is the position's block itself, written in place, as the reference's
donated cache is.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional

import torch

from ..core.collectives import NamedMesh
from ..core.placement import (Placement, PlacedTensor, block_of, entry_axes,
                              gather_blocks, place_tree)
from ..core.treepath import tree_flatten
from ..models.registry import ModelApi
from ..configs.base import InputShape


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

    def cache_shardings(self, batch: int, max_seq: int) -> Dict[str,
                                                                Placement]:
        """The placements of a ``(batch, max_seq)`` cache."""
        from ..launch.mesh import tree_shardings

        shape = InputShape("cache", seq_len=max_seq, global_batch=batch,
                           mode="decode")
        return tree_shardings(self.mesh, self.api.cache_axes(shape),
                              self.rules, self.api.abstract_cache(shape))

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

    def _run(self, fn: Callable, params: Any, cache: Dict[str, Any],
             inputs: Dict[str, torch.Tensor], *, slot: Optional[int],
             traced: bool, count: Callable):
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
            if traced:
                continue
            for k in c_keys:
                new = new_cache[k]
                if slot is not None:
                    if new is not cache_p[k]:
                        cache_p[k].copy_(new)
                    new = local[k][p]
                block = block_of(new, placements[k], p, keep)
                # a cut of a gathered view is copied out, so the view goes
                new_blocks[k][p] = block.clone() if block.shape != new.shape \
                    else block
            for f in full:
                f[p] = None
        if traced:
            return logits[computed[0]], None
        new_cache = {k: PlacedTensor(cache[k].shape, cache[k].dtype,
                                     placements[k], new_blocks[k])
                     for k in c_keys}
        if slot is not None:
            return logits[computed[0]], new_cache
        return self._placed_logits(logits), new_cache

    def _placed_logits(self, logits: List[torch.Tensor]) -> PlacedTensor:
        """The positions' logits as one value placed over the batch
        axes (positions that share a batch index hold equal rows)."""
        t = logits[0]
        n = self.mesh.axis_size(self.batch_axes)
        spec = (self.batch_axes or None,)
        return PlacedTensor((t.shape[0] * n,) + tuple(t.shape[1:]), t.dtype,
                            Placement(self.mesh, spec), logits)

    # ------------------------------------------------------------------
    def prefill(self, params: Any, tokens: torch.Tensor,
                cache: Dict[str, Any], *, slot: Optional[int] = None,
                traced: bool = False,
                count: Callable = contextlib.nullcontext, **extra):
        """``(logits, new_cache)`` of a placed prefill: ``tokens`` (B, S)
        for the whole batch cache, or (1, S) into row ``slot``; ``extra``
        the vlm's ``patches`` / the encdec's ``frames``.  The logits are
        a :class:`PlacedTensor` over the batch axes (a slot's: the (1, 1,
        V) tensor of its first holder).  ``traced``: position 0 alone
        (or the slot's first holder) computes, under ``count()``, and
        only its logits come back (the dry run)."""
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
