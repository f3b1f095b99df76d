"""Logical-axis sharding rules, active only inside :func:`activate`.

The port's counterpart of ``repro/models/pspec.py``: a thread-local
context holds a mesh (:class:`~repro_torch.core.collectives.NamedMesh`)
and a rule table; :func:`logical_to_spec` maps logical axis names to mesh
axes as plain data (the entries the reference puts in a
``PartitionSpec``).  ``models/moe.py`` reads the context to take the
expert-parallel path.

Divergence by design: :func:`constrain` is the identity on values.
PyTorch has no GSPMD partitioner to hand a sharding constraint to: the
port's sharded computations split and move their pieces themselves, and
each position computes on its own rows, so no constraint has anything to
move.  Under an active context it checks what
``with_sharding_constraint`` checks of the call itself, that the axes
name one entry per dim of ``x``, and raises otherwise; outside a context
it does nothing, as the reference's does.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional, Tuple

_tls = threading.local()


def _normalize(entry):
    if entry is None or entry == ():
        return None
    if isinstance(entry, (list, tuple)):
        return tuple(entry) if len(entry) > 1 else entry[0]
    return entry


@contextlib.contextmanager
def activate(mesh, rules: dict):
    """Make ``mesh`` and ``rules`` the thread's active context."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = {"mesh": mesh, "rules": dict(rules)}
    try:
        yield
    finally:
        _tls.ctx = prev


def active_rules() -> Optional[dict]:
    ctx = getattr(_tls, "ctx", None)
    return ctx["rules"] if ctx else None


def active_mesh():
    ctx = getattr(_tls, "ctx", None)
    return ctx["mesh"] if ctx else None


def logical_to_spec(axes, rules: dict) -> Tuple[Any, ...]:
    """One entry a tensor dim: its mesh axis, a tuple of them, or None.  A
    mesh axis shards at most one dim (a later dim naming a used axis gets
    None)."""
    entries = []
    used = set()
    for name in axes:
        e = _normalize(rules.get(name)) if name is not None else None
        flat = e if isinstance(e, tuple) else ((e,) if e else ())
        if any(m in used for m in flat):
            e = None
        else:
            used.update(flat)
        entries.append(e)
    return tuple(entries)


def constrain(x: Any, *axes) -> Any:
    """``x`` as it is; under an active context a rank mismatch between
    ``axes`` and ``x`` raises ``ValueError`` (see the module
    docstring)."""
    if getattr(_tls, "ctx", None) is not None and len(axes) != x.dim():
        raise ValueError(f"constrain: {len(axes)} logical axes {axes} for "
                         f"a rank-{x.dim()} value of shape "
                         f"{tuple(x.shape)}")
    return x


__all__ = ["activate", "active_rules", "active_mesh", "logical_to_spec",
           "constrain"]
