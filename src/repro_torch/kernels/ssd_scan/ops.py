"""The full chunked SSD scan through the chunk kernel.

Counterpart of ``repro/kernels/ssd_scan/ops.py::ssd_chunked_kernel``, a
drop-in for ``repro.models.ssm.ssd_chunked`` (same signature and
semantics).  The chunk kernel reads x, dt and dtA in the model's (B, S,
nh, ...) layout through strided views, where the reference transposes
copies; its y_diag comes back as a view of the model's layout.  The
inter-chunk recurrence (a loop over the nc chunks) and the off-diagonal
term ``y_off`` stay plain torch, as the reference runs them in jnp: they
are linear in S and small next to the kernel's work.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernel import ssd_chunks


def ssd_chunked_kernel(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                       init_state: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, nh, hd), dt: (B, S, nh), A: (nh,), Bm/Cm: (B, S, N).
    Returns y (B, S, nh, hd) in x's dtype and the final state (B, nh, hd,
    N) f32."""
    Bsz, S, nh, hd = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = S // Q
    if nc * Q != S:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")

    xc = x.reshape(Bsz, nc, Q, nh, hd).transpose(2, 3)          # B,nc,nh,Q,hd
    dtf = dt.float()
    dtc = dtf.reshape(Bsz, nc, Q, nh).transpose(2, 3)[:, :, :, None, :]
    dtA = (dtf * A.float()).reshape(Bsz, nc, Q, nh).transpose(2, 3)[
        :, :, :, None, :]
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)

    y_diag, states, cum = ssd_chunks(xc, dtc, dtA, Bc, Cc)
    cum = cum[:, :, :, 0, :]                                    # B,nc,nh,Q

    # inter-chunk recurrence, linear in nc
    chunk_decay = torch.exp(cum[:, :, :, -1])                   # B,nc,nh
    state = torch.zeros((Bsz, nh, hd, N), dtype=torch.float32,
                        device=x.device) if init_state is None \
        else init_state.float()
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)                             # B,nc,nh,hd,N

    y_off = (Cc.float()[:, :, None] @ prev.transpose(-1, -2)) \
        * torch.exp(cum)[..., None]                             # B,nc,nh,Q,hd
    y = (y_diag.float() + y_off).transpose(2, 3).reshape(Bsz, S, nh, hd)
    return y.to(x.dtype), state
