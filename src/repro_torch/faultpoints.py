"""Fault-injection point names, as importable constants.

The port's copy of ``repro/faultpoints.py``: a typo'd point string never
fires, so call sites name points through these constants: the checkpoint
points in :mod:`repro_torch.checkpoint`, ``restore.h2d`` in the train
loop, the serve points in :mod:`repro_torch.runtime.serve`.
"""

CKPT_PACK = "ckpt.pack"
CKPT_WRITE = "ckpt.write"
CKPT_COMMIT = "ckpt.commit"
CKPT_GC = "ckpt.gc"
RESTORE_H2D = "restore.h2d"
SERVE_PREFILL_PACK = "serve.prefill_pack"
SERVE_DECODE_STEP = "serve.decode_step"
SERVE_SLOT_REFILL = "serve.slot_refill"
SERVE_POLICY_SWAP = "serve.policy_swap"

POINTS = (
    CKPT_PACK,
    CKPT_WRITE,
    CKPT_COMMIT,
    CKPT_GC,
    RESTORE_H2D,
    SERVE_PREFILL_PACK,
    SERVE_DECODE_STEP,
    SERVE_SLOT_REFILL,
    SERVE_POLICY_SWAP,
)

SERVE_POINTS = tuple(p for p in POINTS if p.startswith("serve."))
