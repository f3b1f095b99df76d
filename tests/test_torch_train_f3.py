"""Does the reference learn a repeated batch as slowly as the port does?

On the card, llama3.2-1b at full size in bf16 (AdamW, ``warmup_cosine`` at
the CLI's peak 3e-4 with 2 warmup steps) lowers the loss on one repeated
batch by only about 0.05 nat a step.  Both packages keep bf16 params with
no float32 master copy, so an update smaller than half a bf16 ulp of its
param is lost in either.  This test trains both packages at llama3.2-1b's
depth and heads, at a smoke width, in bf16, from the same state, on one
batch repeated, and holds the port's loss to the reference's at every
step: if they agree the slow learning is the reference's own behaviour.
It also counts, per step, the share of bf16 param elements that the
update leaves unchanged (the rounding swallowed it), and holds the port's
share to the reference's.
"""
from __future__ import annotations

import jax
import numpy as np
import torch

from repro.optim import make_optimizer as r_make
from repro.optim import warmup_cosine as r_warmup_cosine
from repro.runtime import train as r_train

from repro_torch.convert import train_state_from_reference
from repro_torch.core import tree_leaves
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.runtime import train as p_train
from test_torch_train import CPU, _batch, _pair
from test_torch_train_precision import WIDTH

BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
LAYERS, STEPS, PEAK_LR, WARMUP = 16, 7, 3e-4, 2
# bf16 compute in both packages, rounded in different places (XLA fuses
# elementwise chains, eager PyTorch rounds each op): the loss of a step
# within 2e-2 of the reference's, relative
LOSS_RTOL = 2e-2
# the share of param elements an update leaves unchanged, port vs
# reference, absolute (the two round the same updates to the same bf16
# grid; they differ where their gradients do)
UNCHANGED_ATOL = 1e-2


def _unchanged(before, after) -> float:
    same = sum(int(np.sum(a == b)) for a, b in zip(before, after))
    return same / sum(a.size for a in before)


def _ref_params(state):
    return [np.asarray(x, np.float32)
            for x in jax.tree_util.tree_leaves(state["params"])]


def _port_params(state):
    return [x.float().numpy().copy() for x in tree_leaves(state["params"])]


def test_bf16_training_on_a_repeated_batch_matches_the_reference():
    r_api, p_api = _pair("llama3.2-1b", num_layers=LAYERS, **WIDTH, **BF16)
    state = r_train.train_state(r_api, r_make("adamw"),
                                jax.random.PRNGKey(0))
    batch = _batch(WIDTH["vocab_size"], B=4, S=32, seed=3)
    r_step = jax.jit(r_train.make_train_step(
        r_api, r_make("adamw"), r_warmup_cosine(PEAK_LR, WARMUP, STEPS)))
    p_step = p_train.make_train_step(
        p_api, make_optimizer("adamw"), warmup_cosine(PEAK_LR, WARMUP, STEPS))
    p_state = train_state_from_reference(jax.device_get(state), CPU)
    p_batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    ref, port, lrs, r_same, p_same = [], [], [], [], []
    for _ in range(STEPS):
        r_before, p_before = _ref_params(state), _port_params(p_state)
        state, r_met = r_step(state, batch)
        p_state, p_met = p_step(p_state, p_batch)
        ref.append(float(r_met["loss"]))
        port.append(float(p_met["loss"]))
        lrs.append(float(r_met["lr"]))
        r_same.append(_unchanged(r_before, _ref_params(state)))
        p_same.append(_unchanged(p_before, _port_params(p_state)))
        np.testing.assert_allclose(float(p_met["lr"]), lrs[-1], rtol=1e-6)
    np.testing.assert_allclose(port, ref, rtol=LOSS_RTOL,
                               err_msg=f"port {port} vs reference {ref}")
    np.testing.assert_allclose(p_same, r_same, atol=UNCHANGED_ATOL)
    # both learn the batch, slowly; an update at lr 0 moves nothing, and
    # even at the peak lr a third of the elements keep their bf16 value
    for losses, same in ((ref, r_same), (port, p_same)):
        assert losses[-1] < losses[0], losses
        assert same[0] == 1.0 and min(same) > 0.25, same
    print(f"reference losses {ref}\nport losses {port}\nlrs {lrs}\n"
          f"unchanged: reference {r_same}, port {p_same}")
