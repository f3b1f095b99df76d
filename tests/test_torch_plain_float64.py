"""The kernels' plain versions compute in ``promote_types(dtype, float32)``:
given float64 they return float64, equal to a float64 numpy computation of
the same semantics within 1e-12 of the largest element (float32 and
bfloat16 inputs compute in float32, as before).  The float64 tests of the
models (``test_torch_sharded_train.py``) rely on it: a plain version that
cast float64 to float32 would run their attention and norms in float32.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import kernel as DK
from repro_torch.kernels.decode_attention import ref as DR
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ref as FR
from repro_torch.kernels.rmsnorm import kernel as RK
from repro_torch.kernels.rmsnorm import ref as RR
from repro_torch.kernels.ssd_scan import kernel as SK
from repro_torch.kernels.ssd_scan import ref as SR

REL = 1e-12
NEG_INF = -1e30


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want):
    assert got.dtype == torch.float64
    got = got.numpy()
    assert got.shape == want.shape
    top = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= REL * top


def np_attention(q, k, v, causal, kv_len, q_offset):
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    g = H // KV
    scale = 1.0 / math.sqrt(hd)
    kv_len = np.clip(kv_len, 1, Sk)
    q_offset = np.maximum(q_offset, 0)
    out = np.empty_like(q)
    for b in range(B):
        for h in range(H):
            s = q[b, h] @ k[b, h // g].T * scale                  # Sq, Sk
            kp = np.arange(Sk)[None, :]
            valid = kp < kv_len[b]
            if causal:
                valid = valid & (kp <= q_offset[b] + np.arange(Sq)[:, None])
            s = np.where(valid, s, NEG_INF)
            p = np.exp(s - s.max(-1, keepdims=True))
            out[b, h] = p @ v[b, h // g] / np.maximum(
                p.sum(-1, keepdims=True), 1e-30)
    return out


def np_decode(q, k, v, valid_len, block_k=512):
    B, H, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    g = H // KV
    out = np.empty_like(q)
    for b in range(B):
        for h in range(H):
            s = k[b, h // g] @ q[b, h] / math.sqrt(hd)
            s = np.where(np.arange(S) < valid_len[b], s, NEG_INF)
            p = np.exp(s - s.max())
            den = p.sum() if valid_len[b] > 0 else \
                float(DR.empty_denominator(S, block_k))
            out[b, h] = p @ v[b, h // g] / max(den, 1e-30)
    return out


def np_rmsnorm(x, scale, eps=1e-6):
    return x / np.sqrt((x * x).mean(-1, keepdims=True) + eps) * scale


def np_ssd_chunks(x, dt, dtA, Bm, Cm):
    B, nc, nh, Q, hd = x.shape
    N = Bm.shape[-1]
    y = np.empty_like(x)
    states = np.empty((B, nc, nh, hd, N))
    cum = np.cumsum(dtA[:, :, :, 0], axis=-1)                   # B,nc,nh,Q
    for b in range(B):
        for c in range(nc):
            cb = Cm[b, c] @ Bm[b, c].T                          # Q, Q
            for h in range(nh):
                cu = cum[b, c, h]
                L = np.where(np.tril(np.ones((Q, Q))) > 0,
                             np.exp(cu[:, None] - cu[None, :]), 0.0)
                dtx = x[b, c, h] * dt[b, c, h, 0][:, None]
                y[b, c, h] = (cb * L) @ dtx
                states[b, c, h] = (dtx * np.exp(cu[-1] - cu)[:, None]).T \
                    @ Bm[b, c]
    return y, states, cum[:, :, :, None, :]


def _attention_inputs(seed=0):
    r = _rng(seed)
    q = r.standard_normal((2, 4, 5, 16))
    k = r.standard_normal((2, 2, 9, 16))
    v = r.standard_normal((2, 2, 9, 16))
    return q, k, v, np.array([9, 6]), np.array([4, 0])


@pytest.mark.parametrize("fn", [FR.attention_ref, FR.attention_tiled_ref,
                                FK.flash_attention],
                         ids=["plain", "tiled", "wrapper"])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_in_float64(fn, causal):
    q, k, v, kv_len, off = _attention_inputs()
    kw = {"block_k": 4} if fn is FR.attention_tiled_ref else {}
    got = fn(_t(q), _t(k), _t(v), causal=causal, kv_len=_t(kv_len),
             q_offset=_t(off), **kw)
    _close(got, np_attention(q, k, v, causal, kv_len, off))


@pytest.mark.parametrize("fn", [DR.decode_ref, DR.decode_split_ref,
                                DK.decode_attention],
                         ids=["plain", "split", "wrapper"])
def test_decode_in_float64(fn):
    r = _rng(1)
    q = r.standard_normal((3, 4, 16))
    k = r.standard_normal((3, 2, 40, 16))
    v = r.standard_normal((3, 2, 40, 16))
    valid = np.array([0, 17, 40])
    kw = {"split": 16} if fn is DR.decode_split_ref else {}
    got = fn(_t(q), _t(k), _t(v), _t(valid), **kw)
    _close(got, np_decode(q, k, v, valid))


@pytest.mark.parametrize("fn", [RR.rmsnorm_ref, RK.rmsnorm],
                         ids=["plain", "wrapper"])
def test_rmsnorm_in_float64(fn):
    r = _rng(2)
    x = r.standard_normal((3, 5, 24))
    scale = r.standard_normal(24)
    got = fn(_t(x), _t(scale)) if fn is RR.rmsnorm_ref \
        else fn(_t(x), _t(scale), eps=1e-6)
    _close(got, np_rmsnorm(x, scale))


@pytest.mark.parametrize("fn", [SR.ssd_chunks_ref, SK.ssd_chunks],
                         ids=["plain", "wrapper"])
def test_ssd_chunks_in_float64(fn):
    r = _rng(3)
    B, nc, nh, Q, hd, N = 2, 2, 3, 8, 4, 5
    x = r.standard_normal((B, nc, nh, Q, hd))
    dt = r.uniform(0.01, 0.2, (B, nc, nh, 1, Q))
    dtA = -r.uniform(0.0, 0.5, (B, nc, nh, 1, Q))
    Bm = r.standard_normal((B, nc, Q, N))
    Cm = r.standard_normal((B, nc, Q, N))
    got = fn(*(_t(a) for a in (x, dt, dtA, Bm, Cm)))
    for g, w in zip(got, np_ssd_chunks(x, dt, dtA, Bm, Cm)):
        _close(g, w)


def test_narrower_inputs_still_compute_in_float32():
    """bf16 in: the f32 arithmetic, bf16 out; states and cum f32."""
    q, k, v, kv_len, off = _attention_inputs()
    bf = [_t(a).to(torch.bfloat16) for a in (q, k, v)]
    got = FR.attention_ref(*bf, kv_len=_t(kv_len), q_offset=_t(off))
    want = FR.attention_ref(*(t.float() for t in bf), kv_len=_t(kv_len),
                            q_offset=_t(off)).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    x = torch.randn(2, 1, 3, 4, 8, dtype=torch.bfloat16)
    dt = torch.rand(2, 1, 3, 1, 4)
    y, states, cum = SR.ssd_chunks_ref(x, dt, -dt, torch.randn(2, 1, 4, 8),
                                       torch.randn(2, 1, 4, 8))
    assert (y.dtype, states.dtype, cum.dtype) == (torch.bfloat16,
                                                  torch.float32,
                                                  torch.float32)
