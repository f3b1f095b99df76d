"""The numerics of the redesigned attention kernels, held on the CPU.

The CUDA kernels run only on a card; what runs here are two tile-level
models of their algorithms, in plain PyTorch, used only by tests:

  * ``attention_tiled_ref`` — the flash kernels' online softmax over
    64-key tiles, with P rounded to bf16 before P V in bf16 (the
    tensor-core kernel's A operand) and kept in f32 in float32 (the FMA
    kernel);
  * ``decode_split_ref`` — the split-KV decode kernel's per-split partials
    and their combine, the ``valid_len == 0`` value included.

Each is held against the plain version its wrapper runs on the CPU
(``attention_ref`` / ``decode_ref``) and against the Pallas kernel in
interpret mode and the reference's oracle, at the smoke models' shapes and
at the edge cases the card tests drive: lengths that are not multiples of
64, per-batch query offsets and key lengths, every head dim 16 to 128, GQA
groups of 1, 4 and 8, and valid lengths on both sides of a split.
Tolerances: 2e-2 in bf16 (``tests/test_kernels.py``'s), 1e-5 in float32.
"""
import jax.numpy as jnp
import ml_dtypes  # noqa: F401  (registers numpy's bfloat16 for the reference)
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import kernel as r_da, ref as r_da_ref
from repro.kernels.flash_attention import ops as r_fa, ref as r_fa_ref

from repro_torch.kernels.decode_attention import kernel as DK, ref as DR
from repro_torch.kernels.flash_attention import kernel as FK, ref as FR
from repro_torch.models import registry as p_registry

SPLIT = 256               # one of the kernel's splits, DK.SPLITS


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)


def _pair(a, dtype):
    """One numpy draw as a JAX array and a torch CPU tensor of ``dtype``
    (bf16 rounded once, the same way in both)."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(np.array(jnp.asarray(j, jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _np(t):
    return t.float().numpy()


def _smoke_attention_shape():
    cfg = p_registry.get("llama3.2-1b", smoke=True).cfg
    return cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim


# ----------------------------------------------------------------- flash

@pytest.mark.parametrize("hd", FK.HEAD_DIMS)
@pytest.mark.parametrize("Sq,Sk", [(1, 1), (63, 63), (65, 65), (65, 200),
                                   (130, 130)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_tiled_model_equals_plain_version(hd, Sq, Sk, causal, dtype):
    rng = np.random.default_rng(hd * 1000 + Sq + Sk)
    _, q = _pair(rng.standard_normal((2, 8, Sq, hd)), dtype)
    _, k = _pair(rng.standard_normal((2, 2, Sk, hd)), dtype)
    _, v = _pair(rng.standard_normal((2, 2, Sk, hd)), dtype)
    got = FR.attention_tiled_ref(q, k, v, causal=causal)
    want = FR.attention_ref(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("hd", FK.HEAD_DIMS)
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2), (8, 1)])   # g = 1, 4, 8
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_tiled_model_at_offsets_equals_plain_version(hd, H, KV, dtype):
    """Per-batch query offsets and key lengths, as a prefill at a nonzero
    cache position passes them; batch 2's offset row 0 sees key 0 alone
    (length 1), and an offset below 0 and a length below 1 are clamped."""
    rng = np.random.default_rng(hd + H)
    _, q = _pair(rng.standard_normal((4, H, 70, hd)), dtype)
    _, k = _pair(rng.standard_normal((4, KV, 938, hd)), dtype)
    _, v = _pair(rng.standard_normal((4, KV, 938, hd)), dtype)
    off = torch.tensor([3, 868, 65, -4])
    kv_len = torch.tensor([73, 938, 1, 0])
    got = FR.attention_tiled_ref(q, k, v, causal=True, kv_len=kv_len,
                                 q_offset=off)
    want = FR.attention_ref(q, k, v, causal=True, kv_len=kv_len,
                            q_offset=off)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    key0 = v[2:, :, :1].repeat_interleave(H // KV, dim=1).expand(2, H, 70, hd)
    np.testing.assert_allclose(_np(got[2:]), _np(key0), **_tol(dtype))


def test_flash_tiled_model_rounds_p_in_bf16_only():
    """In bf16 the model rounds P before P V, so it differs from the plain
    version by rounding (not by more); in f32 it matches it closely."""
    rng = np.random.default_rng(0)
    a = [rng.standard_normal((1, 2, 100, 64)) for _ in range(3)]
    for dtype, lo, hi in (("float32", 0.0, 1e-6), ("bfloat16", 1e-4, 2e-2)):
        q, k, v = (_pair(x, dtype)[1] for x in a)
        d = (FR.attention_tiled_ref(q, k, v).float()
             - FR.attention_ref(q, k, v).float()).abs().max()
        assert lo <= float(d) <= hi, (dtype, float(d))


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd", [
    (2, 4, 2, 37, 37, 16),            # the smoke models' attention
    (2, 4, 2, 64, 200, 16),
    (1, 8, 8, 65, 130, 128),
    (2, 4, 1, 63, 63, 64),
    (1, 4, 4, 100, 100, 80),          # zamba2's head dim
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_tiled_model_equals_pallas(B, H, KV, Sq, Sk, hd, causal, dtype):
    if (B, H, KV, Sq, Sk, hd) == (2, 4, 2, 37, 37, 16):
        assert (H, KV, hd) == _smoke_attention_shape()
    rng = np.random.default_rng(Sq * Sk)
    qj, qt = _pair(rng.standard_normal((B, Sq, H, hd)), dtype)
    kj, kt = _pair(rng.standard_normal((B, Sk, KV, hd)), dtype)
    vj, vt = _pair(rng.standard_normal((B, Sk, KV, hd)), dtype)
    got = _np(FR.attention_tiled_ref(qt.transpose(1, 2), kt.transpose(1, 2),
                                     vt.transpose(1, 2), causal=causal
                                     ).transpose(1, 2))
    pallas = np.asarray(r_fa.mha(qj, kj, vj, causal=causal, interpret=True),
                        np.float32)
    oracle = np.asarray(r_fa_ref.attention_ref(
        qj.transpose(0, 2, 1, 3).astype(jnp.float32),
        kj.transpose(0, 2, 1, 3).astype(jnp.float32),
        vj.transpose(0, 2, 1, 3).astype(jnp.float32),
        causal=causal).transpose(0, 2, 1, 3), np.float32)
    tol = _tol(dtype) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, pallas, **tol)
    np.testing.assert_allclose(got, oracle, **tol)


# ---------------------------------------------------------------- decode

VALID = [0, 1, SPLIT - 1, SPLIT, SPLIT + 1]


@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2)])            # g = 1, 4
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [2 * SPLIT + 88, 2 * SPLIT])
def test_decode_split_model_equals_plain_version(hd, H, KV, dtype, S):
    """valid_len in {0, 1, split - 1, split, split + 1, S, S + 5}: empty,
    one key, both sides of a split boundary, the whole cache and past it."""
    rng = np.random.default_rng(hd + H + S)
    valid = torch.tensor(VALID + [S, S + 5], dtype=torch.int32)
    B = len(valid)
    _, q = _pair(rng.standard_normal((B, H, hd)), dtype)
    _, k = _pair(rng.standard_normal((B, KV, S, hd)), dtype)
    _, v = _pair(rng.standard_normal((B, KV, S, hd)), dtype)
    got = DR.decode_split_ref(q, k, v, valid, split=SPLIT)
    want = DR.decode_ref(q, k, v, valid)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    # the empty row keeps the Pallas kernel's value
    empty = v[0].float().sum(dim=1) / DR.empty_denominator(S)
    np.testing.assert_allclose(
        _np(got[0]), empty.repeat_interleave(H // KV, dim=0).numpy(),
        **_tol(dtype))


@pytest.mark.parametrize("split", DK.SPLITS)
def test_decode_split_model_does_not_depend_on_the_split(split):
    rng = np.random.default_rng(split)
    valid = torch.tensor([0, 1, 63, 64, 65, 300, 999], dtype=torch.int32)
    _, q = _pair(rng.standard_normal((7, 8, 64)), "float32")
    _, k = _pair(rng.standard_normal((7, 2, 600, 64)), "float32")
    _, v = _pair(rng.standard_normal((7, 2, 600, 64)), "float32")
    np.testing.assert_allclose(
        _np(DR.decode_split_ref(q, k, v, valid, split=split)),
        _np(DR.decode_ref(q, k, v, valid)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,H,KV,S,hd,bk", [
    (3, 4, 2, 64, 16, 64),            # the smoke models' attention
    (7, 4, 4, 512, 64, 128),          # g = 1
    (7, 8, 2, 512, 80, 128),          # g = 4, zamba2's head dim
    (2, 8, 1, 2 * SPLIT + 88, 64, 512),  # g = 8, a ragged last split
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_split_model_equals_pallas(B, H, KV, S, hd, bk, dtype):
    if hd == 16:
        assert (H, KV, hd) == _smoke_attention_shape()
    rng = np.random.default_rng(S + hd)
    qj, qt = _pair(rng.standard_normal((B, H, hd)), dtype)
    kj, kt = _pair(rng.standard_normal((B, KV, S, hd)), dtype)
    vj, vt = _pair(rng.standard_normal((B, KV, S, hd)), dtype)
    # the Pallas kernel pads S to its key block and does not clamp
    # valid_len to S, so lengths stay within S here
    valid = np.array(([0, 1, SPLIT - 1, SPLIT, SPLIT + 1, S, S - 3]
                      if S > SPLIT + 1 else [0, S, 17])[:B], np.int32)
    valid = np.minimum(valid, S)
    got = _np(DR.decode_split_ref(qt, kt, vt, torch.from_numpy(valid),
                                  block_k=bk, split=SPLIT))
    pallas = np.asarray(r_da.decode_attention(
        qj, kj, vj, jnp.asarray(valid), interpret=True, block_k=bk),
        np.float32)
    tol = _tol(dtype) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, pallas, **tol)
    live = valid > 0                  # the oracle gives NaN for an empty row
    oracle = np.asarray(r_da_ref.decode_ref(
        qj.astype(jnp.float32), kj.astype(jnp.float32),
        vj.astype(jnp.float32), jnp.asarray(valid)), np.float32)
    np.testing.assert_allclose(got[live], oracle[live], **tol)


@pytest.mark.parametrize("S,want", [
    (2048, 128),                      # the serve phases' cache
    (8192, 512),                      # chip_smoke's large decode shape
    (600, 64),                        # the card tests' shapes
    (1, 64),
    (100000, 512),
])
def test_decode_split_comes_from_the_capacity(S, want):
    assert DK.split_keys(S) == want
    assert SPLIT in DK.SPLITS and all(s % 64 == 0 for s in DK.SPLITS)


def test_decode_wrapper_takes_the_kernels_head_dims():
    """On the CPU the wrapper runs the plain version at any head dim; the
    head dims it names are the CUDA kernels'."""
    assert DK.HEAD_DIMS == FK.HEAD_DIMS == (16, 32, 64, 80, 96, 128)
    q = torch.randn(1, 2, 24)
    k = torch.randn(1, 1, 9, 24)
    got = DK.decode_attention(q, k, k, torch.tensor([5]))
    torch.testing.assert_close(got, DR.decode_ref(q, k, k, torch.tensor([5])))
