"""The CPU model of the bf16 ``ssd_chunks`` kernel's arithmetic,
``ssd_scan/ref.py::ssd_chunks_split_ref``, held against the JAX package and
against the plain version.

The tensor-core kernel takes bf16 operands, so it splits the f32 weighted
scores P and the state operand x·w into bf16 hi + lo parts and sums both
products.  The model does the same on the CPU:

  * at ``test_torch_ssm.py``'s shapes, with x, B and C rounded to bf16 (the
    kernel's inputs, exact as operands), it equals the Pallas kernel in
    interpret mode and ``repro/kernels/ssd_scan/ref.py::ssd_chunk_ref`` tile
    by tile within that file's f32 tolerance (1e-4);
  * at ``chip_smoke.py::check_ssd``'s input distribution (softplus dt, x, B
    and C ~ N(0, 1) in bf16, chunks of 256) it passes the checks the kernel
    is held to on the card: y within 2e-2, the f32 states and cum within
    1e-3 of ``ssd_chunks_ref``;
  * rounding P, or x·w, to one bf16 instead fails those checks at the same
    inputs, which is why the kernel splits them.

Inputs are drawn with numpy from fixed seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import kernel as r_ssd
from repro.kernels.ssd_scan import ref as r_ssd_ref

from repro_torch.kernels.ssd_scan import ref as SR

SSD_TOL = dict(rtol=1e-4, atol=1e-4)        # test_torch_ssm.py's f32 tolerance
Y_TOL = dict(rtol=2e-2, atol=2e-2)          # chip_smoke.py's bf16 y check
F32_TOL = dict(rtol=1e-3, atol=1e-3)        # its states and cum check
# test_torch_ssm.py's shapes: (B, S, nh, hd, N, chunk)
SSD_SHAPES = [(2, 64, 3, 8, 4, 16), (1, 128, 2, 16, 8, 32),
              (2, 32, 1, 8, 16, 8), (1, 37, 2, 8, 4, 256),
              (2, 74, 2, 16, 8, 37)]


def _bf16_values(a):
    """f32 array of the bf16 values nearest ``a``."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _chunked(x, dt, A, Bm, Cm, chunk):
    """The chunk kernel's inputs, laid out as the reference's ops.py lays
    them out (numpy, contiguous)."""
    B, S, nh, hd = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = S // Q
    xc = x.reshape(B, nc, Q, nh, hd).transpose(0, 1, 3, 2, 4)
    dtc = dt.reshape(B, nc, Q, nh).transpose(0, 1, 3, 2)[:, :, :, None, :]
    dtA = (dt * A[None, None, :]).reshape(B, nc, Q, nh).transpose(
        0, 1, 3, 2)[:, :, :, None, :]
    return [np.ascontiguousarray(a, dtype=np.float32) for a in
            (xc, dtc, dtA, Bm.reshape(B, nc, Q, N), Cm.reshape(B, nc, Q, N))]


@pytest.mark.parametrize("B,S,nh,hd,N,chunk", SSD_SHAPES)
def test_split_model_equals_pallas_and_the_oracle(B, S, nh, hd, N, chunk):
    rng = np.random.default_rng(S)
    x = _bf16_values(rng.standard_normal((B, S, nh, hd)).astype(np.float32))
    dt = (np.abs(rng.standard_normal((B, S, nh))) * 0.1 + 0.01
          ).astype(np.float32)
    A = (-np.abs(rng.standard_normal(nh)) - 0.1).astype(np.float32)
    Bm = _bf16_values(rng.standard_normal((B, S, N)).astype(np.float32))
    Cm = _bf16_values(rng.standard_normal((B, S, N)).astype(np.float32))
    ins = _chunked(x, dt, A, Bm, Cm, chunk)
    y, st, cum = SR.ssd_chunks_split_ref(*map(torch.from_numpy, ins))
    py, pst, pcum = r_ssd.ssd_chunks(*map(jnp.asarray, ins), interpret=True)
    for got, want in ((y, py), (st, pst), (cum, pcum)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SSD_TOL)
    xc, dtc, dtA, Bc, Cc = ins
    for b in range(B):
        for c in range(xc.shape[1]):
            for h in range(nh):
                oy, ost, ocum = r_ssd_ref.ssd_chunk_ref(
                    xc[b, c, h], dtc[b, c, h, 0], dtA[b, c, h, 0], Bc[b, c],
                    Cc[b, c])
                np.testing.assert_allclose(y[b, c, h].numpy(), oy, **SSD_TOL)
                np.testing.assert_allclose(st[b, c, h].numpy(), ost,
                                           **SSD_TOL)
                np.testing.assert_allclose(cum[b, c, h, 0].numpy(), ocum,
                                           **SSD_TOL)


def _smoke_inputs(seed, S, nh, hd, N, chunk=256):
    """check_ssd's distribution: x, B, C ~ N(0, 1) in bf16, dt a softplus
    of N(0, 1), A = -exp(0.5 N(0, 1)); the strided views ops.py passes."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((1, S, nh, hd)).astype(
        np.float32)).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((1, S, nh)).astype(np.float32)))
    A = -torch.exp(0.5 * torch.from_numpy(
        rng.standard_normal(nh).astype(np.float32)))
    Bm, Cm = (torch.from_numpy(rng.standard_normal((1, S, N)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    Q = min(chunk, S)
    nc = S // Q
    return (x.reshape(1, nc, Q, nh, hd).transpose(2, 3),
            dt.reshape(1, nc, Q, nh).transpose(2, 3)[:, :, :, None, :],
            (dt * A).reshape(1, nc, Q, nh).transpose(2, 3)[:, :, :, None, :],
            Bm.reshape(1, nc, Q, N), Cm.reshape(1, nc, Q, N))


# mamba2's state width and head dim, then zamba2's state width
WIDTHS = [(64, 128), (64, 64)]


@pytest.mark.parametrize("hd,N", WIDTHS)
def test_split_model_passes_the_card_checks(hd, N):
    args = _smoke_inputs(6, 1024, 4, hd, N)
    got = SR.ssd_chunks_split_ref(*args)
    want = SR.ssd_chunks_ref(*args)
    assert got[0].dtype == torch.bfloat16
    torch.testing.assert_close(got[0].float(), want[0].float(), **Y_TOL)
    torch.testing.assert_close(got[1], want[1], **F32_TOL)
    torch.testing.assert_close(got[2], want[2], **F32_TOL)


@pytest.mark.parametrize("hd,N", WIDTHS)
def test_one_bf16_scores_fail_the_y_check(hd, N):
    args = _smoke_inputs(6, 1024, 4, hd, N)
    got = SR.ssd_chunks_split_ref(*args, split_p=False)
    want = SR.ssd_chunks_ref(*args)
    assert not torch.allclose(got[0].float(), want[0].float(), **Y_TOL)
    torch.testing.assert_close(got[1], want[1], **F32_TOL)


@pytest.mark.parametrize("hd,N", WIDTHS)
def test_one_bf16_state_operand_fails_the_state_check(hd, N):
    args = _smoke_inputs(6, 1024, 4, hd, N)
    got = SR.ssd_chunks_split_ref(*args, split_xw=False)
    want = SR.ssd_chunks_ref(*args)
    torch.testing.assert_close(got[0].float(), want[0].float(), **Y_TOL)
    assert not torch.allclose(got[1], want[1], **F32_TOL)
