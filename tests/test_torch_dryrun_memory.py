"""The dry run's memory counter (``launch/hlo_analysis.py::MemoryCounter``)
and what the kernel wrappers book on meta tensors (``repro_torch.
_counting``): no JAX, meta tensors only.

  * the counter's closed forms: a chain of 1024 x 1024 float32 matmuls
    (4 MiB each), a view, an in-place op, a freed tensor, tensors saved
    by autograd and freed by the backward, the allocator's granule;
  * each wrapper books exactly what its CUDA branch allocates (the
    formulas of its ``_launch``), none of its plain version's
    temporaries, launches nothing, and leaves the op counter's calls,
    FLOPs and bytes those of its plain version, forward and backward;
  * with autograd, the backward books the card's backward (the
    Function's: the plain version recomputed in f32) beside what is
    live.
"""
import pytest
import torch

from repro_torch import _counting
from repro_torch.kernels.decode_attention import kernel as DK
from repro_torch.kernels.decode_attention import ref as DR
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ref as FR
from repro_torch.kernels.marshal_pack import kernel as MK
from repro_torch.kernels.marshal_pack import ref as MR
from repro_torch.kernels.rmsnorm import kernel as RK
from repro_torch.kernels.rmsnorm import ref as RR
from repro_torch.kernels.ssd_scan import kernel as SK
from repro_torch.kernels.ssd_scan import ref as SR
from repro_torch.launch import hlo_analysis as H

MiB = 1 << 20
META = "meta"


def m(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device=META, requires_grad=grad)


def launches():
    return (RK.rmsnorm.launches, FK.flash_attention.launches,
            DK.decode_attention.launches, SK.ssd_chunks.launches,
            MK.gather_tiles.launches)


def test_a_matmul_chain_books_its_products_while_they_live():
    a, b = m(1024, 1024), m(1024, 1024)
    mem = H.MemoryCounter()
    with mem:
        c = a @ b
        d = c @ b
        e = d @ b
        del c
    assert (mem.live, mem.peak) == (8 * MiB, 12 * MiB)
    del d, e
    assert mem.live == 0 and mem.peak == 12 * MiB


def test_views_and_in_place_ops_book_nothing():
    a = m(1024, 1024)
    mem = H.MemoryCounter()
    with mem:
        c = a + 1
        views = (c.view(-1), c.t(), c[:10], c.reshape(-1))
        c.add_(1)
        c.mul_(2)
        torch.add(c, 1, out=c)
        a.add_(1)                 # an argument: never booked
    assert mem.live == mem.peak == 4 * MiB
    del c
    assert mem.live == 4 * MiB    # the views keep the storage
    del views
    assert mem.live == 0


def test_tensors_saved_by_autograd_are_freed_by_the_backward():
    x = m(512, 512, grad=True)
    mem = H.MemoryCounter()
    with mem:
        y = x.exp()               # exp saves its output
        z = y.sum()
        del y
        assert mem.live == MiB + 4
        z.backward()
    assert mem.live == 4 + MiB    # z, and x.grad; y went with the graph
    assert x.grad is not None
    x.grad = None
    assert mem.live == 4


def test_the_granule_rounds_each_storage_up():
    x, y = m(10), m(129)
    mem = H.MemoryCounter(granule=512)
    with mem:
        a = x + 1
        b = y * 2
    assert mem.live == mem.peak == 512 + 1024
    del a
    assert (mem.live, mem.peak) == (1024, 1536)


def test_step_memory_counts_outputs_once_and_their_aliases():
    arg = m(256, 256)
    mem = H.MemoryCounter()
    with mem:
        new = arg * 2
        arg.add_(1)
    got = H.step_memory(mem, ((new, new.t(), arg), {"x": arg[0]}), [arg])
    assert got == H.StepMemory(output=2 * 256 * 256 * 4,
                               alias=256 * 256 * 4, peak=256 * 256 * 4)
    d = H.memory_dict(100, got)
    assert d == {"argument_size_in_bytes": 100,
                 "output_size_in_bytes": got.output,
                 "alias_size_in_bytes": got.alias,
                 "temp_size_in_bytes": 100 + got.peak - 100 - got.output
                 + got.alias,
                 "peak_memory_in_bytes": 100 + got.peak}
    assert H.memory_dict(10) == {"argument_size_in_bytes": 10}


def test_the_switches_pause_one_counter_each():
    a = m(64, 64)
    ops, mem = H.OpCounter(), H.MemoryCounter()
    with mem, ops:
        with _counting.unbooked():
            b = a @ a
        assert mem.live == 0
        with _counting.memory_only():
            c = a @ a
    assert ops.calls == {"aten.mm": 1} and ops.flops["aten.mm"] == 2 * 64**3
    assert mem.live == 64 * 64 * 4
    del b, c
    assert mem.live == 0


def _counted(fn):
    """The op counter's calls, FLOPs and bytes, and the memory counter's
    peak and live, of ``fn()`` on meta tensors."""
    ops, mem = H.OpCounter(), H.MemoryCounter()
    with mem, ops:
        keep = fn()
    return (ops.calls, ops.flops, ops.bytes), mem.peak, mem.live, keep


def _nbytes(shape, dtype):
    return torch.Size(shape).numel() * torch.empty(
        (), dtype=dtype).element_size()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_books_its_output_alone(dtype):
    B, H_, KV, Sq, Sk, hd = 2, 4, 2, 8, 12, 16
    q, k, v = m(B, H_, Sq, hd, dtype=dtype), m(B, KV, Sk, hd, dtype=dtype), \
        m(B, KV, Sk, hd, dtype=dtype)
    before = launches()
    counts, peak, live, out = _counted(lambda: FK.flash_attention(q, k, v))
    base = _nbytes((B, Sq, H_, hd), dtype)       # flash kernel.py _launch
    assert peak == live == base and out.shape == (B, H_, Sq, hd)
    assert counts == _counted(lambda: FR.attention_ref(q, k, v))[0]
    assert launches() == before


def test_decode_books_its_output_scratch_and_lengths():
    B, H_, KV, S, hd = 3, 4, 2, 300, 16
    q = m(B, H_, hd, dtype=torch.bfloat16)
    k, v = (m(B, KV, S, hd, dtype=torch.bfloat16) for _ in range(2))
    valid = torch.empty(B, dtype=torch.int64, device=META)
    counts, peak, live, out = _counted(
        lambda: DK.decode_attention(q, k, v, valid))
    nsplit = -(-S // DK.split_keys(S))
    out_b = B * H_ * hd * 2                          # _launch: out
    scratch = B * H_ * nsplit * (hd + 2) * 4          # scratch, f32
    assert peak == B * 4 + out_b + scratch and live == out_b
    assert counts == _counted(lambda: DR.decode_ref(q, k, v, valid))[0]
    valid32 = torch.empty(B, dtype=torch.int32, device=META)
    _, peak32, _, _ = _counted(lambda: DK.decode_attention(q, k, v, valid32))
    assert peak32 == out_b + scratch                 # no copy of an int32


@pytest.mark.parametrize("contiguous", [True, False])
def test_rmsnorm_books_its_copies_and_output(contiguous):
    x = m(4, 6, 32) if contiguous else m(6, 4, 32).transpose(0, 1)
    scale = m(32)
    counts, peak, live, out = _counted(lambda: RK.rmsnorm(x, scale))
    out_b = 4 * 6 * 32 * 4
    assert live == out_b and peak == out_b * (1 if contiguous else 2)
    assert counts == _counted(lambda: RR.rmsnorm_ref(x, scale, 1e-6))[0]


def test_ssd_chunks_books_its_three_outputs():
    B, nc, nh, Q, hd, N = 1, 2, 4, 8, 16, 5
    args = (m(B, nc, nh, Q, hd, dtype=torch.bfloat16), m(B, nc, nh, 1, Q),
            m(B, nc, nh, 1, Q), m(B, nc, Q, N, dtype=torch.bfloat16),
            m(B, nc, Q, N, dtype=torch.bfloat16))
    counts, peak, live, outs = _counted(lambda: SK.ssd_chunks(*args))
    want = (B * nc * Q * nh * hd * 2 + B * nc * nh * hd * N * 4
            + B * nc * nh * Q * 4)                   # base, states, cum
    assert peak == live == want
    assert counts == _counted(lambda: SR.ssd_chunks_ref(*args))[0]


def test_gather_tiles_books_its_output():
    src, tiles = m(16, 128), torch.empty(3, dtype=torch.int32, device=META)
    counts, peak, live, out = _counted(lambda: MK.gather_tiles(src, tiles))
    assert peak == live == 3 * MK.TILE * 4
    assert counts == _counted(lambda: MR.pack_ref(
        src.reshape(-1), tiles, MK.TILE).reshape(-1, MK.LANE))[0]


CASES = {
    "flash": (lambda a: FK.flash_attention(*a),
              lambda a: FR.attention_ref(*a),
              lambda: (m(1, 4, 8, 16, dtype=torch.bfloat16, grad=True),
                       m(1, 2, 8, 16, dtype=torch.bfloat16, grad=True),
                       m(1, 2, 8, 16, dtype=torch.bfloat16, grad=True))),
    "rmsnorm": (lambda a: RK.rmsnorm(*a), lambda a: RR.rmsnorm_ref(*a),
                lambda: (m(8, 64, grad=True), m(64, grad=True))),
    "ssd_chunks": (lambda a: SK.ssd_chunks(*a)[0],
                   lambda a: SR.ssd_chunks_ref(*a)[0],
                   lambda: (m(1, 2, 2, 8, 4, grad=True),
                            m(1, 2, 2, 1, 8, grad=True),
                            m(1, 2, 2, 1, 8, grad=True),
                            m(1, 2, 8, 3, grad=True),
                            m(1, 2, 8, 3, grad=True))),
}


@pytest.mark.parametrize("name", list(CASES))
def test_the_backward_books_the_cards_and_counts_the_plain_one(name):
    wrapper, plain, make = CASES[name]

    def step(fn):
        def run():
            args = make()
            out = fn(args)
            out.float().sum().backward()
            return [a.grad for a in args]
        return run

    counts, peak, live, grads = _counted(step(wrapper))
    assert counts == _counted(step(plain))[0]
    assert live == sum(g.numel() * g.element_size() for g in grads)
    # the card's backward alone, on inputs and a gradient that are live
    card = {"flash": lambda a, g: FK._backward(
                *a, None, None, True, 1 / 4, g),
            "rmsnorm": lambda a, g: RK._backward(*a, 1e-6, g),
            "ssd_chunks": lambda a, g: SK._backward(
                a, g.transpose(2, 3), None, None)}[name]
    args = [t.detach() for t in make()]
    with torch.no_grad():
        out = plain(args)
    if name == "flash":
        g = m(1, 8, 4, 16, dtype=torch.bfloat16).transpose(1, 2)
    elif name == "ssd_chunks":
        g = m(1, 2, 8, 2, 4).transpose(2, 3)
    else:
        g = torch.empty_like(out)
    _, card_peak, _, _ = _counted(lambda: card(args, g))
    assert card_peak > 0 and peak >= card_peak
