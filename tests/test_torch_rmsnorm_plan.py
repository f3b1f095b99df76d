"""rmsnorm's launch plan (``kernels/rmsnorm/kernel.py::_plan``) on the CPU.

The CUDA kernel runs only on a card (``tests/test_torch_cuda.py`` holds it
to the plain version there); what surrounds it is Python and is held here:
the path each shape takes, the launch shape, and, through a model of the
source's index arithmetic, that the row path sums every 16-byte word of a
row exactly once and in the order of the one-block-a-row kernel it
replaced (the same words a reduction thread, in the same order, reduced in
the same warps at the same lanes, the warps added in the same order), so
that its results are that kernel's bit for bit.  At every shape the main
path launches it with and at the edge cases (1 row, rows that are not a
multiple of the grid, rows that are not 16-byte aligned, rows above 8 KB).
"""
import pytest

from repro_torch.kernels.rmsnorm import kernel as RK

BF16, F32 = 2, 4
SMS = RK.H100_SMS
# the rows the path launches rmsnorm with: a decode step's 8 slots, the
# dp and sharded steps' 256 and 512 a position, the longest serve prompt,
# llama's 8 x 128 train step, the other families' 8 x 512; the widths of
# llama / mamba2 / moonshot, zamba2, phi-3
PATH_ROWS = (8, 256, 512, 938, 1024, 4096)
PATH_WIDTHS = (2048, 2560, 3072)
PATH_SHAPES = [(r, d, BF16) for d in PATH_WIDTHS for r in PATH_ROWS] \
    + [(1024, 2048, F32)]


def _old_reduction(words: int):
    """The one-block-a-row kernel's sum: V threads (32 a 16-byte word, at
    most 256), thread v adding words v, v + V, ...; per warp slot, each
    lane's words in order."""
    V = max(32, min(256, -(-words // 32) * 32))
    slots = {}
    for v in range(V):
        slots.setdefault(v // 32, {})[v % 32] = list(range(v, words, V))
    return slots


def _row_reduction(plan, words: int):
    """The row path's sum under ``plan``: thread t plays the reduction
    threads ``t + j * threads`` (j < fold), each adding words ``+ i * V``
    (i < W) below the row's words; its sums land in warp slot ``t // 32 +
    j * threads // 32`` at lane ``t % 32``."""
    T, F = plan.threads, plan.fold
    V = F * T
    slots = {}
    for t in range(T):
        for j in range(F):
            v = t + j * T
            slots.setdefault(t // 32 + j * (T // 32), {})[t % 32] = [
                v + i * V for i in range(plan.words) if v + i * V < words]
    return slots


def _check_row_plan(plan, rows, D, itemsize, sms=SMS):
    words = D * itemsize // 16
    assert plan.path == "row"
    assert plan.fold in RK.FOLDS and plan.words in RK.WORDS
    assert plan.fold * plan.words <= RK.MAX_THREAD_WORDS
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= RK.MAX_THREADS
    # the persistent grid: no more CTAs than rows, about 64 warps an SM
    assert 1 <= plan.grid <= rows
    assert plan.grid <= sms * max(1, RK.WARPS_PER_SM // (plan.threads // 32))
    old = _old_reduction(words)
    assert _row_reduction(plan, words) == old
    # every word summed once
    assert sorted(k for lanes in old.values() for ks in lanes.values()
                  for k in ks) == list(range(words))


@pytest.mark.parametrize("rows,D,itemsize", PATH_SHAPES)
def test_path_shapes_keep_the_old_reduction_with_the_row_in_registers(
        rows, D, itemsize):
    _check_row_plan(RK._plan(rows, D, itemsize, True), rows, D, itemsize)


def test_the_fold_follows_the_row_count():
    # few rows: the most threads a row (the old kernel's 256)
    assert RK._plan(8, 2048, BF16, True) == RK.Plan("row", 1, 1, 256, 8)
    assert RK._plan(256, 3072, BF16, True) == RK.Plan("row", 1, 2, 256, 256)
    # more rows of one word a reduction thread: two a thread
    assert RK._plan(938, 2048, BF16, True) == RK.Plan("row", 2, 1, 128, 938)
    # rows of two words a reduction thread keep one up to 2048 rows
    assert RK._plan(1024, 2560, BF16, True) == RK.Plan("row", 1, 2, 256,
                                                       1024)
    assert RK._plan(1024, 2048, F32, True) == RK.Plan("row", 1, 2, 256, 1024)
    # many rows: two a thread at every width, the grid persistent where it
    # would pass about 64 warps an SM
    assert RK._plan(4096, 2048, BF16, True) == RK.Plan("row", 2, 1, 128,
                                                       16 * SMS)
    assert RK._plan(4096, 3072, BF16, True) == RK.Plan("row", 2, 2, 128,
                                                       16 * SMS)
    assert RK._plan(2048, 3072, BF16, True) == RK.Plan("row", 1, 2, 256,
                                                       8 * SMS)
    # a card with fewer SMs gets a smaller grid
    assert RK._plan(4096, 3072, BF16, True, sms=100).grid == 1600


@pytest.mark.parametrize("rows", [1, 2, 5, 131, 133, 939, 2049, 4097])
def test_rows_that_are_not_a_multiple_of_the_grid(rows):
    plan = RK._plan(rows, 2560, BF16, True)
    _check_row_plan(plan, rows, 2560, BF16)


@pytest.mark.parametrize("D,itemsize", [(64, BF16), (200, BF16), (72, F32),
                                        (1000, BF16)])
def test_narrow_rows_fold_only_where_the_warps_allow(D, itemsize):
    # the smoke models' widths: fewer than 256 reduction threads
    for rows in (1, 8, 1000, 5000):
        _check_row_plan(RK._plan(rows, D, itemsize, True), rows, D, itemsize)


def test_one_row():
    assert RK._plan(1, 2048, BF16, True) == RK.Plan("row", 1, 1, 256, 1)


@pytest.mark.parametrize("D,itemsize,aligned", [
    (2047, BF16, True),      # D * 2 not a multiple of 16
    (2050, F32, True),
    (2048, BF16, False),     # a pointer off a 16-byte boundary
    (3, BF16, True)])
def test_unaligned_rows_take_the_old_strided_path(D, itemsize, aligned):
    for rows in (1, 8, 1000):
        plan = RK._plan(rows, D, itemsize, aligned)
        assert plan == RK.Plan("strided", 1, 0,
                               max(32, min(256, -(-D // 32) * 32)), rows)


@pytest.mark.parametrize("rows,D,itemsize", [
    (1, 4096, F32), (7, 8192, BF16), (300, 5120, F32), (3000, 8192, BF16),
    (2, 16384, BF16)])
def test_rows_above_8_kb_stay_a_cta_a_row(rows, D, itemsize):
    assert D * itemsize > 8192
    _check_row_plan(RK._plan(rows, D, itemsize, True), rows, D, itemsize)


def test_edges_of_the_paths():
    # 32 KB rows are the row path's largest (256 threads of 8 words); one
    # word more takes the old strided loop
    assert RK._plan(4, 16384, BF16, True) == RK.Plan("row", 1, 8, 256, 4)
    assert RK._plan(4, 16392, BF16, True).path == "strided"
    # many rows of 8 words a reduction thread cannot fold
    assert RK._plan(5000, 16384, BF16, True).fold == 1
    assert RK._plan(5000, 8192, BF16, True).fold == 2
    # nor can 96 reduction threads (48 is not a whole warp)
    assert RK._plan(5000, 768, BF16, True) == RK.Plan("row", 1, 1, 96,
                                                      21 * SMS)
    with pytest.raises(ValueError, match="at least one row"):
        RK._plan(0, 2048, BF16, True)
