"""The Python halves of the Hopper kernels K1-K4, on the CPU.

What the card's kernels take is decided in Python before any launch: K3's
tile plan (``ln_matmul.plan``: rows and columns per tile, weight stages,
shared-memory bytes, the persistent grid's tile ranges), K1's layout check
(``flash_attention.layout_error``: which strided q/k/v views the TMA
descriptors can read in place), K2's route and slabs (``groupnorm.plan``)
and K4's leaf table (``adam8bit.leaf_table``: which leaf each global block
belongs to).  These tests hold them at every main-path shape; pure torch
on the CPU, no JAX, well under a second.
"""

import bisect

import numpy as np
import pytest
import torch

from this_and_that_vdm_tpu_torch.ops import adam8bit, flash_attention, groupnorm, ln_matmul

# (R, C, N) of every LN -> projection site of the VGL denoise step at CFG 2
# (28 = 2 x 14 frames): levels 1-3 and the level-4 mid block, N = C (the
# cross-attention q), 3C (the fused qkv) and 8C (the GEGLU input).
_ROWS = {320: (43008,), 640: (10752,), 1280: (2688, 672)}
MAIN_PATH = [(r, c, n) for c, rows in _ROWS.items() for r in rows for n in (c, 3 * c, 8 * c)]
# the GEGLU epilogue at the feed-forwards' sites (out [R, 4C] from w [8C, C]),
# at CFG 2 and at four clips' rows, and a ragged R and I
GEGLU_SITES = [(r * k, c, 4 * c) for c, rows in _ROWS.items() for r in rows for k in (1, 4)] \
    + [(1000, 320, 1280), (77, 64, 40)]
_PLAN_CASES = ([pytest.param(r, c, n, False, id=f"{r}-{c}-{n}") for r, c, n in MAIN_PATH]
               + [pytest.param(r, c, n, True, id=f"{r}-{c}-{n}-geglu")
                  for r, c, n in GEGLU_SITES])


def _block_ranges(p):
    """The kernel's split of the tiles over the grid (csrc/ln_matmul.cu)."""
    return [(b * p.tiles // p.grid, (b + 1) * p.tiles // p.grid) for b in range(p.grid)]


def _geglu_stage_rows(p, nt, i):
    """The weight row behind each row of column tile ``nt``'s stage under
    the GEGLU epilogue, as the kernel's producer loads it: each 128-row
    part is a 64-row box of h (rows from nt * obn) and one of the gate
    (I rows further on)."""
    return [hg * i + nt * p.obn + 64 * q + k
            for q in range(p.bn // 128) for hg in (0, 1) for k in range(64)]


@pytest.mark.parametrize("r,c,n,geglu", _PLAN_CASES)
def test_ln_matmul_plan_fits_and_covers(r, c, n, geglu):
    p = ln_matmul.plan(r, c, n, geglu=geglu)
    assert p.smem <= ln_matmul.SMEM_LIMIT == 232448
    assert p.stages >= 2 and p.wm in (1, 2) and p.bm == 64 * p.wm
    assert p.obn == (p.bn // 2 if geglu else p.bn)
    # rows past R and columns past N are masked, never left out
    assert -(-r // p.bm) * p.bm >= r and p.tiles_n * p.obn >= n > (p.tiles_n - 1) * p.obn
    assert p.tiles == -(-r // p.bm) * p.tiles_n and p.grid == min(p.tiles, 132)
    ranges = _block_ranges(p)
    assert ranges[0][0] == 0 and ranges[-1][1] == p.tiles
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(ranges, ranges[1:]))
    # the layout the kernel allocates: slack, normalised rows, ring, barriers
    # (the GEGLU epilogue's the same as the plain one's at the same C)
    kb = -(-c // 64)
    assert p.smem == 1024 + kb * p.bm * 128 + p.stages * p.bn * p.kw * 2 + 8 * (2 * p.stages + 2)
    if geglu:
        # the plain plan of the [2I, C] projection, but for the stored width
        assert p._replace(obn=p.bn) == ln_matmul.plan(r, c, 2 * n)
        # every output column is stored once, from accumulator column a of
        # part q (h, a < 64) and its gate at a + 64: w rows o and I + o
        seen = np.zeros(n, np.int64)
        for nt in range(p.tiles_n):
            rows = _geglu_stage_rows(p, nt, n)
            assert len(rows) == p.bn
            for q in range(p.bn // 128):
                for a in range(64):
                    o = nt * p.obn + 64 * q + a
                    assert rows[128 * q + a] == o and rows[128 * q + 64 + a] == n + o
                    if o < n:  # the kernel's store mask
                        seen[o] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("r,c,n", [(77, 64, 40), (3000, 320, 960), (384, 1280, 10240),
                                   (5, 8, 8), (1000, 1000, 16)])
def test_ln_matmul_plan_other_shapes(r, c, n):
    p = ln_matmul.plan(r, c, n)
    assert p.smem <= ln_matmul.SMEM_LIMIT and 0 < p.grid <= min(p.tiles, 132)
    assert p.tiles_n * p.bn >= n and p.tiles // p.tiles_n * p.bm >= r


def test_ln_matmul_plan_refuses_rows_that_do_not_fit():
    assert ln_matmul.plan(10, 1280, 8).wm == 1
    for c in (1288, 2048):
        with pytest.raises(ValueError):
            ln_matmul.plan(10, c, 8)


# (R, C) of the fp32 LN -> projection sites: the train steps at batch 1
# (14 frames) and the CFG-2 rows, with the VL mid block (R = 336)
_F32_SITES = [(21504, 320), (5376, 640), (1344, 1280), (336, 1280), (43008, 320),
              (10752, 640), (2688, 1280)]


@pytest.mark.parametrize("r,c", _F32_SITES)
def test_ln_matmul_plan_f32_fits_every_site(r, c):
    for n in (c, 3 * c, 8 * c):
        p = ln_matmul.plan_f32(r, c, n)
        assert p.smem <= ln_matmul.SMEM_LIMIT == 232448
        # rows past R and columns past N are masked, never left out
        assert p.tiles_n * 128 >= n > (p.tiles_n - 1) * 128
        assert p.tiles == -(-r // 128) * p.tiles_n and p.grid == min(p.tiles, 132)
        ranges = _block_ranges(p)
        assert ranges[0][0] == 0 and ranges[-1][1] == p.tiles
        assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(ranges, ranges[1:]))
        # the kernel's layout: resident rows at C rounded up to 32, + 8
        # floats (8 mod 32), beside 3 weight stages [128, 40]; streamed: 4
        # stages of rows and weights [256, 40]
        assert p.lda % 32 == 8 and p.lda >= c + 8
        assert p.stream == (c > 320)
        assert p.smem == (4 * 4 * 256 * 40 if p.stream else 4 * (128 * p.lda + 3 * 128 * 40))


@pytest.mark.parametrize("c,stream", [(8, False), (72, False), (320, False), (352, True),
                                      (1288, True), (2048, True)])
def test_ln_matmul_plan_f32_takes_every_c_to_2048(c, stream):
    p = ln_matmul.plan_f32(1000, c, 17)
    assert p.stream == stream and p.smem <= ln_matmul.SMEM_LIMIT and p.lda - 8 >= c


def _qkv_views(b, s, h, d, dtype=torch.bfloat16):
    """q, k, v as the transformers make them: .chunk(3) of the fused
    [B, S, 3C] qkv product, each reshaped to [B, S, H, D]."""
    buf = torch.zeros((b, s, 3 * h * d), dtype=dtype)
    return [t.reshape(b, s, h, d) for t in buf.chunk(3, dim=-1)]


@pytest.mark.parametrize("shape", [(28, 1536, 5, 64), (28, 384, 10, 64), (1, 300, 2, 128),
                                   (1, 77, 1, 64)])
def test_flash_layout_takes_qkv_views_and_contiguous(shape):
    q, k, v = _qkv_views(*shape)
    assert not q.is_contiguous()
    assert flash_attention.layout_error(q, k, v) is None
    assert flash_attention.layout_error(q.contiguous(), k.contiguous(), v.contiguous()) is None


def test_flash_layout_refuses_what_tma_cannot_read():
    q, k, v = _qkv_views(2, 384, 10, 64)
    # [B, H, S, D] storage seen as [B, S, H, D]: head stride is not D
    qt, kt, vt = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    assert "head stride" in flash_attention.layout_error(qt, kt, vt)
    # a base 2 bytes past 16-byte alignment
    flat = torch.zeros(2 * 384 * 640 + 1, dtype=torch.bfloat16)[1:].view(2, 384, 10, 64)
    assert "aligned" in flash_attention.layout_error(flat, flat, flat)
    # a row stride that is not a multiple of 8 elements
    odd = torch.zeros((2, 384, 652), dtype=torch.bfloat16)[..., :640].reshape(2, 384, 10, 64)
    assert "multiples of 8" in flash_attention.layout_error(odd, odd, odd)
    # strides that differ between q and k
    assert "strides differ" in flash_attention.layout_error(q, k.contiguous(), v)
    # a unit stride that is not 1
    wide = torch.zeros((2, 384, 10, 128), dtype=torch.bfloat16)[..., ::2]
    assert "unit stride" in flash_attention.layout_error(wide, wide, wide)



# K2: every distinct folded [N, S, C] of the 152 GroupNorm calls of the VGL
# denoise step at CFG 2 (bf16; rank-5 sites fold frames into S), the VAE
# decoder's at chunk 8, and the batch-1 train steps' (14 frames; fp32 in
# the GestureNet and the VL UNet, bf16 in the frozen VGL UNet)
_DENOISE_GN = [(28, 1536, 960), (28, 1536, 640), (28, 384, 1920), (28, 1536, 320),
               (2, 21504, 320), (28, 384, 1280), (28, 384, 960), (28, 384, 640),
               (2, 5376, 640), (28, 96, 2560), (28, 96, 1920), (28, 384, 320),
               (28, 96, 1280), (2, 1344, 1280), (28, 96, 640), (28, 24, 2560),
               (28, 24, 1280), (2, 336, 1280)]
_VAE_GN = [(8, 98304, 256), (8, 24576, 512), (8, 98304, 128), (1, 786432, 128),
           (8, 24576, 256), (1, 196608, 256), (8, 6144, 512), (1, 49152, 512),
           (8, 1536, 512), (1, 12288, 512)]
_TRAIN_GN = [(14, 1536, 320), (1, 21504, 320), (14, 384, 640), (1, 5376, 640),
             (14, 96, 1280), (1, 1344, 1280), (14, 24, 1280), (1, 336, 1280),
             (14, 1536, 640), (14, 1536, 960), (14, 384, 1920), (14, 96, 2560)]
_GN_CASES = ([(shape, 2) for shape in _DENOISE_GN + _VAE_GN + _TRAIN_GN]
             + [(shape, 4) for shape in _TRAIN_GN])
_SHARED = 132 * (groupnorm.SMEM_LIMIT - 1024)  # bytes the card holds resident


def _gn_expected_route(n, s, c, itemsize):
    """Resident iff the tensor, cut into 132 equal slabs of whole rows,
    fits beside each block's reduction buffers."""
    return n * s * c * itemsize <= 27_600_000


@pytest.mark.parametrize("shape,itemsize", _GN_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{'bf16' if i == 2 else 'fp32'}"
                              for s, i in _GN_CASES])
def test_groupnorm_plan_route_fits_and_slabs_cover(shape, itemsize):
    n, s, c = shape
    rows, groups = n * s, 32
    p = groupnorm.plan(n, s, c, groups, itemsize)
    # the route: every site of at most 27.5 MB stays in shared memory
    assert p.resident == _gn_expected_route(n, s, c, itemsize)
    lanes = min(c * itemsize // 16, groupnorm.THREADS)
    red = 4 * (2 * (groupnorm.THREADS // lanes) * c + 2 * groups * p.kmax)
    if p.resident:
        assert p.grid <= 132 and p.smem == p.rows_per_block * c * itemsize + red
        assert p.smem <= groupnorm.SMEM_LIMIT - 1024
        assert rows * c * itemsize <= _SHARED
    else:
        assert p.grid <= 132 * groupnorm.STREAMED_BLOCKS_PER_SM and p.smem == red
    # each row (so each element) lies in exactly one non-empty slab
    rpb = p.rows_per_block
    slabs = [(b * rpb, min(rows, (b + 1) * rpb)) for b in range(p.grid)]
    assert slabs[0][0] == 0 and slabs[-1][1] == rows
    assert all(a < b for a, b in slabs) and all(x[1] == y[0] for x, y in zip(slabs, slabs[1:]))
    # segments: a block's batch rows fit its kmax scratch slots, and the
    # combine of batch row m reads exactly the blocks whose slab meets it
    meets = {}
    for b, (r0, r1) in enumerate(slabs):
        first = r0 // s
        assert (r1 - 1) // s - first < p.kmax
        for m in range(first, (r1 - 1) // s + 1):
            meets.setdefault(m, []).append(b)
    assert sorted(meets) == list(range(n))
    for m, blocks in meets.items():
        lo, hi = m * s // rpb, (m * s + s - 1) // rpb  # the kernel's formulas
        assert blocks == list(range(lo, hi + 1))
        assert all(m - b * rpb // s < p.kmax for b in blocks)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_groupnorm_plan_chunks_cover_a_resident_slab(itemsize):
    """The resident slab goes in as up to 8 bulk copies of whole rows, of
    at least 16 KB where the slab allows (the kernel's split), each a
    multiple of 16 bytes, none empty."""
    for n, s, c in _DENOISE_GN + _TRAIN_GN:
        p = groupnorm.plan(n, s, c, 32, itemsize)
        if not p.resident:
            continue
        for b in range(p.grid):
            nrows = min(n * s, (b + 1) * p.rows_per_block) - b * p.rows_per_block
            count = max(1, min(8, nrows * c * itemsize // 16384))
            crows = -(-nrows // count)
            chunks = [(j * crows, min(nrows, (j + 1) * crows)) for j in range(count)
                      if j * crows < nrows]
            assert chunks[-1][1] == nrows and all(a < b for a, b in chunks)
            assert all((b - a) * c * itemsize % 16 == 0 for a, b in chunks)


def test_groupnorm_plan_small_tensors_take_fewer_blocks():
    p = groupnorm.plan(2, 16, 64, 32, 2)
    assert p.resident and p.grid == 1 and p.rows_per_block == 32 and p.kmax == 2
    assert groupnorm.plan(28, 24, 1280, 32, 2).grid < 132


def _kernel_search(first, blk):
    """csrc/adam8bit.cu's binary search, as written there: the last leaf
    whose first block is <= blk (an empty leaf shares its first block with
    the next one)."""
    lo, hi = 0, len(first) - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if first[mid] <= blk:
            lo = mid
        else:
            hi = mid - 1
    return lo


# a ragged tree: a 1-block leaf, exact blocks, a 513-element leaf, a
# >= 40-block leaf, empty leaves (one last)
_NUMELS = [200, 256, 257, 513, 0, 40 * 256 + 17, 1, 3000, 0]


def test_adam8bit_leaf_table_covers_every_element_once():
    first, total = adam8bit.leaf_blocks(_NUMELS)
    nbs = [-(-n // 256) for n in _NUMELS]
    assert total == sum(nbs) and first == list(np.cumsum([0] + nbs[:-1]))
    seen = [np.zeros(n, np.int64) for n in _NUMELS]
    for blk in range(total):
        leaf = _kernel_search(first, blk)
        assert leaf == bisect.bisect_right(first, blk) - 1 and _NUMELS[leaf] > 0
        local = blk - first[leaf]
        assert 0 <= local < nbs[leaf]
        # a lane reads the gradient up to numel; past it the block is padding
        seen[leaf][local * 256:min(_NUMELS[leaf], (local + 1) * 256)] += 1
    assert all((v == 1).all() for v in seen)


def test_adam8bit_leaf_table_rows():
    gs = [torch.zeros(n) for n in _NUMELS]
    q = [torch.zeros(-(-n // 256) * 256, dtype=torch.uint8) for n in _NUMELS]
    sc = [torch.zeros(-(-n // 256)) for n in _NUMELS]
    q2 = [t.clone() for t in q]
    sc2 = [t.clone() for t in sc]
    steps = [torch.zeros(n) for n in _NUMELS]
    rows = adam8bit.leaf_table(gs, q, sc, q2, sc2, steps)
    assert rows.shape == (len(_NUMELS), 8) and rows.dtype == np.int64
    for j, ts in enumerate((gs, q, sc, q2, sc2)):
        assert rows[:, j].tolist() == [t.data_ptr() for t in ts]
    assert rows[:, 5].tolist() == _NUMELS
    assert rows[:, 6].tolist() == adam8bit.leaf_blocks(_NUMELS)[0]
    assert rows[:, 7].tolist() == [t.data_ptr() for t in steps]
