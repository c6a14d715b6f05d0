"""The Python halves of the Hopper kernels K1 and K3, on the CPU.

What the card's kernels take is decided in Python before any launch: K3's
tile plan (``ln_matmul.plan``: rows and columns per tile, weight stages,
shared-memory bytes, the persistent grid's tile ranges) and K1's layout
check (``flash_attention.layout_error``: which strided q/k/v views the TMA
descriptors can read in place).  These tests hold both at every main-path
shape; pure torch on the CPU, no JAX, well under a second.
"""

import pytest
import torch

from this_and_that_vdm_tpu_torch.ops import flash_attention, ln_matmul

# (R, C, N) of every LN -> projection site of the VGL denoise step at CFG 2
# (28 = 2 x 14 frames): levels 1-3 and the level-4 mid block, N = C (the
# cross-attention q), 3C (the fused qkv) and 8C (the GEGLU input).
_ROWS = {320: (43008,), 640: (10752,), 1280: (2688, 672)}
MAIN_PATH = [(r, c, n) for c, rows in _ROWS.items() for r in rows for n in (c, 3 * c, 8 * c)]


def _block_ranges(p):
    """The kernel's split of the tiles over the grid (csrc/ln_matmul.cu)."""
    return [(b * p.tiles // p.grid, (b + 1) * p.tiles // p.grid) for b in range(p.grid)]


@pytest.mark.parametrize("r,c,n", MAIN_PATH)
def test_ln_matmul_plan_fits_and_covers(r, c, n):
    p = ln_matmul.plan(r, c, n)
    assert p.smem <= ln_matmul.SMEM_LIMIT == 232448
    assert p.stages >= 2 and p.wm in (1, 2) and p.bm == 64 * p.wm
    # rows past R and columns past N are masked, never left out
    assert -(-r // p.bm) * p.bm >= r and p.tiles_n * p.bn >= n
    assert p.tiles == -(-r // p.bm) * p.tiles_n and p.grid == min(p.tiles, 132)
    ranges = _block_ranges(p)
    assert ranges[0][0] == 0 and ranges[-1][1] == p.tiles
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(ranges, ranges[1:]))
    # the layout the kernel allocates: slack, normalised rows, ring, barriers
    kb = -(-c // 64)
    assert p.smem == 1024 + kb * p.bm * 128 + p.stages * p.bn * p.kw * 2 + 8 * (2 * p.stages + 2)


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

