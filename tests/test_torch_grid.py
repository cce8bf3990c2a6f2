# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""The launch geometries of the flash and SSD kernels past 65,535 and past
width 256, on the CPU: each route's tile grid laid onto ``flat_grid``'s
launch grid (x up to 2**31 - 1 blocks, y up to 65,535) covers every tile
once, at the sizes that the grid's 65,535 refused before (b h and b c of
65,536 and 2**20, B x column blocks of 65,536 and 2**20, mamba2-370m's
prefill at batch 2,048 and Jamba's layer at batch 256), and every SSD
width to 1,024 fits the block's shared memory at every chunk.  The
kernels themselves run on the card: tests/test_torch_cuda.py."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.build import GRID_X, GRID_Y, flat_grid, tile_of  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.ssd_chunk import kernel as sk  # noqa: E402


def _covers_each_tile_once(tiles):
    """Enumerate every block of ``flat_grid(tiles)``: the grid within its
    axes' limits, the blocks that take a tile take each tile once, in
    launch order (x fastest), and fewer than Y blocks take none."""
    grid = flat_grid(tiles)
    X, Y, Z = grid
    assert X <= GRID_X and Y <= GRID_Y and Z == 1
    total = math.prod(tiles)
    blocks = np.arange(X * Y, dtype=np.int64)
    (x, y, z), ok = tile_of(blocks % X, blocks // X, grid, tiles)
    assert int(ok.sum()) == total and X * Y - total < Y
    nx, ny, _ = tiles
    number = x[ok] + nx * (y[ok] + ny * z[ok])
    np.testing.assert_array_equal(number, np.arange(total))
    assert (x[ok] < nx).all() and (y[ok] < ny).all()
    return grid


# (b, L, h, g, q, p, n): b h = 65,536 and 2**20 (float32's z), b c of the
# same (bf16's z), mamba2-370m's prefill at batch 2,048 (32 heads in one
# group, 256 tokens, p 64, n 128, chunk 256) and Jamba's layer at batch
# 256 (256 heads in 8 groups, L 64)
SSD_CASES = [
    (2048, 16, 32, 1, 16, 64, 128),
    (32768, 16, 32, 1, 16, 64, 128),
    (65536, 16, 1, 1, 16, 64, 128),
    (2 ** 20, 16, 8, 1, 16, 64, 128),
    (2048, 256, 32, 1, 256, 64, 128),
    (256, 64, 256, 8, 64, 64, 128),
]


@pytest.mark.parametrize("b,L,h,g,q,p,n", SSD_CASES)
def test_ssd_geometries_cover_each_tile_once(b, L, h, g, q, p, n):
    """Both routes' geometries take each case (the float32 one at b h =
    65,536 too, which raised before) and their tiles cover the work, each
    (query tiles + state blocks, head blocks, b c): float32 in tiles of
    16 rows at q = 16, 64 at q 64 and 256; bf16 in tiles of 64."""
    c = L // q
    tiles, threads, smem, hb = sk.cc_geometry(b, L, h, g, q, p, n)
    qt = sk.cc_tile(q, p)
    assert qt == (16 if q == 16 else 64)
    assert tiles == (-(-q // qt) + -(-n // qt), h // hb, b * c)
    assert threads == 256 and smem <= sk.SMEM_LIMIT
    assert (h // g) % hb == 0 and hb == min(8, sk.heads_per_block(h, g))
    if math.prod(tiles) <= 1 << 22:
        _covers_each_tile_once(tiles)
    tiles, threads, smem, hb = sk.mma_geometry(b, L, h, g, q, p, n)
    assert tiles == (-(-q // 64) + -(-n // 64), h // hb, b * c)
    assert threads == 128 and smem <= sk.SMEM_LIMIT
    if math.prod(tiles) <= 1 << 22:
        _covers_each_tile_once(tiles)


@pytest.mark.parametrize("B,dh", [(65536, 64), (16384, 1024), (2 ** 20, 64),
                                  (2 ** 18, 1024)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_geometry_covers_each_tile_once(dtype, B, dh):
    """B x column blocks of 65,536 and 2**20 (one head, S = 16), which the
    grid's 65,535 refused before: tiles (query tiles, heads, B x column
    blocks), each covered once."""
    route, tiles, _, smem = fk.launch_geometry(dtype, B, 1, 16, dh)
    ncb = (fk.column_blocks(dh) if dtype == torch.bfloat16 else
           fk.cc_column_blocks(dh))[0]  # float32: dh 1,024 in one block
    assert tiles == (1, 1, B * ncb) and smem <= fk.SMEM_LIMIT
    _covers_each_tile_once(tiles)


def test_flat_grid_past_one_row_and_its_end():
    """Past 2**31 - 1 tiles the grid takes rows along y, fewer than Y
    blocks past the last tile; the first and last tiles land where the
    launch order puts them; past 65,535 rows of 2**31 - 1 it raises."""
    tiles = (3, 5, 2 ** 30)
    total = math.prod(tiles)
    X, Y, _ = grid = flat_grid(tiles)
    assert Y == -(-total // GRID_X) == 8 and X <= GRID_X
    assert X * Y >= total and X * Y - total < Y
    assert tile_of(0, 0, grid, tiles) == ((0, 0, 0), True)
    last = total - 1
    assert tile_of(last % X, last // X, grid, tiles) == (
        (2, 4, 2 ** 30 - 1), True)
    assert not tile_of((last + 1) % X, (last + 1) // X, grid, tiles)[1]
    assert flat_grid((GRID_X, GRID_Y, 1)) == (GRID_X, GRID_Y, 1)
    with pytest.raises(ValueError, match="exceed"):
        flat_grid((GRID_X, GRID_Y, 2))
    with pytest.raises(ValueError, match="empty"):
        flat_grid((4, 0, 2))


WIDE = (257, 320, 512, 1024)
CHUNKS = (1, 7, 24, 100, 256, 300, 512, 1024, 4096)


@pytest.mark.parametrize("q", CHUNKS)
def test_ssd_wide_layouts_fit_shared_memory(q):
    """Every p and n in 257 / 320 / 512 / 1,024 (and one of them past 256
    beside a narrow other) runs within the block's 232,448 bytes at every
    chunk of ``test_ssd_geometry_any_shape``: p in ceil(p / 256) column
    blocks of the instance of its share on both routes; bf16 on the _wide
    kernel (n in 64-column slices, one head a block), float32 on its one
    kernel (n in depth chunks and state blocks of the tile's rows, up to
    4 heads of a group a block)."""
    for p in WIDE + (8, 96):
        for n in WIDE + (8, 128):
            if not sk.is_wide(p, n):
                continue
            ncb, ow = sk.columns(p)
            assert ow in sk.P_INSTANCES and ncb * ow >= p > (ncb - 1) * 256
            pw, nw = -(-p // 8) * 8, -(-n // 8) * 8
            tiles, _, smem, hb = sk.mma_geometry(2, 2 * q, 8, 2, q, pw, nw)
            assert hb == 1 and smem <= sk.SMEM_LIMIT
            assert tiles == (sk.columns(pw)[0] * (-(-q // 64) + -(-nw // 64)),
                             8, 4)
            pc, nc = -(-p // 4) * 4, -(-n // 4) * 4
            tiles, _, smem, hb = sk.cc_geometry(2, 2 * q, 8, 2, q, pc, nc)
            qt = sk.cc_tile(q, pc)
            assert smem <= sk.SMEM_LIMIT and 4 % hb == 0
            assert tiles == (ncb * (-(-q // qt) + -(-nc // qt)), 8 // hb, 4)
    assert sk.columns(320) == (2, 256) and sk.columns(1024) == (4, 256)
    assert sk.columns(256) == (1, 256) and not sk.is_wide(256, 256)
