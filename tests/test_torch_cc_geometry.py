# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""The float32 (CUDA-core) kernels' geometries on the CPU, through their
Python mirrors (``kernels.flash_attention.kernel.cc_tiling`` /
``cc_column_blocks`` / ``launch_geometry``, ``kernels.ssd_chunk.kernel.
cc_tiling`` / ``cc_tile`` / ``cc_layout`` / ``cc_geometry``): every output
element is owned by exactly one (block, thread), flash forms S once per
(query tile, key tile) up to the one-block width of 1,024, the SSD kernel
walks a group's heads (hb dividing h / g) and forms G once per key tile,
and shared memory fits the block's 232,448 bytes at every width and chunk
the tests and chip_smoke.py run.  The kernels themselves run on the card:
tests/test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.ssd_chunk import kernel as sk  # noqa: E402


def _flash_owners(dtype_dh, Sq, Hq, B):
    """(owner count of every (b, h, query row, O column), S computations
    of every (b, h, query row, key tile) for one kv tile) of a float32
    launch, enumerated block by block and thread by thread as the kernel
    maps them (``cc::attend``)."""
    dh = dtype_dh
    route, tiles, threads, _ = fk.launch_geometry(torch.float32, B, Hq, Sq,
                                                  dh)
    ncb, DH = fk.cc_column_blocks(dh)
    t = fk.cc_tiling(DH, whole=ncb == 1)
    bq, rows, ntc = t["bq"], t["rows"], t["col_threads"]
    rt = bq // rows
    owners = np.zeros((B, Hq, Sq, dh), np.int32)
    s_made = np.zeros((B, Hq, Sq), np.int32)  # S rows formed for key tile 0
    tid = np.arange(threads)
    tr, tc = tid // ntc, tid % ntc
    # S: split group sg, row group rg, key lane kl; rows rg + bq/4 a, keys
    # kl + 8 b: each group covers the (bq x 64) tile once
    sg, rg, kl = tid // (2 * bq), (tid % (2 * bq)) // 8, tid % 8
    assert sg.max() + 1 == t["split"]
    for qt in range(tiles[0]):
        for h in range(tiles[1]):
            for z in range(tiles[2]):
                b, cb = divmod(z, ncb)
                q0, col0 = qt * bq, cb * DH
                for a in range(rows):
                    r = q0 + tr + rt * a
                    for e in range(4):
                        c = col0 + 4 * tc + e
                        ok = (r < Sq) & (c < dh)
                        np.add.at(owners, (b, h, r[ok], c[ok]), 1)
                if cb == 0:  # one column block forms each S (ncb == 1)
                    for a in range(4):
                        r = q0 + rg + (bq // 4) * a
                        ok = (sg == 0) & (r < Sq)
                        np.add.at(s_made, (b, h, r[ok]), 8)  # 8 keys each
    return owners, s_made, ncb


@pytest.mark.parametrize("dh", [8, 16, 48, 64, 96, 128, 160, 256, 264, 512,
                                1000, 1024, 1100, 2049])
def test_flash_cc_owns_every_output_once(dh):
    """Every (query row, O column) of a float32 launch is written by one
    thread of one block; up to the one-block width (1,024) O's columns
    are whole in one block, so S = Q K^T of a (query tile, key tile) is
    formed once (64 keys of every row by one split group); past it, each
    of the ceil(dh / 1024) column blocks forms it again."""
    B, Hq, Sq = 2, 3, 70
    owners, s_made, ncb = _flash_owners(dh, Sq, Hq, B)
    assert (owners == 1).all()
    assert ncb == (1 if dh <= fk.CC_MAX_DH else -(-dh // fk.CC_MAX_DH))
    assert (s_made == 64).all()  # each row's 64 keys, once


@pytest.mark.parametrize("dh", [8, 64, 96, 128, 256, 264, 300, 320, 384,
                                512, 1024, 1100, 4000])
def test_flash_cc_tiling_fits_and_tiles(dh):
    """Each instance's tiling: OR rows x 4 columns a thread cover O (BQ x
    DH) over 256 threads (16 x 4 at 1,024, 8 x 4 at 128-512); the 4 x 8
    S tiles of SPLIT groups cover (BQ x 64); V chunks divide the 64-key
    tile; shared memory fits 232,448 bytes."""
    ncb, DH = fk.cc_column_blocks(dh)
    t = fk.cc_tiling(DH, whole=ncb == 1)
    bq = t["bq"]
    assert (bq // t["rows"]) * t["col_threads"] == fk.CC_THREADS
    assert 4 * t["col_threads"] == DH
    assert t["split"] * 2 * bq == fk.CC_THREADS and t["split"] * bq == 128
    assert fk.CC_BK % t["vk"] == 0 and t["vk"] % 4 == 0
    assert t["rows"] == {16: 1, 32: 2, 64: 4, 128: 8, 256: 8, 512: 8,
                         1024: 16}[DH]
    assert 4 * t["floats"] <= fk.SMEM_LIMIT
    route, tiles, threads, smem = fk.launch_geometry(torch.float32, 2, 4,
                                                     384, dh)
    assert (route, threads, smem) == ("cuda-core", 256, 4 * t["floats"])
    assert tiles == (-(-384 // bq), 4, 2 * ncb)


def _ssd_owners(b, L, h, g, q, p, n):
    """(owner count of every (b, step, head, Y column), of every (b,
    chunk, head, state row, state column), G tiles formed per (b, chunk,
    group, query tile, key tile)) of a float32 launch, enumerated as
    ``cc::ssd_chunk_kernel`` maps blocks, passes of heads and threads."""
    c = L // q
    tiles, threads, _, hb = sk.cc_geometry(b, L, h, g, q, p, n)
    ncb, P = sk.columns(p)
    qt_rows = sk.cc_tile(q, p)
    t = sk.cc_tiling(p, qt_rows)
    hpar, lt, rows, ntc = t["hpar"], t["lane"], t["rows"], t["col_threads"]
    rt = qt_rows // rows
    nq, ns = -(-q // qt_rows), -(-n // qt_rows)
    assert tiles == (ncb * (nq + ns), h // hb, b * c)
    y_own = np.zeros((b, L, h, p), np.int32)
    s_own = np.zeros((b, c, h, p, n), np.int32)
    g_made = np.zeros((b, c, g, nq, nq), np.int32)
    tid = np.arange(threads)
    hl, ltid = tid // lt, tid % lt
    tr, tc = ltid // ntc, ltid % ntc
    npass = -(-hb // hpar)
    for x in range(tiles[0]):
        cb, xr = divmod(x, nq + ns)
        for yb in range(tiles[1]):
            hd0 = yb * hb
            gi = hd0 // (h // g)
            assert all((hd0 + k) // (h // g) == gi for k in range(hb))
            for z in range(tiles[2]):
                bi, ci = divmod(z, c)
                col0 = cb * P
                for hp in range(npass):
                    hh = hp * hpar + hl
                    act = hh < hb
                    for r in range(rows):
                        for gg in range(t["groups"]):
                            for e in range(4):
                                col = col0 + 4 * (tc + ntc * gg) + e
                                if xr < nq:
                                    row = (nq - 1 - xr) * qt_rows + tr + rt * r
                                    ok = act & (row < q) & (col < p)
                                    np.add.at(y_own, (bi, ci * q + row[ok],
                                                      hd0 + hh[ok], col[ok]), 1)
                                else:
                                    s = (xr - nq) * qt_rows + rows * tr + r
                                    ok = act & (s < n) & (col < p)
                                    np.add.at(s_own, (bi, ci, hd0 + hh[ok],
                                                      col[ok], s[ok]), 1)
                if xr < nq and cb == 0:
                    qt = nq - 1 - xr
                    parked = not sk.cc_layout(h, g, q, p, n, b * c)[1]
                    for hp in range(1 if parked else npass):
                        g_made[bi, ci, gi, qt, :qt + 1] += 1
    return y_own, s_own, g_made, hb, npass


SSD_CASES = [  # (b, L, h, g, q, p, n): the card tests' and chip_smoke.py's
    (1, 32, 8, 1, 16, 64, 128),     # q = 16, 8 heads a pass
    (2, 96, 4, 2, 48, 64, 128),     # two groups, a 48-step chunk
    (1, 256, 32, 1, 256, 64, 128),  # the Mamba2-370m prefill's layout
    (1, 48, 4, 1, 24, 48, 96),      # reduced Mamba2 at widths 48 / 96
    (1, 64, 2, 1, 64, 256, 256),    # P = 256: tiles of 32 rows
    (1, 64, 2, 1, 32, 320, 64),     # p past 256: two column blocks
    (1, 8, 3, 3, 1, 8, 8),          # q = 1, a group a head
    (1, 128, 8, 1, 128, 16, 16),    # P = 16: 2 heads a pass
]


@pytest.mark.parametrize("b,L,h,g,q,p,n", SSD_CASES)
def test_ssd_cc_owns_every_output_once(b, L, h, g, q, p, n):
    """Every (step, head, column) of Y and every (chunk, head, state row,
    column) of the states of a float32 launch is written by one thread of
    one block; a block walks hb heads of one group (hb dividing h / g);
    G of a (query tile, key tile) is formed once for the block's heads
    when parked, once a pass of heads when streamed."""
    y_own, s_own, g_made, hb, npass = _ssd_owners(b, L, h, g, q, p, n)
    assert (h // g) % hb == 0 and hb <= sk.CC_HB
    assert (y_own == 1).all() and (s_own == 1).all()
    parked = not sk.cc_layout(h, g, q, p, n, b * (L // q))[1]
    tri = np.tril(np.ones(g_made.shape[-2:], np.int32))
    formed = g_made * tri
    per = (h // g) // hb  # head blocks of a group
    assert (formed == tri * per * (1 if parked else npass)).all()


# the widths and chunks of tests/test_torch_cuda.py (SSD_SHAPES, ANY_SSD,
# the grid cases) and chip_smoke.py (SSD_CASES, SSD_ANY_CASES,
# GRID_SSD_CASES, WIDE_SSD_CASES, JAMBA_SSD_CASE): (h, g, q, p, n)
SSD_RUN = [
    (1, 1, 16, 16, 16), (3, 3, 16, 16, 16), (2, 2, 32, 32, 16),
    (1, 1, 48, 64, 128), (2, 2, 256, 64, 128), (1, 1, 256, 128, 32),
    (4, 1, 24, 8, 8), (4, 4, 24, 48, 48), (4, 1, 100, 96, 96),
    (4, 1, 24, 256, 256), (4, 4, 100, 8, 256), (4, 1, 100, 256, 8),
    (4, 1, 512, 48, 96), (4, 4, 512, 96, 48), (4, 1, 512, 256, 256),
    (4, 1, 1024, 8, 8), (4, 1, 7, 8, 16), (4, 4, 1, 200, 4),
    (4, 1, 300, 4, 120), (4, 1, 64, 320, 320), (4, 4, 256, 320, 320),
    (4, 4, 64, 512, 512), (4, 1, 256, 512, 512), (4, 1, 100, 512, 128),
    (4, 4, 24, 260, 300), (4, 1, 16, 40, 520), (4, 1, 64, 1024, 1024),
    (32, 1, 256, 64, 128), (32, 32, 256, 64, 128), (8, 1, 16, 16, 16),
    (8, 1, 24, 8, 8), (8, 2, 100, 48, 48), (8, 1, 512, 96, 96),
    (8, 2, 512, 256, 256), (32, 1, 16, 64, 128), (256, 8, 64, 64, 128),
    (256, 8, 256, 64, 128), (8, 1, 64, 320, 320), (8, 2, 256, 512, 512),
    (8, 1, 64, 512, 128), (1, 1, 4096, 64, 128), (32, 1, 4096, 256, 256),
]


@pytest.mark.parametrize("h,g,q,p,n", SSD_RUN)
def test_ssd_cc_layouts_fit_shared_memory(h, g, q, p, n):
    """At every SSD shape the tests and chip_smoke.py run, the float32
    kernel's layout (the most heads a block of G parked, else G streamed;
    then fewer heads a block while the grid would hold fewer than
    ``CC_FILL`` blocks, down to a pass's heads) fits the block's 232,448
    bytes, hb divides the
    heads of a group, and the grid's tiles are the query tiles and state
    blocks of its rows."""
    pc, nc = -(-p // 4) * 4, -(-n // 4) * 4
    most = min(sk.CC_HB, sk.heads_per_block(h, g))
    hb0, stream0 = sk.cc_layout(h, g, q, pc, nc)  # shared memory alone
    assert (h // g) % hb0 == 0 and hb0 <= most
    assert sk.cc_smem_bytes(q, nc, pc, hb0, stream0) <= sk.SMEM_LIMIT
    if hb0 < most or stream0:  # a larger parked layout would not fit
        assert sk.cc_smem_bytes(q, nc, pc, most, False) > sk.SMEM_LIMIT
    tiles, threads, smem, hb = sk.cc_geometry(2, 2 * q, h, g, q, pc, nc)
    assert (hb, threads) == (sk.cc_layout(h, g, q, pc, nc, 4)[0], 256)
    assert (h // g) % hb == 0 and hb <= hb0 and smem <= sk.SMEM_LIMIT
    qt = sk.cc_tile(q, pc)
    x = sk.columns(pc)[0] * (-(-q // qt) + -(-nc // qt))
    assert tiles == (x, h // hb, 4)
    if hb < hb0:  # halved only while the grid held too few blocks, and
        # not below the heads one pass takes
        assert x * (h // (2 * hb)) * 4 < sk.CC_FILL
        assert hb >= min(sk.cc_tiling(pc, qt)["hpar"],
                         sk.heads_per_block(h, g))


def test_ssd_cc_tile_rows_follow_the_chunk():
    """Tiles are at most round_up(q, 16) rows: 16 for a chunk of up to 16
    steps (no 48 padding rows at q = 16), else 64, 32 at instance 256;
    heads a pass keep Y's tile at 32 floats a thread where the head block
    allows."""
    assert [sk.cc_tile(q, 64) for q in (1, 16, 17, 256)] == [16, 16, 64, 64]
    assert [sk.cc_tile(q, 256) for q in (16, 24, 512)] == [16, 32, 32]
    for P, qt in ((16, 16), (32, 16), (64, 16), (128, 16), (256, 16),
                  (16, 64), (32, 64), (64, 64), (128, 64), (256, 32)):
        t = sk.cc_tiling(P, qt)
        assert t["hpar"] * t["lane"] == sk.CC_THREADS
        assert (qt // t["rows"]) * t["col_threads"] == t["lane"]
        assert 4 * t["col_threads"] * t["groups"] == P
        per_thread = t["rows"] * 4 * t["groups"]
        assert per_thread == qt * P * t["hpar"] // sk.CC_THREADS
        assert per_thread == 32 or (qt, P) in ((16, 16), (16, 32),
                                               (64, 16), (64, 32))
