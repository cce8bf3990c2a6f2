# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Flash attention past head width 256 and the SSD kernel at any head
width, state width and chunk: the plain routes these shapes take on a CPU
tensor against the JAX package (its plain versions and its Pallas kernels
in interpret mode), the kernels' launch geometries within shared memory,
and a reduced Mamba2 at SSM head width 48, state width 96 and chunk 24
against JAX's ``ssd`` on its kernel route.  The kernels themselves run on
the card: tests/test_torch_cuda.py."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.kernels.flash_attention import attention_ref as j_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.kernels.ssd_chunk import ssd_chunks as jchunks  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.serve import ServeDriver as JDriver  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.ssd_chunk import kernel as sk  # noqa: E402
from repro_torch.kernels.ssd_chunk import ssd_chunks  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.serve import ServeDriver  # noqa: E402

from _torch_port import TIE, model_pair  # noqa: E402

SSD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # tests/test_ssd_kernel.py
SCAN_TOL = 1e-4  # a whole scan, f32, XLA vs ATen summation order


def _qkv(B, Hq, Hkv, S, dh, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Hq, S, dh).astype(np.float32) * 0.5
    k = rng.randn(B, Hkv, S, dh).astype(np.float32) * 0.5
    v = rng.randn(B, Hkv, S, dh).astype(np.float32)
    return q, k, v


# ------------------------------------------------ flash past head width 256
@pytest.mark.parametrize("dh", [264, 320, 512])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_route_matches_jax_past_256(dh, causal):
    """The port's padded plain route (the route these widths take on a
    CPU tensor) against JAX's ``attention_ref`` and its Pallas kernel in
    interpret mode, float32, GQA 4 / 2, ragged S = 100."""
    q, k, v = _qkv(1, 4, 2, 100, dh, dh + causal)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=causal, block_q=64, block_k=64).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    np.testing.assert_allclose(got, np.asarray(j_ref(jq, jk, jv,
                                                     causal=causal)),
                               rtol=2e-4, atol=2e-4)
    kern = np.asarray(j_flash(jq, jk, jv, causal=causal, interpret=True,
                              block_q=64, block_k=64))
    np.testing.assert_allclose(got, kern, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dh,blocks,width", [
    (257, 2, 160), (264, 2, 160), (300, 2, 160), (320, 2, 160),
    (384, 2, 192), (500, 2, 256), (512, 2, 256), (513, 3, 192),
    (1024, 4, 256), (4000, 16, 256)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_wide_geometry(dtype, dh, blocks, width):
    """Past 256, bf16 splits O's columns into ceil(dh / 256) blocks along
    grid z, each on the instance of its share, every block holding a
    column of dh; shared memory no longer grows with dh (a four-stage ring
    of 64-column Q / K slices and a two-stage V ring, 164,960 bytes at 256
    columns).  float32 holds every width up to 1,024 in one block (16
    query rows past 256: Q once, a three-stage ring of K depth chunks and
    V key chunks, the partial S tiles; 171,392 bytes at 512, 204,160 at
    1,024) and splits O's columns only past that (4,000: four blocks of
    1,024, Q's slices riding with K's)."""
    assert fk.column_blocks(dh) == (blocks, width)
    assert fk.instance_width(dh) == width and width in fk.HEAD_DIMS
    assert blocks * width >= dh > (blocks - 1) * 256
    route, grid, threads, smem = fk.launch_geometry(dtype, 2, 8, 1024, dh)
    assert smem <= fk.SMEM_LIMIT
    if dtype == torch.bfloat16:
        assert grid[1:] == (8, 2 * blocks)
        assert (route, grid[0], threads) == ("tensor-core", 8, 384)
        assert smem == 4 * 2 * (128 + 64) * 64 + 2 * 2 * 64 * width + 96 + 1024
    else:
        ncb, DH = fk.cc_column_blocks(dh)
        assert (ncb, DH) == ((1, 512) if dh <= 512 else (1, 1024)
                             if dh <= 1024 else (4, 1024))
        assert ncb * DH >= dh > (ncb - 1) * fk.CC_MAX_DH
        assert (route, grid, threads) == ("cuda-core", (64, 8, 2 * ncb), 256)
        ring = 3 * 64 * 132  # 64 keys x 128 depth columns (+4)
        if ncb > 1:  # Q's 16-row slices ride in the K chunks
            ring = 3 * (64 + 16) * 132
        q = 16 * (DH + 4) if ncb == 1 else 0
        assert smem == 4 * (q + ring + 8 * 16 * 72 + 2 * 16)
        assert smem == {512: 171392, 1024: 204160 if ncb == 1 else 163712}[DH]
    # up to 256, the one-block geometry of before
    assert fk.column_blocks(256) == (1, 256)
    assert fk.launch_geometry(dtype, 2, 8, 1024, 256)[1][2] == 2


# ------------------------------------------------- SSD at any shape
ANY_WIDTHS = [(8, 8), (48, 48), (96, 96), (256, 256), (8, 256), (256, 8),
              (48, 96)]


def _ssd_f64(X, Adt, B, C, chunk):
    """The intra-chunk term and end-states in float64 numpy (the formula
    of ``ssd_chunk_ref``), B / C per head: (Y (b, L, h, p), states (b, c,
    h, p, n))."""
    b, L, h, p = X.shape
    c = L // chunk
    Xc, Bc, Cc = (a.astype(np.float64).reshape(b, c, chunk, h, -1)
                  for a in (X, B, C))
    acum = np.cumsum(Adt.astype(np.float64).reshape(b, c, chunk, h), 2)
    diff = acum[:, :, :, None] - acum[:, :, None, :]  # (b, c, i, j, h)
    tri = np.tril(np.ones((chunk, chunk), bool))[None, None, :, :, None]
    Lm = np.exp(np.where(tri, diff, -np.inf))
    S = np.einsum("bcihn,bcjhn->bcijh", Cc, Bc) * Lm
    Y = np.einsum("bcijh,bcjhp->bcihp", S, Xc).reshape(b, L, h, p)
    decay = np.exp(acum[:, :, -1:] - acum)
    st = np.einsum("bcjhn,bcjh,bcjhp->bchpn", Bc, decay, Xc)
    return Y, st


@pytest.mark.parametrize("chunk", [24, 100, 512])
@pytest.mark.parametrize("p,n", ANY_WIDTHS)
def test_ssd_plain_route_matches_jax_any_shape(p, n, chunk):
    """Head and state widths that are no instance of the kernel and past
    128, chunks that are no multiple of 16 and past 256: the model-layout
    plain route, float32, 4 heads in one group, against the same formula
    in float64 and against JAX's ``ssd_chunks`` on its jnp route and on
    the Pallas kernel in interpret mode, within 1e-5 of the output's scale
    at chunks 24 and 100.  At chunk 512 float32 sums run over 512 keys
    (and G over 256 state columns), and the JAX side's float32 cumsum of
    512 steps drifts 1.6-2.3e-4 from the exact sum (the port's acum is the
    exact sum rounded once, ``chunk_cumsum``): measured up to 2.2e-5 of
    the scale against JAX and 1.2e-5 against float64, so there every
    comparison takes the whole-scan tolerance of 1e-4."""
    c = 2 if chunk < 512 else 1
    b, h, L = 1, 4, c * chunk
    rng = np.random.default_rng(p * 1000 + n + chunk)
    X = rng.standard_normal((b, L, h, p)).astype(np.float32)
    Adt = -np.logaddexp(0.0, rng.standard_normal((b, L, h))).astype(
        np.float32)
    Bg = rng.standard_normal((b, L, 1, n)).astype(np.float32)
    Cg = rng.standard_normal((b, L, 1, n)).astype(np.float32)
    Y, st = ssd_chunks(*(torch.from_numpy(a) for a in (X, Adt, Bg, Cg)),
                       chunk=chunk)
    assert tuple(Y.shape) == (b, L, h, p)
    assert tuple(st.shape) == (b, c, h, p, n)
    Bh, Ch = np.repeat(Bg, h, 2), np.repeat(Cg, h, 2)
    jin = [jnp.asarray(a) for a in (X, Adt, Bh, Ch)]
    tol = SSD_TOL["float32"] if chunk < 512 else SCAN_TOL
    wants = [_ssd_f64(X, Adt, Bh, Ch, chunk)] + [
        jchunks(*jin, chunk=chunk, use_pallas=use_pallas,
                interpret=use_pallas) for use_pallas in (True, False)]
    for Yw, sw in wants:
        for got, want in ((Y, Yw), (st, sw)):
            want = np.asarray(want, np.float32)
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got.numpy() / scale, want / scale,
                                       rtol=tol, atol=tol)


@pytest.mark.parametrize("chunk", [24, 100, 512])
def test_ssd_plain_route_matches_jax_any_shape_bf16(chunk):
    """bf16 at p = n = 48 (one group of 4 heads) against JAX's Pallas
    kernel in interpret mode, within the bf16 2e-2 of the output's
    scale."""
    b, h, L, p, n = 1, 4, 2 * chunk, 48, 48
    rng = np.random.default_rng(chunk)
    X = rng.standard_normal((b, L, h, p)).astype(np.float32)
    Adt = -np.logaddexp(0.0, rng.standard_normal((b, L, h))).astype(
        np.float32)
    B = rng.standard_normal((b, L, h, n)).astype(np.float32)
    C = rng.standard_normal((b, L, h, n)).astype(np.float32)
    Y, st = ssd_chunks(*(torch.from_numpy(a).bfloat16()
                         for a in (X, Adt, B, C)), chunk=chunk)
    Yj, sj = jchunks(*(jnp.asarray(a).astype(jnp.bfloat16)
                       for a in (X, Adt, B, C)), chunk=chunk,
                     use_pallas=True, interpret=True)
    for got, want in ((Y, Yj), (st, sj)):
        want = np.asarray(want, np.float32)
        scale = max(1.0, float(np.abs(want).max()))
        err = np.abs(got.float().numpy() - want) / scale
        assert err.max() <= SSD_TOL["bfloat16"], err.max()


@pytest.mark.parametrize("q", [1, 7, 24, 100, 256, 300, 512, 1024, 4096])
def test_ssd_geometry_any_shape(q):
    """Every width from 1 to 256 at every chunk up to ``MAX_CHUNK`` has a
    tensor-core layout within the block's shared memory (G parked while
    it fits, else streamed) and a CUDA-core one (tiles of 16 rows to q =
    16, else 64, 32 at width 256; G parked while it fits, else formed
    again for each pass of heads); at chunk 512 the widths of 256 stream
    G, 8 to 96 park it; a chunk past what fits raises naming the limit."""
    for p in (1, 8, 13, 48, 96, 129, 200, 256):
        for n in (1, 8, 24, 96, 256):
            pw, nw = -(-p // 8) * 8, -(-n // 8) * 8
            grid, threads, smem, hb = sk.mma_geometry(2, 2 * q, 32, 1, q,
                                                      pw, nw)
            assert smem <= sk.SMEM_LIMIT and threads == 128
            assert grid == (-(-q // 64) + -(-nw // 64), 32 // hb, 4)
            pc, nc = -(-p // 4) * 4, -(-n // 4) * 4
            grid, threads, smem, hb = sk.cc_geometry(2, 2 * q, 32, 1, q, pc,
                                                     nc)
            qt = sk.cc_tile(q, pc)
            assert smem <= sk.SMEM_LIMIT and threads == 256
            assert grid == (-(-q // qt) + -(-nc // qt), 32 // hb, 4)
            assert smem == sk.cc_smem_bytes(
                q, nc, pc, hb, sk.cc_layout(32, 1, q, pc, nc, 4)[1])
            assert sk.p_instance(p) >= p
    if q == 512:
        assert sk.mma_layout(32, 1, 512, 256, 256) == (8, True)
        for w in (8, 48, 96):
            assert sk.mma_layout(32, 1, 512, w, w) == (8, False)
    if q == 4096:
        assert sk.mma_layout(32, 1, q, 256, 256) == (2, True)
        with pytest.raises(ValueError, match="over the 232448"):
            sk.mma_layout(32, 1, 16 * q, 256, 256)
    assert sk.mma_geometry(8, 2048, 32, 1, 256, 64, 128)[2:] == (108544, 8)
    # the Mamba2-370m prefill on the CUDA cores: 4 query tiles and 2 state
    # blocks of 64 rows, 8 heads a block, G parked (179,200 bytes)
    assert sk.cc_geometry(8, 2048, 32, 1, 256, 64, 128) == (
        (6, 4, 64), 256, 179200, 8)
    assert sk.cc_layout(32, 1, 256, 64, 128) == (8, False)


# ------------------------------------- a reduced Mamba2 at those widths
def _any_mamba_cfg():
    """The reduced Mamba2 at SSM head width 48, state width 96 and chunk
    24 (d_model 96: four heads of 48), float32."""
    base = jget("mamba2-370m", reduced=True)
    return dataclasses.replace(
        base, dtype="float32", d_model=96,
        ssm=dataclasses.replace(base.ssm, head_dim=48, d_state=96, chunk=24))


def test_reduced_mamba2_any_shape_ssd_matches_jax_kernel_route():
    """The whole chunked scan at the reduced Mamba2's SSD shapes (4 heads
    of 48, d_state 96 in one group, chunk 24, 3 chunks) with an initial
    state: the port's ``ssd`` on its kernel route (the plain version on a
    CPU tensor) against JAX's ``ssd`` at ``use_pallas=True,
    interpret=True``."""
    b, L, h, p, n, chunk = 2, 72, 4, 48, 96, 24
    rng = np.random.default_rng(21)
    X = rng.standard_normal((b, L, h, p)).astype(np.float32)
    Adt = -np.logaddexp(0.0, rng.standard_normal((b, L, h))).astype(
        np.float32)
    Bg = rng.standard_normal((b, L, 1, n)).astype(np.float32)
    Cg = rng.standard_normal((b, L, 1, n)).astype(np.float32)
    init = rng.standard_normal((b, h, p, n)).astype(np.float32)
    Yj, fj = jmamba.ssd(*(jnp.asarray(a) for a in (
        X, Adt, np.repeat(Bg, h, 2), np.repeat(Cg, h, 2))), chunk,
        init_state=jnp.asarray(init), use_pallas=True, interpret=True)
    Yt, ft = tmamba.ssd(*(torch.from_numpy(a) for a in (X, Adt, Bg, Cg)),
                        chunk, init_state=torch.from_numpy(init),
                        use_pallas=True)
    for got, want in ((Yt, Yj), (ft, fj)):
        want = np.asarray(want, np.float32)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy() / scale, want / scale,
                                   rtol=SCAN_TOL, atol=SCAN_TOL)


def test_reduced_mamba2_any_shape_generates_like_jax(monkeypatch):
    """The reduced Mamba2 at head width 48, state width 96, chunk 24
    through ``ServeDriver.generate`` (prompts of 30 tokens, padded to two
    chunks): the same greedy tokens as JAX's ServeDriver with its layers'
    ``ssd`` on the kernel route in interpret mode, on a fixture whose
    top-2 logit gaps clear 1e-4; every layer's prefill reaches
    ``ssd_chunks`` once, at chunk 24."""
    jcfg = _any_mamba_cfg()
    monkeypatch.setattr(jmamba, "ssd", functools.partial(
        jmamba.ssd, use_pallas=True, interpret=True))
    calls = []
    route = tmamba.ssd_chunks

    def counted(*a, **kw):
        calls.append((a[0].shape[2:], a[2].shape[3], kw["chunk"]))
        return route(*a, **kw)

    monkeypatch.setattr(tmamba, "ssd_chunks", counted)
    jm, jp, tm, tp = model_pair(jcfg)
    B, P, n_new = 2, 30, 4
    prompts = np.random.default_rng(22).integers(
        0, jcfg.vocab, (B, P)).astype(np.int32)
    max_seq = P + n_new + 4
    want = np.asarray(JDriver(model=jm, max_seq=max_seq, batch=B).generate(
        jp, jnp.asarray(prompts), n_new))
    # the JAX model's top-2 logit gap at every generated token
    caches = jinit_cache(jcfg, B, max_seq, jnp.float32)
    logits, caches, _ = jm.prefill(jp, {"tokens": jnp.asarray(prompts)},
                                   caches)
    steps = [np.asarray(logits)]
    for i in range(n_new - 1):
        logits, caches = jm.decode_step(
            jp, jnp.asarray(want[:, P + i:P + i + 1]), caches,
            jnp.int32(P + i))
        steps.append(np.asarray(logits))
    top = np.sort(np.stack(steps), axis=-1)[..., -2:]
    gap = (top[..., 1] - top[..., 0]) / np.maximum(1.0, np.abs(top[..., 1]))
    assert gap.min() > TIE, f"near-tie fixture: min gap {gap.min()}"
    got = ServeDriver(model=tm, max_seq=max_seq, batch=B).generate(
        tp, torch.from_numpy(prompts), n_new)
    np.testing.assert_array_equal(got.numpy(), want)
    assert calls == [((4, 48), 96, 24)] * jcfg.n_layers


# --------------------------------------- SSD past width 256 (the _wide route)
@pytest.mark.parametrize("p,n", [(320, 320), (512, 512), (512, 128)])
def test_ssd_plain_matches_jax_kernel_past_256(p, n):
    """``ssd_plain`` (the route the _wide kernels are held against on the
    card, and the port's route for a CPU tensor) against JAX's Pallas
    kernel in interpret mode and the float64 formula past width 256:
    b = 1, 2 heads in one group, L = 128, chunk 64, float32, within 1e-5
    of the output's scale."""
    from repro_torch.kernels.ssd_chunk.ops import ssd_plain

    b, h, L, chunk = 1, 2, 128, 64
    rng = np.random.default_rng(p + n)
    X = rng.standard_normal((b, L, h, p)).astype(np.float32)
    Adt = -np.logaddexp(0.0, rng.standard_normal((b, L, h))).astype(
        np.float32)
    Bg = rng.standard_normal((b, L, 1, n)).astype(np.float32)
    Cg = rng.standard_normal((b, L, 1, n)).astype(np.float32)
    Y, st = ssd_plain(*(torch.from_numpy(a) for a in (X, Adt, Bg, Cg)),
                      chunk=chunk)
    assert tuple(st.shape) == (b, L // chunk, h, p, n)
    Bh, Ch = np.repeat(Bg, h, 2), np.repeat(Cg, h, 2)
    wants = [_ssd_f64(X, Adt, Bh, Ch, chunk), jchunks(
        *(jnp.asarray(a) for a in (X, Adt, Bh, Ch)), chunk=chunk,
        use_pallas=True, interpret=True)]
    for Yw, sw in wants:
        for got, want in ((Y, Yw), (st, sw)):
            want = np.asarray(want, np.float32)
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got.numpy() / scale, want / scale,
                                       rtol=SSD_TOL["float32"],
                                       atol=SSD_TOL["float32"])


def test_reduced_mamba2_at_head_width_320_matches_jax():
    """A reduced Mamba2 whose SSM heads are 320 wide with a state of 288
    (d_model 320: two heads, chunk 32), float32: the port's prefill (on a
    CPU tensor the kernel route's plain version; on the card the _wide
    kernels) against JAX's with its layers' ``ssd`` on the Pallas kernel
    in interpret mode, the last logits and every layer's SSM state within
    1e-4 of their scale."""
    jcfg = jget("mamba2-370m", reduced=True)
    jcfg = dataclasses.replace(
        jcfg, dtype="float32", d_model=320,
        ssm=dataclasses.replace(jcfg.ssm, head_dim=320, d_state=288,
                                chunk=32))
    jm, jp, tm, tp = model_pair(jcfg)
    B, P = 2, 64
    prompts = np.random.default_rng(23).integers(
        0, jcfg.vocab, (B, P)).astype(np.int32)
    route = functools.partial(jmamba.ssd, use_pallas=True, interpret=True)
    saved, jmamba.ssd = jmamba.ssd, route
    try:
        jl, jc, _ = jm.prefill(jp, {"tokens": jnp.asarray(prompts)},
                               jinit_cache(jcfg, B, P + 8, jnp.float32))
    finally:
        jmamba.ssd = saved
    from repro_torch.models import init_cache

    with torch.inference_mode():
        tl, tc, _ = tm.prefill(tp, {"tokens": torch.from_numpy(prompts)},
                               init_cache(tm.cfg, B, P + 8, device="cpu"))
    # the layers' SSM states, stacked: (layers, B, heads, p, n)
    pairs = [(tl, jl), (tc["blocks"]["l0"]["ssm"], jc["blocks"]["l0"]["ssm"])]
    assert tuple(pairs[1][0].shape) == (jcfg.n_layers, B, 2, 320, 288)
    for got, want in pairs:
        want = np.asarray(want, np.float32)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy() / scale, want / scale,
                                   rtol=SCAN_TOL, atol=SCAN_TOL)
