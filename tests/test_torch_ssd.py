# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of the SSD intra-chunk kernel's plain side (``repro.kernels.
ssd_chunk``) and of ``repro.models.mamba.ssd``, held against the JAX
package on the same numpy inputs: the plain version against the JAX
oracle and against the Pallas kernel in interpret mode, the layout
wrapper's routes and refusals, and the full chunked scan on both
``use_pallas`` routes against JAX and against the per-step recurrence.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.ssd_chunk import ssd_chunk_ref as jref  # noqa: E402
from repro.kernels.ssd_chunk import ssd_chunks as jchunks  # noqa: E402
from repro.kernels.ssd_chunk.kernel import ssd_chunk_pallas  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro_torch.kernels.ssd_chunk import (chunk_cumsum,  # noqa: E402
                                           ssd_chunk_cuda, ssd_chunk_ref,
                                           ssd_chunks)
from repro_torch.models import mamba as tmamba  # noqa: E402

# the shapes of tests/test_ssd_kernel.py: b, L, h, p, n, chunk
SHAPES = [
    (1, 16, 1, 8, 4, 16),
    (2, 64, 3, 16, 8, 16),
    (1, 128, 2, 32, 16, 32),
    (2, 96, 1, 64, 128, 48),  # mamba2-370m head_dim/d_state shapes
]
# tests/test_ssd_kernel.py:35, held on the output's scale (``_close``)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SSD_TOL = 1e-4  # a whole scan, f32, XLA vs ATen summation order


def _inputs(seed, b, L, h, p, n, decay=1.0):
    """float32 numpy X, Adt = -decay * softplus(N(0, 1)), B, C."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((b, L, h, p)).astype(np.float32)
    Adt = (-decay * np.logaddexp(0.0, rng.standard_normal((b, L, h)))
           ).astype(np.float32)
    B = rng.standard_normal((b, L, h, n)).astype(np.float32)
    C = rng.standard_normal((b, L, h, n)).astype(np.float32)
    return X, Adt, B, C


def _jax(arrays, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return [jnp.asarray(a).astype(jdt) for a in arrays]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    """|got - want| <= tol * (scale + |want|), scale = max(1, max|want|):
    the JAX file's rtol = atol = tol with the absolute part on the scale
    of the output.  Its float32 1e-5 holds JAX against JAX (one XLA
    summation order); across frameworks the sums of up to 128-term
    products run in another order and JAX's float32 cumsum rounds acum
    differently (``chunk_cumsum``), an error on the scale of the terms,
    so outputs that cancel to near 0 miss an absolute 1e-5: measured up
    to 4.6e-5 * (1 + |want|) on these shapes over four seeds."""
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = np.abs(got.float().numpy() - want)
    assert (err <= tol * (scale + np.abs(want))).all(), (
        f"max err {err.max()} (scale {scale}, tol {tol})")


# ---------------------------------------------------- the plain version
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,L,h,p,n,chunk", SHAPES)
def test_ssd_chunk_ref_matches_jax_ref(b, L, h, p, n, chunk, dtype):
    """In the kernel's tile layout (b, h, c, q, x)."""
    arrays = _inputs(0, b, L, h, p, n)
    c = L // chunk

    def tiles(a):
        return np.ascontiguousarray(
            a.reshape(b, c, chunk, h, -1).transpose(0, 3, 1, 2, 4))

    X, B, C = (tiles(a) for a in (arrays[0], arrays[2], arrays[3]))
    Adt = np.ascontiguousarray(arrays[1].reshape(b, c, chunk, h)
                               .transpose(0, 3, 1, 2))
    Yj, sj = jref(*_jax((X, Adt, B, C), dtype))
    Yt, st = ssd_chunk_ref(*_torch((X, Adt, B, C), dtype))
    assert Yt.dtype == getattr(torch, dtype) and st.dtype == torch.float32
    assert tuple(Yt.shape) == Yj.shape and tuple(st.shape) == sj.shape
    _close(Yt, Yj, TOL[dtype])
    _close(st, sj, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,L,h,p,n,chunk", SHAPES)
def test_ssd_chunks_matches_pallas_interpret(b, L, h, p, n, chunk, dtype):
    """The model-layout entry on the plain route against the TPU kernel
    run in interpret mode (and against the JAX wrapper's jnp route)."""
    arrays = _inputs(1, b, L, h, p, n)
    jin = _jax(arrays, dtype)
    Yp, sp = jchunks(*jin, chunk=chunk, use_pallas=True, interpret=True)
    Yr, sr = jchunks(*jin, chunk=chunk, use_pallas=False)
    Yt, st = ssd_chunks(*_torch(arrays, dtype), chunk=chunk)
    assert tuple(Yt.shape) == Yp.shape and tuple(st.shape) == sp.shape
    for want_Y, want_s in ((Yp, sp), (Yr, sr)):
        _close(Yt, want_Y, TOL[dtype])
        _close(st, want_s, TOL[dtype])


def test_ssd_chunk_pallas_tiles_match():
    """The tile-layout entry against the TPU kernel itself (interpret)."""
    b, h, c, q, p, n = 1, 2, 2, 32, 16, 8
    rng = np.random.default_rng(2)
    X = rng.standard_normal((b, h, c, q, p)).astype(np.float32)
    Adt = -np.logaddexp(0.0, rng.standard_normal((b, h, c, q))).astype(
        np.float32)
    B = rng.standard_normal((b, h, c, q, n)).astype(np.float32)
    C = rng.standard_normal((b, h, c, q, n)).astype(np.float32)
    Yp, sp = ssd_chunk_pallas(*_jax((X, Adt, B, C), "float32"),
                              interpret=True)
    Yt, st = ssd_chunk_ref(*_torch((X, Adt, B, C), "float32"))
    _close(Yt, Yp, 1e-5)
    _close(st, sp, 1e-5)


def test_chunk_cumsum_is_the_rounded_float64_sum():
    """acum is the float32 rounding of the float64 sum: what torch.cumsum
    of float32 gives on the CPU, bit for bit, and within a few float32
    ulps of the JAX oracle's float32 cumsum."""
    rng = np.random.default_rng(3)
    A = -np.logaddexp(0.0, rng.standard_normal((64, 256))).astype(np.float32)
    got = chunk_cumsum(torch.from_numpy(A))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.cumsum(A.astype(np.float64), -1).astype(np.float32))
    np.testing.assert_array_equal(got.numpy(),
                                  torch.cumsum(torch.from_numpy(A), -1)
                                  .numpy())
    np.testing.assert_allclose(got.numpy(), np.cumsum(A, -1), rtol=1e-6,
                               atol=0)


def test_fast_decay_stays_finite():
    """Adt = -1 per step over a 256-step chunk: acum falls to -256, so
    exp(acum_i - acum_j) above the diagonal is inf; the select keeps it
    out (a masked product would give NaN), and the chunk agrees with the
    per-step recurrence."""
    b, L, h, p, n = 1, 256, 2, 16, 16
    X, _, B, C = _inputs(4, b, L, h, p, n)
    Adt = np.full((b, L, h), -1.0, np.float32)
    t = _torch((X, Adt, B, C), "float32")
    assert float(chunk_cumsum(t[1][0, :, 0]).min()) < -200
    Y, st = ssd_chunks(*t, chunk=L)
    assert torch.isfinite(Y).all() and torch.isfinite(st).all()
    Yr, final = tmamba.ssd_reference(*t)
    torch.testing.assert_close(Y, Yr, rtol=1e-4, atol=1e-4)
    # one chunk: the end-state is the recurrence's final state
    torch.testing.assert_close(st[:, 0], final, rtol=1e-4, atol=1e-4)


# ------------------------------------------------- backends and refusals
def test_ssd_chunks_backends():
    X, Adt, B, C = _torch(_inputs(5, 2, 32, 2, 16, 16), "float32")
    auto = ssd_chunks(X, Adt, B, C, chunk=16)
    plain = ssd_chunks(X, Adt, B, C, chunk=16, backend="torch")
    for a, b in zip(auto, plain):
        assert torch.equal(a, b)
    assert tuple(auto[1].shape) == (2, 2, 2, 16, 16)  # (b, c, h, p, n)


def test_ssd_chunks_refusals():
    """The kernel route on a CPU tensor raises, it never falls back to the
    plain version; so do an unknown backend and a ragged sequence."""
    X, Adt, B, C = _torch(_inputs(6, 1, 32, 1, 16, 16), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunks(X, Adt, B, C, chunk=16, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        ssd_chunks(X, Adt, B, C, chunk=16, backend="pallas")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_chunks(X, Adt, B, C, chunk=24)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunk_cuda(X, Adt, B, C, chunk=16)


# --------------------------------------------------------- the full scan
@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("b,L,h,p,n,chunk", [(2, 64, 2, 16, 8, 16),
                                             (1, 128, 3, 16, 16, 32)])
def test_ssd_matches_jax_and_recurrence(b, L, h, p, n, chunk, use_pallas):
    """The port's ssd on each route against JAX's ssd on the same route
    (its kernel route in interpret mode) and against the per-step
    recurrence, with an initial state: the whole sequence at once equals
    its two halves chained through the first half's final state."""
    X, Adt, B, C = _inputs(7, b, L, h, p, n)
    rng = np.random.default_rng(8)
    init = rng.standard_normal((b, h, p, n)).astype(np.float32)
    kw = {"use_pallas": use_pallas}
    Yj, fj = jmamba.ssd(*_jax((X, Adt, B, C), "float32"), chunk,
                        init_state=jnp.asarray(init), interpret=True, **kw)
    t = _torch((X, Adt, B, C), "float32")
    Yt, ft = tmamba.ssd(*t, chunk, init_state=torch.from_numpy(init), **kw)
    _close(Yt, Yj, SSD_TOL)
    _close(ft, fj, SSD_TOL)
    Yr, fr = tmamba.ssd_reference(*t, init_state=torch.from_numpy(init))
    torch.testing.assert_close(Yt, Yr, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(ft, fr, rtol=SSD_TOL, atol=SSD_TOL)
    half = L // 2
    Y1, f1 = tmamba.ssd(*(a[:, :half] for a in t), chunk,
                        init_state=torch.from_numpy(init), **kw)
    Y2, f2 = tmamba.ssd(*(a[:, half:] for a in t), chunk, init_state=f1,
                        **kw)
    torch.testing.assert_close(torch.cat([Y1, Y2], 1), Yt, rtol=SSD_TOL,
                               atol=SSD_TOL)
    torch.testing.assert_close(f2, ft, rtol=SSD_TOL, atol=SSD_TOL)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_dtypes_follow_jax(dtype, use_pallas):
    """On the kernel route the states are float32, so Y and final are
    float32 whatever X's dtype; on the einsum route they keep it (as JAX
    promotes).  bf16 values within a rounding bound of JAX's."""
    b, L, h, p, n, chunk = 1, 64, 2, 16, 16, 16
    arrays = _inputs(9, b, L, h, p, n)
    Yj, fj = jmamba.ssd(*_jax(arrays, dtype), chunk, use_pallas=use_pallas,
                        interpret=True)
    Yt, ft = tmamba.ssd(*_torch(arrays, dtype), chunk,
                        use_pallas=use_pallas)
    for got, want in ((Yt, Yj), (ft, fj)):
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    tol = SSD_TOL if dtype == "float32" else 1e-1
    scale = max(1.0, float(np.abs(_np(Yj)).max()))
    np.testing.assert_allclose(Yt.float().numpy() / scale, _np(Yj) / scale,
                               rtol=tol, atol=tol)


# ------------------------------------------------- B and C per group
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 2])
def test_grouped_ssd_chunks_match_jax_per_head(g, dtype):
    """B and C per group (b, L, g, n), h = 4 heads (two or four per
    group), through ``ssd_chunks``'s plain route, against the JAX
    ``ssd_chunks`` given B and C repeated per head (its only signature),
    on the jnp route and on the TPU kernel in interpret mode; and against
    the port's own per-head call, which must give the same numbers (the
    plain route repeats B and C itself)."""
    b, L, h, p, n, chunk = 2, 64, 4, 16, 8, 32
    X, Adt, B, C = _inputs(10 + g, b, L, h, p, n)
    Bg, Cg = B[:, :, :g], C[:, :, :g]
    Bh, Ch = (np.repeat(a, h // g, axis=2) for a in (Bg, Cg))
    jin = _jax((X, Adt, Bh, Ch), dtype)
    got = ssd_chunks(*_torch((X, Adt, Bg, Cg), dtype), chunk=chunk)
    per_head = ssd_chunks(*_torch((X, Adt, Bh, Ch), dtype), chunk=chunk)
    for a, b_ in zip(got, per_head):
        assert torch.equal(a, b_)
    for use_pallas in (False, True):
        Yj, sj = jchunks(*jin, chunk=chunk, use_pallas=use_pallas,
                         interpret=use_pallas)
        _close(got[0], Yj, TOL[dtype])
        _close(got[1], sj, TOL[dtype])


@pytest.mark.parametrize("use_pallas", [True, False])
def test_grouped_ssd_matches_jax(use_pallas):
    """The whole chunked scan with B and C per group (g = 2, h = 4; the
    inter-chunk term reads C per group) against JAX's ssd with B and C
    repeated per head, float32, with an initial state."""
    b, L, h, p, n, chunk, g = 2, 64, 4, 16, 8, 16, 2
    X, Adt, B, C = _inputs(12, b, L, h, p, n)
    Bg, Cg = B[:, :, :g], C[:, :, :g]
    Bh, Ch = (np.repeat(a, h // g, axis=2) for a in (Bg, Cg))
    init = np.random.default_rng(13).standard_normal(
        (b, h, p, n)).astype(np.float32)
    Yj, fj = jmamba.ssd(*_jax((X, Adt, Bh, Ch), "float32"), chunk,
                        init_state=jnp.asarray(init), use_pallas=use_pallas,
                        interpret=True)
    Yt, ft = tmamba.ssd(*_torch((X, Adt, Bg, Cg), "float32"), chunk,
                        init_state=torch.from_numpy(init),
                        use_pallas=use_pallas)
    _close(Yt, Yj, SSD_TOL)
    _close(ft, fj, SSD_TOL)


@pytest.mark.parametrize("n_groups", [1, 2])
def test_mamba2_prefill_hands_groups_and_matches_jax(monkeypatch, n_groups):
    """A Mamba2 layer at the reduced config (8 heads of 16, d_state 16,
    chunk 16; one group as Mamba2-370m, and two) through the port's
    prefill: ``ssd_chunks`` receives B and C per group, not repeated per
    head, and the output, conv cache and SSM state equal JAX's (which
    repeats them), float32 within the model tests' 1e-4."""
    import dataclasses

    from _torch_port import port_config
    from repro.configs import get_config as jget

    jcfg = jget("mamba2-370m", reduced=True)
    jcfg = dataclasses.replace(jcfg, dtype="float32", ssm=dataclasses.replace(
        jcfg.ssm, n_groups=n_groups))
    tcfg = port_config(jcfg)
    rng = np.random.default_rng(14)
    p = {k: (0.3 * rng.standard_normal(d.shape)).astype(np.float32)
         for k, d in tmamba.mamba_spec(tcfg).items()}
    seen = []
    route = tmamba.ssd_chunks

    def recorded(X, Adt, B, C, **kw):
        seen.append((X.shape[2], B.shape[2], C.shape[2]))
        return route(X, Adt, B, C, **kw)

    monkeypatch.setattr(tmamba, "ssd_chunks", recorded)
    Bsz, S = 2, 24  # padded to two chunks of 16
    x = rng.standard_normal((Bsz, S, jcfg.d_model)).astype(np.float32)
    jout, jc = jmamba.mamba_prefill(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jmamba.mamba_init_cache(jcfg, Bsz, jnp.float32), jcfg)
    tout, tc = tmamba.mamba_prefill(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        tmamba.mamba_init_cache(tcfg, Bsz, torch.float32, "cpu"), tcfg)
    heads = tcfg.ssm.n_heads(tcfg.d_model)
    assert seen == [(heads, n_groups, n_groups)]
    np.testing.assert_allclose(tout.numpy(), _np(jout), rtol=SSD_TOL,
                               atol=SSD_TOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(tc[k].numpy(), _np(jc[k]), rtol=SSD_TOL,
                                   atol=SSD_TOL)


# ----------------------------------------- launch geometry (no card)
def test_ssd_mma_geometry():
    """The tensor-core kernel's launch at the Mamba2-370m prefill (b = 8,
    L = 2048, 32 heads in one group, p = 64, n = 128, q = 256): 4 query
    tiles and 2 state blocks per (batch, chunk, 8 heads), 1,536 blocks of
    128 threads, 106 KB of shared memory (acum 8 KB, G 64 KB, staging
    34 KB: two blocks per SM); per-head B / C (g = h) walk one head per
    block; the reduced tile (q = p = n = 16) one query and one state
    block."""
    from repro_torch.kernels.ssd_chunk.kernel import (SMEM_LIMIT,
                                                      heads_per_block,
                                                      mma_geometry)

    grid, threads, smem, hb = mma_geometry(8, 2048, 32, 1, 256, 64, 128)
    assert (grid, threads, hb) == ((6, 4, 64), 128, 8)
    assert smem == 8192 + 65536 + 34816 and 2 * (smem + 1024) <= 233472
    assert mma_geometry(8, 2048, 32, 32, 256, 64, 128)[0] == (6, 32, 64)
    assert mma_geometry(2, 64, 8, 1, 16, 16, 16)[:2] == ((2, 1, 8), 128)
    assert [heads_per_block(h, g) for h, g in
            ((32, 1), (24, 2), (6, 1), (8, 8), (12, 4))] == [8, 4, 2, 1, 1]
    for p in (16, 32, 64, 128):
        for n in (16, 32, 64, 128):
            assert mma_geometry(1, 256, 8, 1, 256, p, n)[2] <= SMEM_LIMIT
