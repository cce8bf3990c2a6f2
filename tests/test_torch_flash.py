# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of the flash-attention kernel's Python side: ``attention_ref`` and
``ops.flash_attention`` (its plain route on the CPU, with the padding
the CUDA kernel gets) against the JAX package's ``attention_ref`` and
its Pallas kernel in interpret mode, on the same numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.flash_attention import attention_ref as j_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402

ATTN_SHAPES = [  # B, Hq, Hkv, Sq, Sk, dh: tests/test_kernels.py's shapes
    (1, 2, 2, 128, 128, 64),
    (2, 4, 2, 256, 256, 64),  # GQA 2:1
    (1, 8, 1, 128, 384, 128),  # MQA, rectangular
    (2, 2, 2, 100, 100, 64),  # ragged (padding path)
    (1, 4, 4, 64, 64, 32),  # small blocks
    (1, 4, 4, 128, 128, 96),  # phi3-mini-3.8b's head width
]
ATTN_CASES = [(*s, c) for s in ATTN_SHAPES for c in (True, False)
              if not (c and s[3] != s[4])]  # causal needs Sq == Sk
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _qkv(B, Hq, Hkv, Sq, Sk, dh, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Hq, Sq, dh).astype(np.float32) * 0.5
    k = rng.randn(B, Hkv, Sk, dh).astype(np.float32) * 0.5
    v = rng.randn(B, Hkv, Sk, dh).astype(np.float32)
    return q, k, v


def _t(*xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,dh,causal", ATTN_CASES)
def test_flash_plain_route_matches_jax(B, Hq, Hkv, Sq, Sk, dh, causal):
    """The port's padded plain route against JAX's ``attention_ref`` and
    the Pallas kernel in interpret mode (blocks of 64, as the JAX tests
    run it), float32."""
    q, k, v = _qkv(B, Hq, Hkv, Sq, Sk, dh, Sq + dh)
    got = flash_attention(*_t(q, k, v), causal=causal, block_q=64,
                          block_k=64).numpy()
    want = np.asarray(j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    kern = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal, interpret=True,
                              block_q=64, block_k=64))
    np.testing.assert_allclose(got, kern, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_dtypes_match_jax(dtype, causal):
    """bf16 and f32 inputs keep their dtype; within the JAX tests' bf16
    and f32 tolerances of JAX's ``attention_ref`` on the same values."""
    q, k, v = _qkv(1, 2, 2, 128, 128, 64, 3)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    tq, tk, tv = _t(q, k, v, dtype=getattr(torch, dtype))
    got = flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(j_ref(jq, jk, jv, causal=causal), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_flash_causality():
    """Perturbing future tokens must not change past outputs."""
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 128, 64).astype(np.float32))
               for _ in range(3))
    o1 = flash_attention(q, k, v, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 100:] = 123.0
    v2[:, :, 100:] = -7.0
    o2 = flash_attention(q, k2, v2, causal=True)
    np.testing.assert_allclose(o1[:, :, :100].numpy(),
                               o2[:, :, :100].numpy(), atol=1e-5)


@pytest.mark.parametrize("kv_len,scale", [(77, None), (90, 0.3), (1, None)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_kv_len_and_scale_match_jax(kv_len, scale, causal):
    q, k, v = _qkv(2, 4, 2, 90, 90, 32, kv_len)
    got = attention_ref(*_t(q, k, v), causal=causal, scale=scale,
                        kv_len=kv_len).numpy()
    want = np.asarray(j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, scale=scale, kv_len=kv_len))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S", [1500, 100, 7])
def test_flash_padding_is_invisible(S):
    """Padding to the block multiple (1500 -> 1536, the Whisper encoder;
    7 -> 8) and masking with kv_len = S gives the unpadded answer."""
    q, k, v = _t(*_qkv(1, 2, 2, S, S, 32, S))
    got = flash_attention(q, k, v, causal=False)
    assert got.shape == q.shape
    torch.testing.assert_close(got, attention_ref(q, k, v, causal=False),
                               rtol=1e-5, atol=1e-5)


def test_flash_torch_backend_is_the_cpu_route():
    """``auto`` on a CPU tensor is the plain version, as ``torch`` is
    (``backend="cuda"`` refusing CPU tensors: tests/test_torch_cuda.py)."""
    q, k, v = _t(*_qkv(1, 4, 2, 40, 40, 32, 9))
    for causal in (True, False):
        torch.testing.assert_close(
            flash_attention(q, k, v, causal=causal, backend="torch"),
            flash_attention(q, k, v, causal=causal), rtol=0, atol=0)


# ----------------------------------------------- launch geometry (no card)
@pytest.mark.parametrize("dtype,route,grid", [
    (torch.bfloat16, "tensor-core", (12, 12, 8)),
    (torch.float32, "cuda-core", (24, 12, 8)),
])
def test_flash_launch_geometry_routes_by_dtype(dtype, route, grid):
    """The Whisper encoder's padded shape (B = 8, 12 heads, S = 1536):
    bf16 takes the wgmma kernel in query tiles of 128, float32 the
    CUDA-core kernel in tiles of 64; each route names itself in
    ``ROUTES``."""
    from repro_torch.kernels.flash_attention import ROUTES, launch_geometry

    got_route, got_grid, threads, _ = launch_geometry(dtype, 8, 12, 1536, 64)
    assert (got_route, got_grid) == (route, grid)
    assert threads == (384 if route == "tensor-core" else 256)
    assert ROUTES[dtype].startswith(route)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [32, 64, 96, 128])
def test_flash_smem_fits_each_head_width(dtype, dh):
    """Q, the two-stage K / V ring and the barriers (bf16), or the float
    tiles (float32), fit the 227 KB of one block at every head width."""
    from repro_torch.kernels.flash_attention import launch_geometry
    from repro_torch.kernels.flash_attention.kernel import SMEM_LIMIT

    smem = launch_geometry(dtype, 1, 12, 2048, dh)[3]
    assert smem <= SMEM_LIMIT
    if dtype == torch.bfloat16:  # 2 (Q) + 4 (K, V x 2 stages) bf16 tiles
        assert smem == 2 * 128 * dh + 2 * 2 * 2 * 128 * dh + 40 + 1024


def test_flash_head_width_96_geometry():
    """phi3-mini-3.8b's head width (96, 32 query and 32 kv heads, S =
    2048): both routes take it.  bf16 holds three 32-column blocks per
    tile with the 64-byte swizzle: Q (24 KB), the K / V ring (96 KB), the
    barriers and the alignment slack; float32 runs it on the 128-wide
    instance, its last 32 columns zeros: Q once (64 rows of 128 + 4), a
    three-stage ring of 64 x 132 K / V chunks, the two partial S tiles and
    the rows' statistics (about 169 KB)."""
    from repro_torch.kernels.flash_attention import launch_geometry
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS

    assert 96 in HEAD_DIMS
    route, grid, threads, smem = launch_geometry(torch.bfloat16, 1, 32,
                                                 2048, 96)
    assert (route, grid, threads) == ("tensor-core", (16, 32, 1), 384)
    assert smem == 24576 + 98304 + 40 + 1024 == 123944
    route, grid, threads, smem = launch_geometry(torch.float32, 1, 32,
                                                 2048, 96)
    assert (route, grid, threads) == ("cuda-core", (32, 32, 1), 256)
    assert smem == 4 * (64 * 132 + 3 * 64 * 132 + 2 * 64 * 72 + 2 * 64) \
        == 172544


def test_flash_launch_geometry_refusals_are_unchanged():
    """float16 has no kernel; every head width from 1 up runs (48 on the
    64-wide instance; 257 as two column blocks of O on the 160-wide one),
    and every batch and head count: the tiles lie on ``flat_grid``'s
    launch grid, so 32,768 x 2 column blocks and 65,536 heads, which the
    grid's 65,535 refused before, run.  What is left to refuse is a width
    below 1 and, in bf16, more (batch, head) rows than a TMA coordinate
    addresses, each message naming the limit."""
    from repro_torch.kernels.build import flat_grid
    from repro_torch.kernels.flash_attention import launch_geometry

    with pytest.raises(TypeError, match="dtype"):
        launch_geometry(torch.float16, 1, 2, 64, 64)
    with pytest.raises(ValueError, match="head width 0 .* 1 and up"):
        launch_geometry(torch.float32, 1, 2, 64, 0)
    with pytest.raises(ValueError,
                       match="1073741824 x 2 .* 2147483647 a TMA"):
        launch_geometry(torch.bfloat16, 2 ** 30, 2, 64, 64)
    tiles = launch_geometry(torch.bfloat16, 32768, 2, 64, 257)[1]
    assert tiles == (1, 2, 65536) and flat_grid(tiles) == (131072, 1, 1)
    tiles = launch_geometry(torch.float32, 1, 65536, 64, 64)[1]
    assert tiles == (1, 65536, 1) and flat_grid(tiles) == (65536, 1, 1)
    assert launch_geometry(torch.float32, 2 ** 30, 2, 64, 64)[1][2] == 2 ** 30
    assert launch_geometry(torch.bfloat16, 1, 2, 64, 48)[0] == "tensor-core"
    assert launch_geometry(torch.bfloat16, 1, 2, 64, 257)[1] == (1, 2, 2)
    assert launch_geometry(torch.bfloat16, 32767, 2, 64, 257)[1][2] == 65534


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_every_head_width_fits_shared_memory(dtype):
    """Every head width from 1 to 256 has a geometry within the 227 KB of
    one block: the narrowest instance at least as wide; past 128 the
    tensor-core kernel walks 64-key tiles (Q 64 KB + a 128 KB ring at
    256), the CUDA-core kernel (its instances 16 .. 1,024, powers of two)
    171,776 bytes at 256 (32 query rows)."""
    from repro_torch.kernels.flash_attention.kernel import (
        CC_HEAD_DIMS, HEAD_DIMS, SMEM_LIMIT, cc_column_blocks,
        instance_width, launch_geometry)

    for dh in range(1, 257):
        DH = instance_width(dh)
        assert DH >= dh and DH in HEAD_DIMS
        assert all(w < dh for w in HEAD_DIMS if w < DH)
        assert launch_geometry(dtype, 2, 4, 300, dh)[3] <= SMEM_LIMIT
        cc = cc_column_blocks(dh)
        assert cc[0] == 1 and cc[1] >= dh and cc[1] in CC_HEAD_DIMS
        assert all(w < dh for w in CC_HEAD_DIMS if w < cc[1])
    big = launch_geometry(dtype, 1, 1, 128, 256)[3]
    assert big == (2 * 128 * 256 + 2 * 2 * 2 * 64 * 256 + 40 + 1024
                   if dtype == torch.bfloat16 else
                   4 * (32 * 260 + 3 * 64 * 132 + 4 * 32 * 72 + 2 * 32))


@pytest.mark.parametrize("dh", [8, 48, 80, 160, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_route_matches_jax_at_any_head_width(dh, causal):
    """Head widths that are no instance of the kernel (8, 48, 80) and past
    128 (160, 256): the port's padded plain route, the route those
    widths take on a CPU tensor, against JAX's ``attention_ref`` and its
    Pallas kernel in interpret mode, float32, GQA 4 / 2, ragged S = 100."""
    q, k, v = _qkv(1, 4, 2, 100, 100, dh, dh + causal)
    got = flash_attention(*_t(q, k, v), causal=causal, block_q=64,
                          block_k=64).numpy()
    want = np.asarray(j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    kern = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal, interpret=True,
                              block_q=64, block_k=64))
    np.testing.assert_allclose(got, kern, rtol=2e-4, atol=2e-4)
