# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""ctypes binding of ``csrc/flash_attention.cu``.

Twin of the TPU kernel ``repro/kernels/flash_attention/kernel.py:
flash_attention_pallas``.  ``flash_attention_cuda`` launches on PyTorch's
current stream and counts its launches in ``KERNEL.launches``.  The input's
dtype picks the kernel (``ROUTES``): bfloat16 runs on the tensor cores
(wgmma, TMA), float32 on the CUDA cores.  ``ROUTE_LAUNCHES`` counts the
launches of each route.  The tiles lie on ``build.flat_grid``'s launch
grid, so no batch, head or query-tile count stops at 65,535.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import CudaKernel, check, flat_grid

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

KERNEL = CudaKernel("flash_attention", "flash_attention.cu", {
    # q, k, v, o, B, Hq, Hkv, Sq, Sk, dh, kv_len, causal, scale, dtype,
    # stream
    "flash_attention_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _F, _I, _P),
})
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
# the kernel each dtype takes (csrc/flash_attention.cu; past MAX_DH its
# ``_wide`` variant); neither stands in for the other
ROUTES = {torch.float32: "cuda-core (flash_attention_kernel, FP32 FMA)",
          torch.bfloat16: "tensor-core (flash_attention_wgmma_kernel, "
                          "wgmma + TMA)"}
ROUTE_LAUNCHES = {"cuda-core": 0, "tensor-core": 0}
# the template instances of the source: a head width up to MAX_DH runs on
# the narrowest instance at least as wide, its extra columns read as zeros;
# past MAX_DH, O's columns split into ceil(dh / MAX_DH) blocks along tile
# z, each on the instance of its share (``column_blocks``)
HEAD_DIMS = (16, 32, 64, 96, 128, 160, 192, 256)
MAX_DH = HEAD_DIMS[-1]
# the tensor-core kernel's TMA maps address (batch, head) rows by a
# 32-bit coordinate
MAX_ROWS = 2 ** 31 - 1
SMEM_LIMIT = 232448  # bytes of shared memory one block may have (H100)
# csrc/flash_attention.cu: the tensor-core kernel's query rows, keys per
# tile (64 past head width 128), ring stages and threads (namespace tc),
# the CUDA-core kernel's
TC_BQ, TC_BK, TC_STAGES, TC_THREADS = 128, 128, 2, 384
TC_BK_WIDE = 64
CC_BQ, CC_BK, CC_THREADS = 64, 64, 256
# past MAX_DH (both kernels): columns of a Q / K slice; the tensor-core
# kernel's slice and V ring stages
WIDE_SLICE, TC_WIDE_STAGES, TC_WIDE_V_STAGES = 64, 4, 2


def column_blocks(dh: int) -> tuple[int, int]:
    """-> (blocks of O's columns, the instance each runs on): one block
    up to ``MAX_DH``, past it ceil(dh / 256) blocks of the instance of
    ceil(dh / blocks) columns (dh 320: 2 x 160; 1024: 4 x 256)."""
    if dh < 1:
        raise ValueError(f"head width {dh} not supported: the kernel takes "
                         "1 and up")
    n = -(-dh // MAX_DH)
    return n, next(w for w in HEAD_DIMS if w >= -(-dh // n))


def instance_width(dh: int) -> int:
    """The template instance a head width runs on (past ``MAX_DH``: the
    instance of each column block); raises below 1."""
    return column_blocks(dh)[1]


def launch_geometry(dtype: torch.dtype, B: int, Hq: int, Sq: int,
                    dh: int):
    """-> (route, tiles, threads per block, dynamic shared-memory bytes)
    of one launch.  ``tiles`` is the tile grid (query tiles, heads, batch
    x column blocks), numbered x fastest (heaviest query tile first when
    causal); ``flat_grid(tiles)`` is the launch grid, grid x up to
    2**31 - 1 blocks.  Raises for a dtype the source has no kernel for, a
    head width below 1, and in bfloat16 for more than ``MAX_ROWS`` (batch,
    head) rows."""
    if dtype not in DTYPE_IDS:
        raise TypeError(f"dtype {dtype} not supported; choose from "
                        f"{list(DTYPE_IDS)}")
    ncb, DH = column_blocks(dh)
    if dtype == torch.bfloat16 and B * Hq > MAX_ROWS:
        raise ValueError(f"{B} x {Hq} (batch, head) rows exceed the "
                         f"{MAX_ROWS} a TMA coordinate addresses")
    if dtype == torch.bfloat16:
        tiles = (-(-Sq // TC_BQ), Hq, B * ncb)
        bars = 8 * (1 + 2 * TC_STAGES)
        if ncb > 1:  # Q / K slice ring, V ring of OW columns, barriers
            tile_bytes = (TC_WIDE_STAGES * 2 * (TC_BQ + TC_BK_WIDE)
                          * WIDE_SLICE
                          + TC_WIDE_V_STAGES * 2 * TC_BK_WIDE * DH)
            bars = 8 * 2 * (TC_WIDE_STAGES + TC_WIDE_V_STAGES)
        else:  # Q, the K / V ring
            bk = TC_BK if DH <= 128 else TC_BK_WIDE
            tile_bytes = 2 * TC_BQ * DH + 2 * TC_STAGES * 2 * bk * DH
        flat_grid(tiles)  # raises past what a launch grid holds
        # and slack for 1024-byte alignment
        return "tensor-core", tiles, TC_THREADS, tile_bytes + bars + 1024
    tiles = (-(-Sq // CC_BQ), Hq, B * ncb)
    if ncb > 1:  # Q and K slices, V's OW columns and P as float
        smem = 4 * (CC_BQ * (WIDE_SLICE + 1) + CC_BK * (WIDE_SLICE + 1)
                    + CC_BK * DH + CC_BQ * (CC_BK + 1))
    else:  # Q, K, V and P as float, the padded strides of the source
        smem = 4 * (CC_BQ * (DH + 1) + CC_BK * (DH + 1) + CC_BK * DH
                    + CC_BQ * (CC_BK + 1))
    flat_grid(tiles)
    return "cuda-core", tiles, CC_THREADS, smem


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         kv_len: int | None = None) -> torch.Tensor:
    """Launch the kernel: q (B, Hq, Sq, dh), k/v (B, Hkv, Sk, dh) on one
    card, one dtype (float32 or bfloat16), contiguous, Hq a multiple of
    Hkv, dh >= 1, 0 <= kv_len <= Sk -> (B, Hq, Sq, dh) in q's dtype,
    scores scaled by dh ** -0.5; past ``MAX_DH`` the launch splits O's
    columns over the grid (``column_blocks``).  Any batch and head count
    runs (``launch_geometry``; bfloat16 up to ``MAX_ROWS`` (batch, head)
    rows).  Raises on anything else.

    The tensor-core kernel reads rows through TMA, whose row stride must
    be a multiple of 16 bytes: a bfloat16 head width that is not a
    multiple of 8 is staged into zero-padded copies and the output cut
    back to dh columns."""
    if not q.is_cuda:
        raise ValueError("flash_attention_cuda launches on CUDA tensors only")
    dev = q.device
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, S, dh)")
    B, Hq, Sq, dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, q is "
                             f"{q.dtype} on {dev}")
        if tuple(t.shape) != (B, Hkv, Sk, dh):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(B, Hkv, Sk, dh)}")
    launch_geometry(q.dtype, B, Hq, Sq, dh)  # refuses dtype, width, rows
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv heads")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    kv_len = Sk if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= Sk:
        raise ValueError(f"kv_len {kv_len} outside [0, {Sk}]")
    scale = dh ** -0.5  # the real width's, whatever the kernel reads
    width = dh
    if q.dtype == torch.bfloat16:
        if dh % 8:
            width = dh + (-dh) % 8
            q, k, v = (F.pad(t, (0, width - dh)) for t in (q, k, v))
        # TMA reads from 16-byte aligned addresses; a view that starts
        # elsewhere is copied (fresh allocations are aligned)
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    lib = KERNEL.get()
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            Hkv, Sq, Sk, width, kv_len, int(causal), scale,
            DTYPE_IDS[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    check(KERNEL, err, "flash_attention")
    KERNEL.launches += 1
    ROUTE_LAUNCHES[ROUTES[q.dtype].split()[0]] += 1
    return out[..., :dh] if width != dh else out
