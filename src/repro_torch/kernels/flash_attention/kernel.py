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
# the tensor-core kernel's template instances: a head width up to MAX_DH
# runs on the narrowest instance at least as wide, its extra columns read
# as zeros; past MAX_DH, O's columns split into ceil(dh / MAX_DH) blocks
# along tile z, each on the instance of its share (``column_blocks``)
HEAD_DIMS = (16, 32, 64, 96, 128, 160, 192, 256)
MAX_DH = HEAD_DIMS[-1]
# the tensor-core kernel's TMA maps address (batch, head) rows by a
# 32-bit coordinate
MAX_ROWS = 2 ** 31 - 1
SMEM_LIMIT = 232448  # bytes of shared memory one block may have (H100)
# csrc/flash_attention.cu: the tensor-core kernel's query rows, keys per
# tile (64 past head width 128), ring stages and threads (namespace tc)
TC_BQ, TC_BK, TC_STAGES, TC_THREADS = 128, 128, 2, 384
TC_BK_WIDE = 64
# past MAX_DH: columns of a Q / K slice; its slice and V ring stages
WIDE_SLICE, TC_WIDE_STAGES, TC_WIDE_V_STAGES = 64, 4, 2
# the CUDA-core kernel (namespace cc): its instances, the widest head one
# block holds whole (past it, O's columns in ``cc_column_blocks``), keys
# per tile, threads, ring stages, the partial-S row stride
CC_HEAD_DIMS = (16, 32, 64, 128, 256, 512, 1024)
CC_MAX_DH = CC_HEAD_DIMS[-1]
CC_BK, CC_THREADS, CC_STAGES, CC_LDR = 64, 256, 3, 72


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


def cc_column_blocks(dh: int) -> tuple[int, int]:
    """-> (blocks of O's columns, the instance each runs on) of the
    CUDA-core kernel: one block up to ``CC_MAX_DH``, past it ceil(dh /
    1024) blocks of the instance of ceil(dh / blocks) columns (dh 1100: 2
    x 1024, the columns past dh never stored)."""
    if dh < 1:
        raise ValueError(f"head width {dh} not supported: the kernel takes "
                         "1 and up")
    n = -(-dh // CC_MAX_DH)
    return n, next(w for w in CC_HEAD_DIMS if w >= -(-dh // n))


def cc_tiling(DH: int, whole: bool = True) -> dict:
    """The CUDA-core kernel's tiling of instance DH (``cc::Geo``): ``bq``
    query rows a block; S in ``split`` depth groups of 4 x 8 register
    tiles over K chunks of ``depth`` columns; V in chunks of ``vk`` keys;
    each thread ``rows`` x 4 floats of O (``col_threads`` threads across
    its columns); ``whole``: Q staged once (else its slices ride in the K
    chunks); ``floats`` of shared memory."""
    bq = 64 if DH <= 128 else 32 if DH <= 256 else 16
    split = 128 // bq
    ds = min(DH, 128)
    ldk = ds + 4
    kch = (CC_BK + (0 if whole else bq)) * ldk
    vk = next(v for v in (64, 32, 16, 8) if v * DH <= CC_BK * ldk or v == 8)
    rows = next(r for r in (16, 8, 4, 2, 1)
                if r <= bq and DH % (4 * (CC_THREADS * r // bq)) == 0)
    ntc = CC_THREADS // (bq // rows)
    floats = ((bq * (DH + 4) if whole else 0) + CC_STAGES * max(kch, vk * DH)
              + split * bq * CC_LDR + 2 * bq)
    assert 4 * ntc == DH  # one float4 of O's columns a thread
    return {"bq": bq, "split": split, "depth": ds, "vk": vk, "rows": rows,
            "col_threads": ntc, "whole": whole, "floats": floats}


def launch_geometry(dtype: torch.dtype, B: int, Hq: int, Sq: int,
                    dh: int):
    """-> (route, tiles, threads per block, dynamic shared-memory bytes)
    of one launch.  ``tiles`` is the tile grid (query tiles, heads, batch
    x column blocks), numbered x fastest (heaviest query tile first when
    causal); ``flat_grid(tiles)`` is the launch grid, grid x up to
    2**31 - 1 blocks.  bfloat16 splits O's columns past ``MAX_DH``
    (``column_blocks``), float32 past ``CC_MAX_DH`` (``cc_column_blocks``).
    Raises for a dtype the source has no kernel for, a head width below 1,
    and in bfloat16 for more than ``MAX_ROWS`` (batch, head) rows."""
    if dtype not in DTYPE_IDS:
        raise TypeError(f"dtype {dtype} not supported; choose from "
                        f"{list(DTYPE_IDS)}")
    if dtype == torch.float32:
        ncb, DH = cc_column_blocks(dh)
        t = cc_tiling(DH, whole=ncb == 1)
        tiles = (-(-Sq // t["bq"]), Hq, B * ncb)
        flat_grid(tiles)  # raises past what a launch grid holds
        return "cuda-core", tiles, CC_THREADS, 4 * t["floats"]
    ncb, DH = column_blocks(dh)
    if B * Hq > MAX_ROWS:
        raise ValueError(f"{B} x {Hq} (batch, head) rows exceed the "
                         f"{MAX_ROWS} a TMA coordinate addresses")
    tiles = (-(-Sq // TC_BQ), Hq, B * ncb)
    bars = 8 * (1 + 2 * TC_STAGES)
    if ncb > 1:  # Q / K slice ring, V ring of OW columns, barriers
        tile_bytes = (TC_WIDE_STAGES * 2 * (TC_BQ + TC_BK_WIDE) * WIDE_SLICE
                      + TC_WIDE_V_STAGES * 2 * TC_BK_WIDE * DH)
        bars = 8 * 2 * (TC_WIDE_STAGES + TC_WIDE_V_STAGES)
    else:  # Q, the K / V ring
        bk = TC_BK if DH <= 128 else TC_BK_WIDE
        tile_bytes = 2 * TC_BQ * DH + 2 * TC_STAGES * 2 * bk * DH
    flat_grid(tiles)  # raises past what a launch grid holds
    # and slack for 1024-byte alignment
    return "tensor-core", tiles, TC_THREADS, tile_bytes + bars + 1024


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         kv_len: int | None = None) -> torch.Tensor:
    """Launch the kernel: q (B, Hq, Sq, dh), k/v (B, Hkv, Sk, dh) on one
    card, one dtype (float32 or bfloat16), contiguous, Hq a multiple of
    Hkv, dh >= 1, 0 <= kv_len <= Sk -> (B, Hq, Sq, dh) in q's dtype,
    scores scaled by dh ** -0.5; past ``MAX_DH`` (bfloat16) or
    ``CC_MAX_DH`` (float32) the launch splits O's columns over the grid
    (``column_blocks``, ``cc_column_blocks``).  Any batch and head count
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
