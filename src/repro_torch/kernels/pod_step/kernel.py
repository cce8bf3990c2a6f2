# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""ctypes binding of ``csrc/pod_step.cu`` (the ``pod_step`` kernel).

Twin of the TPU kernel ``repro/kernels/pod_step/kernel.py:
pod_step_pallas``.  ``pod_step_cuda`` launches on PyTorch's current
stream and counts its launches in ``KERNEL.launches``.  ``layout`` picks
the kernel's layout tier and window on the host, from K and d, with the
shared-memory arithmetic of the source (``smem_bytes``).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels.build import CudaKernel, check
from repro_torch.kernels.rbf_gain.kernel import RB_KT, RB_LD, SMEM_LIMIT

# scalar-table layout, one row per session (the enums of csrc/pod_step.cu)
INT_COLS = ("n", "j", "t", "n_fused", "n_queries", "nv", "k_cap", "T",
            "ihi", "num_rungs", "kind_id")
FLT_COLS = ("fval", "base", "inv2l2")
INT_OUT = 5  # n, j, t, n_fused, n_queries

# launch geometry and layout tiers of csrc/pod_step.cu (POD_NT,
# WINDOW_ROWS, TIER_SHARED = 0 / TIER_GLOBAL = 1)
POD_NT = 128
WINDOW_ROWS = (32, 16, 8)
TIERS = ("shared", "global")
RB_DK = 32  # depth of one staged slice (csrc/gain_rows.cuh)
SM_SMEM = 233472  # bytes of shared memory on one SM of the H100 (228 KB)
BLOCK_RESERVED = 1024  # bytes the runtime keeps per resident block

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

KERNEL = CudaKernel("pod_step", "pod_step.cu", {
    # chunks, feats, L, linv, ints, flts, ints_out, fval_out,
    # S, C, K, d, a, bt, tier, dtype, stream
    "pod_step_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                        _I, _I, _I, _P),
    # tier, bt, K, d
    "pod_step_smem_bytes": (_I, _I, _I, _I),
})
# storage types of chunks / feats / L / Linv (csrc/pod_step.cu's dtype)
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def _ld16(x: int) -> int:
    """``ld16``: a multiple of 4 floats, an odd number of 16-byte units."""
    y = _up(x, 4)
    return y if (y // 4) % 2 else y + 4


def smem_bytes(K: int, d: int, bt: int, tier: str) -> int:
    """``pod_step_smem_bytes`` of csrc/pod_step.cu: one block's dynamic
    shared memory.  The shared tier holds the session's Linv (K rows);
    both hold the window's rows X (bt x d) and kernel rows Km (bt x K),
    rb_gemm's two staging buffers, the summary's row norms and the
    acceptor's whitened vector."""
    linv = K * _ld16(K) if tier == "shared" else _up(K, 4)
    floats = (linv + bt * _ld16(_up(d, RB_DK)) + bt * _ld16(_up(K, RB_KT))
              + 2 * RB_KT * RB_LD + 2 * _up(K, 4) + 2 * bt + 4)
    return 4 * floats


@dataclasses.dataclass(frozen=True)
class Layout:
    """The pod step's layout at K_max = K and width d."""

    tier: str  # "shared": Linv in shared memory; "global": in device memory
    bt: int  # window rows
    smem_bytes: int  # dynamic shared memory of one block
    blocks_per_sm: int  # resident blocks per SM that this memory allows


def layout(K: int, d: int, tier: str | None = None,
           window: int | None = None) -> Layout:
    """The pod step's layout: the shared tier with a 32-row window where
    one block's shared memory holds it (K = 100, d = 256: 109,680 bytes,
    two blocks per SM), else the global tier with the largest window of
    32 / 16 / 8 rows that fits.  ``tier`` and ``window`` force one
    (every layout gives the same bits, and tests hold them to that).
    Raises when nothing fits, naming the bytes.
    """
    if tier is not None and tier not in TIERS:
        raise ValueError(f"tier {tier!r} invalid; choose from {TIERS}")
    if window is not None and window not in WINDOW_ROWS:
        raise ValueError(f"window {window} invalid; choose from "
                         f"{WINDOW_ROWS}")
    tiers = TIERS if tier is None else (tier,)
    for name in tiers:
        rows = WINDOW_ROWS if name == "global" else WINDOW_ROWS[:1]
        for bt in rows if window is None else (window,):
            smem = smem_bytes(K, d, bt, name)
            if smem <= SMEM_LIMIT:
                return Layout(name, bt, smem,
                              SM_SMEM // (smem + BLOCK_RESERVED))
    bt = WINDOW_ROWS[-1] if window is None else window
    least = smem_bytes(K, d, bt, tiers[-1])
    raise ValueError(f"the pod step at K={K}, d={d} needs {least} bytes of "
                     f"shared memory even with a {bt}-row window in the "
                     f"{tiers[-1]} tier, over the {SMEM_LIMIT} a block may "
                     "have")


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def pod_step_cuda(chunks: torch.Tensor, feats: torch.Tensor, L: torch.Tensor,
                  Linv: torch.Tensor, ints: torch.Tensor, flts: torch.Tensor,
                  *, a: float, tier: str | None = None,
                  window: int | None = None):
    """Launch one pod step on CUDA tensors.

    chunks (S, C, d), feats (S, K, d), L / Linv (S, K, K), all float32
    or all bfloat16 (the objective's dtype: a bf16 carry stays bf16, with
    float32 arithmetic); ints (S, len(INT_COLS)) int32 and flts
    (S, len(FLT_COLS)) f32 scalar tables.  ``feats``, ``L`` and ``Linv``
    are updated IN PLACE (the port's stand-in for JAX's buffer donation).
    ``tier`` and ``window`` force a layout (``layout``).  Returns
    (ints_out (S, 5)
    int32: n, j, t, n_fused, n_queries; fval (S,) f32, rounded to the
    state's dtype).
    """
    if not chunks.is_cuda:
        raise ValueError("pod_step_cuda launches on CUDA tensors only")
    dev = chunks.device
    S, C, d = chunks.shape
    K = feats.shape[1]
    dt = feats.dtype
    if dt not in DTYPE_IDS:
        raise TypeError(f"state dtype {dt} not supported; choose from "
                        f"{list(DTYPE_IDS)}")
    _check("chunks", chunks, dt, (S, C, d), dev)
    _check("feats", feats, dt, (S, K, d), dev)
    _check("L", L, dt, (S, K, K), dev)
    _check("Linv", Linv, dt, (S, K, K), dev)
    _check("ints", ints, torch.int32, (S, len(INT_COLS)), dev)
    _check("flts", flts, torch.float32, (S, len(FLT_COLS)), dev)
    lay = layout(K, d, tier, window)
    lib = KERNEL.get()
    ints_out = torch.empty((S, INT_OUT), dtype=torch.int32, device=dev)
    fval = torch.empty((S,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pod_step_launch(
            chunks.data_ptr(), feats.data_ptr(), L.data_ptr(),
            Linv.data_ptr(), ints.data_ptr(), flts.data_ptr(),
            ints_out.data_ptr(), fval.data_ptr(), S, C, K, d, float(a),
            lay.bt, TIERS.index(lay.tier), DTYPE_IDS[dt], stream)
    check(KERNEL, err, "pod_step")
    KERNEL.launches += 1
    return ints_out, fval
