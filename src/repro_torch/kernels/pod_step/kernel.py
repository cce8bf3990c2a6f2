# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""ctypes binding of ``csrc/pod_step.cu`` (the ``pod_step`` kernel).

Twin of the TPU kernel ``repro/kernels/pod_step/kernel.py:
pod_step_pallas``.  ``pod_step_cuda`` launches on PyTorch's current
stream and counts its launches in ``KERNEL.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check
from repro_torch.kernels.rbf_gain.kernel import block_rows, tile_floats

# scalar-table layout, one row per session (the enums of csrc/pod_step.cu)
INT_COLS = ("n", "j", "t", "n_fused", "n_queries", "nv", "k_cap", "T",
            "ihi", "num_rungs", "kind_id")
FLT_COLS = ("fval", "base", "inv2l2")
INT_OUT = 5  # n, j, t, n_fused, n_queries

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

KERNEL = CudaKernel("pod_step", "pod_step.cu", {
    # chunks, feats, L, linv, ints, flts, ints_out, fval_out,
    # S, C, K, d, a, bt, dtype, stream
    "pod_step_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                        _I, _I, _P),
})
# storage types of chunks / feats / L / Linv (csrc/pod_step.cu's dtype)
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(K: int) -> int:
    """Dynamic shared memory of one session's block: the row norms, the
    gains and the gain-tile scratch (which also holds the append
    vectors).  feats and Linv stay in device memory, so the width d does
    not enter."""
    bt = block_rows(K)
    return 4 * (K + bt + tile_floats(bt, K))


def layout(K: int):
    """-> (BT, dynamic shared-memory bytes) of the pod step at K_max = K.

    BT, the candidate rows of one gain tile, falls with K so that the
    BT x K kernel block fits (``block_rows``, which raises past K = 3072
    and names the bytes).
    """
    return block_rows(K), smem_bytes(K)


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
                  *, a: float):
    """Launch one pod step on CUDA tensors.

    chunks (S, C, d), feats (S, K, d), L / Linv (S, K, K), all float32
    or all bfloat16 (the objective's dtype: a bf16 carry stays bf16, with
    float32 arithmetic); ints (S, len(INT_COLS)) int32 and flts
    (S, len(FLT_COLS)) f32 scalar tables.  ``feats``, ``L`` and ``Linv``
    are updated IN PLACE (the port's stand-in for JAX's buffer donation).
    Returns (ints_out (S, 5) int32: n, j, t, n_fused, n_queries; fval
    (S,) f32, rounded to the state's dtype).
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
    bt, _ = layout(K)
    lib = KERNEL.get()
    ints_out = torch.empty((S, INT_OUT), dtype=torch.int32, device=dev)
    fval = torch.empty((S,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pod_step_launch(
            chunks.data_ptr(), feats.data_ptr(), L.data_ptr(),
            Linv.data_ptr(), ints.data_ptr(), flts.data_ptr(),
            ints_out.data_ptr(), fval.data_ptr(), S, C, K, d, float(a),
            bt, DTYPE_IDS[dt], stream)
    check(KERNEL, err, "pod_step")
    KERNEL.launches += 1
    return ints_out, fval
