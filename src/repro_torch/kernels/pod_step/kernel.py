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
from repro_torch.kernels.rbf_gain.kernel import SMEM_LIMIT, tile_floats

# scalar-table layout, one row per session (the enums of csrc/pod_step.cu)
INT_COLS = ("n", "j", "t", "n_fused", "n_queries", "nv", "k_cap", "T",
            "ihi", "num_rungs", "kind_id")
FLT_COLS = ("fval", "base", "inv2l2")
INT_OUT = 5  # n, j, t, n_fused, n_queries

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

KERNEL = CudaKernel("pod_step", "pod_step.cu", {
    # chunks, feats, L, linv, ints, flts, ints_out, fval_out,
    # S, C, K, d, a, stream
    "pod_step_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                        _P),
})

# the kernel's own static shared memory (s_first, s_red) and alignment
_STATIC_SMEM = 64
BT = 64  # candidate rows per gain tile (csrc/pod_step.cu)


def smem_bytes(K: int, d: int) -> int:
    """Dynamic shared memory of one session's block: feats, Linv, row
    norms, gains and the gain-tile scratch."""
    return 4 * (K * d + K * K + K + BT + tile_floats(BT, K))


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

    chunks (S, C, d), feats (S, K, d), L / Linv (S, K, K) f32; ints
    (S, len(INT_COLS)) int32 and flts (S, len(FLT_COLS)) f32 scalar
    tables.  ``feats``, ``L`` and ``Linv`` are updated IN PLACE (the
    port's stand-in for JAX's buffer donation).  Returns
    (ints_out (S, 5) int32: n, j, t, n_fused, n_queries; fval (S,) f32).
    Raises on a shape whose per-session working set does not fit one
    block's shared memory.
    """
    if not chunks.is_cuda:
        raise ValueError("pod_step_cuda launches on CUDA tensors only")
    dev = chunks.device
    S, C, d = chunks.shape
    K = feats.shape[1]
    _check("chunks", chunks, torch.float32, (S, C, d), dev)
    _check("feats", feats, torch.float32, (S, K, d), dev)
    _check("L", L, torch.float32, (S, K, K), dev)
    _check("Linv", Linv, torch.float32, (S, K, K), dev)
    _check("ints", ints, torch.int32, (S, len(INT_COLS)), dev)
    _check("flts", flts, torch.float32, (S, len(FLT_COLS)), dev)
    smem = smem_bytes(K, d)
    if smem + _STATIC_SMEM > SMEM_LIMIT:
        raise ValueError(
            f"pod_step: K={K}, d={d} needs {smem} bytes of shared memory "
            f"per session (feats {4 * K * d} + Linv {4 * K * K} + scratch), "
            f"over the {SMEM_LIMIT} a block may have; streaming feats/Linv "
            "tiles from L2 is not implemented yet (ROADMAP.md)")
    lib = KERNEL.get()
    ints_out = torch.empty((S, INT_OUT), dtype=torch.int32, device=dev)
    fval = torch.empty((S,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pod_step_launch(
            chunks.data_ptr(), feats.data_ptr(), L.data_ptr(),
            Linv.data_ptr(), ints.data_ptr(), flts.data_ptr(),
            ints_out.data_ptr(), fval.data_ptr(), S, C, K, d, float(a),
            stream)
    check(KERNEL, err, "pod_step")
    KERNEL.launches += 1
    return ints_out, fval
