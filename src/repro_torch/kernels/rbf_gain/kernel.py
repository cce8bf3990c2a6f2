# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""ctypes binding of ``csrc/rbf_gain.cu`` (the ``gain_traced`` kernel).

Twin of the TPU kernel ``repro/kernels/rbf_gain/kernel.py:
gain_pallas_traced``.  ``gain_traced`` launches on PyTorch's current
stream and counts its launches in ``KERNEL.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

KERNEL = CudaKernel("gain_traced", "rbf_gain.cu", {
    # x, feats, linv, n, inv2l2, kind, out, B, K, d, a, bt, stream
    "gain_traced_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                           _P),
})

SMEM_LIMIT = 232448  # bytes of shared memory one block may have (H100)
KM_BUDGET = 98304  # bytes of the BT x K kernel block Km in shared memory
KT, LDT = 64, 33  # must match csrc/gain_rows.cuh


def block_rows(K: int) -> int:
    """Candidate rows per block: the largest of 64/32/16/8 whose BT x K
    f32 kernel block fits ``KM_BUDGET``."""
    for bt in (64, 32, 16, 8):
        if bt * K * 4 <= KM_BUDGET:
            return bt
    raise ValueError(f"gain_traced: K={K} needs a {8 * K * 4}-byte kernel "
                     f"block even at 8 rows, over the {KM_BUDGET}-byte "
                     "budget")


def tile_floats(bt: int, K: int) -> int:
    """``gain_tile_floats`` of csrc/gain_rows.cuh."""
    return bt * LDT + KT * LDT + 2 * bt + bt * K


def smem_bytes(K: int) -> int:
    bt = block_rows(K)
    return 4 * (K + bt + tile_floats(bt, K))


def _check_f32(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_scalar(name, t, dtype, device):
    if t.device != device or t.dtype != dtype or t.numel() != 1:
        raise ValueError(f"{name} must be a one-element {dtype} tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def gain_traced(x: torch.Tensor, feats: torch.Tensor, linv: torch.Tensor,
                n: torch.Tensor, inv2l2: torch.Tensor, kind_id: torch.Tensor,
                *, a: float) -> torch.Tensor:
    """Launch ``gain_traced`` on CUDA tensors -> gains (B,) f32.

    x (B, d), feats (K, d), linv (K, K) f32 contiguous; n, kind_id int32
    and inv2l2 f32 one-element tensors, read by the kernel on the device
    (no host sync).  Raises on anything else.
    """
    if not x.is_cuda:
        raise ValueError("gain_traced launches on CUDA tensors only")
    dev = x.device
    B, d = x.shape
    K = feats.shape[0]
    _check_f32("x", x, (B, d), dev)
    _check_f32("feats", feats, (K, d), dev)
    _check_f32("linv", linv, (K, K), dev)
    _check_scalar("n", n, torch.int32, dev)
    _check_scalar("inv2l2", inv2l2, torch.float32, dev)
    _check_scalar("kind_id", kind_id, torch.int32, dev)
    smem = smem_bytes(K)
    if smem > SMEM_LIMIT:
        raise ValueError(f"gain_traced: K={K} needs {smem} bytes of shared "
                         f"memory, over the {SMEM_LIMIT} a block may have")
    lib = KERNEL.get()
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gain_traced_launch(
            x.data_ptr(), feats.data_ptr(), linv.data_ptr(), n.data_ptr(),
            inv2l2.data_ptr(), kind_id.data_ptr(), out.data_ptr(),
            B, K, d, float(a), block_rows(K), stream)
    check(KERNEL, err, "gain_traced")
    KERNEL.launches += 1
    return out
