# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""ctypes binding of ``csrc/flash_attention.cu``.

Twin of the TPU kernel ``repro/kernels/flash_attention/kernel.py:
flash_attention_pallas``.  ``flash_attention_cuda`` launches on PyTorch's
current stream and counts its launches in ``KERNEL.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

KERNEL = CudaKernel("flash_attention", "flash_attention.cu", {
    # q, k, v, o, B, Hq, Hkv, Sq, Sk, dh, kv_len, causal, scale, dtype,
    # stream
    "flash_attention_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _F, _I, _P),
})
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)  # the template instances of the source


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         kv_len: int | None = None) -> torch.Tensor:
    """Launch the kernel: q (B, Hq, Sq, dh), k/v (B, Hkv, Sk, dh) on one
    card, one dtype (float32 or bfloat16), contiguous, Hq a multiple of
    Hkv, dh in ``HEAD_DIMS``, 0 <= kv_len <= Sk -> (B, Hq, Sq, dh) in q's
    dtype, scores scaled by dh ** -0.5.  Raises on anything else."""
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
    if q.dtype not in DTYPE_IDS:
        raise TypeError(f"dtype {q.dtype} not supported; choose from "
                        f"{list(DTYPE_IDS)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head width {dh} not supported; choose from "
                         f"{HEAD_DIMS}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv heads")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    kv_len = Sk if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= Sk:
        raise ValueError(f"kv_len {kv_len} outside [0, {Sk}]")
    lib = KERNEL.get()
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            Hkv, Sq, Sk, dh, kv_len, int(causal), dh ** -0.5, DTYPE_IDS[q.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    check(KERNEL, err, "flash_attention")
    KERNEL.launches += 1
    return out
