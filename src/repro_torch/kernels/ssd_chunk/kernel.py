# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""ctypes binding of ``csrc/ssd_chunk.cu``.

Twin of the TPU kernel ``repro/kernels/ssd_chunk/kernel.py:
ssd_chunk_pallas``.  ``ssd_chunk_cuda`` launches on PyTorch's current
stream, once per call (Y and the chunk end-states come from the same
launch), and counts its launches in ``KERNEL.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = CudaKernel("ssd_chunk", "ssd_chunk.cu", {
    # X, Adt, B, C, Y, states, BH, c, q, p, n, dtype, stream
    "ssd_chunk_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _P),
})
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
WIDTHS = (16, 32, 64, 128)  # head widths p and state widths n it takes
MAX_CHUNK = 256  # q: a multiple of 16 up to this
MAX_GRID = 65535  # b * h and c each index one grid axis


def ssd_chunk_cuda(X: torch.Tensor, Adt: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor):
    """Launch the kernel: X (b, h, c, q, p), Adt (b, h, c, q), B/C
    (b, h, c, q, n) on one card, one dtype (float32 or bfloat16),
    contiguous, q a multiple of 16 up to 256, p and n in ``WIDTHS`` ->
    (Y (b, h, c, q, p) in X's dtype, states (b, h, c, n, p) float32).
    Raises on anything else."""
    if not X.is_cuda:
        raise ValueError("ssd_chunk_cuda launches on CUDA tensors only")
    if X.dim() != 5 or Adt.dim() != 4 or B.dim() != 5 or C.dim() != 5:
        raise ValueError("X, B, C must be (b, h, c, q, x) and Adt "
                         "(b, h, c, q)")
    b, h, c, q, p = X.shape
    n = B.shape[-1]
    for name, t, shape in (("Adt", Adt, (b, h, c, q)),
                           ("B", B, (b, h, c, q, n)),
                           ("C", C, (b, h, c, q, n))):
        if t.device != X.device or t.dtype != X.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, X is "
                             f"{X.dtype} on {X.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if X.dtype not in DTYPE_IDS:
        raise TypeError(f"dtype {X.dtype} not supported; choose from "
                        f"{list(DTYPE_IDS)}")
    if p not in WIDTHS or n not in WIDTHS:
        raise ValueError(f"head width {p} / state width {n} not supported; "
                         f"choose from {WIDTHS}")
    if q % 16 or not 16 <= q <= MAX_CHUNK:
        raise ValueError(f"chunk {q} not supported: a multiple of 16 up to "
                         f"{MAX_CHUNK}")
    if b * h > MAX_GRID or c > MAX_GRID:
        raise ValueError(f"{b * h} batch-heads or {c} chunks exceed the "
                         f"grid's {MAX_GRID}")
    if not all(t.is_contiguous() for t in (X, Adt, B, C)):
        raise ValueError("X, Adt, B, C must be contiguous")
    Y = torch.empty_like(X)
    st = torch.empty((b, h, c, n, p), dtype=torch.float32, device=X.device)
    if X.numel() == 0:
        return Y, st
    lib = KERNEL.get()
    with torch.cuda.device(X.device):
        err = lib.ssd_chunk_launch(
            X.data_ptr(), Adt.data_ptr(), B.data_ptr(), C.data_ptr(),
            Y.data_ptr(), st.data_ptr(), b * h, c, q, p, n,
            DTYPE_IDS[X.dtype], torch.cuda.current_stream(X.device)
            .cuda_stream)
    check(KERNEL, err, "ssd_chunk")
    KERNEL.launches += 1
    return Y, st
