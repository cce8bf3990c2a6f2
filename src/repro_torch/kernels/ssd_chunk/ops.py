# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Public SSD intra-chunk entry (port of
``repro/kernels/ssd_chunk/ops.py``): layout adaptation from the model's
(b, L, h, ...) tensors to the kernel's (b, h, c, q, ...) tiles and back,
and the route to the CUDA kernel or its plain version.

Backends:

    auto    the kernel for a CUDA tensor, the plain version
            (``ssd_chunk_ref``) for a CPU tensor;
    torch   the plain version on any device (the yardstick the kernel is
            held against on the card);
    cuda    the kernel; a CPU tensor raises.

There is no fallback between them: a kernel that cannot build or launch
raises.
"""
from __future__ import annotations

import torch

from .kernel import ssd_chunk_cuda
from .ref import ssd_chunk_ref

BACKENDS = ("auto", "torch", "cuda")


def ssd_chunks(X: torch.Tensor, Adt: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, *, chunk: int, backend: str = "auto"):
    """Model-layout entry: X (b, L, h, p), Adt (b, L, h), B/C (b, L, h, n)
    with L % chunk == 0 -> (Y_diag (b, L, h, p) in X's dtype, states
    (b, c, h, p, n) float32), the shapes ``models.mamba.ssd`` uses for its
    intra-chunk term and end-states."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} invalid; choose from "
                         f"{BACKENDS}")
    if backend == "cuda" and not X.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors; X is on "
                         f"{X.device}")
    b, L, h, p = X.shape
    if L % chunk:
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"chunk {chunk}")
    c = L // chunk

    def tiles(t):  # (b, L, h, x) -> (b, h, c, q, x)
        return t.reshape(b, c, chunk, h, -1).permute(0, 3, 1, 2, 4)

    Xc, Bc, Cc = tiles(X), tiles(B), tiles(C)
    Ac = Adt.reshape(b, c, chunk, h).permute(0, 3, 1, 2)
    if backend == "cuda" or (backend == "auto" and X.is_cuda):
        Y, st = ssd_chunk_cuda(Xc.contiguous(), Ac.contiguous(),
                               Bc.contiguous(), Cc.contiguous())
    else:
        Y, st = ssd_chunk_ref(Xc, Ac, Bc, Cc)
    # back to the model layout
    return (Y.permute(0, 2, 3, 1, 4).reshape(b, L, h, p),
            st.permute(0, 2, 1, 4, 3))
