# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Public SSD intra-chunk entry (port of
``repro/kernels/ssd_chunk/ops.py``): the model's (b, L, ...) tensors in,
the intra-chunk Y and the chunk end-states out, through the CUDA kernel
or its plain version.

B and C come per group, (b, L, g, n) with h % g == 0; g = h is the
per-head signature of the JAX package.  The kernel reads them once per
group; the plain version repeats them over the heads of their group and
runs on the (b, h, c, q, x) tiles.

Backends:

    auto    the kernel for a CUDA tensor, the plain version
            (``ssd_chunk_ref``) for a CPU tensor;
    torch   the plain version on any device (the yardstick the kernel is
            held against on the card);
    cuda    the kernel; a CPU tensor raises.

There is no fallback between them: a kernel that cannot build or launch
raises.

The kernel route is differentiable: ``kernels.autograd.with_plain_grad``
runs the kernel forward and the plain version's gradient backward (the
JAX package trains through its plain ``ssd``); under
``torch.inference_mode`` it is the kernel alone.
"""
from __future__ import annotations

import torch

from ..autograd import with_plain_grad
from .kernel import ssd_chunk_cuda
from .ref import ssd_chunk_ref

BACKENDS = ("auto", "torch", "cuda")


def ssd_chunks(X: torch.Tensor, Adt: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, *, chunk: int, backend: str = "auto"):
    """Model-layout entry: X (b, L, h, p), Adt (b, L, h), B/C (b, L, g, n)
    with L % chunk == 0 and h % g == 0 -> (Y_diag (b, L, h, p) in X's
    dtype, states (b, c, h, p, n) float32), the shapes
    ``models.mamba.ssd`` uses for its intra-chunk term and end-states."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} invalid; choose from "
                         f"{BACKENDS}")
    if backend == "cuda" and not X.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors; X is on "
                         f"{X.device}")
    b, L, h, p = X.shape
    g = B.shape[2]
    if L % chunk:
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"chunk {chunk}")
    if g == 0 or h % g:
        raise ValueError(f"{h} heads do not group over {g} B/C groups")
    if backend == "cuda" or (backend == "auto" and X.is_cuda):
        return with_plain_grad(ssd_chunk_cuda, ssd_plain, X, Adt, B, C,
                               chunk=chunk)
    return ssd_plain(X, Adt, B, C, chunk=chunk)


def ssd_plain(X: torch.Tensor, Adt: torch.Tensor, B: torch.Tensor,
              C: torch.Tensor, *, chunk: int):
    """The plain route on the model layout (``ssd_chunks``' signature and
    results): B and C repeated over the heads of their group, the
    (b, h, c, q, x) tiles through ``ssd_chunk_ref``."""
    b, L, h, p = X.shape
    g = B.shape[2]
    if g != h:  # each head its group's B and C
        B = torch.repeat_interleave(B, h // g, dim=2)
        C = torch.repeat_interleave(C, h // g, dim=2)
    c = L // chunk

    def tiles(t):  # (b, L, h, x) -> (b, h, c, q, x)
        return t.reshape(b, c, chunk, h, -1).permute(0, 3, 1, 2, 4)

    Y, st = ssd_chunk_ref(tiles(X), Adt.reshape(b, c, chunk, h)
                          .permute(0, 3, 1, 2), tiles(B), tiles(C))
    # back to the model layout
    return (Y.permute(0, 2, 3, 1, 4).reshape(b, L, h, p),
            st.permute(0, 2, 1, 4, 3))
