# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Plain PyTorch version of the SSD intra-chunk kernel (port of
``repro/kernels/ssd_chunk/ref.py``): the oracle the CUDA kernel is held
against.

One chunk of the state-space-duality dual form (Dao & Gu 2024):

    acum  = cumsum(Adt)                                (q,)
    L     = tril(exp(acum_i - acum_j))                 (q, q)
    S     = (C @ B^T) * L                              (q, q)
    Y     = S @ X                                      (q, p)
    state = (B * exp(acum_q - acum))^T @ X             (n, p)

Inputs per (batch, head, chunk): X (q, p) dt-scaled inputs, Adt (q,) decay
logits, B/C (q, n) input/output projections; float32 arithmetic.
"""
from __future__ import annotations

import torch


def chunk_cumsum(Adt: torch.Tensor) -> torch.Tensor:
    """acum = cumsum(Adt) over the last axis, summed in float64 and
    rounded once to float32.

    This is what ``torch.cumsum`` of float32 computes on the CPU (it
    accumulates in double), and on every device it is the float32
    rounding of the exact sum of up to 256 float32 terms, whatever the
    summation order.  The CUDA kernel sums the same way, so both see the
    same acum: at |acum| ~ 200 one float32 ulp (1.5e-5) would otherwise
    carry into every near-diagonal decay exp(acum_i - acum_j).
    """
    return torch.cumsum(Adt.double(), -1).float()


def ssd_chunk_ref(X: torch.Tensor, Adt: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor):
    """X (..., q, p), Adt (..., q), B/C (..., q, n) -> (Y (..., q, p) in
    X's dtype, state (..., n, p) float32).

    Two explicit products, S = (C B^T) * L then Y = S X, so the live
    intermediates are (..., q, q), never (..., q, q, n).  Above the
    diagonal acum_i - acum_j may be large enough for exp to overflow to
    inf; it is set to -inf before the exponent, so L is 0 there and so
    is its gradient (masking after the exponent would give the same L,
    but a gradient of 0 x inf = NaN, which training at Mamba2-370m's
    decays reaches; this version is the kernel route's backward,
    ``kernels.autograd``).
    """
    Xf, Bf, Cf = X.float(), B.float(), C.float()
    acum = chunk_cumsum(Adt)
    q = X.shape[-2]
    tri = torch.ones(q, q, dtype=torch.bool, device=X.device).tril()
    L = torch.exp(torch.where(tri, acum[..., :, None] - acum[..., None, :],
                              torch.tensor(float("-inf"), device=X.device)))
    S = (Cf @ Bf.transpose(-1, -2)) * L
    Y = S @ Xf
    decay = torch.exp(acum[..., -1:] - acum)
    state = (Bf * decay[..., None]).transpose(-1, -2) @ Xf
    return Y.to(X.dtype), state
