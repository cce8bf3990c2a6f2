# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Public flash-attention entry (port of
``repro/kernels/flash_attention/ops.py``): pad the sequence axes to block
multiples, mask the padding with ``kv_len``, and route to the CUDA kernel
or its plain version.

Backends:

    auto    the kernel for a CUDA tensor, the plain version
            (``attention_ref``) for a CPU tensor;
    torch   the plain version on any device (the yardstick the kernel is
            held against on the card);
    cuda    the kernel; a CPU tensor raises.

Both routes see the same padded inputs, so the CPU tests reach the
padding the kernel gets.  There is no fallback between them: a kernel
that cannot build or launch raises.

The kernel route is differentiable: ``kernels.autograd.with_plain_grad``
runs the kernel forward and ``attention_ref``'s gradient backward (the
JAX package trains through its plain attention); under
``torch.inference_mode`` it is the kernel alone.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..autograd import with_plain_grad
from .kernel import flash_attention_cuda
from .ref import attention_ref

BACKENDS = ("auto", "torch", "cuda")


def _pad_seq(x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(x, (0, 0, 0, pad)) if pad else x


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, backend: str = "auto",
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q (B, Hq, Sq, dh), k/v (B, Hkv, Sk, dh) -> (B, Hq, Sq, dh) in q's
    dtype.  Sq and Sk are padded to multiples of ``min(block, max(S, 8))``
    as the TPU kernel needs; ``kv_len = Sk`` masks the padded keys and the
    padded query rows are dropped."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} invalid; choose from "
                         f"{BACKENDS}")
    if backend == "cuda" and not q.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors; q is on "
                         f"{q.device}")
    kernel = backend == "cuda" or (backend == "auto" and q.is_cuda)
    Sq, Sk = q.shape[2], k.shape[2]
    bq = min(block_q, max(Sq, 8))
    bk = min(block_k, max(Sk, 8))
    qp = _pad_seq(q, (-Sq) % bq)
    kp = _pad_seq(k, (-Sk) % bk)
    vp = _pad_seq(v, (-Sk) % bk)
    args = (qp.contiguous(), kp.contiguous(), vp.contiguous())
    if kernel:
        out = with_plain_grad(flash_attention_cuda, attention_ref, *args,
                              causal=causal, kv_len=Sk)
    else:
        out = attention_ref(*args, causal=causal, kv_len=Sk)
    return out[:, :, :Sq]
