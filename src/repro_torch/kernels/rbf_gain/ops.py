# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Public gain-pass wrappers (port of ``repro/kernels/rbf_gain/ops.py``).

A CUDA tensor goes to the kernel (``gain_traced`` / ``gain_static``); a
CPU tensor to its plain version.  There is no fallback from one to the
other.  No padding: the CUDA kernels mask their own ragged edges.

The kernels are float32, as the TPU kernels are: the JAX wrappers upcast
x, feats and Linv to float32 before ``pallas_call``
(``repro/kernels/rbf_gain/ops.py``), and so do these (exact for a bf16
summary); the oracle casts the float32 gains to the objective's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernelmath import KernelParams

from .kernel import gain_static, gain_traced
from .ref import gain_ref, gain_traced_ref


def on_card(x: torch.Tensor) -> bool:
    """Whether a call with candidates ``x`` takes the kernel route."""
    return x.is_cuda


def kernel_operands(x: torch.Tensor, feats: torch.Tensor,
                    linv: torch.Tensor):
    """x, feats and Linv as the float32 contiguous operands the gain
    kernels take (a copy only where the dtype or layout differs)."""
    return tuple(t.to(torch.float32).contiguous() for t in (x, feats, linv))


def fused_gains_traced(x: torch.Tensor, feats: torch.Tensor,
                       linv: torch.Tensor, n: torch.Tensor,
                       kern: KernelParams, *, a: float) -> torch.Tensor:
    """Marginal gains of x (B, d) against a summary -> (B,) f32, or
    against stacked summaries (feats (I, K, d), n (I,)) -> (I, B); with
    groups, x (G, B, d) and ``kern`` leaves of G elements, run g of the
    I / G summaries priced against x[g] with kernel g -> (I, B)."""
    if not on_card(x):
        return gain_traced_ref(x, feats, linv, n, kern, a=a)
    return gain_traced(
        *kernel_operands(x, feats, linv),
        n.to(torch.int32).reshape(-1).contiguous(),
        kern.inv2l2.to(torch.float32).reshape(-1).contiguous(),
        kern.kind_id.to(torch.int32).reshape(-1).contiguous(), a=a)


def fused_gains(x: torch.Tensor, feats: torch.Tensor, linv: torch.Tensor,
                n: torch.Tensor, *, a: float, inv2l2: float,
                kind: str = "rbf") -> torch.Tensor:
    """Marginal gains of x (B, d) against a summary with a static kernel
    (``kind``, ``inv2l2``) -> (B,) f32."""
    if not on_card(x):
        K = feats.shape[0]
        mask = (torch.arange(K, device=feats.device) < n).to(torch.float32)
        return gain_ref(x.to(torch.float32), feats.to(torch.float32),
                        linv.to(torch.float32), mask[None, :], a=a,
                        inv2l2=inv2l2, kind=kind)[:, 0]
    return gain_static(
        *kernel_operands(x, feats, linv), n.to(torch.int32).reshape(1), a=a,
        inv2l2=inv2l2, kind=kind)

