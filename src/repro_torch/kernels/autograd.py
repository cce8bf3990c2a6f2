# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Gradients through a kernel route: the kernel's outputs forward, the
plain version's gradient backward.

The TPU kernels of the JAX package define no VJP, and the JAX package
trains on their plain (jnp) routes.  The CUDA kernels write their outputs
through ``data_ptr()`` into fresh tensors, which carry no ``grad_fn``: a
bare kernel call would silently drop the gradient through its outputs.
``with_plain_grad`` wraps such a call in ``PlainGrad``: the forward
launches the kernel unchanged and saves its inputs; the backward
recomputes the plain version on the saved inputs under
``torch.enable_grad()`` and returns ``torch.autograd.grad`` of it, which
is exactly the gradient of the reference's training math at those
inputs.  No backward kernel is written: the TPU kernels have none.

Where no input needs a gradient (serving under ``torch.inference_mode``
or ``torch.no_grad``, or inputs that require none), the kernel is called
directly: the wrapper costs that path nothing.

A recompute of the forward (``torch.utils.checkpoint``) runs the kernel
again, so a kernel's launch count includes the launches of a remat
recompute.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch


class PlainGrad(torch.autograd.Function):
    """``apply(forward, plain, kwargs, *inputs)`` -> ``forward(*inputs,
    **kwargs)`` (a tensor or a tuple of tensors); the backward is the
    gradient of ``plain(*inputs, **kwargs)``, recomputed from the saved
    inputs.  ``forward`` and ``plain`` must return outputs of the same
    shapes and dtypes."""

    @staticmethod
    def forward(ctx, forward: Callable, plain: Callable, kwargs: Dict,
                *inputs: torch.Tensor):
        ctx.plain, ctx.kwargs = plain, kwargs
        ctx.save_for_backward(*inputs)
        return forward(*inputs, **kwargs)

    @staticmethod
    def backward(ctx, *grads: torch.Tensor) -> Tuple:
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            outs = ctx.plain(*inputs, **ctx.kwargs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            wrt = [t for t in inputs if t.requires_grad]
            got = iter(torch.autograd.grad(outs, wrt, grads,
                                           allow_unused=True))
        return (None, None, None,
                *(next(got) if n else None for n in need))


def with_plain_grad(forward: Callable, plain: Callable,
                    *inputs: torch.Tensor, **kwargs):
    """``forward(*inputs, **kwargs)``, differentiable as ``plain`` is
    (``PlainGrad``) whenever grad mode is on and an input requires a
    gradient; otherwise ``forward`` alone."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return PlainGrad.apply(forward, plain, kwargs, *inputs)
    return forward(*inputs, **kwargs)
