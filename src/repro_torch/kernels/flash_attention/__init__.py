# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of ``repro.kernels.flash_attention``: blocked online-softmax
attention, a CUDA kernel beside its plain version."""
from .kernel import (KERNEL, ROUTE_LAUNCHES, ROUTES, flash_attention_cuda,
                     launch_geometry)
from .ops import BACKENDS, flash_attention
from .ref import attention_ref

__all__ = ["BACKENDS", "KERNEL", "ROUTES", "ROUTE_LAUNCHES", "attention_ref",
           "flash_attention", "flash_attention_cuda", "launch_geometry"]
