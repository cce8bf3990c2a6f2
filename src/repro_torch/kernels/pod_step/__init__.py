# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of ``repro.kernels.pod_step``: one launch advances a whole pod."""
from .kernel import (FLT_COLS, INT_COLS, KERNEL, TIERS, Layout, layout,
                     pod_step_cuda, smem_bytes)
from .ops import BACKENDS, default_backend, fusable, pod_step, resolve
from .ref import pod_step_ref

__all__ = ["BACKENDS", "FLT_COLS", "INT_COLS", "KERNEL", "Layout", "TIERS",
           "default_backend", "fusable", "layout", "pod_step",
           "pod_step_cuda", "pod_step_ref", "resolve", "smem_bytes"]
