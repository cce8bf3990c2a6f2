# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of ``repro.kernels.rbf_gain``: the fused gain pass, traced and
static kernel forms."""
from .kernel import (KERNEL, KERNEL_STATIC, block_rows, gain_block_rows,
                     gain_grid, gain_static, gain_traced, rbf_gain,
                     smem_bytes, static_block_rows)
from .ops import fused_gains, fused_gains_traced
from .ref import gain_ref, gain_traced_ref, kernel_block, rbf_gain_ref

__all__ = ["KERNEL", "KERNEL_STATIC", "block_rows", "fused_gains",
           "gain_block_rows", "gain_grid",
           "fused_gains_traced", "gain_ref", "gain_static", "gain_traced",
           "gain_traced_ref", "kernel_block", "rbf_gain", "rbf_gain_ref",
           "smem_bytes", "static_block_rows"]
