# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of ``repro.kernels.rbf_gain``: the fused gain pass (traced kind)."""
from .kernel import KERNEL, block_rows, gain_traced, smem_bytes
from .ops import fused_gains_traced
from .ref import gain_traced_ref

__all__ = ["KERNEL", "block_rows", "fused_gains_traced", "gain_traced",
           "gain_traced_ref", "smem_bytes"]
