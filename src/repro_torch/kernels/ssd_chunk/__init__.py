# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of ``repro.kernels.ssd_chunk``: the Mamba2 SSD intra-chunk dual
form, a CUDA kernel beside its plain version."""
from .kernel import KERNEL, ROUTE_LAUNCHES, ROUTES, ssd_chunk_cuda
from .ops import BACKENDS, ssd_chunks
from .ref import chunk_cumsum, ssd_chunk_ref

__all__ = ["BACKENDS", "KERNEL", "ROUTES", "ROUTE_LAUNCHES", "chunk_cumsum",
           "ssd_chunk_cuda", "ssd_chunk_ref", "ssd_chunks"]
