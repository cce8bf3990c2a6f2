# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Hand-written CUDA kernels of the port, each beside its plain version.

Sources live in ``repro_torch/csrc``; ``kernels.build`` compiles them
with ``nvcc`` for ``sm_90a`` at first use and binds them with ``ctypes``.
"""
