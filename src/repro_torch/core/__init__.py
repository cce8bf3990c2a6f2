# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of ``repro.core``: objective, oracle, ThreeSieves, ``make``."""
