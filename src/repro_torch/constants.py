# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Numerical constants of the gain paths (port of ``repro/constants.py``).

``GAIN_EPS`` clamps the whitened residual ``(1 + a) - |c|^2`` before the
log in every marginal-gain path (``LogDet.append``, the oracle's plain
version and both CUDA kernels, see ``csrc/gain_rows.cuh``).  ``NORM_EPS``
guards the row norms of the ``linear_norm`` kernel.  One value each,
shared by every implementation, keeps accept decisions aligned.
"""

GAIN_EPS = 1e-12
NORM_EPS = 1e-12
