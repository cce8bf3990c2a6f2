# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""repro_torch.data — synthetic streams (port of ``repro/data``; the
coreset selector and the distributed summarizer wait for later slices,
ROADMAP.md)."""
from .streams import (MixtureSpec, TokenStreamSpec, deterministic_batch_fn,
                      drifting_mixture, gaussian_mixture, session_stream,
                      token_stream)

__all__ = ["MixtureSpec", "TokenStreamSpec", "deterministic_batch_fn",
           "drifting_mixture", "gaussian_mixture", "session_stream",
           "token_stream"]
