# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""repro_torch.data — synthetic streams, the coreset selector and the
distributed summarizer (port of ``repro/data``)."""
from .coreset import CoresetSelector
from .distributed import DistributedSummarizer, MergedSummary
from .streams import (MixtureSpec, TokenStreamSpec, deterministic_batch_fn,
                      drifting_mixture, gaussian_mixture, session_stream,
                      token_stream)

__all__ = ["CoresetSelector", "DistributedSummarizer", "MergedSummary",
           "MixtureSpec", "TokenStreamSpec", "deterministic_batch_fn",
           "drifting_mixture", "gaussian_mixture", "session_stream",
           "token_stream"]
