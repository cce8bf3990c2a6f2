# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of ``repro.serve``: the multi-tenant ``SummarizerPod`` and batched
prefill/decode serving."""
from .engine import ServeDriver, make_decode_step, make_prefill_step

__all__ = ["ServeDriver", "make_decode_step", "make_prefill_step"]
