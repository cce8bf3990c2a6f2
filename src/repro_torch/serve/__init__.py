# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of ``repro.serve``: batched prefill/decode serving, the
multi-tenant ``SummarizerPod``, and the pod autoscaler driving live
session migration across a fleet."""
from .autoscale import (VICTIM_POLICIES, HandoffReport, PodAutoscaler,
                        PodSignals, ScalePolicy)
from .engine import ServeDriver, make_decode_step, make_prefill_step
from .summarize import PodReadout, PodState, SummarizerPod

__all__ = ["ServeDriver", "make_decode_step", "make_prefill_step",
           "PodReadout", "PodState", "SummarizerPod", "PodAutoscaler",
           "ScalePolicy", "PodSignals", "HandoffReport", "VICTIM_POLICIES"]
