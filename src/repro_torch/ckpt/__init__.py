# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""repro_torch.ckpt — manifest checkpointing, plus the in-memory snapshot
store the pod-handoff path uses (port of ``repro/ckpt``)."""
from .store import CheckpointStore, MemoryStore

__all__ = ["CheckpointStore", "MemoryStore"]
