# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""PyTorch/CUDA port of ``repro``: the streaming-summarization main path.

The layout mirrors ``src/repro`` module for module (``repro_torch.core.
threesieves`` is the port of ``repro.core.threesieves``).  The package
imports ``torch`` and never ``jax`` or ``repro``.  Entry points take
``device=None``, which means ``cuda``; without a card they raise unless
the caller asks for ``device="cpu"``.
"""
