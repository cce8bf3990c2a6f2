# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Plain PyTorch version of the pod step: a loop over the session slots
of eager ``run_batched``, for any algorithm with the pod protocol
(``init / run_batched(state, X, n_valid) / summary / insertions``).

The JAX reference is ``vmap(run_batched)``; ``torch.func.vmap`` cannot
carry run_batched's data-dependent loop, so the port loops over slots.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.tree import tree_map


def pod_step_ref(algo, state, chunks: torch.Tensor, counts: torch.Tensor, *,
                 margins: Optional[List[Dict[int, float]]] = None):
    """Advance every session by one chunk -> a new stacked state.

    algo: the pod's algorithm; state: stacked (S, ...) state; chunks
    (S, C, d); counts (S,) valid prefix lengths.  ``margins`` (one dict
    per slot) collects each decided item's relative decision margin, as
    the sieve family's ``run_batched`` documents.
    """
    S = chunks.shape[0]
    counts = counts.tolist()
    outs = []
    for s in range(S):
        row = tree_map(lambda l, s=s: l[s], state)
        kw = {} if margins is None else {"margins": margins[s]}
        outs.append(algo.run_batched(row, chunks[s], counts[s], **kw))
    return tree_map(lambda *rows: torch.stack(rows), *outs)
