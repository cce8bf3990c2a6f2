# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Distributed streaming summarization: per-shard local sieves + a merge
(port of ``repro/data/distributed.py``).

The stream is data-parallel: each of P shards sees 1/P of the items and
runs its own sieve-family algorithm; a merge pools the P local summaries
(P*K candidates, tiny — K vectors each) and re-selects the global K with
a greedy threshold-free pass.  Submodularity makes this sound: greedy
re-selection over the union of per-shard summaries is the standard
two-round protocol for distributed submodular maximization (Mirzasoleiman
et al., RandGreeDi lineage), and the merged value is at least every
local summary's.

Any algorithm with the uniform protocol (``init/run_batched/summary``,
objective bound as ``algo.f``) plugs in.  Communication cost: P*K*d
floats per merge — for P=32 shards, K=100, d=256 that is 3.2 MB.

``shards`` is either a device mesh or a number of shards.

  * A ``DeviceMesh``: one shard a rank along ``axis``, the JAX package's
    ``shard_map`` over the mesh's data axis (``tree.shard_map``).  The
    stacked states and the global batch X (P*B, d) are DTensors split on
    the leading axis (``tree.shard_tree`` of each rank's rows); ``merge``
    all-gathers each rank's (K, d) summary features and its ``n`` over
    ``axis`` and runs the rounds on every rank, so the merged summary is
    the same on all of them (plain tensors, not DTensors).
  * An int P: one process loops over the P shards; shard p runs
    ``run_batched`` on rows ``[p*B, (p+1)*B)`` of X (P*B, d), the rows
    ``shard_map`` would hand it.

The merge runs on the card with no host sync: K rounds of one
``f.gains`` over the pool (the ``gain_static`` kernel there), a masked
``argmax`` and a ``maybe_append``, all on device tensors, as the JAX
scan does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.functions import LogDetState
from repro_torch.core.sieve_family import stack_states
from repro_torch.launch.mesh import all_gather, axis_sizes
from repro_torch.tree import local_tree, shard_map, shard_tree, tree_map, vmap


@dataclasses.dataclass(frozen=True)
class MergedSummary:
    """Result of a global merge: one LogDet summary over the pooled pools."""

    ld: LogDetState


@dataclasses.dataclass(frozen=True)
class DistributedSummarizer:
    """P parallel sieve instances + merge: over the ranks of a mesh's
    ``axis``, or a loop over ``shards`` in one process.

    ``algo`` is any sieve-family algorithm from
    ``repro_torch.core.api.make`` (uniform ``init/run_batched/summary``
    protocol, objective bound as ``algo.f``).
    """

    algo: Any
    shards: Any  # a DeviceMesh, or the number of shards (an int)
    axis: str = "data"

    def __post_init__(self):
        if isinstance(self.shards, int) and self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")

    @property
    def on_mesh(self) -> bool:
        return not isinstance(self.shards, int)

    @property
    def n_shards(self) -> int:
        if self.on_mesh:
            return axis_sizes(self.shards)[self.axis]
        return self.shards

    # ----------------------------------------------------------------- local
    def init(self):
        """Stacked per-shard states (a leading (P,) shard axis; on a mesh
        one row a rank)."""
        if self.on_mesh:
            return shard_tree(stack_states(self.algo.init(), 1),
                              self.shards, self.axis)
        return stack_states(self.algo.init(), self.n_shards)

    def update(self, states, X: torch.Tensor):
        """X (P*B, d) global batch; shard p's local sieve consumes rows
        ``[p*B, (p+1)*B)`` -> the new stacked states."""
        if self.on_mesh:
            def local(st, x):
                st = tree_map(lambda l: l[0], st)
                out = self.algo.run_batched(st, x)
                return tree_map(lambda l: l[None], out)

            return shard_map(local, self.shards, self.axis)(states, X)
        P_ = self.n_shards
        if X.shape[0] % P_:
            raise ValueError(f"global batch of {X.shape[0]} rows does not "
                             f"split over {P_} shards")
        B = X.shape[0] // P_
        outs = [self.algo.run_batched(tree_map(lambda l: l[p], states),
                                      X[p * B:(p + 1) * B])
                for p in range(P_)]
        return tree_map(lambda *ls: torch.stack(ls), *outs)

    # ----------------------------------------------------------------- merge
    def _summaries(self, states):
        """(P, K, d) features and (P,) sizes of every shard's summary, in
        shard order; on a mesh, all-gathered over ``axis``."""
        if not self.on_mesh:
            feats, n, _ = vmap(self.algo.summary)(states)
            return feats, n
        feats, n, _ = vmap(self.algo.summary)(
            local_tree(states, self.shards, self.axis))
        return (all_gather(feats.contiguous(), self.shards, self.axis),
                all_gather(n.contiguous(), self.shards, self.axis))

    def merge(self, states, *, gaps: Optional[list] = None
              ) -> MergedSummary:
        """Gather all local summaries and re-sieve into one global summary.

        A *greedy threshold-free* pass over the pooled candidates: each
        round accepts the highest positive marginal gain — one ThreeSieves
        pass with T=inf over a finite pool.  The local summaries are read
        through the uniform ``summary`` protocol (mapped over the shard
        axis), so any sieve-family algorithm's states merge the same way.
        ``gaps``, when a list, receives per round the relative gap
        ``(g1 - g2) / max(1, |g1|)`` of the two largest eligible gains
        (one host sync a round): the near-tie test of comparisons with
        other implementations.
        """
        f = self.algo.f
        K = f.K
        feats_s, n_s = self._summaries(states)  # (P,K,d),(P,)
        feats_all = feats_s.reshape(-1, f.d)  # (P*K, d)
        dev = feats_all.device
        live = (torch.arange(K, device=dev)[None, :]
                < n_s[:, None]).reshape(-1)
        used = torch.zeros((feats_all.shape[0],), dtype=torch.bool,
                           device=dev)
        ld = f.init()
        neg = torch.tensor(-torch.inf, dtype=f.dtype, device=dev)
        for _ in range(K):
            gains = f.gains(ld, feats_all)  # one (K,K)x(K,PK) pass
            gains = torch.where(live & ~used, gains, neg)
            if gaps is not None:
                top = torch.topk(gains, min(2, gains.numel())).values
                g1, g2 = (top.tolist() + [-math.inf])[:2]
                gaps.append((g1 - g2) / max(1.0, abs(g1)))
            i = torch.argmax(gains)
            take = (gains[i] > 0) & (ld.n < K)
            ld = f.maybe_append(ld, feats_all[i], take)
            used = used.index_fill(0, i.reshape(1), True)
        return MergedSummary(ld=ld)

    def global_summary(self, states) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
        merged = self.merge(states)
        return merged.ld.feats, merged.ld.n, merged.ld.fval
