# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""The (offline) Greedy algorithm of Nemhauser et al. (1978) (port of
``repro/core/greedy.py``).

Not a streaming algorithm: it is the paper's quality yardstick, every
comparison reports f(S_algo) / f(S_greedy).  K rounds over the whole
ground set, each one oracle pass (the ``gain_static`` kernel on the card),
an argmax and an append, all on the device: no round copies anything to
the host.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from .functions import LogDet


@dataclasses.dataclass(frozen=True)
class Greedy:
    f: LogDet

    def select(self, X: torch.Tensor, *,
               margins: Optional[List[float]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """K greedy rounds over the ground set X (N, d) -> (feats, n, fval).

        ``margins``, when given a list, receives per round the relative gap
        ``(g1 - g2) / max(1, |g1|)`` between the two largest gains of the
        unused items (a host sync per round): the near-tie test of
        comparisons with other implementations.
        """
        f = self.f
        N = X.shape[0]
        ld = f.init()
        used = torch.zeros((N,), dtype=torch.bool, device=X.device)
        for _ in range(f.K):
            gains = torch.where(used, -torch.inf, f.gains(ld, X))
            i = torch.argmax(gains).reshape(1)
            if margins is not None and N > 1:
                top = torch.topk(gains, 2).values.tolist()
                margins.append((top[0] - top[1]) / max(1.0, abs(top[0])))
            ld = f.append(ld, X.index_select(0, i)[0])
            used = used.index_fill(0, i, True)
        return ld.feats, ld.n, ld.fval
