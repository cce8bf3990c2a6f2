# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Admission control for the ingest edge: rate limits + the shed ladder
(port of ``repro/ingest/shedding.py``).

Two host-side policies that ``TaggedBuffer`` consults *before* an item
is enqueued, so overload becomes a measured, per-tenant regime instead
of an accident at the capacity wall:

  * :class:`RateLimit` / :class:`TokenBucket` — a classic per-session
    token bucket.  A tenant may burst to ``burst`` items and sustain
    ``rate`` items/sec; beyond that its items are *throttled* (counted,
    never enqueued).  This bounds what any single producer can ever ask
    of the buffer, independent of global load.

  * :class:`ShedPolicy` — the load-adaptive watermark ladder.  As
    buffer fill crosses watermarks the policy escalates, and every rung
    states the guarantee it preserves:

      rung 0, ``admit``      (fill < lo): admit everything — lossless.
      rung 1, ``subsample``  (lo <= fill < hi): tenants holding more
          than their fair share of the buffer are Bernoulli-thinned
          with a keep probability tied to the overload factor.  "Do
          Less, Get More" (Feldman, Karbasi, Kazemi, Krause; arXiv
          1802.07098) shows a uniformly subsampled stream preserves the
          submodular-maximization approximation guarantee in
          expectation at a fraction of the work — thinning the
          over-share tenants is that theorem applied per tenant, so a
          shed item costs expected summary quality, never correctness.
      rung 2, ``clip``       (fill >= hi): Stream Clipper-style
          two-threshold buffering (Zhou, Bilmes, Guestrin; arXiv
          1606.00389).  Per-tenant queue depth is judged against two
          thresholds: below the fair share items are still *buffered*
          in full (the defer band — quiet tenants stay lossless even at
          the top rung); between fair share and ``clip_mult`` x fair
          share items get a floor-probability second chance; above it
          they are clipped deterministically.  Memory stays bounded by
          the thresholds themselves, and drops concentrate on exactly
          the tenants that caused the overload — never a blind
          drop-oldest across victims.

  Under-share tenants never reach a random draw on any rung, so a quiet
  tenant's admitted sequence — and therefore its summary, bit for bit —
  is identical to the unloaded run (pinned by test).

Both policies are pure host code (numpy + the buffer's own lock); the
ledgers they grow (``sheds``/``throttled`` per session, per-policy
counts) are drained into ``shed_total{policy,pod}`` /
``ratelimit_throttled_total{pod}`` ONLY at existing host-sync
boundaries (``repro_torch.obs.drain.drain_buffer`` — DESIGN.md §13's one
rule, so PL004/PL006 stay clean).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

#: ladder rung names, in escalation order (index = severity)
RUNGS = ("admit", "subsample", "clip")


@dataclasses.dataclass(frozen=True)
class RateLimit:
    """Token-bucket parameters: sustain ``rate`` items/sec, burst to
    ``burst`` items (default: one second's worth)."""

    rate: float
    burst: Optional[float] = None

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(f"rate must be positive, got {self.rate}")
        if self.burst is None:
            object.__setattr__(self, "burst", max(1.0, self.rate))
        elif self.burst < 1.0:
            raise ValueError(f"burst must be >= 1, got {self.burst}")


class TokenBucket:
    """One session's bucket.  Not thread-safe on its own — the owning
    ``TaggedBuffer`` calls ``allow`` under its lock."""

    __slots__ = ("rate", "burst", "tokens", "t_last")

    def __init__(self, limit: RateLimit, now: float):
        self.rate = float(limit.rate)
        self.burst = float(limit.burst)
        self.tokens = self.burst  # a fresh session may burst immediately
        self.t_last = now

    def allow(self, now: float) -> bool:
        """Spend one token if available; refills at ``rate``/sec."""
        if now > self.t_last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.t_last) * self.rate)
            self.t_last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class ShedPolicy:
    """The watermark shedding ladder (see module docstring).

    ``lo``/``hi`` are buffer-fill fractions bounding the three rungs;
    ``p_floor`` is the minimum keep probability (reached at ``hi`` on
    the subsample rung, and the second-chance probability of the clip
    rung's middle band); ``clip_mult`` places the clip rung's upper
    threshold at ``clip_mult`` x the per-tenant fair share.  The fair
    share itself is ``lo * capacity / n_live`` — the low watermark
    split across the sessions currently holding backlog, so "over
    share" adapts to how many tenants are actually queueing.

    Deterministic in ``seed``; draws happen *only* for over-share
    items, so under-share admission never consumes randomness.
    """

    def __init__(self, lo: float = 0.5, hi: float = 0.85, *,
                 p_floor: float = 0.1, clip_mult: float = 2.0,
                 seed: int = 0):
        if not 0.0 < lo < hi <= 1.0:
            raise ValueError(
                f"watermarks must satisfy 0 < lo < hi <= 1, got "
                f"lo={lo}, hi={hi}")
        if not 0.0 < p_floor <= 1.0:
            raise ValueError(f"p_floor must be in (0, 1], got {p_floor}")
        if clip_mult < 1.0:
            raise ValueError(f"clip_mult must be >= 1, got {clip_mult}")
        self.lo = float(lo)
        self.hi = float(hi)
        self.p_floor = float(p_floor)
        self.clip_mult = float(clip_mult)
        self.seed = int(seed)
        self._rng = np.random.default_rng(seed)

    def rung(self, size: int, capacity: int) -> str:
        """Ladder rung for a buffer fill level (by name, ``RUNGS``)."""
        fill = size / capacity
        if fill < self.lo:
            return "admit"
        return "subsample" if fill < self.hi else "clip"

    def fair_share(self, capacity: int, n_live: int) -> float:
        """Per-tenant backlog budget: the low watermark split across
        the sessions currently holding backlog."""
        return self.lo * capacity / max(1, n_live)

    def decide(self, *, size: int, capacity: int, depth: int,
               n_live: int) -> Tuple[bool, str]:
        """Admission decision for one arriving item.

        ``size``/``capacity`` give the buffer fill, ``depth`` the
        arriving item's session backlog, ``n_live`` the number of
        sessions holding backlog.  Returns ``(admit, rung)``; a
        ``False`` is a shed attributed to that rung's policy.
        """
        fill = size / capacity
        if fill < self.lo:
            return True, "admit"
        share = self.fair_share(capacity, n_live)
        rung = "subsample" if fill < self.hi else "clip"
        if depth <= share:
            return True, rung  # under fair share: lossless on every rung
        if rung == "subsample":
            overload = (fill - self.lo) / (self.hi - self.lo)
            p = 1.0 - (1.0 - self.p_floor) * overload
            return bool(self._rng.random() < p), rung
        if depth <= self.clip_mult * share:  # the defer band's 2nd chance
            return bool(self._rng.random() < self.p_floor), rung
        return False, rung  # above the upper threshold: clipped
