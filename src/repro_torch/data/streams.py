# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Synthetic data streams for the paper's experiments and the framework's
data pipeline (port of ``repro/data/streams.py``).

  * ``gaussian_mixture``   — i.i.d. items from a fixed mixture (batch regime),
  * ``drifting_mixture``   — mixture components move / appear over time
                             (stream51 regime: new classes enter the stream),
  * ``token_stream``       — synthetic LM token batches with embeddings,
  * ``session_stream``     — a *tagged* multi-tenant ingest queue
                             ``(session_id, x)`` (the SummarizerPod
                             serving regime).

The two mixtures draw on a ``torch.Generator`` on the caller's device
(the reference draws from ``jax.random``, whose streams no torch
generator reproduces), so they match the reference in distribution, not
value.  ``token_stream``, ``session_stream`` and
``deterministic_batch_fn`` draw from numpy's ``default_rng`` exactly as
the reference does, so they match it value for value; only the tensor
type of what they yield differs.  ``device=None`` means ``cuda``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MixtureSpec:
    n_components: int = 10
    d: int = 16
    spread: float = 4.0  # distance scale between component means
    noise: float = 0.5


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _means(gen, spec: MixtureSpec, device) -> torch.Tensor:
    return spec.spread * torch.randn(spec.n_components, spec.d,
                                     generator=gen, device=device)


def gaussian_mixture(seed: int, spec: MixtureSpec, chunk: int, *,
                     device=None) -> Iterator[torch.Tensor]:
    """Infinite i.i.d. stream in (chunk, d) float32 batches."""
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    means = _means(gen, spec, dev)
    while True:
        comp = torch.randint(0, spec.n_components, (chunk,), generator=gen,
                             device=dev)
        yield means[comp] + spec.noise * torch.randn(
            chunk, spec.d, generator=gen, device=dev)


def drifting_mixture(seed: int, spec: MixtureSpec, chunk: int, *,
                     drift_per_chunk: float = 0.05, introduce_every: int = 0,
                     device=None) -> Iterator[torch.Tensor]:
    """Concept drift: means random-walk each chunk; optionally only the
    first component is active initially and one more is introduced every
    ``introduce_every`` chunks (the stream51 'new classes appear' regime)."""
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    means = _means(gen, spec, dev)
    i = 0
    while True:
        n_active = (spec.n_components if not introduce_every else
                    min(1 + i // introduce_every, spec.n_components))
        comp = torch.randint(0, n_active, (chunk,), generator=gen,
                             device=dev)
        x = means[comp] + spec.noise * torch.randn(
            chunk, spec.d, generator=gen, device=dev)
        means = means + drift_per_chunk * torch.randn(
            means.shape, generator=gen, device=dev)
        i += 1
        yield x


@dataclasses.dataclass(frozen=True)
class TokenStreamSpec:
    vocab: int
    seq: int
    batch: int
    embed_d: int = 64  # embedding dim used for coreset selection


def token_stream(seed: int, spec: TokenStreamSpec, *, device=None
                 ) -> Iterator[Tuple[dict, torch.Tensor]]:
    """Synthetic LM batches + per-example embeddings.

    Yields ({'tokens': (B, S) int32, 'labels': (B, S) int32},
            embeds (B, embed_d) float32), the reference's values.

    Batches are drawn from a mixture of 'domains' (distinct unigram
    distributions); the embedding is the document's domain-posterior-like
    soft histogram.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_dom = 8
    # distinct peaked unigram distributions per domain
    logits = rng.normal(0, 2.0, (n_dom, spec.vocab)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    proj = rng.normal(0, 1.0, (spec.vocab, spec.embed_d)).astype(np.float32)

    while True:
        dom = rng.integers(0, n_dom, spec.batch)
        toks = np.stack([
            rng.choice(spec.vocab, size=spec.seq + 1, p=probs[d])
            for d in dom]).astype(np.int32)
        batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
                 "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)}
        hist = np.zeros((spec.batch, spec.vocab), np.float32)
        for b in range(spec.batch):
            np.add.at(hist[b], toks[b], 1.0)
        hist /= hist.sum(-1, keepdims=True)
        yield batch, torch.from_numpy(hist @ proj).to(dev)


def session_stream(seed: int, spec: MixtureSpec, n_sessions: int,
                   batch: int, *, drift_per_batch: float = 0.0,
                   session_ids: Optional[np.ndarray] = None,
                   as_numpy: bool = False, device=None
                   ) -> Iterator[Tuple]:
    """Tagged multi-tenant ingest queue for the SummarizerPod.

    Yields ``(sids (batch,) int32, X (batch, d) float32)``: sessions
    interleaved uniformly at random, each drawing from its *own* mixture,
    optionally drifting per batch.  ``session_ids`` overrides the default
    ids ``0..n_sessions-1``.  ``as_numpy`` keeps batches host-resident
    (the ingest pipeline routes on the host); otherwise they are tensors
    on ``device``.  Item values are the reference's either way.
    """
    dev = None if as_numpy else resolve_device(device)
    rng = np.random.default_rng(seed)
    ids = (np.arange(n_sessions, dtype=np.int32)
           if session_ids is None
           else np.asarray(session_ids, np.int32))
    if len(ids) != n_sessions:
        raise ValueError(
            f"session_ids has {len(ids)} entries for {n_sessions} sessions")
    # (n_sessions, n_components, d) — a private mixture per tenant
    means = spec.spread * rng.normal(
        0, 1.0, (n_sessions, spec.n_components, spec.d)).astype(np.float32)
    while True:
        sess = rng.integers(0, n_sessions, batch)
        comp = rng.integers(0, spec.n_components, batch)
        x = (means[sess, comp] + spec.noise * rng.normal(
            0, 1.0, (batch, spec.d)).astype(np.float32)).astype(np.float32)
        if as_numpy:
            yield ids[sess], x
        else:
            yield (torch.from_numpy(ids[sess]).to(dev),
                   torch.from_numpy(x).to(dev))
        if drift_per_batch:
            means = means + drift_per_batch * rng.normal(
                0, 1.0, means.shape).astype(np.float32)


def deterministic_batch_fn(seed: int, spec: TokenStreamSpec, *,
                           device=None):
    """next_batch(step) for the fault-tolerant loop: batch depends only on
    (seed, step) so a restart re-reads identical data."""
    dev = resolve_device(device)

    def next_batch(step: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
        toks = rng.integers(0, spec.vocab,
                            (spec.batch, spec.seq + 1)).astype(np.int32)
        return {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
                "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)}

    return next_batch
