"""Routing of a tagged batch into per-session chunks, written out plainly:
each slot takes the items tagged with its session, in stream order, up
to its chunk; the rest are counted as overflow, and items of no hosted
session as unknown."""
from __future__ import annotations

import torch


def route(sids: torch.Tensor, X: torch.Tensor, table: list, chunk: int):
    """sids (N,), X (N, d), ``table[s]`` the session id of slot s ->
    (chunks (S, C, d) zero padded, counts (S,), unknown, overflow (S,))."""
    S, d = len(table), X.shape[1]
    chunks = torch.zeros((S, chunk, d), dtype=X.dtype, device=X.device)
    counts = torch.zeros(S, dtype=torch.int64)
    overflow = torch.zeros(S, dtype=torch.int64)
    hosted = torch.zeros_like(sids, dtype=torch.bool)
    for s, sid in enumerate(table):
        mine = sids == sid
        hosted |= mine
        idx = torch.nonzero(mine).flatten()  # ascending: stream order
        take = idx[:chunk]
        chunks[s, :take.numel()] = X[take]
        counts[s] = take.numel()
        overflow[s] = idx.numel() - take.numel()
    unknown = int((~hosted & (sids >= 0)).sum())
    return chunks, counts, unknown, overflow


def errors(prog, ref, sid_table, table) -> int:
    """Entries in which the program's routing departs from the reference:
    chunk rows (each of S x C), counts, overflow and unknown, and slots
    whose session id differs from the admission table."""
    chunks, counts, unknown, overflow = prog
    rchunks, rcounts, runknown, roverflow = ref
    bad = int((chunks != rchunks).any(-1).sum())
    bad += int((counts.long().cpu() != rcounts).sum())
    bad += int((overflow.long().cpu() != roverflow).sum())
    bad += int(int(unknown) != runknown)
    bad += sum(int(a != b) for a, b in zip(sid_table, table))
    return bad


def least_bytes(N: int, d: int, S: int, C: int, esize: int = 4) -> int:
    """The least traffic of one routing: read the tags, the items and the
    slot table once; write the chunks, counts, overflow and the unknown
    count once."""
    return 4 * N + esize * N * d + 5 * S + esize * S * C * d + 8 * S + 4
