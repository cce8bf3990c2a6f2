"""The one traffic generator: tagged batches of every session's own
Gaussian mixture, made on the device from the seed.

A traffic file (``traffic/<name>.json``) gives, in units of the
configuration's ``data_scale`` (the item noise its lengthscales are set
for): ``components`` per session, ``center_std`` of the component means
per coordinate, ``noise_std`` of an item about its mean, ``drift_std``
of the means' random walk per batch; ``pool`` batches are made and the
window cycles through them; ``rearm`` re-arms every session after each
ingest; ``fill`` more set-up ingests (optional).  The means and their
walk come from the file's own ``layout_seed``; the run's seed draws each
item's component, its noise and the interleaving.  Every batch brings
each session exactly items_per_ingest / sessions items, so every seed
has the same sizes and the same mixtures, in another draw and order.
"""
from __future__ import annotations

import torch

KEYS = ("components", "center_std", "noise_std", "drift_std", "pool",
        "rearm", "layout_seed")


def session_ids(cfg) -> list:
    first = int(cfg.get("first_session_id", 1000))
    return list(range(first, first + int(cfg["total_sessions"])))


def per_session(cfg) -> int:
    S, N = int(cfg["total_sessions"]), int(cfg["items_per_ingest"])
    if N % S or N // S > int(cfg["chunk_per_session"]):
        raise ValueError(f"{N} items over {S} sessions must split evenly "
                         f"within the chunk of {cfg['chunk_per_session']}")
    return N // S


def make_pool(cfg, traffic, seed: int, device) -> list:
    """``traffic['pool']`` batches (sids (N,) int32, X (N, d) float32)."""
    missing = [k for k in KEYS if k not in traffic]
    if missing:
        raise ValueError(f"traffic file lacks {missing}")
    S, d = int(cfg["total_sessions"]), int(cfg["d"])
    m, N = per_session(cfg), int(cfg["items_per_ingest"])
    unit = float(cfg["data_scale"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    lay = torch.Generator(device=device)
    lay.manual_seed(int(traffic["layout_seed"]))
    comps = int(traffic["components"])
    means = (traffic["center_std"] * unit) * torch.randn(
        (S, comps, d), generator=lay, device=device)
    ids = torch.tensor(session_ids(cfg), dtype=torch.int32, device=device)
    slots = torch.arange(S, device=device).repeat_interleave(m)
    pool = []
    for _ in range(int(traffic["pool"])):
        slot = slots[torch.randperm(N, generator=gen, device=device)]
        comp = torch.randint(0, comps, (N,), generator=gen, device=device)
        X = means[slot, comp] + (traffic["noise_std"] * unit) * torch.randn(
            (N, d), generator=gen, device=device)
        pool.append((ids[slot].contiguous(), X.float().contiguous()))
        if traffic["drift_std"]:
            means = means + (traffic["drift_std"] * unit) * torch.randn(
                means.shape, generator=lay, device=device)
    return pool
