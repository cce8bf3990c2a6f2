# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of ``repro.models.moe``: the Mixture-of-Experts FFN, two
interchangeable implementations.

  * ``dense``     every expert on every token, mask-combined: one grouped
                  einsum over all E experts (``ebsf``), the reference's
                  baseline and the configs' default ``impl``;
  * ``dispatch``  capacity-based sort dispatch (drop on overflow): the
                  (token, choice) pairs sorted by expert id (a stable
                  sort), batched per expert up to the capacity, scattered
                  back weighted with ``index_add_``.

Both return ``(y, aux)``, aux the load-balancing loss
E * sum_e frac_e * mean_p_e.  The router, its renormalization and the aux
loss run in float32 as in the reference.  ``torch.topk`` and
``jax.lax.top_k`` both sort descending, but their order among tied
probabilities is not guaranteed to agree.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import ParamDef, einsum, matmul, replicated, shard_act


def moe_spec(cfg: ModelConfig) -> Dict[str, Any]:
    m = cfg.moe
    d = cfg.d_model
    eff = m.expert_ff or cfg.d_ff
    s = {
        "router": ParamDef((d, m.n_experts), (None, None), "normal:0.006"),
        "w_gate": ParamDef((m.n_experts, d, eff),
                           ("experts", "fsdp", "expert_ffn")),
        "w_up": ParamDef((m.n_experts, d, eff),
                         ("experts", "fsdp", "expert_ffn")),
        "w_down": ParamDef((m.n_experts, eff, d),
                           ("experts", "expert_ffn", "fsdp")),
    }
    if m.n_shared:
        f_sh = m.n_shared * eff
        s["shared"] = {
            "w_gate": ParamDef((d, f_sh), ("fsdp", "ffn")),
            "w_up": ParamDef((d, f_sh), ("fsdp", "ffn")),
            "w_down": ParamDef((f_sh, d), ("ffn", "fsdp")),
        }
    return s


def _expert_ffn(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    g = matmul(x, wg.to(dt))
    u = matmul(x, wu.to(dt))
    return matmul(F.silu(g.float()).to(dt) * u, wd.to(dt))


def _route(p, x: torch.Tensor, cfg: ModelConfig):
    """Router: top-k (vals renormalized, idx) of the softmax over the
    experts, and the aux loss, all float32."""
    m = cfg.moe
    logits = matmul(x.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.topk(probs, m.top_k, dim=-1)
    vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(idx, m.n_experts).float()  # (..., k, E)
    frac = onehot.sum(-2).reshape(-1, m.n_experts).mean(0)
    mean_p = probs.reshape(-1, m.n_experts).mean(0)
    aux = m.n_experts * torch.sum(frac * mean_p)
    return vals, idx, aux


def moe_dense(p, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every expert on every token, mask-combined, as batched einsums
    over the expert axis (the reference's overcompute included)."""
    m = cfg.moe
    dt = x.dtype
    vals, idx, aux = _route(p, x, cfg)
    comb = einsum("...ke,...k->...e",
                  F.one_hot(idx, m.n_experts).to(dt), vals.to(dt))
    g = shard_act(einsum("bsd,edf->ebsf", x, p["w_gate"].to(dt)),
                  None, "batch", None, "tp")
    u = shard_act(einsum("bsd,edf->ebsf", x, p["w_up"].to(dt)),
                  None, "batch", None, "tp")
    h = F.silu(g.float()).to(dt) * u
    ye = einsum("ebsf,efd->ebsd", h, p["w_down"].to(dt))
    y = einsum("ebsd,bse->bsd", ye, comb)
    if m.n_shared:
        sh = p["shared"]
        y = y + _expert_ffn(x, sh["w_gate"], sh["w_up"], sh["w_down"])
    return y, aux


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert: N k / E times the capacity factor, rounded up to
    a multiple of 8, at least 8 (the reference's rounding)."""
    m = cfg.moe
    cap = int(n_tokens * m.top_k / m.n_experts * m.capacity_factor)
    return max(8, cap - cap % 8 + (8 if cap % 8 else 0))


def dispatch_slots(idx: torch.Tensor, n_experts: int, cap: int):
    """The reference's dispatch order for top-k choices idx (N, k) ->
    (order, slot, valid): the flat (token, choice) pairs sorted stably by
    expert, each pair's slot se * cap + rank in the expert buffers, and
    whether it fits (rank < cap; an overflow's slot is the scratch row
    E * cap)."""
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = torch.bincount(flat_e, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts  # exclusive prefix
    rank = torch.arange(flat_e.numel(), device=idx.device) - starts[se]
    valid = rank < cap
    slot = torch.where(valid, se * cap + rank,
                       torch.full_like(se, n_experts * cap))
    return order, slot, valid


def moe_dispatch(p, x: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based sort dispatch: FLOPs ~ (top_k + shared) / E of the
    dense route; a pair past its expert's capacity is dropped."""
    m = cfg.moe
    B, S, d = x.shape
    N, k, E = B * S, m.top_k, m.n_experts
    cap = capacity(cfg, N)
    dt = x.dtype
    xf = x.reshape(N, d)
    vals, idx, aux = _route(p, xf, cfg)  # (N, k)
    order, slot, valid = dispatch_slots(idx, E, cap)
    stok = torch.arange(N, device=x.device).repeat_interleave(k)[order]
    sw = vals.reshape(N * k)[order]
    # overflow pairs all land on the scratch row, which is thrown away
    buf = torch.zeros((E * cap + 1, d), dtype=dt, device=x.device)
    buf[slot] = xf[stok]
    h = buf[:E * cap].reshape(E, cap, d)
    g = torch.einsum("ecd,edf->ecf", h, p["w_gate"].to(dt))
    u = torch.einsum("ecd,edf->ecf", h, p["w_up"].to(dt))
    yo = torch.einsum("ecf,efd->ecd", F.silu(g.float()).to(dt) * u,
                      p["w_down"].to(dt)).reshape(E * cap, d)
    contrib = yo[torch.clamp(slot, max=E * cap - 1)] * (
        sw * valid.float()).to(dt)[:, None]
    y = torch.zeros((N, d), dtype=dt, device=x.device)
    y.index_add_(0, stok, contrib)
    y = y.reshape(B, S, d)
    if m.n_shared:
        sh = p["shared"]
        y = y + _expert_ffn(x, sh["w_gate"], sh["w_up"], sh["w_down"])
    return y, aux


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.moe.impl == "dispatch":
        # on a mesh the dispatch runs whole on every rank (its capacity
        # and drop set are those of the global token set)
        return replicated(lambda p, x: moe_dispatch(p, x, cfg), p, x)
    return moe_dense(p, x, cfg)
