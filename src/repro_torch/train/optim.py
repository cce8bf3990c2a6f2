# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""AdamW with dtype-configurable moment states (port of
``repro/train/optim.py``).

The state tree mirrors the parameter tree: ``OptState(m, v, step)`` with
``step`` an int32 scalar tensor, saved under the JAX package's keys
(``m/embed``, ``step``).  The math is the reference's, in float32: the
global-norm clip scale, bias correction, the warmup-then-cosine rate,
decoupled weight decay on leaves of two or more dimensions only (no
decay on norms or biases).

``adamw_update`` updates the parameter and moment tensors in place
(under ``torch.no_grad``) and returns them: at qwen2-1.5b's 1.54e9
float32 parameters a second copy of params, m and v would cost 17 GiB.
The values are the reference's; a caller that needs the old tree keeps a
copy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.tree import leaves_with_keys, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"  # "float32" | "bfloat16"
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor


def init_opt_state(params, cfg: AdamWConfig) -> OptState:
    """Zero moments in ``cfg.state_dtype`` beside each parameter, and
    step 0, on the parameters' device."""
    dt = getattr(torch, cfg.state_dtype)
    leaves = list(leaves_with_keys(params).values())
    dev = leaves[0].device if leaves else None

    def zeros(p):  # a DTensor parameter's moments take its placements
        return torch.zeros_like(p, dtype=dt,
                                memory_format=torch.contiguous_format)

    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def lr_at(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac`` (float32)."""
    s = step.float()
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32; a DTensor
    leaf's sum is its ranks' partial sums added across the mesh (a plain
    scalar on every rank)."""
    from repro_torch.launch.mesh import full_tensor

    total = 0
    for leaf in leaves_with_keys(tree).values():
        total = total + full_tensor(torch.sum(torch.square(leaf.float())))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def adamw_update(params, grads, state: OptState, cfg: AdamWConfig
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step -> (params, OptState, {"lr", "grad_norm"}); params,
    m and v are updated in place and returned, ``step`` is a new
    tensor."""
    step = state.step + 1
    lr = lr_at(step, cfg)
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if cfg.grad_clip > 0 else 1.0)
    sdt = getattr(torch, cfg.state_dtype)
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()

    ps, gs = leaves_with_keys(params), leaves_with_keys(grads)
    ms, vs = leaves_with_keys(state.m), leaves_with_keys(state.v)
    for key, p in ps.items():
        g = gs[key].float() * scale
        m32 = cfg.b1 * ms[key].float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * vs[key].float() + (1 - cfg.b2) * g * g
        del g
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if cfg.weight_decay and p.dim() >= 2:  # no decay on norms/bias
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        del delta
        ms[key].copy_(m32.to(sdt))
        vs[key].copy_(v32.to(sdt))
    return (params, OptState(m=state.m, v=state.v, step=step),
            {"lr": lr, "grad_norm": gnorm})
