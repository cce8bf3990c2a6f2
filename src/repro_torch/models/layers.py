# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of ``repro.models.layers``: the parameter-spec system and the basic
layers (norms, RoPE, MLPs, embeddings).

Parameters live in plain nested dicts of tensors under the JAX package's
key paths (``blocks/l0/attn/wq``).  Every leaf is declared as a
``ParamDef(shape, axes, init)``; the logical sharding ``axes`` are kept so
the spec reads like the JAX one, and ``launch.sharding`` resolves them
to mesh axes (``spec_tree_pspecs``; ``abstract_tree`` and ``param_bytes``
for shapes and sizes without storage).

Norms and RoPE compute in float32 and cast back to the input's type, as
in the JAX package; ``jax.nn.gelu`` defaults to its tanh approximation,
so ``apply_mlp`` does too.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "lecun"  # "lecun" | "normal:<std>" | "zeros" | "ones"
    dtype: str = "float32"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in length")


def _leaf_init(d: ParamDef, gen: torch.Generator, device) -> torch.Tensor:
    dt = getattr(torch, d.dtype)
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dt, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dt, device=device)
    if d.init.startswith("normal:"):
        std = float(d.init.split(":")[1])
    elif d.init == "lecun":
        # the JAX package's fan-in: every axis but the last, the stacked
        # layer axis included
        fan_in = d.shape[0] if len(d.shape) == 1 else math.prod(d.shape[:-1])
        std = max(fan_in, 1) ** -0.5
    else:
        raise ValueError(d.init)
    # scaled in place: no second copy of the leaf while it is made (the
    # stacked expert weights of deepseek-v2-lite-16b are 17.9 GiB each)
    return torch.randn(d.shape, generator=gen, dtype=dt,
                       device=device).mul_(std)


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict (a ``ParamDef`` is a
    leaf here, so ``repro_torch.tree.tree_map`` does not serve)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_tree(spec: Dict[str, Any], gen: torch.Generator,
              device) -> Dict[str, Any]:
    """Real parameters for a spec tree, drawn leaf after leaf from ``gen``
    (the values differ from ``jax.random``'s)."""
    return tree_map(lambda d: _leaf_init(d, gen, device), spec)


def abstract_tree(spec: Dict[str, Any]) -> Dict[str, Any]:
    """Shapes and dtypes of a spec tree as tensors on the ``meta`` device
    (the JAX package's ``ShapeDtypeStruct`` tree): no storage."""
    return tree_map(lambda d: torch.empty(
        d.shape, dtype=getattr(torch, d.dtype), device="meta"), spec)


def spec_tree_pspecs(spec: Dict[str, Any],
                     rules: Dict[Optional[str], Any]):
    """Logical axes -> partition spec tree under ``rules``: per leaf a
    tuple with one mesh axis (a name, a tuple of names or ``None``) per
    dimension, the JAX ``PartitionSpec``'s entries
    (``launch.mesh.pspec``)."""
    from repro_torch.launch.mesh import pspec

    return tree_map(lambda d: pspec(*[rules.get(a, None) for a in d.axes]),
                    spec)


def param_bytes(spec: Dict[str, Any]) -> int:
    """Bytes of every leaf of a spec tree at its dtype."""
    total = 0

    def add(d: ParamDef):
        nonlocal total
        total += math.prod(d.shape) * getattr(torch, d.dtype).itemsize

    tree_map(add, spec)
    return total


def stack_spec(spec: Dict[str, Any], n: int) -> Dict[str, Any]:
    """Add a leading stacked-layers dimension to every leaf."""
    return tree_map(lambda d: ParamDef((n,) + d.shape, (None,) + d.axes,
                                       d.init, d.dtype), spec)


# ---------------------------------------------------------------- norms
def norm_spec(d: int, kind: str) -> Dict[str, ParamDef]:
    s = {"scale": ParamDef((d,), (None,), "ones")}
    if kind == "layernorm":
        s["bias"] = ParamDef((d,), (None,), "zeros")
    return s


def apply_norm(p, x: torch.Tensor, kind: str,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"]
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(x.dtype)


# ----------------------------------------------------------------- RoPE
def rope_cos_sin(pos: torch.Tensor, rope_dim: int, theta: float):
    """pos (...,) int -> cos/sin (..., rope_dim/2), float32."""
    half = rope_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=pos.device)
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=pos.device), exps / half)
    ang = pos.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, *, frac: float = 1.0,
               theta: float = 10_000.0) -> torch.Tensor:
    """x (B, S, H, hd), pos (B, S) or (S,) -> rotated x (rotate-half
    convention; only the first ``frac`` of each head rotates)."""
    hd = x.shape[-1]
    rope_dim = int(hd * frac)
    rope_dim -= rope_dim % 2
    if rope_dim == 0:
        return x
    cos, sin = rope_cos_sin(pos, rope_dim, theta)
    if cos.dim() == 2:  # (S, half) -> broadcast batch
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]  # (B, S, 1, half)
    xr, xp = x[..., :rope_dim], x[..., rope_dim:]
    x1, x2 = torch.chunk(xr.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return torch.cat([out.to(x.dtype), xp], -1)


# ----------------------------------------------------------------- MLPs
def mlp_spec(d: int, f: int, kind: str) -> Dict[str, ParamDef]:
    if kind == "swiglu":
        return {
            "w_gate": ParamDef((d, f), ("fsdp", "ffn")),
            "w_up": ParamDef((d, f), ("fsdp", "ffn")),
            "w_down": ParamDef((f, d), ("ffn", "fsdp")),
        }
    return {
        "w_in": ParamDef((d, f), ("fsdp", "ffn")),
        "w_out": ParamDef((f, d), ("ffn", "fsdp")),
    }


def apply_mlp(p, x: torch.Tensor, kind: str) -> torch.Tensor:
    dt = x.dtype
    if kind == "swiglu":
        g = x @ p["w_gate"].to(dt)
        u = x @ p["w_up"].to(dt)
        return (F.silu(g.float()).to(dt) * u) @ p["w_down"].to(dt)
    h = x @ p["w_in"].to(dt)
    return F.gelu(h.float(), approximate="tanh").to(dt) @ p["w_out"].to(dt)


# ----------------------------------------------------------- embeddings
def embed_spec(vocab: int, d: int) -> ParamDef:
    return ParamDef((vocab, d), ("vocab", "fsdp"), "normal:0.02")


def embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                 dtype) -> torch.Tensor:
    return table[ids].to(dtype)
