# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Logical-axis -> mesh-axis resolution with divisibility guards (port of
``repro/launch/sharding.py``).

``build_rules`` maps the logical axes declared in ParamDefs ('fsdp',
'heads', 'ffn', 'vocab', ...) to the axes of a device mesh
(``launch.mesh``).  Every resolved axis is checked for divisibility per
leaf by ``safe_pspecs``: a dim that does not divide (whisper's vocab
51865 on a 16-way model axis, qwen2's 12 heads, ...) falls back to
replication for that dim, as the reference does.

A partition spec is a tuple with one entry per tensor dimension: a mesh
axis name, a tuple of names or ``None`` (the JAX ``PartitionSpec``'s
entries, normalized as it normalizes them: ``launch.mesh.pspec``).
``shardings`` turns each into DTensor placements on the mesh
(``launch.mesh.placements``) for ``torch.distributed.tensor.
distribute_tensor``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

from repro_torch.launch.mesh import (axis_names, axis_sizes, placements,
                                     pspec)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamDef, tree_map
from repro_torch.tree import tree_map as tensor_tree_map


def dp_axes(mesh) -> tuple:
    """Data-parallel axes: ('pod', 'data') on the multi-pod mesh."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def build_rules(cfg: ModelConfig, mesh, *, mode: str = "train",
                serve_replicate_budget: float = 8e9
                ) -> Dict[Optional[str], Any]:
    """mode 'train': params FSDP-sharded over 'data'.  mode 'serve':
    replicate over 'data' (TP-only sharding) whenever the per-device TP
    shard of the bf16 params fits ``serve_replicate_budget`` bytes."""
    model = axis_sizes(mesh).get("model", 1)
    fsdp_axis: Any = "data"
    if mode == "serve":
        per_dev = cfg.param_count() * 2 / model  # bf16 TP shard
        if per_dev <= serve_replicate_budget:
            fsdp_axis = None
    rules: Dict[Optional[str], Any] = {
        "batch": dp_axes(mesh),
        "vocab": "model",
        "heads": "model" if cfg.n_heads % model == 0 else None,
        "kv_heads": "model" if cfg.n_kv_heads % model == 0 else None,
        "ffn": "model",
        "fsdp": fsdp_axis,
        None: None,
    }
    if cfg.moe is not None:
        if cfg.moe.impl == "dispatch" and cfg.moe.n_experts % model == 0:
            rules["experts"] = "model"  # EP
            rules["expert_ffn"] = None
        else:
            rules["experts"] = None
            rules["expert_ffn"] = "model"  # TP inside every expert
    return rules


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axis_names(axes))


def safe_pspec(d: ParamDef, rules, mesh) -> tuple:
    parts = []
    for dim, ax in zip(d.shape, d.axes):
        resolved = rules.get(ax, None)
        if resolved is not None and dim % _axis_size(mesh, resolved) != 0:
            resolved = None  # replicate: dim does not divide
        parts.append(resolved)
    return pspec(*parts)


def safe_pspecs(spec_tree, rules, mesh):
    return tree_map(lambda d: safe_pspec(d, rules, mesh), spec_tree)


def shardings(spec_tree, rules, mesh):
    """Per leaf the DTensor placements of its ``safe_pspec`` on
    ``mesh``."""
    return tree_map(lambda d: placements(safe_pspec(d, rules, mesh), mesh),
                    spec_tree)


def batch_pspec(shape, mesh) -> tuple:
    """Shard the leading (batch) dim over dp axes if divisible."""
    dp = dp_axes(mesh)
    if dp and shape[0] % _axis_size(mesh, dp) == 0:
        return pspec(dp, *([None] * (len(shape) - 1)))
    return pspec(*([None] * len(shape)))


def cache_pspec(shape, mesh, offset: int = 0) -> tuple:
    """KV/SSM cache sharding for one leaf.

    Layout after ``offset`` leading stacked dims (scanned blocks):
      GQA: (B, S, Kv, hd)   MLA ckv: (B, S, lora)   conv: (B, cw-1, ch)
      SSM state: (B, H, P, N)
    Batch shards over dp; the largest remaining dim (the long-sequence
    dim for KV caches; heads for SSM states) shards over 'model' when
    divisible.
    """
    model = axis_sizes(mesh).get("model", 1)
    dp = dp_axes(mesh)
    parts = [None] * len(shape)
    core = tuple(shape[offset:])
    if dp and core and core[0] % _axis_size(mesh, dp) == 0:
        parts[offset] = dp
    if len(core) >= 2:
        cand = max(range(1, len(core)), key=lambda i: core[i])
        if core[cand] % model == 0 and core[cand] >= model:
            parts[offset + cand] = "model"
    return pspec(*parts)


def cache_pspecs(caches, mesh):
    """Partition spec tree of a cache tree (``init_cache``'s, e.g. on the
    ``meta`` device): 'blocks' leaves carry one leading stacked dim,
    'head' leaves none."""
    return {key: tensor_tree_map(
        lambda l, off=1 if key == "blocks" else 0: cache_pspec(
            l.shape, mesh, offset=off), sub)
        for key, sub in caches.items()}
