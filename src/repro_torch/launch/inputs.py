# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Stand-in inputs for every (architecture x input-shape) cell (port of
``repro/launch/inputs.py``).

``input_specs(cfg, shape)`` returns a dict of tensors on the ``meta``
device, the JAX package's ``ShapeDtypeStruct``s: shapes and dtypes, never
allocated (the dry-run runs against them; the KV caches come from
``init_cache`` on the ``meta`` device, where the reference uses
``jax.eval_shape``, so even a 500k-token cache costs zero bytes here).

Shape table (the reference's):
  train_4k     seq=4096    global_batch=256   -> train_step
  prefill_32k  seq=32768   global_batch=32    -> prefill (serve)
  decode_32k   seq=32768   global_batch=128   -> serve_step (1 new token)
  long_500k    seq=524288  global_batch=1     -> serve_step; sub-quadratic
                                                 archs only (SSM / hybrid)
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import ModelConfig, init_cache

SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k": {"seq": 4096, "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32768, "batch": 32, "kind": "prefill"},
    "decode_32k": {"seq": 32768, "batch": 128, "kind": "decode"},
    "long_500k": {"seq": 524288, "batch": 1, "kind": "decode"},
}


def cell_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic attention (DESIGN.md §6)."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: long_500k skipped per spec"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _frontend_specs(cfg: ModelConfig, batch: int) -> Dict[str, Any]:
    """Stub modality frontends: precomputed frame/patch embeddings."""
    out: Dict[str, Any] = {}
    if cfg.encoder is not None:
        out["frames"] = _meta((batch, cfg.encoder.n_frames, cfg.d_model),
                              cfg.activation_dtype)
    if cfg.n_prefix:
        out["prefix"] = _meta((batch, cfg.n_prefix, cfg.d_model),
                              cfg.activation_dtype)
    return out


def train_input_specs(cfg: ModelConfig, seq: int, batch: int
                      ) -> Dict[str, Any]:
    specs = {"tokens": _meta((batch, seq), torch.int32),
             "labels": _meta((batch, seq), torch.int32)}
    specs.update(_frontend_specs(cfg, batch))
    return specs


def prefill_input_specs(cfg: ModelConfig, seq: int, batch: int
                        ) -> Dict[str, Any]:
    specs = {"tokens": _meta((batch, seq), torch.int32)}
    specs.update(_frontend_specs(cfg, batch))
    return specs


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int):
    """The KV / SSM cache tree on the ``meta`` device: no allocation."""
    return init_cache(cfg, batch, max_seq, cfg.activation_dtype,
                      device="meta")


def decode_input_specs(cfg: ModelConfig, seq: int, batch: int
                       ) -> Dict[str, Any]:
    """One new token with a cache holding ``seq`` prior positions."""
    specs: Dict[str, Any] = {
        "token": _meta((batch, 1), torch.int32),
        "caches": cache_specs(cfg, batch, seq),
        "pos": _meta((), torch.int32),
    }
    if cfg.encoder is not None:
        specs["enc_out"] = _meta((batch, cfg.encoder.n_frames, cfg.d_model),
                                 cfg.activation_dtype)
    return specs


def input_specs(cfg: ModelConfig, shape: str) -> Tuple[str, Dict[str, Any]]:
    """-> (kind, {name: meta tensor | tree of them})."""
    if shape not in SHAPES:
        raise ValueError(f"unknown shape {shape!r}; choose from {list(SHAPES)}")
    s = SHAPES[shape]
    seq, batch, kind = s["seq"], s["batch"], s["kind"]
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} x {shape}: {why}")
    if kind == "train":
        return kind, train_input_specs(cfg, seq, batch)
    if kind == "prefill":
        return kind, prefill_input_specs(cfg, seq, batch)
    return kind, decode_input_specs(cfg, seq, batch)
