# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Batched serving (port of ``repro/serve/engine.py``): prefill and
decode step factories and a request driver.

The caches are fixed-shape and updated in place: an attention layer's KV
cache (B, max_seq, ...), a Mamba layer's conv window and SSM state.  The steps run eagerly: the JAX package's ``jax.jit`` has no
counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import full_tensor
from repro_torch.models import Model, init_cache


def make_prefill_step(model: Model):
    """(params, batch{tokens[, frames, prefix]}, caches)
    -> (last_logits (B, V), caches, enc_out | None)."""

    def prefill_step(params, batch, caches):
        return model.prefill(params, batch, caches)

    return prefill_step


def make_decode_step(model: Model, *, sample: str = "greedy"):
    """One new token against a populated cache:
    (params, token (B, 1), caches, pos int[, enc_out])
    -> (next_token (B, 1) int32, logits (B, V), caches)."""
    if sample != "greedy":
        raise ValueError(sample)

    def decode_step(params, token, caches, pos, enc_out=None):
        logits, caches = model.decode_step(params, token, caches, pos,
                                           enc_out=enc_out)
        # on a mesh the greedy pick reads the whole vocab row: gathered
        logits = full_tensor(logits)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return nxt, logits, caches

    return decode_step


@dataclasses.dataclass
class ServeDriver:
    """Minimal batched request driver: admit up to ``batch`` prompts,
    prefill once, decode greedily.  It runs on the model's device."""

    model: Model
    max_seq: int
    batch: int

    def __post_init__(self):
        self._prefill = make_prefill_step(self.model)
        self._decode = make_decode_step(self.model)

    @torch.inference_mode()
    def generate(self, params, prompts: torch.Tensor, n_new: int,
                 frontend: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
        """prompts (B, P) int32 -> (B, P + n_new) int32 (greedy).

        B may be smaller than the slot count (partial admission): short
        batches are zero-padded up to ``self.batch`` and the padded rows
        are dropped from the output.
        """
        cfg = self.model.cfg
        B, P = prompts.shape
        if B > self.batch:
            raise ValueError(
                f"batch {B} exceeds the slot count {self.batch}")
        pad = self.batch - B
        if pad:
            prompts = _pad_rows(prompts, pad)
            frontend = {k: _pad_rows(v, pad)
                        for k, v in (frontend or {}).items()} or None
        caches = init_cache(cfg, self.batch, self.max_seq,
                            device=self.model.device)
        batch = {"tokens": prompts, **(frontend or {})}
        logits, caches, enc_out = self._prefill(params, batch, caches)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        out = [prompts, tok]
        pos0 = P + (cfg.n_prefix or 0)  # the stub prefix occupies slots
        for i in range(n_new - 1):
            tok, _, caches = self._decode(params, tok, caches, pos0 + i,
                                          enc_out)
            out.append(tok)
        return torch.cat(out, dim=1)[:B]


def _pad_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad the leading (batch) axis by ``pad`` rows."""
    return F.pad(x, (*([0, 0] * (x.dim() - 1)), 0, pad))
