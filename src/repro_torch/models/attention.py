# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of ``repro.models.attention``: GQA (dense archs) and
cross-attention (enc-dec).  Three entry modes per layer:

  * train    full-sequence attention (``gqa_train``; also the Whisper
             encoder, non-causal)
  * prefill  the causal prompt pass that writes the KV cache
  * decode   one new token against the cache

``chunked_attention`` is the plain PyTorch attention of every mode, as
the plain JAX chunked attention is in the reference.  With
``cfg.use_pallas_attention`` set, ``gqa_train`` routes to the CUDA
flash-attention kernel (``kernels.flash_attention``; its plain version
for a CPU tensor).  MLA waits for the ``ROADMAP.md`` item that ports it.

The KV cache is updated in place and returned (the JAX package returns a
new, donated buffer).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention

from .config import ModelConfig
from .layers import ParamDef, apply_rope

NEG = -1e30


# ------------------------------------------------- chunked attention (plain)
def _attend_block(q, k, v, qpos, kv_len, causal):
    """q (B,Sq,Kv,G,hd) float32-softmax attention against the full k/v
    (B,T,Kv,hd); qpos (Sq,) global query positions; keys masked to
    t < kv_len (and, when causal, t <= qpos)."""
    hd = q.shape[-1]
    T = k.shape[1]
    s = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * hd ** -0.5
    t = torch.arange(T, device=q.device)
    mask = t[None, :] < kv_len
    if causal:
        mask = mask & (qpos[:, None] >= t[None, :])
    s = torch.where(mask[None, None, None], s,
                    torch.tensor(NEG, device=q.device))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.to(v.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, chunk: int = 512, kv_len=None,
                      q_offset: int = 0) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,T,Kv,hd) -> (B,S,H,hd), over query chunks so
    the scores of one chunk, not of the whole sequence, are live."""
    B, S, H, hd = q.shape
    T, Kv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    G = H // Kv
    kv_len = T if kv_len is None else kv_len
    qg = q.reshape(B, S, Kv, G, hd)
    outs = []
    for c0 in range(0, S, chunk):
        qc = qg[:, c0:c0 + chunk]
        qpos = q_offset + c0 + torch.arange(qc.shape[1], device=q.device)
        outs.append(_attend_block(qc, k, v, qpos, kv_len, causal))
    return torch.cat(outs, 1).reshape(B, S, H, dv)


# ------------------------------------------------------------- GQA layer
def gqa_spec(cfg: ModelConfig) -> Dict[str, Any]:
    d, hd, Hq, Kv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    s = {
        "wq": ParamDef((d, Hq, hd), ("fsdp", "heads", None)),
        "wk": ParamDef((d, Kv, hd), ("fsdp", "kv_heads", None)),
        "wv": ParamDef((d, Kv, hd), ("fsdp", "kv_heads", None)),
        "wo": ParamDef((Hq, hd, d), ("heads", None, "fsdp")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamDef((Hq, hd), ("heads", None), "zeros")
        s["bk"] = ParamDef((Kv, hd), ("kv_heads", None), "zeros")
        s["bv"] = ParamDef((Kv, hd), ("kv_heads", None), "zeros")
    return s


def _gqa_qkv(p, x: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.rope != "none":
        frac = cfg.rope_frac if cfg.rope == "partial" else 1.0
        q = apply_rope(q, pos, frac=frac, theta=cfg.rope_theta)
        k = apply_rope(k, pos, frac=frac, theta=cfg.rope_theta)
    return q, k, v


def _out(p, o: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype))


def gqa_train(p, x: torch.Tensor, cfg: ModelConfig, *,
              causal: bool = True) -> torch.Tensor:
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)[None, :]
    q, k, v = _gqa_qkv(p, x, pos, cfg)
    if cfg.use_pallas_attention:
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal).transpose(1, 2)
    else:
        o = chunked_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk)
    return _out(p, o)


def gqa_init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                   device) -> Dict[str, torch.Tensor]:
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_prefill(p, x: torch.Tensor, cache, cfg: ModelConfig):
    """Causal prompt pass that writes cache positions [0, S)."""
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)[None, :]
    q, k, v = _gqa_qkv(p, x, pos, cfg)
    cache["k"][:, :S] = k
    cache["v"][:, :S] = v
    o = chunked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    return _out(p, o), cache


def gqa_decode(p, x: torch.Tensor, cache, pos: int, cfg: ModelConfig):
    """x (B, 1, D) at position ``pos`` (a Python int) against the cache."""
    q, k, v = _gqa_qkv(p, x, torch.full((1, 1), pos, device=x.device), cfg)
    cache["k"][:, pos:pos + 1] = k
    cache["v"][:, pos:pos + 1] = v
    o = chunked_attention(q, cache["k"], cache["v"], causal=False,
                          chunk=cfg.attn_chunk, kv_len=pos + 1)
    return _out(p, o), cache


# ------------------------------------------------------- cross-attention
def cross_spec(cfg: ModelConfig) -> Dict[str, Any]:
    d, hd, Hq = cfg.d_model, cfg.hd, cfg.n_heads
    return {
        "wq": ParamDef((d, Hq, hd), ("fsdp", "heads", None)),
        "wk": ParamDef((d, Hq, hd), ("fsdp", "heads", None)),
        "wv": ParamDef((d, Hq, hd), ("fsdp", "heads", None)),
        "wo": ParamDef((Hq, hd, d), ("heads", None, "fsdp")),
    }


def cross_attend(p, x: torch.Tensor,
                 enc_kv: Tuple[torch.Tensor, torch.Tensor],
                 cfg: ModelConfig) -> torch.Tensor:
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k, v = enc_kv
    return _out(p, chunked_attention(q, k, v, causal=False,
                                     chunk=cfg.attn_chunk))


def cross_encode(p, enc_out: torch.Tensor, cfg: ModelConfig):
    """The encoder-side K/V of one decoder layer."""
    dt = enc_out.dtype
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"].to(dt))
    return k, v
