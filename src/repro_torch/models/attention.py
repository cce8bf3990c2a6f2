# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of ``repro.models.attention``: GQA (dense archs), MLA
(DeepSeek-V2) and cross-attention (enc-dec).  Three entry modes per
layer:

  * train    full-sequence attention (``gqa_train``; also the Whisper
             encoder, non-causal)
  * prefill  the causal prompt pass that writes the KV cache
  * decode   one new token against the cache

``chunked_attention`` is the plain PyTorch attention of every mode, as
the plain JAX chunked attention is in the reference.  With
``cfg.use_pallas_attention`` set, ``gqa_train`` routes to the CUDA
flash-attention kernel (``kernels.flash_attention``; its plain version
for a CPU tensor).  MLA trains and prefills on the decompressed K/V
through ``chunked_attention`` (qk width 192, v width 128 at DeepSeek-V2's
widths) and decodes with the absorbed matmuls in float32 against its
compressed cache (``ckv``, ``krope``).

The KV cache is updated in place and returned (the JAX package returns a
new, donated buffer).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention

from .config import ModelConfig
from .layers import (ParamDef, _ambient_mesh, apply_norm, apply_rope,
                     einsum, heads_local, matmul, norm_spec, shard_act)

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
    """q (B,S,H,hd), k (B,T,Kv,hd), v (B,T,Kv,dv) -> (B,S,H,dv), over
    query chunks so the scores of one chunk, not of the whole sequence,
    are live (dv may differ from hd: MLA's qk 192 against v 128)."""
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
    q = einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.rope != "none":
        frac = cfg.rope_frac if cfg.rope == "partial" else 1.0
        q = apply_rope(q, pos, frac=frac, theta=cfg.rope_theta)
        k = apply_rope(k, pos, frac=frac, theta=cfg.rope_theta)
    # on a mesh each tensor gets the best layout it divides into: heads
    # over 'model'; or, with ``attn_seq_shard`` and q heads that do not
    # divide 'model', the query sequence over 'model' (context
    # parallelism) and k / v gathered
    if _seq_shard(cfg, q.shape[1]):
        q = shard_act(q, "batch", "tp")
        k = shard_act(k, "batch")
        v = shard_act(v, "batch")
    else:
        q = shard_act(q, "batch", None, "tp")
        k = shard_act(k, "batch", None, "tp")
        v = shard_act(v, "batch", None, "tp")
    return q, k, v


def _q_heads_divisible(cfg: ModelConfig) -> bool:
    m = _ambient_mesh()
    if m is None or "model" not in m.mesh_dim_names:
        return True
    return cfg.n_heads % m.size(m.mesh_dim_names.index("model")) == 0


def _seq_shard(cfg: ModelConfig, S: int) -> bool:
    return cfg.attn_seq_shard and not _q_heads_divisible(cfg) and S > 1


def _attend(q, k, v, cfg: ModelConfig, causal: bool) -> torch.Tensor:
    """The plain attention of train and prefill.  A query sequence split
    over 'model' (``_seq_shard``) is attended rank by rank: each rank's
    rows at their global offset against the whole k / v, whose gradient
    is then a partial sum over 'model'."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    mesh = q.device_mesh if isinstance(q, DTensor) else None
    if mesh is None or "model" not in mesh.mesh_dim_names or \
            q.placements[mesh.mesh_dim_names.index("model")] != Shard(1):
        return heads_local(functools.partial(
            chunked_attention, causal=causal, chunk=cfg.attn_chunk), (q,),
            (k, v))
    mi = mesh.mesh_dim_names.index("model")
    grad = list(k.placements)
    grad[mi] = Partial()
    ql = q.to_local()
    o = chunked_attention(
        ql, k.to_local(grad_placements=grad),
        v.to_local(grad_placements=grad), causal=causal,
        chunk=cfg.attn_chunk,
        q_offset=mesh.get_local_rank("model") * ql.shape[1])
    return DTensor.from_local(o, mesh, q.placements, run_check=False)


def _out(p, o: torch.Tensor) -> torch.Tensor:
    return einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype))


def _flash(q, k, v, causal: bool) -> torch.Tensor:
    return flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=causal).transpose(1, 2)


def gqa_train(p, x: torch.Tensor, cfg: ModelConfig, *,
              causal: bool = True) -> torch.Tensor:
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)[None, :]
    q, k, v = _gqa_qkv(p, x, pos, cfg)
    if cfg.use_pallas_attention:
        # on a mesh the kernel runs on each rank's heads; a query
        # sequence split over 'model' is gathered for it (the kernel has
        # no query offset) and split again after
        o = heads_local(functools.partial(_flash, causal=causal), (q,),
                        (k, v))
        if _seq_shard(cfg, S):
            o = shard_act(o, "batch", "tp")
    else:
        o = _attend(q, k, v, cfg, causal)
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
    o = _attend(q, k, v, cfg, True)
    return _out(p, o), cache


def gqa_decode(p, x: torch.Tensor, cache, pos: int, cfg: ModelConfig):
    """x (B, 1, D) at position ``pos`` (a Python int) against the cache."""
    q, k, v = _gqa_qkv(p, x, torch.full((1, 1), pos, device=x.device), cfg)
    cache["k"][:, pos:pos + 1] = k
    cache["v"][:, pos:pos + 1] = v
    o = heads_local(functools.partial(
        chunked_attention, causal=False, chunk=cfg.attn_chunk,
        kv_len=pos + 1), (q,), (cache["k"], cache["v"]))
    return _out(p, o), cache


# ------------------------------------------------------------- MLA layer
def mla_spec(cfg: ModelConfig) -> Dict[str, Any]:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq": ParamDef((d, H, qk_hd), ("fsdp", "heads", None)),
        "w_dkv": ParamDef((d, m.kv_lora_rank + m.qk_rope_head_dim),
                          ("fsdp", None)),
        "ckv_norm": norm_spec(m.kv_lora_rank, "rmsnorm"),
        "w_uk": ParamDef((m.kv_lora_rank, H, m.qk_nope_head_dim),
                         (None, "heads", None)),
        "w_uv": ParamDef((m.kv_lora_rank, H, m.v_head_dim),
                         (None, "heads", None)),
        "wo": ParamDef((H, m.v_head_dim, d), ("heads", None, "fsdp")),
    }


def _mla_q_ckv(p, x: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig):
    m, dt = cfg.mla, x.dtype
    q = einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], pos,
                        theta=cfg.rope_theta)
    dkv = matmul(x, p["w_dkv"].to(dt))  # (B, S, lora + rope)
    ckv = apply_norm(p["ckv_norm"], dkv[..., :m.kv_lora_rank], "rmsnorm")
    k_rope = apply_rope(dkv[..., None, m.kv_lora_rank:], pos,
                        theta=cfg.rope_theta)[:, :, 0]  # one shared head
    return q_nope, q_rope, ckv, k_rope


def mla_train(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The decompressed path (K and V materialized): train and prefill."""
    m, dt = cfg.mla, x.dtype
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope, ckv, k_rope = _mla_q_ckv(p, x, pos, cfg)
    k_nope = einsum("bsl,lhn->bshn", ckv, p["w_uk"].to(dt))
    v = einsum("bsl,lhn->bshn", ckv, p["w_uv"].to(dt))
    k_rope_h = k_rope[:, :, None, :].expand(B, S, cfg.n_heads,
                                            m.qk_rope_head_dim)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope_h], -1)
    o = _attend(q, k, v, cfg, True)
    return einsum("bshv,hvd->bsd", o, p["wo"].to(dt))


def mla_init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                   device) -> Dict[str, torch.Tensor]:
    m = cfg.mla
    return {"ckv": torch.zeros((batch, max_seq, m.kv_lora_rank),
                               dtype=dtype, device=device),
            "krope": torch.zeros((batch, max_seq, m.qk_rope_head_dim),
                                 dtype=dtype, device=device)}


def mla_prefill(p, x: torch.Tensor, cache, cfg: ModelConfig):
    """The decompressed prompt pass that writes the compressed cache at
    positions [0, S)."""
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)[None, :]
    _, _, ckv, k_rope = _mla_q_ckv(p, x, pos, cfg)
    cache["ckv"][:, :S] = ckv
    cache["krope"][:, :S] = k_rope
    return mla_train(p, x, cfg), cache


def mla_decode(p, x: torch.Tensor, cache, pos: int, cfg: ModelConfig):
    """Absorbed-matmul decode: attention in the compressed latent space,
    W_uk folded into the query and W_uv into the output (DeepSeek-V2
    section 2.1.2); scores and softmax in float32, keys t <= pos."""
    m, dt = cfg.mla, x.dtype
    q_nope, q_rope, ckv, k_rope = _mla_q_ckv(
        p, x, torch.full((1, 1), pos, device=x.device), cfg)
    cache["ckv"][:, pos:pos + 1] = ckv
    cache["krope"][:, pos:pos + 1] = k_rope
    q_lat = einsum("bshn,lhn->bshl", q_nope, p["w_uk"].to(dt))
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    ckv_f = cache["ckv"].float()
    s = (einsum("bshl,btl->bhst", q_lat.float(), ckv_f)
         + einsum("bshr,btr->bhst", q_rope.float(),
                  cache["krope"].float())) * scale
    t = torch.arange(cache["ckv"].shape[1], device=x.device)
    s = torch.where((t <= pos)[None, None, None, :], s,
                    torch.tensor(NEG, device=x.device))
    w = torch.exp(s - torch.amax(s, -1, keepdim=True))
    w = w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-30)
    ctx = einsum("bhst,btl->bshl", w, ckv_f)
    v_ctx = einsum("bshl,lhv->bshv", ctx.to(dt), p["w_uv"].to(dt))
    return einsum("bshv,hvd->bsd", v_ctx, p["wo"].to(dt)), cache


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
    q = einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k, v = enc_kv
    return _out(p, _attend(q, k, v, cfg, False))


def cross_encode(p, enc_out: torch.Tensor, cfg: ModelConfig):
    """The encoder-side K/V of one decoder layer."""
    dt = enc_out.dtype
    k = einsum("bsd,dhk->bshk", enc_out, p["wk"].to(dt))
    v = einsum("bsd,dhk->bshk", enc_out, p["wv"].to(dt))
    return k, v
