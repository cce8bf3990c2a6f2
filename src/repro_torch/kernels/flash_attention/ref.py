# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Plain PyTorch version of the flash-attention kernel (port of
``repro/kernels/flash_attention/ref.py``): the O(S^2)-memory oracle the
CUDA kernel is held against."""
from __future__ import annotations

import torch

NEG_INF = -1e30  # the masked score, as in the TPU kernel (not -inf)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale: float | None = None,
                  kv_len: int | None = None) -> torch.Tensor:
    """q (B, Hq, Sq, dh), k/v (B, Hkv, Sk, dh) -> (B, Hq, Sq, dh).

    Float32 softmax over materialized (Sq, Sk) scores; query head h reads
    kv head h // (Hq // Hkv); keys at or past ``kv_len`` (default Sk) and,
    when causal, keys after the query are masked with -1e30.  The output
    is in q's dtype.
    """
    _, Hq, Sq, dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = scale if scale is not None else dh ** -0.5
    kv_len = kv_len if kv_len is not None else Sk

    kr = torch.repeat_interleave(k, group, dim=1)
    vr = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) * scale
    kj = torch.arange(Sk, device=q.device)[None, None, None, :]
    mask = kj < kv_len
    if causal:
        qi = torch.arange(Sq, device=q.device)[None, None, :, None]
        mask = mask & (qi >= kj)
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=q.device))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vr.float())
    return out.to(q.dtype)
