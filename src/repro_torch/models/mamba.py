# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of ``repro.models.mamba``: the Mamba2 (state-space duality, SSD)
layer, a chunked parallel scan for train/prefill and an O(1)-state
recurrence for decode.

The chunked SSD algorithm (Dao & Gu 2024, Listing 1): within a chunk the
recurrence is expanded into an attention-like quadratic form; across
chunks a cumulative-decay recurrence propagates the (H, P, N) state.

``mamba_train`` and ``mamba_prefill`` call ``ssd(..., use_pallas=True)``,
the JAX package's own route to its TPU kernel for the same function
(its layer never passes the flag): the quadratic intra-chunk term and the
chunk end-states go to ``kernels.ssd_chunk.ssd_chunks``, which runs the
hand-written CUDA kernel (``csrc/ssd_chunk.cu``) on a CUDA tensor and its
plain version on a CPU tensor (backend ``auto``).  B and C go to it per
group (``n_groups``, one for Mamba2-370m), not repeated over the heads:
the kernel reads each group once for all its heads, and the inter-chunk
term reads C per group too.  The inter-chunk recurrence stays plain
PyTorch.  Decode is plain PyTorch, repeats B and C per head as the JAX
package does, and launches no kernel.

The caches are updated in place (``copy_`` into the given tensors, which
are views of the model's stacked caches) and returned.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_chunk import ssd_chunks

from .config import ModelConfig
from .layers import ParamDef


def mamba_spec(cfg: ModelConfig) -> Dict[str, Any]:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    gn = s.n_groups * s.d_state
    conv_ch = di + 2 * gn
    return {
        "w_zx": ParamDef((d, 2 * di), ("fsdp", "ffn")),
        "w_bc": ParamDef((d, 2 * gn), ("fsdp", None)),
        "w_dt": ParamDef((d, nh), ("fsdp", None)),
        "conv_w": ParamDef((s.conv_width, conv_ch), (None, None)),
        "conv_b": ParamDef((conv_ch,), (None,), "zeros"),
        "A_log": ParamDef((nh,), (None,), "zeros"),  # A = -exp(A_log) = -1
        "D": ParamDef((nh,), (None,), "ones"),
        "dt_bias": ParamDef((nh,), (None,), "zeros"),
        "norm_scale": ParamDef((di,), (None,), "ones"),
        "w_out": ParamDef((di, d), ("ffn", "fsdp")),
    }


# ---------------------------------------------------------------- SSD core
def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., Q) -> (..., Q, Q) lower-tri cumulative segment sums."""
    cs = torch.cumsum(x, -1)
    diff = cs[..., :, None] - cs[..., None, :]
    Q = x.shape[-1]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, diff, torch.tensor(float("-inf"),
                                                dtype=diff.dtype,
                                                device=x.device))


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` over operands promoted to one dtype, as
    ``jnp.einsum`` promotes them (bfloat16 with float32 gives float32)."""
    dt = ops[0].dtype
    for t in ops[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.einsum(eq, *(t.to(dt) for t in ops))


def ssd(X: torch.Tensor, Adt: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int, init_state: Optional[torch.Tensor] = None,
        use_pallas: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.

    X (b,L,h,p) inputs (already dt-scaled), Adt (b,L,h) = dt*A,
    B,C (b,L,g,n) per group, h % g == 0 (g = h: per head, the JAX
    signature).  L % chunk == 0.  Returns (Y (b,L,h,p), final (b,h,p,n)).

    ``use_pallas`` routes the quadratic intra-chunk term + end-states
    through ``kernels.ssd_chunk.ssd_chunks`` (the kernel on the card);
    the O(c) inter-chunk recurrence below stays plain PyTorch either way.
    The dtypes are the JAX package's: on the ``use_pallas`` route the
    states are float32, so Y and final are float32 whatever X's dtype; on
    the einsum route they keep X's dtype.
    """
    b, L, h, p = X.shape
    g, n = B.shape[-2], B.shape[-1]
    c = L // chunk
    Ac = Adt.reshape(b, c, chunk, h).permute(0, 3, 1, 2)  # (b,h,c,q)
    A_cum = torch.cumsum(Ac, -1)

    if use_pallas:
        Yk, states = ssd_chunks(X, Adt, B, C, chunk=chunk)
        Y_diag = Yk.reshape(b, c, chunk, h, p)  # states (b,c,h,p,n)
    else:
        Xc = X.reshape(b, c, chunk, h, p)
        # each head its group's B and C
        Bc = torch.repeat_interleave(B, h // g, dim=2).reshape(
            b, c, chunk, h, n)
        Ch = torch.repeat_interleave(C, h // g, dim=2).reshape(
            b, c, chunk, h, n)
        # intra-chunk (quadratic, attention-like), two products
        Lmat = torch.exp(_segsum(Ac))  # (b,h,c,q,s)
        scores = _einsum("bcqhn,bcshn->bhcqs", Ch, Bc)
        Y_diag = _einsum("bhcqs,bcshp->bcqhp", scores * Lmat, Xc)

        # chunk end-states
        decay_states = torch.exp(A_cum[..., -1:] - A_cum)  # (b,h,c,q)
        states = _einsum("bcqhn,bhcq,bcqhp->bchpn", Bc, decay_states, Xc)

    # inter-chunk recurrence over chunk sums
    if init_state is None:
        init_state = torch.zeros((b, h, p, n), dtype=X.dtype, device=X.device)
    dt = torch.promote_types(init_state.dtype, states.dtype)
    states_ext = torch.cat([init_state[:, None].to(dt), states.to(dt)], 1)
    chunk_sum = F.pad(A_cum[..., -1], (1, 0))  # (b,h,c+1)
    decay_chunk = torch.exp(_segsum(chunk_sum))  # (b,h,c+1,c+1)
    new_states = _einsum("bhzc,bchpn->bzhpn", decay_chunk, states_ext)
    prev_states, final = new_states[:, :-1], new_states[:, -1]

    # C per group: head k * h // g + r reads group k
    state_decay = torch.exp(A_cum).reshape(b, g, h // g, c, chunk)
    Y_off = _einsum("bcqgn,bcgrpn,bgrcq->bcqgrp",
                    C.reshape(b, c, chunk, g, n),
                    prev_states.reshape(b, c, g, h // g, p, n), state_decay)
    Y = (Y_diag + Y_off.reshape(b, c, chunk, h, p)).reshape(b, L, h, p)
    return Y, final


def ssd_reference(X, Adt, B, C, init_state=None):
    """Naive per-step recurrence — oracle for tests."""
    b, L, h, p = X.shape
    n = B.shape[-1]
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=X.device)
             if init_state is None else init_state.float())
    ys = []
    for t in range(L):
        da = torch.exp(Adt[:, t]).float()  # (b,h)
        state = state * da[..., None, None] + torch.einsum(
            "bhp,bhn->bhpn", X[:, t].float(), B[:, t].float())
        ys.append(torch.einsum("bhn,bhpn->bhp", C[:, t].float(), state))
    return torch.stack(ys, 1).to(X.dtype), state.to(X.dtype)


# ------------------------------------------------------------ full layer
def _conv_causal(u: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width cw: u (B,S,C), w (cw,C)."""
    cw = w.shape[0]
    up = F.pad(u, (0, 0, cw - 1, 0))
    out = sum(up[:, i:i + u.shape[1]] * w[i] for i in range(cw))
    return out + b


def _project(p, x: torch.Tensor, cfg: ModelConfig):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    dt_ = x.dtype
    zx = x @ p["w_zx"].to(dt_)
    z, xin = zx[..., :di], zx[..., di:]
    bc = x @ p["w_bc"].to(dt_)
    dt_raw = x @ p["w_dt"].to(dt_)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    return z, xin, bc, dt


def _split_heads(xc, bcc, cfg: ModelConfig, repeat: bool = True):
    """-> (x per head, B, C): B and C per head (``repeat``, as the JAX
    package does) or per group, (..., n_groups, d_state)."""
    s = cfg.ssm
    nh = s.n_heads(cfg.d_model)
    gn = s.n_groups * s.d_state
    B_, C_ = bcc[..., :gn], bcc[..., gn:]
    shp = xc.shape[:-1]
    xh = xc.reshape(*shp, nh, s.head_dim)
    Bg = B_.reshape(*shp, s.n_groups, s.d_state)
    Cg = C_.reshape(*shp, s.n_groups, s.d_state)
    if not repeat:
        return xh, Bg, Cg
    rep = nh // s.n_groups
    return (xh, torch.repeat_interleave(Bg, rep, dim=-2),
            torch.repeat_interleave(Cg, rep, dim=-2))


def _gate_out(p, y_flat: torch.Tensor, z: torch.Tensor,
              x_dtype) -> torch.Tensor:
    yf = y_flat.float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    yn = yf * torch.rsqrt(var + 1e-5) * p["norm_scale"]
    gated = (yn * F.silu(z.float())).to(x_dtype)
    return gated @ p["w_out"].to(x_dtype)


def _ssd_inputs(p, x: torch.Tensor, cfg: ModelConfig):
    """The projections, the causal conv and the SSD operands of a
    sequence, padded to a whole number of chunks -> (z, u, xh, Xs, Adt,
    Bg, Cg), B and C per group: the part ``mamba_train`` and
    ``mamba_prefill`` share."""
    s = cfg.ssm
    S = x.shape[1]
    di = s.d_inner(cfg.d_model)
    z, xin, bc, dt = _project(p, x, cfg)
    u = torch.cat([xin, bc], -1)
    conv = F.silu(_conv_causal(u, p["conv_w"].to(x.dtype),
                               p["conv_b"].to(x.dtype)).float()).to(x.dtype)
    xc, bcc = conv[..., :di], conv[..., di:]
    xh, Bg, Cg = _split_heads(xc, bcc, cfg, repeat=False)
    A = -torch.exp(p["A_log"].float())  # (nh,)
    Adt = dt * A  # (B,S,nh)
    Xs = xh * dt[..., None].to(x.dtype)
    pad = (-S) % s.chunk
    if pad:
        Xs = F.pad(Xs, (0, 0, 0, 0, 0, pad))
        Adt = F.pad(Adt, (0, 0, 0, pad))
        Bg = F.pad(Bg, (0, 0, 0, 0, 0, pad))
        Cg = F.pad(Cg, (0, 0, 0, 0, 0, pad))
    return z, u, xh, Xs, Adt.to(Xs.dtype), Bg, Cg


def mamba_train(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (B,S,D) -> (B,S,D)."""
    B_, S, d = x.shape
    z, _, xh, Xs, Adt, Bg, Cg = _ssd_inputs(p, x, cfg)
    Y, _ = ssd(Xs, Adt, Bg, Cg, cfg.ssm.chunk, use_pallas=True)
    Y = Y[:, :S] + p["D"].to(x.dtype)[:, None] * xh
    return _gate_out(p, Y.reshape(B_, S, cfg.ssm.d_inner(d)), z, x.dtype)


def mamba_init_cache(cfg: ModelConfig, batch: int, dtype, device):
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    conv_ch = di + 2 * s.n_groups * s.d_state
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, conv_ch), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, nh, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }


def mamba_prefill(p, x: torch.Tensor, cache, cfg: ModelConfig):
    """Train math + the recurrent state at the end of the sequence,
    written into ``cache`` in place -> (out, cache).

    The conv cache holds the last ``conv_width - 1`` conv inputs; a prompt
    shorter than that is zero-padded in front, as the causal conv pads
    (the JAX package slices past the start there)."""
    B_, S, d = x.shape
    cw = cfg.ssm.conv_width
    z, u, xh, Xs, Adt, Bg, Cg = _ssd_inputs(p, x, cfg)
    Y, final = ssd(Xs, Adt, Bg, Cg, cfg.ssm.chunk, use_pallas=True)
    Y = Y[:, :S] + p["D"].to(x.dtype)[:, None] * xh
    out = _gate_out(p, Y.reshape(B_, S, cfg.ssm.d_inner(d)), z, x.dtype)
    tail = F.pad(u, (0, 0, max(cw - 1 - S, 0), 0))[:, -(cw - 1):]
    cache["conv"].copy_(tail)
    cache["ssm"].copy_(final)
    return out, cache


def mamba_decode(p, x: torch.Tensor, cache, cfg: ModelConfig):
    """x (B,1,D) one-step recurrence; ``cache`` is updated in place."""
    s = cfg.ssm
    B_, _, d = x.shape
    di = s.d_inner(d)
    z, xin, bc, dt = _project(p, x, cfg)  # seq dim = 1
    u = torch.cat([xin, bc], -1)  # (B,1,ch)
    window = torch.cat([cache["conv"], u], 1)  # (B,cw,ch)
    w = p["conv_w"].to(x.dtype)
    conv = sum(window[:, i] * w[i] for i in range(s.conv_width)) \
        + p["conv_b"].to(x.dtype)
    conv = F.silu(conv.float()).to(x.dtype)  # (B,ch)
    xc, bcc = conv[..., :di], conv[..., di:]
    xh, Bh, Ch = _split_heads(xc, bcc, cfg)  # (B,nh,p), (B,nh,n)
    A = -torch.exp(p["A_log"].float())
    dt1 = dt[:, 0]  # (B,nh)
    da = torch.exp(dt1 * A)  # (B,nh)
    ssm = cache["ssm"] * da[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", (xh * dt1[..., None]).float(), Bh.float())
    y = torch.einsum("bhn,bhpn->bhp", Ch.float(), ssm)
    y = y.to(x.dtype) + p["D"].to(x.dtype)[:, None] * xh
    out = _gate_out(p, y.reshape(B_, 1, di), z, x.dtype)
    cache["conv"].copy_(window[:, 1:])
    cache["ssm"].copy_(ssm)
    return out, cache
