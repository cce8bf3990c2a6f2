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

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_chunk import ssd_chunks

from .config import ModelConfig
from .layers import (ParamDef, _grouped_slice, batch_local, heads_local,
                     matmul, shard_act)


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


def _columns(w, lo: int, hi: int):
    """Columns [lo, hi) of a DTensor weight, split over 'model' again
    where they divide it (slicing a split dimension gathers it)."""
    from torch.distributed.tensor import Shard

    part = w[:, lo:hi]
    names = part.device_mesh.mesh_dim_names
    if "model" in names:
        mi = names.index("model")
        if (hi - lo) % part.device_mesh.size(mi) == 0:
            pl = list(part.placements)
            pl[mi] = Shard(1)
            part = part.redistribute(part.device_mesh, pl)
    return part


def _project(p, x: torch.Tensor, cfg: ModelConfig):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    from torch.distributed.tensor import DTensor

    dt_ = x.dtype
    w = p["w_zx"].to(dt_)
    if isinstance(x, DTensor):
        # on a mesh z and x come from the weight's two halves, each split
        # over 'model' as zx is: zx's own split would put z on some ranks
        # and x on others, and slicing it would gather zx twice
        z = shard_act(matmul(x, _columns(w, 0, di)), "batch", None, "tp")
        xin = shard_act(matmul(x, _columns(w, di, 2 * di)), "batch", None,
                        "tp")
    else:
        zx = shard_act(matmul(x, w), "batch", None, "tp")
        z, xin = zx[..., :di], zx[..., di:]
    bc = matmul(x, p["w_bc"].to(dt_))
    dt_raw = matmul(x, p["w_dt"].to(dt_))
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


def _gate_out(y_flat: torch.Tensor, z: torch.Tensor, norm_scale,
              x_dtype) -> torch.Tensor:
    """The gated RMSNorm of the SSD output, before ``w_out``."""
    yf = y_flat.float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    yn = yf * torch.rsqrt(var + 1e-5) * norm_scale
    return (yn * F.silu(z.float())).to(x_dtype)


def _ssd_operands(xin, bc, dt, conv_w, conv_b, A_log, cfg: ModelConfig,
                  x_dtype):
    """The causal conv and the SSD operands of a sequence, padded to a
    whole number of chunks -> (u, xh, Xs, Adt, Bg, Cg), B and C per
    group."""
    s = cfg.ssm
    S = xin.shape[1]
    di = s.d_inner(cfg.d_model)
    u = torch.cat([xin, bc], -1)
    conv = F.silu(_conv_causal(u, conv_w.to(x_dtype),
                               conv_b.to(x_dtype)).float()).to(x_dtype)
    xc, bcc = conv[..., :di], conv[..., di:]
    xh, Bg, Cg = _split_heads(xc, bcc, cfg, repeat=False)
    A = -torch.exp(A_log.float())  # (nh,)
    Adt = dt * A  # (B,S,nh)
    Xs = xh * dt[..., None].to(x_dtype)
    pad = (-S) % s.chunk
    if pad:
        Xs = F.pad(Xs, (0, 0, 0, 0, 0, pad))
        Adt = F.pad(Adt, (0, 0, 0, pad))
        Bg = F.pad(Bg, (0, 0, 0, 0, 0, pad))
        Cg = F.pad(Cg, (0, 0, 0, 0, 0, pad))
    return u, xh, Xs, Adt.to(Xs.dtype), Bg, Cg


def _conv_tail(u: torch.Tensor, cw: int) -> torch.Tensor:
    """The last ``cw - 1`` conv inputs of a sequence, zero-padded in front
    when it is shorter (the conv cache)."""
    return F.pad(u, (0, 0, max(cw - 1 - u.shape[1], 0), 0))[:, -(cw - 1):]


def _mixer(p, x: torch.Tensor, cfg: ModelConfig):
    """The projections, the SSD and the gate of ``mamba_train`` and
    ``mamba_prefill`` -> (out, the conv cache's tail, final state).

    On a mesh whose 'model' axis divides the heads (and their groups)
    every rank runs the mixer on its own heads (``_mixer_on_heads``);
    otherwise the projections are sharded products, the conv and the
    SSD operands run on each rank's batch rows (``batch_local``), the SSD
    on each rank's heads as well (``heads_local``: the kernel takes local
    tensors), the gate on the batch rows again."""
    heads = _head_split(x, cfg)
    if heads is not None:
        return _mixer_on_heads(p, x, cfg, *heads)
    S = x.shape[1]
    z, xin, bc, dt = _project(p, x, cfg)
    u, xh, Xs, Adt, Bg, Cg = batch_local(
        lambda xin, bc, dt, w, b, a: _ssd_operands(xin, bc, dt, w, b, a,
                                                   cfg, x.dtype),
        (xin, bc, dt), (p["conv_w"], p["conv_b"], p["A_log"]))
    Y, final = heads_local(
        lambda X, Adt, B, C: ssd(X, Adt, B, C, cfg.ssm.chunk,
                                 use_pallas=True),
        (Xs, Adt), (Bg, Cg), out_hdims=(2, 1))
    gated = batch_local(
        lambda Y, xh, z, D, scale: _gate_out(
            (Y[:, :S] + D.to(x.dtype)[:, None] * xh).flatten(-2), z, scale,
            x.dtype),
        (Y, xh, z), (p["D"], p["norm_scale"]))
    tail = batch_local(lambda u: _conv_tail(u, cfg.ssm.conv_width), (u,))
    return matmul(gated, p["w_out"].to(x.dtype)), tail, final


def _head_split(x, cfg: ModelConfig):
    """(mesh, heads [h0, h1), groups [g0, g1)) of this rank when ``x`` is
    on a mesh whose 'model' axis splits the heads into whole groups (or
    whole heads of one group), else ``None``."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return None
    mesh = x.device_mesh
    if "model" not in mesh.mesh_dim_names:
        return None
    m = mesh.size(mesh.mesh_dim_names.index("model"))
    nh, g = cfg.ssm.n_heads(cfg.d_model), cfg.ssm.n_groups
    if m == 1 or nh % m:
        return None
    r = mesh.get_local_rank("model")
    h0, h1 = r * nh // m, (r + 1) * nh // m
    groups = _grouped_slice(h0, h1, nh, g)
    return None if groups is None else (mesh, (h0, h1), groups)


def _mixer_on_heads(p, x, cfg: ModelConfig, mesh, heads, groups):
    """The tensor-parallel mixer (Megatron's for Mamba): z and x are
    column-parallel products, so each rank holds its heads' channels; the
    conv (depthwise), the SSD kernel and the gate run on them with B / C
    of the rank's groups; the gate's RMS sums across 'model' as a (B, S)
    tensor; ``w_out`` is row-parallel (a partial sum).  Parameters whole
    on a rank but read in part, and B / C, dt whole but read in part,
    get partial gradients over 'model'."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    s = cfg.ssm
    di, dt_ = s.d_inner(cfg.d_model), x.dtype
    (h0, h1), (g0, g1) = heads, groups
    c0, c1 = h0 * s.head_dim, h1 * s.head_dim
    gn = s.n_groups * s.d_state
    mi = mesh.mesh_dim_names.index("model")
    x = shard_act(x, "batch")
    w = p["w_zx"].to(dt_)
    z = matmul(x, _columns(w, 0, di))  # this rank's channels
    xin = matmul(x, _columns(w, di, 2 * di))
    bc = matmul(x, p["w_bc"].to(dt_))
    dt_raw = matmul(x, p["w_dt"].to(dt_))
    rows = [pl if i != mi else Replicate() for i, pl in enumerate(
        z.placements)]
    part = [Partial() if i == mi or isinstance(pl, Shard) else Replicate()
            for i, pl in enumerate(rows)]
    mine = [Shard(2) if i == mi else pl for i, pl in enumerate(rows)]
    over_model = [Partial() if i == mi else pl for i, pl in enumerate(rows)]
    loc = [t.redistribute(mesh, mine).to_local() for t in (z, xin)]
    loc += [t.redistribute(mesh, rows).to_local(grad_placements=over_model)
            for t in (bc, dt_raw)]
    loc += [p[k].redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=part) for k in ("conv_w", "conv_b", "A_log", "D",
                                       "dt_bias", "norm_scale")]

    def total(t):
        # the sum over 'model' of a (B, S, 1) partial; each rank reads it
        # for its own heads only, so its gradient is a partial sum too
        return DTensor.from_local(t, mesh, over_model,
                                  run_check=False).redistribute(
            mesh, rows).to_local(grad_placements=over_model)

    def local(z, xin, bc, dt_raw, conv_w, conv_b, A_log, D, dt_bias, scale):
        S = xin.shape[1]
        keep = torch.cat([torch.arange(c0, c1), torch.arange(di, di + 2 * gn)]
                         ).to(conv_w.device)
        u = torch.cat([xin, bc], -1)
        conv = F.silu(_conv_causal(u, conv_w.to(dt_)[:, keep],
                                   conv_b.to(dt_)[keep]).float()).to(dt_)
        xc, bcc = conv[..., :c1 - c0], conv[..., c1 - c0:]
        xh = xc.reshape(*xc.shape[:-1], h1 - h0, s.head_dim)
        Bg = bcc[..., :gn].reshape(*bcc.shape[:-1], s.n_groups, s.d_state)
        Cg = bcc[..., gn:].reshape(*bcc.shape[:-1], s.n_groups, s.d_state)
        Bg, Cg = Bg[..., g0:g1, :], Cg[..., g0:g1, :]
        dt = F.softplus(dt_raw[..., h0:h1].float() + dt_bias[h0:h1])
        Adt = dt * -torch.exp(A_log[h0:h1].float())
        Xs = xh * dt[..., None].to(dt_)
        pad = (-S) % s.chunk
        if pad:
            Xs = F.pad(Xs, (0, 0, 0, 0, 0, pad))
            Adt = F.pad(Adt, (0, 0, 0, pad))
            Bg = F.pad(Bg, (0, 0, 0, 0, 0, pad))
            Cg = F.pad(Cg, (0, 0, 0, 0, 0, pad))
        Y, final = ssd(Xs, Adt.to(Xs.dtype), Bg, Cg, s.chunk, use_pallas=True)
        yf = (Y[:, :S] + D[h0:h1].to(dt_)[:, None] * xh).flatten(-2).float()
        var = total(torch.sum(yf * yf, -1, keepdim=True)) / di
        gated = (yf * torch.rsqrt(var + 1e-5) * scale[c0:c1]
                 * F.silu(z.float())).to(dt_)
        return (gated, _conv_tail(xin, s.conv_width),
                _conv_tail(bc, s.conv_width), final)

    gated, xt, bt, final = local(*loc)
    wrap = functools.partial(DTensor.from_local, device_mesh=mesh,
                             run_check=False)
    gated, xt = wrap(gated, placements=mine), wrap(xt, placements=mine)
    bt = wrap(bt, placements=rows)
    final = wrap(final, placements=[Shard(1) if i == mi else pl
                                    for i, pl in enumerate(rows)])
    tail = torch.cat([shard_act(xt, "batch"), bt], -1)
    return matmul(gated, p["w_out"].to(dt_)), tail, final


def mamba_train(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (B,S,D) -> (B,S,D)."""
    return _mixer(p, x, cfg)[0]


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
    out, tail, final = _mixer(p, x, cfg)
    cache["conv"].copy_(tail)
    cache["ssm"].copy_(final)
    return out, cache


def _decode_step(xin, bc, dt, z, conv_cache, ssm_cache, conv_w, conv_b,
                 A_log, D, norm_scale, cfg: ModelConfig, x_dtype):
    """One recurrence step -> (gated output, conv window, SSM state)."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    u = torch.cat([xin, bc], -1)  # (B,1,ch)
    window = torch.cat([conv_cache, u], 1)  # (B,cw,ch)
    w = conv_w.to(x_dtype)
    conv = sum(window[:, i] * w[i] for i in range(s.conv_width)) \
        + conv_b.to(x_dtype)
    conv = F.silu(conv.float()).to(x_dtype)  # (B,ch)
    xc, bcc = conv[..., :di], conv[..., di:]
    xh, Bh, Ch = _split_heads(xc, bcc, cfg)  # (B,nh,p), (B,nh,n)
    A = -torch.exp(A_log.float())
    dt1 = dt[:, 0]  # (B,nh)
    da = torch.exp(dt1 * A)  # (B,nh)
    ssm = ssm_cache * da[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", (xh * dt1[..., None]).float(), Bh.float())
    y = torch.einsum("bhn,bhpn->bhp", Ch.float(), ssm)
    y = y.to(x_dtype) + D.to(x_dtype)[:, None] * xh
    gated = _gate_out(y.flatten(-2)[:, None], z, norm_scale, x_dtype)
    return gated, window[:, 1:], ssm


def mamba_decode(p, x: torch.Tensor, cache, cfg: ModelConfig):
    """x (B,1,D) one-step recurrence; ``cache`` is updated in place (on a
    mesh the step runs on each rank's batch rows, ``batch_local``)."""
    z, xin, bc, dt = _project(p, x, cfg)  # seq dim = 1
    gated, window, ssm = batch_local(
        lambda *a: _decode_step(*a, cfg, x.dtype),
        (xin, bc, dt, z, cache["conv"], cache["ssm"]),
        (p["conv_w"], p["conv_b"], p["A_log"], p["D"], p["norm_scale"]))
    cache["conv"].copy_(window)
    cache["ssm"].copy_(ssm)
    return matmul(gated, p["w_out"].to(x.dtype)), cache
