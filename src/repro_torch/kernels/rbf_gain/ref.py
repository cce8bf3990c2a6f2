# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Plain PyTorch versions of the two gain kernels (port of
``repro/kernels/rbf_gain/ref.py``).

``gain_traced_ref`` is the plain ``gain_traced`` (kernel hyperparameters
as tensors, ``kernelmath.traced_gain_rows``), stacked summaries and
groups of candidates included.
``gain_ref`` is the plain ``gain_static`` in the order of operations of
the Pallas body ``_gain_kernel`` (``repro/kernels/rbf_gain/kernel.py``):
rbf in the expanded-square form, ``linear_norm`` normalising the rows
before the product.
"""
from __future__ import annotations

import torch

from repro_torch.constants import GAIN_EPS, NORM_EPS
from repro_torch.kernelmath import KernelParams, traced_gain_rows


def gain_traced_ref(x: torch.Tensor, feats: torch.Tensor, linv: torch.Tensor,
                    n: torch.Tensor, kern: KernelParams, *,
                    a: float) -> torch.Tensor:
    """x (B, d) against feats (K, d), linv (K, K), n () live rows -> (B,)
    f32; or against stacked feats (I, K, d), linv (I, K, K), n (I,) ->
    (I, B).  Grouped: x (G, B, d) and ``kern`` leaves of G elements
    against stacked summaries, G dividing I -> (I, B), each run of I / G
    summaries priced as one stacked call with its group's x and kernel."""
    if x.dim() == 3:
        G = x.shape[0]
        if feats.dim() != 3 or feats.shape[0] % G:
            raise ValueError(f"grouped candidates ({G} groups) need stacked "
                             f"summaries in equal runs per group, got "
                             f"{tuple(feats.shape)}")
        per = feats.shape[0] // G
        inv2l2, kind = kern.inv2l2.reshape(G), kern.kind_id.reshape(G)
        return torch.cat([gain_traced_ref(
            x[g], feats[g * per:(g + 1) * per], linv[g * per:(g + 1) * per],
            n.reshape(-1)[g * per:(g + 1) * per],
            KernelParams(inv2l2[g], kind[g]), a=a) for g in range(G)])
    K = feats.shape[-2]
    live = torch.arange(K, device=feats.device) < n.reshape(*n.shape, 1)
    mask = live.to(torch.float32).unsqueeze(-2)  # (1, K) or (I, 1, K)
    return traced_gain_rows(x.to(torch.float32), feats.to(torch.float32),
                            linv.to(torch.float32), mask,
                            a=a, kern=kern)[..., 0]


def kernel_block(x: torch.Tensor, feats: torch.Tensor, *, inv2l2: float,
                 kind: str = "rbf") -> torch.Tensor:
    """Unmasked kernel values k(x_i, feats_j): (B, d), (K, d) -> (B, K)."""
    if kind == "rbf":
        xn = torch.sum(x * x, dim=-1, keepdim=True)  # (B, 1)
        fn = torch.sum(feats * feats, dim=-1)[None, :]  # (1, K)
        d2 = torch.clamp_min(xn + fn - 2.0 * (x @ feats.T), 0.0)
        return torch.exp(-inv2l2 * d2)
    if kind == "linear_norm":
        xn = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
        fn = torch.sqrt(torch.sum(feats * feats, dim=-1, keepdim=True))
        xs = x / torch.clamp_min(xn, NORM_EPS)
        fs = feats / torch.clamp_min(fn, NORM_EPS)
        return 0.5 * (xs @ fs.T + 1.0)
    raise ValueError(f"unknown kernel kind {kind!r}")


def gain_ref(x: torch.Tensor, feats: torch.Tensor, linv: torch.Tensor,
             mask: torch.Tensor, *, a: float, inv2l2: float,
             kind: str = "rbf") -> torch.Tensor:
    """x (B, d), feats (K, d), linv (K, K), mask (1, K) -> (B, 1) gains."""
    km = a * kernel_block(x, feats, inv2l2=inv2l2, kind=kind) * mask
    c = km @ linv.T
    cn2 = torch.sum(c * c, dim=-1, keepdim=True)
    return 0.5 * torch.log(torch.clamp_min((1.0 + a) - cn2, GAIN_EPS))


def rbf_gain_ref(x, feats, linv, mask, *, a: float, inv2l2: float):
    """``gain_ref`` with the rbf kernel."""
    return gain_ref(x, feats, linv, mask, a=a, inv2l2=inv2l2, kind="rbf")
