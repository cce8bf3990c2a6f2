# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Public pod-step entry (port of ``repro/kernels/pod_step/ops.py``).

``pod_step(algo, state, chunks, counts)`` advances every session of a
pod by one ingest chunk and updates ``state`` IN PLACE.  Backends:

    auto    the CUDA kernel for CUDA tensors, the plain per-slot loop
            (``ref.pod_step_ref``) for CPU tensors;
    torch   the plain loop on any device;
    cuda    the kernel; CPU tensors raise.

Unlike the JAX wrapper there is no lane/sublane padding and no ``C < 2``
detour: the CUDA kernel masks its own edges and launches at C = 1 too.
Only ThreeSieves has a fused kernel (``fusable``); a pod of the other
sieves (the JAX pod's vmapped ``run_batched`` path) is the next slice of
the port (ROADMAP.md), and ``pod_step`` raises for it.
"""
from __future__ import annotations


import torch

from repro_torch.core.threesieves import ThreeSieves, TSState

from .kernel import pod_step_cuda
from .ref import pod_step_ref

BACKENDS = ("auto", "torch", "cuda")


def fusable(algo) -> bool:
    """Whether ``algo`` has a fused pod-step kernel."""
    return isinstance(algo, ThreeSieves)


def _tables(state: TSState, counts: torch.Tensor, C: int):
    """The (S, 11) int32 and (S, 3) f32 scalar tables of the kernel."""
    ld, hp = state.ld, state.hp
    nv = torch.clamp(counts.to(torch.int32), 0, C)
    ints = torch.stack([
        ld.n, state.j, state.t, state.n_fused, ld.n_queries, nv,
        hp.k_cap, hp.T, hp.ihi, hp.num_rungs, hp.kernel_kind,
    ], dim=-1).to(torch.int32).contiguous()
    flts = torch.stack([ld.fval.to(torch.float32), hp.base, hp.inv2l2],
                       dim=-1).to(torch.float32).contiguous()
    return ints, flts


def _write_back(state: TSState, new: TSState) -> TSState:
    """Copy a stepped state into ``state``'s tensors, in place."""
    old_ld, new_ld = state.ld, new.ld
    for name in ("feats", "L", "Linv", "n", "fval", "n_queries"):
        getattr(old_ld, name).copy_(getattr(new_ld, name))
    for name in ("j", "t", "n_fused"):
        getattr(state, name).copy_(getattr(new, name))
    return state


def pod_step(algo, state: TSState, chunks: torch.Tensor,
             counts: torch.Tensor, *, backend: str = "auto",
             tier: str | None = None, window: int | None = None) -> TSState:
    """Advance every pod session by one chunk, in place; returns ``state``.

    chunks (S, C, d); counts (S,) valid prefixes (clamped to [0, C]).
    ``tier`` / ``window`` force the kernel's layout (``kernel.layout``
    chooses it from K and d); every layout gives the same bits.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} invalid; choose from "
                         f"{BACKENDS}")
    if not fusable(algo):
        raise NotImplementedError(
            f"{type(algo).__name__} has no pod-step kernel (only "
            "ThreeSieves has one)")
    use_kernel = backend == "cuda" or (backend == "auto" and chunks.is_cuda)
    if not use_kernel:
        return _write_back(state, pod_step_ref(algo, state, chunks, counts))
    C = chunks.shape[1]
    ints, flts = _tables(state, counts, C)
    ld = state.ld
    # the chunk rounded to the objective's dtype before any use, as the
    # Pallas body casts it (``chunk_ref[0].astype(dtype)``)
    iout, fval = pod_step_cuda(chunks.to(algo.f.dtype).contiguous(),
                               ld.feats, ld.L, ld.Linv, ints, flts,
                               a=algo.f.a, tier=tier, window=window)
    ld.n.copy_(iout[:, 0])
    state.j.copy_(iout[:, 1])
    state.t.copy_(iout[:, 2])
    state.n_fused.copy_(iout[:, 3])
    ld.n_queries.copy_(iout[:, 4])
    ld.fval.copy_(fval)
    return state
