# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Public pod-step entry (port of ``repro/kernels/pod_step/ops.py``).

``pod_step(algo, state, chunks, counts)`` advances every session of a
pod by one ingest chunk and updates ``state`` IN PLACE, for every
algorithm the JAX pod hosts.  By algorithm:

    ThreeSieves     the fused ``pod_step`` CUDA kernel (``fusable``);
    StackedSieve    (SieveStreaming, SieveStreaming++, Salsa) the batched
                    step ``StackedSieve.run_slots``: every slot at once,
                    one grouped ``gain_traced`` launch per round;
    other           (QuickStream) the per-slot loop ``ref.pod_step_ref``:
                    the JAX pod vmaps a jnp Cholesky there, and no TPU
                    kernel is behind it.

Backends:

    auto    ThreeSieves: the kernel for CUDA tensors, the plain per-slot
            loop for CPU tensors; StackedSieve: ``run_slots`` with the
            objective's gain oracle (the kernel on CUDA tensors, its
            plain version on the CPU);
    torch   the plain per-slot loop on any device;
    cuda    the kernels; CPU tensors, and an algorithm with no kernel,
            raise ``ValueError`` (the reference degrades both to its
            plain path with a warning; the port never falls back, so it
            records no ``backend_fallback_total``).

``resolve(backend, algo, device=)`` names the route: ``cuda`` (the
algorithm's kernels), ``slots`` (``run_slots`` on the objective's own
gain oracle) or ``torch`` (the per-slot loop).  ``backend=None`` reads
the process default, ``REPRO_TORCH_PODSTEP_BACKEND``, else ``auto``: the
port's own variable, which an environment set up for the JAX package
cannot reach.

Unlike the JAX wrapper there is no lane/sublane padding and no ``C < 2``
detour: the CUDA kernel masks its own edges and launches at C = 1 too.
"""
from __future__ import annotations

import dataclasses
import os

import torch

from repro_torch import obs
from repro_torch.core.sieve_family import StackedSieve
from repro_torch.core.threesieves import ThreeSieves, TSState
from repro_torch.tree import copy_into

from .kernel import pod_step_cuda
from .ref import pod_step_ref

BACKENDS = ("auto", "torch", "cuda")
_ENV_VAR = "REPRO_TORCH_PODSTEP_BACKEND"


def default_backend() -> str:
    """Process-wide default: ``REPRO_TORCH_PODSTEP_BACKEND``, else auto."""
    backend = os.environ.get(_ENV_VAR, "auto")
    if backend not in BACKENDS:
        raise ValueError(
            f"{_ENV_VAR}={backend!r} invalid; choose from {BACKENDS}")
    return backend


def fusable(algo) -> bool:
    """Whether ``algo`` has a fused pod-step kernel."""
    return isinstance(algo, ThreeSieves)


def resolve(backend: str | None, algo, *, device) -> str:
    """The route a pod step of ``algo`` on ``device`` takes: ``cuda``,
    ``slots`` or ``torch`` (module docstring); an explicit ``cuda`` that
    cannot be honoured raises ``ValueError`` with the reason."""
    backend = default_backend() if backend is None else backend
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} invalid; choose from "
                         f"{BACKENDS}")
    on_card = torch.device(device).type == "cuda"
    stacked = isinstance(algo, StackedSieve)
    if backend == "cuda":
        if not on_card:
            raise ValueError("pod_step backend 'cuda' needs CUDA tensors, "
                             f"got chunks on {device}")
        if not (fusable(algo) or stacked):
            raise ValueError(f"{type(algo).__name__} has no pod-step "
                             "kernel (ThreeSieves and the stacked sieves "
                             "have); the port does not fall back")
        return "cuda"
    if backend == "auto" and stacked:
        return "slots"
    if backend == "auto" and fusable(algo) and on_card:
        return "cuda"
    return "torch"


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


def pod_step(algo, state, chunks: torch.Tensor,
             counts: torch.Tensor, *, backend: str | None = None,
             tier: str | None = None, window: int | None = None):
    """Advance every pod session by one chunk, in place; returns ``state``.

    chunks (S, C, d); counts (S,) valid prefixes (clamped to [0, C]).
    ``tier`` / ``window`` force the ThreeSieves kernel's layout
    (``kernel.layout`` chooses it from K and d); every layout gives the
    same bits.
    """
    route = resolve(backend, algo, device=chunks.device)
    if route == "torch":
        return copy_into(state, pod_step_ref(algo, state, chunks, counts))
    if isinstance(algo, StackedSieve):
        if route == "cuda":  # the gain kernel whatever the objective says
            algo = dataclasses.replace(
                algo, f=dataclasses.replace(algo.f, backend="cuda"))
        return algo.run_slots(state, chunks, counts)
    C = chunks.shape[1]
    with obs.hot_span("pod_step.tables"):
        ints, flts = _tables(state, counts, C)
    ld = state.ld
    with obs.hot_span("pod_step.kernel"):
        # the chunk rounded to the objective's dtype before any use, as
        # the Pallas body casts it (``chunk_ref[0].astype(dtype)``)
        iout, fval = pod_step_cuda(chunks.to(algo.f.dtype).contiguous(),
                                   ld.feats, ld.L, ld.Linv, ints, flts,
                                   a=algo.f.a, tier=tier, window=window)
    with obs.hot_span("pod_step.unpack"):
        if obs.hot_tracing():  # the most fused passes of any session,
            # worked out when tracing stops from this ingest's columns
            obs.hot_count("pod_step_passes",
                          lambda: (iout[:, 3] - ints[:, 3]).max())
        ld.n.copy_(iout[:, 0])
        state.j.copy_(iout[:, 1])
        state.t.copy_(iout[:, 2])
        state.n_fused.copy_(iout[:, 3])
        ld.n_queries.copy_(iout[:, 4])
        ld.fval.copy_(fval)
    return state
