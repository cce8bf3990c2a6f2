#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one card.

    python3 chip_smoke.py [--seed N] [--ingests N]

Phases, one JSON line each; any failure ends the run with a non-zero
exit and no result line:

  1. build           the five CUDA kernels from the four sources in
                     ``src/repro_torch/csrc`` (one nvcc each, started
                     together), ptxas lines;
  2. gain            ``gain_traced`` against its plain version at B=1024,
                     K=100, d=256, n in {0, 37, 100}, both kernel kinds,
                     two inv2l2 (device time per call: the gain kernel and
                     its first pass over the summaries' norms);
  3. pod_step        the kernel against ``pod_step_ref`` (16 sessions,
                     K=100, d=256, C=1024, three tiers): ragged counts, a
                     C=1 chunk, a saturating chunk, a round after it;
  4. pod             the main path: ``make`` + ``SummarizerPod(S=256,
                     chunk=1024)``, 256 tenants in three tiers, ingests of
                     262,144 tagged items (the first is cold; items/s
                     counts the rest), one ``drift_check`` that re-arms the
                     full summaries before the last ingest, ``readout``;
                     each summary's fval is checked against a float64
                     slogdet and the last ingest is replayed through
                     ``pod_step_ref``;
  5. sieve           standalone ``ThreeSieves.run_batched`` through the
                     gain oracle (``auto`` -> the kernel), 64 chunks of
                     1024 items, against the same run under ``torch``;
  6. gain_static     ``gain_static`` against ``gain_ref``, the cases of
                     ``gain`` at B=65,536 (a Greedy round) and B=1 (an ISI
                     query);
  7. gain_stacked    ``gain_traced`` over I=147 stacked summaries (Salsa
                     at K=100, eps=0.1: 3 rules x 49 rungs), B=1024, and
                     over I=49 of them (SieveStreaming's stack), timed;
  8. pod_step_large  the pod step past what shared memory could hold:
                     8 sessions at K_max=512 (tiers 128/256/512: ragged
                     fill, saturating, after saturation), then one ragged
                     round of 4 sessions at K_max=1024;
  9. paper           the paper's comparison through ``make`` at K=100,
                     d=256 on a drifting stream of tight clusters (rungs
                     reject, ISI and Preemption replace; the phase fails
                     if one of them never did): Greedy over N=65,536
                     items, ThreeSieves,
                     SieveStreaming(++) and Salsa (eps=0.1) with
                     ``run_batched`` over 64 chunks, Random, ISI,
                     Preemption and QuickStream over the first 4,096
                     items; each under ``auto`` (the kernels) and under
                     ``torch``, reported as f / f_greedy;
 10. flash           ``flash_attention`` (the kernel route of
                     ``kernels.flash_attention``) against ``attention_ref``:
                     the Whisper-small encoder shape (B=8, 12 heads,
                     S=1500 padded to 1536, dh=64, bf16, full) with near
                     uniform and with near one-hot attention, causal GQA
                     at qwen2-1.5b's attention shape (12 q / 2 kv heads,
                     dh=128, S=2048, bf16) and a ragged float32 case
                     (S=100); within 2e-4 (f32) / 2e-2 (bf16), and within
                     1e-4 (f32) / 1e-2 (bf16) of the largest output; the
                     kernel told to keep the padded keys must fail that
                     check; timed beside the plain version and
                     ``scaled_dot_product_attention``; the route each
                     dtype ran (bf16: the tensor-core kernel, f32: the
                     CUDA-core one, from the profiler's kernel names), and
                     before it a ``flash_sass`` line counting HGMMA / HMMA
                     in the built library (none fails the run);
 11. whisper         the slice's main path: Whisper-small at full width
                     (seeded parameters) serving 8 requests of 1500 frames
                     and 16 prompt tokens through ``ServeDriver.generate``
                     (32 new tokens, greedy), the encoder's attention on
                     the kernel (12 launches per generate), held against
                     the same run on the plain attention route: in float32
                     the tokens equal and, on three input draws, the
                     encoder output and prefill logits within 1e-4, which
                     the padded-keys fault planted in the encoder must
                     fail; in bfloat16 the logits within 5e-2 (a bound on
                     rounding, which cannot see that fault).  Five
                     generates per route, prefill and decode timed by CUDA
                     events inside each (median and range); the idle share
                     from one profiled generate, in which all 12 bf16
                     encoder launches must be the tensor-core kernel;
 12. ssd             ``ssd_chunk_cuda`` against ``ssd_chunk_ref``: the
                     Mamba2-370m prefill's tiles (b=8, L=2048, 32 heads,
                     p=64, n=128, q=256) in bf16 with Adt = -softplus(N)
                     and in float32 with slow decay (-0.01 softplus(N)),
                     and the reduced config's (q=p=n=16, float32); Y and
                     the states elementwise within 1e-5 (f32) / 2e-2
                     (bf16) and within 1e-5 / 1e-2 of the largest
                     output; the plain version with
                     the diagonal dropped (strict tril) must fail that
                     check in every case; timed beside the plain version
                     (no PyTorch call computes this function);
 13. mamba           the slice's main path: Mamba2-370m at full width
                     (seeded parameters) serving 8 requests of 2000 prompt
                     tokens (padded inside each layer to 8 chunks of 256)
                     through ``ServeDriver.generate`` (32 new tokens,
                     greedy), each layer's prefill on the SSD kernel (48
                     launches per generate, none in decode), held against
                     the plain route (``ssd_chunks`` with backend
                     ``torch``): in float32 the tokens equal and, on three
                     input draws, the prefill logits within 1e-4, which
                     the kernel route fed Adt shifted by one step must
                     fail; in bfloat16 the logits within 5e-2 (a bound on
                     rounding).  Five generates per route, timed as in
                     ``whisper``; the idle share from one profiled
                     generate.

"Held against" (the summarization kernels): integers equal (n, j, t, n_fused,
n_queries, accepted items); floats within rtol = atol = 1e-5 (f32 with a
different summation order at K <= 100).  A run whose accept decisions
first differ at an item whose reference margin
|gain - thr| / max(1, |thr|) is at most 1e-4 is a near-tie: printed, not
failed (for Greedy: a first differing round whose two largest reference
gains are within 1e-4 relative; for Whisper's tokens: a first differing
token whose two largest plain-route logits are within 1e-3 relative).
Then the phases' seconds, the kernels' summary line, the card's name and
power limit, and the result line.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RTOL = ATOL = 1e-5
TIE = 1e-4
PEAK_FP32 = 67e12  # FLOP/s, H100 SXM, CUDA cores (NVIDIA data sheet)
PEAK_BF16 = 989e12  # FLOP/s, H100 SXM, dense bf16 tensor cores (same)
PEAK_BW = 3.35e12  # bytes/s, H100 SXM HBM3
K_MAX, D, CHUNK, SESSIONS = 100, 256, 1024, 256
GREEDY_B = 65536  # a Greedy round over the paper phase's ground set
SALSA_I = 147  # Salsa's stack at K=100, eps=0.1: 3 rules x 49 rungs
SIEVE_I = 49  # SieveStreaming(++)'s stack: 49 rungs
PAPER_CHUNKS, PAPER_EPS, BASELINE_ITEMS = 64, 0.1, 4096
# the paper phase's stream: 8 tight clusters per chunk (in-cluster rbf
# ~exp(-0.09) at the stream lengthscale), drawn afresh for every chunk, so
# summaries fill with near-duplicates, rungs reject, and later chunks
# bring items that ISI and Preemption swap in
PAPER_CLUSTERS, PAPER_SPREAD = 8, 0.3
SPREAD_FAR = 400.0  # items far apart: every one accepted until k_cap
LARGE_PODS = [  # K_max, sessions, tier budgets, rounds (name, item spread)
    (512, 8, (128, 256, 512), [("ragged", 1.0), ("saturate", SPREAD_FAR),
                               ("after_saturation", 1.0)]),
    (1024, 4, (256, 1024), [("ragged", 1.0)]),
]
# phase flash: (name, B, Hq, Hkv, S, dh, causal, dtype, std of q and k).
# The scores' std is the draw's std squared: at 0.5 attention over 1500
# keys is near uniform, at 2 near one-hot.
FLASH_CASES = [
    ("whisper_encoder", 8, 12, 12, 1500, 64, False, "bfloat16", 0.5),
    ("whisper_encoder_peaked", 8, 12, 12, 1500, 64, False, "bfloat16", 2.0),
    ("qwen2_causal_gqa", 1, 12, 2, 2048, 128, True, "bfloat16", 0.5),
    ("ragged_f32", 2, 4, 2, 100, 64, True, "float32", 0.5),
]
FLASH_TOL = {"float32": 2e-4, "bfloat16": 2e-2}  # tests/test_kernels.py
# and against the output's own size, max|got - want| / max|want| (one bf16
# ulp is at most 2^-7 = 7.8e-3 of a value)
FLASH_SCALED_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# the case whose check must fail a planted fault: the kernel told to keep
# the 36 padded keys (near-uniform rows give them about 2 % of the weight)
FLASH_CONTROL = "whisper_encoder"
# phase whisper: slots, prompt tokens, new tokens; timed generates per
# route and dtype; input draws the prefill logits are held on; the logit
# tolerances of the kernel route against the plain one, and the near-tie
# bound of a first differing token (top-2 plain-route logit gap, relative)
WHISPER_B, WHISPER_PROMPT, WHISPER_NEW = 8, 16, 32
WHISPER_REPS, WHISPER_DRAWS = 5, 3
WHISPER_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
TOKEN_TIE = 1e-3
# phase ssd: (name, b, L, h, p, n, q, dtype, decay); Adt = -decay *
# softplus(N(0, 1)) as in tests/test_ssd_kernel.py:15
SSD_CASES = [
    ("mamba2_prefill", 8, 2048, 32, 64, 128, 256, "bfloat16", 1.0),
    ("mamba2_prefill_slow_f32", 8, 2048, 32, 64, 128, 256, "float32", 0.01),
    ("reduced_f32", 2, 64, 8, 16, 16, 16, "float32", 1.0),
]
# elementwise rtol = atol, tests/test_ssd_kernel.py:35; and max|got -
# want| / max|want| (one bf16 ulp is at most 2^-7 = 7.8e-3 of a value)
SSD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SSD_SCALED_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# phase mamba: slots, prompt tokens, new tokens; timed generates per route
# and dtype; input draws; logit tolerances of the kernel route against the
# plain one
MAMBA_B, MAMBA_PROMPT, MAMBA_NEW = 8, 2000, 32
MAMBA_REPS, MAMBA_DRAWS = 5, 3
MAMBA_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
DEV = "cuda"


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def timed_ms(torch, fn, *, reps=20, warmup=3, setup=None):
    """Median over ``reps`` launches, each bracketed by CUDA events."""
    times = []
    for i in range(warmup + reps):
        args = setup() if setup else ()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, kernels, *, reps=20, setup=None, seen=None):
    """Device time (ms) per call of ``fn``: the time of every CUDA kernel
    whose name contains one of ``kernels`` (a name or a tuple: all the
    kernels one call launches, the call's own kernel first), summed and
    divided by the number of calls, from ``torch.profiler`` over ``reps``
    calls.  The profiler may miss the first launches of its window (15 of
    20 seen on the H100), so the calls are counted by the events of the
    call's own kernel, one per call, not taken as ``reps``.  Fails when
    the profiler saw no device time for it.  ``seen`` collects {name:
    count}."""
    from torch.profiler import ProfilerActivity, profile

    kernels = (kernels,) if isinstance(kernels, str) else tuple(kernels)
    argsets = [setup() if setup else () for _ in range(reps)]
    fn(*argsets[0])  # warm
    argsets[0] = setup() if setup else ()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for args in argsets:
            fn(*args)
        torch.cuda.synchronize()
    total, calls = 0.0, 0
    for ev in prof.key_averages():
        if any(k in ev.key for k in kernels):
            t = getattr(ev, "self_device_time_total", None)
            if t is None:
                t = getattr(ev, "self_cuda_time_total", 0.0)
            total += t
            if kernels[0] in ev.key:
                calls += ev.count
            if seen is not None and t > 0:
                seen[ev.key[:90]] = seen.get(ev.key[:90], 0) + ev.count
    if not calls or total <= 0:
        fail(f"the profiler saw no device time for {kernels[0]}")
    return total / calls / 1e3


def host_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def bound(flops, nbytes, peak=PEAK_FP32):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BW
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# the kernels one gain call launches: the summaries' norms, then the pass
GAIN_TRACED_KERNELS = ("gain_traced_kernel", "gain_norms_kernel")
GAIN_STATIC_KERNELS = ("gain_static_kernel", "gain_norms_kernel")
FLASH_KERNELS = ("flash_attention_kernel", "flash_attention_wgmma_kernel")


def gain_work(B, ns):
    """The least work of pricing B candidates against summaries of ns
    live rows -> (FLOP, bytes): per candidate and summary the Gram row
    (2 d n), the kernel values (~10 n) and the whitening against the
    lower-triangular Linv[:n, :n] (n (n + 1)); one read of the candidates,
    of each summary's live rows and live Linv triangle, one write of each
    gain."""
    flops = sum(B * (2 * D * n + n * (n + 1) + 10 * n) for n in ns)
    nbytes = 4 * (B * D + sum(n * D + n * (n + 1) // 2 for n in ns)
                  + B * len(ns))
    return flops, nbytes


TIERS = {  # name: (K, T, eps, lengthscale rule)
    "small": (10, 500, 0.05, "batch"),
    "default": (50, 1000, 0.01, "stream"),
    "pro": (100, 2500, 0.005, "stream"),
}


def tier_of(i):
    """Tenant i's tier and kernel kind: tiers in rotation; one third of
    the pro tenants use linear_norm."""
    name = ("small", "default", "pro")[i % 3]
    kind = "linear_norm" if name == "pro" and (i // 3) % 3 == 0 else "rbf"
    return name, kind


def spec_of(i):
    from repro_torch.core.functions import (rbf_lengthscale_batch,
                                            rbf_lengthscale_stream)
    from repro_torch.core.spec import SessionSpec

    name, kind = tier_of(i)
    K, T, eps, ls = TIERS[name]
    ls = (rbf_lengthscale_batch if ls == "batch"
          else rbf_lengthscale_stream)(D)
    return SessionSpec(K=K, T=T, eps=eps, d=D, lengthscale=ls,
                       kernel_kind=kind)


def mixture(torch, gen, n, *, clusters=64, spread=1.0):
    """Gaussian mixture at the scale of the paper's kernels: in-cluster
    rbf values ~exp(-spread^2) at the stream lengthscale 1/sqrt(d),
    across clusters ~exp(-4 - spread^2)."""
    centers = (2.0 / D) * torch.randn(clusters, D, generator=gen,
                                      device=DEV)
    z = torch.randint(0, clusters, (n,), generator=gen, device=DEV)
    return (centers[z] + (spread / D) * torch.randn(n, D, generator=gen,
                                                    device=DEV)).float()


# --------------------------------------------------------------- comparing
def accepted_at(torch, rows, chunk):
    """Chunk positions of appended summary rows (an appended row is a
    bit copy of its item)."""
    if rows.shape[0] == 0:
        return []
    hit = (chunk[:, None, :] == rows[None]).all(-1)
    return hit.to(torch.uint8).argmax(0).tolist()


def pod_work(torch, before, after, chunks, margins):
    """The least work one pod step's data needs -> (FLOP, bytes).

    FLOP: every item the step decided, priced once against the n summary
    rows it was decided at (Gram row 2 d n, kernel values, whitening
    against the lower-triangular Linv[:n, :n], n (n + 1)); every append
    at row m (kernel row 2 d m, c = Linv u and the new Linv row, both
    triangular, m (m + 1) each).  Bytes: one read of the decided items,
    of the live rows [0, n0) of feats and of the live triangle of Linv;
    one write of each new row's live part (feats d, L and Linv m + 1
    each); the scalar tables.  A session that decided nothing (a full
    summary, or no items) moves only its tables."""
    import bisect

    S, _, d = chunks.shape
    flops = nbytes = 0.0
    n0s, n1s = before.ld.n.tolist(), after.ld.n.tolist()
    for s in range(S):
        nbytes += 4 * 20  # scalar tables in and out
        decided = sorted(margins[s])
        if not decided:
            continue
        n0, n1 = n0s[s], n1s[s]
        acc = sorted(accepted_at(torch, after.ld.feats[s, n0:n1], chunks[s]))
        for p in decided:
            n = n0 + bisect.bisect_left(acc, p)
            flops += 2 * d * n + n * (n + 1) + 10 * n
        flops += sum(2 * d * m + 2 * m * (m + 1) for m in range(n0, n1))
        nbytes += 4 * (len(decided) * d + n0 * d + n0 * (n0 + 1) // 2
                       + sum(d + 2 * (m + 1) for m in range(n0, n1)))
    return flops, nbytes


def compare_sessions(torch, ker, ref, chunks, n_before, margins, what):
    """Hold a kernel-stepped stacked TSState against the reference under
    the near-tie rule -> (max abs float error, [near-tie sessions])."""
    ties, err = [], 0.0
    S = chunks.shape[0]
    for s in range(S):
        ints_k = [int(ker.ld.n[s]), int(ker.j[s]), int(ker.t[s]),
                  int(ker.n_fused[s]), int(ker.ld.n_queries[s])]
        ints_r = [int(ref.ld.n[s]), int(ref.j[s]), int(ref.t[s]),
                  int(ref.n_fused[s]), int(ref.ld.n_queries[s])]
        nk, nr = ints_k[0], ints_r[0]
        same_rows = nk == nr and torch.equal(ker.ld.feats[s, :nk],
                                             ref.ld.feats[s, :nr])
        if ints_k != ints_r or not same_rows:
            nb = int(n_before[s])
            diff = (set(accepted_at(torch, ker.ld.feats[s, nb:nk], chunks[s]))
                    ^ set(accepted_at(torch, ref.ld.feats[s, nb:nr],
                                      chunks[s])))
            if not diff:
                fail(f"{what}: session {s} integers differ (kernel "
                     f"{ints_k}, reference {ints_r}) with the same "
                     "accepted items")
            first = min(diff)
            m = margins[s].get(first)
            if m is None or m > TIE:
                fail(f"{what}: session {s} accepts differ first at item "
                     f"{first} with reference margin {m} (> {TIE}); "
                     f"kernel {ints_k}, reference {ints_r}")
            ties.append({"session": s, "item": first, "margin": m})
            continue
        for name in ("L", "Linv"):
            a, b = getattr(ker.ld, name)[s], getattr(ref.ld, name)[s]
            if not torch.allclose(a, b, rtol=RTOL, atol=ATOL):
                fail(f"{what}: session {s} {name} off by "
                     f"{(a - b).abs().max().item()}")
            err = max(err, (a - b).abs().max().item())
        fk, fr = ker.ld.fval[s], ref.ld.fval[s]
        if not torch.allclose(fk, fr, rtol=RTOL, atol=ATOL):
            fail(f"{what}: session {s} fval {fk.item()} vs {fr.item()}")
        err = max(err, (fk - fr).abs().item())
    return err, ties


def resync(ker, ref, sessions):
    """Copy the reference rows of near-tie sessions into the kernel state,
    so later rounds compare from the same state."""
    from repro_torch.tree import leaves_with_keys

    rk, rr = leaves_with_keys(ker), leaves_with_keys(ref)
    for s in sessions:
        for key in rk:
            rk[key][s].copy_(rr[key][s])


def clone_state(state):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.clone(), state)


# ------------------------------------------------------------------ phases
def phase_build(torch):
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import KERNEL as FLASH
    from repro_torch.kernels.pod_step import KERNEL as POD
    from repro_torch.kernels.rbf_gain import KERNEL as GAIN
    from repro_torch.kernels.rbf_gain import KERNEL_STATIC as STATIC
    from repro_torch.kernels.ssd_chunk import KERNEL as SSD

    kernels = (GAIN, STATIC, POD, FLASH, SSD)
    t0 = time.perf_counter()
    build.build_all(list(kernels))
    sources = {k.source.name: k for k in kernels}  # gain kernels share one
    ptxas = [f"{entry}: {' '.join(ln.strip() for ln in info)}"
             for k in sources.values()
             for entry, info in _ptxas_entries(k.ptxas_log)]
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         per_source_seconds={name: k.build_seconds
                             for name, k in sources.items()},
         ptxas=ptxas, nvcc=build.nvcc_path())


def _ptxas_entries(log):
    """(kernel<template arguments>, [spill line, registers line]) per
    entry function of a ``-Xptxas -v`` log."""
    import re

    out = []
    for ln in log.splitlines():
        if "Function properties for" in ln:
            m = re.search(r"([a-z_]+_kernel)(I((?:Li\d+E|f)+)E)?", ln)
            name = m.group(1) if m else ln.split()[-1]
            if m and m.group(3):
                args = re.findall(r"Li(\d+)E|(f)", m.group(3))
                name += "<" + ",".join(a or "float" for a, _ in args) + ">"
            out.append((name, []))
        elif out and ("registers" in ln or "spill" in ln):
            out[-1][1].append(ln.replace("ptxas info    :", "").strip())
    return out


def _summary_state(torch, f, kern, X, n):
    """A LogDet state holding the first n rows of X (plain appends)."""
    st = f.init()
    for i in range(n):
        st = f.append(st, X[i], kern)
    return st


def phase_gain(torch, gen):
    from repro_torch.core.functions import KernelConfig, LogDet
    from repro_torch.kernelmath import KernelParams
    from repro_torch.kernels.rbf_gain import gain_traced, gain_traced_ref

    f = LogDet(K=K_MAX, d=D, kernel=KernelConfig("rbf", 1.0), backend="torch",
               device=DEV)
    B = 1024
    X = mixture(torch, gen, B)
    pool = mixture(torch, gen, K_MAX)
    cases, max_err, timing = [], 0.0, None
    for kind in (0, 1):
        for inv2l2 in (D / 2.0, 2.0 * D):  # stream and batch lengthscales
            kern = KernelParams(
                inv2l2=torch.tensor(inv2l2, dtype=torch.float32,
                                    device=DEV),
                kind_id=torch.tensor(kind, dtype=torch.int32, device=DEV))
            for n in (0, 37 * K_MAX // 100, K_MAX):
                st = _summary_state(torch, f, kern, pool, n)
                nt = torch.tensor([n], dtype=torch.int32, device=DEV)
                args = (X, st.feats, st.Linv, nt, kern.inv2l2.reshape(1),
                        kern.kind_id.reshape(1))
                got = gain_traced(*args, a=f.a)
                want = gain_traced_ref(X, st.feats, st.Linv, nt[0], kern,
                                       a=f.a)
                torch.cuda.synchronize()
                if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
                    fail(f"gain_traced kind={kind} inv2l2={inv2l2} n={n}: "
                         f"max err {(got - want).abs().max().item()}")
                e = (got - want).abs().max().item()
                max_err = max(max_err, e)
                cases.append({"kind": kind, "inv2l2": inv2l2, "n": n,
                              "max_abs_err": e})
                if kind == 0 and inv2l2 == D / 2.0 and n == K_MAX:
                    call = timed_ms(torch, lambda: gain_traced(*args, a=f.a))
                    dev = device_ms(torch, lambda: gain_traced(*args, a=f.a),
                                    GAIN_TRACED_KERNELS)
                    plain = timed_ms(torch, lambda: gain_traced_ref(
                        X, st.feats, st.Linv, nt[0], kern, a=f.a))
                    b_ms, b_by = bound(*gain_work(B, [n]))
                    timing = {"ms": dev, "call_ms": call,
                              "plain_ms": plain, "bound_ms": b_ms,
                              "bound_by": b_by, "shape": [B, K_MAX, D, n]}
    emit("gain", cases=cases, max_abs_err=max_err, **timing)
    return {"max_abs_err": max_err, **timing}


def _refactored(torch, f, pool, n):
    """A LogDet state holding rows [0, n) of ``pool`` (one factorization,
    batched when ``n`` is a tensor of counts)."""
    return f.refactor(pool, torch.as_tensor(n, dtype=torch.int32,
                                            device=DEV))


def phase_gain_static(torch, gen):
    from repro_torch.core.functions import KernelConfig, LogDet
    from repro_torch.kernels.rbf_gain import gain_ref, gain_static

    X = mixture(torch, gen, GREEDY_B)
    pool = mixture(torch, gen, K_MAX)
    cases, max_err, timing = [], 0.0, {}
    for kind in ("rbf", "linear_norm"):
        for inv2l2 in (D / 2.0, 2.0 * D):  # stream and batch lengthscales
            ls = (2.0 * inv2l2) ** -0.5
            f = LogDet(K=K_MAX, d=D, kernel=KernelConfig(kind, ls),
                       device=DEV)
            for n in (0, 37 * K_MAX // 100, K_MAX):
                st = _refactored(torch, f, pool, n)
                nt = st.n.reshape(1)
                mask = (torch.arange(K_MAX, device=DEV) < n).float()[None]
                for B in (GREEDY_B, 1):
                    x = X[:B]

                    def kern(x=x):
                        return gain_static(x, st.feats, st.Linv, nt, a=f.a,
                                           inv2l2=inv2l2, kind=kind)

                    def plain(x=x):
                        return gain_ref(x, st.feats, st.Linv, mask, a=f.a,
                                        inv2l2=inv2l2, kind=kind)[:, 0]

                    got, want = kern(), plain()
                    torch.cuda.synchronize()
                    e = (got - want).abs().max().item()
                    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
                        fail(f"gain_static kind={kind} inv2l2={inv2l2} "
                             f"n={n} B={B}: max err {e}")
                    max_err = max(max_err, e)
                    cases.append({"kind": kind, "inv2l2": inv2l2, "n": n,
                                  "B": B, "max_abs_err": e})
                    if kind == "rbf" and inv2l2 == D / 2.0 and n == K_MAX:
                        b_ms, b_by = bound(*gain_work(B, [n]))
                        timing[B] = {
                            "ms": device_ms(torch, kern,
                                            GAIN_STATIC_KERNELS),
                            "call_ms": timed_ms(torch, kern),
                            "plain_ms": timed_ms(torch, plain),
                            "bound_ms": b_ms, "bound_by": b_by,
                            "shape": [B, K_MAX, D, n]}
    emit("gain_static", cases=cases, max_abs_err=max_err,
         greedy_round=timing[GREEDY_B], isi_query=timing[1],
         library_ms=None,
         library="none: no single PyTorch call computes the gain pass")
    return {"max_abs_err": max_err, **timing[GREEDY_B]}


def phase_gain_stacked(torch, gen):
    from repro_torch.core.functions import (KernelConfig, LogDet,
                                            rbf_lengthscale_stream)
    from repro_torch.kernelmath import KernelParams
    from repro_torch.kernels.rbf_gain import gain_traced, gain_traced_ref

    B = CHUNK
    f = LogDet(K=K_MAX, d=D, kernel=KernelConfig(
        "rbf", rbf_lengthscale_stream(D)), device=DEV)
    pool = mixture(torch, gen, SALSA_I * K_MAX).reshape(SALSA_I, K_MAX, D)
    ns = [i % (K_MAX + 1) for i in range(SALSA_I)]
    st = _refactored(torch, f, pool, ns)
    X = mixture(torch, gen, B)
    cases, max_err, timing = [], 0.0, None
    for kind in (0, 1):
        kern = KernelParams(
            inv2l2=torch.tensor(D / 2.0, dtype=torch.float32, device=DEV),
            kind_id=torch.tensor(kind, dtype=torch.int32, device=DEV))

        def kernel(kern=kern):
            return gain_traced(X, st.feats, st.Linv, st.n,
                               kern.inv2l2.reshape(1),
                               kern.kind_id.reshape(1), a=f.a)

        def plain(kern=kern):
            return gain_traced_ref(X, st.feats, st.Linv, st.n, kern, a=f.a)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        if got.shape != (SALSA_I, B) or not torch.allclose(
                got, want, rtol=RTOL, atol=ATOL):
            fail(f"gain_traced (I={SALSA_I}) kind={kind}: shape "
                 f"{tuple(got.shape)}, max err {e}")
        max_err = max(max_err, e)
        cases.append({"kind": kind, "max_abs_err": e})
        if kind == 0:
            b_ms, b_by = bound(*gain_work(B, ns))
            timing = {"ms": device_ms(torch, kernel, GAIN_TRACED_KERNELS),
                      "call_ms": timed_ms(torch, kernel),
                      "plain_ms": timed_ms(torch, plain),
                      "bound_ms": b_ms, "bound_by": b_by,
                      "shape": [SALSA_I, B, K_MAX, D]}
            # SieveStreaming's stack (I = 49, one rule): every third
            # instance, so its n spread like Salsa's
            sub = [t[::3].contiguous() for t in (st.feats, st.Linv, st.n)]
            got = gain_traced(X, *sub, kern.inv2l2.reshape(1),
                              kern.kind_id.reshape(1), a=f.a)
            want = gain_traced_ref(X, *sub, kern, a=f.a)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            if got.shape != (SIEVE_I, B) or not torch.allclose(
                    got, want, rtol=RTOL, atol=ATOL):
                fail(f"gain_traced (I={SIEVE_I}): shape {tuple(got.shape)},"
                     f" max err {e}")
            max_err = max(max_err, e)
            sb_ms, sb_by = bound(*gain_work(B, ns[::3]))
            timing["sieve"] = {
                "ms": device_ms(torch, lambda: gain_traced(
                    X, *sub, kern.inv2l2.reshape(1), kern.kind_id.reshape(1),
                    a=f.a), GAIN_TRACED_KERNELS),
                "plain_ms": timed_ms(torch, lambda: gain_traced_ref(
                    X, *sub, kern, a=f.a)),
                "bound_ms": sb_ms, "bound_by": sb_by, "max_abs_err": e,
                "shape": [SIEVE_I, B, K_MAX, D]}
    emit("gain_stacked", instances=SALSA_I, cases=cases, max_abs_err=max_err,
         **timing)
    return {"max_abs_err": max_err, **timing}


def _pod_algos(torch):
    from repro_torch.core.api import make
    from repro_torch.core.functions import rbf_lengthscale_stream
    from repro_torch.core.spec import SessionSpec

    base = SessionSpec(K=K_MAX, T=1000, eps=0.01, d=D,
                       lengthscale=rbf_lengthscale_stream(D))
    return (make(base, device=DEV),
            make(base.replace(backend="torch"), device=DEV))


def _stacked_tiers(torch, algo, S):
    from repro_torch.tree import tree_map

    rows = []
    for i in range(S):
        sp = spec_of(i)
        rows.append(algo.init(algo.hyper(
            K=sp.K, T=sp.T, eps=sp.eps, lengthscale=sp.lengthscale,
            kernel_kind=sp.kernel_kind)))
    return tree_map(lambda *xs: torch.stack(xs), *rows)


def phase_pod_step(torch, gen):
    from repro_torch.kernels.pod_step import pod_step, pod_step_ref

    algo, algo_ref = _pod_algos(torch)
    S = 16
    ker = _stacked_tiers(torch, algo, S)
    ref = clone_state(ker)
    rounds = []
    plan = [("ragged", CHUNK, 1.0), ("c1", 1, 1.0),
            ("saturate", CHUNK, SPREAD_FAR), ("after_saturation", CHUNK, 1.0)]
    max_err = 0.0
    for name, C, spread in plan:
        chunks = mixture(torch, gen, S * C, spread=spread).reshape(S, C, D)
        if name == "saturate":
            counts = torch.full((S,), C, dtype=torch.int32, device=DEV)
        else:
            counts = torch.randint(0, C + 1, (S,), generator=gen,
                                   device=DEV).to(torch.int32)
            counts[0], counts[1] = 0, C
        n_before = ker.ld.n.clone()
        before = clone_state(ker)
        ms = timed_ms(torch, lambda s: pod_step(algo, s, chunks, counts,
                                                backend="cuda"),
                      reps=5, warmup=1, setup=lambda: (clone_state(before),))
        pod_step(algo, ker, chunks, counts, backend="cuda")
        margins = [dict() for _ in range(S)]
        plain_ms, ref = host_ms(torch, lambda: pod_step_ref(
            algo_ref, ref, chunks, counts, margins=margins))
        err, ties = compare_sessions(torch, ker, ref, chunks, n_before,
                                     margins, f"pod_step {name}")
        resync(ker, ref, [t["session"] for t in ties])
        max_err = max(max_err, err)
        rounds.append({"round": name, "C": C, "ms": ms, "plain_ms": plain_ms,
                       "max_abs_err": err, "near_ties": ties,
                       "n": ker.ld.n.tolist()})
    rbf = ker.hp.kernel_kind == 0  # linear_norm rows never get far apart
    if not bool((ker.ld.n == ker.hp.k_cap)[rbf].all()):
        fail("pod_step: the saturating round left an rbf summary below "
             "k_cap")
    emit("pod_step", sessions=S, rounds=rounds, max_abs_err=max_err)
    return max_err


def once_ms(torch, fn):
    """One call bracketed by CUDA events (for calls that change state)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def phase_pod_step_large(torch, gen):
    """The pod step against ``pod_step_ref`` where a session's state is
    far past shared memory: K_max = 512 over three rounds, then one round
    at K_max = 1024."""
    from repro_torch.core.api import make
    from repro_torch.core.functions import rbf_lengthscale_stream
    from repro_torch.core.spec import SessionSpec
    from repro_torch.kernels.pod_step import layout, pod_step, pod_step_ref
    from repro_torch.tree import tree_map

    rounds, max_err, state_mb = [], 0.0, {}
    for k_max, S, tiers, plan in LARGE_PODS:
        bt, smem = layout(k_max)
        spec = SessionSpec(K=k_max, T=1000, eps=0.01, d=D,
                           lengthscale=rbf_lengthscale_stream(D))
        algo = make(spec, device=DEV)
        algo_ref = make(spec.replace(backend="torch"), device=DEV)
        ker = tree_map(lambda *xs: torch.stack(xs), *[
            algo.init(algo.hyper(K=tiers[i % len(tiers)],
                                 kernel_kind=("linear_norm" if i % 4 == 3
                                              else "rbf")))
            for i in range(S)])
        ref = clone_state(ker)
        state_mb[k_max] = 4 * S * (k_max * D + 2 * k_max * k_max) / 1e6
        for name, spread in plan:
            chunks = mixture(torch, gen, S * CHUNK,
                             spread=spread).reshape(S, CHUNK, D)
            if name == "saturate":
                counts = torch.full((S,), CHUNK, dtype=torch.int32,
                                    device=DEV)
            else:
                counts = torch.randint(0, CHUNK + 1, (S,), generator=gen,
                                       device=DEV).to(torch.int32)
                counts[0] = CHUNK
            before = clone_state(ker)
            ms = once_ms(torch, lambda: pod_step(algo, ker, chunks, counts,
                                                 backend="cuda"))
            margins = [dict() for _ in range(S)]
            plain_ms, ref = host_ms(torch, lambda: pod_step_ref(
                algo_ref, ref, chunks, counts, margins=margins))
            err, ties = compare_sessions(torch, ker, ref, chunks,
                                         before.ld.n, margins,
                                         f"pod_step K_max={k_max} {name}")
            flops, nbytes = pod_work(torch, before, ker, chunks, margins)
            resync(ker, ref, [t["session"] for t in ties])
            max_err = max(max_err, err)
            b_ms, b_by = bound(flops, nbytes)
            rounds.append({"K_max": k_max, "bt": bt,
                           "smem_bytes": smem, "sessions": S, "round": name,
                           "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": b_ms, "bound_by": b_by,
                           "max_abs_err": err, "near_ties": ties,
                           "n": ker.ld.n.tolist()})
            if name == "saturate":
                rbf = ker.hp.kernel_kind == 0
                if not bool((ker.ld.n == ker.hp.k_cap)[rbf].all()):
                    fail("pod_step_large: the saturating round left an rbf "
                         "summary below k_cap")
    emit("pod_step_large", rounds=rounds, max_abs_err=max_err,
         state_mb=state_mb)
    return {"max_abs_err": max_err, "rounds": rounds}


def phase_pod(torch, gen, ingests):
    from repro_torch.core.functions import KernelConfig, naive_logdet
    from repro_torch.kernels.pod_step import KERNEL as POD
    from repro_torch.kernels.pod_step import pod_step, pod_step_ref
    from repro_torch.kernels.rbf_gain import KERNEL as GAIN
    from repro_torch.serve.summarize import SummarizerPod

    algo, algo_ref = _pod_algos(torch)
    pod = SummarizerPod(algo=algo, sessions=SESSIONS, chunk=CHUNK, device=DEV)
    state = pod.init()
    sids = torch.arange(1000, 1000 + SESSIONS, dtype=torch.int32,
                        device=DEV)
    for i in range(SESSIONS):
        state, _, ok = pod.admit(state, 1000 + i, spec=spec_of(i))
        if not bool(ok):
            fail(f"admit of tenant {i} refused")
    N = SESSIONS * CHUNK
    batches = []
    for _ in range(ingests):
        perm = torch.randperm(N, generator=gen, device=DEV)
        batches.append((sids.repeat_interleave(CHUNK)[perm],
                        mixture(torch, gen, N)))
    torch.cuda.synchronize()

    POD.launches = GAIN.launches = 0  # the main path starts here
    per_ingest, route_ms, step_ms, last = [], [], [], None
    resets = None
    for b, (tags, X) in enumerate(batches):
        if b == ingests - 1:
            # every summary is full by now and accepts nothing more, so
            # its windowed accept rate is far below 5%: all re-armed, and
            # the last ingest refills them (the paper's re-selection)
            state, mask = pod.drift_check(state, min_items=(ingests - 1)
                                          * CHUNK, min_rate=0.05)
            resets = int(mask.sum())
            last = (clone_state(state.algo), tags, X)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        routed = pod.route(state, tags, X)
        ev[1].record()
        state, info = pod.ingest_routed(state, *routed)
        ev[2].record()
        torch.cuda.synchronize()
        per_ingest.append((time.perf_counter() - t0) * 1e3)
        route_ms.append(ev[0].elapsed_time(ev[1]))
        step_ms.append(ev[1].elapsed_time(ev[2]))
    out = pod.readout(state)
    torch.cuda.synchronize()
    launches = {"pod_step": POD.launches, "gain_traced": GAIN.launches}

    if resets != SESSIONS:
        fail(f"drift_check re-armed {resets} of {SESSIONS} full sessions")
    if launches["pod_step"] != ingests:
        fail(f"pod_step launched {launches['pod_step']} times over "
             f"{ingests} ingests")
    drops = int(out.drops["overflow"].sum()) + int(out.drops["unknown"])
    if drops:
        fail(f"{drops} items dropped")
    n = out.n.tolist()
    k_cap = out.specs.k_cap.tolist()
    tiers = {}
    for i in range(SESSIONS):
        name, kind = tier_of(i)
        if not 0 < n[i] <= k_cap[i]:
            fail(f"tenant {i} ({name}) holds {n[i]} items, cap {k_cap[i]}")
        tiers.setdefault(name, []).append(n[i])
    if not bool(torch.isfinite(out.fval).all()):
        fail("non-finite fval")
    # f(S) = 1/2 logdet(I + a K_SS) in float64, per session
    fe = 0.0
    kinds = out.specs.kernel_kind.tolist()
    ls = out.specs.lengthscale.tolist()
    for i in range(SESSIONS):
        kc = KernelConfig("rbf" if kinds[i] == 0 else "linear_norm", ls[i])
        want = naive_logdet(out.feats[i, :n[i]].double(), kc, algo.f.a)
        got = out.fval[i].double()
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
            fail(f"tenant {i}: fval {got.item()} vs slogdet {want.item()}")
        fe = max(fe, (got - want).abs().item())

    # the last ingest once more, kernel against reference, same inputs
    algo_state, tags, X = last
    chunks, counts, _, _ = pod.route(state, tags, X)
    ker = clone_state(algo_state)
    call = timed_ms(torch, lambda s: pod_step(algo, s, chunks, counts,
                                              backend="cuda"),
                    reps=5, warmup=1, setup=lambda: (clone_state(algo_state),))
    dev = device_ms(torch, lambda s: pod_step(algo, s, chunks, counts,
                                              backend="cuda"),
                    "pod_step_kernel", reps=5,
                    setup=lambda: (clone_state(algo_state),))
    pod_step(algo, ker, chunks, counts, backend="cuda")
    margins = [dict() for _ in range(SESSIONS)]
    plain_ms, ref = host_ms(torch, lambda: pod_step_ref(
        algo_ref, clone_state(algo_state), chunks, counts, margins=margins))
    err, ties = compare_sessions(torch, ker, ref, chunks, algo_state.ld.n,
                                 margins, "pod_step (main-path shape)")
    flops, nbytes = pod_work(torch, algo_state, ker, chunks, margins)
    b_ms, b_by = bound(flops, nbytes)
    warm_s = sum(per_ingest[1:]) / 1e3  # the first ingest is cold
    emit("pod", sessions=SESSIONS, K=K_MAX, d=D, chunk=CHUNK,
         ingests=ingests, items_per_ingest=N,
         items_per_s=(ingests - 1) * N / warm_s,
         items_per_s_cold_first=N / (per_ingest[0] / 1e3),
         ms_per_ingest=per_ingest,
         route_ms=route_ms, pod_step_ms=step_ms, launches=launches,
         accepts=int(state.accepts.sum()),
         n_fused=int(state.algo.n_fused.sum()), drift_resets=resets,
         summary_sizes={k: [min(v), max(v), sum(v) / len(v)]
                        for k, v in tiers.items()},
         fval_vs_slogdet_max_err=fe,
         replay={"ms": dev, "call_ms": call,
                 "plain_ms": plain_ms, "max_abs_err": err,
                 "near_ties": ties, "bound_ms": b_ms, "bound_by": b_by,
                 "flops": flops, "bytes": nbytes},
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return {"launches": launches["pod_step"], "ms": dev, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
            "ties": ties}


def phase_sieve(torch, gen):
    from repro_torch.core.api import make
    from repro_torch.core.functions import rbf_lengthscale_stream
    from repro_torch.core.spec import SessionSpec
    from repro_torch.kernels.rbf_gain import KERNEL as GAIN
    from repro_torch.tree import tree_map

    spec = SessionSpec(K=K_MAX, T=1000, eps=0.01, d=D,
                       lengthscale=rbf_lengthscale_stream(D))
    algo = make(spec, device=DEV)  # oracle backend auto: the kernel
    algo_ref = make(spec.replace(backend="torch"), device=DEV)
    chunks = [mixture(torch, gen, CHUNK) for _ in range(64)]
    stk = lambda s: tree_map(lambda t: t[None], s)  # noqa: E731
    st, st_ref = algo.init(), algo_ref.init()
    ties, err, passes = [], 0.0, 0
    GAIN.launches = 0  # the standalone path starts here
    t0 = time.perf_counter()
    for i, X in enumerate(chunks):
        nb = st.ld.n.reshape(1).clone()
        st = algo.run_batched(st, X)
        margins = {}
        st_ref = algo_ref.run_batched(st_ref, X, margins=margins)
        e, t = compare_sessions(torch, stk(st), stk(st_ref), X[None], nb,
                                [margins], f"run_batched chunk {i}")
        err = max(err, e)
        if t:
            ties.append({"chunk": i, **t[0]})
            st = st_ref
    torch.cuda.synchronize()
    launches = GAIN.launches
    if launches == 0:
        fail("run_batched never launched gain_traced")
    passes = int(st.n_fused)
    emit("sieve", chunks=64, launches=launches, n_fused=passes,
         n=int(st.ld.n), fval=float(st.ld.fval), max_abs_err=err,
         near_ties=ties, seconds_with_reference=time.perf_counter() - t0)
    return {"launches": launches, "max_abs_err": err, "ties": ties}


def _instances(state):
    """(feats (I, K, d), n list) of the summaries a state holds, or None
    (QuickStream's ring)."""
    for attr in ("lds", "ld"):
        if hasattr(state, attr):
            state = getattr(state, attr)
            break
    if not (hasattr(state, "feats") and hasattr(state, "n")):
        return None
    if state.feats.dim() == 2:
        return state.feats[None], [int(state.n)]
    return state.feats, state.n.tolist()


# the algorithms whose summaries leave the stream's prefix only by
# rejecting (the sieve family) or replacing (ISI, Preemption) an item
SKIPPERS = ("threesieves", "sievestreaming", "sievestreaming++", "salsa",
            "independentsetimprovement", "preemptionstreaming")


def _not_prefix(torch, state, X) -> int:
    """Instances of a state whose summary is not the first n items of the
    stream X: each of them rejected or replaced at least one item."""
    feats, ns = _instances(state)
    return sum(not torch.equal(feats[i, :n], X[:n]) for i, n in enumerate(ns))


def _queries(state) -> int:
    """Oracle queries a state counted (Random counts none)."""
    if hasattr(state, "n_queries"):
        return int(state.n_queries)
    return int(state.ld.n_queries) if hasattr(state, "ld") else 0


def hold_states(torch, ker, ref, before, X, margins, what):
    """Hold a kernel-run algorithm state against the reference run on the
    same chunk -> (max abs float error, near-tie or None).  Integers
    equal, floats within tolerance; where they are not, the first item
    any summary accepted in one run and not the other must be a near-tie
    of the reference (``margins``), or the run fails."""
    from repro_torch.tree import leaves_with_keys

    lk, lr = leaves_with_keys(ker), leaves_with_keys(ref)
    err, bad = 0.0, []
    for key in lk:
        a, b = lk[key], lr[key]
        if a.dtype.is_floating_point:
            if a.shape == b.shape and torch.allclose(a, b, rtol=RTOL,
                                                     atol=ATOL):
                if a.numel():
                    err = max(err, (a - b).abs().max().item())
                continue
        elif torch.equal(a, b):
            continue
        bad.append(key)
    if not bad:
        return err, None
    if _instances(ker) is None:
        fail(f"{what}: leaves {bad} differ")
    fk, nk = _instances(ker)
    fr, nr = _instances(ref)
    _, nb = _instances(before)
    diff = set()
    for i, n0 in enumerate(nb):
        diff |= (set(accepted_at(torch, fk[i, n0:nk[i]], X))
                 ^ set(accepted_at(torch, fr[i, n0:nr[i]], X)))
    if not diff:
        fail(f"{what}: leaves {bad} differ with the same accepted items")
    first = min(diff)
    m = margins.get(first)
    if m is None or m > TIE:
        fail(f"{what}: accepts differ first at item {first} with reference "
             f"margin {m} (> {TIE}); leaves {bad}")
    return err, {"item": first, "margin": m}


def _counted(torch, kernels, fn):
    """Run ``fn`` with every kernel's count set to 0 just before -> (out,
    seconds, {kernel: launches})."""
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, {k.name: k.launches
                                           for k in kernels}


def phase_paper(torch, gen):
    """The paper's comparison on the card, f / f_greedy per algorithm."""
    from repro_torch.core.api import make
    from repro_torch.core.functions import (KernelConfig, naive_logdet,
                                            rbf_lengthscale_stream)
    from repro_torch.core.spec import SessionSpec
    from repro_torch.kernels.pod_step import KERNEL as POD
    from repro_torch.kernels.rbf_gain import KERNEL as GAIN
    from repro_torch.kernels.rbf_gain import KERNEL_STATIC as STATIC

    kernels = (GAIN, STATIC, POD)
    ls = rbf_lengthscale_stream(D)
    base = SessionSpec(K=K_MAX, d=D, a=1.0, lengthscale=ls, eps=PAPER_EPS,
                       T=1000, c=4)
    chunks = [mixture(torch, gen, CHUNK, clusters=PAPER_CLUSTERS,
                      spread=PAPER_SPREAD) for _ in range(PAPER_CHUNKS)]
    X = torch.cat(chunks)
    Xb = X[:BASELINE_ITEMS]
    N = X.shape[0]

    def pair(name):
        return (make(base.replace(algo=name), device=DEV),
                make(base.replace(algo=name, backend="torch"), device=DEV))

    rows, max_err = [], 0.0

    def record(name, algo, summary, items, queries, secs, launches, err,
               ties):
        feats, n, fval = summary
        n = int(n)
        want = naive_logdet(feats[:n].double(), KernelConfig("rbf", ls),
                            algo.f.a)
        fe = abs(float(fval) - float(want))
        if not fe <= 1e-4 + 1e-4 * abs(float(want)):
            fail(f"paper {name}: fval {float(fval)} vs slogdet "
                 f"{float(want)}")
        rows.append({"algo": name, "items": items, "n": n,
                     "fval": float(fval), "fval_vs_slogdet_err": fe,
                     "queries_per_item": queries / items, "seconds": secs,
                     "launches": launches, "max_abs_err": err,
                     "near_ties": ties})

    # Greedy: the yardstick
    greedy, greedy_ref = pair("greedy")
    sel, secs, launches = _counted(torch, kernels, lambda: greedy.select(X))
    gaps = []
    ref = greedy_ref.select(X, margins=gaps)
    ties, err = [], 0.0
    if torch.equal(sel[0], ref[0]):
        if not torch.allclose(sel[2], ref[2], rtol=RTOL, atol=ATOL):
            fail(f"paper greedy: fval {float(sel[2])} vs {float(ref[2])}")
        err = abs(float(sel[2]) - float(ref[2]))
    else:
        r = int(torch.nonzero((sel[0] != ref[0]).any(-1))[0, 0])
        if gaps[r] > TIE:
            fail(f"paper greedy: rounds differ first at {r} with the two "
                 f"largest reference gains {gaps[r]} apart (> {TIE})")
        ties.append({"round": r, "gap": gaps[r]})
    record("greedy", greedy, sel, N, K_MAX * N, secs, launches, err, ties)
    rows[-1]["memory_elements"] = N  # offline: it holds the ground set
    f_greedy = float(sel[2])

    # the sieve family over every chunk, held chunk by chunk
    for name in ("threesieves", "sievestreaming", "sievestreaming++",
                 "salsa"):
        algo, algo_ref = pair(name)
        st, sr = algo.init(), algo_ref.init()
        secs, ties, err = 0.0, [], 0.0
        launches = {k.name: 0 for k in kernels}
        for i, Xc in enumerate(chunks):
            before = st
            st, dt, ln = _counted(torch, kernels,
                                  lambda: algo.run_batched(st, Xc))
            secs += dt
            for k, v in ln.items():
                launches[k] += v
            margins = {}
            sr = algo_ref.run_batched(sr, Xc, margins=margins)
            e, tie = hold_states(torch, st, sr, before, Xc, margins,
                                 f"paper {name} chunk {i}")
            err = max(err, e)
            if tie:
                ties.append({"chunk": i, **tie})
                st = clone_state(sr)
        record(name, algo, algo.summary(st), N, _queries(st), secs,
               launches, err, ties)
        rows[-1]["memory_elements"] = int(algo.memory_elements(st))
        rows[-1]["insertions"] = int(algo.insertions(st))
        rows[-1]["not_prefix"] = _not_prefix(torch, st, X)

    # the per-item baselines over the first BASELINE_ITEMS items
    for name in ("random", "independentsetimprovement",
                 "preemptionstreaming", "quickstream"):
        algo, algo_ref = pair(name)
        init = ((lambda a: a.init(seed=0)) if name == "random"
                else (lambda a: a.init()))
        sk, sr = init(algo), init(algo_ref)
        secs, ties, err = 0.0, [], 0.0
        launches = {k.name: 0 for k in kernels}
        if name == "independentsetimprovement":
            # lockstep: each replacement decision is held as it is made
            for i, x in enumerate(Xb):
                sk, dt, ln = _counted(torch, kernels,
                                      lambda: algo.step(sk, x))
                secs += dt
                for k, v in ln.items():
                    launches[k] += v
                prev, sr = sr, algo_ref.step(sr, x)
                if int(sk.ld.n) == int(sr.ld.n) and torch.equal(
                        sk.ld.feats, sr.ld.feats):
                    continue
                g = float(algo_ref.f.gain1(prev.ld, x))
                w2 = 2.0 * float(prev.w.min())
                m = abs(g - w2) / max(1.0, abs(w2))
                if int(prev.ld.n) < algo.f.K or m > TIE:
                    fail(f"paper isi: item {i} decided differently with "
                         f"reference margin {m} (> {TIE})")
                ties.append({"item": i, "margin": m})
                sk = clone_state(sr)
        else:
            sk, secs, launches = _counted(
                torch, kernels, lambda: algo.run_batched(sk, Xb))
            sr = algo_ref.run_batched(sr, Xb)
        e, _ = hold_states(torch, sk, sr, sk, Xb, {}, f"paper {name}")
        err = max(err, e)
        record(name, algo, algo.summary(sk), BASELINE_ITEMS, _queries(sk),
               secs, launches, err, ties)
        rows[-1]["memory_elements"] = int(algo.memory_elements(sk))
        if name in SKIPPERS:
            rows[-1]["not_prefix"] = _not_prefix(torch, sk, Xb)

    for r in rows:
        r["f_over_greedy"] = r["fval"] / f_greedy
        max_err = max(max_err, r["max_abs_err"])
    static = sum(r["launches"]["gain_static"] for r in rows)
    stacked = sum(r["launches"]["gain_traced"] for r in rows
                  if r["algo"] in ("sievestreaming", "sievestreaming++",
                                   "salsa"))
    for r in rows:
        if r["algo"] in SKIPPERS and not r["not_prefix"]:
            fail(f"paper {r['algo']}: every summary is the stream's prefix, "
                 "so no item was ever rejected or replaced and the check "
                 "could not tell a wrong gain from a right one")
    if not static:
        fail("paper: gain_static never launched")
    if not stacked:
        fail("paper: the stacked gain_traced never launched")
    emit("paper", K=K_MAX, d=D, eps=PAPER_EPS, items=N,
         baseline_items=BASELINE_ITEMS, algorithms=rows,
         max_abs_err=max_err)
    return {"gain_static": static,
            "gain_traced": sum(r["launches"]["gain_traced"] for r in rows),
            "max_abs_err": max_err}


def flash_work(B, Hq, Hkv, Sq, Sk, dh, causal, esize):
    """The least work of one attention call -> (FLOP, bytes): 4 dh FLOP
    per live (query, key) pair and head (the q.k and p.v products); one
    read of q, k, v and one write of o."""
    pairs = (sum(min(i + 1, Sk) for i in range(Sq)) if causal
             else Sq * Sk)
    flops = 4 * B * Hq * dh * pairs
    nbytes = esize * (2 * B * Hq * Sq * dh + 2 * B * Hkv * Sk * dh)
    return flops, nbytes


def _padded(q, k, v):
    """q, k, v padded along the sequence to the block the wrapper picks
    (``kernels.flash_attention.ops``) -> (qp, kp, vp, pad)."""
    import torch.nn.functional as F

    S = k.shape[2]
    pad = (-S) % min(128, max(S, 8))
    return (*(F.pad(t, (0, 0, 0, pad)).contiguous() for t in (q, k, v)),
            pad)


def phase_flash(torch, gen):
    """The flash-attention kernel against ``attention_ref`` in the cases
    of FLASH_CASES, timed beside the plain version and SDPA; at the
    control case, a planted fault (padded keys kept) must fail the
    check."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (KERNEL, ROUTES,
                                                     attention_ref,
                                                     flash_attention,
                                                     flash_attention_cuda)

    # the built library's SASS: the bf16 kernel's products on the tensor
    # cores show as HGMMA (wgmma) or HMMA (mma.sync)
    sass = sass_counts(KERNEL, ("HGMMA", "HMMA", "UTMALDG"))
    emit("flash_sass", library=KERNEL.so_path().name, **sass)
    if not (sass["HGMMA"] or sass["HMMA"]):
        fail(f"flash: no tensor-core instruction in the SASS ({sass})")
    cases, max_err = [], 0.0
    for name, B, Hq, Hkv, S, dh, causal, dtype, std in FLASH_CASES:
        dt = getattr(torch, dtype)
        q = (std * torch.randn(B, Hq, S, dh, generator=gen,
                               device=DEV)).to(dt)
        k = (std * torch.randn(B, Hkv, S, dh, generator=gen,
                               device=DEV)).to(dt)
        v = torch.randn(B, Hkv, S, dh, generator=gen, device=DEV).to(dt)
        got = flash_attention(q, k, v, causal=causal, backend="cuda")
        want = attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        size = want.float().abs().max().item()
        tol, scaled_tol = FLASH_TOL[dtype], FLASH_SCALED_TOL[dtype]
        if got.dtype != dt or not torch.allclose(got.float(), want.float(),
                                                 rtol=tol, atol=tol):
            fail(f"flash {name}: {got.dtype}, max err {e} (tol {tol})")
        if e / size > scaled_tol:
            fail(f"flash {name}: max err {e} is {e / size} of the largest "
                 f"output {size} (tol {scaled_tol})")
        max_err = max(max_err, e)
        # the kernel alone on the padded inputs the wrapper hands it
        qp, kp, vp, pad = _padded(q, k, v)
        control = None
        if name == FLASH_CONTROL:
            bad = flash_attention_cuda(qp, kp, vp, causal=causal,
                                       kv_len=S + pad)[:, :, :S]
            control = (bad.float() - want.float()).abs().max().item() / size
            if control <= scaled_tol:
                fail(f"flash {name}: the check passes a kernel that keeps "
                     f"the {pad} padded keys ({control} of the largest "
                     f"output, tol {scaled_tol})")

        def kernel():
            return flash_attention_cuda(qp, kp, vp, causal=causal, kv_len=S)

        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  enable_gqa=True)

        lib = library()
        lib_err = (lib.float() - want.float()).abs().max().item()
        flops, nbytes = flash_work(B, Hq, Hkv, S, S, dh, causal,
                                   q.element_size())
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16 if dt == torch.bfloat16
                           else PEAK_FP32)
        seen = {}
        ms = device_ms(torch, kernel, FLASH_KERNELS[::-1] if dtype ==
                       "bfloat16" else FLASH_KERNELS, seen=seen)
        ran = ("tensor-core" if any("wgmma" in k for k in seen)
               else "cuda-core")
        if len(seen) != 1 or not ROUTES[dt].startswith(ran):
            fail(f"flash {name}: {dtype} ran {sorted(seen)}, expected the "
                 f"{ROUTES[dt]} kernel alone")
        cases.append({
            "case": name, "route": ran, "kernels_seen": seen,
            "shape": [B, Hq, Hkv, S, dh], "causal": causal,
            "dtype": dtype, "qk_std": std, "padded_to": S + pad,
            "max_abs_err": e, "tol": tol, "max_abs_want": size,
            "scaled_err": e / size, "scaled_tol": scaled_tol,
            "control_kv_len_ignored_scaled_err": control,
            "ms": ms, "call_ms": timed_ms(torch, lambda: (
                flash_attention(q, k, v, causal=causal, backend="cuda"))),
            "plain_ms": timed_ms(torch, lambda: attention_ref(
                q, k, v, causal=causal)),
            "library_ms": timed_ms(torch, library),
            "library_max_abs_err": lib_err,
            "library_scaled_err": lib_err / size, "bound_ms": b_ms,
            "bound_by": b_by, "flops": flops, "bytes": nbytes,
            "tflops": flops / ms / 1e9})
    emit("flash", cases=cases, max_abs_err=max_err,
         routes={str(k).replace("torch.", ""): v for k, v in ROUTES.items()},
         library="torch.nn.functional.scaled_dot_product_attention")
    return {"max_abs_err": max_err, **cases[0]}


def sass_counts(kernel, opcodes):
    """How often each opcode appears in the SASS of a kernel's built
    library (``cuobjdump --dump-sass``, beside ``nvcc``)."""
    from repro_torch.kernels import build

    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "--dump-sass", str(kernel.so_path())],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    return {op: out.count(op) for op in opcodes}


def _gap_recorder(torch, step, gaps, at):
    """Wrap a prefill or decode step (its logits are output ``at``) so it
    records, per row, the relative gap between its two largest logits."""

    def wrapped(*args, **kw):
        out = step(*args, **kw)
        logits = out[at]
        top = torch.topk(logits.float(), 2, dim=-1).values
        gaps.append(((top[:, 0] - top[:, 1])
                     / top[:, 0].abs().clamp(min=1.0)).tolist())
        return out

    return wrapped


def _first_diff(tokens, ref, P, gaps, what):
    """Hold the kernel route's tokens against the plain route's: a row
    whose tokens first differ at a step whose plain-route top-2 gap is at
    most TOKEN_TIE is a near-tie, any other difference fails."""
    ties = []
    for r in range(tokens.shape[0]):
        diff = (tokens[r] != ref[r]).nonzero()
        if not len(diff):
            continue
        c = int(diff[0, 0])
        g = gaps[c - P][r]
        if g > TOKEN_TIE:
            fail(f"{what}: row {r} differs first at token {c} with plain "
                 f"top-2 gap {g} (> {TOKEN_TIE})")
        ties.append({"row": r, "token": c, "gap": g})
    return ties


def _spread(xs):
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def _staged(torch, driver, stages):
    """Wrap ``driver``'s prefill and decode steps so that every generate
    appends [before prefill, after prefill, after its last decode step]
    CUDA events to ``stages``."""
    prefill, decode = driver._prefill, driver._decode

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def staged_prefill(*args, **kw):
        start = event()
        out = prefill(*args, **kw)
        stages.append([start, event(), None])
        return out

    def staged_decode(*args, **kw):
        out = decode(*args, **kw)
        stages[-1][2] = event()
        return out

    driver._prefill, driver._decode = staged_prefill, staged_decode


def _generates(torch, driver, kernels, run, n_new, reps):
    """``reps`` generates, each with every count set to 0 just before ->
    (stage times {metric: spread}, launches of each generate).  Prefill
    and decode are timed by CUDA events inside the same generate, the
    generate by the host clock."""
    stages, secs, launches = [], [], []
    _staged(torch, driver, stages)
    for _ in range(reps):
        out, sec, ln = _counted(torch, kernels, run)
        secs.append(sec)
        launches.append(ln)
    B = out.shape[0]
    return {
        "generate_ms": _spread([t * 1e3 for t in secs]),
        "tokens_per_s": _spread([B * n_new / t for t in secs]),
        "prefill_ms": _spread([a.elapsed_time(b) for a, b, _ in stages]),
        "decode_ms_per_token": _spread([b.elapsed_time(c) / (n_new - 1)
                                        for _, b, c in stages]),
    }, launches


def _ignoring_kv_len(q, k, v, *, causal=True):
    """A planted fault in the encoder's attention route: the kernel keeps
    the padded keys (``kv_len`` = the padded length)."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    qp, kp, vp, pad = _padded(q, k, v)
    return flash_attention_cuda(qp, kp, vp, causal=causal,
                                kv_len=k.shape[2] + pad)[:, :, :q.shape[2]]


def _profile(torch, fn):
    """Device time by kernel over one call of ``fn``, and the device's idle
    share of the same profiled window (host clock)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by = []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t > 0:
            by.append((t / 1e3, ev.count, ev.key[:90]))
    by.sort(reverse=True)
    busy = sum(t for t, _, _ in by)
    return wall, busy, by


def phase_whisper(torch, gen, seed):
    """Whisper-small at full width serving 8 requests through
    ``ServeDriver.generate`` with the CUDA flash-attention kernel in its
    encoder, held against the same run on the plain attention route, in
    float32 and in bfloat16 (the config's dtype)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import KERNEL as FLASH
    from repro_torch.kernels.pod_step import KERNEL as POD
    from repro_torch.kernels.rbf_gain import KERNEL as GAIN
    from repro_torch.kernels.rbf_gain import KERNEL_STATIC as STATIC
    from repro_torch.kernels.ssd_chunk import KERNEL as SSD
    from repro_torch.models import Model, attention, init_cache
    from repro_torch.serve import ServeDriver, make_prefill_step
    from repro_torch.tree import leaves_with_keys

    kernels = (GAIN, STATIC, POD, FLASH, SSD)
    B, P, N = WHISPER_B, WHISPER_PROMPT, WHISPER_NEW
    base = get_config("whisper-small", use_pallas_attention=True)
    n_frames = base.encoder.n_frames
    draws = [(torch.randn(B, n_frames, base.d_model, generator=gen,
                          device=DEV),
              torch.randint(0, base.vocab, (B, P), generator=gen,
                            device=DEV, dtype=torch.int32))
             for _ in range(WHISPER_DRAWS)]
    frames, prompts = draws[0]  # the served requests
    params = Model(base, device=DEV).init(
        torch.Generator(device=DEV).manual_seed(seed))
    n_params = sum(t.numel() for t in leaves_with_keys(params).values())
    runs, launches = {}, None
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        model = Model(cfg, device=DEV)
        plain = Model(dataclasses.replace(cfg, use_pallas_attention=False),
                      device=DEV)
        max_seq = P + N + 8
        fe = {"frames": frames}
        tol = WHISPER_TOL[dtype]

        # tokens: the kernel route against the plain route
        driver = ServeDriver(model=model, max_seq=max_seq, batch=B)
        out = driver.generate(params, prompts, N, frontend=fe)  # warms
        gaps = []
        ref_driver = ServeDriver(model=plain, max_seq=max_seq, batch=B)
        ref_driver._prefill = _gap_recorder(torch, ref_driver._prefill, gaps,
                                            0)
        ref_driver._decode = _gap_recorder(torch, ref_driver._decode, gaps, 1)
        ref_out = ref_driver.generate(params, prompts, N, frontend=fe)
        if out.shape != (B, P + N) or not torch.equal(out[:, :P], prompts):
            fail(f"whisper {dtype}: output {tuple(out.shape)} does not "
                 "extend the prompts")
        if int(out.min()) < 0 or int(out.max()) >= cfg.vocab:
            fail(f"whisper {dtype}: a token outside the vocabulary")
        equal = int((out == ref_out).all(1).sum())
        ties = (_first_diff(out, ref_out, P, gaps, "whisper float32")
                if dtype == "float32" else None)  # bf16 holds logits only

        # the main path: timed generates, launches counted in each
        torch.cuda.reset_peak_memory_stats()
        timing, lns = _generates(torch, driver, kernels, lambda: (
            driver.generate(params, prompts, N, frontend=fe)), N,
            WHISPER_REPS)
        peak = torch.cuda.max_memory_allocated()
        for ln in lns:
            if ln["flash_attention"] != cfg.encoder.n_layers or any(
                    v for k, v in ln.items() if k != "flash_attention"):
                fail(f"whisper {dtype}: launches {ln}, expected "
                     f"{cfg.encoder.n_layers} flash_attention per generate")
        if dtype == base.dtype:
            launches = lns[0]["flash_attention"]
        ref_timed = ServeDriver(model=plain, max_seq=max_seq, batch=B)
        plain_timing, plain_lns = _generates(
            torch, ref_timed, kernels, lambda: ref_timed.generate(
                params, prompts, N, frontend=fe), N, WHISPER_REPS)
        if any(v for ln in plain_lns for v in ln.values()):
            fail(f"whisper {dtype}: the plain route launched {plain_lns}")

        # encoder output and prefill logits, kernel route against plain,
        # on every input draw and under the planted fault
        def prefill(m, fr, pr):
            caches = init_cache(cfg, B, max_seq, device=DEV)
            with torch.inference_mode():
                return make_prefill_step(m)(params, {"tokens": pr,
                                                     "frames": fr}, caches)

        def errs(fr, pr):
            with torch.inference_mode():
                enc = model._encode(params, fr)
                enc_ref = plain._encode(params, fr)
            logits, logits_ref = prefill(model, fr, pr)[0], prefill(
                plain, fr, pr)[0]
            if not (torch.isfinite(enc).all()
                    and torch.isfinite(logits).all()):
                fail(f"whisper {dtype}: non-finite encoder output or logits")
            return ((enc.float() - enc_ref.float()).abs().max().item(),
                    (logits.float() - logits_ref.float()).abs().max().item())

        enc_errs, logit_errs = zip(*(errs(fr, pr) for fr, pr in draws))
        if max(logit_errs) > tol:
            fail(f"whisper {dtype}: prefill logits off by {logit_errs} "
                 f"(tol {tol})")
        if dtype == "float32" and max(enc_errs) > tol:
            fail(f"whisper float32: encoder output off by {enc_errs}")
        route = attention.flash_attention
        attention.flash_attention = _ignoring_kv_len
        try:
            control = errs(frames, prompts)
        finally:
            attention.flash_attention = route
        if dtype == "float32" and max(control) <= tol:
            fail(f"whisper float32: the check passes the padded-keys fault "
                 f"(errors {control}, tol {tol})")
        with torch.inference_mode():
            enc_ms = timed_ms(torch, lambda: model._encode(params, frames),
                              reps=WHISPER_REPS, warmup=1)
            plain_enc_ms = timed_ms(torch, lambda: plain._encode(
                params, frames), reps=WHISPER_REPS, warmup=1)
        runs[dtype] = {
            "launches": lns[0], "generates": len(lns),
            "tokens_equal_rows": equal, "near_ties": ties,
            "min_plain_gap": min(min(g) for g in gaps),
            "encoder_max_abs_err": enc_errs, "logits_max_abs_err": logit_errs,
            "tol": tol, "control_kv_len_ignored": {
                "encoder_max_abs_err": control[0],
                "logits_max_abs_err": control[1]},
            "encoder_ms": enc_ms, "plain_encoder_ms": plain_enc_ms,
            **timing, "plain": plain_timing, "peak_mem_gib": peak / 2 ** 30}

        if dtype == base.dtype:  # where the serving run's device time goes
            wall, busy, by = _profile(torch, lambda: driver.generate(
                params, prompts, N, frontend=fe))
            flash = sum(t for t, _, k in by
                        if any(f in k for f in FLASH_KERNELS))
            tc = sum(c for _, c, k in by if "flash_attention_wgmma_kernel" in k)
            if dtype == "bfloat16" and tc != cfg.encoder.n_layers:
                fail(f"whisper bf16: {tc} flash launches on the tensor "
                     f"cores in one generate, expected "
                     f"{cfg.encoder.n_layers}")
            pre_ms = timing["prefill_ms"]["median"]
            runs[dtype]["profile"] = {
                "wall_ms": wall, "device_busy_ms": busy,
                "idle_share": 1 - busy / wall, "flash_ms": flash,
                "flash_tensor_core_launches": tc,
                "flash_share_of_encoder": flash / enc_ms,
                "flash_share_of_prefill": flash / pre_ms,
                "top": [{"ms": t, "count": c, "kernel": k}
                        for t, c, k in by[:12]]}
    emit("whisper", arch="whisper-small", params=n_params, batch=B,
         prompt=P, new_tokens=N, frames=n_frames, draws=WHISPER_DRAWS,
         runs=runs)
    return {"launches": launches}

def ssd_work(b, h, c, q, p, n, esize):
    """The least work of one SSD intra-chunk call -> (FLOP, bytes): per
    (batch, head, chunk) tile 2 n + 2 p FLOP per live (query, key) pair,
    q (q + 1) / 2 pairs (the C.B score and the S.X product), and 2 n p per
    key for the end-state; one read of X, Adt, B, C and one write of Y (in
    the input type) and the float32 states."""
    tiles = b * h * c
    flops = tiles * (q * (q + 1) // 2 * (2 * n + 2 * p) + 2 * q * n * p)
    nbytes = tiles * (esize * q * (2 * p + 2 * n + 1) + 4 * n * p)
    return flops, nbytes


def ssd_errors(torch, got, want, tol):
    """-> (max abs error, error over the largest output, whether every
    element is within rtol = atol = tol)."""
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    return err, err / w.abs().max().item(), torch.allclose(g, w, rtol=tol,
                                                           atol=tol)


def _without_diagonal(X, B, C, Y):
    """The planted fault of phase ssd: the plain output with the diagonal
    of L (exp(0) = 1) dropped, so each step misses its own input: Y minus
    (C_i . B_i) X_i."""
    return (Y.float() - (C.float() * B.float()).sum(-1, keepdim=True)
            * X.float()).to(Y.dtype)


def phase_ssd(torch, gen):
    """The SSD intra-chunk kernel against ``ssd_chunk_ref`` in the cases of
    SSD_CASES, timed beside the plain version; in every case the plain
    version without the diagonal must fail the check."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_chunk import (ssd_chunk_cuda, ssd_chunk_ref,
                                               ssd_chunks)

    cases, max_err = [], 0.0
    for name, b, L, h, p, n, q, dtype, decay in SSD_CASES:
        dt = getattr(torch, dtype)
        c = L // q
        X = torch.randn(b, h, c, q, p, generator=gen, device=DEV).to(dt)
        Adt = (-decay * F.softplus(torch.randn(b, h, c, q, generator=gen,
                                               device=DEV))).to(dt)
        B = torch.randn(b, h, c, q, n, generator=gen, device=DEV).to(dt)
        C = torch.randn(b, h, c, q, n, generator=gen, device=DEV).to(dt)
        Y, st = ssd_chunk_cuda(X, Adt, B, C)
        Yr, sr = ssd_chunk_ref(X, Adt, B, C)
        torch.cuda.synchronize()
        tol, scaled_tol = SSD_TOL[dtype], SSD_SCALED_TOL[dtype]
        if Y.dtype != dt or st.dtype != torch.float32 or not (
                torch.isfinite(Y.float()).all() and torch.isfinite(st).all()):
            fail(f"ssd {name}: Y {Y.dtype}, states {st.dtype}, or not finite")
        y_err, y_scaled, y_ok = ssd_errors(torch, Y, Yr, tol)
        s_err, s_scaled, s_ok = ssd_errors(torch, st, sr, tol)
        if not (y_ok and s_ok) or max(y_scaled, s_scaled) > scaled_tol:
            fail(f"ssd {name}: Y off by {y_err} ({y_scaled} of the largest), "
                 f"states by {s_err} ({s_scaled}); tol {tol} / "
                 f"{scaled_tol}")
        bad = _without_diagonal(X, B, C, Yr)
        c_err, c_scaled, c_ok = ssd_errors(torch, bad, Yr, tol)
        if c_ok and c_scaled <= scaled_tol:
            fail(f"ssd {name}: the check passes the plain version without "
                 f"the diagonal ({c_err}, {c_scaled} of the largest)")
        del bad
        max_err = max(max_err, y_err, s_err)
        flops, nbytes = ssd_work(b, h, c, q, p, n, X.element_size())
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16 if dt == torch.bfloat16
                           else PEAK_FP32)
        b32_ms, b32_by = bound(flops, nbytes, PEAK_FP32)
        ms = device_ms(torch, lambda: ssd_chunk_cuda(X, Adt, B, C),
                       "ssd_chunk_kernel")
        # the wrapper in the model's layout (the transposes and copies the
        # prefill pays around each launch)
        Xm = X.permute(0, 2, 3, 1, 4).reshape(b, L, h, p)
        Am = Adt.permute(0, 2, 3, 1).reshape(b, L, h)
        Bm = B.permute(0, 2, 3, 1, 4).reshape(b, L, h, n)
        Cm = C.permute(0, 2, 3, 1, 4).reshape(b, L, h, n)
        cases.append({
            "case": name, "shape": [b, L, h, p, n, q], "dtype": dtype,
            "decay": decay, "acum_min": Adt.float().sum(-1).min().item(),
            "y_max_abs_err": y_err, "y_scaled_err": y_scaled,
            "state_max_abs_err": s_err, "state_scaled_err": s_scaled,
            "tol": tol, "scaled_tol": scaled_tol,
            "max_abs_want": Yr.float().abs().max().item(),
            "control_strict_tril_max_abs_err": c_err,
            "control_strict_tril_scaled_err": c_scaled,
            "ms": ms, "call_ms": timed_ms(torch, lambda: ssd_chunks(
                Xm, Am, Bm, Cm, chunk=q, backend="cuda")),
            "plain_ms": timed_ms(torch, lambda: ssd_chunk_ref(X, Adt, B, C)),
            "bound_ms": b_ms, "bound_by": b_by, "bound_fp32_ms": b32_ms,
            "bound_fp32_by": b32_by, "flops": flops, "bytes": nbytes,
            "tflops": flops / ms / 1e9})
        del X, Adt, B, C, Y, st, Yr, sr, Xm, Am, Bm, Cm
    emit("ssd", cases=cases, max_abs_err=max_err, library=None)
    return {"max_abs_err": max_err, **cases[0]}


class _SsdRoute:
    """Swap ``models.mamba.ssd_chunks``, the prefill's SSD route, for
    ``fn`` for a block, then restore it."""

    def __init__(self, fn):
        self.fn = fn

    def __enter__(self):
        from repro_torch.models import mamba

        self.saved, mamba.ssd_chunks = mamba.ssd_chunks, self.fn

    def __exit__(self, *exc):
        from repro_torch.models import mamba

        mamba.ssd_chunks = self.saved


def _plain_ssd(X, Adt, B, C, *, chunk):
    """The plain route: ``ssd_chunks`` on its plain version."""
    from repro_torch.kernels.ssd_chunk import ssd_chunks

    return ssd_chunks(X, Adt, B, C, chunk=chunk, backend="torch")


def _shifted_adt(X, Adt, B, C, *, chunk):
    """A planted fault in the prefill's SSD route: the kernel fed Adt
    shifted by one step (each step decays by its predecessor's dt A)."""
    import torch

    from repro_torch.kernels.ssd_chunk import ssd_chunks

    shifted = torch.cat([Adt[:, :1], Adt[:, :-1]], 1)
    return ssd_chunks(X, shifted, B, C, chunk=chunk, backend="cuda")


def phase_mamba(torch, gen, seed):
    """Mamba2-370m at full width serving 8 requests through
    ``ServeDriver.generate`` with each layer's prefill on the CUDA SSD
    kernel, held against the same run on the plain route, in float32 and
    in bfloat16 (the config's dtype)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import KERNEL as FLASH
    from repro_torch.kernels.pod_step import KERNEL as POD
    from repro_torch.kernels.rbf_gain import KERNEL as GAIN
    from repro_torch.kernels.rbf_gain import KERNEL_STATIC as STATIC
    from repro_torch.kernels.ssd_chunk import KERNEL as SSD
    from repro_torch.models import Model, init_cache
    from repro_torch.serve import ServeDriver, make_prefill_step
    from repro_torch.tree import leaves_with_keys

    kernels = (GAIN, STATIC, POD, FLASH, SSD)
    B, P, N = MAMBA_B, MAMBA_PROMPT, MAMBA_NEW
    base = get_config("mamba2-370m")
    draws = [torch.randint(0, base.vocab, (B, P), generator=gen, device=DEV,
                           dtype=torch.int32) for _ in range(MAMBA_DRAWS)]
    prompts = draws[0]  # the served requests
    params = Model(base, device=DEV).init(
        torch.Generator(device=DEV).manual_seed(seed))
    n_params = sum(t.numel() for t in leaves_with_keys(params).values())
    runs, launches = {}, None
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        model = Model(cfg, device=DEV)
        max_seq = P + N + 8
        tol = MAMBA_TOL[dtype]

        # tokens: the kernel route against the plain route
        driver = ServeDriver(model=model, max_seq=max_seq, batch=B)
        out = driver.generate(params, prompts, N)  # warms
        gaps = []
        ref_driver = ServeDriver(model=model, max_seq=max_seq, batch=B)
        ref_driver._prefill = _gap_recorder(torch, ref_driver._prefill, gaps,
                                            0)
        ref_driver._decode = _gap_recorder(torch, ref_driver._decode, gaps, 1)
        with _SsdRoute(_plain_ssd):
            ref_out = ref_driver.generate(params, prompts, N)
        if out.shape != (B, P + N) or not torch.equal(out[:, :P], prompts):
            fail(f"mamba {dtype}: output {tuple(out.shape)} does not extend "
                 "the prompts")
        if int(out.min()) < 0 or int(out.max()) >= cfg.vocab:
            fail(f"mamba {dtype}: a token outside the vocabulary")
        equal = int((out == ref_out).all(1).sum())
        ties = (_first_diff(out, ref_out, P, gaps, "mamba float32")
                if dtype == "float32" else None)  # bf16 holds logits only

        # the main path: timed generates, launches counted in each
        torch.cuda.reset_peak_memory_stats()
        timing, lns = _generates(torch, driver, kernels, lambda: (
            driver.generate(params, prompts, N)), N, MAMBA_REPS)
        peak = torch.cuda.max_memory_allocated()
        for ln in lns:
            if ln["ssd_chunk"] != cfg.n_layers or any(
                    v for k, v in ln.items() if k != "ssd_chunk"):
                fail(f"mamba {dtype}: launches {ln}, expected "
                     f"{cfg.n_layers} ssd_chunk per generate")
        if dtype == base.dtype:
            launches = lns[0]["ssd_chunk"]
        ref_timed = ServeDriver(model=model, max_seq=max_seq, batch=B)

        def plain_generate():
            with _SsdRoute(_plain_ssd):
                return ref_timed.generate(params, prompts, N)

        plain_timing, plain_lns = _generates(torch, ref_timed, kernels,
                                             plain_generate, N, MAMBA_REPS)
        if any(v for ln in plain_lns for v in ln.values()):
            fail(f"mamba {dtype}: the plain route launched {plain_lns}")

        # prefill logits, kernel route against plain, on every input draw
        # and under the planted fault
        def prefill(pr):
            caches = init_cache(cfg, B, max_seq, device=DEV)
            with torch.inference_mode():
                return make_prefill_step(model)(params, {"tokens": pr},
                                                caches)[0]

        def err(pr):
            logits = prefill(pr)
            with _SsdRoute(_plain_ssd):
                ref = prefill(pr)
            if not torch.isfinite(logits).all():
                fail(f"mamba {dtype}: non-finite prefill logits")
            return (logits.float() - ref.float()).abs().max().item()

        logit_errs = [err(pr) for pr in draws]
        if max(logit_errs) > tol:
            fail(f"mamba {dtype}: prefill logits off by {logit_errs} "
                 f"(tol {tol})")
        with _SsdRoute(_shifted_adt):
            control = err(prompts)
        if dtype == "float32" and control <= tol:
            fail(f"mamba float32: the check passes the shifted-Adt fault "
                 f"(error {control}, tol {tol})")
        runs[dtype] = {
            "launches": lns[0], "generates": len(lns),
            "tokens_equal_rows": equal, "near_ties": ties,
            "min_plain_gap": min(min(g) for g in gaps),
            "logits_max_abs_err": logit_errs, "tol": tol,
            "control_shifted_adt_logits_max_abs_err": control,
            **timing, "plain": plain_timing, "peak_mem_gib": peak / 2 ** 30}

        if dtype == base.dtype:  # where the serving run's device time goes
            wall, busy, by = _profile(torch, lambda: driver.generate(
                params, prompts, N))
            ssd = sum(t for t, _, k in by if "ssd_chunk_kernel" in k)
            runs[dtype]["profile"] = {
                "wall_ms": wall, "device_busy_ms": busy,
                "idle_share": 1 - busy / wall, "ssd_ms": ssd,
                "ssd_share_of_prefill": ssd / timing["prefill_ms"]["median"],
                "top": [{"ms": t, "count": c, "kernel": k}
                        for t, c, k in by[:12]]}
    emit("mamba", arch="mamba2-370m", params=n_params,
         params_analytic=base.param_count(), batch=B, prompt=P,
         padded_to=-(-P // base.ssm.chunk) * base.ssm.chunk, new_tokens=N,
         draws=MAMBA_DRAWS, runs=runs)
    return {"launches": launches}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ingests", type=int, default=6)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script measures the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count())
    gen = torch.Generator(device=DEV)
    gen.manual_seed(args.seed)

    seconds = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t0
        return out

    # the phases of the first slice first, on the seed's draws as before
    timed("build", phase_build, torch)
    gain = timed("gain", phase_gain, torch, gen)
    pod_err = timed("pod_step", phase_pod_step, torch, gen)
    pod = timed("pod", phase_pod, torch, gen, args.ingests)
    sieve = timed("sieve", phase_sieve, torch, gen)
    static = timed("gain_static", phase_gain_static, torch, gen)
    stacked = timed("gain_stacked", phase_gain_stacked, torch, gen)
    large = timed("pod_step_large", phase_pod_step_large, torch, gen)
    paper = timed("paper", phase_paper, torch, gen)
    flash = timed("flash", phase_flash, torch, gen)
    whisper = timed("whisper", phase_whisper, torch, gen, args.seed)
    ssd = timed("ssd", phase_ssd, torch, gen)
    mamba = timed("mamba", phase_mamba, torch, gen, args.seed)
    emit("seconds", total=sum(seconds.values()), **seconds)

    kernels = [
        {"name": "gain_traced", "route": "cuda",
         "source": "src/repro_torch/csrc/rbf_gain.cu",
         "replaces": "src/repro/kernels/rbf_gain/kernel.py:126",
         "launches": sieve["launches"] + paper["gain_traced"],
         "max_abs_err": max(gain["max_abs_err"], stacked["max_abs_err"],
                            sieve["max_abs_err"], paper["max_abs_err"]),
         "ms": gain["ms"], "plain_ms": gain["plain_ms"],
         "bound_ms": gain["bound_ms"], "bound_by": gain["bound_by"],
         "library_ms": None},
        {"name": "gain_static", "route": "cuda",
         "source": "src/repro_torch/csrc/rbf_gain.cu",
         "replaces": "src/repro/kernels/rbf_gain/kernel.py:74",
         "launches": paper["gain_static"],
         "max_abs_err": max(static["max_abs_err"], paper["max_abs_err"]),
         "ms": static["ms"], "plain_ms": static["plain_ms"],
         "bound_ms": static["bound_ms"], "bound_by": static["bound_by"],
         "library_ms": None},
        {"name": "pod_step", "route": "cuda",
         "source": "src/repro_torch/csrc/pod_step.cu",
         "replaces": "src/repro/kernels/pod_step/kernel.py:160",
         "launches": pod["launches"],
         "max_abs_err": max(pod_err, large["max_abs_err"],
                            pod["max_abs_err"]),
         "ms": pod["ms"], "plain_ms": pod["plain_ms"],
         "bound_ms": pod["bound_ms"], "bound_by": pod["bound_by"],
         "library_ms": None},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:81",
         "launches": whisper["launches"],
         "max_abs_err": flash["max_abs_err"],
         "ms": flash["ms"], "plain_ms": flash["plain_ms"],
         "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
         "library_ms": flash["library_ms"]},
        {"name": "ssd_chunk", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_chunk.cu",
         "replaces": "src/repro/kernels/ssd_chunk/kernel.py:58",
         "launches": mamba["launches"],
         "max_abs_err": ssd["max_abs_err"],
         "ms": ssd["ms"], "plain_ms": ssd["plain_ms"],
         "bound_ms": ssd["bound_ms"], "bound_by": ssd["bound_by"],
         "library_ms": None},
    ]
    for k in kernels:
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms") + (
                ("library_ms",) if k["library_ms"] is not None else ()):
            if not math.isfinite(k[key]):
                fail(f"{k['name']}: {key} is not finite")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
