#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one card.

    python3 chip_smoke.py [--seed N] [--ingests N]

Phases, one JSON line each; any failure ends the run with a non-zero
exit and no result line:

  1. build           the five CUDA kernels from the four sources in
                     ``src/repro_torch/csrc`` (one nvcc each, started
                     together), ptxas lines, the instantiations that
                     spill;
  2. gain            ``gain_traced`` against its plain version at B=1024,
                     K=100, d=256, n in {0, 37, 100}, both kernel kinds,
                     two inv2l2 (device time per call: the gain kernel and
                     its first pass over the summaries' norms);
  3. pod_step        the kernel against ``pod_step_ref`` (16 sessions,
                     K=100, d=256, C=1024, three tiers): ragged counts, a
                     C=1 chunk, a saturating chunk, a round after it; the
                     layout tier (Linv in shared memory at K=100), and per
                     round the longest session's passes (its growth in
                     n_fused) and the us per serial pass; the ragged round
                     again with Linv in device memory (timed) and with an
                     8-row window, which must leave the same bits;
  4. pod             the main path: ``make`` + ``SummarizerPod(S=256,
                     chunk=1024)``, 256 tenants in three tiers, ingests of
                     262,144 tagged items (the first is cold; items/s
                     counts the rest), one ``drift_check`` that re-arms the
                     full summaries before the last ingest, ``readout``;
                     each summary's fval is checked against a float64
                     slogdet and the last ingest is replayed through
                     ``pod_step_ref`` (the replay's layout, passes and us
                     per pass as in ``pod_step``);
  5. sieve           standalone ``ThreeSieves.run_batched`` through the
                     gain oracle (``auto`` -> the kernel), 64 chunks of
                     1024 items, against the same run under ``torch``;
  6. gain_static     ``gain_static`` against ``gain_ref``, the cases of
                     ``gain`` at B=65,536 (a Greedy round) and B=1 (an ISI
                     query);
  7. gain_stacked    ``gain_traced`` over I=147 stacked summaries (Salsa
                     at K=100, eps=0.1: 3 rules x 49 rungs), B=1024, and
                     over I=49 of them (SieveStreaming's stack), timed;
  8. pod_step_large  the pod step past what shared memory could hold (the
                     global layout tier, Linv in device memory): 8
                     sessions at K_max=512 (tiers 128/256/512: ragged
                     fill, saturating, after saturation), then one ragged
                     round of 4 sessions at K_max=1024; passes and us per
                     pass as in ``pod_step``;
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
                     dh=128, S=2048, bf16, and float32: the shape the
                     float32 mesh forward gives each rank) and a ragged
                     float32 case (S=100); within 2e-4 (f32) / 2e-2
                     (bf16), and within 1e-4 (f32) / 1e-2 (bf16) of the
                     largest output; the kernel told to keep the padded
                     keys (and, in the float32 qwen2 case, to see every
                     key) must fail that check; timed beside the plain
                     version and
                     ``scaled_dot_product_attention``; the route each
                     dtype ran (bf16: the tensor-core kernel, f32: the
                     CUDA-core one, from the profiler's kernel names), and
                     before it a ``flash_sass`` line counting HGMMA / HMMA
                     in the built library (none fails the run);
 11. whisper         the slice's main path: Whisper-small at full width,
                     its encoder and decoder cut to 4 of their 12 layers
                     (seeded parameters), serving 8 requests of 1500 frames
                     and 16 prompt tokens through ``ServeDriver.generate``
                     (32 new tokens, greedy), the encoder's attention on
                     the kernel (one launch per encoder layer per
                     generate), held against
                     the same run on the plain attention route: in float32
                     the tokens equal and, on three input draws, the
                     encoder output and prefill logits within 1e-4, which
                     the padded-keys fault planted in the encoder must
                     fail; in bfloat16 the logits within 5e-2 (a bound on
                     rounding, which cannot see that fault).  One timed
                     generate per route (WHISPER_REPS), prefill and decode
                     timed by CUDA events inside it; the idle share
                     from one profiled generate, in which all 12 bf16
                     encoder launches must be the tensor-core kernel;
 12. ssd             ``ssd_chunk_cuda`` against its plain version on the
                     model's layout: the Mamba2-370m prefill (b=8, L=2048,
                     32 heads, p=64, n=128, q=256) in bf16 with Adt =
                     -softplus(N) and B / C in one group (the kernels
                     line's case), the same with B / C per head (g = 32),
                     in float32 with slow decay (-0.01 softplus(N)), and
                     the reduced config's (q=p=n=16, float32); Y and the
                     states elementwise within 1e-5 (f32) / 2e-2 (bf16)
                     and within 1e-5 / 1e-2 of the largest output; the
                     plain version with the diagonal dropped (strict tril)
                     must fail that check in every case, and in bf16 the
                     kernel fed Adt shifted by one step (the margin: the
                     fault's error over the gate); the route each dtype
                     took (bf16: the tensor-core kernel, f32: the CUDA-core
                     one); timed beside the plain version against the
                     grouped and the per-head bound (no PyTorch call
                     computes this function);
 13. mamba           the slice's main path: Mamba2-370m at full width
                     cut to 8 of its 48 layers (seeded parameters) serving
                     8 requests of 2000 prompt tokens (padded inside each
                     layer to 8 chunks of 256) through
                     ``ServeDriver.generate`` (32 new tokens, greedy), each
                     layer's prefill on the SSD kernel (one launch per
                     layer per generate, none in decode; bf16 all on
                     the tensor-core kernel, B / C handed per group and
                     read in place), held against
                     the plain route (``ssd_chunks`` with backend
                     ``torch``): in float32 the tokens equal and, on three
                     input draws, the prefill logits within 1e-4, which
                     the kernel route fed Adt shifted by one step must
                     fail; in bfloat16 the logits within 5e-2 (a bound on
                     rounding).  One timed generate per route
                     (MAMBA_REPS), timed as in ``whisper``; the idle
                     share from one profiled
                     generate;
 14. pod_bf16        the pod step on bf16 summaries (K=100, d=256, 16
                     sessions, the rounds of ``pod_step``) against
                     ``pod_step_ref``: integers equal, fval within 0.05,
                     the carry still bf16; the kernel fed each count one
                     short must fail; the ragged round timed beside the
                     float32 one, passes and us per pass as in
                     ``pod_step``; then a ``SummarizerPod`` of 32 bf16
                     tenants, two ingests, each replayed through
                     ``pod_step_ref``;
 15. gain_bf16       a bf16 summary's gains (B=1024, K=100, d=256, n=100)
                     through the oracle's kernel route (the float32 gain
                     kernels after an exact upcast) against its plain
                     route within one bf16 ulp, ``gain_traced`` and
                     ``gain_static``; the summary priced without its
                     second half must fail; timed beside the float32 call; and
                     ThreeSieves, SieveStreaming and ISI on a bf16 LogDet
                     on both routes (n equal, fval within 0.05);
 16. flash_dh96      head width 96: phi3-mini-3.8b's attention (32 / 32
                     heads, S=2048, causal, bf16) timed beside SDPA, and a
                     ragged float32 case, under the gates of ``flash``;
                     the kernel of each (causal) case told to see every
                     key must fail;
 17. pod_sieves      pods of 64 SieveStreaming++ tenants (tiers K = 10 /
                     50 / 100, eps = 0.1, per-tenant lengthscales, chunk
                     1,024: 3,136 instances a round), of 16 Salsa tenants
                     and of 16 QuickStream tenants (chunk 256), each fed
                     by ``SummarizerPod.serve`` + ``IngestPipeline`` from
                     a seeded ``DriftSource``: an ingest, a drift check
                     that re-arms every K = 10 tenant, an ingest; no drop,
                     every summary in budget with fval within 1e-4 of a
                     float64 slogdet; per ingest the seconds, the rounds
                     (one grouped ``gain_traced`` launch each) and ms per
                     round; both ingests (the first from the state the
                     run's sync boundary saw, before the drift check)
                     replayed for twelve slots, four of each tier,
                     through ``pod_step_ref`` (plain gains: integers
                     equal, floats within 1e-5, near-tie rule) and
                     through the per-slot loop on the kernel (the same
                     rule, bit-equality reported); the grouped gain pass
                     of the second ingest's first round against its plain
                     version, one group bit for bit the ungrouped call,
                     timed beside its bound;
 18. ingest          the ThreeSieves pod of ``pod`` fed by
                     ``IngestPipeline`` from 4 host batches of 262,144
                     items (1,024 of each session; pinned copy on a side
                     stream, routed on the card), against the same
                     batches through ``pod.ingest``: the final state
                     bit-equal to the direct one, no drop; per batch the
                     host's staging ms, the copy's and the step's device
                     ms, items/s, and each path's device idle share;
 19. ckpt            checkpoint -> restore -> continue on the pod of
                     ``pod``: two ingests, ``SummarizerPod.save`` to a
                     ``ckpt.CheckpointStore`` (sync, then async while the
                     third ingest steps the state in place) and to a
                     ``MemoryStore``; each restored and the third ingest
                     run again, bit-equal to the uninterrupted pod; 8
                     rows restored into a second pod of 128 tenants and
                     128 free slots, their next ingest bit-equal to the
                     source's; the bf16 pod of ``pod_bf16`` (32 tenants)
                     round-tripped bit for bit; save / restore ms, bytes,
                     MB/s;
 20. handoff         two pods of that shape in a ``PodRouter`` fleet of
                     buffer-mode ``IngestPipeline``s (256 tenants; 128
                     and 128 free slots), 4 batches of 384 items per
                     session: one, then ``PodAutoscaler.maybe_rebalance``
                     (8 victims, fewest insertions) while the next waits
                     in the buffers, a third landing behind the parked
                     backlog, a fourth; a control fleet on the same
                     batches without the handoff: zero drops, every
                     session bit for bit the control's but n_fused (the
                     gain passes, one per chunk: the backlog changes the
                     chunk split), the moved sessions against
                     ``pod_step_ref`` over their whole stream (integers
                     but n_fused equal, floats within 1e-5, near-tie
                     rule); the handoff's latency and phase spans, the
                     backlog, items/s before, during and after;
 21. pubsub          4 ``Publisher``s over loopback TCP into a
                     ``PubSubListener`` (8 partitions), each owning a
                     quarter of the sessions, 2 batches of 262,144 items
                     (268 MB); producer 2's wire dies mid-way through the
                     second and it replays from its ACK; a
                     ``PubSubFrontEnd`` attached to the pipeline of the
                     ``ingest`` phase's pod pumps each batch, commits at
                     the pipeline's sync and is restarted from
                     ``committed()`` between them: every frame in the
                     broker once, no drop, the final state bit-equal to
                     the same batches through ``pod.ingest``; items/s,
                     lag, the card's idle share;
 22. distributed     ``DistributedSummarizer`` of ThreeSieves (K=100,
                     d=256, T and eps of ``paper``) on 32 shards of the
                     ``paper`` stream (65,536 items in batches of 32 x
                     1,024), update and merge under ``auto`` (the
                     kernels; the merge one ``gain_static`` launch a
                     round, 100) and ``torch``: shard states held under
                     the near-tie rule, the merges equal (a first
                     differing round a near-tie of the reference's top
                     two gains), f(merged) at least every shard's;
                     f(merged) / best shard and / f_greedy of ``paper``,
                     merge ms; then ``CoresetSelector(K=100, d=256)`` over
                     the same stream on both routes, ``assign`` of the
                     last 1,024 items equal.

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

Then this slice's phases, after ``archs``:

 train_grad          ``Model.loss(...).backward()`` through the kernel
                     routes (SSD; flash at head width 16 under
                     ``use_pallas_attention``) against the plain routes:
                     reduced Mamba2, Jamba (g = 2), qwen2-1.5b and
                     whisper-small at 2 x 64 tokens, then Mamba2-370m
                     whole at 2 x 2048 (remat ``full``: 96 SSD launches);
                     float32: every leaf within 1e-4 of its largest
                     plain gradient, which the detached route (the
                     kernels' outputs with no autograd Function) must
                     fail, and the loss within 1e-4 (relative) of the
                     plain loss; bf16 printed;
 flash_dh16          head width 16 under the gates of ``flash``: causal
                     GQA and full, ragged S, the reduced models' own
                     shapes of train_grad, both dtypes (bf16 on the
                     tensor-core kernel), the padded-keys and non-causal
                     faults, timed beside SDPA and the bound;
 train_qwen2         qwen2-1.5b at full width cut to 4 of its 28 layers
                     (float32 master
                     weights, gradients and AdamW moments; bf16
                     activations, remat ``full``) through ``run_training``
                     into a ``CheckpointStore``: 6 steps of 8 x 512
                     tokens, a checkpoint every 3, then a kill after step
                     3's and a resume, compared with steps 4-6; ms a step
                     (CUDA events), tokens/s, peak memory, model FLOP
                     utilisation, a profiled step by kernel kind and the
                     idle share; the step with remat off;
 train_mamba         mamba2-370m whole, bf16, 8 x 2048 tokens, remat
                     ``full``, 4 AdamW steps: 96 ``ssd_chunk`` launches a
                     step on the tensor-core route; ms a step, tokens/s,
                     peak memory, the plain SSD backward's share of a
                     profiled step against the kernel's forward.

Then the scale-out path, each phase's ranks spawned (``spawn``) on the
one card, one process group each; a rank that raises or outlives its
timeout fails the run with every rank's traceback:

 sharded_pod         the ``pod`` phase's 256 tenants as 4 gloo ranks x 64
                     sessions through ``make_sharded_update``: 2 ingests
                     of 262,144 tagged items (65,536 a rank) on a (4, 1)
                     ("data", "model") mesh, 2 pre-routed (chunks from
                     ``ingest.host_route``), then one of each on a (2, 2)
                     ("pod", "data") mesh with the tuple axis; every
                     rank's rows bit for bit the one-process 256-session
                     pod's fed the same items; items/s over all ranks,
                     ms an ingest a rank, host-route ms, launches;
 sharded_merge       ``DistributedSummarizer`` of ThreeSieves on a (4,)
                     ("data",) mesh, one shard a rank, over the ``paper``
                     stream in batches of 4 x 1,024: every rank's shard
                     state bit for bit the one-process loop's at
                     ``shards=4``, every rank's merge bit for bit the
                     others' and the loop's (near-tie rule of
                     ``distributed``); the all-gather's bytes and ms
                     (CUDA tensors over gloo), the merge's ms, 100
                     ``gain_static`` launches a rank;
 pod_compress        two gloo ranks as two pods, each training
                     mamba2-370m at full width cut to 4 of its 48 layers
                     (8 x 2048 tokens, bf16, remat ``full``) on its own
                     batches, 2 AdamW steps through
                     ``Compressor(mesh, "pod")``: the parameters bit for
                     bit the same on both after every step, each reduced
                     gradient within the int8 bound of the pods' mean
                     (``_check_reduced``), 8 ``ssd_chunk`` launches a
                     step a rank; ms a step, the compress window, the
                     int32 bytes a step, peak memory;
 nccl                one rank on an NCCL group: the pod (64 sessions),
                     the merge (8 batches of the stream) and the
                     compressor (reduced mamba2-370m, 2 steps) under the
                     same gates, every kernel but flash launched.

Then flash at every head width to 256 (``flash_dh_any``), the model on a
mesh of ranks sharing the card (``tp_forward``: qwen2-1.5b on (2, 2) and
mamba2-370m on (1, 2); ``seq_shard``: phi3-mini-3.8b on (1, 3), context
parallel; ``train_mesh``: ``launch.train`` on (1, 2), a step, a
checkpoint, a resumed step bit-equal), each model at full width cut in
depth (qwen2 and phi3 to 2 layers, mamba2 to 4; the ``cut`` of each
line), and the dry-run (``dryrun``).  Each rank phase's timeout is at
most 180 s.

Then this slice's phases:

 flash_wide          head widths 264, 300, 320, 384, 512 and 1024: bf16
                     causal GQA (B = 2, 8 / 2 heads, S = 1024; O's columns
                     in ceil(dh / 256) blocks along the grid, the ``_wide``
                     kernel) and ragged float32 (S = 300; one block holds
                     every width to 1,024) under the gates of ``flash``,
                     the one-column-short fault, the dtype's kernel seen
                     by the profiler; timed beside the plain version,
                     SDPA and the bound; then reduced Whisper with
                     encoder heads of 320 through ``ServeDriver.generate``
                     (one launch per encoder layer, prefill logits held
                     against the plain route, both dtypes);
 ssd_any             the SSD kernel at p = n in {8, 48, 96, 256}, chunks
                     24, 100 and 512 (G streamed at 256 / 512), B / C in
                     one group and in h / 4, both dtypes, under the gates
                     and faults of ``ssd``, one launch on the dtype's
                     route each; then reduced Mamba2 at SSM head width 48,
                     state width 96 and chunk 24 through
                     ``ServeDriver.generate`` on the kernel route against
                     the plain route.

Then this slice's phase:

 grid_wide           both kernels past a grid axis of 65,535 (their tiles
                     on ``build.flat_grid``'s launch grid) and SSD past
                     width 256 (the ``_wide`` kernels), under the gates and
                     faults of ``ssd`` / ``flash``, one launch each on the
                     dtype's route: SSD at b = 2,048, 32 heads, L = chunk
                     = 16, p 64, n 128 in both dtypes (b h = 65,536; bf16
                     is fault 1's shape) and Jamba's layer at b = 256 (256
                     heads in 8 groups, L = chunk = 64, bf16); flash at B
                     = 65,536 (dh 64) and 16,384 (dh 1,024: four column
                     blocks), one head, S = 16, both dtypes, causal and
                     full; SSD at p = n = 320 and 512 (chunks 64 and 256)
                     and p 512 / n 128, B / C in one group and in h / 4,
                     both dtypes, timed at g = 1; then a mamba2-370m bf16
                     prefill of 2,048 prompts of 256 tokens at full width,
                     4 of 48 layers (one SSD launch a layer, tensor-core
                     route), its ms and peak memory, logits and final SSM
                     states against the plain SSD route in slices of 256
                     prompts; and a reduced Mamba2 with SSM heads of 320
                     (state 288, chunk 32) served on the ``_wide`` kernel
                     against the plain route.

The float32 routes of flash and SSD (FP32 on the CUDA cores) are timed
on their own too: ``flash`` at qwen2-1.5b's causal GQA shape,
``flash_dh_any`` at every float32 width, and the kernels line gives them
rows of their own (``flash_attention_f32``, ``ssd_chunk_f32``) beside
the other twelve.

The whole script is kept under 600 s on the H100 (PERF.md has each
phase's seconds).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RTOL = ATOL = 1e-5
TIE = 1e-4
# bf16 summaries: fval of the pod step within tests/test_pod_step_kernel.py's
# bf16 pin; a near-tie within one bf16 ulp (2^-7 = 7.8e-3 relative) of
# its threshold; gains of the kernel route within one bf16 ulp of the plain
# route's (both round float32 gains once)
POD_BF16_TOL, TIE_BF16, GAIN_BF16_TOL = 0.05, 1e-2, 2 ** -7
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
    # qwen2-1.5b's attention in float32: the shape tp_forward's float32
    # run gives the CUDA-core kernel on each rank
    ("qwen2_causal_gqa_f32", 1, 12, 2, 2048, 128, True, "float32", 0.5),
]
FLASH_F32_ROW = "qwen2_causal_gqa_f32"  # the kernels line's float32 case
FLASH_TOL = {"float32": 2e-4, "bfloat16": 2e-2}  # tests/test_kernels.py
# and against the output's own size, max|got - want| / max|want| (one bf16
# ulp is at most 2^-7 = 7.8e-3 of a value)
FLASH_SCALED_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# the case whose check must fail a planted fault: the kernel told to keep
# the 36 padded keys (near-uniform rows give them about 2 % of the weight)
FLASH_CONTROL = "whisper_encoder"
# phase flash_dh96: head width 96, phi3-mini-3.8b's attention
# (src/repro/configs/phi3_mini_3_8b.py: 32 heads of 96, no GQA), and a
# ragged float32 case
FLASH_DH96_CASES = [
    ("phi3_mini_causal", 1, 32, 32, 2048, 96, True, "bfloat16", 0.5),
    ("dh96_ragged_f32", 2, 4, 4, 300, 96, True, "float32", 0.5),
]
# phase whisper: slots, prompt tokens, new tokens; timed generates per
# route and dtype; input draws the prefill logits are held on; the logit
# tolerances of the kernel route against the plain one, and the near-tie
# bound of a first differing token (top-2 plain-route logit gap, relative)
WHISPER_B, WHISPER_PROMPT, WHISPER_NEW = 8, 16, 32
WHISPER_REPS, WHISPER_DRAWS = 1, 2
# the encoder's and the decoder's layers served, of whisper-small's 12 each,
# at full width (the script's time)
WHISPER_LAYERS = 4
WHISPER_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
TOKEN_TIE = 1e-3
# phase ssd: (name, b, L, h, g, p, n, q, dtype, decay), in the model's
# layout with B / C per group (g = h: per head, the JAX signature); Adt =
# -decay * softplus(N(0, 1)) as in tests/test_ssd_kernel.py:15.  The first
# case is the Mamba2-370m prefill (one group), its numbers the kernels
# line's.
SSD_CASES = [
    ("mamba2_prefill", 8, 2048, 32, 1, 64, 128, 256, "bfloat16", 1.0),
    ("mamba2_prefill_per_head", 8, 2048, 32, 32, 64, 128, 256, "bfloat16",
     1.0),
    ("mamba2_prefill_slow_f32", 8, 2048, 32, 1, 64, 128, 256, "float32",
     0.01),
    ("reduced_f32", 2, 64, 8, 1, 16, 16, 16, "float32", 1.0),
]
# elementwise rtol = atol, tests/test_ssd_kernel.py:35; and max|got -
# want| / max|want| (one bf16 ulp is at most 2^-7 = 7.8e-3 of a value)
SSD_F32_ROW = "mamba2_prefill_slow_f32"  # the kernels line's float32 case
SSD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SSD_SCALED_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# phase mamba: slots, prompt tokens, new tokens; timed generates per route
# and dtype; input draws; logit tolerances of the kernel route against the
# plain one
MAMBA_B, MAMBA_PROMPT, MAMBA_NEW = 8, 2000, 32
MAMBA_REPS, MAMBA_DRAWS = 1, 2
MAMBA_LAYERS = 8  # of mamba2-370m's 48, at full width (the script's time)
MAMBA_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# phase pod_sieves: (algorithm, tenants, chunk, pipeline batch) of the
# pods fed by serve + IngestPipeline from a seeded DriftSource; a batch
# brings each tenant 3/4 of its chunk on average, so none overflows.
# Tenants rotate through the tiers' budgets and the lengthscales (the
# DriftSource's clusters lie 90 apart with noise 11 apart: in-cluster
# kernel values 0.37-0.78); every eighth uses linear_norm
SIEVE_PODS = [("sievestreaming++", 64, 1024, 49152),
              ("salsa", 16, 1024, 12288),
              ("quickstream", 16, 256, 2048)]
SIEVE_TIER_K = (10, 50, 100)
SIEVE_LS = (8.0, 9.5, 11.3, 13.5, 16.0)
# the drift check between the two ingests re-arms every small tenant: its
# insertions are at most rungs x K (25 x 10, Salsa 3 x 25 x 10) of about
# 700 items or more
DRIFT_MIN_RATE = {"sievestreaming++": 0.5, "salsa": 1.2, "quickstream": 0.5}
REPLAY_SLOTS = 12  # replayed through pod_step_ref: four of each tier
# phase ingest: device batches of the pod phase's shape through the
# pipeline and through pod.ingest
INGEST_BATCHES = 4
# phase handoff: batches of HANDOFF_SHARE items per session of both pods
# (a victim's parked share plus its next one, 768, stays under the chunk
# of 1,024); the victims of one rebalance (the dry-run cell
# paper-summarizer__handoff__pod256's 8)
HANDOFF_BATCHES, HANDOFF_SHARE, HANDOFF_VICTIMS = 4, 384, 8
# phase pubsub: batches of CHUNK items per session (268 MB), producers,
# broker partitions, frames per producer and batch, front-end read size
PUBSUB_BATCHES, PUBSUB_PRODUCERS, PUBSUB_PARTITIONS = 2, 4, 8
PUBSUB_FRAMES, PUBSUB_READ = 4, 16384
# phase distributed: shards of the paper stream (P x K = 3,200 pooled
# candidates, 3.2 MB: the data/distributed.py docstring's sizing)
DIST_SHARDS = 32
# phase deepseek: deepseek-v2-lite-16b at published widths, cut in depth
# (27 layers: one dense MLA layer, then 26 MLA + MoE layers); slots,
# prompt tokens, new tokens, timed generates; the teacher-forcing check's
# (batch, length, prefilled tokens) and its gate, rtol = atol = 3e-2
# (tests/test_arch_smoke.py:84-92, the reference's own); the gates of two
# routes' prefill logits, float32 and bf16 (WHISPER_TOL, MAMBA_TOL); the
# capacity factor at which dispatch cannot drop (E / top_k = 64 / 6: N
# slots per expert).  Teacher forcing is gated in float32 and printed in
# bf16: there the rounding alone takes the full-width models past the
# reference's gate (shares 1.2-2.7 on an H100, dense models too), and it
# moves some top-k router choices (98 of 3,328 in deepseek's, none in
# float32); the phases print those flips
DEEPSEEK_B, DEEPSEEK_PROMPT, DEEPSEEK_NEW, DEEPSEEK_REPS = 8, 512, 32, 1
# cut from 27 layers to 3 (the dense first layer and 2 MLA + MoE layers)
# to keep the script inside its time (PERF.md has the whole model's
# numbers)
DEEPSEEK_LAYERS = 3
DEEPSEEK_TF = (2, 64, 32)
TF_TOL = 3e-2
ROUTE_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
NO_DROP_CAPACITY = 64 / 6
# phase archs: the five dense architectures at published widths and full
# depth, grok-1-314b at published widths cut to GROK_LAYERS of its 64
# layers (1,179 GiB of float32 parameters do not fit one card), reduced
# jamba-1.5-large-398b served on the SSD kernel, then the SSD kernel at
# the layer shape of Jamba's published config (8 B / C groups of 32 heads)
ARCHS_DENSE = ("qwen2-1.5b", "chatglm3-6b", "phi3-mini-3.8b",
               "phi-3-vision-4.2b", "mistral-nemo-12b")
ARCHS_B, ARCHS_PROMPT, ARCHS_NEW = 8, 128, 8
ARCHS_TF = (1, 16, 8)
GROK_LAYERS = 2
JAMBA_SSD_CASE = ("jamba_layer_g8", 2, 4096, 256, 8, 64, 128, 256,
                  "bfloat16", 1.0)
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


def device_ms(torch, fn, kernels, *, reps=20, setup=None, seen=None,
              windows=3):
    """Device time (ms) per call of ``fn``: the time of every CUDA kernel
    whose name contains one of ``kernels`` (a name or a tuple: all the
    kernels one call launches, the call's own kernel first), summed and
    divided by the number of calls, from ``torch.profiler`` over ``reps``
    calls.  The profiler may miss launches of its window (15 of 20 seen
    on the H100, and in one run every one of them), so the calls are
    counted by the events of the call's own kernel, one per call, not
    taken as ``reps``, and a window that saw none is profiled again, up
    to ``windows`` times.  ``seen`` collects {name: count}.

    After the ``deepseek`` phase's profiled generate the profiler can go
    blind for a while: it records the runtime calls of a window but none
    of its kernels (2 of 20 windows in one run, 8 in a row in another).
    When every window is blind, the calls are timed by CUDA events
    instead (the whole device span of ``reps`` calls over ``reps``),
    ``seen`` stays empty and a ``profiler_blind`` line says so; callers
    that check the route then read the wrapper's route counters."""
    from torch.profiler import ProfilerActivity, profile

    kernels = (kernels,) if isinstance(kernels, str) else tuple(kernels)
    blind = []
    for _ in range(windows):
        argsets = [setup() if setup else () for _ in range(reps)]
        fn(*argsets[0])  # warm
        argsets[0] = setup() if setup else ()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for args in argsets:
                fn(*args)
            torch.cuda.synchronize()
        total, calls, names = 0.0, 0, {}
        events = prof.key_averages()
        for ev in events:
            if any(k in ev.key for k in kernels):
                t = getattr(ev, "self_device_time_total", None)
                if t is None:
                    t = getattr(ev, "self_cuda_time_total", 0.0)
                total += t
                if kernels[0] in ev.key:
                    calls += ev.count
                if t > 0:
                    names[ev.key[:90]] = names.get(ev.key[:90], 0) + ev.count
        if calls and total > 0:
            if seen is not None:
                seen.update(names)
            return total / calls / 1e3
        blind.append(sorted(ev.key[:40] for ev in events))
    argsets = [setup() if setup else () for _ in range(reps)]
    fn(*argsets[0])  # warm
    argsets[0] = setup() if setup else ()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for args in argsets:
        fn(*args)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    emit("profiler_blind", kernel=kernels[0], windows=windows,
         window_events=blind, event_ms=ms)
    return ms


def _route_ran(seen, tensor_core, counts, before):
    """The route a timed call took: from the kernel names the profiler
    saw (one kernel, ``tensor_core`` in the tensor-core kernel's name),
    or, when ``device_ms`` found the profiler blind, from the wrapper's
    route counters (one route launched); "mixed" when more than one
    ran."""
    if seen:
        if len(seen) != 1:
            return "mixed"
        return ("tensor-core" if any(tensor_core in k for k in seen)
                else "cuda-core")
    ran = [r for r in counts if counts[r] > before[r]]
    return ran[0] if len(ran) == 1 else "mixed"


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
SSD_KERNELS = ("ssd_chunk_kernel", "ssd_chunk_mma_kernel")


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
    bit copy of its item, rounded to the summary's dtype)."""
    if rows.shape[0] == 0:
        return []
    hit = (chunk.to(rows.dtype)[:, None, :] == rows[None]).all(-1)
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


def compare_sessions(torch, ker, ref, chunks, n_before, margins, what, *,
                     tie=TIE, tol=RTOL, factors=True, passes=True):
    """Hold a kernel-stepped stacked TSState against the reference under
    the near-tie rule (a first differing accept within ``tie``, relative,
    of its threshold) -> (max abs float error, [near-tie sessions]).
    fval must agree within rtol = atol = ``tol``, and so must L and Linv
    where ``factors`` (else their error is only measured).  n_fused (the
    gain passes) is held only where ``passes``: it counts a pass per
    chunk, so it differs where the two ran the items in other chunks."""
    ties, err = [], 0.0
    S = chunks.shape[0]
    for s in range(S):
        ints_k = [int(ker.ld.n[s]), int(ker.j[s]), int(ker.t[s]),
                  int(ker.n_fused[s]) if passes else 0,
                  int(ker.ld.n_queries[s])]
        ints_r = [int(ref.ld.n[s]), int(ref.j[s]), int(ref.t[s]),
                  int(ref.n_fused[s]) if passes else 0,
                  int(ref.ld.n_queries[s])]
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
            if m is None or m > tie:
                fail(f"{what}: session {s} accepts differ first at item "
                     f"{first} with reference margin {m} (> {tie}); "
                     f"kernel {ints_k}, reference {ints_r}")
            ties.append({"session": s, "item": first, "margin": m})
            continue
        for name in ("L", "Linv"):
            a = getattr(ker.ld, name)[s].float()
            b = getattr(ref.ld, name)[s].float()
            if factors and not torch.allclose(a, b, rtol=tol, atol=tol):
                fail(f"{what}: session {s} {name} off by "
                     f"{(a - b).abs().max().item()}")
            err = max(err, (a - b).abs().max().item())
        fk, fr = ker.ld.fval[s].float(), ref.ld.fval[s].float()
        if not torch.allclose(fk, fr, rtol=tol, atol=tol):
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


def pod_layout(K):
    """The pod step's layout at K_max = K, d = D (kernels.pod_step.layout):
    the tier (Linv in shared or in device memory), the window rows, the
    shared memory of a block and the blocks it lets one SM hold."""
    from repro_torch.kernels.pod_step import layout

    lay = layout(K, D)
    return {"tier": lay.tier, "bt": lay.bt, "smem_bytes": lay.smem_bytes,
            "blocks_per_sm": lay.blocks_per_sm}


def serial_chain(before, after, ms):
    """The longest session's passes in one pod step (its growth in
    n_fused: each pass waits for the append before it) and the step's ms
    spread over them, in us per pass."""
    passes = int((after.n_fused - before.n_fused).max())
    return {"serial_passes": passes,
            "us_per_pass": 1e3 * ms / passes if passes else None}


# ------------------------------------------------------------------ phases
def phase_build(torch):
    from repro_torch.kernels import build
    from repro_torch.obs import get_registry
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
    # instantiations whose ptxas line reports spill stores or loads
    spills = [ln for ln in ptxas
              if "spill" in ln and (" 0 bytes spill stores" not in ln
                                    or " 0 bytes spill loads" not in ln)]
    # the builds as the metrics registry counted them (kernels/build.py)
    counted = ("kernel_build_total", "kernel_build_seconds")
    counters = {f["name"]: {s["labels"]["source"]: s.get("value", s.get("sum"))
                            for s in f["series"]}
                for f in get_registry().snapshot().families
                if f["name"] in counted}
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         per_source_seconds={name: k.build_seconds
                             for name, k in sources.items()},
         ptxas=ptxas, spills=spills, nvcc=build.nvcc_path(), **counters)


def _ptxas_entries(log):
    """(kernel<template arguments>, [spill line, registers line]) per
    entry function of a ``-Xptxas -v`` log."""
    import re

    out = []
    for ln in log.splitlines():
        if "Function properties for" in ln:
            m = re.search(r"([a-z_]+_kernel)(I((?:Li\d+E|Lb[01]E|f|"
                          r"13__nv_bfloat16)+)E)?", ln)
            name = m.group(1) if m else ln.split()[-1]
            if m and m.group(3):
                args = re.findall(r"Li(\d+)E|Lb([01])E|(f)|(13__nv_bfloat16)",
                                  m.group(3))
                name += "<" + ",".join(
                    a or ({"0": "false", "1": "true"}[b] if b else
                          "float" if f else "bf16")
                    for a, b, f, _ in args) + ">"
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
    from repro_torch.tree import leaves_with_keys

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
        layouts = {}
        if name == "ragged":  # Linv in device memory, an 8-row window
            layouts["global_tier_ms"] = timed_ms(torch, lambda s: pod_step(
                algo, s, chunks, counts, backend="cuda", tier="global"),
                reps=5, warmup=1, setup=lambda: (clone_state(before),))
            other = clone_state(before)
            pod_step(algo, other, chunks, counts, backend="cuda",
                     tier="global", window=8)
            a, b = leaves_with_keys(ker), leaves_with_keys(other)
            if not all(torch.equal(a[k], b[k]) for k in a):
                fail("pod_step: the global tier with an 8-row window left "
                     "other bits than the shared tier")
            layouts["global_tier_window_8_bit_equal"] = True
        margins = [dict() for _ in range(S)]
        plain_ms, ref = host_ms(torch, lambda: pod_step_ref(
            algo_ref, ref, chunks, counts, margins=margins))
        err, ties = compare_sessions(torch, ker, ref, chunks, n_before,
                                     margins, f"pod_step {name}")
        resync(ker, ref, [t["session"] for t in ties])
        max_err = max(max_err, err)
        rounds.append({"round": name, "C": C, "ms": ms, **layouts,
                       "plain_ms": plain_ms,
                       **serial_chain(before, ker, ms),
                       "max_abs_err": err, "near_ties": ties,
                       "n": ker.ld.n.tolist()})
    rbf = ker.hp.kernel_kind == 0  # linear_norm rows never get far apart
    if not bool((ker.ld.n == ker.hp.k_cap)[rbf].all()):
        fail("pod_step: the saturating round left an rbf summary below "
             "k_cap")
    emit("pod_step", sessions=S, layout=pod_layout(K_MAX), rounds=rounds,
         max_abs_err=max_err)
    return max_err


def _int_table(state):
    """(S, 5) int32: n, j, t, n_fused, n_queries of a stacked TSState."""
    import torch

    return torch.stack([state.ld.n, state.j, state.t, state.n_fused,
                        state.ld.n_queries], -1)


def phase_pod_bf16(torch, gen):
    """The pod step on bf16 summaries (the carry bf16 in device memory,
    float32 arithmetic) against ``pod_step_ref`` over the rounds of
    ``pod_step``: integers equal, fval within POD_BF16_TOL, L and Linv
    measured; a first differing accept within TIE_BF16 of its threshold
    is a near-tie.  The kernel fed each session's count one short (a
    ragged-edge fault) must fail the integer check.  The ragged round is
    timed beside the same round on float32 state."""
    from repro_torch.core.functions import (KernelConfig, LogDet,
                                            rbf_lengthscale_stream)
    from repro_torch.core.threesieves import ThreeSieves
    from repro_torch.kernels.pod_step import pod_step, pod_step_ref

    def bf16_algo(backend):
        f = LogDet(K=K_MAX, d=D, kernel=KernelConfig(
            "rbf", rbf_lengthscale_stream(D)), dtype=torch.bfloat16,
            backend=backend, device=DEV)
        return ThreeSieves(f=f, T=1000, eps=0.01)

    algo, algo_ref = bf16_algo(None), bf16_algo("torch")
    algo32 = _pod_algos(torch)[0]
    S = 16
    ker = _stacked_tiers(torch, algo, S)
    ref = clone_state(ker)
    rounds, max_err, fault = [], 0.0, None
    plan = [("ragged", CHUNK, 1.0), ("c1", 1, 1.0),
            ("saturate", CHUNK, SPREAD_FAR), ("after_saturation", CHUNK, 1.0)]
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
        timing = {"ms": timed_ms(torch, lambda st: pod_step(
            algo, st, chunks, counts, backend="cuda"), reps=5, warmup=1,
            setup=lambda: (clone_state(before),))}
        if name == "ragged":  # the same round on float32 state
            st32 = _stacked_tiers(torch, algo32, S)
            timing["f32_ms"] = timed_ms(torch, lambda st: pod_step(
                algo32, st, chunks, counts, backend="cuda"), reps=5,
                warmup=1, setup=lambda: (clone_state(st32),))
        pod_step(algo, ker, chunks, counts, backend="cuda")
        margins = [dict() for _ in range(S)]
        plain_ms, ref = host_ms(torch, lambda: pod_step_ref(
            algo_ref, ref, chunks, counts, margins=margins))
        for field in ("feats", "L", "Linv", "fval"):
            if getattr(ker.ld, field).dtype != torch.bfloat16:
                fail(f"pod_bf16 {name}: {field} left bf16")
        err, ties = compare_sessions(torch, ker, ref, chunks, n_before,
                                     margins, f"pod_bf16 {name}",
                                     tie=TIE_BF16, tol=POD_BF16_TOL,
                                     factors=False)
        if name == "after_saturation":
            bad = clone_state(before)
            pod_step(algo, bad, chunks, torch.clamp_min(counts - 1, 0),
                     backend="cuda")
            fault = int((_int_table(bad) != _int_table(ref)).any(-1).sum())
            if not fault:
                fail("pod_bf16: the check passes the kernel fed counts "
                     "one short")
        resync(ker, ref, [t["session"] for t in ties])
        max_err = max(max_err, err)
        rounds.append({"round": name, "C": C, **timing,
                       **serial_chain(before, ker, timing["ms"]),
                       "plain_ms": plain_ms, "max_abs_err": err,
                       "near_ties": ties, "n": ker.ld.n.tolist()})
    pod = _bf16_pod(torch, gen, algo, algo_ref)
    emit("pod_bf16", sessions=S, layout=pod_layout(K_MAX), rounds=rounds,
         max_abs_err=max_err,
         fval_tol=POD_BF16_TOL, tie=TIE_BF16,
         control_counts_short_sessions_failing=fault, summarizer_pod=pod)
    return max_err


def _bf16_pod(torch, gen, algo, algo_ref, ingests=2):
    """A ``SummarizerPod`` of bf16 ThreeSieves tenants (32 sessions in the
    three tiers) through ``route`` and ``ingest_routed`` on the card, each
    ingest replayed through ``pod_step_ref`` under pod_bf16's rules."""
    from repro_torch.kernels.pod_step import KERNEL as POD
    from repro_torch.kernels.pod_step import pod_step_ref
    from repro_torch.serve.summarize import SummarizerPod

    S = 32
    pod = SummarizerPod(algo=algo, sessions=S, chunk=CHUNK, device=DEV)
    state = pod.init()
    for i in range(S):
        state, _, ok = pod.admit(state, 1000 + i, spec=spec_of(i))
        if not bool(ok):
            fail(f"pod_bf16: admit of tenant {i} refused")
    sids = torch.arange(1000, 1000 + S, dtype=torch.int32, device=DEV)
    POD.launches, err, ties = 0, 0.0, []
    for b in range(ingests):
        perm = torch.randperm(S * CHUNK, generator=gen, device=DEV)
        routed = pod.route(state, sids.repeat_interleave(CHUNK)[perm],
                           mixture(torch, gen, S * CHUNK))
        before = clone_state(state.algo)
        state, _ = pod.ingest_routed(state, *routed)
        chunks, counts = routed[0], routed[1]
        margins = [dict() for _ in range(S)]
        ref = pod_step_ref(algo_ref, before, chunks, counts, margins=margins)
        e, t = compare_sessions(torch, state.algo, ref, chunks,
                                before.ld.n, margins, f"pod_bf16 pod {b}",
                                tie=TIE_BF16, tol=POD_BF16_TOL,
                                factors=False)
        err, ties = max(err, e), ties + t
    out = pod.readout(state)
    if POD.launches != ingests or out.feats.dtype != torch.bfloat16:
        fail(f"pod_bf16 pod: {POD.launches} pod-step launches over "
             f"{ingests} ingests, summaries {out.feats.dtype}")
    return {"sessions": S, "ingests": ingests, "launches": POD.launches,
            "n": out.n.tolist(), "max_abs_err": err, "near_ties": ties}


def phase_gain_bf16(torch, gen):
    """A bf16 summary (K = 100, d = 256, n = 100) through the gain
    oracle's kernel route (x, feats and Linv upcast to float32 for the
    float32 kernels, the gains cast back to bf16) against its plain
    route, traced (``gain_traced``) and static (``gain_static``) kernels,
    B = 1024: within one bf16 ulp (GAIN_BF16_TOL).  The summary priced
    without its second half must fail the check.  Timed beside the same call
    on the float32 summary."""
    import dataclasses

    from repro_torch.core.functions import (KernelConfig, LogDet,
                                            rbf_lengthscale_stream)
    from repro_torch.kernelmath import KernelParams
    from repro_torch.tree import tree_map

    # the static kernel prices the summary with the lengthscale it was
    # built with (inv2l2 = D / 2)
    f = LogDet(K=K_MAX, d=D, kernel=KernelConfig(
        "rbf", rbf_lengthscale_stream(D)), dtype=torch.bfloat16, device=DEV)
    plain = dataclasses.replace(f, backend="torch")
    f32 = dataclasses.replace(f, dtype=torch.float32)
    B = 1024
    # candidates and summary rows from one mixture, so that the summary
    # moves the gains (each call of ``mixture`` draws its own centres)
    items = mixture(torch, gen, B + K_MAX)
    X, pool = items[:B], items[B:]
    kern = KernelParams(
        inv2l2=torch.tensor(D / 2.0, dtype=torch.float32, device=DEV),
        kind_id=torch.tensor(0, dtype=torch.int32, device=DEV))
    st = _summary_state(torch, plain, kern, pool, K_MAX)
    st32 = tree_map(lambda t: t.float() if t.is_floating_point() else t, st)
    # the planted fault: the live-row count halved (a summary that lost
    # its last 50 rows; one row moves gains by less than a bf16 ulp here)
    short = dataclasses.replace(st, n=st.n // 2)
    cases, max_err = [], 0.0
    for form, kp, kernels in (("traced", kern, GAIN_TRACED_KERNELS),
                              ("static", None, GAIN_STATIC_KERNELS)):
        got = f.gains(st, X, kp)
        want = plain.gains(st, X, kp)
        torch.cuda.synchronize()
        if got.dtype != torch.bfloat16 or not torch.allclose(
                got.float(), want.float(), rtol=GAIN_BF16_TOL,
                atol=GAIN_BF16_TOL):
            fail(f"gain_bf16 {form}: {got.dtype}, max err "
                 f"{(got.float() - want.float()).abs().max().item()}")
        e = (got.float() - want.float()).abs().max().item()
        bad = f.gains(short, X, kp).float()
        if torch.allclose(bad, want.float(), rtol=GAIN_BF16_TOL,
                          atol=GAIN_BF16_TOL):
            fail(f"gain_bf16 {form}: the check passes the summary "
                 "without its second half")
        bad = (bad - want.float()).abs().max().item()
        max_err = max(max_err, e)
        cases.append({
            "form": form, "max_abs_err": e, "tol": GAIN_BF16_TOL,
            "control_half_summary_max_abs_err": bad,
            "ms": device_ms(torch, lambda: f.gains(st, X, kp), kernels),
            "f32_ms": device_ms(torch, lambda: f32.gains(st32, X, kp),
                                kernels),
            "call_ms": timed_ms(torch, lambda: f.gains(st, X, kp)),
            "f32_call_ms": timed_ms(torch, lambda: f32.gains(st32, X, kp)),
            "plain_ms": timed_ms(torch, lambda: plain.gains(st, X, kp))})
    algos = _bf16_algorithms(torch, gen)
    emit("gain_bf16", shape=[B, K_MAX, D, K_MAX], cases=cases,
         max_abs_err=max_err, algorithms=algos)
    return {"max_abs_err": max_err}


def _bf16_algorithms(torch, gen):
    """ThreeSieves, SieveStreaming (both ``run_batched``) and ISI
    (``run``, with its refactoring replacements) on a bf16 LogDet (K =
    20, d = 256) over 1,024 items of the paper phase's clustered stream,
    the oracle's kernel route against its plain route: n equal, fval
    within POD_BF16_TOL; for the sieves a first differing accept within
    TIE_BF16 of its threshold is a near-tie."""
    from repro_torch.core.baselines import IndependentSetImprovement
    from repro_torch.core.functions import (KernelConfig, LogDet,
                                            rbf_lengthscale_stream)
    from repro_torch.core.sieves import SieveStreaming
    from repro_torch.core.threesieves import ThreeSieves

    X = mixture(torch, gen, 1024, clusters=PAPER_CLUSTERS,
                spread=PAPER_SPREAD)
    out = {}
    for name in ("threesieves", "sievestreaming", "isi"):
        runs = {}
        for backend in (None, "torch"):
            f = LogDet(K=20, d=D, kernel=KernelConfig(
                "rbf", rbf_lengthscale_stream(D)), dtype=torch.bfloat16,
                backend=backend, device=DEV)
            margins = {}
            if name == "threesieves":
                algo = ThreeSieves(f=f, T=50, eps=0.1)
                st = algo.run_batched(algo.init(), X, margins=margins)
            elif name == "sievestreaming":
                algo = SieveStreaming(f=f, eps=0.1)
                st = algo.run_batched(algo.init(), X, margins=margins)
            else:
                algo = IndependentSetImprovement(f=f)
                st = algo.run(algo.init(), X)
            _, n, fval = algo.summary(st)
            runs[backend] = (int(n), fval.float().item(), margins,
                             fval.dtype)
        (nk, fk, _, dk), (nr, fr, mr, _) = runs[None], runs["torch"]
        tie = min(mr.values()) if mr else None
        if dk != torch.bfloat16:
            fail(f"gain_bf16 {name}: fval {dk}, not bf16")
        if nk != nr and not (tie is not None and tie <= TIE_BF16):
            fail(f"gain_bf16 {name}: n {nk} on the kernel route, {nr} on "
                 "the plain route")
        if nk == nr and abs(fk - fr) > POD_BF16_TOL * (1 + abs(fr)):
            fail(f"gain_bf16 {name}: fval {fk} vs {fr}")
        out[name] = {"n": nk, "fval": fk, "plain_n": nr, "plain_fval": fr,
                     "min_plain_margin": tie}
    return out


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
    from repro_torch.kernels.pod_step import pod_step, pod_step_ref
    from repro_torch.tree import tree_map

    rounds, max_err, state_mb = [], 0.0, {}
    for k_max, S, tiers, plan in LARGE_PODS:
        lay = pod_layout(k_max)
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
            rounds.append({"K_max": k_max, "layout": lay,
                           "sessions": S, "round": name,
                           "ms": ms, **serial_chain(before, ker, ms),
                           "plain_ms": plain_ms,
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
    chain = serial_chain(algo_state, ker, dev)
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
         replay={"ms": dev, "call_ms": call, "layout": pod_layout(K_MAX),
                 **chain, "plain_ms": plain_ms, "max_abs_err": err,
                 "near_ties": ties, "bound_ms": b_ms, "bound_by": b_by,
                 "flops": flops, "bytes": nbytes},
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return {"launches": launches["pod_step"], "ms": dev, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
            "ties": ties, **chain}


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
            "max_abs_err": max_err, "X": X, "f_greedy": f_greedy}


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


def _flash_case(torch, gen, case, control, timed=True):
    """One flash case (a FLASH_CASES tuple) against ``attention_ref`` ->
    its JSON record.  ``control`` names the planted fault its check must
    fail: "padded_keys" (the kernel told to keep the padded keys),
    "non_causal" (the kernel of a causal case told to see every key) or
    "short_column" (the kernel fed inputs one column short).  Untimed,
    the route is read from the wrapper's route counters (one launch on
    the dtype's route) and no time is taken."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ROUTE_LAUNCHES as \
        FLASH_ROUTE_LAUNCHES
    from repro_torch.kernels.flash_attention import (ROUTES, attention_ref,
                                                     flash_attention,
                                                     flash_attention_cuda)

    name, B, Hq, Hkv, S, dh, causal, dtype, std = case
    dt = getattr(torch, dtype)
    q = (std * torch.randn(B, Hq, S, dh, generator=gen, device=DEV)).to(dt)
    k = (std * torch.randn(B, Hkv, S, dh, generator=gen, device=DEV)).to(dt)
    v = torch.randn(B, Hkv, S, dh, generator=gen, device=DEV).to(dt)
    routed = dict(FLASH_ROUTE_LAUNCHES)
    got = flash_attention(q, k, v, causal=causal, backend="cuda")
    ran_once = [r for r in routed if FLASH_ROUTE_LAUNCHES[r] > routed[r]]
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
    # the kernel alone on the padded inputs the wrapper hands it
    qp, kp, vp, pad = _padded(q, k, v)
    fault = None
    if control == "short_column":  # a kernel reading dh - 1 columns
        def cut(t):
            return torch.cat([t[..., :-1], torch.zeros_like(t[..., -1:])],
                             -1).contiguous()

        bad = flash_attention_cuda(cut(qp), cut(kp), cut(vp), causal=causal,
                                   kv_len=S)[:, :, :S]
        fault = (bad.float() - want.float()).abs().max().item() / size
        if fault <= scaled_tol:
            fail(f"flash {name}: the check passes the {control} fault "
                 f"({fault} of the largest output, tol {scaled_tol})")
    elif control is not None:
        bad = flash_attention_cuda(
            qp, kp, vp, causal=causal and control != "non_causal",
            kv_len=S + pad if control == "padded_keys" else S)[:, :, :S]
        fault = (bad.float() - want.float()).abs().max().item() / size
        if fault <= scaled_tol:
            fail(f"flash {name}: the check passes the {control} fault "
                 f"({fault} of the largest output, tol {scaled_tol})")

    if not timed:
        if ran_once != [ROUTES[dt].split()[0]]:
            fail(f"flash {name}: {dtype} ran {ran_once}, expected the "
                 f"{ROUTES[dt]} kernel alone")
        return {"case": name, "route": ran_once[0],
                "shape": [B, Hq, Hkv, S, dh], "causal": causal,
                "dtype": dtype, "max_abs_err": e, "tol": tol,
                "scaled_err": e / size, "scaled_tol": scaled_tol,
                "control": control, "control_scaled_err": fault}

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
    seen, before = {}, dict(FLASH_ROUTE_LAUNCHES)
    ms = device_ms(torch, kernel, FLASH_KERNELS[::-1] if dtype ==
                   "bfloat16" else FLASH_KERNELS, seen=seen)
    ran = _route_ran(seen, "wgmma", FLASH_ROUTE_LAUNCHES, before)
    if not ROUTES[dt].startswith(ran):
        fail(f"flash {name}: {dtype} ran {sorted(seen) or ran}, expected "
             f"the {ROUTES[dt]} kernel alone")
    return {
        "case": name, "route": ran, "kernels_seen": seen,
        "shape": [B, Hq, Hkv, S, dh], "causal": causal,
        "dtype": dtype, "qk_std": std, "padded_to": S + pad,
        "max_abs_err": e, "tol": tol, "max_abs_want": size,
        "scaled_err": e / size, "scaled_tol": scaled_tol,
        "control": control, "control_scaled_err": fault,
        "ms": ms, "call_ms": timed_ms(torch, lambda: (
            flash_attention(q, k, v, causal=causal, backend="cuda"))),
        "plain_ms": timed_ms(torch, lambda: attention_ref(
            q, k, v, causal=causal)),
        "library_ms": timed_ms(torch, library),
        "library_max_abs_err": lib_err,
        "library_scaled_err": lib_err / size, "bound_ms": b_ms,
        "bound_by": b_by, "flops": flops, "bytes": nbytes,
        "tflops": flops / ms / 1e9}


def phase_flash(torch, gen):
    """The flash-attention kernel against ``attention_ref`` in the cases
    of FLASH_CASES, timed beside the plain version and SDPA; at the
    control case, a planted fault (padded keys kept) must fail the
    check."""
    from repro_torch.kernels.flash_attention import KERNEL, ROUTES

    # the built library's SASS: the bf16 kernel's products on the tensor
    # cores show as HGMMA (wgmma) or HMMA (mma.sync)
    sass = sass_counts(KERNEL, ("HGMMA", "HMMA", "UTMALDG"))
    emit("flash_sass", library=KERNEL.so_path().name, **sass)
    if not (sass["HGMMA"] or sass["HMMA"]):
        fail(f"flash: no tensor-core instruction in the SASS ({sass})")
    cases = [_flash_case(torch, gen, case, "padded_keys"
                         if case[0] == FLASH_CONTROL else "non_causal"
                         if case[0] == FLASH_F32_ROW else None)
             for case in FLASH_CASES]
    max_err = max(c["max_abs_err"] for c in cases)
    emit("flash", cases=cases, max_abs_err=max_err,
         routes={str(k).replace("torch.", ""): v for k, v in ROUTES.items()},
         library="torch.nn.functional.scaled_dot_product_attention")
    return {"max_abs_err": max_err, **cases[0],
            "f32": next(c for c in cases if c["case"] == FLASH_F32_ROW)}


def phase_flash_dh96(torch, gen):
    """Head width 96 on both routes: phi3-mini-3.8b's attention (32 / 32
    heads, S = 2048, causal, bf16: the tensor-core kernel in 64-byte
    swizzled column blocks) timed against SDPA, and a ragged float32 case;
    the kernel of a causal case told to see every key must fail the
    check (under the causal mask the padded keys are never seen)."""
    cases = [_flash_case(torch, gen, case, "non_causal" if case[6]
                         else "padded_keys") for case in FLASH_DH96_CASES]
    emit("flash_dh96", cases=cases,
         max_abs_err=max(c["max_abs_err"] for c in cases),
         library="torch.nn.functional.scaled_dot_product_attention")
    return {"max_abs_err": max(c["max_abs_err"] for c in cases)}


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
    full = get_config("whisper-small", use_pallas_attention=True)
    base = dataclasses.replace(
        full, n_layers=WHISPER_LAYERS, encoder=dataclasses.replace(
            full.encoder, n_layers=WHISPER_LAYERS))
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
         cut={"layers": WHISPER_LAYERS, "of": full.n_layers,
              "encoder_layers": WHISPER_LAYERS,
              "encoder_of": full.encoder.n_layers},
         prompt=P, new_tokens=N, frames=n_frames, draws=WHISPER_DRAWS,
         runs=runs)
    return {"launches": launches}

def ssd_work(b, h, g, c, q, p, n, esize):
    """The least work of one SSD intra-chunk call with B / C per group ->
    (FLOP, bytes): per (batch, chunk) and live (query, key) pair, q (q +
    1) / 2 pairs per chunk, 2 n FLOP per group for G = C B^T and 2 p per
    head for S X; 2 n p per key and head for the end-state; one read of
    X, Adt, B, C and one write of Y (in the input type) and the float32
    states."""
    pairs = b * c * (q * (q + 1) // 2)
    flops = pairs * (2 * n * g + 2 * p * h) + b * c * h * 2 * q * n * p
    nbytes = b * c * (esize * q * (2 * h * p + h + 2 * g * n)
                      + 4 * h * n * p)
    return flops, nbytes


def ssd_errors(torch, got, want, tol):
    """-> (max abs error, error over the largest output, whether every
    element is within rtol = atol = tol)."""
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    return err, err / w.abs().max().item(), torch.allclose(g, w, rtol=tol,
                                                           atol=tol)


def _without_diagonal(X, B, C, Y):
    """A planted fault of phase ssd: the plain output with the diagonal
    of L (exp(0) = 1) dropped, so each step misses its own input: Y minus
    (C_i . B_i) X_i (model layout, B / C per group)."""
    h, g = X.shape[2], B.shape[2]
    cb = (C.float() * B.float()).sum(-1, keepdim=True)
    return (Y.float() - cb.repeat_interleave(h // g, dim=2)
            * X.float()).to(Y.dtype)


def _ssd_inputs(torch, gen, b, L, h, g, p, n, dtype, decay):
    import torch.nn.functional as F

    dt = getattr(torch, dtype)
    X = torch.randn(b, L, h, p, generator=gen, device=DEV).to(dt)
    Adt = (-decay * F.softplus(torch.randn(b, L, h, generator=gen,
                                           device=DEV))).to(dt)
    B = torch.randn(b, L, g, n, generator=gen, device=DEV).to(dt)
    C = torch.randn(b, L, g, n, generator=gen, device=DEV).to(dt)
    return X, Adt, B, C


def phase_ssd(torch, gen):
    """The SSD intra-chunk kernel against its plain version in the cases
    of SSD_CASES, timed beside it; the route each dtype took (bf16: the
    tensor-core kernel, float32: the CUDA-core one, from the profiler's
    kernel names); in every case the plain version without the diagonal,
    and in bf16 the kernel fed Adt shifted by one step, must fail the
    check (the margin: the fault's error over the gate)."""
    from repro_torch.kernels.ssd_chunk import ROUTES

    cases = [_ssd_case(torch, gen, case) for case in SSD_CASES]
    max_err = max(max(c["y_max_abs_err"], c["state_max_abs_err"])
                  for c in cases)
    emit("ssd", cases=cases, max_abs_err=max_err, library=None,
         routes={str(k).replace("torch.", ""): v for k, v in ROUTES.items()})
    return {"max_abs_err": max_err, **cases[0],
            "f32": next(c for c in cases if c["case"] == SSD_F32_ROW)}


def _ssd_case(torch, gen, case, timed=True):
    """One case of SSD_CASES (or the Jamba layer's, or SSD_ANY_CASES'):
    the kernel against its plain version under the gates, one launch on
    the dtype's route (the wrapper's counters), the planted faults, and,
    when ``timed``, the route from the profiler, the times and both
    bounds -> the case's line."""
    from repro_torch.kernels.ssd_chunk import KERNEL as SSD
    from repro_torch.kernels.ssd_chunk import ROUTE_LAUNCHES as \
        SSD_ROUTE_LAUNCHES
    from repro_torch.kernels.ssd_chunk import (ROUTES, ssd_chunk_cuda,
                                               ssd_chunks)

    name, b, L, h, g, p, n, q, dtype, decay = case
    dt = getattr(torch, dtype)
    c = L // q
    X, Adt, B, C = _ssd_inputs(torch, gen, b, L, h, g, p, n, dtype,
                               decay)
    launched, routed = SSD.launches, dict(SSD_ROUTE_LAUNCHES)
    Y, st = ssd_chunk_cuda(X, Adt, B, C, chunk=q)
    want_route = ROUTES[dt].split()[0]
    if SSD.launches != launched + 1 or any(
            SSD_ROUTE_LAUNCHES[r] - routed[r] != (r == want_route)
            for r in routed):
        fail(f"ssd {name}: {SSD.launches - launched} launches, routes "
             f"{SSD_ROUTE_LAUNCHES} from {routed}; want one on the "
             f"{want_route} kernel")
    Yr, sr = ssd_chunks(X, Adt, B, C, chunk=q, backend="torch")
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
    controls = {}
    bad = _without_diagonal(X, B, C, Yr)
    controls["strict_tril"] = ssd_errors(torch, bad, Yr, tol)
    del bad
    if dt == torch.bfloat16:
        shifted = torch.cat([Adt[:, :1], Adt[:, :-1]], 1)
        controls["shifted_adt"] = ssd_errors(
            torch, ssd_chunk_cuda(X, shifted, B, C, chunk=q)[0], Yr, tol)
        del shifted
    for fault, (c_err, c_scaled, c_ok) in controls.items():
        if c_ok and c_scaled <= scaled_tol:
            fail(f"ssd {name}: the check passes the {fault} fault "
                 f"({c_err}, {c_scaled} of the largest)")
    flops, nbytes = ssd_work(b, h, g, c, q, p, n, X.element_size())
    peak = PEAK_BF16 if dt == torch.bfloat16 else PEAK_FP32
    b_ms, b_by = bound(flops, nbytes, peak)
    per_head_ms, per_head_by = bound(*ssd_work(b, h, h, c, q, p, n,
                                               X.element_size()), peak)
    out = {
        "case": name, "shape": [b, L, h, g, p, n, q], "dtype": dtype,
        "route": want_route, "decay": decay,
        "y_max_abs_err": y_err, "y_scaled_err": y_scaled,
        "state_max_abs_err": s_err, "state_scaled_err": s_scaled,
        "tol": tol, "scaled_tol": scaled_tol,
        **{f"control_{k}_scaled_err": v[1] for k, v in controls.items()},
        "bound_ms": b_ms, "bound_by": b_by}
    if not timed:
        del X, Adt, B, C, Y, st, Yr, sr
        return out
    seen, before = {}, dict(SSD_ROUTE_LAUNCHES)
    ms = device_ms(torch, lambda: ssd_chunk_cuda(X, Adt, B, C, chunk=q),
                   SSD_KERNELS[::-1] if dtype == "bfloat16"
                   else SSD_KERNELS, seen=seen)
    ran = _route_ran(seen, "mma", SSD_ROUTE_LAUNCHES, before)
    if not ROUTES[dt].startswith(ran):
        fail(f"ssd {name}: {dtype} ran {sorted(seen) or ran}, expected the "
             f"{ROUTES[dt]} kernel alone")
    out.update({
        "route": ran,
        "acum_min": Adt.float().reshape(b, c, q, h).sum(2).min().item(),
        "y_share_differing": (Y != Yr).float().mean().item(),
        "max_abs_want": Yr.float().abs().max().item(),
        **{f"control_{k}_max_abs_err": v[0] for k, v in controls.items()},
        **{f"control_{k}_margin": v[1] / scaled_tol
           for k, v in controls.items()},
        "ms": ms, "call_ms": timed_ms(torch, lambda: ssd_chunks(
            X, Adt, B, C, chunk=q, backend="cuda")),
        "plain_ms": timed_ms(torch, lambda: ssd_chunks(
            X, Adt, B, C, chunk=q, backend="torch")),
        "bound_per_head_ms": per_head_ms,
        "bound_per_head_by": per_head_by, "flops": flops,
        "bytes": nbytes, "tflops": flops / ms / 1e9,
        "tb_per_s": nbytes / ms / 1e9})
    del X, Adt, B, C, Y, st, Yr, sr
    return out


class _Route:
    """Swap module attributes (``(module, name, value)`` triples) for a
    block, then restore them."""

    def __init__(self, *swaps):
        self.swaps = swaps

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n, _ in self.swaps]
        for m, n, v in self.swaps:
            setattr(m, n, v)

    def __exit__(self, *exc):
        for m, n, v in self.saved:
            setattr(m, n, v)


def _SsdRoute(fn):
    """Swap ``models.mamba.ssd_chunks``, the prefill's SSD route, for
    ``fn`` for a block, then restore it."""
    from repro_torch.models import mamba

    return _Route((mamba, "ssd_chunks", fn))


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


def _recording_ssd(calls):
    """The kernel route, recording for each call the heads, the B / C
    groups it was handed, and whether X, B and C were read in place (rows
    on 16 bytes, no copy before the launch)."""
    from repro_torch.kernels.ssd_chunk import ssd_chunks
    from repro_torch.kernels.ssd_chunk.kernel import reads_in_place

    def route(X, Adt, B, C, *, chunk):
        calls.append({"heads": X.shape[2], "groups": B.shape[2],
                      "in_place": all(reads_in_place(t)
                                      for t in (X, B, C))})
        return ssd_chunks(X, Adt, B, C, chunk=chunk, backend="cuda")

    return route


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
    from repro_torch.kernels.ssd_chunk import ROUTE_LAUNCHES
    from repro_torch.models import Model, init_cache
    from repro_torch.serve import ServeDriver, make_prefill_step
    from repro_torch.tree import leaves_with_keys

    kernels = (GAIN, STATIC, POD, FLASH, SSD)
    B, P, N = MAMBA_B, MAMBA_PROMPT, MAMBA_NEW
    base = dataclasses.replace(get_config("mamba2-370m"),
                               n_layers=MAMBA_LAYERS)
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

        # tokens: the kernel route against the plain route; the warm-up
        # generate records what each SSD launch was handed
        driver = ServeDriver(model=model, max_seq=max_seq, batch=B)
        ssd_calls = []
        with _SsdRoute(_recording_ssd(ssd_calls)):
            out = driver.generate(params, prompts, N)  # warms
        groups = cfg.ssm.n_groups
        if len(ssd_calls) != cfg.n_layers or any(
                c["groups"] != groups or (dtype == "bfloat16"
                                          and not c["in_place"])
                for c in ssd_calls):
            fail(f"mamba {dtype}: the SSD route was handed {ssd_calls[:2]} "
                 f"({len(ssd_calls)} calls); expected {cfg.n_layers} calls "
                 f"with B / C per group ({groups}), read in place in bf16")
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
        routed = dict(ROUTE_LAUNCHES)
        timing, lns = _generates(torch, driver, kernels, lambda: (
            driver.generate(params, prompts, N)), N, MAMBA_REPS)
        peak = torch.cuda.max_memory_allocated()
        for ln in lns:
            if ln["ssd_chunk"] != cfg.n_layers or any(
                    v for k, v in ln.items() if k != "ssd_chunk"):
                fail(f"mamba {dtype}: launches {ln}, expected "
                     f"{cfg.n_layers} ssd_chunk per generate")
        # the route of those launches, per generate
        routes = {r: (ROUTE_LAUNCHES[r] - routed[r]) / len(lns)
                  for r in ROUTE_LAUNCHES}
        want = "tensor-core" if dtype == "bfloat16" else "cuda-core"
        if routes[want] != cfg.n_layers:
            fail(f"mamba {dtype}: SSD routes per generate {routes}, "
                 f"expected {cfg.n_layers} on the {want} kernel")
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
            "ssd_routes_per_generate": routes,
            "ssd_inputs": {"calls": len(ssd_calls), "groups": groups,
                           "heads": ssd_calls[0]["heads"],
                           "in_place": sum(c["in_place"]
                                           for c in ssd_calls)},
            "tokens_equal_rows": equal, "near_ties": ties,
            "min_plain_gap": min(min(g) for g in gaps),
            "logits_max_abs_err": logit_errs, "tol": tol,
            "control_shifted_adt_logits_max_abs_err": control,
            **timing, "plain": plain_timing, "peak_mem_gib": peak / 2 ** 30}

        if dtype == base.dtype:  # where the serving run's device time goes
            wall, busy, by = _profile(torch, lambda: driver.generate(
                params, prompts, N))
            ssd = sum(t for t, _, k in by
                      if any(n in k for n in SSD_KERNELS))
            # layout copies and B / C repeats: ATen's copy and index kernels
            copies = sum(t for t, _, k in by
                         if "copy" in k or "index" in k.lower())
            runs[dtype]["profile"] = {
                "wall_ms": wall, "device_busy_ms": busy,
                "idle_share": 1 - busy / wall, "ssd_ms": ssd,
                "ssd_share_of_prefill": ssd / timing["prefill_ms"]["median"],
                "copy_and_index_kernels_ms": copies,
                "top": [{"ms": t, "count": c, "kernel": k}
                        for t, c, k in by[:12]]}
    emit("mamba", arch="mamba2-370m", params=n_params,
         cut={"layers": MAMBA_LAYERS,
              "of": get_config("mamba2-370m").n_layers},
         params_analytic=base.param_count(), batch=B, prompt=P,
         padded_to=-(-P // base.ssm.chunk) * base.ssm.chunk, new_tokens=N,
         draws=MAMBA_DRAWS, runs=runs)
    return {"launches": launches}


# ------------------------------------------------ this slice: the front end
def _sieve_spec(name, i):
    from repro_torch.core.spec import SessionSpec

    return SessionSpec(algo=name, K=SIEVE_TIER_K[i % 3], eps=PAPER_EPS, d=D,
                       lengthscale=SIEVE_LS[i % len(SIEVE_LS)],
                       kernel_kind="linear_norm" if i % 8 == 7 else "rbf")


def _intervals_idle(intervals, span):
    """1 - (the union of the busy intervals) / span."""
    busy, end = 0.0, 0.0
    for a, b in sorted(intervals):
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    return 1.0 - busy / span if span > 0 else None


def _pipeline_batches(timings, items):
    """Per device batch of a pipeline run: the host's ms drawing it from
    the feed and staging it in pinned memory, the
    copy's and the step's device ms, the batch's share of the device
    timeline (step end to step end) and its items/s; and the device's
    idle share over the run (copy and step intervals)."""
    rows, prev = [], 0.0
    for tm in timings:
        h2d, step = tm["h2d"], tm["step"]
        interval = step[1] - prev
        rows.append({"source_ms": tm["source_ms"],
                     "stage_ms": tm["stage_ms"], "h2d_ms": h2d[1] - h2d[0],
                     "step_ms": step[1] - step[0], "interval_ms": interval,
                     "items_per_s": items / (interval / 1e3)})
        prev = step[1]
    idle = _intervals_idle([tm["h2d"] for tm in timings]
                           + [tm["step"] for tm in timings],
                           timings[-1]["step"][1] if timings else 0.0)
    return rows, idle


def _slot_rows(state, idx):
    from repro_torch.tree import tree_map

    return tree_map(lambda l: l[idx], state)


def _replay_ingest(torch, name, algo, plain, before, after, chunks, counts,
                   idx):
    """One ingest of the slots ``idx`` again from ``before``, through
    ``pod_step_ref`` (plain gains) and through the per-slot loop on the
    kernel, each held against the pod's state ``after`` under the
    near-tie rule -> the replay's record."""
    from repro_torch.kernels.pod_step import pod_step_ref
    from repro_torch.tree import leaves_with_keys

    sub_before = _slot_rows(before, idx)
    sub_chunks, sub_counts = chunks[idx], counts[idx]
    margins = [dict() for _ in range(len(idx))]
    plain_s = time.perf_counter()
    ref = pod_step_ref(plain, sub_before, sub_chunks, sub_counts,
                       margins=margins)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - plain_s
    loop = pod_step_ref(algo, sub_before, sub_chunks, sub_counts)
    ker = _slot_rows(after, idx)
    errs, ties = {"plain": 0.0, "loop": 0.0}, []
    for what, other in (("plain", ref), ("loop", loop)):
        for j in range(len(idx)):
            e, tie = hold_states(
                torch, _slot_rows(ker, j), _slot_rows(other, j),
                _slot_rows(sub_before, j), sub_chunks[j], margins[j],
                f"pod_sieves {name} slot {int(idx[j])}"
                + ("" if what == "plain" else
                   " (per-slot loop on the kernel)"))
            errs[what] = max(errs[what], e)
            if tie:
                ties.append({"slot": int(idx[j]), "against": what, **tie})
    la, lb = leaves_with_keys(ker), leaves_with_keys(loop)
    return {"slots": idx.tolist(), "max_abs_err": errs["plain"],
            "near_ties": ties, "plain_s": plain_s,
            "kernel_loop_bit_equal": all(torch.equal(la[k], lb[k])
                                         for k in la),
            "kernel_loop_max_abs_err": errs["loop"]}


def phase_pod_sieves(torch, gen, seed):
    """Pods of SieveStreaming++, Salsa and QuickStream tenants on the
    card, each fed by ``serve`` + ``IngestPipeline`` from a seeded
    ``DriftSource``: one ingest, a drift check, a second ingest; both
    ingests replayed through ``pod_step_ref`` for slots of every tier."""
    import numpy as np

    from repro_torch.core.api import make
    from repro_torch.core.functions import KernelConfig, naive_logdet
    from repro_torch.core.spec import SessionSpec
    from repro_torch.ingest import DriftSource, IngestPipeline
    from repro_torch.kernels.pod_step import KERNEL as POD
    from repro_torch.kernels.rbf_gain import KERNEL as GAIN
    from repro_torch.kernels.rbf_gain import gain_traced, gain_traced_ref
    from repro_torch.kernelmath import KernelParams
    from repro_torch.serve.summarize import SummarizerPod
    from repro_torch.tree import leaves_with_keys

    result = {"launches": 0, "max_abs_err": 0.0, "pods": []}
    for name, S, C, B in SIEVE_PODS:
        stacked = name != "quickstream"
        base = SessionSpec(algo=name, K=K_MAX, eps=PAPER_EPS, d=D,
                           lengthscale=SIEVE_LS[0])
        algo = make(base, device=DEV)
        plain = make(base.replace(backend="torch"), device=DEV)
        pod = SummarizerPod(algo=algo, sessions=S, chunk=C, device=DEV)
        ids = np.arange(5000, 5000 + S, dtype=np.int32)
        state = pod.init()
        for i in range(S):
            state, _, ok = pod.admit(state, int(ids[i]), spec=(
                _sieve_spec(name, i) if stacked else None))
            if not bool(ok):
                fail(f"pod_sieves {name}: admit of tenant {i} refused")

        def source():
            return DriftSource(seed=seed, n_sessions=S, batch=B, d=D,
                               n_components=8, drift_per_batch=0.5,
                               session_ids=ids, n_batches=2)

        timings = []
        # the state after the first ingest, taken at the run's sync
        # boundary, before serve's drift check resets a tier
        firsts = []
        pipe = IngestPipeline(pod, source=source(), batch=B, timings=timings,
                              on_sync=lambda st: firsts.append(
                                  clone_state(st.algo)))
        before1 = clone_state(state.algo)
        torch.cuda.synchronize()
        GAIN.launches = POD.launches = 0  # the main path starts here
        state, s1 = pod.serve(state, pipe, max_batches=1, drift_every=1,
                              min_items=B // S // 2,
                              min_rate=DRIFT_MIN_RATE[name])
        rounds = [GAIN.launches]
        pipe.on_sync = None
        after1 = firsts[0]
        before = clone_state(state.algo)
        state, s2 = pod.serve(state, pipe, max_batches=1)
        out = pod.readout(state)
        torch.cuda.synchronize()
        rounds.append(GAIN.launches - rounds[0])
        if POD.launches:
            fail(f"pod_sieves {name}: the ThreeSieves kernel ran")
        if stacked and min(rounds) < 1:
            fail(f"pod_sieves {name}: an ingest launched no gain_traced "
                 f"({rounds})")
        result["launches"] += GAIN.launches
        drops = (s1["dropped_unknown"] + s1["dropped_overflow"]
                 + s2["dropped_unknown"] + s2["dropped_overflow"]
                 + int(out.drops["overflow"].sum())
                 + int(out.drops["unknown"]))
        if drops:
            fail(f"pod_sieves {name}: {drops} items dropped")
        n = out.n.tolist()
        tier = [SIEVE_TIER_K[i % 3] for i in range(S)]
        resets = state.resets.tolist()
        if stacked and not all(resets[i] for i in range(S)
                               if tier[i] == SIEVE_TIER_K[0]):
            fail(f"pod_sieves {name}: the drift check left a small tenant "
                 f"armed ({resets})")
        fe = 0.0
        for i in range(S):
            k_cap = tier[i] if stacked else K_MAX
            if not 0 < n[i] <= k_cap:
                fail(f"pod_sieves {name}: tenant {i} holds {n[i]} items, "
                     f"cap {k_cap}")
            sp = _sieve_spec(name, i) if stacked else base
            kc = KernelConfig(sp.kernel_kind, sp.lengthscale)
            want = naive_logdet(out.feats[i, :n[i]].double(), kc, 1.0)
            got = out.fval[i].double()
            if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
                fail(f"pod_sieves {name}: tenant {i} fval {got.item()} vs "
                     f"slogdet {want.item()}")
            fe = max(fe, (got - want).abs().item())
        ingests = []
        for s, r, tm in zip((s1, s2), rounds, timings):
            step = tm["step"][1] - tm["step"][0]
            ingests.append({"s": s["wall_s"], "items": s["items"],
                            "items_per_s": s["items"] / s["wall_s"],
                            "rounds": r,
                            "ms_per_round": step / r if r else None,
                            "source_ms": tm["source_ms"],
                            "stage_ms": tm["stage_ms"],
                            "h2d_ms": tm["h2d"][1] - tm["h2d"][0],
                            "step_ms": step})
        rec = {"algo": name, "sessions": S, "chunk": C, "batch": B,
               "ingests": ingests, "gain_traced_launches": GAIN.launches,
               "resets": {k: sum(resets[i] for i in range(S)
                                 if tier[i] == k) for k in SIEVE_TIER_K}
               if stacked else sum(resets),
               "summary_sizes": {k: [min(n[i] for i in range(S)
                                         if tier[i] == k),
                                     max(n[i] for i in range(S)
                                         if tier[i] == k)]
                                 for k in SIEVE_TIER_K} if stacked
               else [min(n), max(n)],
               "accepts": int(state.accepts.sum()),
               "fval_vs_slogdet_max_err": fe,
               "state_mb": sum(t.numel() * t.element_size() for t in
                               leaves_with_keys(state.algo).values()) / 1e6}
        if stacked:
            # both ingests again: their batches, routed as the pod did
            # (the slot table is the same in both)
            routed = [pod.route(state, torch.from_numpy(sids).to(DEV),
                                torch.from_numpy(X).to(DEV))[:2]
                      for sids, X in source()]
            I = before.lds.n.shape[1]
            rec["instances_per_round"] = S * I
            per_tier = REPLAY_SLOTS // 3
            idx = torch.tensor(
                [i for k in range(3) for i in range(k, S, 3)[:per_tier]],
                device=DEV)
            rec["replay"] = [
                _replay_ingest(torch, f"{name} ingest {n + 1}", algo, plain,
                               b0, b1, *routed[n], idx)
                for n, (b0, b1) in enumerate(((before1, after1),
                                              (before, state.algo)))]
            result["max_abs_err"] = max(
                [result["max_abs_err"]]
                + [r["max_abs_err"] for r in rec["replay"]])
            chunks = routed[1][0]
            # the grouped gain pass of the second ingest's first round:
            # every slot's chunk against all its rungs, one launch
            lds, hp = before.lds, before.hp
            feats = lds.feats.flatten(0, 1)
            linv = lds.Linv.flatten(0, 1)
            ns = lds.n.flatten()
            inv2l2 = hp.inv2l2.contiguous()
            kind = hp.kernel_kind.contiguous()

            def grouped():
                return gain_traced(chunks, feats, linv, ns, inv2l2, kind,
                                   a=1.0)

            def grouped_plain():
                return gain_traced_ref(chunks, feats, linv, ns,
                                       KernelParams(inv2l2, kind), a=1.0)

            got, want = grouped(), grouped_plain()
            e = (got - want).abs().max().item()
            if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
                fail(f"pod_sieves {name}: grouped gain_traced off by {e}")
            one = gain_traced(chunks[:1], feats[:I], linv[:I], ns[:I],
                              inv2l2[:1], kind[:1], a=1.0)
            flat = gain_traced(chunks[0], feats[:I], linv[:I], ns[:I],
                               inv2l2[:1], kind[:1], a=1.0)
            if not torch.equal(one, flat) or not torch.equal(one, got[:I]):
                fail(f"pod_sieves {name}: one group is not the ungrouped "
                     "call bit for bit")
            b_ms, b_by = bound(*gain_work(C, ns.tolist()))
            # ms: CUDA events around the call (both kernels, milliseconds
            # long, so the launch gaps are noise; the profiler missed
            # every launch of a five-call window once)
            rec["grouped_gain"] = {
                "shape": [S, I, C, K_MAX, D], "max_abs_err": e,
                "g1_bit_equal": True,
                "ms": timed_ms(torch, grouped, reps=10),
                "plain_ms": timed_ms(torch, grouped_plain, reps=3,
                                     warmup=1),
                "bound_ms": b_ms, "bound_by": b_by}
            result["max_abs_err"] = max(result["max_abs_err"], e)
            if name == SIEVE_PODS[0][0]:
                result["grouped_gain"] = rec["grouped_gain"]
        emit("pod_sieves", **rec)
        result["pods"].append(rec)
    return result


def phase_ingest(torch, gen):
    """The ThreeSieves pod of phase ``pod`` fed by ``IngestPipeline``
    from host batches, against the same batches through ``pod.ingest``:
    the final states bit-equal, no drops; per batch the stages' times."""
    from repro_torch.ingest import IngestPipeline, ReplaySource
    from repro_torch.kernels.pod_step import KERNEL as POD
    from repro_torch.serve.summarize import SummarizerPod
    from repro_torch.tree import leaves_with_keys

    algo, _ = _pod_algos(torch)
    pod = SummarizerPod(algo=algo, sessions=SESSIONS, chunk=CHUNK, device=DEV)
    state0 = pod.init()
    for i in range(SESSIONS):
        state0, _, ok = pod.admit(state0, 1000 + i, spec=spec_of(i))
        if not bool(ok):
            fail(f"ingest: admit of tenant {i} refused")
    N = SESSIONS * CHUNK
    sids = torch.arange(1000, 1000 + SESSIONS, dtype=torch.int32,
                        device=DEV).repeat_interleave(CHUNK)
    host, dev = [], []
    for _ in range(INGEST_BATCHES):
        perm = torch.randperm(N, generator=gen, device=DEV)
        tags, X = sids[perm], mixture(torch, gen, N)
        dev.append((tags, X))
        host.append((tags.cpu().numpy(), X.cpu().numpy()))
    torch.cuda.synchronize()

    # the direct path: each batch on the card through route + the step
    # (after one untimed ingest, so no path pays the kernels' first load)
    pod.ingest(clone_state(state0), *dev[0])
    state = clone_state(state0)
    POD.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    marks = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for tags, X in dev:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        routed = pod.route(state, tags, X)
        ev[1].record()
        state, _ = pod.ingest_routed(state, *routed)
        ev[2].record()
        marks.append(ev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = POD.launches
    direct = state
    spans = [(start.elapsed_time(a), start.elapsed_time(b),
              start.elapsed_time(c)) for a, b, c in marks]
    rows, prev = [], 0.0
    for a, b, c in spans:
        rows.append({"route_ms": b - a, "step_ms": c - b,
                     "interval_ms": c - prev,
                     "items_per_s": N / ((c - prev) / 1e3)})
        prev = c
    report = {"direct": {
        "s": wall, "items_per_s": INGEST_BATCHES * N / wall,
        "launches": launches, "batches": rows,
        "idle_share": _intervals_idle([(a, c) for a, _, c in spans],
                                      spans[-1][2])}}
    if launches != INGEST_BATCHES:
        fail(f"ingest: direct path launched pod_step {launches} times")
    want = leaves_with_keys(direct)
    timings = []
    pipe = IngestPipeline(pod, source=ReplaySource.from_batches(host),
                          batch=N, timings=timings)
    st = clone_state(state0)
    torch.cuda.synchronize()
    POD.launches = 0  # this path's launches
    st, stats = pipe.run(st)
    n_launch = POD.launches
    launches += n_launch
    got = leaves_with_keys(st)
    diff = [k for k in want if not torch.equal(want[k], got[k])]
    if diff:
        fail(f"ingest: the pipeline's final state differs from direct "
             f"ingest in {diff}")
    drops = (stats["dropped_unknown"] + stats["dropped_overflow"]
             + int(st.drops_overflow.sum()) + int(st.drops_unknown.sum()))
    if drops or n_launch != INGEST_BATCHES:
        fail(f"ingest: the pipeline had {drops} drops, {n_launch} "
             "pod_step launches")
    rows, idle = _pipeline_batches(timings, N)
    report["pipeline"] = {
        "route": "the card's: the tagged batch copied from pinned memory "
                 "on a side stream, then SummarizerPod.route",
        "s": stats["wall_s"], "items_per_s": stats["items"]
        / stats["wall_s"], "launches": n_launch, "batches": rows,
        "idle_share": idle, "bit_equal_to_direct": True}
    emit("ingest", sessions=SESSIONS, chunk=CHUNK, items_per_batch=N,
         batches=INGEST_BATCHES, drops=0, **report)
    return {"launches": launches}


# ------------------------------------------------- checkpoints and handoff
def _admitted(pod, base, n, first=0):
    """``pod.init()`` with tenants ``base + i`` (first <= i < first + n)
    in spec_of(i)'s tier admitted."""
    state = pod.init()
    for i in range(first, first + n):
        state, _, ok = pod.admit(state, base + i, spec=spec_of(i))
        if not bool(ok):
            fail(f"admit of tenant {base + i} refused")
    return state


def _tagged_batch(torch, gen, sids, per):
    """``per`` items of every session in ``sids`` in a random order, from
    ``mixture``."""
    n = len(sids) * per
    perm = torch.randperm(n, generator=gen, device=DEV)
    return sids.repeat_interleave(per)[perm], mixture(torch, gen, n)


def _first_difference(torch, a, b, skip=()):
    """The first leaf key where two trees differ bit for bit, or None."""
    from repro_torch.tree import leaves_with_keys

    la, lb = leaves_with_keys(a), leaves_with_keys(b)
    for k in la:
        if k not in skip and not torch.equal(la[k], lb[k]):
            return k
    return None


def _session_rows(pod, state):
    """{sid: that session's row of every leaf} of a pod state."""
    from repro_torch.tree import tree_map

    return {sid: tree_map(lambda l: l[slot], state)
            for sid, slot in pod.routing_table(state).items()}


def _tree_bytes(tree):
    from repro_torch.tree import leaves_with_keys

    return sum(t.numel() * t.element_size()
               for t in leaves_with_keys(tree).values())


def phase_ckpt(torch, gen):
    """checkpoint -> restore -> continue on the pod of phase ``pod``: two
    ingests, a save to the disk store (sync, then async while the third
    ingest runs) and to the memory store, the third ingest; each store
    restored and the third ingest run again, bit-equal to the pod that
    never stopped; 8 rows restored into a second pod with free slots,
    their next ingest bit-equal to the source's; the bf16 pod of
    ``pod_bf16`` round-tripped bit for bit."""
    import tempfile

    from repro_torch import obs
    from repro_torch.ckpt import CheckpointStore, MemoryStore
    from repro_torch.core.functions import (KernelConfig, LogDet,
                                            rbf_lengthscale_stream)
    from repro_torch.core.threesieves import ThreeSieves
    from repro_torch.kernels.pod_step import KERNEL as POD
    from repro_torch.serve.summarize import SummarizerPod

    algo, _ = _pod_algos(torch)
    pod = SummarizerPod(algo=algo, sessions=SESSIONS, chunk=CHUNK, device=DEV)
    sids = torch.arange(1000, 1000 + SESSIONS, dtype=torch.int32, device=DEV)
    state = _admitted(pod, 1000, SESSIONS)
    batches = [_tagged_batch(torch, gen, sids, CHUNK) for _ in range(3)]
    torch.cuda.synchronize()
    rec = obs.get_recorder()
    POD.launches = 0  # the main path starts here
    for tags, X in batches[:2]:
        state, _ = pod.ingest(state, tags, X)
    nbytes = _tree_bytes(state)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        disk, mem = CheckpointStore(tmp, keep=2), MemoryStore()
        ms = {}
        ms["save_sync"], _ = host_ms(torch, lambda: pod.save(disk, 1, state))
        ms["save_memory"], _ = host_ms(torch, lambda: pod.save(mem, 1,
                                                               state))
        ms["save_async_call"], _ = host_ms(
            torch, lambda: disk.save_async(2, state))
        # the third ingest steps the state in place while the write runs
        cont, _ = pod.ingest(state, *batches[2])
        ms["wait"], _ = host_ms(torch, disk.wait)
        ms["async_write"] = rec.find("ckpt_write")[-1]["dur_s"] * 1e3
        files = sum(p.stat().st_size
                    for p in (Path(tmp) / "step_000000001").glob("*.npy"))
        restored = {}
        for name, store, step in (("disk_sync", disk, 1),
                                  ("disk_async", disk, 2),
                                  ("memory", mem, 1)):
            ms[f"restore_{name}"], (st, _) = host_ms(
                torch, lambda: pod.restore(store, step))
            restored[name] = st
        for name, st in restored.items():
            st, _ = pod.ingest(st, *batches[2])
            torch.cuda.synchronize()
            k = _first_difference(torch, st, cont)
            if k is not None:
                fail(f"ckpt: the pod restored from {name} differs from the "
                     f"uninterrupted pod after the next ingest in {k}")
        # 8 rows into a second pod of 128 tenants and 128 free slots
        pod2 = SummarizerPod(algo=algo, sessions=SESSIONS, chunk=CHUNK,
                             device=DEV)
        st2 = _admitted(pod2, 3000, SESSIONS // 2)
        slots = torch.randperm(SESSIONS, generator=gen,
                               device=DEV)[:8].sort().values.cpu().numpy()
        torch.cuda.synchronize()
        ms["restore_8_rows"], (st2, _) = host_ms(
            torch, lambda: pod2.restore(mem, 1, slots=slots, into=st2))
        moved = torch.as_tensor(1000 + slots, dtype=torch.int32, device=DEV)
        tags, X = batches[2]
        keep = torch.isin(tags, moved)
        st2, _ = pod2.ingest(st2, tags[keep], X[keep])
        got, want = _session_rows(pod2, st2), _session_rows(pod, cont)
        for sid in moved.tolist():
            k = _first_difference(torch, got[sid], want[sid],
                                  skip=("drops_unknown",))
            if k is not None:
                fail(f"ckpt: restored session {sid} differs from the "
                     f"source pod after the next ingest in {k}")

        # the bf16 pod of pod_bf16: 32 tenants, two ingests, a round trip
        f16 = LogDet(K=K_MAX, d=D, kernel=KernelConfig(
            "rbf", rbf_lengthscale_stream(D)), dtype=torch.bfloat16,
            device=DEV)
        pod16 = SummarizerPod(algo=ThreeSieves(f=f16, T=1000, eps=0.01),
                              sessions=32, chunk=CHUNK, device=DEV)
        st16 = _admitted(pod16, 1000, 32)
        b16 = [_tagged_batch(torch, gen, sids[:32], CHUNK)
               for _ in range(3)]
        for tags, X in b16[:2]:
            st16, _ = pod16.ingest(st16, tags, X)
        pod16.save(disk, 3, st16)
        cont16, _ = pod16.ingest(st16, *b16[2])
        back16, _ = pod16.restore(disk, 3)
        if back16.algo.ld.feats.dtype != torch.bfloat16:
            fail("ckpt: the bf16 pod came back as "
                 f"{back16.algo.ld.feats.dtype}")
        back16, _ = pod16.ingest(back16, *b16[2])
        torch.cuda.synchronize()
        k = _first_difference(torch, back16, cont16)
        if k is not None:
            fail(f"ckpt: the bf16 pod differs after its round trip in {k}")
    launches = POD.launches
    # two ingests, the third, its three replays, the 8 rows', bf16's four
    if launches != 2 + 1 + 3 + 1 + 4:
        fail(f"ckpt: pod_step launched {launches} times")
    mb = nbytes / 1e6
    emit("ckpt", sessions=SESSIONS, K=K_MAX, d=D, chunk=CHUNK,
         state_bytes=nbytes, file_bytes=files,
         bytes_per_session=nbytes / SESSIONS, ms=ms,
         mb_per_s={"save_sync": mb / (ms["save_sync"] / 1e3),
                   "save_memory": mb / (ms["save_memory"] / 1e3),
                   "save_async_call": mb / (ms["save_async_call"] / 1e3),
                   "restore_disk_sync": mb / (ms["restore_disk_sync"] / 1e3),
                   "restore_memory": mb / (ms["restore_memory"] / 1e3)},
         restored_rows=len(slots), bit_equal=True, bf16_bit_equal=True,
         launches=launches)
    return {"launches": launches}


def _drain_fleet(pipes, states):
    """Run every pipeline, one device batch at a time, until its buffer is
    empty -> (states, [the stats of every run])."""
    runs = []
    for pid, pipe in pipes.items():
        while pipe.buffer.size:
            states[pid], st = pipe.run(states[pid], max_batches=1)
            if not st["items"]:
                fail(f"handoff: pod {pid}'s buffer holds "
                     f"{pipe.buffer.size} items it does not drain")
            runs.append(st)
    return states, runs


def phase_handoff(torch, gen):
    """Two pods of the ``pod`` phase's shape in a ``PodRouter`` fleet, each
    fed by a buffer-mode ``IngestPipeline``: pod 0 with 256 tenants, pod 1
    with 128 and 128 free slots.  A batch, then ``maybe_rebalance`` (8
    victims, fewest insertions) while the next batch waits in the buffers,
    then two batches; a control fleet gets the same batches and no
    handoff.  Zero drops; every session bit for bit the control's; the
    moved sessions against ``pod_step_ref`` over their whole stream."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.ingest import IngestPipeline, PodRouter, TaggedBuffer
    from repro_torch.kernels.pod_step import KERNEL as POD
    from repro_torch.kernels.pod_step import pod_step_ref
    from repro_torch.serve import PodAutoscaler, ScalePolicy
    from repro_torch.serve.summarize import SummarizerPod
    from repro_torch.tree import tree_map

    algo, algo_ref = _pod_algos(torch)
    live = {0: SESSIONS, 1: SESSIONS // 2}
    every = torch.cat([torch.arange(1000, 1000 + live[0]),
                       torch.arange(5000, 5000 + live[1])]).to(
        torch.int32).to(DEV)
    feed = []
    for _ in range(HANDOFF_BATCHES):
        tags, X = _tagged_batch(torch, gen, every, HANDOFF_SHARE)
        feed.append((tags.cpu().numpy(), X.cpu().numpy()))
    B = live[0] * HANDOFF_SHARE  # one device batch holds a round of pod 0

    def fleet():
        pods = {pid: SummarizerPod(algo=algo, sessions=SESSIONS, chunk=CHUNK,
                                   device=DEV) for pid in live}
        pipes = {pid: IngestPipeline(pod, buffer=TaggedBuffer(4 * B),
                                     batch=B, get_timeout=60.0)
                 for pid, pod in pods.items()}
        router = PodRouter(pipelines=pipes)
        states = {0: _admitted(pods[0], 1000, live[0]),
                  1: _admitted(pods[1], 5000, live[1])}
        router.assign(np.arange(1000, 1000 + live[0]), 0)
        router.assign(np.arange(5000, 5000 + live[1]), 1)
        for pipe in pipes.values():
            pipe._stage_slots()  # the pinned staging, out of the timings
        return pods, pipes, router, states

    def run(move):
        pods, pipes, router, states = fleet()
        asc = PodAutoscaler(router=router, pods=pods, policy=ScalePolicy(
            max_occupancy=0.9, victims=HANDOFF_VICTIMS,
            victim_policy="fewest-insertions"))
        torch.cuda.synchronize()
        windows, rep, spans = [], None, {}
        rec = obs.get_recorder()
        # before: batch 0; during: batch 1 waits in the buffers while
        # the handoff parks and forwards the victims' share, batch 2 lands
        # behind it, both drained (a victim's backlog and its next share
        # in one chunk, where the control splits them); after: batch 3
        for window in ([0], [1, 2], list(range(3, HANDOFF_BATCHES))):
            t0 = time.perf_counter()
            for b in window:
                router.put(*feed[b])
                if move and b == 1:
                    rec.clear()
                    states, rep = asc.maybe_rebalance(states)
                    if rep is None or not rep.ok:
                        fail(f"handoff: maybe_rebalance moved nothing "
                             f"({rep})")
                    spans = {e["name"]: e["dur_s"] * 1e3
                             for e in rec.events if e["name"] in (
                                 "handoff", "quiesce", "snapshot",
                                 "restore", "evict", "flip")}
            states, runs = _drain_fleet(pipes, states)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            windows.append({"items": sum(s["items"] for s in runs),
                            "s": wall, "runs": len(runs),
                            "drops": sum(s["dropped_unknown"]
                                         + s["dropped_overflow"]
                                         for s in runs)})
        drops = (sum(w["drops"] for w in windows)
                 + sum(router.drops_unrouted.values())
                 + sum(sum(p.buffer.drop_counts().values())
                       for p in pipes.values())
                 + sum(int(s.drops_overflow.sum()) + int(s.drops_unknown.sum())
                       for s in states.values()))
        rows = {}
        for pid, pod in pods.items():
            rows.update(_session_rows(pod, states[pid]))
        return rows, rep, windows, drops, spans

    POD.launches = 0  # the main path starts here
    rows, rep, windows, drops, spans = run(True)
    launches = POD.launches
    control, _, cwin, cdrops, _ = run(False)
    if drops or cdrops:
        fail(f"handoff: {drops} drops with the handoff, {cdrops} without")
    if len(rep.moved) != HANDOFF_VICTIMS or sorted(rows) != sorted(control):
        fail(f"handoff: moved {rep.moved}; sessions {len(rows)} against "
             f"{len(control)}")
    # every leaf but the pod-scoped ledger and n_fused, the count of gain
    # passes: one per chunk not ending on an accept, so it follows the
    # chunk split (measured below, not held)
    first_diff, passes = None, []
    for sid in sorted(rows):
        k = _first_difference(torch, rows[sid], control[sid],
                              skip=("drops_unknown", "algo/n_fused"))
        if k is not None and first_diff is None:
            first_diff = {"session": sid, "leaf": k,
                          "moved": sid in rep.moved}
        passes.append(int(rows[sid].algo.n_fused)
                      - int(control[sid].algo.n_fused))
    # the moved sessions against pod_step_ref over their whole stream
    idx = [int(s) - 1000 for s in rep.moved]
    per = [[X[tags == s] for tags, X in feed] for s in rep.moved]
    C = max(sum(len(p) for p in items) for items in per)
    chunks = torch.zeros((len(idx), C, D), device=DEV)
    counts = torch.zeros((len(idx),), dtype=torch.int32, device=DEV)
    for j, items in enumerate(per):
        allx = torch.from_numpy(np.concatenate(items)).to(DEV)
        chunks[j, :len(allx)] = allx
        counts[j] = len(allx)
    fresh = _stacked_tiers(torch, algo_ref, SESSIONS)
    fresh = tree_map(lambda l: l[torch.as_tensor(idx, device=DEV)], fresh)
    margins = [dict() for _ in idx]
    ref = pod_step_ref(algo_ref, fresh, chunks, counts, margins=margins)
    ker = tree_map(lambda *ls: torch.stack(ls),
                   *[rows[s].algo for s in rep.moved])
    err, ties = compare_sessions(
        torch, ker, ref, chunks, torch.zeros(len(idx), dtype=torch.int32),
        margins, "handoff: moved sessions against pod_step_ref",
        passes=False)
    if first_diff is not None:
        fail(f"handoff: not bit-equal to the control fleet: {first_diff}")

    def rate(w):
        return w["items"] / w["s"]

    emit("handoff", sessions=live, K=K_MAX, d=D, chunk=CHUNK,
         share_per_session=HANDOFF_SHARE, batches=HANDOFF_BATCHES,
         device_batch=B, moved=rep.moved, reason=rep.reason,
         backlog_items=rep.backlog_items,
         payload_bytes=HANDOFF_VICTIMS * _tree_bytes(
             next(iter(rows.values()))),
         handoff_latency_ms=rep.latency_s * 1e3, spans_ms=spans,
         before_items_per_sec=rate(windows[0]),
         during_items_per_sec=rate(windows[1]),
         after_items_per_sec=rate(windows[2]),
         device_batches=[w["runs"] for w in windows],
         control_items_per_sec=[rate(w) for w in cwin],
         control_device_batches=[w["runs"] for w in cwin], drops=0,
         bit_equal_to_control=True,
         n_fused_vs_control={"sessions_differing": sum(map(bool, passes)),
                             "min": min(passes), "max": max(passes)}, vs_pod_step_ref_max_abs_err=err,
         near_ties=ties, launches=launches)
    return {"launches": launches, "max_abs_err": err}


def phase_pubsub(torch, gen):
    """Producers over loopback TCP into a ``PubSubListener`` (8
    partitions); a ``PubSubFrontEnd`` pumps the broker into a router
    fleet of the ``ingest`` phase's pod, committing at its pipeline's
    sync.  One producer's wire dies mid-stream and it replays from its
    ACK; the front end is restarted from ``committed()`` between the
    batches.  Every frame lands once; no drop; the final state is
    bit-equal to the same per-session orders through ``pod.ingest``."""
    import threading

    import numpy as np

    from repro_torch.ingest import (IngestPipeline, PodRouter, Publisher,
                                    PubSubBroker, PubSubFrontEnd,
                                    PubSubListener, TaggedBuffer)
    from repro_torch.kernels.pod_step import KERNEL as POD
    from repro_torch.serve.summarize import SummarizerPod

    algo, _ = _pod_algos(torch)
    pod = SummarizerPod(algo=algo, sessions=SESSIONS, chunk=CHUNK, device=DEV)
    state0 = _admitted(pod, 1000, SESSIONS)
    sids = torch.arange(1000, 1000 + SESSIONS, dtype=torch.int32, device=DEV)
    N = SESSIONS * CHUNK
    dev = [_tagged_batch(torch, gen, sids, CHUNK)
           for _ in range(PUBSUB_BATCHES)]
    host = [(t.cpu().numpy(), x.cpu().numpy()) for t, x in dev]
    # the direct path: the same batches through pod.ingest
    direct = clone_state(state0)
    for tags, X in dev:
        direct, _ = pod.ingest(direct, tags, X)
    torch.cuda.synchronize()

    pipe = IngestPipeline(pod, buffer=TaggedBuffer(2 * N), batch=N,
                          get_timeout=60.0, timings=[])
    router = PodRouter({0: pipe})
    router.assign(np.arange(1000, 1000 + SESSIONS), 0)
    broker = PubSubBroker(n_partitions=PUBSUB_PARTITIONS)
    fe = PubSubFrontEnd(broker, router, read_batch=PUBSUB_READ)
    fe.attach(pipe)
    pipe._stage_slots()  # the pinned staging, out of the timings
    state = clone_state(state0)
    P, frames = PUBSUB_PRODUCERS, PUBSUB_FRAMES
    errors, lags, marks, steps = [], [], [], []
    torch.cuda.synchronize()
    POD.launches = 0  # the main path starts here
    t0 = time.perf_counter()
    with PubSubListener(broker, timeout=60.0) as lis:
        pubs = [Publisher("127.0.0.1", lis.port, producer_id=k,
                          timeout=60.0) for k in range(P)]

        def produce(k, tags, X, kill):
            # producer k owns the sessions sid % P == k, in stream order
            try:
                mine = (tags % P) == k
                for j, (s, x) in enumerate(zip(
                        np.array_split(tags[mine], frames),
                        np.array_split(X[mine], frames))):
                    if kill and j == frames // 2:
                        pubs[k]._sock.close()  # the wire dies mid-stream
                        try:
                            pubs[k].publish(s, x)
                            raise RuntimeError("publish on a dead wire")
                        except OSError:
                            pubs[k].connect()  # replays from its ACK
                    else:
                        pubs[k].publish(s, x)
            except Exception as e:  # raised by the main thread below
                errors.append(e)

        for b, (tags, X) in enumerate(host):
            threads = [threading.Thread(target=produce,
                                        args=(k, tags, X, b == 1 and k == 2))
                       for k in range(P)]
            t1 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                fail(f"pubsub: a producer failed: {errors[0]!r}")
            t2 = time.perf_counter()
            lags.append(fe.lag())
            fe.pump()
            lags.append(fe.lag())
            t3 = time.perf_counter()
            pipe.timings = []
            state, stats = pipe.run(state, max_batches=1)
            marks.append(stats)
            rows, idle = _pipeline_batches(pipe.timings, N)
            steps.append({"publish_s": t2 - t1, "pump_s": t3 - t2,
                          "run_s": stats["wall_s"], **rows[0],
                          "idle_share_run": idle})
            if b == 0:  # restart the front end from its commits
                fe = PubSubFrontEnd(broker, router, read_batch=PUBSUB_READ,
                                    start=fe.committed())
                fe.attach(pipe)
        for p in pubs:
            p.close()
        dups = lis.duplicates
        last_seq = dict(lis.last_seq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = POD.launches
    total = sum(broker.high_water(p) for p in range(PUBSUB_PARTITIONS))
    if total != PUBSUB_BATCHES * N or last_seq != {
            k: PUBSUB_BATCHES * frames for k in range(P)}:
        fail(f"pubsub: broker holds {total} items (want "
             f"{PUBSUB_BATCHES * N}); producers' seqs {last_seq}")
    drops = (sum(m["dropped_unknown"] + m["dropped_overflow"] for m in marks)
             + sum(router.drops_unrouted.values())
             + sum(pipe.buffer.drop_counts().values())
             + int(state.drops_overflow.sum()) + int(state.drops_unknown.sum()))
    items = sum(m["items"] for m in marks)
    if drops or items != PUBSUB_BATCHES * N or launches != PUBSUB_BATCHES:
        fail(f"pubsub: {drops} drops, {items} items, {launches} launches")
    k = _first_difference(torch, state, direct)
    if k is not None:
        fail(f"pubsub: the final state differs from direct ingest in {k}")
    busy = sum(r["h2d_ms"] + r["step_ms"] for r in steps)
    emit("pubsub", producers=P, partitions=PUBSUB_PARTITIONS,
         frames_per_producer=PUBSUB_BATCHES * frames, items=total,
         batch_mb=N * D * 4 / 1e6, duplicates=dups, reconnects=[
             p.reconnects for p in pubs],
         committed=sum(fe.committed().values()), lag=lags, s=wall,
         items_per_s=total / wall, batches=steps,
         idle_share=1 - busy / (wall * 1e3),
         drops=0, bit_equal_to_direct=True, launches=launches)
    return {"launches": launches}


def phase_distributed(torch, gen, paper):
    """ThreeSieves on P shards of the ``paper`` stream (K = 100, d = 256,
    T and eps as there), ``DistributedSummarizer`` update and merge under
    ``auto`` (the kernels) and ``torch``; then ``CoresetSelector`` over the
    same stream on both routes."""
    from repro_torch.core.api import make
    from repro_torch.core.functions import rbf_lengthscale_stream
    from repro_torch.core.spec import SessionSpec
    from repro_torch.data import CoresetSelector, DistributedSummarizer
    from repro_torch.kernels.rbf_gain import KERNEL as GAIN
    from repro_torch.kernels.rbf_gain import KERNEL_STATIC as STATIC
    from repro_torch.tree import tree_map

    X, f_greedy = paper["X"], paper["f_greedy"]
    ls = rbf_lengthscale_stream(D)
    base = SessionSpec(K=K_MAX, d=D, lengthscale=ls, eps=PAPER_EPS, T=1000)
    algo = make(base, device=DEV)
    plain = make(base.replace(backend="torch"), device=DEV)
    P, B = DIST_SHARDS, CHUNK
    dist, dref = DistributedSummarizer(algo, P), DistributedSummarizer(
        plain, P)
    batches = X.split(P * B)
    st, sr = dist.init(), dref.init()
    kernels = (GAIN, STATIC)
    secs = {"update": 0.0, "update_plain": 0.0}
    err, ties = 0.0, []
    launches = {k.name: 0 for k in kernels}
    for b, Xb in enumerate(batches):
        before = st
        st, dt, ln = _counted(torch, kernels, lambda: dist.update(st, Xb))
        secs["update"] += dt
        for k, v in ln.items():
            launches[k] += v
        t0 = time.perf_counter()
        sr = dref.update(sr, Xb)
        torch.cuda.synchronize()
        secs["update_plain"] += time.perf_counter() - t0
        for p in range(P):
            ker_p = tree_map(lambda l: l[p], st)
            ref_p = tree_map(lambda l: l[p], sr)
            if _first_difference(torch, ker_p, ref_p) is None:
                continue
            margins = {}
            Xp = Xb[p * B:(p + 1) * B]
            ref_p = plain.run_batched(tree_map(lambda l: l[p], before), Xp,
                                      margins=margins)
            e, tie = hold_states(torch, ker_p, ref_p,
                                 tree_map(lambda l: l[p], before), Xp,
                                 margins, f"distributed shard {p} batch {b}")
            err = max(err, e)
            if tie:
                ties.append({"shard": p, "batch": b, **tie})
                sr = tree_map(lambda a, k: a.index_copy(
                    0, torch.tensor([p], device=DEV), k[p:p + 1]), sr, st)
    # the merge on the kernels' shard states, both routes
    merged, dt, ln = _counted(torch, kernels, lambda: dist.merge(st))
    secs["merge"] = dt
    launches["gain_static_merge"] = ln["gain_static"]
    for k, v in ln.items():
        launches[k] += v
    gaps = []
    t0 = time.perf_counter()
    mref = dref.merge(st, gaps=gaps)
    torch.cuda.synchronize()
    secs["merge_plain"] = time.perf_counter() - t0
    mk, mr = merged.ld, mref.ld
    merge_tie = None
    if int(mk.n) != int(mr.n) or not torch.equal(mk.feats, mr.feats):
        rows = (mk.feats != mr.feats).any(-1)
        r = int(torch.nonzero(rows)[0, 0]) if rows.any() else min(
            int(mk.n), int(mr.n))
        if gaps[r] > TIE:
            fail(f"distributed merge: rounds differ first at {r} with the "
                 f"two largest reference gains {gaps[r]} apart (> {TIE})")
        merge_tie = {"round": r, "gap": gaps[r]}
    else:
        for name in ("fval", "L", "Linv"):
            a, c = getattr(mk, name), getattr(mr, name)
            if not torch.allclose(a, c, rtol=RTOL, atol=ATOL):
                fail(f"distributed merge: {name} off by "
                     f"{(a - c).abs().max().item()}")
            err = max(err, (a - c).abs().max().item())
    if launches["gain_static_merge"] != K_MAX:
        fail(f"distributed merge: {launches['gain_static_merge']} "
             f"gain_static launches, want {K_MAX}")
    local = [float(algo.summary(tree_map(lambda l: l[p], st))[2])
             for p in range(P)]
    f_merged = float(mk.fval)
    if f_merged < max(local) - 1e-4:
        fail(f"distributed merge: f {f_merged} below a shard's {max(local)}")

    # the coreset selector over the same stream, both routes
    sel = CoresetSelector(K_MAX, D, T=1000, eps=PAPER_EPS, lengthscale=ls,
                          device=DEV)
    sel_ref = CoresetSelector(K_MAX, D, T=1000, eps=PAPER_EPS,
                              lengthscale=ls, backend="torch", device=DEV)
    GAIN.launches = 0
    t0 = time.perf_counter()
    for Xc in X.split(CHUNK):
        sel.update(Xc)
    torch.cuda.synchronize()
    secs["coreset"] = time.perf_counter() - t0
    launches["gain_traced_coreset"] = GAIN.launches
    launches["gain_traced"] += GAIN.launches
    for Xc in X.split(CHUNK):
        sel_ref.update(Xc)
    fk, nk, vk = sel.summary()
    fr, nr, vr = sel_ref.summary()
    if int(nk) != int(nr) or not torch.equal(fk, fr) or not torch.allclose(
            vk, vr, rtol=RTOL, atol=ATOL):
        fail(f"distributed coreset: n {int(nk)} / {int(nr)}, fval "
             f"{float(vk)} / {float(vr)}")
    last = X[-CHUNK:]
    ak, ar = sel.assign(last), sel_ref.assign(last)
    if not torch.equal(ak, ar):
        fail(f"distributed coreset: assign differs in "
             f"{int((ak != ar).sum())} of {CHUNK} rows")
    emit("distributed", algo="threesieves", K=K_MAX, d=D, shards=P,
         items=X.shape[0], batch=P * B, pool=P * K_MAX,
         pool_mb=P * K_MAX * D * 4 / 1e6, n_merged=int(mk.n),
         f_merged=f_merged, f_merged_over_best_local=f_merged / max(local),
         f_merged_over_greedy=f_merged / f_greedy,
         local_n=[int(n) for n in st.ld.n.tolist()], seconds=secs,
         merge_ms=secs["merge"] * 1e3, launches=launches, max_abs_err=err,
         near_ties=ties, merge_near_tie=merge_tie,
         coreset={"n": int(nk), "fval": float(vk),
                  "f_over_greedy": float(vk) / f_greedy,
                  "assign_equal": True})
    return {"gain_traced": launches["gain_traced"],
            "gain_static": launches["gain_static"], "max_abs_err": err}


# ---------------------------- this slice: MoE, MLA and every architecture
def _all_kernels():
    from repro_torch.kernels.flash_attention import KERNEL as FLASH
    from repro_torch.kernels.pod_step import KERNEL as POD
    from repro_torch.kernels.rbf_gain import KERNEL as GAIN
    from repro_torch.kernels.rbf_gain import KERNEL_STATIC as STATIC
    from repro_torch.kernels.ssd_chunk import KERNEL as SSD

    return (GAIN, STATIC, POD, FLASH, SSD)


def _free(torch):
    """Release what the last model left on the card before the next one
    is built."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _gib(nbytes):
    return nbytes / 2 ** 30


def _with_dtype(model, params, dtype, **moe):
    """A model of ``model``'s config in ``dtype`` (and MoE fields
    ``moe``) on the same parameters (no copy)."""
    import dataclasses

    from repro_torch.models import Model

    cfg = dataclasses.replace(model.cfg, dtype=dtype)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    out = Model(cfg, device=DEV)
    out.load(params)
    return out


class _RouteLog:
    """Record the top-k experts of every MoE router call
    (``models.moe._route``) for a block, one (tokens, k) sorted tensor a
    layer call."""

    def __enter__(self):
        import torch

        from repro_torch.models import moe

        self.saved, self.idx = moe._route, []

        def recording(p, x, cfg):
            out = self.saved(p, x, cfg)
            k = out[1].shape[-1]
            self.idx.append(torch.sort(out[1].reshape(-1, k), -1).values)
            return out

        moe._route = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._route = self.saved


def _flips(a, b):
    """-> ((token, layer) router choices that differ between two logs of
    the same tokens, choices compared)."""
    return (sum(int((x != y).any(-1).sum()) for x, y in zip(a, b)),
            sum(x.shape[0] for x in a))


def _teacher_forcing(torch, model, params, B, S, pre, gen):
    """Teacher forcing, the reference's gate (tests/test_arch_smoke.py:
    69-92): prefill ``pre`` tokens, then decode positions pre..S-1 on the
    true tokens; the prefill's last logits and every decode step's within
    rtol = atol = TF_TOL of ``train_logits`` at the same position.  Holds
    the cache path (MLA: the absorbed decode) against the full forward
    (MLA: the decompressed path).  Gated in float32; in the config's
    bf16 printed beside it with the MoE router choices that differ
    between the two paths (bf16 rounding moves a top-k choice, a step in
    the function no fixed tolerance bounds) -> {dtype: readings}."""
    from repro_torch.models import init_cache

    cfg = model.cfg
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=DEV,
                           dtype=torch.int32)
    out = {}
    for dtype in ("float32", cfg.dtype):
        m = _with_dtype(model, params, dtype)
        with torch.inference_mode():
            with _RouteLog() as full_log:
                full, _ = m.train_logits(params, {"tokens": tokens})
            caches = init_cache(m.cfg, B, S, device=DEV)
            with _RouteLog() as path_log:
                last, caches, _ = m.prefill(
                    params, {"tokens": tokens[:, :pre]}, caches)
                steps = [(pre - 1, last)]
                for t in range(pre, S):
                    logits, caches = m.decode_step(
                        params, tokens[:, t:t + 1], caches, t)
                    steps.append((t, logits))
        err = share = 0.0
        for t, logits in steps:
            got, want = logits.float(), full[:, t].float()
            if not torch.isfinite(got).all():
                fail(f"{cfg.name} {dtype}: non-finite decode logits at "
                     f"position {t}")
            d = (got - want).abs()
            err = max(err, d.max().item())
            share = max(share, (d / (TF_TOL + TF_TOL * want.abs()))
                        .max().item())
        # the path's router calls: the prefill's, then one per step, each
        # against the full forward's choices at the same positions
        L = len(full_log.idx)
        k = full_log.idx[0].shape[-1] if L else 0
        ref = [f.reshape(B, S, k) for f in full_log.idx]
        want_idx = ([r[:, :pre].reshape(-1, k) for r in ref]
                    + [r[:, t] for t in range(pre, S) for r in ref])
        flips = _flips(path_log.idx, want_idx)
        gated = dtype == "float32"
        if gated and share > 1.0:
            fail(f"{cfg.name}: float32 teacher-forced decode off the train "
                 f"logits by {err} ({share} of the rtol = atol = {TF_TOL} "
                 "gate)")
        out[dtype] = {"max_abs_err": err, "gate_share": share,
                      "router_flips": flips, "gated": gated}
        del m, full, caches, steps
    return {"batch": B, "length": S, "prefilled": pre, "tol": TF_TOL, **out}


class _DropCount:
    """Wrap ``models.moe.dispatch_slots`` for a block: the (token, choice)
    pairs the dispatch drops and routes, summed on the card."""

    def __enter__(self):
        from repro_torch.models import moe

        self.saved, self.sums = moe.dispatch_slots, []

        def counting(idx, n_experts, cap):
            out = self.saved(idx, n_experts, cap)
            self.sums.append(((~out[2]).sum(), out[2].numel()))
            return out

        moe.dispatch_slots = counting
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.dispatch_slots = self.saved

    def counts(self):
        """-> (dropped pairs, routed pairs)."""
        return (sum(int(d) for d, _ in self.sums),
                sum(n for _, n in self.sums))


def _check_tokens(torch, out, prompts, vocab, what):
    B, P = prompts.shape
    if out.shape[0] != B or not torch.equal(out[:, :P], prompts):
        fail(f"{what}: output {tuple(out.shape)} does not extend the "
             "prompts")
    if int(out.min()) < 0 or int(out.max()) >= vocab:
        fail(f"{what}: a token outside the vocabulary")


def _prefill_logits(torch, model, params, batch, max_seq):
    from repro_torch.models import init_cache
    from repro_torch.serve import make_prefill_step

    B = batch["tokens"].shape[0]
    caches = init_cache(model.cfg, B, max_seq, device=DEV)
    with torch.inference_mode():
        logits = make_prefill_step(model)(params, batch, caches)[0]
    if not torch.isfinite(logits.float()).all():
        fail(f"{model.cfg.name}: non-finite prefill logits")
    return logits.float()


def _routes_vs(torch, model, ref_model, params, prompts, max_seq, what,
               ref_route=None):
    """Prefill logits of two routes of one model within ROUTE_TOL, in
    float32 and in the config's bf16, with the router choices that
    differ -> {dtype: readings}."""
    import contextlib

    out = {}
    for dtype in ("float32", model.cfg.dtype):
        m = _with_dtype(model, params, dtype)
        r = _with_dtype(ref_model, params, dtype)
        with _RouteLog() as log:
            got = _prefill_logits(torch, m, params, {"tokens": prompts},
                                  max_seq)
        with _RouteLog() as ref_log, ref_route or contextlib.nullcontext():
            want = _prefill_logits(torch, r, params, {"tokens": prompts},
                                   max_seq)
        err = (got - want).abs().max().item()
        if err > ROUTE_TOL[dtype]:
            fail(f"{what}: {dtype} prefill logits off by {err} (tol "
                 f"{ROUTE_TOL[dtype]})")
        out[dtype] = {"prefill_logits_max_abs_err": err,
                      "tol": ROUTE_TOL[dtype],
                      "router_flips": _flips(log.idx, ref_log.idx)}
    return out


def _tokens_vs(torch, model, ref_model, params, prompts, N, max_seq, what,
               ref_route=None):
    """Greedy tokens of ``model`` against ``ref_model``'s (generated inside
    ``ref_route``, a context) under the near-tie rule (TOKEN_TIE on the
    reference's top-2 gap) -> (rows equal, near ties, smallest reference
    gap)."""
    import contextlib

    from repro_torch.serve import ServeDriver

    B, P = prompts.shape
    out = ServeDriver(model=model, max_seq=max_seq, batch=B).generate(
        params, prompts, N)
    gaps = []
    ref = ServeDriver(model=ref_model, max_seq=max_seq, batch=B)
    ref._prefill = _gap_recorder(torch, ref._prefill, gaps, 0)
    ref._decode = _gap_recorder(torch, ref._decode, gaps, 1)
    with ref_route or contextlib.nullcontext():
        want = ref.generate(params, prompts, N)
    _check_tokens(torch, out, prompts, model.cfg.vocab, what)
    ties = _first_diff(out, want, P, gaps, what)
    return {"tokens_equal_rows": int((out == want).all(1).sum()),
            "near_ties": ties, "min_ref_gap": min(min(g) for g in gaps)}


def phase_deepseek(torch, gen, seed):
    """deepseek-v2-lite-16b at published widths, cut to DEEPSEEK_LAYERS of
    its 27 layers, serving 8
    requests of 512 prompt tokens through ``ServeDriver.generate`` (32
    new tokens), float32 master parameters and bf16 activations, MoE on
    the config's ``impl="dense"``; the teacher-forcing gate (the MLA
    absorbed decode against the decompressed path); dispatch at a
    capacity that cannot drop against dense; dispatch at the config's
    capacity factor, its drops and tokens/s.  The path meets no CUDA
    kernel of the port: MLA runs the plain chunked attention and the
    MoE plain matrix products, as in the reference."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve import ServeDriver
    from repro_torch.tree import leaves_with_keys

    kernels = _all_kernels()
    B, P, N = DEEPSEEK_B, DEEPSEEK_PROMPT, DEEPSEEK_NEW
    cfg = get_config("deepseek-v2-lite-16b", use_pallas_attention=True,
                     n_layers=DEEPSEEK_LAYERS)
    _free(torch)
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(seed))
    n_params = sum(t.numel() for t in leaves_with_keys(params).values())
    param_gib = _gib(torch.cuda.memory_allocated() - resident)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=DEV,
                            dtype=torch.int32)
    max_seq = P + N + 8
    driver = ServeDriver(model=model, max_seq=max_seq, batch=B)
    out = driver.generate(params, prompts, N)  # warms
    _check_tokens(torch, out, prompts, cfg.vocab, "deepseek")

    # the main path: timed generates, every count set to 0 before each
    timing, lns = _generates(torch, driver, kernels, lambda: (
        driver.generate(params, prompts, N)), N, DEEPSEEK_REPS)
    if any(v for ln in lns for v in ln.values()):
        fail(f"deepseek: a CUDA kernel launched on a path that has none: "
             f"{lns}")
    peak = torch.cuda.max_memory_allocated()
    wall, busy, by = _profile(torch, lambda: driver.generate(params, prompts,
                                                             N))
    tf = _teacher_forcing(torch, model, params, *DEEPSEEK_TF, gen)

    # dispatch at a capacity that cannot drop against dense: prefill
    # logits in float32 and bf16, float32 tokens under the near-tie rule
    # (bf16 holds logits only, as in whisper), no pair dropped
    no_drop = dict(impl="dispatch", capacity_factor=NO_DROP_CAPACITY)
    with _DropCount() as dc:
        routes = _routes_vs(torch, _with_dtype(model, params, cfg.dtype,
                                               **no_drop),
                            model, params, prompts, max_seq,
                            "deepseek dispatch against dense")
        tokens = _tokens_vs(torch, _with_dtype(model, params, "float32",
                                               **no_drop),
                            _with_dtype(model, params, "float32"), params,
                            prompts, N, max_seq, "deepseek dispatch float32")
    drops = dc.counts()
    if drops[0]:
        fail(f"deepseek: dispatch at capacity factor {NO_DROP_CAPACITY} "
             f"dropped {drops[0]} of {drops[1]} pairs")

    # the config's capacity factor: drops and tokens/s, not gated
    capped = _with_dtype(model, params, cfg.dtype, impl="dispatch")
    cdrv = ServeDriver(model=capped, max_seq=max_seq, batch=B)
    cdrv.generate(params, prompts, N)  # warms
    with _DropCount() as dcap:
        cap_timing, _ = _generates(torch, cdrv, kernels, lambda: (
            cdrv.generate(params, prompts, N)), N, 1)
    emit("deepseek", arch=cfg.name, layers=cfg.n_layers,
         layers_published=27, cut=None, params=n_params,
         params_analytic=cfg.param_count(),
         active_params=cfg.active_param_count(), param_gib=param_gib,
         dtype=cfg.dtype, param_dtype=cfg.param_dtype, impl=cfg.moe.impl,
         batch=B, prompt=P, new_tokens=N, generates=len(lns),
         launches=lns[0], **timing, peak_mem_gib=_gib(peak),
         profile={"wall_ms": wall, "device_busy_ms": busy,
                  "idle_share": 1 - busy / wall,
                  "top": [{"ms": t, "count": c, "kernel": k}
                          for t, c, k in by[:12]]},
         teacher_forcing=tf,
         dispatch_no_drop={"capacity_factor": NO_DROP_CAPACITY,
                           "dropped_routed_pairs": drops, **routes,
                           "float32_tokens": tokens},
         dispatch_capped={"capacity_factor": cfg.moe.capacity_factor,
                          "dropped_routed_pairs": dcap.counts(),
                          **cap_timing})
    del model, params, driver, capped, cdrv
    _free(torch)
    return {"tokens_per_s": timing["tokens_per_s"]["median"]}


def _serve_arch(torch, gen, seed, cfg, *, teacher, cut=None):
    """One generate of ARCHS_B x ARCHS_PROMPT tokens (ARCHS_NEW new) after
    a warm-up one, prefill and decode timed by CUDA events, the counts set
    to 0 before it; the teacher-forcing gate unless exempt; peak memory."""
    from repro_torch.models import Model
    from repro_torch.serve import ServeDriver
    from repro_torch.tree import leaves_with_keys

    B, P, N = ARCHS_B, ARCHS_PROMPT, ARCHS_NEW
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(seed))
    n_params = sum(t.numel() for t in leaves_with_keys(params).values())
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=DEV,
                            dtype=torch.int32)
    fe = ({"prefix": torch.randn(B, cfg.n_prefix, cfg.d_model, generator=gen,
                                 device=DEV).to(cfg.activation_dtype)}
          if cfg.n_prefix else None)
    driver = ServeDriver(model=model, max_seq=P + N + cfg.n_prefix + 8,
                         batch=B)
    out = driver.generate(params, prompts, N, frontend=fe)  # warms
    _check_tokens(torch, out, prompts, cfg.vocab, cfg.name)
    timing, lns = _generates(torch, driver, _all_kernels(), lambda: (
        driver.generate(params, prompts, N, frontend=fe)), N, 1)
    if any(v for v in lns[0].values()):
        fail(f"{cfg.name}: a CUDA kernel launched on a path that has none: "
             f"{lns[0]}")
    peak = torch.cuda.max_memory_allocated()
    tf = (_teacher_forcing(torch, model, params, *ARCHS_TF, gen)
          if teacher else "exempt: the stub prefix shifts the positions "
          "(tests/test_arch_smoke.py:73-74)")
    emit("archs", arch=cfg.name, layers=cfg.n_layers, cut=cut,
         params=n_params, params_analytic=cfg.param_count(), batch=B,
         prompt=P, prefix_rows=cfg.n_prefix, new_tokens=N,
         launches=lns[0], prefill_ms=timing["prefill_ms"]["median"],
         decode_ms_per_token=timing["decode_ms_per_token"]["median"],
         generate_ms=timing["generate_ms"]["median"],
         tokens_per_s=timing["tokens_per_s"]["median"],
         peak_mem_gib=_gib(peak), teacher_forcing=tf)
    del model, params, driver
    _free(torch)


def _serve_jamba(torch, gen, seed):
    """Reduced jamba-1.5-large-398b on the card: its Mamba layers on the
    SSD kernel (B / C in 2 groups), its MoE layers in the ``"DE"``
    pattern; in bf16 (the config's dtype) every SSD launch of a counted
    generate on the tensor-core kernel; the kernel route against the
    plain SSD route in prefill logits (float32 and bf16) and in float32
    tokens under the near-tie rule -> the launches of that generate."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_chunk import ROUTE_LAUNCHES
    from repro_torch.models import Model
    from repro_torch.serve import ServeDriver

    B, P, N = ARCHS_B, ARCHS_PROMPT, ARCHS_NEW
    cfg = get_config("jamba-1.5-large-398b", reduced=True,
                     use_pallas_attention=True)
    n_mamba = sum(cfg.layer_kind(i) == "M" for i in range(cfg.n_layers))
    model = Model(cfg, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(seed))
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=DEV,
                            dtype=torch.int32)
    max_seq = P + N + 8
    driver = ServeDriver(model=model, max_seq=max_seq, batch=B)
    calls = []
    with _SsdRoute(_recording_ssd(calls)):
        out = driver.generate(params, prompts, N)  # warms
    _check_tokens(torch, out, prompts, cfg.vocab, "jamba")
    if len(calls) != n_mamba or any(c["groups"] != cfg.ssm.n_groups
                                    for c in calls):
        fail(f"jamba: the SSD route was handed {calls}; expected "
             f"{n_mamba} calls with B / C in {cfg.ssm.n_groups} groups")
    routed = dict(ROUTE_LAUNCHES)
    timing, lns = _generates(torch, driver, _all_kernels(), lambda: (
        driver.generate(params, prompts, N)), N, 1)
    routes = {r: ROUTE_LAUNCHES[r] - routed[r] for r in ROUTE_LAUNCHES}
    if lns[0]["ssd_chunk"] != n_mamba or routes["tensor-core"] != n_mamba:
        fail(f"jamba: launches {lns[0]}, routes {routes}; expected "
             f"{n_mamba} ssd_chunk on the tensor-core kernel")
    logits = _routes_vs(torch, model, model, params, prompts, max_seq,
                        "jamba kernel route against the plain SSD route",
                        ref_route=_SsdRoute(_plain_ssd))
    f32 = _with_dtype(model, params, "float32")
    tokens = _tokens_vs(torch, f32, f32, params, prompts, N, max_seq,
                        "jamba float32", ref_route=_SsdRoute(_plain_ssd))
    emit("archs", arch=cfg.name, layers=cfg.n_layers, cut="reduced widths",
         batch=B, prompt=P, new_tokens=N, launches=lns[0],
         ssd_routes=routes, ssd_groups=cfg.ssm.n_groups, **logits,
         float32_tokens=tokens, prefill_ms=timing["prefill_ms"]["median"],
         decode_ms_per_token=timing["decode_ms_per_token"]["median"],
         tokens_per_s=timing["tokens_per_s"]["median"])
    del model, params, driver, f32
    _free(torch)
    return lns[0]["ssd_chunk"]


def phase_archs(torch, gen, seed):
    """The five dense architectures at published widths and full depth,
    grok-1-314b at published widths cut to GROK_LAYERS layers, reduced
    jamba-1.5-large-398b on the SSD kernel, then the SSD kernel at the
    layer shape of Jamba's published config against its plain version."""
    import dataclasses

    from repro_torch.configs import get_config

    for arch in ARCHS_DENSE:
        _serve_arch(torch, gen, seed, get_config(
            arch, use_pallas_attention=True),
            teacher=arch != "phi-3-vision-4.2b")
    grok = get_config("grok-1-314b", use_pallas_attention=True)
    cut = {"layers": GROK_LAYERS, "of": grok.n_layers,
           "why": f"{grok.param_count()} float32 parameters "
                  f"({_gib(4 * grok.param_count()):.0f} GiB) do not fit one "
                  "card; every width is the published one"}
    print(f"grok-1-314b: cut to {GROK_LAYERS} of {grok.n_layers} layers at "
          f"published widths ({cut['why']})", flush=True)
    _serve_arch(torch, gen, seed, dataclasses.replace(
        grok, n_layers=GROK_LAYERS), teacher=True, cut=cut)
    jamba_launches = _serve_jamba(torch, gen, seed)
    case = _ssd_case(torch, gen, JAMBA_SSD_CASE)
    emit("archs_ssd", **case)
    return {"jamba_launches": jamba_launches, **case,
            "max_abs_err": max(case["y_max_abs_err"],
                               case["state_max_abs_err"])}


# -------------------------------------- this slice: training, flash at dh 16
# phase flash_dh16: head width 16 (every reduced config's), both dtypes;
# the ragged cases (S = 300 padded to 384) carry the padded-keys control,
# the causal ones the non-causal control, the full one (no padding)
# none
FLASH_DH16_CASES = [
    ("dh16_causal_gqa_bf16", 4, 4, 2, 1024, 16, True, "bfloat16", 0.5),
    ("dh16_full_bf16", 4, 4, 4, 1024, 16, False, "bfloat16", 0.5),
    ("dh16_ragged_bf16", 2, 4, 2, 300, 16, False, "bfloat16", 0.5),
    ("dh16_causal_gqa_f32", 2, 4, 2, 512, 16, True, "float32", 0.5),
    ("dh16_ragged_f32", 2, 4, 2, 300, 16, False, "float32", 0.5),
    # the shapes train_grad hands the kernel: the reduced qwen2-1.5b's
    # causal GQA at GRAD_SHAPE, the reduced whisper-small's encoder frames
    ("dh16_reduced_qwen2_f32", 2, 4, 2, 64, 16, True, "float32", 0.5),
    ("dh16_reduced_qwen2_bf16", 2, 4, 2, 64, 16, True, "bfloat16", 0.5),
    ("dh16_reduced_enc_f32", 2, 4, 4, 16, 16, False, "float32", 0.5),
    ("dh16_reduced_enc_bf16", 2, 4, 4, 16, 16, False, "bfloat16", 0.5),
]
# phase train_grad: the reduced models on the kernel routes (SSD, flash at
# dh 16) against the plain routes, tokens (B, S); every leaf's gradient
# within GRAD_TOL of that leaf's largest plain gradient (float32; bf16
# printed), and the loss within GRAD_TOL of the plain loss (relative);
# then Mamba2-370m whole at GRAD_FULL (B, S), float32
GRAD_ARCHS = ("mamba2-370m", "jamba-1.5-large-398b", "qwen2-1.5b",
              "whisper-small")
GRAD_SHAPE = (2, 64)
GRAD_FULL = (2, 2048)
GRAD_TOL = 1e-4
# phase train_qwen2: qwen2-1.5b whole, batch x tokens, AdamW warmup, steps,
# checkpoint interval, steps timed with remat off
QWEN_B, QWEN_S, QWEN_WARMUP, QWEN_STEPS, QWEN_CKPT = 8, 512, 2, 6, 3
QWEN_NOREMAT_STEPS = 3
QWEN_LAYERS = 4  # of qwen2-1.5b's 28, at full width: the checkpoints' time
# phase train_mamba: mamba2-370m whole, batch x tokens, steps
MAMBA_TRAIN_B, MAMBA_TRAIN_S, MAMBA_TRAIN_STEPS = 8, 2048, 4


def phase_flash_dh16(torch, gen):
    """Head width 16 on both routes under the gates of ``flash``: causal
    GQA and full attention, ragged S; the kernel told to keep the padded
    keys (full cases the wrapper pads) or to see every key (causal cases)
    must fail; the
    bf16 cases on the tensor-core kernel (the route check of
    ``_flash_case``); timed beside SDPA, the plain version and the
    bound."""
    from repro_torch.kernels.flash_attention import KERNEL

    sass = sass_counts(KERNEL, ("HGMMA", "HGMMA.64x16x16"))
    cases = [_flash_case(torch, gen, case, "non_causal" if case[6]
                         else "padded_keys"
                         if (-case[4]) % min(128, max(case[4], 8)) else None)
             for case in FLASH_DH16_CASES]
    emit("flash_dh16", sass=sass, cases=cases,
         max_abs_err=max(c["max_abs_err"] for c in cases),
         library="torch.nn.functional.scaled_dot_product_attention")
    if not sass["HGMMA"]:
        fail(f"flash_dh16: no HGMMA in the SASS ({sass})")
    return {**cases[0], "max_abs_err": max(c["max_abs_err"] for c in cases)}


def _plain_routes():
    """Both kernel routes on their plain versions (backend ``torch``)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import attention, mamba

    def flash(q, k, v, *, causal=True):
        return flash_ops.flash_attention(q, k, v, causal=causal,
                                         backend="torch")

    return _Route((mamba, "ssd_chunks", _plain_ssd),
                  (attention, "flash_attention", flash))


def _detached_routes():
    """The planted fault: both kernels' outputs with no autograd Function
    (the parent's route), so no gradient flows through them."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops

    def bare(forward, plain, *inputs, **kw):
        return forward(*inputs, **kw)

    return _Route((flash_ops, "with_plain_grad", bare),
                  (ssd_ops, "with_plain_grad", bare))


def _grads(torch, model, params, batch):
    """(loss, {key: gradient}) of ``model.loss`` through
    ``train.step.make_grad_fn``."""
    from repro_torch.train.step import TrainStepConfig, make_grad_fn
    from repro_torch.tree import leaves_with_keys

    g, m = make_grad_fn(model, TrainStepConfig())(params, batch)
    out = leaves_with_keys(g)
    torch.cuda.synchronize()
    return float(m["loss"]), out


def _grad_errors(got, want):
    """Per leaf max |got - want| / max |want| -> (worst share, its key)."""
    worst, at = 0.0, None
    for k, w in want.items():
        size = w.float().abs().max().item()
        e = (got[k].float() - w.float()).abs().max().item()
        share = e / size if size > 0 else (0.0 if e == 0 else math.inf)
        if share >= worst:
            worst, at = share, k
    return worst, at


def _train_batch(torch, gen, cfg, B, S):
    b = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                 device=DEV, dtype=torch.int32)}
    if cfg.encoder is not None:
        b["frames"] = torch.randn(B, cfg.encoder.n_frames, cfg.d_model,
                                  generator=gen, device=DEV)
    return b


def _grad_case(torch, gen, seed, arch, *, reduced, shape, dtypes):
    """One model's gradients: kernel route, plain route and the planted
    detached route, per dtype -> (its JSON record (float32 gated), the
    kernel route's launches summed over the dtypes)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import KERNEL as FLASH
    from repro_torch.kernels.ssd_chunk import KERNEL as SSD
    from repro_torch.kernels.ssd_chunk import ROUTE_LAUNCHES
    from repro_torch.models import Model

    base = get_config(arch, reduced=reduced, use_pallas_attention=True)
    params = Model(base, device=DEV).init(
        torch.Generator(device=DEV).manual_seed(seed))
    batch = _train_batch(torch, gen, base, *shape)
    rec = {"arch": base.name, "batch": list(shape), "remat": base.remat,
           "n_layers": base.n_layers, "dtypes": {}}
    launches = {"ssd_chunk": 0, "flash_attention": 0}
    for dtype in dtypes:
        model = Model(dataclasses.replace(base, dtype=dtype), device=DEV)
        ssd0, flash0 = SSD.launches, FLASH.launches
        routes0 = dict(ROUTE_LAUNCHES)
        loss, got = _grads(torch, model, params, batch)
        n_ssd, n_flash = SSD.launches - ssd0, FLASH.launches - flash0
        routes = {r: ROUTE_LAUNCHES[r] - routes0[r] for r in ROUTE_LAUNCHES}
        launches["ssd_chunk"] += n_ssd
        launches["flash_attention"] += n_flash
        with _plain_routes():
            ssd0, flash0 = SSD.launches, FLASH.launches
            ref_loss, want = _grads(torch, model, params, batch)
            if SSD.launches != ssd0 or FLASH.launches != flash0:
                fail(f"train_grad {arch}: the plain route launched a kernel")
        with _detached_routes():
            _, bad = _grads(torch, model, params, batch)
        err, at = _grad_errors(got, want)
        fault, fault_at = _grad_errors(bad, want)
        loss_err = abs(loss - ref_loss) / max(1.0, abs(ref_loss))
        rec["dtypes"][dtype] = {
            "loss": loss, "plain_loss": ref_loss,
            "scaled_loss_err": loss_err, "leaves": len(want),
            "max_scaled_grad_err": err, "at": at,
            "control_detached_scaled_err": fault, "control_at": fault_at,
            "launches": {"ssd_chunk": n_ssd, "flash_attention": n_flash},
            "ssd_routes": routes}
        if not math.isfinite(loss) or not all(
                torch.isfinite(g).all() for g in got.values()):
            fail(f"train_grad {arch} {dtype}: non-finite loss or gradient")
        if dtype == "float32":
            if err > GRAD_TOL:
                fail(f"train_grad {arch}: gradient of {at} off by {err} of "
                     f"its largest plain value (tol {GRAD_TOL})")
            if loss_err > GRAD_TOL:
                fail(f"train_grad {arch}: loss {loss} against the plain "
                     f"route's {ref_loss} ({loss_err} relative, tol "
                     f"{GRAD_TOL})")
            if fault <= GRAD_TOL:
                fail(f"train_grad {arch}: the check passes the detached "
                     f"route ({fault} at {fault_at}, tol {GRAD_TOL})")
        if n_ssd + n_flash == 0:
            fail(f"train_grad {arch} {dtype}: no kernel launched")
    del params
    _free(torch)
    return rec, launches


def phase_train_grad(torch, gen, seed):
    """``Model.loss(...).backward()`` through the kernel routes (the SSD
    kernel, flash at head width 16) against the plain routes: reduced
    Mamba2, Jamba (g = 2), qwen2-1.5b and whisper-small with
    ``use_pallas_attention``, then Mamba2-370m whole at 2 x 2048 in
    float32 (remat ``full``: each layer's kernel launched twice)."""
    cases, launches = [], {"ssd_chunk": 0, "flash_attention": 0}
    for arch in GRAD_ARCHS:
        rec, ln = _grad_case(torch, gen, seed, arch, reduced=True,
                             shape=GRAD_SHAPE,
                             dtypes=("float32", "bfloat16"))
        cases.append(rec)
        for k in launches:
            launches[k] += ln[k]
    rec, ln = _grad_case(torch, gen, seed, "mamba2-370m", reduced=False,
                         shape=GRAD_FULL, dtypes=("float32",))
    cases.append(rec)
    for k in launches:
        launches[k] += ln[k]
    full = rec["dtypes"]["float32"]["launches"]["ssd_chunk"]
    want = rec["n_layers"] * (2 if rec["remat"] else 1)
    if full != want:
        fail(f"train_grad mamba2-370m: {full} ssd_chunk launches in a "
             f"step, expected {want} (a forward and, under remat, a "
             "recompute per layer)")
    worst = max(r["dtypes"]["float32"]["max_scaled_grad_err"] for r in cases)
    f32 = {k: sum(r["dtypes"]["float32"]["launches"][k] for r in cases)
           for k in launches}
    emit("train_grad", cases=cases, tol=GRAD_TOL, launches=launches,
         float32_launches=f32, max_scaled_grad_err=worst)
    return {"launches": launches, "float32_launches": f32,
            "max_scaled_grad_err": worst}


def _step_events(torch, step, events, metrics):
    """``step`` bracketed by CUDA events, its metrics kept (on the card:
    read after the run, no extra sync)."""
    def timed(*a):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(*a)
        end.record()
        events.append((start, end))
        metrics.append(out[-1])
        return out
    return timed


def _kind_of(name):
    """A device kernel's bucket in a training step's profile."""
    low = name.lower()
    if any(s in low for s in ("gemm", "xmma", "cutlass", "cublas", "sm90_",
                              "ampere_", "gemv", "splitk", "nvjet")):
        return "cublas"
    if "softmax" in low or "nll" in low or "gather" in low or \
            "scatter" in low:
        return "loss"
    if "ssd_chunk" in low:
        return "ssd_chunk_kernel"
    if "flash_attention" in low:
        return "flash_kernel"
    if "bfloat16_copy" in low:
        return "casts_to_bf16"
    if "copy" in low:
        return "other_copies"
    if "reduce" in low or "norm" in low:
        return "reductions"
    if "elementwise" in low or "functor" in low:
        return "elementwise"
    return "other"


def _by_kind(by):
    out = {}
    for t, c, k in by:
        kind = _kind_of(k)
        ms, n = out.get(kind, (0.0, 0))
        out[kind] = (ms + t, n + c)
    return {k: {"ms": ms, "kernels": n} for k, (ms, n) in out.items()}


def _ms_stats(xs):
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs),
            "all": xs}


def phase_train_qwen2(torch, gen, seed):
    """qwen2-1.5b at full width, cut to QWEN_LAYERS of its 28 layers,
    trained on one card: float32
    parameters, gradients and AdamW moments, bf16 activations, remat
    ``full``, 8 x 512 tokens a step, through ``run_training`` into a
    ``CheckpointStore`` in a temporary directory (6 steps, a checkpoint
    every 3); then a kill after step 3's checkpoint (step 6's removed) and
    a resume from it, compared with the uninterrupted steps 4-6; ms per
    step (CUDA events), tokens/s, peak memory, model FLOP utilisation,
    one profiled step; and the step with remat off."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.ckpt import CheckpointStore
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStreamSpec, deterministic_batch_fn
    from repro_torch.models import Model
    from repro_torch.train import (AdamWConfig, init_opt_state,
                                   make_train_step)
    from repro_torch.train.loop import LoopConfig, run_training
    from repro_torch.tree import leaves_with_keys, tree_map

    cfg = dataclasses.replace(get_config("qwen2-1.5b"),
                              n_layers=QWEN_LAYERS)
    model = Model(cfg, device=DEV)
    opt_cfg = AdamWConfig(warmup_steps=QWEN_WARMUP, total_steps=QWEN_STEPS)
    step = make_train_step(model, opt_cfg)
    batch_fn = deterministic_batch_fn(seed, TokenStreamSpec(
        vocab=cfg.vocab, seq=QWEN_S, batch=QWEN_B), device=DEV)
    tokens = QWEN_B * QWEN_S
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        torch.cuda.reset_peak_memory_stats()
        params = model.init(torch.Generator(device=DEV).manual_seed(seed))
        n_params = sum(t.numel() for t in leaves_with_keys(params).values())
        opt = init_opt_state(params, opt_cfg)
        events, metrics = [], []
        store = CheckpointStore(root / "run", keep=2)
        t0 = time.perf_counter()
        pA, oA, repA = run_training(
            _step_events(torch, step, events, metrics), params, opt,
            batch_fn, store, LoopConfig(total_steps=QWEN_STEPS,
                                        ckpt_every=QWEN_CKPT, log_every=100),
            log=lambda s: None)
        loop_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        ms = [s.elapsed_time(e) for s, e in events]
        lossA = [float(m["loss"]) for m in metrics]
        saved = store.committed_steps()
        del params, opt

        # the kill: step 6's checkpoint is gone, the newest is step 3
        shutil.rmtree(root / "run" / f"step_{QWEN_STEPS:09d}")
        like = tree_map(lambda t: torch.empty_like(t, device="meta"),
                        (pA, oA))
        ev_b, met_b = [], []
        pB, oB, repB = run_training(
            _step_events(torch, step, ev_b, met_b), like[0], like[1],
            batch_fn, store, LoopConfig(total_steps=QWEN_STEPS,
                                        ckpt_every=QWEN_CKPT, log_every=100),
            log=lambda s: None)
        lossB = [float(m["loss"]) for m in met_b]
        la, lb = leaves_with_keys((pA, oA)), leaves_with_keys((pB, oB))
        unequal = [k for k in la if not torch.equal(la[k], lb[k])]
        resumed = {
            "start_step": repB.start_step, "end_step": repB.end_step,
            "loss_uninterrupted_4_6": lossA[QWEN_CKPT:],
            "loss_resumed_4_6": lossB,
            "losses_bit_equal": lossA[QWEN_CKPT:] == lossB,
            "leaves_bit_equal": len(la) - len(unequal),
            "leaves": len(la), "unequal": unequal[:8],
            "max_abs_diff": max(((la[k].float() - lb[k].float()).abs()
                                 .max().item() for k in unequal),
                                default=0.0)}
        del pA, oA, la, like
        _free(torch)
        if repB.start_step != QWEN_CKPT or repB.end_step != QWEN_STEPS:
            fail(f"train_qwen2: resumed {repB.start_step}->{repB.end_step}")
        if not all(math.isfinite(x) for x in lossA + lossB):
            fail(f"train_qwen2: non-finite loss {lossA} {lossB}")

        # one profiled step, on the resumed state; the optimizer's window
        # (CUDA events around adamw_update)
        from repro_torch.train import step as step_mod

        batch = batch_fn(QWEN_STEPS)
        opt_ev = []
        real_update = step_mod.adamw_update

        def update(*a):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real_update(*a)
            end.record()
            opt_ev.append((start, end))
            return out

        step_mod.adamw_update = update
        try:
            wall, busy, by = _profile(torch, lambda: step(pB, oB, batch))
        finally:
            step_mod.adamw_update = real_update
        opt_ms = sum(s.elapsed_time(e) for s, e in opt_ev)
        steady = ms[1:]
        med = statistics.median(steady)
        flops = 6 * n_params * tokens
        # remat off: the same step, timed
        step_nr = make_train_step(
            Model(dataclasses.replace(cfg, remat=False), device=DEV),
            opt_cfg)
        step_nr(pB, oB, batch)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev_nr, met_nr = [], []
        timed_nr = _step_events(torch, step_nr, ev_nr, met_nr)
        for _ in range(QWEN_NOREMAT_STEPS):
            timed_nr(pB, oB, batch)
        torch.cuda.synchronize()
        peak_nr = torch.cuda.max_memory_allocated()
        ms_nr = [s.elapsed_time(e) for s, e in ev_nr]
        emit("train_qwen2", arch=cfg.name, params=n_params,
             batch=[QWEN_B, QWEN_S], remat=cfg.remat_policy,
             activations=cfg.dtype, param_dtype=cfg.param_dtype,
             cut={"layers": QWEN_LAYERS,
                  "of": get_config("qwen2-1.5b").n_layers},
             steps=QWEN_STEPS, ckpt_every=QWEN_CKPT, saved_steps=saved,
             loss=lossA, loop_s=loop_s, step_ms=ms,
             step_ms_2_6=_ms_stats(steady),
             tokens_per_s=tokens / med * 1e3, peak_mem_gib=peak / 2 ** 30,
             model_flops_per_step=flops,
             mfu_6n=flops / (med / 1e3) / PEAK_BF16,
             mfu_note="6 N tokens over the step and the dense bf16 peak; "
                      "remat's recompute is not counted as useful work",
             resumed=resumed,
             profile={"wall_ms": wall, "device_busy_ms": busy,
                      "idle_share": 1 - busy / wall, "by_kind": _by_kind(by),
                      "optimizer_window_ms": opt_ms,
                      "top": [{"ms": t, "count": c, "kernel": k}
                              for t, c, k in by[:15]]},
             remat_off={"step_ms": _ms_stats(ms_nr),
                        "tokens_per_s": tokens / statistics.median(ms_nr)
                        * 1e3, "peak_mem_gib": peak_nr / 2 ** 30})
        del pB, oB
    finally:
        shutil.rmtree(root, ignore_errors=True)
        _free(torch)
    return {"ms": med}


def phase_train_mamba(torch, gen, seed):
    """mamba2-370m at full width and depth trained on one card: bf16
    activations, 8 x 2048 tokens (the ``mamba`` cell's prompt shape),
    remat ``full``, AdamW, 4 steps; ``ssd_chunk`` launches a step (96:
    48 forward, 48 recompute, all on the tensor-core route); ms a step,
    tokens/s, peak memory; from one profiled step, the share of the step
    in the plain SSD backward (``PlainGrad.backward``, CUDA events)
    against the kernel's forward launches."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStreamSpec, deterministic_batch_fn
    from repro_torch.kernels import autograd
    from repro_torch.kernels.ssd_chunk import KERNEL as SSD
    from repro_torch.kernels.ssd_chunk import ROUTE_LAUNCHES
    from repro_torch.models import Model
    from repro_torch.train import (AdamWConfig, init_opt_state,
                                   make_train_step)
    from repro_torch.tree import leaves_with_keys

    cfg = get_config("mamba2-370m")
    model = Model(cfg, device=DEV)
    opt_cfg = AdamWConfig(warmup_steps=2, total_steps=MAMBA_TRAIN_STEPS)
    step = make_train_step(model, opt_cfg)
    batch_fn = deterministic_batch_fn(seed, TokenStreamSpec(
        vocab=cfg.vocab, seq=MAMBA_TRAIN_S, batch=MAMBA_TRAIN_B), device=DEV)
    tokens = MAMBA_TRAIN_B * MAMBA_TRAIN_S
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=DEV).manual_seed(seed))
    n_params = sum(t.numel() for t in leaves_with_keys(params).values())
    opt = init_opt_state(params, opt_cfg)
    events, metrics, per_step, routes = [], [], [], []
    timed = _step_events(torch, step, events, metrics)
    for i in range(MAMBA_TRAIN_STEPS):
        n0, r0 = SSD.launches, dict(ROUTE_LAUNCHES)
        params, opt, _ = timed(params, opt, batch_fn(i))
        per_step.append(SSD.launches - n0)
        routes.append({r: ROUTE_LAUNCHES[r] - r0[r] for r in r0})
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ms = [s.elapsed_time(e) for s, e in events]
    loss = [float(m["loss"]) for m in metrics]
    want = 2 * cfg.n_layers
    if any(n != want for n in per_step) or any(
            r["tensor-core"] != want for r in routes):
        fail(f"train_mamba: ssd_chunk launches a step {per_step}, routes "
             f"{routes}; expected {want} on the tensor-core route")
    if not all(math.isfinite(x) for x in loss):
        fail(f"train_mamba: non-finite loss {loss}")

    # one profiled step; the plain SSD backward timed by CUDA events
    plain = []
    real = autograd.PlainGrad.backward

    def backward(ctx, *grads):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(ctx, *grads)
        end.record()
        plain.append((start, end))
        return out

    batch = batch_fn(MAMBA_TRAIN_STEPS)
    autograd.PlainGrad.backward = staticmethod(backward)
    try:
        wall, busy, by = _profile(torch, lambda: step(params, opt, batch))
    finally:
        autograd.PlainGrad.backward = staticmethod(real)
    plain_ms = sum(s.elapsed_time(e) for s, e in plain)
    kernel_ms = sum(t for t, _, k in by if any(n in k for n in SSD_KERNELS))
    med = statistics.median(ms[1:])
    emit("train_mamba", arch=cfg.name, params=n_params,
         batch=[MAMBA_TRAIN_B, MAMBA_TRAIN_S], remat=cfg.remat_policy,
         activations=cfg.dtype, steps=MAMBA_TRAIN_STEPS, loss=loss,
         step_ms=ms, step_ms_2_4=_ms_stats(ms[1:]),
         tokens_per_s=tokens / med * 1e3, peak_mem_gib=peak / 2 ** 30,
         ssd_launches_per_step=per_step, ssd_routes_per_step=routes,
         profile={"wall_ms": wall, "device_busy_ms": busy,
                  "idle_share": 1 - busy / wall,
                  "plain_ssd_backward_ms": plain_ms,
                  "plain_ssd_backward_calls": len(plain),
                  "plain_ssd_backward_share": plain_ms / wall,
                  "ssd_kernel_forward_ms": kernel_ms,
                  "ssd_kernel_share": kernel_ms / wall,
                  "by_kind": _by_kind(by),
                  "top": [{"ms": t, "count": c, "kernel": k}
                          for t, c, k in by[:15]]})
    del params, opt
    _free(torch)
    return {"launches": sum(per_step), "ms": med}


# --------------------------- this slice: the scale-out path, run as ranks
# phase sharded_pod: the pod phase's 256 tenants as SHARD_RANKS ranks of
# SHARD_SESSIONS sessions sharing the card, one gloo group; per segment
# (name, mesh shape, mesh axis names, the sharded axis, pre-routed,
# ingests of SESSIONS x CHUNK tagged items)
SHARD_RANKS = 4
SHARD_SESSIONS = SESSIONS // SHARD_RANKS
SHARD_SEGMENTS = (
    ("data", (SHARD_RANKS, 1), ("data", "model"), "data", False, 2),
    ("data_routed", (SHARD_RANKS, 1), ("data", "model"), "data", True, 2),
    ("pod_data", (2, SHARD_RANKS // 2), ("pod", "data"), ("pod", "data"),
     False, 1),
    ("pod_data_routed", (2, SHARD_RANKS // 2), ("pod", "data"),
     ("pod", "data"), True, 1))
# phase sharded_merge: ranks of one shard each over the paper stream in
# batches of CHUNK items a shard (the distributed phase's)
MERGE_RANKS = 4
# phase pod_compress: two ranks as two pods, each training mamba2-370m
# whole at the train_mamba cell's shape on its own batches, AdamW steps
# through Compressor(mesh, "pod")
COMPRESS_PODS, COMPRESS_STEPS = 2, 2
COMPRESS_LAYERS = 4  # of mamba2-370m's 48, at full width
# the one-rank NCCL leg, at a reduced size: a pod of NCCL_SESSIONS, a
# merge over NCCL_MERGE_BATCHES batches of the paper stream, the reduced
# mamba2-370m config trained NCCL_STEPS steps at GRAD_SHAPE
NCCL_SESSIONS, NCCL_MERGE_BATCHES, NCCL_STEPS = 64, 8, 2
# seconds a rank group may run before it fails the run with every rank's
# traceback: about three times its spawn-to-exit seconds on the H100 (the
# dry-run beside it; PERF.md), 180 at most
RANK_TIMEOUT = {"sharded_pod": 75, "sharded_merge": 90,
                "pod_compress": 100, "nccl": 60}


def _rank_main(rank, world, work, backend, dev, fn, cfg):
    """One spawned rank: its process group (``backend``, a ``file://``
    store in ``work``), then ``fn(torch, rank, world, cfg)``; the result,
    or the rank's own traceback, written to ``work``."""
    global DEV
    import os
    import pickle
    import traceback

    DEV = dev
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    if dev == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        if backend == "hostgloo":
            from repro_torch.launch.mesh import register_host_backend

            register_host_backend()
        dist.init_process_group(backend, init_method=f"file://{work}/store",
                                rank=rank, world_size=world)
        out = fn(torch, rank, world, cfg)
        with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(work, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(torch, name, fn, world, cfg, *, backend="gloo"):
    """``fn`` on ``world`` ranks spawned from this process (``spawn``: the
    parent holds a CUDA context), all on the one card -> (the ranks'
    results in rank order, seconds from spawn to the last exit).  A rank
    that raises, or a group still running after ``RANK_TIMEOUT[name]``
    seconds, fails the run with every rank's traceback; every process
    started here has ended when this returns."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        ctx = mp.start_processes(_rank_main, args=(
            world, work, backend, DEV, fn, cfg), nprocs=world, join=False,
            start_method="spawn")
        deadline = time.monotonic() + RANK_TIMEOUT[name]
        try:
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks still running after "
                                       f"{RANK_TIMEOUT[name]} s")
        except Exception as e:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(30)
            told = ""
            for r in range(world):
                err = Path(work) / f"rank{r}.err"
                if err.exists():
                    told += f"\n--- rank {r}:\n{err.read_text()}"
            fail(f"{name}: rank group failed: {e}{told}")
        seconds = time.perf_counter() - t0
        out = []
        for r in range(world):
            with open(Path(work) / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))  # written by the rank above
    return out, seconds


def _launches():
    return {k.name: k.launches for k in _all_kernels()}


def _zero_launches():
    for k in _all_kernels():
        k.launches = 0


def _shard_batch(torch, seed, b, sessions):
    """Ingest ``b`` of the sharded phases: CHUNK items of every one of
    ``sessions`` tenants (ids 1000 + i) in a random order, from
    ``mixture``; the same on every rank and in the parent (a generator
    seeded from ``seed`` and ``b`` on the card)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(1_000_003 * seed + 7919 * b + 1)
    sids = torch.arange(1000, 1000 + sessions, dtype=torch.int32,
                        device=DEV)
    return _tagged_batch(torch, gen, sids, CHUNK)


def _rank_items(tags, X, rank, S):
    """The items of one rank's sessions (1000 + rank S .. + S), in the
    batch's order: what the front end routes to that rank."""
    mine = (tags - 1000) // S == rank
    return tags[mine], X[mine]


def _ingest_segments(torch, pod, state, rank, world, seed, segments):
    """A rank's pod through ``make_sharded_update`` over ``segments`` ->
    per segment {the state's leaves, per ingest the start and end on the
    host's monotonic clock, the host-route ms of a pre-routed ingest}.  A barrier starts every ingest on all ranks
    together; each ends at the card's synchronize."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.convert import state_to_numpy
    from repro_torch.ingest import host_route
    from repro_torch.tree import local_tree, shard_tree

    S = pod.sessions
    out, b = {}, 0
    for name, shape, names, axis, routed, n in segments:
        mesh = init_device_mesh(DEV, shape, mesh_dim_names=names)
        update = pod.make_sharded_update(mesh, axis, pre_routed=routed)
        glob = shard_tree(state, mesh, axis)
        spans, host = [], []
        for _ in range(n):
            tags, X = _rank_items(*_shard_batch(torch, seed, b, world * S),
                                  rank, S)
            b += 1
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.monotonic()
            if routed:
                local = local_tree(glob, mesh, axis)
                h0 = time.perf_counter()
                chunks, counts, unknown, overflow = host_route(
                    local.sid.cpu().numpy(), local.active.cpu().numpy(),
                    tags.cpu().numpy(), X.cpu().numpy(), pod.chunk)
                args = tuple(torch.from_numpy(a).to(DEV) for a in (
                    chunks, counts, unknown.reshape(1), overflow))
                host.append((time.perf_counter() - h0) * 1e3)
            else:
                args = (tags, X)
            glob, _ = update(glob, *(shard_tree(a, mesh, axis)
                                     for a in args))
            torch.cuda.synchronize()
            spans.append((t0, time.monotonic()))
        state = local_tree(glob, mesh, axis)
        out[name] = {"state": state_to_numpy(state), "spans": spans,
                     "host_route_ms": host}
    return out


def _rank_sharded_pod(torch, rank, world, cfg):
    from repro_torch.serve.summarize import SummarizerPod

    algo, _ = _pod_algos(torch)
    S = cfg["sessions"]
    pod = SummarizerPod(algo=algo, sessions=S, chunk=CHUNK, device=DEV)
    state = _admitted(pod, 1000, S, first=rank * S)
    torch.cuda.synchronize()
    _zero_launches()  # the main path starts here
    out = _ingest_segments(torch, pod, state, rank, world, cfg["seed"],
                           cfg["segments"])
    return {"segments": out, "launches": _launches(),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def _control_pod(torch, seed, sessions, segments):
    """The one-process pod of ``sessions`` tenants fed every batch of the
    segments through ``pod.ingest`` -> the state's leaves after each
    segment."""
    from repro_torch.convert import state_to_numpy
    from repro_torch.serve.summarize import SummarizerPod

    algo, _ = _pod_algos(torch)
    pod = SummarizerPod(algo=algo, sessions=sessions, chunk=CHUNK,
                        device=DEV)
    state = _admitted(pod, 1000, sessions)
    out, b = {}, 0
    for name, *_, n in segments:
        for _ in range(n):
            state, _ = pod.ingest(state, *_shard_batch(torch, seed, b,
                                                        sessions))
            b += 1
        out[name] = state_to_numpy(state)
    return out


def _hold_rows(got, want, S, what):
    """Every rank's rows bit for bit the control's rows of its sessions;
    the unknown-id ledger (one a pod, on its slot 0) in sum."""
    for name, ctrl in want.items():
        for r, g in enumerate(got):
            mine = g["segments"][name]["state"]
            for k, a in ctrl.items():
                if k == "drops_unknown":
                    continue
                rows = a[r * S:(r + 1) * S]
                if rows.shape != mine[k].shape or not (rows == mine[k]).all():
                    fail(f"{what} {name}: rank {r} leaf {k} differs from "
                         "the one-process pod's rows")
        total = sum(int(g["segments"][name]["state"]["drops_unknown"].sum())
                    for g in got)
        if total != int(ctrl["drops_unknown"].sum()):
            fail(f"{what} {name}: unknown-id drops {total} vs "
                 f"{int(ctrl['drops_unknown'].sum())}")


def _segment_times(got, segments, items):
    """Per segment: each ingest's wall (first start to last end over the
    ranks), items/s over all ranks, ms a rank, host-route ms."""
    out = {}
    for name, *_ in segments:
        per = [g["segments"][name] for g in got]
        walls = [max(p["spans"][i][1] for p in per)
                 - min(p["spans"][i][0] for p in per)
                 for i in range(len(per[0]["spans"]))]
        out[name] = {
            "wall_ms": [w * 1e3 for w in walls],
            "items_per_s": [items / w for w in walls],
            "ms_per_ingest_rank": [[(e - s) * 1e3 for s, e in p["spans"]]
                                   for p in per],
            "host_route_ms_rank": [p["host_route_ms"] for p in per]}
    return out


def phase_sharded_pod(torch, seed):
    """The pod of ``pod`` as 4 ranks x 64 sessions: ``make_sharded_update``
    on a (4, 1) ("data", "model") mesh, plain and pre-routed (host-routed
    chunks), then on a (2, 2) ("pod", "data") mesh with the tuple axis;
    every rank's rows against the one-process 256-session pod."""
    segs = SHARD_SEGMENTS
    got, secs = run_ranks(torch, "sharded_pod", _rank_sharded_pod,
                          SHARD_RANKS, {"seed": seed,
                                        "sessions": SHARD_SESSIONS,
                                        "segments": segs})
    want = _control_pod(torch, seed, SESSIONS, segs)
    _hold_rows(got, want, SHARD_SESSIONS, "sharded_pod")
    ingests = sum(s[-1] for s in segs)
    pod_steps = [g["launches"]["pod_step"] for g in got]
    if pod_steps != [ingests] * SHARD_RANKS:
        fail(f"sharded_pod: pod_step launches a rank {pod_steps}, want "
             f"{ingests}")
    emit("sharded_pod", ranks=SHARD_RANKS, sessions_a_rank=SHARD_SESSIONS,
         K=K_MAX, d=D, chunk=CHUNK, items_per_ingest=SESSIONS * CHUNK,
         items_per_rank=SHARD_SESSIONS * CHUNK, backend="gloo",
         segments={name: {"mesh": list(shape), "axis": axis,
                          "pre_routed": routed, "ingests": n}
                   for name, shape, _, axis, routed, n in segs},
         times=_segment_times(got, segs, SESSIONS * CHUNK),
         launches_a_rank=[g["launches"] for g in got],
         bit_equal_to_one_pod=True,
         peak_mem_gib_rank=[g["peak_mem_gib"] for g in got],
         spawn_to_exit_s=secs)
    return {"launches": sum(pod_steps)}


def _rank_sharded_merge(torch, rank, world, cfg):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.convert import state_to_numpy
    from repro_torch.data import DistributedSummarizer
    from repro_torch.launch.mesh import all_gather
    from repro_torch.tree import local_tree, shard_tree, vmap

    X = torch.load(cfg["stream"]).to(DEV)[:cfg["items"]]
    mesh = init_device_mesh(DEV, (world,), mesh_dim_names=("data",))
    algo = _dist_algo(torch)
    ds = DistributedSummarizer(algo, mesh)
    B = CHUNK
    torch.cuda.synchronize()
    _zero_launches()  # the main path starts here
    st = ds.init()
    for Xb in X.split(world * B):
        st = ds.update(st, shard_tree(Xb[rank * B:(rank + 1) * B], mesh,
                                      "data"))
    torch.cuda.synchronize()
    update = _launches()
    _zero_launches()
    dist.barrier()
    t0 = time.perf_counter()
    merged = ds.merge(st)
    torch.cuda.synchronize()
    merge_ms = (time.perf_counter() - t0) * 1e3
    merge = _launches()
    # the all-gather alone: the two collectives of the merge, timed
    feats, n, _ = vmap(algo.summary)(local_tree(st, mesh, "data"))
    feats, n = feats.contiguous(), n.contiguous()
    gather_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        pool = all_gather(feats, mesh, "data")
        ns = all_gather(n, mesh, "data")
        torch.cuda.synchronize()
        gather_ms.append((time.perf_counter() - t0) * 1e3)
    return {"merged": state_to_numpy(merged.ld),
            "state": state_to_numpy(local_tree(st, mesh, "data")),
            "launches_update": update, "launches_merge": merge,
            "merge_ms": merge_ms, "gather_ms": gather_ms,
            "gather_bytes_rank": (feats.numel() * feats.element_size()
                                  + n.numel() * n.element_size()),
            "gathered_bytes": (pool.numel() * pool.element_size()
                               + ns.numel() * ns.element_size()),
            "n_shards": ds.n_shards}


def _dist_algo(torch):
    """ThreeSieves at K = 100, d = 256 with the ``paper`` phase's eps and
    the ``distributed`` phase's T."""
    from repro_torch.core.api import make
    from repro_torch.core.functions import rbf_lengthscale_stream
    from repro_torch.core.spec import SessionSpec

    return make(SessionSpec(K=K_MAX, d=D, lengthscale=rbf_lengthscale_stream(
        D), eps=PAPER_EPS, T=1000), device=DEV)


def _control_merge(torch, X, P):
    """The one-process loop at ``shards=P`` over X in batches of P x
    CHUNK -> (stacked states, merged ld, gaps of the merge's rounds)."""
    from repro_torch.data import DistributedSummarizer

    loop = DistributedSummarizer(_dist_algo(torch), shards=P)
    st = loop.init()
    for Xb in X.split(P * CHUNK):
        st = loop.update(st, Xb)
    gaps = []
    return st, loop.merge(st, gaps=gaps).ld, gaps


def _hold_merge(torch, got, X, P, what):
    """Each rank's shard state bit for bit the loop's shard; every rank's
    merged summary bit for bit rank 0's, and rank 0's the loop's (a first
    differing round a near-tie of the loop's two largest gains) -> the
    near tie or None."""
    from repro_torch.convert import state_to_numpy
    from repro_torch.tree import tree_map

    st, ref, gaps = _control_merge(torch, X, P)
    for r, g in enumerate(got):
        mine = state_to_numpy(tree_map(lambda l: l[r:r + 1], st))
        for k, a in mine.items():
            if not (a == g["state"][k]).all():
                fail(f"{what}: rank {r} shard state {k} differs from the "
                     "loop's shard")
        for k, a in got[0]["merged"].items():
            if not (a == g["merged"][k]).all():
                fail(f"{what}: rank {r} merged {k} differs from rank 0's")
    mine, want = got[0]["merged"], state_to_numpy(ref)
    if all((want[k] == mine[k]).all() for k in want):
        return None
    rows = (want["feats"] != mine["feats"]).any(-1)
    r = int(rows.argmax()) if rows.any() else min(int(want["n"]),
                                                  int(mine["n"]))
    if gaps[r] > TIE:
        fail(f"{what}: merges differ first at round {r}, the loop's two "
             f"largest gains {gaps[r]} apart (> {TIE})")
    return {"round": r, "gap": gaps[r]}


def phase_sharded_merge(torch, paper):
    """``DistributedSummarizer`` of ThreeSieves on a (4,) ("data",) mesh
    of 4 ranks, one shard each, over the ``paper`` stream in batches of
    4 x 1,024; the merge's all-gather (features and n of every rank) and
    its K rounds on every rank; against the one-process loop at
    ``shards=4``."""
    import tempfile

    X = paper["X"]
    P = MERGE_RANKS
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "stream.pt")
        torch.save(X.cpu(), path)
        got, secs = run_ranks(torch, "sharded_merge", _rank_sharded_merge,
                              P, {"stream": path, "items": X.shape[0]})
    tie = _hold_merge(torch, got, X, P, "sharded_merge")
    static = [g["launches_merge"]["gain_static"] for g in got]
    traced = [g["launches_update"]["gain_traced"] for g in got]
    if static != [K_MAX] * P or min(traced) == 0:
        fail(f"sharded_merge: gain_static launches in the merge {static} "
             f"(want {K_MAX} a rank), gain_traced in the updates {traced}")
    if [g["n_shards"] for g in got] != [P] * P:
        fail("sharded_merge: n_shards is not the mesh axis's size")
    emit("sharded_merge", algo="threesieves", ranks=P, K=K_MAX, d=D,
         items=X.shape[0], batch=P * CHUNK, backend="gloo",
         n_merged=int(got[0]["merged"]["n"]),
         f_merged=float(got[0]["merged"]["fval"]), merge_near_tie=tie,
         gather_bytes_rank=got[0]["gather_bytes_rank"],
         gathered_bytes=got[0]["gathered_bytes"],
         gather_ms_rank=[g["gather_ms"] for g in got],
         merge_ms_rank=[g["merge_ms"] for g in got],
         launches_update_rank=[g["launches_update"] for g in got],
         launches_merge_rank=[g["launches_merge"] for g in got],
         bit_equal_across_ranks=True, spawn_to_exit_s=secs)
    return {"gain_traced": sum(traced), "gain_static": sum(static)}


class _RecordedCompressor:
    """A ``Compressor``'s ``compress_reduce`` bracketed by the host clock
    (synchronized), its inputs and output kept for the check after the
    step."""

    def __init__(self, torch, comp):
        self.torch = torch
        self.comp = comp
        self.ms = None
        self.record = None

    def init_ef(self, grads_like):
        return self.comp.init_ef(grads_like)

    def compress_reduce(self, grads, ef):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.comp.compress_reduce(grads, ef)
        self.torch.cuda.synchronize()
        self.ms = (time.perf_counter() - t0) * 1e3
        self.record = (grads, ef, out[0])
        return out


def _gather_all(torch, t, group):
    """Every rank's ``t`` as float32, stacked: (P, ...) (a list
    ``all_gather``: the check's own collective, not the code under
    test's)."""
    import torch.distributed as dist

    t = t.detach().float().contiguous()
    parts = [torch.empty_like(t) for _ in range(group.size())]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts)


def _check_reduced(torch, mesh, record, chunk=1 << 24):
    """Each leaf's reduced gradient against ``reference_reduce`` of the
    pods' gradients.  With v_p = g_p + e_p, q_p, s_p = Q(v_p) and m the
    mean scale, reduced = sum q_p m / P = mean v_p - mean r_p + D, where
    r_p = v_p - q_p s_p (|r_p| <= s_p / 2) and D = sum q_p (m - s_p) / P,
    the mean-scale decode; so |reduced - mean g_p - D| <= |mean e_p| +
    max s_p / 2 (at most one quantization step when the residuals are
    at most half a step), plus float32 rounding: 4 ulps of the decode
    and of the mean, and 2^-16 of a step for v / s rounded before the
    round to an integer (half an ulp at 127 is 2^-17).  Each rank's s_p
    from its own v_p; the leaves compared ``chunk`` elements at a time ->
    (worst share of that bound, worst |reduced - mean g| in steps, max
    |D| in steps)."""
    from repro_torch.train.compress import reference_reduce
    from repro_torch.tree import leaves_with_keys

    grads, ef, reduced = (leaves_with_keys(t) for t in record)
    group = mesh.get_group("pod")
    P = group.size()
    worst = steps = dmax = 0.0
    for k, red in reduced.items():
        g = grads[k].detach().float().reshape(-1)
        e = ef[k].reshape(-1)
        s_own = torch.clamp((g + e).abs().max(), min=1e-12) / 127.0
        scale = _gather_all(torch, s_own.reshape(1), group).reshape(P, 1)
        m = (scale.sum() / P).double()
        step = float(scale.max())
        red = red.detach().reshape(-1)
        for a in range(0, g.numel(), chunk):
            G = _gather_all(torch, g[a:a + chunk], group)
            E = _gather_all(torch, e[a:a + chunk], group)
            Q = torch.clamp(torch.round((G + E) / scale), -127, 127)
            Dd = (Q.double() * (m - scale.double())).sum(0) / P
            ref = reference_reduce(list(G.unbind(0))).double()
            r = red[a:a + chunk].double()
            slack = 4 * 2 ** -23 * (r.abs() + ref.abs()) + 2 ** -16 * step
            bnd = E.double().mean(0).abs() + step / 2 + slack
            worst = max(worst, float(((r - ref - Dd).abs() / bnd).max()))
            steps = max(steps, float((r - ref).abs().max()) / step)
            dmax = max(dmax, float(Dd.abs().max()) / step)
    return worst, steps, dmax


def _params_equal(torch, mesh, params):
    """Whether every rank holds the same bits in every parameter leaf:
    the elementwise max and min over the ranks of each leaf's int32 view
    equal its own."""
    import torch.distributed as dist

    from repro_torch.tree import leaves_with_keys

    group = mesh.get_group("pod")
    same = True
    for t in leaves_with_keys(params).values():
        bits = t.detach().contiguous().view(torch.int32)
        hi, lo = bits.clone(), bits.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
        same = same and torch.equal(hi, bits) and torch.equal(lo, bits)
        del hi, lo
    flag = torch.tensor([int(same)], dtype=torch.int32, device=DEV)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
    return bool(flag.item())


def _rank_pod_compress(torch, rank, world, cfg):
    """One pod of ``world``: the model trained ``cfg["steps"]`` AdamW
    steps on its own batches through ``Compressor(mesh, "pod")``; after
    each step the reduced gradient checked against the pods' mean and
    the parameters against the other pods'."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.data import TokenStreamSpec, deterministic_batch_fn
    from repro_torch.kernels.ssd_chunk import KERNEL as SSD
    from repro_torch.models import Model
    from repro_torch.train import (AdamWConfig, init_opt_state,
                                   make_train_step)
    from repro_torch.train.compress import Compressor
    from repro_torch.tree import leaves_with_keys

    mcfg = _cut_config(cfg, reduced=cfg["reduced"])
    model = Model(mcfg, device=DEV)
    mesh = init_device_mesh(DEV, (world,), mesh_dim_names=("pod",))
    comp = _RecordedCompressor(torch, Compressor(mesh, "pod"))
    opt_cfg = AdamWConfig(warmup_steps=2, total_steps=cfg["steps"])
    step = make_train_step(model, opt_cfg, compressor=comp)
    B, S = cfg["shape"]
    batch_fn = deterministic_batch_fn(cfg["seed"] + 1 + rank, TokenStreamSpec(
        vocab=mcfg.vocab, seq=S, batch=B), device=DEV)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=DEV).manual_seed(cfg["seed"]))
    leaves = leaves_with_keys(params)
    n_params = sum(t.numel() for t in leaves.values())
    opt = init_opt_state(params, opt_cfg)
    ef = comp.init_ef(params)
    start_equal = _params_equal(torch, mesh, params)
    out = {"step_ms": [], "compress_ms": [], "ssd_launches": [], "loss": [],
           "bound_share": [], "err_steps": [], "decode_steps": [],
           "params_equal": [], "params": n_params,
           "wire_bytes_a_step": 4 * n_params + 4 * len(leaves),
           "start_equal": start_equal}
    torch.cuda.synchronize()
    _zero_launches()  # the main path starts here
    for i in range(cfg["steps"]):
        n0 = SSD.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, ef, metrics = step(params, opt, batch_fn(i), ef)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["ssd_launches"].append(SSD.launches - n0)
        out["compress_ms"].append(comp.ms)
        out["loss"].append(float(metrics["loss"]))
        share, steps, dsteps = _check_reduced(torch, mesh, comp.record)
        comp.record = None
        out["bound_share"].append(share)
        out["err_steps"].append(steps)
        out["decode_steps"].append(dsteps)
        out["params_equal"].append(_params_equal(torch, mesh, params))
    out["launches"] = _launches()
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def _hold_compress(got, cfg, what):
    want_ssd = cfg["ssd_a_step"]
    for r, g in enumerate(got):
        if not g["start_equal"] or not all(g["params_equal"]):
            fail(f"{what}: rank {r} parameters differ from the other "
                 f"pods' (after each step: {g['params_equal']})")
        if max(g["bound_share"]) > 1:
            fail(f"{what}: rank {r} reduced gradient off the int8 bound "
                 f"(worst share {max(g['bound_share'])})")
        if g["ssd_launches"] != [want_ssd] * cfg["steps"]:
            fail(f"{what}: rank {r} ssd_chunk launches a step "
                 f"{g['ssd_launches']}, want {want_ssd}")
        if not all(math.isfinite(x) for x in g["loss"]):
            fail(f"{what}: rank {r} loss {g['loss']}")


def _ssd_a_step(cfg):
    """``ssd_chunk`` launches of one training step: one a Mamba layer's
    forward, and one more for its recompute under remat."""
    return cfg.n_layers * (2 if cfg.remat else 1)


def phase_pod_compress(torch, seed):
    """Two ranks as two pods, each training mamba2-370m at full width cut
    to 4 of its 48 layers (8 x 2048 tokens, bf16, remat ``full``) on its
    own batches, 2 AdamW steps through ``Compressor(mesh, "pod")``: the
    int8 payloads summed in int32 over the pod axis's gloo group (staged
    through host memory).  Gates: parameters bit-equal across the pods
    after every step, every reduced gradient within the int8 bound of
    the pods' mean, 8 ``ssd_chunk`` launches a step a rank (the
    forward's and the remat recompute's)."""
    cfg = {"arch": "mamba2-370m", "reduced": False, "seed": seed,
           "layers": COMPRESS_LAYERS, "steps": COMPRESS_STEPS,
           "shape": (MAMBA_TRAIN_B, MAMBA_TRAIN_S)}
    cfg["ssd_a_step"] = _ssd_a_step(_cut_config(cfg))
    _free(torch)
    got, secs = run_ranks(torch, "pod_compress", _rank_pod_compress,
                          COMPRESS_PODS, cfg)
    _hold_compress(got, cfg, "pod_compress")
    emit("pod_compress", arch=cfg["arch"], pods=COMPRESS_PODS,
         batch=list(cfg["shape"]), cut=_cut(cfg), steps=COMPRESS_STEPS,
         backend="gloo",
         params=got[0]["params"],
         wire_bytes_a_step_rank=got[0]["wire_bytes_a_step"],
         loss_rank=[g["loss"] for g in got],
         step_ms_rank=[g["step_ms"] for g in got],
         compress_ms_rank=[g["compress_ms"] for g in got],
         bound_share_rank=[g["bound_share"] for g in got],
         err_steps_rank=[g["err_steps"] for g in got],
         decode_steps_rank=[g["decode_steps"] for g in got],
         params_bit_equal=True,
         ssd_launches_rank=[g["ssd_launches"] for g in got],
         peak_mem_gib_rank=[g["peak_mem_gib"] for g in got],
         spawn_to_exit_s=secs)
    return {"launches": sum(sum(g["ssd_launches"]) for g in got)}


def _rank_nccl(torch, rank, world, cfg):
    """The three pieces at a reduced size on a one-rank NCCL group."""
    from repro_torch.convert import state_to_numpy
    from repro_torch.data import DistributedSummarizer
    from repro_torch.serve.summarize import SummarizerPod
    from repro_torch.tree import local_tree, shard_tree
    from torch.distributed.device_mesh import init_device_mesh

    out = {}
    algo, _ = _pod_algos(torch)
    S = cfg["sessions"]
    pod = SummarizerPod(algo=algo, sessions=S, chunk=CHUNK, device=DEV)
    state = _admitted(pod, 1000, S)
    torch.cuda.synchronize()
    _zero_launches()  # the main path starts here
    out["pod"] = _ingest_segments(torch, pod, state, rank, world,
                                  cfg["seed"], cfg["segments"])
    X = torch.load(cfg["stream"]).to(DEV)[:cfg["items"]]
    mesh = init_device_mesh(DEV, (world,), mesh_dim_names=("data",))
    ds = DistributedSummarizer(_dist_algo(torch), mesh)
    st = ds.init()
    for Xb in X.split(world * CHUNK):
        st = ds.update(st, shard_tree(Xb, mesh, "data"))
    out["merge"] = {"merged": state_to_numpy(ds.merge(st).ld),
                    "state": state_to_numpy(local_tree(st, mesh, "data"))}
    pod_launches = _launches()
    out["compress"] = _rank_pod_compress(torch, rank, world, cfg["compress"])
    for k, v in pod_launches.items():
        out["compress"]["launches"][k] += v
    out["launches"] = out["compress"]["launches"]
    return out


def phase_nccl(torch, seed, paper):
    """The one-rank NCCL leg: the pod (64 sessions; both variants on a
    (1, 1) mesh and the tuple axis on a (1, 1) ("pod", "data") mesh), the
    merge (8 batches of the paper stream) and the compressor (the reduced
    mamba2-370m config, 2 steps), on CUDA tensors through NCCL (no host
    staging), under the gates of the gloo phases."""
    import tempfile

    from repro_torch.configs import get_config

    segs = (("data", (1, 1), ("data", "model"), "data", False, 1),
            ("data_routed", (1, 1), ("data", "model"), "data", True, 1),
            ("pod_data", (1, 1), ("pod", "data"), ("pod", "data"), False,
             1))
    items = NCCL_MERGE_BATCHES * CHUNK
    comp = {"arch": "mamba2-370m", "reduced": True, "seed": seed,
            "steps": NCCL_STEPS, "shape": GRAD_SHAPE,
            "ssd_a_step": _ssd_a_step(get_config("mamba2-370m",
                                                 reduced=True))}
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "stream.pt")
        torch.save(paper["X"][:items].cpu(), path)
        got, secs = run_ranks(torch, "nccl", _rank_nccl, 1, {
            "seed": seed, "sessions": NCCL_SESSIONS, "segments": segs,
            "stream": path, "items": items, "compress": comp},
            backend="nccl")
    g = got[0]
    _hold_rows([{"segments": g["pod"]}],
               _control_pod(torch, seed, NCCL_SESSIONS, segs),
               NCCL_SESSIONS, "nccl pod")
    tie = _hold_merge(torch, [g["merge"]], paper["X"][:items], 1,
                      "nccl merge")
    _hold_compress([g["compress"]], comp, "nccl compress")
    missing = [k for k, v in g["launches"].items()
               if k != "flash_attention" and v == 0]
    if missing:
        fail(f"nccl: no launch of {missing}")
    emit("nccl", backend="nccl", sessions=NCCL_SESSIONS,
         items_per_ingest=NCCL_SESSIONS * CHUNK, merge_items=items,
         compress_arch="mamba2-370m reduced", compress_batch=list(GRAD_SHAPE),
         launches=g["launches"], merge_near_tie=tie,
         times=_segment_times([{"segments": g["pod"]}], segs,
                              NCCL_SESSIONS * CHUNK),
         compress={k: g["compress"][k] for k in (
             "step_ms", "compress_ms", "loss", "bound_share", "err_steps",
             "wire_bytes_a_step")},
         bit_equal=True,
         spawn_to_exit_s=secs)
    return g["launches"]


# ------------------------------------------ the last slice: flash at any dh
# phase flash_dh_any: head widths that are no instance of the kernel
# (8 ... 112 run on the next instance up, their extra columns zeros) and
# those past 128 (the 64-key tiles); bf16 causal GQA and float32 ragged
FLASH_ANY_DH = (8, 24, 40, 48, 80, 112, 136, 160, 192, 256)
FLASH_ANY_CASES = (
    [(f"dh{dh}_causal_gqa_bf16", 2, 8, 2, 1024, dh, True, "bfloat16", 0.5)
     for dh in FLASH_ANY_DH]
    + [(f"dh{dh}_ragged_f32", 2, 4, 2, 300, dh, False, "float32", 0.5)
       for dh in FLASH_ANY_DH])


def phase_flash_dh_any(torch, gen):
    """Every head width up to 256 on both routes under the gates of
    ``flash``: the kernel fed one column short (q, k and v with their
    last column zeroed, a kernel that reads dh - 1 columns) must fail
    each case's gate; the widest (256) and every float32 case timed
    beside the plain version, SDPA and the bound, the others' route read
    from the wrapper's counters.  A head width of 0 raises, naming the range (widths past
    256 run: phase ``flash_wide``)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     launch_geometry)

    cases = [_flash_case(torch, gen, case, "short_column",
                         timed=case[5] == 256 or case[7] == "float32")
             for case in FLASH_ANY_CASES]
    empty = torch.zeros(1, 2, 64, 0, device=DEV, dtype=torch.bfloat16)
    try:
        flash_attention(empty, empty, empty, backend="cuda")
        fail("flash_dh_any: head width 0 did not raise")
    except ValueError as e:
        if "1 and up" not in str(e):
            fail(f"flash_dh_any: the refusal does not name the range: {e}")
        refusal = str(e)
    geometry = {dh: launch_geometry(torch.bfloat16, 2, 8, 1024, dh)[3]
                for dh in FLASH_ANY_DH}
    emit("flash_dh_any", cases=cases, refusal=refusal,
         smem_bytes_bf16=geometry,
         max_abs_err=max(c["max_abs_err"] for c in cases),
         library="torch.nn.functional.scaled_dot_product_attention")
    top = next(c for c in cases if c["case"] == "dh256_causal_gqa_bf16")
    return {**top, "max_abs_err": max(c["max_abs_err"] for c in cases)}


# --------------------------------------------- the last slice: the mesh
# the model on a ("data", "model") mesh of ranks sharing the card, on the
# host-copy gloo backend (launch.mesh.register_host_backend: gloo's own
# CUDA path crashed in the functional all-gather DTensor uses)
MESH_BACKEND = "hostgloo"
MESH_TOL = 1e-4  # of the largest |logit|: float32, sums split over ranks
# Each mesh phase runs its model at full width cut in depth ("layers" of
# the published n_layers): the collectives' bytes and seconds grow with
# the layers, the kernels see each layer's width; every gate holds at the
# cut depth (the launch counts follow it).
TP_QWEN = {"arch": "qwen2-1.5b", "shape": (2, 2), "batch": (8, 512),
           "layers": 2, "runs": [("plain_f32", {"dtype": "float32"}),
                    ("kernel_f32", {"dtype": "float32",
                                    "use_pallas_attention": True}),
                    ("kernel_bf16", {"use_pallas_attention": True})]}
TP_MAMBA = {"arch": "mamba2-370m", "shape": (1, 2), "batch": (8, 2048),
            "layers": 4, "runs": [("kernel_f32", {"dtype": "float32"}),
                     ("kernel_bf16", {})]}
SEQ_PHI3 = {"arch": "phi3-mini-3.8b", "shape": (1, 3), "batch": (4, 1536),
            "layers": 2, "runs": [("plain_f32", {"dtype": "float32",
                                    "attn_seq_shard": True})]}
# (1, 2), not (2, 2): on (2, 2) the FSDP gathers over 'data' and the
# checkpoints (18.6 GB gathered whole on every rank) run through host
# copies four ways; (1, 2) keeps the tensor-parallel path and halves it
TRAIN_MESH = {"arch": "qwen2-1.5b", "shape": (1, 2), "batch": (8, 512),
              "layers": 2, "steps": 2}
TRAIN_MESH_TOL = {"loss": 1e-2, "grad_norm": 5e-2}  # bf16 activations
RANK_TIMEOUT.update({"tp_qwen2": 125, "tp_mamba": 95, "seq_shard": 70,
                     "train_mesh": 125})


def _cut_config(cfg, **over):
    """The phase's model, cut to ``cfg["layers"]`` of its layers where
    the phase names a cut (the NCCL leg's reduced model names none)."""
    import dataclasses

    from repro_torch.configs import get_config

    mcfg = get_config(cfg["arch"], **over)
    if "layers" not in cfg:
        return mcfg
    return dataclasses.replace(mcfg, n_layers=cfg["layers"])


def _cut(cfg):
    """The depth cut an emit line names."""
    from repro_torch.configs import get_config

    return {"layers": cfg["layers"], "of": get_config(cfg["arch"]).n_layers}


def _mesh_of(torch, shape):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(DEV, tuple(shape),
                            mesh_dim_names=("data", "model"))


def _mesh_tokens(torch, cfg, vocab):
    g = torch.Generator(device=DEV).manual_seed(cfg["seed"] + 17)
    B, S = cfg["batch"]
    return torch.randint(0, vocab, (B, S), generator=g, device=DEV)


def _rank_mesh_forward(torch, rank, world, cfg):
    """Each run of ``cfg["runs"]``: the whole model, seeded alike on every
    rank, laid out by ``build_rules`` on the mesh; ``train_logits`` on the
    mesh under ``use_mesh`` with the launch counters zeroed just before
    and read just after; rank 0 first runs the one-process forward of
    the same tree and holds the gathered logits against it."""
    from repro_torch.kernels.flash_attention import KERNEL as FLASH
    from repro_torch.kernels.ssd_chunk import KERNEL as SSD
    from repro_torch.launch.hlo_stats import CollectiveCounter
    from repro_torch.launch.mesh import (distribute, distribute_tree,
                                         full_tensor, placements, use_mesh)
    from repro_torch.launch.sharding import (batch_pspec, build_rules,
                                             shardings)
    from repro_torch.models import Model

    mesh = _mesh_of(torch, cfg["shape"])
    out = {}
    for name, over in cfg["runs"]:
        mcfg = _cut_config(cfg, **over)
        model = Model(mcfg, device=DEV)
        params = model.init(torch.Generator(device=DEV).manual_seed(
            cfg["seed"]))
        tokens = _mesh_tokens(torch, cfg, mcfg.vocab)
        want = None
        with torch.no_grad():
            if rank == 0:
                want = model.train_logits(params, {"tokens": tokens})[0]
            # the model holds the tree it was given: the shards replace it
            params = model.load(distribute_tree(params, shardings(
                model.spec(), build_rules(mcfg, mesh), mesh), mesh))
            _free(torch)
            tok = distribute(tokens, mesh, placements(
                batch_pspec(tokens.shape, mesh), mesh))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_launches()  # the mesh path starts here
            t0 = time.perf_counter()
            with use_mesh(mesh), CollectiveCounter() as coll:
                logits, _ = model.train_logits(params, {"tokens": tok})
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = {"flash_attention": FLASH.launches,
                        "ssd_chunk": SSD.launches}
            got = full_tensor(logits)
        rec = {"ms": ms, "launches": launches,
               "placements": str(logits.placements),
               "local_shape": list(logits.to_local().shape),
               "collectives": coll.stats().as_dict(),
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        if rank == 0:
            err = (got.float() - want.float()).abs().max().item()
            rec.update(max_abs_err=err,
                       scale=want.float().abs().max().item(),
                       finite=bool(torch.isfinite(got).all()),
                       shape=list(got.shape), dtype=str(got.dtype))
        out[name] = rec
        del params, logits, got, want
        _free(torch)
    return out


def _hold_mesh(got, cfg, what, want_launch):
    """The f32 runs' gate (rank 0's gathered logits within MESH_TOL of
    the largest one-process logit), finite logits everywhere, and the
    kernel launches each run must make on every rank."""
    for name, _ in cfg["runs"]:
        r0 = got[0][name]
        if not r0["finite"]:
            fail(f"{what} {name}: non-finite logits")
        if "f32" in name and r0["max_abs_err"] > MESH_TOL * r0["scale"]:
            fail(f"{what} {name}: logits off the one-process forward by "
                 f"{r0['max_abs_err']} (bound {MESH_TOL} x {r0['scale']})")
        for r, g in enumerate(got):
            for kernel, n in want_launch(name).items():
                if g[name]["launches"][kernel] != n:
                    fail(f"{what} {name}: rank {r} launched {kernel} "
                         f"{g[name]['launches'][kernel]} times, want {n}")


def _mesh_record(got, cfg):
    return {name: {
        "max_abs_err": got[0][name]["max_abs_err"],
        "scale": got[0][name]["scale"],
        "scaled_err": got[0][name]["max_abs_err"] / got[0][name]["scale"],
        "ms_rank": [g[name]["ms"] for g in got],
        "launches_rank": [g[name]["launches"] for g in got],
        "collective_bytes_rank": [g[name]["collectives"]["total_bytes"]
                                  for g in got],
        "collectives_rank0": got[0][name]["collectives"],
        "placements": got[0][name]["placements"],
        "local_shape": got[0][name]["local_shape"],
        "peak_mem_gib_rank": [g[name]["peak_mem_gib"] for g in got]}
        for name, _ in cfg["runs"]}


def phase_tp_forward(torch, seed):
    """The model on a mesh of ranks sharing the card: qwen2-1.5b at full
    width cut to 2 of its 28 layers on (2, 2), 8 x 512 tokens, on the
    plain attention route and under ``use_pallas_attention`` (flash on
    each rank's 6 query and 1 kv heads: one launch a layer a rank);
    mamba2-370m cut to 4 of 48 layers on (1, 2), 8 x 2048 tokens,
    ``ssd_chunk`` on each rank's 16 heads (one launch a layer a rank).
    Gates: float32 logits within 1e-4 of the largest one-process logit,
    the launches on every rank; bf16 printed."""
    _free(torch)
    q = dict(TP_QWEN, seed=seed)
    got_q, secs_q = run_ranks(torch, "tp_qwen2", _rank_mesh_forward,
                              4, q, backend=MESH_BACKEND)
    _hold_mesh(got_q, q, "tp_forward qwen2", lambda name: {
        "flash_attention": q["layers"] if "kernel" in name else 0})
    m = dict(TP_MAMBA, seed=seed)
    got_m, secs_m = run_ranks(torch, "tp_mamba", _rank_mesh_forward, 2, m,
                              backend=MESH_BACKEND)
    _hold_mesh(got_m, m, "tp_forward mamba2", lambda name: {
        "ssd_chunk": m["layers"]})
    emit("tp_forward", backend=MESH_BACKEND,
         qwen2={"mesh": list(q["shape"]), "batch": list(q["batch"]),
                "cut": _cut(q), "runs": _mesh_record(got_q, q),
                "spawn_to_exit_s": secs_q},
         mamba2={"mesh": list(m["shape"]), "batch": list(m["batch"]),
                 "cut": _cut(m), "runs": _mesh_record(got_m, m),
                 "spawn_to_exit_s": secs_m},
         tol=MESH_TOL)
    return {"flash_attention": sum(g[name]["launches"]["flash_attention"]
                                   for g in got_q for name, _ in q["runs"]),
            "ssd_chunk": sum(g[name]["launches"]["ssd_chunk"]
                             for g in got_m for name, _ in m["runs"]),
            # the float32 runs' (the CUDA-core kernels)
            "float32": {"flash_attention": sum(
                g["kernel_f32"]["launches"]["flash_attention"]
                for g in got_q),
                "ssd_chunk": sum(g["kernel_f32"]["launches"]["ssd_chunk"]
                                 for g in got_m)}}


def phase_seq_shard(torch, seed):
    """Context parallelism: phi3-mini-3.8b at full width (32 query heads
    of width 96) cut to 2 of its 32 layers on (1, 3), where 32 does not
    divide 3, so attention splits the query sequence over 'model' (4 x
    1536 tokens, 1536 = 3 x 512): the float32 logits against the
    one-process forward.  (Under ``use_pallas_attention`` the query
    sequence is gathered for the kernel and split again:
    tests/test_torch_mesh_model.py.)"""
    _free(torch)
    c = dict(SEQ_PHI3, seed=seed)
    got, secs = run_ranks(torch, "seq_shard", _rank_mesh_forward, 3, c,
                          backend=MESH_BACKEND)
    _hold_mesh(got, c, "seq_shard", lambda name: {
        "flash_attention": c["layers"] if "kernel" in name else 0})
    emit("seq_shard", backend=MESH_BACKEND, mesh=list(c["shape"]),
         batch=list(c["batch"]), cut=_cut(c), runs=_mesh_record(got, c),
         spawn_to_exit_s=secs, tol=MESH_TOL)
    return {"flash_attention": sum(g[name]["launches"]["flash_attention"]
                                   for g in got for name, _ in c["runs"])}


def _rank_train_mesh(torch, rank, world, cfg):
    """``launch.train.main`` on the mesh: one step and a checkpoint, then
    a second run resuming from it for the second step; an uninterrupted
    run of the same two steps (the launcher's own pieces) beside it."""
    from repro_torch.data import TokenStreamSpec, deterministic_batch_fn
    from repro_torch.launch import train as launcher
    from repro_torch.launch.hlo_stats import CollectiveCounter
    from repro_torch.launch.mesh import (distribute, distribute_tree,
                                         placements, use_mesh)
    from repro_torch.launch.sharding import (batch_pspec, build_rules,
                                             shardings)
    from repro_torch.models import Model
    from repro_torch.train import (AdamWConfig, init_opt_state,
                                   make_train_step)
    from repro_torch.tree import leaves_with_keys

    mesh = _mesh_of(torch, cfg["shape"])
    B, S = cfg["batch"]
    argv = ["--arch", cfg["arch"], "--layers", str(cfg["layers"]),
            "--batch", str(B), "--seq", str(S), "--ckpt-dir", cfg["dir"],
            "--ckpt-every", "100", "--seed", str(cfg["seed"])]
    out = {}
    t0 = time.perf_counter()
    _, _, first, _ = launcher.main(argv + ["--steps", "1"], mesh=mesh)
    out["first_s"] = time.perf_counter() - t0
    out["first"] = first.last_metrics
    _free(torch)
    t0 = time.perf_counter()
    resumed, _, second, _ = launcher.main(
        argv + ["--steps", str(cfg["steps"])], mesh=mesh)
    out["resumed_s"] = time.perf_counter() - t0
    out["resumed_from"] = second.start_step
    mine = {k: v.to_local().clone()
            for k, v in leaves_with_keys(resumed).items()}
    del resumed
    _free(torch)
    # the uninterrupted run: the launcher's init, layout, batches and step
    mcfg = _cut_config(cfg)
    model = Model(mcfg, device=DEV)
    params = model.load(distribute_tree(
        model.init(torch.Generator(device=DEV).manual_seed(cfg["seed"])),
        shardings(model.spec(), build_rules(mcfg, mesh), mesh), mesh))
    opt_cfg = AdamWConfig(total_steps=cfg["steps"])
    opt = init_opt_state(params, opt_cfg)
    step = make_train_step(model, opt_cfg)
    batches = deterministic_batch_fn(0, TokenStreamSpec(
        vocab=mcfg.vocab, seq=S, batch=B), device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["step_ms"], out["collective_bytes"] = [], []
    with use_mesh(mesh):
        for i in range(cfg["steps"]):
            b = {k: distribute(v, mesh, placements(batch_pspec(v.shape, mesh),
                                                   mesh))
                 for k, v in batches(i).items()}
            t0 = time.perf_counter()
            with CollectiveCounter() as coll:
                params, opt, metrics = step(params, opt, b)
            torch.cuda.synchronize()
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            out["collective_bytes"].append(coll.stats().total_bytes)
            if i == 0:
                out["loss"] = float(metrics["loss"])
                out["grad_norm"] = float(metrics["grad_norm"])
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["equal"] = all(torch.equal(mine[k], v.to_local())
                       for k, v in leaves_with_keys(params).items())
    return out


def _one_process_step(torch, cfg):
    """The first step of ``TRAIN_MESH`` on one process: (loss, grad
    norm), the launcher's init and batch."""
    from repro_torch.data import TokenStreamSpec, deterministic_batch_fn
    from repro_torch.models import Model
    from repro_torch.train import (AdamWConfig, init_opt_state,
                                   make_train_step)

    mcfg = _cut_config(cfg)
    model = Model(mcfg, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(cfg["seed"]))
    opt_cfg = AdamWConfig(total_steps=cfg["steps"])
    B, S = cfg["batch"]
    b = deterministic_batch_fn(0, TokenStreamSpec(
        vocab=mcfg.vocab, seq=S, batch=B), device=DEV)(0)
    m = make_train_step(model, opt_cfg)(
        params, init_opt_state(params, opt_cfg), b)[2]
    return float(m["loss"]), float(m["grad_norm"])


def phase_train_mesh(torch, seed):
    """Training on the mesh: ``launch.train.main(argv, mesh=...)`` on a
    (1, 2) mesh of ranks sharing the card, qwen2-1.5b at full width cut
    to 2 of its 28 layers (``--layers``; 8 x 512 tokens, remat
    ``full``), the one-process step too: one step and a checkpoint (the gathered
    tree, written by rank 0), then a run that resumes from it for the
    second step.  Gates: the resumed parameters bit-equal on every rank
    to an uninterrupted two-step run; the first step's loss and global
    norm within TRAIN_MESH_TOL of the one-process step (bf16
    activations, sums split over the ranks)."""
    import shutil
    import tempfile

    cfg = dict(TRAIN_MESH, seed=seed)
    loss1, gnorm1 = _one_process_step(torch, cfg)
    _free(torch)  # the step's tensors died with its frame
    work = tempfile.mkdtemp(prefix="train_mesh_")
    try:
        got, secs = run_ranks(torch, "train_mesh", _rank_train_mesh,
                              math.prod(cfg["shape"]), dict(cfg, dir=work),
                              backend=MESH_BACKEND)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for r, g in enumerate(got):
        if not g["equal"] or g["resumed_from"] != 1:
            fail(f"train_mesh: rank {r} resumed from {g['resumed_from']}, "
                 f"parameters bit-equal: {g['equal']}")
    errs = {"loss": abs(got[0]["loss"] - loss1) / abs(loss1),
            "grad_norm": abs(got[0]["grad_norm"] - gnorm1) / abs(gnorm1)}
    for k, e in errs.items():
        if not e <= TRAIN_MESH_TOL[k]:
            fail(f"train_mesh: {k} off the one-process step by {e} "
                 f"(bound {TRAIN_MESH_TOL[k]})")
    emit("train_mesh", arch=cfg["arch"], mesh=list(cfg["shape"]),
         batch=list(cfg["batch"]), cut=_cut(cfg), steps=cfg["steps"],
         backend=MESH_BACKEND, resumed_bit_equal=True,
         loss=got[0]["loss"], one_process_loss=loss1,
         grad_norm=got[0]["grad_norm"], one_process_grad_norm=gnorm1,
         rel_err=errs, tol=TRAIN_MESH_TOL,
         step_ms_rank=[g["step_ms"] for g in got],
         gloo_bytes_a_step_rank=[g["collective_bytes"] for g in got],
         peak_mem_gib_rank=[g["peak_mem_gib"] for g in got],
         first_run_s=got[0]["first_s"], resumed_run_s=got[0]["resumed_s"],
         spawn_to_exit_s=secs)


DRYRUN_CELLS = (("qwen2-1.5b", "train_4k"), ("paper-summarizer", None))
# the dry-run's processes run on the CPU alone (placeholder ranks, the
# meta device, the pod cell's program on the host): they start before the
# scale-out phases and run beside them, DRYRUN_THREADS threads each
DRYRUN_THREADS = 2


def start_dryrun():
    """Start ``python -m repro_torch.launch.dryrun`` in a process of its
    own for each of DRYRUN_CELLS -> (the output directory, the runs) for
    ``phase_dryrun``."""
    import tempfile

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS=str(DRYRUN_THREADS),
               MKL_NUM_THREADS=str(DRYRUN_THREADS))
    out = tempfile.TemporaryDirectory()
    runs = []  # the cells' processes run side by side
    for arch, shape in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--mesh", "single", "--out", out.name]
        if shape:
            cmd += ["--shape", shape]
        runs.append((arch, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env)))
    return out, runs


def phase_dryrun(torch, started):
    """The processes of ``start_dryrun`` (PyTorch's fake process group of
    256 placeholder ranks, under the card's PyTorch) for qwen2-1.5b
    ``train_4k`` and the summarizer pod cell on the single-pod mesh,
    waited for and read; a cell that is not ok fails the run."""
    out, runs = started
    cells, secs = {}, {}
    with out:
        for arch, t0, proc in runs:
            try:
                stdout, stderr = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                fail(f"dryrun {arch}: still running after 600 s")
            secs[arch] = time.perf_counter() - t0
            if proc.returncode:
                fail(f"dryrun {arch}: exit {proc.returncode}\n"
                     f"{stdout[-3000:]}\n{stderr[-3000:]}")
        for p in sorted(Path(out.name).glob("*.json")):
            cell = json.loads(p.read_text())
            if not cell["ok"]:
                fail(f"dryrun {cell['cell']}: {cell.get('error')}")
            cell.pop("traceback", None)
            arch = cell.get("arch", "paper-summarizer")
            cells[cell["cell"]] = dict(cell, process_s=secs[arch])
    train = cells["qwen2-1.5b__train_4k__pod256"]
    pod = cells["paper-summarizer__pod256"]
    emit("dryrun", torch=torch.__version__, threads=DRYRUN_THREADS,
         beside=["sharded_pod", "sharded_merge", "pod_compress", "nccl",
                 "flash_dh_any", "tp_forward", "seq_shard", "train_mesh"],
         train_4k={k: train[k] for k in ("memory_analysis", "cost_analysis",
                                          "collectives", "roofline",
                                          "run_s", "process_s")},
         pod256={k: pod[k] for k in ("pod_ingest", "pod_ingest_prerouted",
                                      "merge", "process_s")})


# ------------------------- this slice: flash past head width 256, the SSD
# kernel at every head width, state width and chunk
FLASH_WIDE_DH = (264, 300, 320, 384, 512, 1024)
FLASH_WIDE_CASES = (
    [(f"dh{dh}_causal_gqa_bf16", 2, 8, 2, 1024, dh, True, "bfloat16", 0.5)
     for dh in FLASH_WIDE_DH]
    + [(f"dh{dh}_ragged_f32", 2, 4, 2, 300, dh, False, "float32", 0.5)
       for dh in FLASH_WIDE_DH])
# the main path past 256: reduced Whisper with encoder heads of this
# width (four heads, d_model 64), its frames and its requests
WIDE_HEAD, WIDE_FRAMES, WIDE_B, WIDE_PROMPT, WIDE_NEW = 320, 300, 4, 8, 8


def phase_flash_wide(torch, gen, seed):
    """Head widths past 256 on both routes under the gates of ``flash``
    (bf16: O's columns in ceil(dh / 256) blocks along the grid, S summed
    over 64-column slices of Q and K; float32: every width to 1,024 in
    one block, S once per key tile): every case within FLASH_TOL and
    FLASH_SCALED_TOL, the kernel fed one column short must fail it, the
    profiler sees the dtype's kernel alone (bf16's ``_wide``); timed
    beside the plain version, SDPA and the bound.  Then the main path:
    a reduced Whisper whose encoder heads are 320 wide serving through
    ``ServeDriver.generate``, one flash launch per encoder layer, its
    prefill logits on the kernel route against the plain route in
    float32 and bf16."""
    from repro_torch.kernels.flash_attention.kernel import CC_MAX_DH

    cases = [_flash_case(torch, gen, case, "short_column")
             for case in FLASH_WIDE_CASES]
    for c in cases:
        # bf16 splits O's columns past 256; float32 holds them in one
        # block up to CC_MAX_DH (1,024)
        wide = c["dtype"] == "bfloat16" or c["shape"][4] > CC_MAX_DH
        if c["kernels_seen"] and not all(("_wide" in k) == wide
                                         for k in c["kernels_seen"]):
            fail(f"flash_wide {c['case']}: ran {c['kernels_seen']}, not "
                 f"the {'wide' if wide else 'one-block'} kernel")
    serve = _serve_wide_whisper(torch, gen, seed)
    emit("flash_wide", cases=cases, serve=serve,
         max_abs_err=max(c["max_abs_err"] for c in cases),
         library="torch.nn.functional.scaled_dot_product_attention")
    top = next(c for c in cases if c["case"] == "dh320_causal_gqa_bf16")
    return {**top, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "launches": serve["launches"],
            "launches_f32": serve["float32"]["launches"]["flash_attention"]}


def _serve_wide_whisper(torch, gen, seed):
    """Reduced whisper-small with encoder heads of WIDE_HEAD on the flash
    kernel: per dtype a warm generate, then one with every count set to
    0 just before (the encoder's layers launch flash once each, on the
    dtype's route), and prefill logits against the plain attention
    route -> the record; its ``launches`` sums the counted generates."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ROUTE_LAUNCHES, ROUTES
    from repro_torch.models import Model
    from repro_torch.serve import ServeDriver

    base = get_config("whisper-small", reduced=True)
    base = dataclasses.replace(
        base, head_dim=WIDE_HEAD, use_pallas_attention=True,
        encoder=dataclasses.replace(base.encoder, n_frames=WIDE_FRAMES))
    B, P, N = WIDE_B, WIDE_PROMPT, WIDE_NEW
    params = Model(base, device=DEV).init(
        torch.Generator(device=DEV).manual_seed(seed))
    frames = torch.randn(B, WIDE_FRAMES, base.d_model, generator=gen,
                         device=DEV)
    prompts = torch.randint(0, base.vocab, (B, P), generator=gen,
                            device=DEV, dtype=torch.int32)
    max_seq = P + N + 8
    batch = {"tokens": prompts, "frames": frames}
    out, total = {}, 0
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        model = Model(cfg, device=DEV)
        model.load(params)
        plain = Model(dataclasses.replace(cfg, use_pallas_attention=False),
                      device=DEV)
        plain.load(params)
        driver = ServeDriver(model=model, max_seq=max_seq, batch=B)
        fe = {"frames": frames}
        driver.generate(params, prompts, N, frontend=fe)  # warms
        routed = dict(ROUTE_LAUNCHES)
        tokens, secs, ln = _counted(torch, _all_kernels(), lambda: (
            driver.generate(params, prompts, N, frontend=fe)))
        routes = {r: ROUTE_LAUNCHES[r] - routed[r] for r in ROUTE_LAUNCHES}
        _check_tokens(torch, tokens, prompts, cfg.vocab, f"flash_wide "
                      f"whisper {dtype}")
        want_route = ROUTES[getattr(torch, dtype)].split()[0]
        if (ln["flash_attention"] != cfg.encoder.n_layers
                or routes[want_route] != cfg.encoder.n_layers):
            fail(f"flash_wide whisper {dtype}: launches {ln}, routes "
                 f"{routes}; want {cfg.encoder.n_layers} on the "
                 f"{want_route} kernel")
        got = _prefill_logits(torch, model, params, batch, max_seq)
        want = _prefill_logits(torch, plain, params, batch, max_seq)
        err = (got - want).abs().max().item()
        if err > ROUTE_TOL[dtype]:
            fail(f"flash_wide whisper {dtype}: prefill logits off the "
                 f"plain route by {err} (tol {ROUTE_TOL[dtype]})")
        total += ln["flash_attention"]
        out[dtype] = {"launches": ln, "routes": routes, "generate_s": secs,
                      "prefill_logits_max_abs_err": err,
                      "tol": ROUTE_TOL[dtype]}
        del model, plain, driver
    _free(torch)
    return {"arch": base.name, "head_dim": WIDE_HEAD,
            "encoder_layers": base.encoder.n_layers, "frames": WIDE_FRAMES,
            "batch": B, "prompt": P, "new_tokens": N, "launches": total,
            **out}


# phase ssd_any: (name, b, L, h, g, p, n, q, dtype, decay) over both
# dtypes, p = n in SSD_ANY_WIDTHS, the chunks of SSD_ANY_CHUNKS (four
# chunks of 24 and 100, two of 512), B / C in one group and in h / 4;
# timed at g = 1
SSD_ANY_WIDTHS = (8, 48, 96, 256)
SSD_ANY_CHUNKS = ((24, 4), (100, 4), (512, 2))
SSD_ANY_CASES = [
    (f"p{w}_n{w}_q{q}_g{g}_{dt}", 2, q * c, 8, g, w, w, q, dt, 1.0)
    for dt in ("bfloat16", "float32") for w in SSD_ANY_WIDTHS
    for q, c in SSD_ANY_CHUNKS for g in (1, 2)]
SSD_ANY_ROW = "p256_n256_q512_g1_bfloat16"  # the kernels line's case
# the main path at those shapes: reduced Mamba2 with SSM heads of 48,
# state width 96 and chunk 24 (d_model 96: four heads), its requests
ANY_MAMBA_SSM = {"head_dim": 48, "d_state": 96, "chunk": 24}
ANY_MAMBA_D, ANY_MAMBA_B, ANY_MAMBA_PROMPT, ANY_MAMBA_NEW = 96, 4, 60, 8


def phase_ssd_any(torch, gen, seed):
    """The SSD kernel at head and state widths that are no instance
    (8, 48, 96) and at 256, at chunks that are no multiple of 16 (24, 100)
    and past 256 (512: G streamed at width 256), B / C in one group and in
    h / 4, in both dtypes: each case within SSD_TOL and SSD_SCALED_TOL,
    one launch on the dtype's route, the plain version without the
    diagonal (and in bf16 the kernel fed a shifted Adt) failing the
    check; the g = 1 cases timed beside the plain version and the bound.
    Then the main path: a reduced Mamba2 at SSM head width 48, state
    width 96 and chunk 24 through ``ServeDriver.generate`` on the kernel
    route, held against the plain route."""
    cases = [_ssd_case(torch, gen, case, timed=case[4] == 1)
             for case in SSD_ANY_CASES]
    serve = _serve_any_mamba(torch, gen, seed)
    max_err = max(max(c["y_max_abs_err"], c["state_max_abs_err"])
                  for c in cases)
    emit("ssd_any", cases=cases, serve=serve, max_abs_err=max_err,
         library=None)
    top = next(c for c in cases if c["case"] == SSD_ANY_ROW)
    return {**top, "max_abs_err": max_err, "launches": serve["launches"]}


def _serve_any_mamba(torch, gen, seed, *, d_model=ANY_MAMBA_D,
                     ssm=ANY_MAMBA_SSM, what="ssd_any mamba2"):
    """Reduced mamba2-370m at ``ssm``'s widths and chunk (ANY_MAMBA_SSM's
    by default; prompts padded to whole chunks): the SSD route handed
    B / C in one group, one launch per layer per generate (bf16: all on
    the tensor-core kernel) in a generate with every count set to 0 just
    before; prefill logits of the kernel route against the plain SSD
    route in float32 and bf16, float32 tokens under the near-tie rule ->
    the record."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_chunk import ROUTE_LAUNCHES
    from repro_torch.models import Model
    from repro_torch.serve import ServeDriver

    base = get_config("mamba2-370m", reduced=True)
    cfg = dataclasses.replace(base, d_model=d_model,
                              ssm=dataclasses.replace(base.ssm, **ssm))
    B, P, N = ANY_MAMBA_B, ANY_MAMBA_PROMPT, ANY_MAMBA_NEW
    model = Model(cfg, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(seed))
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=DEV,
                            dtype=torch.int32)
    max_seq = P + N + 8
    driver = ServeDriver(model=model, max_seq=max_seq, batch=B)
    calls = []
    with _SsdRoute(_recording_ssd(calls)):
        out = driver.generate(params, prompts, N)  # warms
    _check_tokens(torch, out, prompts, cfg.vocab, what)
    if len(calls) != cfg.n_layers or any(
            c["groups"] != cfg.ssm.n_groups for c in calls):
        fail(f"{what}: the SSD route was handed {calls}; expected "
             f"{cfg.n_layers} calls with B / C in {cfg.ssm.n_groups} group")
    routed = dict(ROUTE_LAUNCHES)
    tokens, secs, ln = _counted(torch, _all_kernels(), lambda: (
        driver.generate(params, prompts, N)))
    routes = {r: ROUTE_LAUNCHES[r] - routed[r] for r in ROUTE_LAUNCHES}
    if ln["ssd_chunk"] != cfg.n_layers or (
            routes["tensor-core"] != cfg.n_layers):
        fail(f"{what}: launches {ln}, routes {routes}; expected "
             f"{cfg.n_layers} ssd_chunk on the tensor-core kernel")
    logits = _routes_vs(torch, model, model, params, prompts, max_seq,
                        f"{what} kernel route against the plain SSD route",
                        ref_route=_SsdRoute(_plain_ssd))
    f32 = _with_dtype(model, params, "float32")
    tok = _tokens_vs(torch, f32, f32, params, prompts, N, max_seq,
                     f"{what} float32", ref_route=_SsdRoute(_plain_ssd))
    del model, params, driver, f32
    _free(torch)
    return {"arch": cfg.name, "d_model": cfg.d_model, **ssm,
            "heads": cfg.ssm.n_heads(cfg.d_model), "layers": cfg.n_layers,
            "batch": B, "prompt": P, "new_tokens": N, "launches":
            ln["ssd_chunk"], "routes": routes, "generate_s": secs,
            "in_place": [c["in_place"] for c in calls], **logits,
            "float32_tokens": tok}


# ---------------- this slice: grids past 65,535 and SSD widths past 256
# phase grid_wide.  SSD (name, b, L, h, g, p, n, q, dtype, decay): b h =
# 65,536 (mamba2-370m's 32 heads at batch 2,048, fault 1 in bf16; the
# float32 launch's (batch, head) axis), Jamba's layer at batch 256 (256
# heads in 8 groups); timed: the two mamba2 cases
GRID_SSD_CASES = [
    ("mamba2_b2048_bf16", 2048, 16, 32, 1, 64, 128, 16, "bfloat16", 1.0),
    ("mamba2_b2048_f32", 2048, 16, 32, 1, 64, 128, 16, "float32", 1.0),
    ("jamba_b256_g8_bf16", 256, 64, 256, 8, 64, 128, 64, "bfloat16", 1.0),
]
GRID_SSD_TIMED = ("mamba2_b2048_bf16", "mamba2_b2048_f32")
# flash (FLASH_CASES' tuple): B x column blocks of 65,536, one head,
# S = 16, both dtypes, causal and full; timed: the bf16 causal ones
GRID_FLASH_CASES = [
    (f"b{B}_dh{dh}_{'causal' if causal else 'full'}_{dt}", B, 1, 1, 16, dh,
     causal, dt, 0.5)
    for B, dh in ((65536, 64), (16384, 1024))
    for dt in ("bfloat16", "float32") for causal in (True, False)]
GRID_FLASH_TIMED = ("b65536_dh64_causal_bfloat16",
                    "b16384_dh1024_causal_bfloat16")
# SSD past width 256: p = n = 320 and 512 at chunks 64 and 256, and p 512
# with n 128 at chunk 64; b = 2, 8 heads, two chunks, B / C in one group
# and in h / 4, both dtypes; timed at g = 1
WIDE_SSD_CASES = [
    (f"p{p}_n{n}_q{q}_g{g}_{dt}", 2, 2 * q, 8, g, p, n, q, dt, 1.0)
    for dt in ("bfloat16", "float32")
    for p, n, q in ((320, 320, 64), (320, 320, 256), (512, 512, 64),
                    (512, 512, 256), (512, 128, 64))
    for g in (1, 2)]
WIDE_SSD_ROW = "p512_n512_q256_g1_bfloat16"  # the kernels line's case
# the main path past 256: reduced Mamba2 with SSM heads of 320, a state
# of 288 and chunk 32 (d_model 320: two heads)
WIDE_MAMBA_D, WIDE_MAMBA_SSM = 320, {"head_dim": 320, "d_state": 288,
                                     "chunk": 32}
# the main path past 65,535: a mamba2-370m bf16 prefill of 2,048 prompts
# of 256 tokens at full width, 4 of its 48 layers, held against the
# plain SSD route in slices of 256 prompts
PREFILL_B, PREFILL_S, PREFILL_LAYERS, PREFILL_SLICE = 2048, 256, 4, 256


def phase_grid_wide(torch, gen, seed):
    """The SSD and flash kernels past a grid axis of 65,535 and the SSD
    kernel past width 256 (the ``_wide`` kernels), each case under the
    gates and faults of ``ssd`` / ``flash`` with one launch on its
    dtype's route; a few timed beside the plain version and the bound.
    Then two main paths: the mamba2-370m prefill of PREFILL_B prompts on
    the kernel route (fault 1: b h = 65,536 in bf16) against the plain
    route in slices, and a reduced Mamba2 at SSM head width 320 served
    through ``ServeDriver.generate`` on the ``_wide`` kernel."""
    ssd = [_ssd_case(torch, gen, case, timed=case[0] in GRID_SSD_TIMED)
           for case in GRID_SSD_CASES]
    _free(torch)
    flash = [_flash_case(torch, gen, case, "short_column",
                         timed=case[0] in GRID_FLASH_TIMED)
             for case in GRID_FLASH_CASES]
    _free(torch)
    wide = [_ssd_case(torch, gen, case, timed=case[4] == 1)
            for case in WIDE_SSD_CASES]
    prefill = _prefill_batch(torch, gen, seed)
    serve = _serve_any_mamba(torch, gen, seed, d_model=WIDE_MAMBA_D,
                             ssm=WIDE_MAMBA_SSM, what="grid_wide mamba2")
    cases = ssd + wide
    max_err = max(max(c["y_max_abs_err"], c["state_max_abs_err"])
                  for c in cases)
    emit("grid_wide", ssd=ssd, flash=flash, ssd_wide=wide, prefill=prefill,
         serve=serve, max_abs_err=max_err,
         flash_max_abs_err=max(c["max_abs_err"] for c in flash),
         library="torch.nn.functional.scaled_dot_product_attention "
                 "(flash); none (SSD)")
    return {"grid": {**ssd[0], "max_abs_err": max(
                max(c["y_max_abs_err"], c["state_max_abs_err"])
                for c in ssd), "launches": prefill["launches"]},
            "wide": {**next(c for c in wide if c["case"] == WIDE_SSD_ROW),
                     "max_abs_err": max(
                         max(c["y_max_abs_err"], c["state_max_abs_err"])
                         for c in wide), "launches": serve["launches"]}}


def _prefill_batch(torch, gen, seed):
    """mamba2-370m at full width cut to PREFILL_LAYERS of its layers, bf16:
    a prefill of PREFILL_B prompts of PREFILL_S tokens with every count
    set to 0 just before (one SSD launch a layer, on the tensor-core
    kernel: b h = 65,536), timed by CUDA events with its peak memory;
    its last logits and final SSM states against the same prompts on the
    plain SSD route in slices of PREFILL_SLICE prompts (the plain
    version's float32 G of the whole batch would not fit), logits within
    MAMBA_TOL and the states within MAMBA_TOL of their largest -> the
    record."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_chunk import ROUTE_LAUNCHES
    from repro_torch.models import Model, init_cache
    from repro_torch.serve import make_prefill_step

    full = get_config("mamba2-370m")
    cfg = dataclasses.replace(full, n_layers=PREFILL_LAYERS)
    model = Model(cfg, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(seed))
    B, S = PREFILL_B, PREFILL_S
    prompts = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=DEV,
                            dtype=torch.int32)
    step = make_prefill_step(model)

    def prefill(rows):
        caches = init_cache(cfg, rows.shape[0], S, device=DEV)
        with torch.inference_mode():
            logits = step(params, {"tokens": rows}, caches)[0]
        return logits, caches["blocks"]["l0"]["ssm"]

    prefill(prompts[:8])  # warms
    routed = dict(ROUTE_LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def run():
        start.record()
        out = prefill(prompts)
        end.record()
        return out

    (logits, states), secs, ln = _counted(torch, _all_kernels(), run)
    ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated()
    routes = {r: ROUTE_LAUNCHES[r] - routed[r] for r in ROUTE_LAUNCHES}
    if ln["ssd_chunk"] != cfg.n_layers or routes["tensor-core"] != (
            cfg.n_layers) or any(v for k, v in ln.items()
                                 if k != "ssd_chunk"):
        fail(f"grid_wide prefill: launches {ln}, routes {routes}; expected "
             f"{cfg.n_layers} ssd_chunk on the tensor-core kernel")
    if not (torch.isfinite(logits).all() and torch.isfinite(states).all()):
        fail("grid_wide prefill: non-finite logits or states")
    l_err = s_err = s_size = 0.0
    with _SsdRoute(_plain_ssd):
        for r0 in range(0, B, PREFILL_SLICE):
            rl, rs = prefill(prompts[r0:r0 + PREFILL_SLICE])
            sl = slice(r0, r0 + PREFILL_SLICE)
            l_err = max(l_err, (logits[sl].float() - rl.float()).abs()
                        .max().item())
            s_err = max(s_err, (states[:, sl].float() - rs.float()).abs()
                        .max().item())
            s_size = max(s_size, rs.float().abs().max().item())
            del rl, rs
    tol = MAMBA_TOL["bfloat16"]
    if l_err > tol or s_err > tol * max(1.0, s_size):
        fail(f"grid_wide prefill: logits off the plain route by {l_err}, "
             f"states by {s_err} of {s_size} (tol {tol})")
    del model, params, logits, states
    _free(torch)
    return {"arch": cfg.name, "dtype": cfg.dtype,
            "cut": {"layers": PREFILL_LAYERS, "of": full.n_layers},
            "batch": B, "prompt": S, "ssd_heads": cfg.ssm.n_heads(
                cfg.d_model), "launches": ln["ssd_chunk"], "routes": routes,
            "prefill_ms": ms, "host_s": secs, "peak_mem_gib": peak / 2 ** 30,
            "plain_slices": -(-B // PREFILL_SLICE),
            "logits_max_abs_err": l_err, "states_max_abs_err": s_err,
            "states_max_abs": s_size, "tol": tol}


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
        try:
            out = fn(*a)
        finally:  # a failed run still shows where its time went
            seconds[name] = time.perf_counter() - t0
            print(f"[chip_smoke] {name}: {seconds[name]:.1f} s",
                  file=sys.stderr, flush=True)
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
    # the checks of this slice's repairs, after the main paths
    timed("pod_bf16", phase_pod_bf16, torch, gen)
    timed("gain_bf16", phase_gain_bf16, torch, gen)
    flash96 = timed("flash_dh96", phase_flash_dh96, torch, gen)
    # this slice: every algorithm in the pod, the ingest front end
    sieves = timed("pod_sieves", phase_pod_sieves, torch, gen, args.seed)
    ingest = timed("ingest", phase_ingest, torch, gen)
    # this slice: checkpoints, the live handoff, the pub/sub front end,
    # the distributed merge and the coreset
    ckpt = timed("ckpt", phase_ckpt, torch, gen)
    handoff = timed("handoff", phase_handoff, torch, gen)
    pubsub = timed("pubsub", phase_pubsub, torch, gen)
    dist = timed("distributed", phase_distributed, torch, gen, paper)
    # this slice: MoE, MLA and every architecture of the registry
    timed("deepseek", phase_deepseek, torch, gen, args.seed)
    archs = timed("archs", phase_archs, torch, gen, args.seed)
    # this slice: training; first the gradient through the kernel routes
    # and flash at head width 16
    tgrad = timed("train_grad", phase_train_grad, torch, gen, args.seed)
    flash16 = timed("flash_dh16", phase_flash_dh16, torch, gen)
    timed("train_qwen2", phase_train_qwen2, torch, gen, args.seed)
    tmamba = timed("train_mamba", phase_train_mamba, torch, gen, args.seed)
    # this slice: the scale-out path, ranks spawned on the one card; the
    # dry-run's CPU processes run beside it (read in phase dryrun)
    dry = start_dryrun()
    try:
        spod = timed("sharded_pod", phase_sharded_pod, torch, args.seed)
        smerge = timed("sharded_merge", phase_sharded_merge, torch, paper)
        scomp = timed("pod_compress", phase_pod_compress, torch, args.seed)
        nccl = timed("nccl", phase_nccl, torch, args.seed, paper)
        # the last slice: flash at every head width up to 256, the model
        # on a mesh (tensor and context parallelism, training), the
        # dry-run
        flash_any = timed("flash_dh_any", phase_flash_dh_any, torch, gen)
        tp = timed("tp_forward", phase_tp_forward, torch, args.seed)
        cp = timed("seq_shard", phase_seq_shard, torch, args.seed)
        timed("train_mesh", phase_train_mesh, torch, args.seed)
        timed("dryrun", phase_dryrun, torch, dry)
    finally:  # a failed phase leaves no dry-run process behind
        for _, _, proc in dry[1]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    # this slice: flash past head width 256, the SSD kernel at every head
    # width, state width and chunk
    wide = timed("flash_wide", phase_flash_wide, torch, gen, args.seed)
    anyssd = timed("ssd_any", phase_ssd_any, torch, gen, args.seed)
    # this slice: grids past 65,535 (both kernels), SSD past width 256
    gw = timed("grid_wide", phase_grid_wide, torch, gen, args.seed)
    emit("seconds", total=sum(seconds.values()), **seconds)

    kernels = [
        {"name": "gain_traced", "route": "cuda",
         "source": "src/repro_torch/csrc/rbf_gain.cu",
         "replaces": "src/repro/kernels/rbf_gain/kernel.py:126",
         "launches": (sieve["launches"] + paper["gain_traced"]
                      + sieves["launches"] + dist["gain_traced"]
                      + smerge["gain_traced"] + nccl["gain_traced"]),
         "max_abs_err": max(gain["max_abs_err"], stacked["max_abs_err"],
                            sieve["max_abs_err"], paper["max_abs_err"],
                            sieves["max_abs_err"], dist["max_abs_err"]),
         "ms": gain["ms"], "plain_ms": gain["plain_ms"],
         "bound_ms": gain["bound_ms"], "bound_by": gain["bound_by"],
         "library_ms": None},
        {"name": "gain_static", "route": "cuda",
         "source": "src/repro_torch/csrc/rbf_gain.cu",
         "replaces": "src/repro/kernels/rbf_gain/kernel.py:74",
         "launches": (paper["gain_static"] + dist["gain_static"]
                      + smerge["gain_static"] + nccl["gain_static"]),
         "max_abs_err": max(static["max_abs_err"], paper["max_abs_err"],
                            dist["max_abs_err"]),
         "ms": static["ms"], "plain_ms": static["plain_ms"],
         "bound_ms": static["bound_ms"], "bound_by": static["bound_by"],
         "library_ms": None},
        {"name": "pod_step", "route": "cuda",
         "source": "src/repro_torch/csrc/pod_step.cu",
         "replaces": "src/repro/kernels/pod_step/kernel.py:160",
         "launches": (pod["launches"] + ingest["launches"]
                      + ckpt["launches"] + handoff["launches"]
                      + pubsub["launches"] + spod["launches"]
                      + nccl["pod_step"]),
         "max_abs_err": max(pod_err, large["max_abs_err"],
                            pod["max_abs_err"], handoff["max_abs_err"]),
         "ms": pod["ms"], "plain_ms": pod["plain_ms"],
         "bound_ms": pod["bound_ms"], "bound_by": pod["bound_by"],
         "library_ms": None},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:81",
         "launches": (whisper["launches"] + tp["flash_attention"]
                      + cp["flash_attention"]),
         "max_abs_err": max(flash["max_abs_err"], flash96["max_abs_err"]),
         "ms": flash["ms"], "plain_ms": flash["plain_ms"],
         "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
         "library_ms": flash["library_ms"]},
        # the same kernel at head width 16 (every reduced config's); its
        # launches: the reduced models' gradient steps of train_grad, in
        # both dtypes
        {"name": "flash_attention_dh16", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:81",
         "launches": tgrad["launches"]["flash_attention"],
         "max_abs_err": flash16["max_abs_err"],
         "ms": flash16["ms"], "plain_ms": flash16["plain_ms"],
         "bound_ms": flash16["bound_ms"], "bound_by": flash16["bound_by"],
         "library_ms": flash16["library_ms"]},
        # the same kernel at the widest head (256, bf16 causal GQA, 64-key
        # tiles); its launches: the mesh phases', where the kernel runs on
        # each rank's heads (qwen2 dh 128, phi3 dh 96)
        {"name": "flash_attention_dh_any", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:81",
         "launches": tp["flash_attention"] + cp["flash_attention"],
         "max_abs_err": flash_any["max_abs_err"],
         "ms": flash_any["ms"], "plain_ms": flash_any["plain_ms"],
         "bound_ms": flash_any["bound_ms"],
         "bound_by": flash_any["bound_by"],
         "library_ms": flash_any["library_ms"]},
        {"name": "ssd_chunk", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_chunk.cu",
         "replaces": "src/repro/kernels/ssd_chunk/kernel.py:58",
         "launches": (mamba["launches"] + tgrad["launches"]["ssd_chunk"]
                      + tmamba["launches"] + scomp["launches"]
                      + nccl["ssd_chunk"] + tp["ssd_chunk"]),
         "max_abs_err": ssd["max_abs_err"],
         "ms": ssd["ms"], "plain_ms": ssd["plain_ms"],
         "bound_ms": ssd["bound_ms"], "bound_by": ssd["bound_by"],
         "library_ms": None},
        # the same kernel at the layer shape of Jamba's published config
        # (8 B / C groups of 32 heads); its launches: the reduced Jamba's
        # counted generate
        {"name": "ssd_chunk_jamba_g8", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_chunk.cu",
         "replaces": "src/repro/kernels/ssd_chunk/kernel.py:58",
         "launches": archs["jamba_launches"],
         "max_abs_err": archs["max_abs_err"],
         "ms": archs["ms"], "plain_ms": archs["plain_ms"],
         "bound_ms": archs["bound_ms"], "bound_by": archs["bound_by"],
         "library_ms": None},
        # the same kernel past head width 256 (dh 320, bf16 causal GQA,
        # O's columns in two blocks of 160); its launches: the reduced
        # Whisper with encoder heads of 320, in both dtypes
        {"name": "flash_attention_wide", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:81",
         "launches": wide["launches"],
         "max_abs_err": wide["max_abs_err"],
         "ms": wide["ms"], "plain_ms": wide["plain_ms"],
         "bound_ms": wide["bound_ms"], "bound_by": wide["bound_by"],
         "library_ms": wide["library_ms"]},
        # the same kernel at any head width, state width and chunk (p = n
        # = 256 at chunk 512, bf16: G streamed); its launches: the reduced
        # Mamba2 at head width 48, state width 96 and chunk 24
        {"name": "ssd_chunk_any_shape", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_chunk.cu",
         "replaces": "src/repro/kernels/ssd_chunk/kernel.py:58",
         "launches": anyssd["launches"],
         "max_abs_err": anyssd["max_abs_err"],
         "ms": anyssd["ms"], "plain_ms": anyssd["plain_ms"],
         "bound_ms": anyssd["bound_ms"], "bound_by": anyssd["bound_by"],
         "library_ms": None},
        # the same kernel past a grid axis of 65,535 (b = 2,048, 32 heads,
        # L = chunk = 16, bf16: fault 1's shape); its launches: the
        # mamba2-370m prefill of 2,048 prompts (4 of 48 layers)
        {"name": "ssd_chunk_grid", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_chunk.cu",
         "replaces": "src/repro/kernels/ssd_chunk/kernel.py:58",
         "launches": gw["grid"]["launches"],
         "max_abs_err": gw["grid"]["max_abs_err"],
         "ms": gw["grid"]["ms"], "plain_ms": gw["grid"]["plain_ms"],
         "bound_ms": gw["grid"]["bound_ms"],
         "bound_by": gw["grid"]["bound_by"], "library_ms": None},
        # the _wide kernel (p = n = 512 at chunk 256, bf16); its launches:
        # the reduced Mamba2 with SSM heads of 320 served
        {"name": "ssd_chunk_wide", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_chunk.cu",
         "replaces": "src/repro/kernels/ssd_chunk/kernel.py:58",
         "launches": gw["wide"]["launches"],
         "max_abs_err": gw["wide"]["max_abs_err"],
         "ms": gw["wide"]["ms"], "plain_ms": gw["wide"]["plain_ms"],
         "bound_ms": gw["wide"]["bound_ms"],
         "bound_by": gw["wide"]["bound_by"], "library_ms": None},
        # the float32 routes of the two kernels (FP32 on the CUDA cores,
        # redesigned in this slice): flash at qwen2-1.5b's causal GQA shape
        # (the float32 mesh forward's per-rank shape), timed beside SDPA;
        # its launches: the float32 runs of tp_forward, flash_wide's
        # Whisper and train_grad
        {"name": "flash_attention_f32", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:81",
         "launches": (tp["float32"]["flash_attention"]
                      + wide["launches_f32"]
                      + tgrad["float32_launches"]["flash_attention"]),
         "max_abs_err": max(flash["max_abs_err"], flash_any["max_abs_err"],
                            wide["max_abs_err"]),
         "ms": flash["f32"]["ms"], "plain_ms": flash["f32"]["plain_ms"],
         "bound_ms": flash["f32"]["bound_ms"],
         "bound_by": flash["f32"]["bound_by"],
         "library_ms": flash["f32"]["library_ms"]},
        # SSD at the Mamba2-370m prefill in float32 (slow decay); its
        # launches: the float32 runs of train_grad (Mamba2-370m whole: 96
        # a step) and tp_forward
        {"name": "ssd_chunk_f32", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_chunk.cu",
         "replaces": "src/repro/kernels/ssd_chunk/kernel.py:58",
         "launches": (tgrad["float32_launches"]["ssd_chunk"]
                      + tp["float32"]["ssd_chunk"]),
         "max_abs_err": max(ssd["f32"]["y_max_abs_err"],
                            ssd["f32"]["state_max_abs_err"]),
         "ms": ssd["f32"]["ms"], "plain_ms": ssd["f32"]["plain_ms"],
         "bound_ms": ssd["f32"]["bound_ms"],
         "bound_by": ssd["f32"]["bound_by"], "library_ms": None},
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
