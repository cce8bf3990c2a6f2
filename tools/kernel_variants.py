#!/usr/bin/env python3
"""Time the float32 flash and SSD kernels against variants of their own
source on one card: each variant is the CUDA source with a text change
(the ``ABLATIONS`` below drop one piece of work: the staging copies, a
product, the softmax), built by nvcc like ``kernels/build.py`` into
``build/variants/`` and bound in place of the kernel's library, so the
wrappers, shapes and inputs are the same for every variant.

    python3 tools/kernel_variants.py [--set flash|ssd|all] [--reps 30]

Prints one JSON line per variant: the median of ``--reps`` calls of the
wrapper bracketed by CUDA events (the launch included), and whether the
output still matched the plain version (an ablation's does not; its time
says what the dropped work costs).  Needs a CUDA card; writes only under
``build/``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name -> (source, [(text, replacement), ...]); "" is the source as it is
ABLATIONS = {
    "flash": {
        "base": [],
        # no chunk staged: the copies and their shared-memory writes
        "no_fills": [("  auto fetch = [&](int i) {  // chunk i of the "
                      "sequence into its slot\n    if (i < total) {",
                      "  auto fetch = [&](int i) {  // chunk i of the "
                      "sequence into its slot\n    if (i < total && "
                      "kv_len < -5) {")],
        # no S = Q K^T products (their loads included)
        "no_s": [("      for (int dd = 0; dd < DSS; dd += 4) {",
                  "      for (int dd = 0; dd < 0; dd += 4) {")],
        # no O += P V products
        "no_pv": [("      for (int kk = 0; kk < VK; kk += 4) {",
                   "      for (int kk = 0; kk < 0; kk += 4) {")],
        # no softmax (the partial tiles' sum, masks, exponentials)
        "no_softmax": [("    {  // softmax of row sr over keys k0 + seg "
                        "EPT ..", "    if (kv_len < -5) {  // softmax")],
    },
    "ssd": {
        "base": [],
        "no_fills": [("  const int r = tid / C4, c = 4 * (tid % C4);\n"
                      "  if (c0 + c >= clim) return;",
                      "  const int r = tid / C4, c = 4 * (tid % C4);\n"
                      "  if (c0 + c >= clim || rlim > -5) return;")],
        # no S X products
        "no_sx": [("          for (int kk = 0; kk < kn; kk += 4) {",
                   "          for (int kk = 0; kk < 0; kk += 4) {")],
        # no end-state products
        "no_states": [("        for (int t = 0; t < tl; ++t) {",
                       "        for (int t = 0; t < 0; ++t) {")],
        # no S = select(G exp(.)) (the exponentials)
        "no_s": [("          for (int e = lt; e < QT * QT; e += LT) {",
                  "          for (int e = lt; e < 0; e += LT) {")],
    },
}
SOURCES = {"flash": "flash_attention.cu", "ssd": "ssd_chunk.cu"}


def build(kind: str, name: str, subs) -> Path:
    """The variant's source under build/variants/<kind>_<name>/ and its
    library, by nvcc with kernels/build.py's flags."""
    from repro_torch.kernels import build as kb

    d = ROOT / "build" / "variants" / f"{kind}_{name}"
    d.mkdir(parents=True, exist_ok=True)
    for f in kb.CSRC.glob("*.cuh"):
        shutil.copy(f, d)
    src = (kb.CSRC / SOURCES[kind]).read_text()
    for a, b in subs:
        if a not in src:
            raise SystemExit(f"{kind}/{name}: the text to change is not in "
                             f"the source: {a[:60]!r}")
        src = src.replace(a, b)
    (d / SOURCES[kind]).write_text(src)
    out = d / "lib.so"
    r = subprocess.run([kb.nvcc_path(), *kb.NVCC_FLAGS, "-I", str(d), "-o",
                        str(out), str(d / SOURCES[kind])],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"{kind}/{name}: nvcc failed\n{r.stdout[-3000:]}"
                         f"{r.stderr[-3000:]}")
    return out


def cases(torch, F, kind):
    """(name, call, plain result) of the float32 cases: flash ragged at S
    = 300 (padded to 384) and qwen2-1.5b's causal GQA; SSD at the
    Mamba2-370m prefill (slow decay), at b h = 65,536 and p = n = 256."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)
    from repro_torch.kernels.ssd_chunk import ssd_chunk_cuda, ssd_chunks

    g = torch.Generator(device="cuda").manual_seed(0)
    out = []
    if kind == "flash":
        for name, B, Hq, Hkv, S, dh, causal in (
                ("f300_dh128", 2, 4, 2, 300, 128, False),
                ("f300_dh512", 2, 4, 2, 300, 512, False),
                ("f300_dh1024", 2, 4, 2, 300, 1024, False),
                ("qwen2_f32", 1, 12, 2, 2048, 128, True)):
            q = 0.5 * torch.randn(B, Hq, S, dh, generator=g, device="cuda")
            k = 0.5 * torch.randn(B, Hkv, S, dh, generator=g, device="cuda")
            v = torch.randn(B, Hkv, S, dh, generator=g, device="cuda")
            pad = (-S) % min(128, max(S, 8))
            qp, kp, vp = (F.pad(t, (0, 0, 0, pad)).contiguous()
                          for t in (q, k, v))
            want = attention_ref(q, k, v, causal=causal)

            def call(qp=qp, kp=kp, vp=vp, S=S, causal=causal):
                return flash_attention_cuda(qp, kp, vp, causal=causal,
                                            kv_len=S)

            out.append((name, call, lambda r, want=want, S=S: torch.allclose(
                r[:, :, :S], want, rtol=2e-4, atol=2e-4)))
    else:
        for name, b, L, h, p, n, q, decay in (
                ("prefill_slow", 8, 2048, 32, 64, 128, 256, 0.01),
                ("b2048_q16", 2048, 16, 32, 64, 128, 16, 1.0),
                ("p256_q512", 2, 1024, 8, 256, 256, 512, 1.0)):
            X = torch.randn(b, L, h, p, generator=g, device="cuda")
            A = -decay * F.softplus(torch.randn(b, L, h, generator=g,
                                                device="cuda"))
            Bm = torch.randn(b, L, 1, n, generator=g, device="cuda")
            Cm = torch.randn(b, L, 1, n, generator=g, device="cuda")
            Yr, sr = ssd_chunks(X, A, Bm, Cm, chunk=q, backend="torch")

            def call(X=X, A=A, Bm=Bm, Cm=Cm, q=q):
                return ssd_chunk_cuda(X, A, Bm, Cm, chunk=q)

            out.append((name, call, lambda r, Yr=Yr, sr=sr: torch.allclose(
                r[0], Yr, rtol=1e-5, atol=1e-5) and torch.allclose(
                r[1], sr, rtol=1e-5, atol=1e-5)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set", default="all", choices=("all", "flash", "ssd"))
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    os.chdir(ROOT)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels.flash_attention import KERNEL as FK
    from repro_torch.kernels.ssd_chunk import KERNEL as SK

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    kinds = ("flash", "ssd") if args.set == "all" else (args.set,)
    for kind in kinds:
        libs = {name: build(kind, name, subs)
                for name, subs in ABLATIONS[kind].items()}
        kernel = FK if kind == "flash" else SK
        todo = cases(torch, F, kind)
        for name, lib in libs.items():
            kernel._bind(lib)
            rec = {"kernel": kind, "variant": name}
            for case, call, ok in todo:
                r = call()
                torch.cuda.synchronize()
                right = bool(ok(r))
                for _ in range(3):
                    call()
                times = []
                for _ in range(args.reps):
                    s = torch.cuda.Event(enable_timing=True)
                    e = torch.cuda.Event(enable_timing=True)
                    s.record()
                    call()
                    e.record()
                    e.synchronize()
                    times.append(s.elapsed_time(e))
                rec[case] = {"event_ms": statistics.median(times),
                             "matches_plain": right}
                torch.cuda.empty_cache()
            print(json.dumps(rec), flush=True)
        kernel.lib = None  # the next call rebinds the package's own build
    return 0


if __name__ == "__main__":
    sys.exit(main())
