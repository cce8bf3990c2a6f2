#!/usr/bin/env python3
"""Time the flash and SSD kernel cases of ``chip_smoke.py`` in two trees
of the repository on one card, in turns, so that the two can be compared
within one machine's run.

    python3 tools/chip_compare.py --trees build/parent . --order 0,1,1,0

Each entry of ``--order`` is one fresh process running in the tree of
that index: it imports that tree's ``chip_smoke.py`` and ``repro_torch``
(whose kernels it builds from that tree's sources at first use) and runs
every case below through the tree's own ``_flash_case`` / ``_ssd_case``
(the gates of ``chip_smoke.py``, device time by the profiler, the plain
version, SDPA for flash, the bound), printing one JSON line per case
tagged with the tree and the turn.  The case tuples are this script's,
so a tree whose ``chip_smoke.py`` lacks a case still runs it.  Needs a
CUDA card; writes nothing.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

# (name, B, Hq, Hkv, S, dh, causal, dtype, std): chip_smoke.py's
# FLASH_CASES, FLASH_DH96_CASES, the float32 widths of FLASH_ANY_CASES and
# FLASH_WIDE_CASES, and their timed bf16 cases
FLASH = (
    [("whisper_encoder", 8, 12, 12, 1500, 64, False, "bfloat16", 0.5),
     ("qwen2_causal_gqa", 1, 12, 2, 2048, 128, True, "bfloat16", 0.5),
     ("ragged_f32", 2, 4, 2, 100, 64, True, "float32", 0.5),
     ("qwen2_causal_gqa_f32", 1, 12, 2, 2048, 128, True, "float32", 0.5),
     ("phi3_mini_causal", 1, 32, 32, 2048, 96, True, "bfloat16", 0.5),
     ("dh96_ragged_f32", 2, 4, 4, 300, 96, True, "float32", 0.5),
     ("dh256_causal_gqa_bf16", 2, 8, 2, 1024, 256, True, "bfloat16", 0.5)]
    + [(f"dh{dh}_ragged_f32", 2, 4, 2, 300, dh, False, "float32", 0.5)
       for dh in (8, 24, 40, 48, 80, 112, 136, 160, 192, 256, 264, 300, 320,
                  384, 512, 1024)]
    + [(f"dh{dh}_causal_gqa_bf16", 2, 8, 2, 1024, dh, True, "bfloat16", 0.5)
       for dh in (320, 1024)])
# (name, b, L, h, g, p, n, q, dtype, decay): chip_smoke.py's SSD_CASES,
# the g = 1 cases of SSD_ANY_CASES, GRID_SSD_TIMED and the g = 1 cases of
# WIDE_SSD_CASES
SSD = (
    [("mamba2_prefill", 8, 2048, 32, 1, 64, 128, 256, "bfloat16", 1.0),
     ("mamba2_prefill_per_head", 8, 2048, 32, 32, 64, 128, 256, "bfloat16",
      1.0),
     ("mamba2_prefill_slow_f32", 8, 2048, 32, 1, 64, 128, 256, "float32",
      0.01),
     ("reduced_f32", 2, 64, 8, 1, 16, 16, 16, "float32", 1.0)]
    + [(f"p{w}_n{w}_q{q}_g1_{dt}", 2, q * c, 8, 1, w, w, q, dt, 1.0)
       for dt in ("bfloat16", "float32") for w in (8, 48, 96, 256)
       for q, c in ((24, 4), (100, 4), (512, 2))]
    + [("mamba2_b2048_bf16", 2048, 16, 32, 1, 64, 128, 16, "bfloat16", 1.0),
       ("mamba2_b2048_f32", 2048, 16, 32, 1, 64, 128, 16, "float32", 1.0)]
    + [(f"p{p}_n{n}_q{q}_g1_{dt}", 2, 2 * q, 8, 1, p, n, q, dt, 1.0)
       for dt in ("bfloat16", "float32")
       for p, n, q in ((320, 320, 64), (320, 320, 256), (512, 512, 64),
                       (512, 512, 256), (512, 128, 64))])
KEEP = ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
        "route", "max_abs_err", "y_max_abs_err", "state_max_abs_err",
        "y_share_differing", "kernels_seen")


def run_tree(root: str, turn: int, which: str) -> None:
    """One turn in ``root``: every case of ``which`` ("flash", "ssd" or
    "all") through that tree's chip_smoke.py, a JSON line each."""
    root = str(Path(root).resolve())
    os.chdir(root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("chip_compare: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    if which in ("flash", "all"):
        for case in FLASH:
            rec = cs._flash_case(torch, gen, case, None)
            print(json.dumps({"tree": root, "turn": turn, "kernel": "flash",
                              "case": case[0], "dtype": case[7],
                              **{k: rec.get(k) for k in KEEP}}), flush=True)
    if which in ("ssd", "all"):
        for case in SSD:
            rec = cs._ssd_case(torch, gen, case)
            print(json.dumps({"tree": root, "turn": turn, "kernel": "ssd",
                              "case": case[0], "dtype": case[8],
                              **{k: rec.get(k) for k in KEEP}}), flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({"tree": root, "turn": turn, "seconds":
                      time.perf_counter() - t0,
                      "device": torch.cuda.get_device_name(0)}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True,
                    help="roots of the trees (a checkout each)")
    ap.add_argument("--order", default="0,1,1,0",
                    help="tree indices, one process each, in turn")
    ap.add_argument("--cases", default="all", choices=("all", "flash", "ssd"))
    ap.add_argument("--one", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--turn", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:  # a child: one turn in one tree
        run_tree(args.trees[args.one], args.turn, args.cases)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    for turn, i in enumerate(int(x) for x in args.order.split(",")):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--trees", *args.trees, "--one", str(i),
                            "--turn", str(turn), "--cases", args.cases])
        if r.returncode:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
