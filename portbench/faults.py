"""Faults planted under the timed path, for the checks of the comparison
that decides ``correct``: each must come out not correct.

    python3 portbench/faults.py --workload <cell> --fault frozen \
        --seeds 1,2,3 --seconds 5

runs the cell on the card at its own size with the fault planted and
prints one JSON line a seed: ``correct``, ``failed`` and the numbers
compared beside their limits.  The benchmark's own runs never plant one.

- ``frozen``: a step that returns its state unchanged;
- ``half``: half of the batch left out (tagged with no session);
- ``altered``: one answer altered where it is produced (the last f).
"""
from __future__ import annotations

import argparse
import io
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
KINDS = ("frozen", "half", "altered")


class Fault:
    """Delegates to the program, with one fault planted."""

    def __init__(self, prog, kind):
        if kind not in KINDS:
            raise ValueError(f"unknown fault {kind!r}")
        self.prog, self.kind = prog, kind

    def __getattr__(self, name):
        return getattr(self.prog, name)

    def route(self, sids, X):
        if self.kind == "half":
            keep = torch.arange(sids.numel(), device=sids.device) % 2 == 0
            sids = torch.where(keep, sids, -1)
        return self.prog.route(sids, X)

    def ingest_routed(self, routed):
        if self.kind == "frozen":
            from repro_torch.tree import copy_into, tree_map
            before = tree_map(lambda t: t.clone(), self.prog.state.algo)
            info = self.prog.ingest_routed(routed)
            copy_into(self.prog.state.algo, before)
            return info
        info = self.prog.ingest_routed(routed)
        if self.kind == "altered":
            leaves = self.prog._leaves(self.prog.state.algo)
            fval = next(v for k, v in leaves.items()
                        if k in ("ld/fval", "lds/fval"))
            fval.view(-1)[-1] += 1e-3 * (1.0 + fval.view(-1)[-1].abs())
        return info


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=KINDS)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("faults: no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import harness

    for s in args.seeds.split(","):
        out = harness.run(ROOT, args.workload, int(s), args.seconds, False,
                          log=io.StringIO(),
                          wrap=lambda p: Fault(p, args.fault))
        print(json.dumps({"workload": args.workload, "fault": args.fault,
                          "seed": int(s), "correct": out["correct"],
                          "attempted": out["attempted"],
                          "failed": out["failed"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
