"""The control of the comparison that decides ``correct``: the reference
computed one precision below the configuration's float32 (TF32 inner
products, ``reference.logdet.Arith``) is put in the program's place and
judged like the program.  It must come out not correct.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--late 1e-3]

For each seed it makes the cell's batch pool, runs the reference and the
control over every batch at the cell's own size, and prints one JSON
line of the numbers compared beside their limits.  With ``--late r`` the
candidate is instead the float64 reference with a fault that parts
late: each gain off by the share r once a summary holds half its budget
(as a kernel that errs only past a tile of rows would).  The benchmark's
own runs never run either.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT)]


def late_fault(r: float):
    """Gains off by the share ``r`` once n >= K / 2."""
    import torch

    def perturb(gain, n, K):
        return torch.where(2 * n >= K, gain * (1.0 + r), gain)
    return perturb


def readings(root, workload, seed, precision="tf32", late=None,
             device="cuda") -> dict:
    """The control's numbers on one seed, at the cell's own size: in a
    tumbling cell each pool batch from empty; in a steady one the set-up
    stream, then each pool batch from the control's own state, judged
    from that state as the program's sampled ingests are.  With ``late``
    the candidate is the reference with ``late_fault(late)``."""
    from portbench import harness, sessions, traffic
    from portbench.reference import routing

    cell = harness.Cell(root, workload)
    cfg, tr, ref = cell.cfg, cell.traffic, cell.reference()
    hp = ref.hyper(sessions.specs(cfg), cfg, device)
    table = traffic.session_ids(cfg)
    tie = cfg["tie_margin"]
    kw = dict(a=float(cfg["a"]), K_max=int(cfg["K"]))
    cand = (dict(precision=precision) if late is None
            else dict(perturb=late_fault(late)))
    pool = [routing.route(sids, X, table, int(cfg["chunk_per_session"]))[:2]
            for sids, X in traffic.make_pool(cfg, tr, seed, device)]
    P = len(pool)
    verdicts = []
    if tr["rearm"]:
        for chunks, counts in pool:
            res = ref.run(chunks, counts.to(device), hp, **kw)
            ctl = ref.run(chunks, counts.to(device), hp, **cand, **kw)
            verdicts.append((0, ref.compare(ref.as_output(ctl, chunks), res,
                                            chunks, tie)))
    else:
        seq = [q % P for q in range(harness.WARM + int(tr.get("fill", 0))
                                    + 2)]
        items, counts = harness.stream([pool[q] for q in seq])
        res = ref.run(items, counts.to(device), hp, **kw)
        ctl = ref.run(items, counts.to(device), hp, **cand, **kw)
        state = ref.as_output(ctl, items)
        verdicts.append((0, ref.compare(state, res, items, tie)))
        for chunks, counts in pool:
            pre = {k: state[k] for k in ref.OUTPUT_KEYS}
            res = ref.run(chunks, counts.to(device), hp, start=pre, **kw)
            ctl = ref.run(chunks, counts.to(device), hp, start=state,
                          **cand, **kw)
            state = ref.as_output(ctl, chunks)
            verdicts.append((0, ref.compare(state, res, chunks, tie)))
    checks, _, info = harness.judge(verdicts, cfg["limits"], tie)
    return {"workload": workload, "seed": seed,
            "candidate": precision if late is None else f"late {late:g}",
            "correct": harness.passed(checks), **info,
            "checks": {k: {"value": c["value"], "limit": c["limit"]}
                       for k, c in checks.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--late", type=float, default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        out = readings(ROOT, args.workload, int(s), late=args.late)
        out["seconds"] = time.perf_counter() - t0
        out["device"] = torch.cuda.get_device_name(0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
