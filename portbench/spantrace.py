"""A traced run of one cell with the program's hot spans joined to the
device trace.

    python3 portbench/spantrace.py --workload <cell> --seed <n> \
        --seconds <s> [--hot 0|1] [--dump <file.jsonl>]

Runs ``harness.run`` with ``--trace 1`` as ``run.py`` does, with hot
tracing (``repro_torch.obs``) turned on right before the profiler starts
and off right after it stops (``--hot 0`` leaves it off: the same run
without spans, for the cost of tracing).  Prints the per-span table on
standard error (``info span.<path> ...``, ``spans.lines``) and, as the
last line of standard output, one JSON object: ``result`` (the harness's
result line), ``metrics`` (``spans.METRICS`` read from the join),
``idle_gaps`` (the gaps by span path), ``join`` (the clock and launch
checks), ``table`` (the per-span table) and ``traced`` (the traced
ingests' means of the harness's own ``route_ms`` and ``pod_step_ms``).
``--dump`` writes the span records as JSONL.

The harness itself runs unchanged: this script wraps the profiler class
it builds, ``trace.read`` and the metric readers, to see the profiler
and the window's context.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    import run  # noqa: F401  (the caches inside the checkout, sys.path)


@contextlib.contextmanager
def hooks(hot: bool):
    """Inside: the harness's profiler turns hot tracing on and off with
    itself, and what the join needs is kept in the yielded dict."""
    import torch.profiler

    from portbench import harness, trace
    from repro_torch import obs

    seen = {"records": [], "prof": None, "ctx": None}
    rec = obs.get_recorder()
    base = torch.profiler.profile

    class Profile(base):
        def start(self):
            if hot:
                rec.trace_hot(True)
            super().start()

        def stop(self):
            super().stop()
            if hot:
                seen["records"] = rec.trace_hot(False)
            seen["prof"] = self

    read, reader = trace.read, harness.Cell.reader

    def read_kept(prof):
        seen["prof"] = prof
        return read(prof)

    def reader_kept(cell, metric):
        f = reader(cell, metric)

        def kept(ctx):
            seen["ctx"] = ctx
            return f(ctx)
        return kept

    torch.profiler.profile = Profile
    trace.read = read_kept
    harness.Cell.reader = reader_kept
    try:
        yield seen
    finally:
        torch.profiler.profile = base
        trace.read = read
        harness.Cell.reader = reader
        if rec.hot:
            rec.trace_hot(False)


def traced(ctx) -> dict:
    """The traced ingests' means of the harness's own per-ingest times."""
    n = ctx["trace"]["ingests"] if ctx and ctx["trace"] else 0
    out = {}
    for key in ("route_ms", "pod_step_ms"):
        ms = ctx[key][:n] if n else []
        out[key] = sum(ms) / len(ms) if ms else None
    return out


def run_cell(root, workload, seed, seconds, *, hot=True, device="cuda",
             t_start=None, log=sys.stderr) -> dict:
    """One traced run with the join -> the script's JSON object."""
    from portbench import harness, spans

    with hooks(hot) as seen:
        result = harness.run(root, workload, seed, seconds, True,
                             device=device, t_start=t_start, log=log)
    ctx = dict(seen["ctx"] or {})
    out = {"result": result, "hot": hot, "traced": traced(ctx)}
    if seen["prof"] is None:
        return out
    joined = spans.join(spans.kineto_events(seen["prof"]), seen["records"])
    ctx["spans"] = joined
    for line in spans.lines(joined):
        print(line, file=log)
    out["metrics"] = {name: f(ctx) for name, f in spans.METRICS.items()}
    out["idle_gaps"] = joined["idle_gaps"]
    out["join"] = {k: joined[k] for k in (
        "idle_s", "raw_lead_us", "drift_us_per_s", "launch_lead_us",
        "leads_over_5us", "unlaunched_s", "device_ops")}
    out["table"] = joined["table"]
    out["records"] = len(seen["records"])
    out["dropped"] = sum(r["value"] for r in seen["records"]
                         if r.get("name") == "hot_spans_dropped")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--hot", type=int, choices=(0, 1), default=1)
    ap.add_argument("--dump", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("spantrace: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    out = run_cell(ROOT, args.workload, args.seed, args.seconds,
                   hot=bool(args.hot), t_start=T0)
    if args.dump:
        from repro_torch import obs

        obs.get_recorder().dump_jsonl(args.dump)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
