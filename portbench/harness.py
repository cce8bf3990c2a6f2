"""One run of one cell: set-up, the measured window, the trace, and the
check of what the window produced against the plain reference.

The window is a closed loop with two ingests in flight: ingest i + 1 is
handed to the pod once ingest i - 1 has completed (the pipeline's double
buffering; an upstream that blocks on the pod).  Each ingest is
``route`` then ``ingest_routed`` (``SummarizerPod.ingest``'s two halves),
then, where the traffic says so, ``reset_slots`` of every live session.
CUDA events mark each part.  The batches cycle through a pool made on
the device from the seed during set-up.

A sample of the window's ingests, drawn from the seed, keeps what the
program produced (its routed chunks and counts, and its summaries); once
the window has closed, the peak memory been read and the program freed,
the reference routes the same batches and runs the same sessions, and
the two are compared.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import random
import sys
import time
from pathlib import Path

import torch

from . import peaks, sessions, trace, traffic
from .reference import routing

TRACE_S = 2.0  # seconds of the window the profiler records in a traced run
WARM = 2  # set-up ingests before the traffic's fill
TRACE_CHAIN = 16  # the most traced ingests in a cell never re-armed
SAMPLES = 8  # ingests of the window whose output is compared
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Cell:
    """A workload of ``BENCHMARK.json`` and the files it names."""

    def __init__(self, root: Path, name: str):
        self.root = Path(root)
        bench = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.bench, self.name, self.cell = bench, name, cells[name]
        conf = {c["name"]: c for c in bench["configs"]}[self.cell["config"]]
        self.cfg = json.loads((self.root / conf["file"]).read_text())
        self.dir = self.root / bench["paths"][0]
        self.traffic = json.loads(
            (self.dir / "traffic" / f"{self.cell['traffic']}.json")
            .read_text())

    def metrics(self, kind: str) -> list:
        """The cell's metrics of ``end_to_end`` or ``per_layer``."""
        return [m for m in self.bench[kind]
                if "workloads" not in m or self.name in m["workloads"]]

    def reader(self, metric: str):
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def reference(self):
        return importlib.import_module(
            f"{__package__}.reference.{self.cfg['reference']}")


class _HostStamp:
    """A CUDA event's interface for a run on the CPU (tests)."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


def _stamp(device):
    if torch.device(device).type == "cuda":
        return torch.cuda.Event(enable_timing=True)
    return _HostStamp()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(root, workload: str, seed: int, seconds: float, traced: bool, *,
        device="cuda", t_start=None, wrap=None, log=sys.stderr) -> dict:
    """One run -> the result line's object (its ``checks`` last).

    ``wrap``, for tests, takes the built program and returns the object
    the window drives (a program with a fault planted in it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(root, workload)
    cfg, tr = cell.cfg, cell.traffic
    ref = cell.reference()
    specs = sessions.specs(cfg)
    keys = ref.OUTPUT_KEYS
    rearm = bool(tr["rearm"])

    from .program import Program

    stages = {"imports": time.perf_counter() - t_start}
    prog = Program(cfg, specs, device)
    prog = wrap(prog) if wrap else prog
    _sync(device)
    stages["admit"] = time.perf_counter() - t_start
    table = traffic.session_ids(cfg)
    pool = traffic.make_pool(cfg, tr, seed, device)
    _sync(device)
    stages["pool"] = time.perf_counter() - t_start
    N = int(cfg["items_per_ingest"])
    P = len(pool)

    def ingest(q, keep=None, mark=None, host=None):
        sids, X = pool[q]
        if keep is not None and "pre" in keep:
            out = prog.outputs(keys)
            for k in keys:
                keep["pre"][k].copy_(out[k])
        if mark:
            mark[0].record()
        routed = prog.route(sids, X)
        if mark:
            mark[1].record()
        h0 = time.perf_counter()
        prog.ingest_routed(routed)
        h1 = time.perf_counter()
        if mark:
            mark[2].record()
        if host is not None:
            host.append(h1 - h0)
        if keep is not None:
            for buf, x in zip(keep["routed"], routed):
                buf.copy_(x)
            out = prog.outputs(keys)
            for k in keys:
                keep["out"][k].copy_(out[k])
        if rearm:
            prog.rearm()
        if mark:
            mark[3].record()

    # set-up ingests: two that warm up, the traffic's fill, and two more
    # that time an ingest for the sample and the traced part
    seq = [q % P for q in range(WARM + int(tr.get("fill", 0)) + 2)]
    for q in seq[:-2]:
        ingest(q)
    _sync(device)
    w0 = time.perf_counter()
    for q in seq[-2:]:
        ingest(q)
    _sync(device)
    est_s = max((time.perf_counter() - w0) / 2, 1e-4)
    stages["warm_up"] = time.perf_counter() - t_start
    start_out = None if rearm else {
        k: v.clone() for k, v in prog.outputs(keys).items()}
    rng = random.Random(int(seed))
    est_n = max(2, int(0.9 * seconds / est_s))
    sampled = sorted({0} | {rng.randrange(1, est_n)
                             for _ in range(SAMPLES - 1)})
    keeps = {i: _buffers(pool[0], cfg, prog.outputs(keys), pre=not rearm)
             for i in sampled}
    n_trace = max(2, math.ceil(TRACE_S / est_s)) if traced else 0
    if not rearm:  # the reference follows each traced ingest in turn
        n_trace = min(n_trace, TRACE_CHAIN)
    launches0 = prog.launches()
    _sync(device)

    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        # on the card the device's activity alone: recording every host
        # operation as well slows the host enough to starve the device
        prof = profile(activities=[
            ProfilerActivity.CUDA if torch.device(device).type == "cuda"
            else ProfilerActivity.CPU])
    marks, host, i = [], [], 0
    first = _stamp(device)
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    first.record()
    if prof:
        prof.start()
    trace_info, launches_t = None, None
    while True:
        if i >= 2:
            marks[i - 2][3].synchronize()
        if prof and i == n_trace:
            _sync(device)
            prof.stop()
            launches_t = prog.launches()
            trace_info = trace.read(prof)
            prof = None
        if time.perf_counter() - t0 >= seconds:
            break
        mark = [_stamp(device) for _ in range(4)]
        marks.append(mark)
        ingest(i % P, keeps.get(i), mark, host)
        i += 1
    _sync(device)
    window_s = time.perf_counter() - t0
    if prof:  # a window shorter than the traced part
        prof.stop()
        launches_t = prog.launches()
        trace_info = trace.read(prof)
    n = i
    launches = {k: v - launches0[k] for k, v in prog.launches().items()}
    lat = [(first if k < 2 else marks[k - 2][3]).elapsed_time(marks[k][3])
           for k in range(n)]
    route_ms = [m[0].elapsed_time(m[1]) for m in marks]
    step_ms = [m[1].elapsed_time(m[2]) for m in marks]
    mem = (torch.cuda.max_memory_allocated()
           if torch.device(device).type == "cuda" else 0)

    t_check = time.perf_counter()
    # ---- the check, after the window: the program is freed first
    sid_table = prog.sid_table()
    resets = prog.resets().clone()
    rearmed = {k: v.clone() for k, v in prog.outputs(keys).items()}
    dropped = prog.dropped()  # set-up's and the window's, from the ledgers
    del prog
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    hp = ref.hyper(specs, cfg, device)
    limits = cfg["limits"]
    kw = dict(a=float(cfg["a"]), K_max=int(cfg["K"]))
    done = [k for k in sampled if k < n]
    routed_ref, refs = {}, {}

    def ref_routed(q):
        if q not in routed_ref:
            sids, X = pool[q]
            routed_ref[q] = routing.route(sids, X, table,
                                          int(cfg["chunk_per_session"]))
        return routed_ref[q]

    def ref_fresh(q):  # tumbling: a pool batch's result from empty
        if q not in refs:
            chunks, counts = ref_routed(q)[:2]
            refs[q] = ref.run(chunks, counts.to(device), hp, **kw)
        return refs[q]

    verdicts = []
    if not rearm:
        # the start: the reference over the set-up's items from empty, as
        # one stream a session, against the state the window began from
        items, counts = stream([ref_routed(q)[:2] for q in seq])
        res = ref.run(items, counts.to(device), hp, **kw)
        verdicts.append((0, ref.compare(start_out, res, items,
                                        cfg["tie_margin"])))
    for k in done:
        r_routed = ref_routed(k % P)
        if rearm:
            res = ref_fresh(k % P)
        else:  # from the program's own state before the sampled ingest
            res = ref.run(r_routed[0], r_routed[1].to(device), hp,
                          start=keeps[k]["pre"], **kw)
        e = routing.errors(keeps[k]["routed"], r_routed, sid_table, table)
        verdicts.append((e, ref.compare(keeps[k]["out"], res, r_routed[0],
                                        cfg["tie_margin"])))
    checks, wrong, info = judge(verdicts, limits, cfg["tie_margin"])
    want_resets = n + len(seq) if rearm else 0
    rearm_err = int((resets.long().cpu() != want_resets).sum())
    if rearm:
        rearm_err += ref.fresh(rearmed, hp)
    checks["dropped_items"] = {"value": dropped, "limit": 0}
    checks["rearm_errors"] = {"value": rearm_err, "limit": 0}
    correct = passed(checks)
    if start_out is not None:  # sessions whose summaries are full, and
        # the rows the window added (it replays its pool: PERF.md)
        nkey = next(k for k in keys if k.endswith("/n"))
        info["start_full_sessions"] = ref.full(start_out, hp)
        info["end_full_sessions"] = ref.full(rearmed, hp)
        info["window_accepts"] = int(rearmed[nkey].sum()
                                     - start_out[nkey].sum())
    info["check_s"] = time.perf_counter() - t_check
    info.update({f"setup_{k}_s": v for k, v in stages.items()})

    # ---- metrics
    ctx = {"cell": cell.name, "config": cfg, "traffic": tr, "ingests": n,
           "items": n * N, "window_s": window_s, "setup_s": setup_s,
           "latency_ms": lat, "route_ms": route_ms, "pod_step_ms": step_ms,
           "ingest_routed_s": host, "launches": launches, "peaks": peaks,
           "trace": None, "work": None}
    if trace_info is not None:
        nt = min(n_trace, n)
        work = {"route_bytes": nt * routing.least_bytes(
            N, int(cfg["d"]), len(table), int(cfg["chunk_per_session"]))}
        state = start_out
        for k in range(nt):
            q = k % P
            if rearm:
                res = ref_fresh(q)
            else:  # the reference goes on from its own state
                chunks, counts = ref_routed(q)[:2]
                res = ref.run(chunks, counts.to(device), hp, start=state,
                              **kw)
                state = ref.as_output(res, chunks)
            for key, v in ref.work(res, int(cfg["d"])).items():
                work[key] = work.get(key, 0.0) + v
        ctx["trace"] = dict(trace_info, ingests=nt, launches={
            key: v - launches0[key] for key, v in launches_t.items()})
        ctx["work"] = work
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cell.metrics(kind):
        v = cell.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda"
           else "cpu",
           "kind": (torch.cuda.get_device_name(0)
                    if torch.device(device).type == "cuda" else "cpu"),
           "count": int(cell.cell.get("chips", 1)),
           "memory_peak_bytes": int(mem)}
    out = {"correct": bool(correct), "attempted": n,
           # which ingest dropped is not recorded: with any drop, all failed
           "failed": n if dropped else int(wrong), "metrics": metrics,
           "device": dev}
    if trace_info is not None:
        dev["busy_s"] = trace_info["busy_s"]
        dev["window_s"] = trace_info["window_s"]
        out["breakdown"] = {"device_ops": trace_info["device_ops"],
                            "idle_gaps": trace_info["idle_gaps"]}
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in checks.items()}
    for k, v in info.items():
        print(f"info {k} {v}", file=log)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']} "
              f"{'at least' if c.get('at_least') else 'limit'} {c['limit']}",
              file=log)
    return out


def forbidden_loaded() -> list:
    """JAX, its relatives and the JAX package among the loaded modules,
    by whole top-level name (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def judge(verdicts, limits, tie) -> tuple:
    """(checks, wrong answers, info) of (routing errors, ``compare``
    readings) pairs: the numbers compared with their limits."""
    fval = max(c["fval_err"] for _, c in verdicts) if verdicts else 0.0
    checks = {
        "answers_compared": {"value": len(verdicts), "limit": 1,
                             "at_least": True},
        "route_errors": {"value": sum(e for e, _ in verdicts), "limit": 0},
        "parted_sessions": {"value": sum(c["parted"] for _, c in verdicts),
                            "limit": 0},
        "near_tie_sessions": {"value": sum(c["ties"] for _, c in verdicts),
                              "limit": limits["near_ties"]},
        "fval_err": {"value": fval, "limit": limits["fval_err"]},
    }
    wrong = sum(bool(e or c["parted"] or c["fval_err"] > limits["fval_err"])
                for e, c in verdicts)
    margins = [m for _, c in verdicts for m in c["margins"]]
    info = {"near_tie_margin_max": max((m for m in margins if m <= tie),
                                       default=None),
            "parted_margin_min": min((m for m in margins if m > tie),
                                     default=None)}
    return checks, wrong, info


def passed(checks) -> bool:
    return all((c["value"] >= c["limit"]) if c.get("at_least")
               else (c["value"] <= c["limit"]) for c in checks.values())


def stream(routed) -> tuple:
    """Chunks of consecutive ingests as one stream a session: (items (S,
    total, d), counts (S,))."""
    S, _, d = routed[0][0].shape
    rows = [torch.cat([c[s, :int(k[s])] for c, k in routed])
            for s in range(S)]
    counts = torch.tensor([r.shape[0] for r in rows])
    items = torch.zeros((S, int(counts.max()), d), dtype=rows[0].dtype,
                        device=rows[0].device)
    for s, r in enumerate(rows):
        items[s, :r.shape[0]] = r
    return items, counts


def _buffers(batch, cfg, outs, pre=False) -> dict:
    """Preallocated copies of one ingest's routed chunks and summaries
    (and, where ``pre``, of the summaries before it)."""
    sids, X = batch
    S, C = int(cfg["total_sessions"]), int(cfg["chunk_per_session"])
    dev = X.device
    i32 = dict(dtype=torch.int32, device=dev)
    return {"routed": (torch.empty((S, C, X.shape[1]), dtype=X.dtype,
                                   device=dev),
                       torch.empty(S, **i32), torch.empty((), **i32),
                       torch.empty(S, **i32)),
            "out": {k: torch.empty_like(v) for k, v in outs.items()},
            **({"pre": {k: torch.empty_like(v) for k, v in outs.items()}}
               if pre else {})}

