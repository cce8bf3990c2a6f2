"""SieveStreaming++ (Kazemi et al., ICML 2019) over the log-determinant
objective, one item at a time for every session at once.

A session keeps one summary per rung v of its threshold ladder ((1 +
eps)^i from the singleton value m to K m; the stack is as deep as the
deepest ladder of the pod, and a shallower one leaves its tail dead).
Per item, each live rung with n < K prices it:

    thr_v = (v / 2 - f(S_v)) / max(K - n_v, 1), accept when gain >= thr_v.

After an item some rung accepted, LB = max(LB, max_v f(S_v)), and every
rung with v <= LB dies.  The session's answer is its best live rung.
"""
from __future__ import annotations

import math

import torch

from .logdet import KINDS, Arith, ladder, rung_values

OUTPUT_KEYS = ("lds/feats", "lds/n", "lds/fval", "alive", "lb")


def hyper(specs, cfg, device) -> dict:
    """Per-session hyperparameters (S,); the rung stack is as deep as the
    ladder of the pod's own (K, eps)."""
    a = float(cfg["a"])
    rungs = ladder(int(cfg["K"]), float(cfg["pod"]["eps"]), a)[1]
    rows = []
    for sp in specs:
        ihi, nr, base = ladder(int(sp["K"]), float(sp["eps"]), a)
        if nr > rungs:
            raise ValueError(f"spec {sp} needs {nr} rungs of {rungs}")
        rows.append((int(sp["K"]), ihi, nr, base,
                     1.0 / (2.0 * float(sp["lengthscale"]) ** 2),
                     KINDS[sp["kernel_kind"]]))
    cols = list(zip(*rows))

    def t(v, dt):
        return torch.tensor(v, dtype=dt, device=device)

    hp = {"K": t(cols[0], torch.int64), "ihi": t(cols[1], torch.int64),
          "nr": t(cols[2], torch.int64), "base": t(cols[3], torch.float64),
          "inv2l2": t(cols[4], torch.float64),
          "kind": t(cols[5], torch.int64), "I": rungs}
    return hp


def _values(hp, dt):
    r = torch.arange(hp["I"], device=hp["K"].device)
    return rung_values(hp["base"][:, None], hp["ihi"][:, None], r[None, :],
                       dt)


def run(items, counts, hp, *, a: float, K_max: int, precision="float64",
        start=None, perturb=None) -> dict:
    """Every session's chunk items (S, C, d) through SieveStreaming++, from
    empty stacks or from ``start`` (``OUTPUT_KEYS`` tensors: each rung's
    rows and n, the live mask and LB; factors and f(S_v) are worked out
    again from the rows).

    Returns each rung's accepted chunk positions (``pos`` (S, I, K), -1
    for none or a row kept from ``start``), n, fval, alive, lb; the
    margin of each decision, per (session, item, rung) and NaN where
    none: ``amargin`` of each price, |gain - thr| / max(|thr|, 1), and
    ``kmargin`` of each live rung's test after an accept, |v - LB| /
    max(v, 1); ``killed_at`` (S, I), the item at which a rung died (-1
    where it did not); and the priced (rung, item) pairs' summary sizes
    summed for the work count.

    ``perturb(gain, n, K) -> gain``, where given, plants a fault in the
    gains (for the comparison's own checks; the benchmark never sets
    it)."""
    ar = Arith(precision)
    dt, dev = ar.dtype, items.device
    S, C, d = items.shape
    I = hp["I"]
    X = items.to(dt)
    counts = torch.as_tensor(counts, device=dev).long()
    rr = torch.arange(I, device=dev)
    v = _values(hp, dt)  # (S, I)
    feats = torch.zeros((S, I, K_max, d), dtype=dt, device=dev)
    L = torch.eye(K_max, dtype=dt, device=dev).repeat(S, I, 1, 1)
    n = torch.zeros((S, I), dtype=torch.int64, device=dev)
    fval = torch.zeros((S, I), dtype=dt, device=dev)
    alive = rr[None, :] < hp["nr"][:, None]
    lb = torch.zeros(S, dtype=dt, device=dev)
    if start is not None:
        n = start["lds/n"].to(dev).long().clone()
        alive = start["alive"].to(dev).clone()
        lb = start["lb"].to(dev).to(dt).clone()
        if "ref/L" in start:  # the reference's own state goes on
            feats, L, fval = (start[k].clone() for k in
                              ("ref/feats", "ref/L", "ref/fval"))
        else:
            feats, L, fval = _refactor(ar, start["lds/feats"].to(dev), n,
                                       hp, a)
    n0 = n.clone()
    pos = torch.full((S, I, K_max), -1, dtype=torch.int64, device=dev)
    amargin = torch.full((S, C, I), math.nan, dtype=torch.float32,
                         device=dev)
    kmargin = torch.full_like(amargin, math.nan)
    killed_at = torch.full((S, I), -1, dtype=torch.int64, device=dev)
    priced = torch.zeros((), dtype=torch.float64, device=dev)
    priced_n = torch.zeros((), dtype=torch.float64, device=dev)
    priced_n2 = torch.zeros((), dtype=torch.float64, device=dev)
    kidx = torch.arange(K_max, device=dev)
    kcap = hp["K"][:, None]
    inv2l2, kind = hp["inv2l2"].to(dt), hp["kind"]
    for p in range(int(counts.max()) if S else 0):
        valid = (p < counts)[:, None]
        e_s, e_r = torch.nonzero(valid & alive & (n < kcap), as_tuple=True)
        if e_s.numel() == 0:
            if not bool((alive & (n < kcap)).any()):
                break  # nothing can price any more: nothing changes
            continue
        ne = n[e_s, e_r]
        x = X[e_s, p]
        live = (kidx[None, :] < ne[:, None]).to(dt)
        kx = ar.kernel(x, feats[e_s, e_r], inv2l2[e_s], kind[e_s])
        c, res, gain = ar.gain(L[e_s, e_r], kx, live, a)
        if perturb is not None:
            gain = perturb(gain, ne, kcap[e_s, 0])
        thr = ((v[e_s, e_r] / 2.0 - fval[e_s, e_r])
               / torch.clamp_min(kcap[e_s, 0] - ne, 1).to(dt))
        acc = gain >= thr
        amargin[e_s, p, e_r] = ((gain - thr).abs()
                                / torch.clamp_min(thr.abs(), 1.0)).float()
        nd = ne.double()
        priced += e_s.numel()
        priced_n += nd.sum()
        priced_n2 += (nd * nd).sum()
        if bool(acc.any()):
            s, r, m = e_s[acc], e_r[acc], ne[acc]
            feats[s, r, m] = X[s, p]
            L[s, r, m] = c[acc] + torch.sqrt(res[acc])[:, None] * (
                kidx[None, :] == m[:, None]).to(dt)
            pos[s, r, m] = p
            fval[s, r] += gain[acc]
            n[s, r] += 1
            event = torch.zeros(S, dtype=torch.bool, device=dev)
            event[s] = True
            lb = torch.where(event, torch.maximum(lb, fval.amax(-1)), lb)
            relv = ((v - lb[:, None]).abs()
                    / torch.clamp_min(v.abs(), 1.0)).float()
            tested = alive & event[:, None]
            kmargin[:, p] = torch.where(tested, relv, kmargin[:, p])
            died = tested & ~(v > lb[:, None])
            killed_at = torch.where(died, p, killed_at)
            alive = alive & ~died
    return {"feats": feats, "L": L, "pos": pos, "n": n, "fval": fval,
            "alive": alive, "lb": lb, "amargin": amargin,
            "kmargin": kmargin, "killed_at": killed_at, "n0": n0,
            "priced": float(priced), "priced_n": float(priced_n),
            "priced_n2": float(priced_n2), "counts": counts,
            "start_rows": None if start is None else start["lds/feats"]}


def _refactor(ar, rows, n, hp, a):
    S, I, K, d = rows.shape
    dt = ar.dtype
    kidx = torch.arange(K, device=rows.device)
    live = kidx < n[..., None]
    feats = rows.to(dt) * live[..., None]
    inv2l2 = hp["inv2l2"].to(dt)[:, None]
    kind = hp["kind"][:, None]
    Km = torch.stack([ar.kernel(feats[:, :, i], feats, inv2l2, kind)
                      for i in range(K)], dim=2)
    m2 = live[..., :, None] & live[..., None, :]
    eye = torch.eye(K, dtype=dt, device=rows.device)
    L = torch.linalg.cholesky(torch.where(m2, eye + a * Km, eye))
    fval = torch.where(live, torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                       0.0).sum(-1)
    return feats, L, fval


def compare(out, res, items, tie: float) -> dict:
    """Judge the program's rung stacks ``out`` against the reference's.

    A session any of whose rungs differs in rows, n or liveness is followed
    to the first decision at which it parts from the reference: over its
    rungs, the earliest chunk position where a rung's rows part (that
    rung's price and kill test there), where the reference killed a rung
    the program kept, or where the reference's LB came within ``tie`` of
    a rung the program killed.  It is a near tie, and not compared
    further, where the reference's margin at that one decision is within
    ``tie`` (of rungs parting at the same item, the least); else it has
    ``parted``.  A row that is no item of its chunk, a kept row changed, a
    rung revived, or a rung killed where no decision of the reference came
    within ``tie`` with no earlier decision to follow from, part
    outright.  ``fval_err`` is the largest |f - f_ref| / max(|f_ref|, 1)
    over every rung and LB of the sessions that did not part; ``margins``
    the margin of each parting decision."""
    dev = res["n"].device
    feats = out["lds/feats"]
    n = out["lds/n"].long().to(dev)
    alive = out["alive"].to(dev)
    S, I, K, d = feats.shape
    ref_rows = _rows_at(items, res["pos"], res["start_rows"])
    kidx = torch.arange(K, device=dev)
    both = kidx < torch.minimum(n, res["n"])[..., None]
    rows_same = ((feats.to(items.dtype) == ref_rows).all(-1)
                 | ~both).all(-1) & (n == res["n"])
    rung_same = rows_same & (alive == res["alive"])
    same = rung_same.all(-1)
    parted, ties, margins = 0, 0, []
    for s in torch.nonzero(~same).flatten().tolist():
        m = _parting_margin(s, feats[s], n[s], alive[s], rows_same[s],
                            rung_same[s], items[s], res, tie)
        margins.append(m)
        if m <= tie:
            ties += 1
        else:
            parted += 1
    fp = out["lds/fval"].double().to(dev)
    fr = res["fval"].double()
    err = (fp - fr).abs() / torch.clamp_min(fr.abs(), 1.0)
    lbe = ((out["lb"].double().to(dev) - res["lb"].double()).abs()
           / torch.clamp_min(res["lb"].double().abs(), 1.0))
    err = torch.maximum(err.amax(-1), lbe)
    fval_err = float(err[same].max()) if bool(same.any()) else 0.0
    return {"parted": parted, "fval_err": fval_err, "ties": ties,
            "margins": margins}


def _parting_margin(s, feats, n, alive, rows_same, rung_same, chunk, res,
                    tie) -> float:
    """The reference's margin at session s's first parting decision (inf
    where none can be named)."""
    first = []  # (chunk position, margin) of each rung's first parting
    for r in torch.nonzero(~rung_same).flatten().tolist():
        if not bool(rows_same[r]):
            p = _first_part(feats[r], int(n[r]), chunk, res, s, r)
            if p < 0:
                return math.inf
            first.append((p, _nanmin(res["amargin"][s, p, r],
                                     res["kmargin"][s, p, r])))
        if bool(alive[r]) == bool(res["alive"][s, r]):
            continue
        if bool(alive[r]):  # the reference killed it, the program not
            p = int(res["killed_at"][s, r])
            if p < 0:
                return math.inf
            first.append((p, _nanmin(res["kmargin"][s, p, r])))
        else:  # the program killed it: where did the reference come near?
            near = torch.nonzero(res["kmargin"][s, :, r] <= tie).flatten()
            if near.numel():
                p = int(near[0])
                first.append((p, float(res["kmargin"][s, p, r])))
    if not first:  # only kills that no decision of the reference explains
        return math.inf
    p0 = min(p for p, _ in first)
    return min(m for p, m in first if p == p0)


def _nanmin(*xs) -> float:
    vals = [float(x) for x in xs if not math.isnan(float(x))]
    return min(vals) if vals else math.inf


def _rows_at(items, pos, start_rows):
    S, I, K = pos.shape
    d = items.shape[-1]
    idx = torch.clamp_min(pos, 0).reshape(S, I * K)
    rows = torch.gather(items, 1, idx[..., None].expand(-1, -1, d))
    rows = rows.reshape(S, I, K, d)
    rows = torch.where((pos >= 0)[..., None], rows, 0.0)
    if start_rows is not None:
        rows = torch.where((pos < 0)[..., None],
                           start_rows.to(rows.device, rows.dtype), rows)
    return rows


def _first_part(prog_rows, n_prog, chunk, res, s, r) -> int:
    """The chunk position of the first decision at which rung r of session
    s parts: the earlier of the two items that the first differing row
    holds on either side; -1 where none can be named (a row that is no
    item of the chunk, a kept row changed)."""
    pos_ref = res["pos"][s, r].tolist()
    n_ref, n0 = int(res["n"][s, r]), int(res["n0"][s, r])
    start = res["start_rows"]
    for k in range(max(n_prog, n_ref)):
        row = prog_rows[k].to(chunk.dtype) if k < n_prog else None
        if k < n0:  # a row the ingest started from: kept on both sides
            if row is None or not torch.equal(
                    start[s, r, k].to(chunk.device, chunk.dtype), row):
                return -1
            continue
        p_ref = pos_ref[k] if k < n_ref else None
        p_prog = None
        if row is not None:
            hit = torch.nonzero((chunk == row).all(-1)).flatten()
            if hit.numel() == 0:
                return -1
            p_prog = int(hit[0])
        if p_ref != p_prog:
            return min(x for x in (p_ref, p_prog) if x is not None)
    return -1


def full(out, hp) -> int:
    """Sessions none of whose live rungs can accept (each full or dead)."""
    n = out["lds/n"].long().to(hp["K"].device)
    open_ = out["alive"].to(n.device) & (n < hp["K"][:, None])
    return int((~open_.any(-1)).sum())


def fresh(out, hp) -> int:
    """Sessions of a re-armed state that are not empty stacks with the
    ladder's rungs live and LB 0."""
    dev = out["lds/n"].device
    rr = torch.arange(hp["I"], device=dev)
    valid = rr[None, :] < hp["nr"].to(dev)[:, None]
    bad = ((out["lds/n"] != 0).any(-1) | (out["lds/fval"] != 0).any(-1)
           | (out["alive"] != valid).any(-1) | (out["lb"] != 0))
    return int(bad.sum())


def work(res, d: int) -> dict:
    """The least work of the gain pass over one ingest (FLOP, bytes): each
    (item, live rung) decided priced once at the rung's size n (Gram row
    2 d n, kernel values 10 n, whitening n (n + 1)); one read of each
    item, of each rung's rows and factor triangle as they end, one write
    of each gain."""
    flops = ((2 * d + 11) * res["priced_n"] + res["priced_n2"])
    n1 = res["n"].double()
    nbytes = 4 * (float(res["counts"].sum()) * d
                  + float((n1 * d + n1 * (n1 + 1) / 2).sum())
                  + res["priced"])
    return {"gain_flops": float(flops), "gain_bytes": float(nbytes)}


def as_output(res, items) -> dict:
    """The reference's result in the program's ``OUTPUT_KEYS`` form (for
    a control put in the program's place)."""
    return {"lds/feats": _rows_at(items, res["pos"], res["start_rows"]),
            "lds/n": res["n"], "lds/fval": res["fval"],
            "alive": res["alive"], "lb": res["lb"],
            "ref/feats": res["feats"], "ref/L": res["L"],
            "ref/fval": res["fval"]}
