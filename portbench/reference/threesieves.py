"""ThreeSieves (Buschjaeger et al., arXiv:2010.10059, Algorithm 1) over
the log-determinant objective, one item at a time for every session at
once.

Per item of a session with summary S (n rows, budget K), rung j of its
threshold ladder and counter t of rejections at that rung:

    gain = f(S + x) - f(S)            (from L, the Cholesky factor)
    thr  = (v_j / 2 - f(S)) / max(K - n, 1),  v_j = (1 + eps)^(ihi - j)
    accept when n < K and gain >= thr: append x, t = 0
    else t += 1, and after T rejections in a row j += 1 (to the last rung)
             and t = 0.

A full summary prices nothing; its items still count as rejections.
"""
from __future__ import annotations

import math

import torch

from .logdet import KINDS, Arith, ladder, rung_values

OUTPUT_KEYS = ("ld/feats", "ld/n", "ld/fval", "j", "t")


def hyper(specs, cfg, device) -> dict:
    """Per-session hyperparameters (S,) from the session specs."""
    a = float(cfg["a"])
    rows = []
    for sp in specs:
        ihi, nr, base = ladder(int(sp["K"]), float(sp["eps"]), a)
        rows.append((int(sp["K"]), int(sp["T"]), ihi, nr, base,
                     1.0 / (2.0 * float(sp["lengthscale"]) ** 2),
                     KINDS[sp["kernel_kind"]]))
    cols = list(zip(*rows))

    def t(v, dt):
        return torch.tensor(v, dtype=dt, device=device)

    return {"K": t(cols[0], torch.int64), "T": t(cols[1], torch.int64),
            "ihi": t(cols[2], torch.int64), "nr": t(cols[3], torch.int64),
            "base": t(cols[4], torch.float64),
            "inv2l2": t(cols[5], torch.float64),
            "kind": t(cols[6], torch.int64)}


def run(items, counts, hp, *, a: float, K_max: int, precision="float64",
        start=None, perturb=None) -> dict:
    """Every session's chunk items (S, C, d) through ThreeSieves, each
    from an empty summary, or from ``start`` (a dict of ``OUTPUT_KEYS``
    tensors of a state to go on from: its rows, n, j and t; the factor
    and f(S) are worked out again from the rows).

    Returns the summaries (``pos``: chunk position of each accepted row,
    -1 for rows kept from ``start``), n, fval, j, t, and per item the
    decision margin |gain - thr| / max(|thr|, 1) (NaN where nothing was
    priced) and the summary size it was priced at (-1 where not).

    ``perturb(gain, n, K) -> gain``, where given, plants a fault in the
    gains (for the comparison's own checks; the benchmark never sets
    it)."""
    ar = Arith(precision)
    dt, dev = ar.dtype, items.device
    S, C, d = items.shape
    X = items.to(dt)
    counts = torch.as_tensor(counts, device=dev).long()
    feats = torch.zeros((S, K_max, d), dtype=dt, device=dev)
    L = torch.eye(K_max, dtype=dt, device=dev).repeat(S, 1, 1)
    n = torch.zeros(S, dtype=torch.int64, device=dev)
    fval = torch.zeros(S, dtype=dt, device=dev)
    j = torch.zeros(S, dtype=torch.int64, device=dev)
    t = torch.zeros(S, dtype=torch.int64, device=dev)
    pos = torch.full((S, K_max), -1, dtype=torch.int64, device=dev)
    if start is not None:
        n = start["ld/n"].to(dev).long().clone()
        j = start["j"].to(dev).long().clone()
        t = start["t"].to(dev).long().clone()
        if "ref/L" in start:  # the reference's own state goes on
            feats, L, fval = (start[k].clone() for k in
                              ("ref/feats", "ref/L", "ref/fval"))
        else:
            feats, L, fval = refactor(ar, start["ld/feats"].to(dev), n, hp,
                                      a)
    margin = torch.full((S, C), math.nan, dtype=torch.float64, device=dev)
    priced_at = torch.full((S, C), -1, dtype=torch.int64, device=dev)
    rows = torch.arange(S, device=dev)
    kidx = torch.arange(K_max, device=dev)
    inv2l2, kind = hp["inv2l2"].to(dt), hp["kind"]
    for p in range(int(counts.max()) if S else 0):
        valid = p < counts
        priced = valid & (n < hp["K"])
        if not bool(priced.any()):
            break  # every session left is full: counters only, below
        x = X[:, p]
        live = (kidx[None, :] < n[:, None]).to(dt)
        kx = ar.kernel(x, feats, inv2l2, kind)
        c, res, gain = ar.gain(L, kx, live, a)
        if perturb is not None:
            gain = perturb(gain, n, hp["K"])
        jc = torch.minimum(j, hp["nr"] - 1)
        v = rung_values(hp["base"], hp["ihi"], jc, dt)
        thr = (v / 2.0 - fval) / torch.clamp_min(hp["K"] - n, 1).to(dt)
        acc = priced & (gain >= thr)
        rel = ((gain - thr).abs() / torch.clamp_min(thr.abs(), 1.0))
        margin[:, p] = torch.where(priced, rel.double(), math.nan)
        priced_at[:, p] = torch.where(priced, n, -1)
        if bool(acc.any()):
            s, m = rows[acc], n[acc]
            feats[s, m] = x[s]
            row = c[s] + torch.sqrt(res[s])[:, None] * (
                kidx[None, :] == m[:, None]).to(dt)
            L[s, m] = row
            pos[s, m] = p
            fval = torch.where(acc, fval + gain, fval)
            n = n + acc.long()
        rej = valid & ~acc
        t = torch.where(acc, 0, torch.where(rej, t + 1, t))
        lower = rej & (t >= hp["T"])
        j = torch.where(lower, torch.minimum(j + 1, hp["nr"] - 1), j)
        t = torch.where(lower, 0, t)
    else:
        p = int(counts.max()) if S else 0
    # the items past p are rejections of full summaries, in closed form:
    # r of them from counter t step the rung (t + r) // T times
    r = torch.clamp_min(counts - p, 0)
    j = torch.minimum(j + (t + r) // hp["T"], hp["nr"] - 1)
    t = (t + r) % hp["T"]
    n0 = (start["ld/n"].to(dev).long() if start is not None
          else torch.zeros(S, dtype=torch.int64, device=dev))
    return {"feats": feats, "L": L, "pos": pos, "n": n, "fval": fval,
            "j": j, "t": t, "margin": margin, "priced_at": priced_at, "n0": n0,
            "start_rows": None if start is None else start["ld/feats"]}


def refactor(ar, rows, n, hp, a):
    """(feats, L, f(S)) of explicit summaries: the factor of I + a K_SS
    on the live rows, identity past them."""
    S, K, d = rows.shape
    dt = ar.dtype
    feats = rows.to(dt) * (torch.arange(K, device=rows.device)[None, :, None]
                           < n[:, None, None])
    live = (torch.arange(K, device=rows.device)[None, :] < n[:, None])
    Km = _gram(ar, feats, hp)
    m2 = live[:, :, None] & live[:, None, :]
    eye = torch.eye(K, dtype=dt, device=rows.device)
    M = torch.where(m2, eye + a * Km, eye)
    L = torch.linalg.cholesky(M)
    fval = torch.where(live, torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                       0.0).sum(-1)
    return feats, L, fval


def _gram(ar, feats, hp):
    """K(S, S) of each session's rows (S, K, d) -> (S, K, K)."""
    S, K, _ = feats.shape
    dt = ar.dtype
    cols = [ar.kernel(feats[:, i], feats, hp["inv2l2"].to(dt), hp["kind"])
            for i in range(K)]
    return torch.stack(cols, dim=1)


def compare(out, res, items, tie: float) -> dict:
    """Judge the program's summaries ``out`` (``OUTPUT_KEYS``) against the
    reference's ``res`` over the same chunk ``items`` -> readings.

    A session whose rows, n, j or t differ is followed to the first
    decision at which it parts from the reference: the chunk position of
    the first row that differs.  It is a near tie, and not compared
    further, where the reference's margin at that one decision (|gain -
    thr| / max(|thr|, 1)) is within ``tie``; else it has ``parted``.
    Rows alike with j or t apart, a row that is no item of its chunk, or
    a kept row changed, part outright.  ``fval_err`` is the largest |f -
    f_ref| / max(|f_ref|, 1) over the sessions that did not part;
    ``margins`` the margin of each parting decision."""
    feats, n = out["ld/feats"], out["ld/n"].long().to(res["n"].device)
    S, K, d = feats.shape
    fp = out["ld/fval"].double().to(res["n"].device)
    ref_rows = _rows_at(items, res["pos"], res.get("start_rows"))
    kidx = torch.arange(K, device=n.device)
    both = kidx[None, :] < torch.minimum(n, res["n"])[:, None]
    same = ((feats.to(items.dtype) == ref_rows).all(-1) | ~both).all(-1)
    same &= (n == res["n"]) & (out["j"].long().to(n.device) == res["j"])
    same &= out["t"].long().to(n.device) == res["t"]
    parted, ties, margins = 0, 0, []
    for s in torch.nonzero(~same).flatten().tolist():
        p = _first_part(feats[s], int(n[s]), items[s], res, s)
        m = float(res["margin"][s, p]) if p >= 0 else math.inf
        m = math.inf if math.isnan(m) else m
        margins.append(m)
        if m <= tie:
            ties += 1
        else:
            parted += 1
    err = ((fp - res["fval"].double()).abs()
           / torch.clamp_min(res["fval"].double().abs(), 1.0))
    fval_err = float(err[same].max()) if bool(same.any()) else 0.0
    return {"parted": parted, "fval_err": fval_err, "ties": ties,
            "margins": margins}


def _rows_at(items, pos, start_rows=None):
    """The reference's summary rows, gathered from the chunk positions."""
    S, C, d = items.shape
    idx = torch.clamp_min(pos, 0)
    rows = torch.gather(items, 1, idx[:, :, None].expand(-1, -1, d))
    rows = torch.where((pos >= 0)[:, :, None], rows, 0.0)
    if start_rows is not None:
        rows = torch.where((pos < 0)[:, :, None], start_rows.to(rows.dtype),
                           rows)
    return rows


def _first_part(prog_rows, n_prog, chunk, res, s) -> int:
    """The chunk position of session s's first decision that parts from
    the reference: the earlier of the two items that the first differing
    row holds on either side; -1 where no decision can be named (rows
    alike, a row that is no item of its chunk, a kept row changed)."""
    pos_ref = res["pos"][s].tolist()
    n_ref, n0 = int(res["n"][s]), int(res["n0"][s])
    start = res["start_rows"]
    for k in range(max(n_prog, n_ref)):
        row = prog_rows[k].to(chunk.dtype) if k < n_prog else None
        if k < n0:  # a row the ingest started from: kept on both sides
            if row is None or not torch.equal(
                    start[s, k].to(chunk.device, chunk.dtype), row):
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
    """Sessions whose summary holds its budget K."""
    return int((out["ld/n"].long().to(hp["K"].device) >= hp["K"]).sum())


def fresh(out, hp) -> int:
    """Sessions of a re-armed state that are not empty at rung 0."""
    bad = ((out["ld/n"] != 0) | (out["ld/fval"] != 0) | (out["j"] != 0)
           | (out["t"] != 0))
    return int(bad.sum())


def work(res, d: int) -> dict:
    """The least work of one pod step (FLOP, bytes): every decided item
    priced once at the summary size it met (Gram row 2 d n, kernel values
    10 n, whitening against the triangular factor n (n + 1)); every append
    at row m (kernel row 2 d m, the new factor row and its inverse's, m (m
    + 1) each).  Bytes: one read of the decided items, of the live rows
    and factor a session starts from; one write of each new row's live
    part (the item d, two factor rows m + 1 each); 20 scalars a session in
    and out."""
    pa = res["priced_at"].double()
    on = pa >= 0
    flops = float(torch.where(on, 2 * d * pa + pa * (pa + 1) + 10 * pa,
                              0.0).sum())
    n0, n1 = res["n0"].double(), res["n"].double()
    # sum over m in [n0, n1) of 2 d m + 2 m (m + 1), in closed form
    s1 = (n1 * (n1 - 1) - n0 * (n0 - 1)) / 2
    s2 = ((n1 - 1) * n1 * (2 * n1 - 1) - (n0 - 1) * n0 * (2 * n0 - 1)) / 6
    flops += float((2 * d * s1 + 2 * (s2 + s1)).sum())
    nbytes = 4 * float(on.sum() * d + (n0 * d + n0 * (n0 + 1) / 2).sum()
                       + ((n1 - n0) * d + 2 * (s1 + (n1 - n0))).sum()
                       + 20 * n0.numel())
    return {"pod_flops": flops, "pod_bytes": nbytes}


def as_output(res, items) -> dict:
    """The reference's result in the program's ``OUTPUT_KEYS`` form (for
    a control put in the program's place)."""
    return {"ld/feats": _rows_at(items, res["pos"], res["start_rows"]),
            "ld/n": res["n"], "ld/fval": res["fval"], "j": res["j"],
            "t": res["t"], "ref/feats": res["feats"], "ref/L": res["L"],
            "ref/fval": res["fval"]}
