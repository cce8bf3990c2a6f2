"""The reference and the frozen work counts against hand counts."""
from __future__ import annotations

import math

import pytest
import torch

from portbench.reference import logdet, routing, sievestreampp, threesieves


def test_route_least_bytes_by_hand():
    # tags 4 N, items 4 N d, table 5 S, chunks 4 S C d, counts and
    # overflow 8 S, the unknown count 4
    assert routing.least_bytes(10, 4, 2, 8) == 40 + 160 + 10 + 256 + 16 + 4


def test_threesieves_work_by_hand():
    res = {"priced_at": torch.tensor([[0, 1, 1, -1]]),
           "n0": torch.tensor([0]), "n": torch.tensor([2])}
    w = threesieves.work(res, d=4)
    # priced at n = 0, 1, 1: 0 + 2 x (2 d + 2 + 10); appends at m = 0, 1:
    # 0 + (2 d + 4)
    assert w["pod_flops"] == 2 * (8 + 2 + 10) + (8 + 4)
    # 3 items read (d each), two rows written (d + 2 (m + 1) each), 20
    # scalars
    assert w["pod_bytes"] == 4 * (3 * 4 + (4 + 2) + (4 + 4) + 20)


def test_sievestreampp_work_by_hand():
    res = {"priced": 3.0, "priced_n": 3.0, "priced_n2": 5.0,
           "counts": torch.tensor([2]), "n": torch.tensor([[2, 1]])}
    w = sievestreampp.work(res, d=4)
    assert w["gain_flops"] == 0 + (8 + 2 + 10) + (16 + 6 + 20)
    assert w["gain_bytes"] == 4 * (2 * 4 + (8 + 3) + (4 + 1) + 3)


def test_routing_keeps_stream_order_and_counts_drops():
    sids = torch.tensor([7, 5, 7, 9, 7, -1, 5, 7])
    X = torch.arange(8.0)[:, None].repeat(1, 2)
    chunks, counts, unknown, overflow = routing.route(sids, X, [5, 7], 3)
    assert counts.tolist() == [2, 3] and overflow.tolist() == [0, 1]
    assert unknown == 1
    assert chunks[1, :, 0].tolist() == [0.0, 2.0, 4.0]
    assert chunks[0, :, 0].tolist() == [1.0, 6.0, 0.0]


def test_threesieves_orthogonal_items_by_hand():
    """Far-apart items each gain the singleton value 1/2 log(1 + a): the
    first K are taken, f = K / 2 log 2, and the rest are rejections that
    lower the rung every T."""
    K, T, C = 2, 2, 7
    items = (100.0 * torch.eye(8)[:C])[None].double()
    hp = threesieves.hyper([{"K": K, "T": T, "eps": 0.5,
                             "lengthscale": 1.0, "kernel_kind": "rbf"}],
                           {"a": 1.0}, "cpu")
    res = threesieves.run(items, torch.tensor([C]), hp, a=1.0, K_max=4)
    assert res["n"].tolist() == [2] and res["pos"][0, :2].tolist() == [0, 1]
    assert math.isclose(float(res["fval"][0]), math.log(2.0), rel_tol=1e-12)
    # five rejections at T = 2: two rung steps (down to the last rung),
    # one rejection left over
    assert res["j"].tolist() == [min(2, int(hp["nr"][0]) - 1)]
    assert res["t"].tolist() == [1]


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2.0 ** -12, 1.0 + 2.0 ** -10, 3.0])
    assert logdet.tf32_round(x).tolist() == [1.0, 1.0 + 2.0 ** -10, 3.0]


def _orthogonal_run(K=2, T=2, C=7):
    items = (100.0 * torch.eye(8)[:C])[None].double()
    hp = threesieves.hyper([{"K": K, "T": T, "eps": 0.5,
                             "lengthscale": 1.0, "kernel_kind": "rbf"}],
                           {"a": 1.0}, "cpu")
    res = threesieves.run(items, torch.tensor([C]), hp, a=1.0, K_max=4)
    return items, res


def test_threesieves_excuses_only_the_parting_decision():
    """A session that parts at item 1 is a near tie only by the margin of
    item 1's decision; an earlier near tie elsewhere excuses nothing."""
    items, res = _orthogonal_run()
    out = threesieves.as_output(res, items)
    out = {k: v.clone() for k, v in out.items()}
    out["ld/feats"][0, 1] = items[0, 2]  # took item 2 where ref took 1
    res["margin"][0, 0] = 1e-9  # a near tie before the parting
    res["margin"][0, 1] = 0.1
    r = threesieves.compare(out, res, items, tie=1e-6)
    assert (r["parted"], r["ties"]) == (1, 0)
    assert r["margins"] == [pytest.approx(0.1)]
    res["margin"][0, 1] = 1e-7  # the parting decision itself is a tie
    r = threesieves.compare(out, res, items, tie=1e-6)
    assert (r["parted"], r["ties"]) == (0, 1)


def test_threesieves_counters_apart_part_outright():
    items, res = _orthogonal_run()
    out = {k: v.clone() for k, v in threesieves.as_output(res, items).items()}
    res["margin"][0].fill_(1e-12)  # every decision a near tie
    out["t"] = out["t"] + 1
    r = threesieves.compare(out, res, items, tie=1e-6)
    assert (r["parted"], r["ties"]) == (1, 0)


def _sieve_run():
    gen = torch.Generator().manual_seed(5)
    items = torch.randn((1, 6, 4), generator=gen, dtype=torch.float64)
    cfg = {"a": 1.0, "K": 8, "pod": {"eps": 0.2}}
    hp = sievestreampp.hyper([{"K": 8, "eps": 0.2, "lengthscale": 1.0,
                               "kernel_kind": "rbf"}], cfg, "cpu")
    res = sievestreampp.run(items, torch.tensor([6]), hp, a=1.0, K_max=8)
    return items, res


def test_sievestreampp_kill_is_a_tie_only_near_the_reference_lb():
    """The program killed a rung the reference kept: a near tie only
    where the reference's LB came within the tie of the rung's value."""
    items, res = _sieve_run()
    live = torch.nonzero(res["alive"][0]).flatten().tolist()
    assert live
    r = live[-1]
    out = {k: v.clone()
           for k, v in sievestreampp.as_output(res, items).items()}
    out["alive"][0, r] = False
    res["kmargin"][0, :, r] = 0.5  # no decision came near
    res["amargin"][0].fill_(1e-12)  # every price a near tie
    c = sievestreampp.compare(out, res, items, tie=1e-6)
    assert (c["parted"], c["ties"]) == (1, 0)
    res["kmargin"][0, 3, r] = 1e-7
    c = sievestreampp.compare(out, res, items, tie=1e-6)
    assert (c["parted"], c["ties"]) == (0, 1)


def test_near_tie_count_is_limited():
    from portbench import harness

    reading = {"parted": 0, "fval_err": 0.0, "ties": 2, "margins": [0.0] * 2}
    limits = {"fval_err": 1e-6, "near_ties": 2}
    checks, wrong, _ = harness.judge([(0, reading)], limits, 1e-6)
    assert harness.passed(checks) and wrong == 0
    checks, _, _ = harness.judge([(0, reading), (0, reading)], limits, 1e-6)
    assert not harness.passed(checks)
