# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of the pod: routing, the tenant lifecycle, the pod step and the
state carried across packages, held against a JAX pod fed the same
tagged batches (JAX pod step: the ``jnp`` reference)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.spec import SessionSpec as JSpec  # noqa: E402
from repro.kernels.pod_step import pod_step_ref as jax_pod_step_ref  # noqa
from repro.serve.summarize import SummarizerPod as JPod  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.spec import SessionSpec as TSpec  # noqa: E402
from repro_torch.kernels.pod_step import pod_step, pod_step_ref  # noqa
from repro_torch.serve.summarize import PodState  # noqa: E402
from repro_torch.serve.summarize import SummarizerPod as TPod  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

from _torch_port import (assert_clear_margins, assert_leaves_match,  # noqa
                         assert_states_match, jax_algo, jax_leaves, stream,
                         torch_algo, torch_leaves)

K, D, S, C = 8, 5, 4, 12
SPECS = [dict(K=4, T=3, eps=0.3, lengthscale=0.8),
         dict(K=8, T=5, eps=0.1, lengthscale=1.2, kernel_kind="linear_norm"),
         dict(K=6, T=4, eps=0.2, lengthscale=1.0)]
SIDS = [10, 11, 12]


def pods():
    jp = JPod(algo=jax_algo(K=K, d=D, T=5, eps=0.2, lengthscale=1.0),
              sessions=S, chunk=C, podstep_backend="jnp")
    tp = TPod(algo=torch_algo(K=K, d=D, T=5, eps=0.2, lengthscale=1.0),
              sessions=S, chunk=C, device="cpu")
    return jp, tp


def admit_all(jp, tp, js, ts):
    for sid, sp in zip(SIDS, SPECS):
        js, jslot, jok = jp.admit(js, sid, spec=JSpec(d=D, **sp))
        ts, tslot, tok = tp.admit(ts, sid, spec=TSpec(d=D, **sp))
        assert (int(jslot), bool(jok)) == (int(tslot), bool(tok))
    return js, ts


def batch(seed, n=30, pool=(10, 11, 12, 99, -1)):
    rng = np.random.default_rng(seed)
    sids = rng.choice(pool, size=n).astype(np.int32)
    return sids, (0.5 * rng.standard_normal((n, D))).astype(np.float32)


def test_route_matches_jax():
    jp, tp = pods()
    js, ts = admit_all(jp, tp, jp.init(), tp.init())
    # session 10 gets more than C items: overflow; 99 unknown; -1 padding
    sids, X = batch(0, n=60, pool=(10, 10, 10, 11, 99, -1))
    jout = jp.route(js, jnp.asarray(sids), jnp.asarray(X))
    tout = tp.route(ts, torch.from_numpy(sids), torch.from_numpy(X))
    for name, a, b in zip(("chunks", "counts", "unknown", "overflow"),
                          jout, tout):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert int(tout[3].sum()) > 0 and int(tout[2]) > 0


def test_lifecycle_matches_jax():
    """admit (mixed specs) -> ingest x2 -> evict -> re-admit -> ingest ->
    drift reset -> ingest -> readout, compared leaf by leaf throughout."""
    jp, tp = pods()
    ingest = jax.jit(jp.ingest)
    js, ts = admit_all(jp, tp, jp.init(), tp.init())
    assert_states_match(js, ts, "admit")

    def feed(js, ts, seed):
        sids, X = batch(seed)
        js, jinfo = ingest(js, jnp.asarray(sids), jnp.asarray(X))
        ts, tinfo = tp.ingest(ts, torch.from_numpy(sids),
                              torch.from_numpy(X))
        for k in jinfo:
            np.testing.assert_array_equal(np.asarray(jinfo[k]),
                                          tinfo[k].numpy(), err_msg=k)
        assert_states_match(js, ts, f"ingest {seed}")
        return js, ts

    js, ts = feed(js, ts, 1)
    js, ts = feed(js, ts, 2)
    js, ts = jp.evict(js, 11), tp.evict(ts, 11)
    assert_states_match(js, ts, "evict")
    js, _, _ = jp.admit(js, 13, spec=JSpec(d=D, **SPECS[0]))
    ts, _, _ = tp.admit(ts, 13, spec=TSpec(d=D, **SPECS[0]))
    # idempotent re-admit, and a conflicting spec is refused
    for sp, want in ((None, True), (SPECS[2], False)):
        jspec = None if sp is None else JSpec(d=D, **sp)
        tspec = None if sp is None else TSpec(d=D, **sp)
        js2, jslot, jok = jp.admit(js, 10, spec=jspec)
        ts2, tslot, tok = tp.admit(ts, 10, spec=tspec)
        assert bool(jok) == bool(tok) == want
        assert int(jslot) == int(tslot)
        assert_states_match(js2, ts2, f"re-admit {sp}")
    assert tp.routing_table(ts) == jp.routing_table(js)
    js, ts = feed(js, ts, 3)
    js, jmask = jp.drift_check(js, min_items=5, min_rate=0.5)
    ts, tmask = tp.drift_check(ts, min_items=5, min_rate=0.5)
    np.testing.assert_array_equal(np.asarray(jmask), tmask.numpy())
    assert bool(tmask.any())
    assert_states_match(js, ts, "drift reset")
    js, ts = feed(js, ts, 4)
    jr, tr = jp.readout(js), tp.readout(ts)
    for name in ("feats", "n", "fval", "active"):
        a, b = np.asarray(getattr(jr, name)), getattr(tr, name).numpy()
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)
    for k in ("overflow", "unknown"):
        np.testing.assert_array_equal(np.asarray(jr.drops[k]),
                                      tr.drops[k].numpy())
    assert_leaves_match(jax_leaves(jr.specs), torch_leaves(tr.specs))
    assert int(tr.n.sum()) > 0


def _stacked(algo, specs, lib):
    rows = [algo.init(algo.hyper(**{("kernel_kind" if k == "kind" else k): v
                                    for k, v in sp.items()}))
            for sp in specs]
    if lib == "jax":
        return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *rows)
    return tree_map(lambda *xs: torch.stack(xs), *rows)


def test_pod_step_ref_matches_jax_and_updates_in_place():
    specs = SPECS + [dict(K=8, T=2, eps=0.5, lengthscale=0.7)]
    ja, ta = (jax_algo(K=K, d=D, lengthscale=1.0),
              torch_algo(K=K, d=D, lengthscale=1.0))
    js, ts = _stacked(ja, specs, "jax"), _stacked(ta, specs, "torch")
    step = jax.jit(lambda st, c, n: jax_pod_step_ref(ja, st, c, n))
    margins = [dict() for _ in specs]
    for rnd, (Cr, counts) in enumerate([(C, [C, 5, 0, 1]), (1, [1, 0, 1, 1]),
                                        (C, [C, C, 9, C])]):
        chunks = stream(300 + rnd, len(specs) * Cr, D).reshape(-1, Cr, D)
        counts = np.asarray(counts, np.int32)
        js = step(js, jnp.asarray(chunks), jnp.asarray(counts))
        feats = ts.ld.feats
        ref = pod_step_ref(ta, ts, torch.from_numpy(chunks),
                           torch.from_numpy(counts), margins=margins)
        out = pod_step(ta, ts, torch.from_numpy(chunks),
                       torch.from_numpy(counts))
        assert out.ld.feats is feats  # stepped in place
        assert_states_match(js, ref, f"ref round {rnd}")
        assert_states_match(js, ts, f"in place round {rnd}")
    assert_clear_margins(margins)
    with pytest.raises(ValueError, match="CUDA"):
        pod_step(ta, ts, torch.from_numpy(chunks), torch.from_numpy(counts),
                 backend="cuda")
    with pytest.raises(ValueError, match="invalid"):
        pod_step(ta, ts, torch.from_numpy(chunks), torch.from_numpy(counts),
                 backend="pallas")


def test_convert_round_trip_then_continue():
    """A JAX pod after two ingests, flattened to numpy, carried into the
    port: both take a third batch and must agree."""
    jp, tp = pods()
    ingest = jax.jit(jp.ingest)
    js, ts = admit_all(jp, tp, jp.init(), tp.init())
    for seed in (11, 12):
        sids, X = batch(seed)
        js, _ = ingest(js, jnp.asarray(sids), jnp.asarray(X))
    flat = jax_leaves(js)
    ts = convert.state_from_numpy(PodState, flat, device="cpu")
    back = convert.state_to_numpy(ts)
    assert set(back) == set(flat)
    for k in flat:
        assert back[k].dtype == flat[k].dtype
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    sids, X = batch(13)
    js, _ = ingest(js, jnp.asarray(sids), jnp.asarray(X))
    ts, _ = tp.ingest(ts, torch.from_numpy(sids), torch.from_numpy(X))
    assert_states_match(js, ts, "after the carried-over ingest")
    with pytest.raises(KeyError, match="unknown leaves"):
        convert.state_from_numpy(PodState, {**flat, "bogus": flat["sid"]},
                                 device="cpu")
    with pytest.raises(KeyError, match="missing leaf"):
        convert.state_from_numpy(
            PodState, {k: v for k, v in flat.items() if k != "sid"},
            device="cpu")


def test_readout_views_follow_the_in_place_step():
    _, tp = pods()
    ts = tp.init()
    ts, _, _ = tp.admit(ts, 10, spec=TSpec(d=D, **SPECS[2]))
    view = tp.readout(ts)
    n_copy = view.n.clone()
    sids, X = batch(21, pool=(10,))
    ts, _ = tp.ingest(ts, torch.from_numpy(sids), torch.from_numpy(X))
    assert int(view.n[0]) == int(ts.algo.ld.n[0]) > int(n_copy[0])


def test_pod_step_tables_follow_the_kernel_layout():
    """The (S, 11) int32 / (S, 3) f32 tables the CUDA kernel reads, column
    by column (``INT_COLS``/``FLT_COLS``), with counts clamped to [0, C]."""
    from repro_torch.kernels.pod_step import FLT_COLS, INT_COLS
    from repro_torch.kernels.pod_step.ops import _tables

    ta = torch_algo(K=K, d=D, lengthscale=1.0)
    st = _stacked(ta, SPECS, "torch")
    counts = torch.tensor([-3, 5, C + 9], dtype=torch.int32)
    ints, flts = _tables(st, counts, C)
    assert ints.dtype == torch.int32 and ints.shape == (3, len(INT_COLS))
    assert flts.dtype == torch.float32 and flts.shape == (3, len(FLT_COLS))
    col = {name: ints[:, i] for i, name in enumerate(INT_COLS)}
    assert col["nv"].tolist() == [0, 5, C]
    for name, want in (("n", st.ld.n), ("j", st.j), ("t", st.t),
                       ("n_fused", st.n_fused), ("n_queries", st.ld.n_queries),
                       ("k_cap", st.hp.k_cap), ("T", st.hp.T),
                       ("ihi", st.hp.ihi), ("num_rungs", st.hp.num_rungs),
                       ("kind_id", st.hp.kernel_kind)):
        assert torch.equal(col[name], want), name
    for i, want in enumerate((st.ld.fval, st.hp.base, st.hp.inv2l2)):
        assert torch.equal(flts[:, i], want), FLT_COLS[i]


def test_pod_step_shared_memory_budget():
    """The pod step's layout tiers: the shared tier keeps the session's
    Linv in shared memory beside the 32-row window (X, Km), and at the
    main path's K = 100, d = 256 two blocks fit on one SM, so a pod of 256
    sessions is resident on 132 SMs at once; past what one block may hold
    (K = 193 at d = 256) the global tier keeps Linv in device memory, its
    window falling from 32 to 16 to 8 rows as Km grows; past K = 4664 at
    d = 256 the wrapper refuses, naming the bytes."""
    from repro_torch.kernels.pod_step import Layout, layout, smem_bytes
    from repro_torch.kernels.pod_step.kernel import pod_step_cuda
    from repro_torch.kernels.rbf_gain.kernel import SMEM_LIMIT

    want = {  # (K, d): (tier, window rows, bytes, blocks per SM)
        (10, 256): ("shared", 32, 61264, 3),
        (50, 256): ("shared", 32, 71504, 3),
        (100, 256): ("shared", 32, 109680, 2),
        (192, 256): ("shared", 32, 229136, 1),
        (193, 256): ("global", 32, 87616, 2),
        (512, 256): ("global", 32, 124176, 1),
        (1024, 256): ("global", 32, 195856, 1),
        (2048, 256): ("global", 16, 191120, 1),
        (3072, 256): ("global", 8, 162128, 1),
        (12, 9): ("shared", 32, 32688, 6),
    }
    for (k, d), row in want.items():
        lay = layout(k, d)
        assert (lay.tier, lay.bt, lay.smem_bytes, lay.blocks_per_sm) == row
        assert smem_bytes(k, d, lay.bt, lay.tier) == lay.smem_bytes
        assert lay.smem_bytes <= SMEM_LIMIT
    assert layout(100, 256).blocks_per_sm >= 2
    # the shared tier at K = 100 costs Linv (40,000 bytes) over the global
    assert (smem_bytes(100, 256, 32, "shared")
            - smem_bytes(100, 256, 32, "global")) == 4 * (100 * 100 - 100)
    assert layout(100, 256, "global") == Layout("global", 32, 70080, 3)
    assert layout(100, 256, window=8) == Layout("shared", 8, 71856, 3)
    with pytest.raises(ValueError, match="238160 bytes of shared memory"):
        layout(4800, 256)
    with pytest.raises(ValueError, match="339216 bytes of shared memory"):
        layout(2048, 256, window=32)
    with pytest.raises(ValueError, match="invalid"):
        layout(100, 256, "resident")
    with pytest.raises(ValueError, match="invalid"):
        layout(100, 256, window=64)
    z = torch.zeros(1, 1, 1)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        pod_step_cuda(z, z, z, z, z.int(), z, a=1.0)


def test_pod_step_layout_matches_the_source():
    """The host's layout and launch geometry against the constants of
    csrc/pod_step.cu and csrc/gain_rows.cuh: threads per block, window
    rows, tier ids, the product's tile and stage, and the C entry points'
    arity.  (The byte formula itself is held against the built library's
    ``pod_step_smem_bytes`` on the card, tests/test_torch_cuda.py.)"""
    import re
    from pathlib import Path

    from repro_torch.kernels.pod_step import kernel as pk
    from repro_torch.kernels.rbf_gain.kernel import RB_KT, RB_LD

    csrc = Path(pk.__file__).resolve().parents[2] / "csrc"
    cu = (csrc / "pod_step.cu").read_text()
    cuh = (csrc / "gain_rows.cuh").read_text()

    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const(cuh, "RB_NT") == pk.POD_NT
    assert re.search(r"constexpr int POD_NT = RB_NT;", cu)
    assert (const(cuh, "RB_KT"), const(cuh, "RB_DK")) == (RB_KT, pk.RB_DK)
    assert re.search(r"constexpr int RB_LD = RB_DK \+ 4;", cuh)
    assert RB_LD == pk.RB_DK + 4
    rows = re.search(r"constexpr int WINDOW_ROWS\[\] = \{([^}]*)\}", cu)[1]
    assert tuple(int(v) for v in rows.split(",")) == pk.WINDOW_ROWS
    tiers = re.search(r"enum \{ TIER_SHARED = (\d), TIER_GLOBAL = (\d) \}", cu)
    assert (pk.TIERS[int(tiers[1])], pk.TIERS[int(tiers[2])]) == (
        "shared", "global")
    assert re.search(r"STAGE_FLOATS = 2 \* RB_KT \* RB_LD;", cu)
    for fn in ("pod_step_launch", "pod_step_smem_bytes"):
        proto = re.search(rf'extern "C" int {fn}\(([^)]*)\)', cu)[1]
        assert len(proto.split(",")) == len(pk.KERNEL.signatures[fn]), fn
    # the launch passes the layout's window rows and tier id, in that order
    proto = re.search(r'extern "C" int pod_step_launch\(([^)]*)\)', cu)[1]
    names = [p.split()[-1].lstrip("*") for p in proto.split(",")]
    assert names[13:16] == ["bt", "tier", "dtype"]
