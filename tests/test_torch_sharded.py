# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""The port's scale-out path on four gloo ranks, held against the JAX
package on four host devices.

One rank group (``_torch_ranks.sharded_suite``, spawned ranks joined
through a ``file://`` store in the test's directory) and one JAX
subprocess (this file run as a script with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``) run on the same
numpy inputs at the same time:

  * ``SummarizerPod.make_sharded_update``: 4 ranks x 3 sessions on a
    (4, 1) ("data", "model") mesh, plain and pre-routed, then on a
    (2, 2) ("pod", "data") mesh with the tuple axis; the ranks' states
    joined (``convert.join_sharded``) against the JAX global state;
  * ``DistributedSummarizer`` on a (4,) ("data",) mesh: the ranks' states
    after every update against JAX ``update`` on the 4-device mesh, and
    every rank's merge against JAX ``merge`` on the same states
    unsharded (the reference's ``merge`` raises on a 4-device mesh in
    JAX 0.9.0: ``dynamic_slice`` on a sharded dimension);
  * ``Compressor(mesh, "pod")`` over 3 steps with different gradients a
    pod, on a (4,) pod mesh and on the two pod pairs of a (2, 2)
    ("pod", "data") mesh, against the JAX ``Compressor`` on (4,) and (2,)
    pod meshes; and the identity on a mesh without a pod axis.

Integers equal; pod and merge floats within rtol = atol = 1e-5 (the pod
tests' tolerance); the compressor's reduced gradients and residuals
within rtol = 1e-6 and atol = 1e-6 x the leaf's largest reduced value
(the pods' scales are summed in another order, and XLA fuses the
residual's multiply and subtract: up to 7.2e-7 where the reduced values
reach 2.4, a few float32 ulps).
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_ranks as ranks  # noqa: E402

P, K, D, S, C, N = 4, 8, 5, 3, 12, 30
SPECS = [dict(K=4, T=3, eps=0.3, lengthscale=0.8),
         dict(K=8, T=5, eps=0.1, lengthscale=1.2, kernel_kind="linear_norm"),
         dict(K=6, T=4, eps=0.2, lengthscale=1.0)]
POD_ALGO = dict(K=K, T=5, eps=0.2, lengthscale=1.0)
SEGMENTS = [("data", "data", False, [0, 1]),
            ("data_routed", "data", True, [2, 3]),
            ("pod_data", "pod_data", False, [4, 5])]
MERGE_ALGO = dict(K=K, T=10, eps=0.2, lengthscale=1.5)
MERGE_B, MERGE_BATCHES = 16, 3
GRAD_SHAPES = {"w": (6, 4), "b": (7,), "z": (3, 5)}
STEPS = 3
TIMEOUT = 240
ROOT = Path(__file__).resolve().parents[1]


def _config():
    rng = np.random.default_rng(7)
    sids = [[100 + 10 * p + s for s in range(S)] for p in range(P)]
    specs = [[SPECS[(p + s) % 3] for s in range(S)] for p in range(P)]
    batch_sids, batch_X = [], []
    for _ in range(6):
        tags = []
        for p in range(P):
            # each rank's own sessions, one unknown id and padding; one
            # session past its chunk now and then
            pool = sids[p] + [sids[p][0], 999, -1]
            tags.append(rng.choice(pool, size=N).astype(np.int32))
        batch_sids.append(np.concatenate(tags))
        batch_X.append((0.5 * rng.standard_normal((P * N, D))).astype(
            np.float32))
    grads = [ranks.random_grads(11 + t, P, GRAD_SHAPES) for t in range(STEPS)]
    merge = [(0.5 * rng.standard_normal((P * MERGE_B, D))).astype(np.float32)
             for _ in range(MERGE_BATCHES)]
    return {
        "pod": {"d": D, "algo": POD_ALGO, "S": S, "C": C, "N": N,
                "sids": sids, "specs": specs, "segments": SEGMENTS,
                "batch_sids": batch_sids, "batch_X": batch_X},
        "merge": {"d": D, "algo": MERGE_ALGO, "B": MERGE_B,
                  "batches": merge},
        "compress": {"grads": grads},
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the config, the ranks' results, the JAX results): the rank group
    and the JAX subprocess run side by side."""
    work = tmp_path_factory.mktemp("sharded")
    cfg = _config()
    with open(work / "in.pkl", "wb") as f:
        pickle.dump(cfg, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    with open(work / "jax.log", "w") as log:
        jax_proc = subprocess.Popen(
            [sys.executable, __file__, str(work / "in.pkl"),
             str(work / "jax.pkl")], env=env, stdout=log,
            stderr=subprocess.STDOUT)
        try:
            got = ranks.run_ranks(ranks.sharded_suite, P, work / "ranks", cfg,
                                  timeout=TIMEOUT)
            rc = jax_proc.wait(timeout=TIMEOUT)
        finally:
            if jax_proc.poll() is None:
                jax_proc.kill()
                jax_proc.wait()
    assert rc == 0, (work / "jax.log").read_text()[-4000:]
    with open(work / "jax.pkl", "rb") as f:
        want = pickle.load(f)  # written by the subprocess above
    return cfg, got, want


def _match(jl, tl, msg, rtol=1e-5, atol=1e-5):
    assert set(jl) == set(tl), (msg, set(jl) ^ set(tl))
    for k in sorted(jl):
        a, b = np.asarray(jl[k]), np.asarray(tl[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (msg, k, a.shape,
                                                           b.shape, a.dtype,
                                                           b.dtype)
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b, err_msg=f"{msg} {k}")
        else:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                       err_msg=f"{msg} {k}")


# --------------------------------------------------------------------- pod
def test_pod_ranks_start_from_jax_rows(runs):
    """Each rank's admitted pod is its rows of the JAX global state, and
    the global state crosses both ways through ``split_sharded`` /
    ``join_sharded``."""
    from repro_torch.convert import (join_sharded, split_sharded,
                                     state_from_numpy, state_to_numpy)
    from repro_torch.serve.summarize import PodState

    _, got, want = runs
    pieces = split_sharded(want["pod"]["init"], P)
    for p in range(P):
        _match(pieces[p], got[p]["pod"]["init"], f"rank {p} init")
        back = state_to_numpy(state_from_numpy(PodState, pieces[p],
                                               device="cpu"))
        _match(pieces[p], back, f"rank {p} round trip", rtol=0, atol=0)
    _match(want["pod"]["init"], join_sharded(pieces), "join", rtol=0, atol=0)


@pytest.mark.parametrize("segment", [s[0] for s in SEGMENTS])
def test_sharded_update_matches_jax(runs, segment):
    from repro_torch.convert import join_sharded

    _, got, want = runs
    _match(want["pod"][segment]["state"],
           join_sharded([g["pod"][segment]["state"] for g in got]), segment)
    for i, jstats in enumerate(want["pod"][segment]["stats"]):
        _match(jstats, join_sharded([g["pod"][segment]["stats"][i]
                                     for g in got]), f"{segment} stats {i}")
    drops = sum(int(g["pod"][segment]["state"]["drops_unknown"].sum())
                for g in got)
    assert drops > 0  # the unknown id reached every rank's ledger


# ------------------------------------------------------------------- merge
@pytest.mark.parametrize("step", range(MERGE_BATCHES))
def test_distributed_update_matches_jax(runs, step):
    from repro_torch.convert import join_sharded

    _, got, want = runs
    _match(want["merge"]["updates"][step],
           join_sharded([g["merge"]["updates"][step] for g in got]),
           f"update {step}")


def test_distributed_merge_matches_jax(runs):
    _, got, want = runs
    assert [g["merge"]["n_shards"] for g in got] == [P] * P
    for p in range(P):
        _match(want["merge"]["merged"], got[p]["merge"]["merged"],
               f"rank {p} merge")
        _match(got[0]["merge"]["merged"], got[p]["merge"]["merged"],
               f"rank {p} vs rank 0", rtol=0, atol=0)
    assert int(want["merge"]["merged"]["n"]) > 0


# -------------------------------------------------------------- compressor
@pytest.mark.parametrize("mesh", ["pod4", "pod2"])
@pytest.mark.parametrize("step", range(STEPS))
def test_compress_reduce_matches_jax(runs, mesh, step):
    """Reduced gradients and residuals of every pod after ``step`` steps;
    pod2: rank 2 i + j is pod i of the pair at data position j."""
    _, got, want = runs
    for r in range(P):
        mine = got[r]["compress"][mesh]
        assert mine["active"] and mine["steps"][step]["ratio"] == 4.0
        jstep = want["compress"][mesh][r][step]
        tstep = mine["steps"][step]
        for k, a in jstep["grads"].items():
            scale = np.abs(a).max()
            for name in ("grads", "ef"):
                a, b = jstep[name][k], tstep[name][k]
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_allclose(
                    b, a, rtol=1e-6, atol=1e-6 * scale,
                    err_msg=f"{mesh} rank {r} step {step} {name} {k}")
    if mesh == "pod4":  # one mean on every pod
        for k in GRAD_SHAPES:
            for r in range(1, P):
                np.testing.assert_array_equal(
                    got[r]["compress"][mesh]["steps"][step]["grads"][k],
                    got[0]["compress"][mesh]["steps"][step]["grads"][k])


def test_error_feedback_crosses_as_per_pod_trees(runs):
    """The JAX residuals, stacked over the pods, split into each pod's
    tree (``split_sharded(keep_axis=False)``) and joined back."""
    from repro_torch.convert import join_sharded, split_sharded

    _, got, want = runs
    stacked = {k: np.stack([want["compress"]["pod4"][r][STEPS - 1]["ef"][k]
                            for r in range(P)]) for k in GRAD_SHAPES}
    per_pod = split_sharded(stacked, P, keep_axis=False)
    last = want["compress"]["pod4"][0][STEPS - 1]["grads"]
    for r in range(P):
        mine = got[r]["compress"]["pod4"]["steps"][-1]["ef"]
        assert set(per_pod[r]) == set(mine)
        for k, a in per_pod[r].items():
            np.testing.assert_allclose(mine[k], a, rtol=1e-6,
                                       atol=1e-6 * np.abs(last[k]).max())
    _match(stacked, join_sharded(per_pod, keep_axis=False), "join", rtol=0,
           atol=0)


def test_compressor_without_pod_axis_is_identity(runs):
    _, got, _ = runs
    for r in range(P):
        mine = got[r]["compress"]["nopod"]
        assert not mine["active"]
        assert all(s["ratio"] == 1.0 and s["same"] for s in mine["steps"])


# ------------------------------------------------------ the JAX subprocess
def _jax_main(inp, outp):
    """The JAX package on 4 host devices over the same inputs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as PS

    from repro.ckpt.store import _flatten_with_keys
    from repro.core import api
    from repro.core.spec import SessionSpec
    from repro.data import DistributedSummarizer
    from repro.serve.summarize import SummarizerPod
    from repro.train.compress import Compressor

    assert len(jax.devices()) == P, jax.devices()
    with open(inp, "rb") as f:
        cfg = pickle.load(f)  # written by the test

    def flat(tree):
        return {k: np.asarray(v) for k, v in _flatten_with_keys(tree).items()}

    tmap = jax.tree_util.tree_map
    out = {}

    # the pod: P per-shard states concatenated
    c = cfg["pod"]
    algo = api.make(SessionSpec(d=c["d"], backend="jnp", **c["algo"]))
    pod = SummarizerPod(algo=algo, sessions=c["S"], chunk=c["C"],
                        podstep_backend="jnp")
    shards = []
    for p in range(P):
        st = pod.init()
        for sid, sp in zip(c["sids"][p], c["specs"][p]):
            st, _, ok = pod.admit(st, int(sid),
                                  spec=SessionSpec(d=c["d"], **sp))
            assert bool(ok)
        shards.append(st)
    state = tmap(lambda *ls: jnp.concatenate(ls), *shards)
    res = {"init": flat(state)}
    meshes = {"data": (jax.make_mesh((P, 1), ("data", "model")), "data"),
              "pod_data": (jax.make_mesh((2, P // 2), ("pod", "data")),
                           ("pod", "data"))}
    Sn, Nn = c["S"], c["N"]
    for name, mesh_key, pre_routed, batches in c["segments"]:
        mesh, axis = meshes[mesh_key]
        sh = NamedSharding(mesh, PS(axis))
        fn = jax.jit(pod.make_sharded_update(mesh, axis,
                                             pre_routed=pre_routed))
        state = jax.device_put(state, sh)
        stats = []
        for b in batches:
            sids, X = c["batch_sids"][b], c["batch_X"][b]
            if pre_routed:
                host = jax.device_get(state)
                parts = [pod.route(tmap(lambda l: l[p * Sn:(p + 1) * Sn],
                                        host),
                                   jnp.asarray(sids[p * Nn:(p + 1) * Nn]),
                                   jnp.asarray(X[p * Nn:(p + 1) * Nn]))
                         for p in range(P)]
                args = (jnp.concatenate([q[0] for q in parts]),
                        jnp.concatenate([q[1] for q in parts]),
                        jnp.stack([q[2] for q in parts]),
                        jnp.concatenate([q[3] for q in parts]))
            else:
                args = (jnp.asarray(sids), jnp.asarray(X))
            state, st = fn(state, *jax.device_put(args, sh))
            stats.append(flat(st))
        res[name] = {"state": flat(state), "stats": stats}
    out["pod"] = res

    # the distributed summarizer on a (P,) data mesh; merge unsharded
    c = cfg["merge"]
    algo = api.make(SessionSpec(d=c["d"], backend="jnp", **c["algo"]))
    mesh = jax.make_mesh((P,), ("data",))
    dist = DistributedSummarizer(algo, mesh=mesh)
    states = dist.init()
    update = jax.jit(dist.update)
    ups = []
    for X in c["batches"]:
        states = update(states, jax.device_put(
            jnp.asarray(X), NamedSharding(mesh, PS("data"))))
        ups.append(flat(states))
    host = tmap(jnp.asarray, jax.device_get(states))
    out["merge"] = {"updates": ups,
                    "merged": flat(jax.jit(dist.merge)(host).ld)}

    # the compressor: each pod's gradients on its own device of a
    # replicated-spec array, read back device by device in mesh order
    grads = cfg["compress"]["grads"]

    def run(mesh, pods):
        devs = list(mesh.devices.flat)
        sh = NamedSharding(mesh, PS())
        comp = Compressor(mesh=mesh)
        reduce = jax.jit(comp.compress_reduce)

        def glob(per_pod):
            return jax.make_array_from_single_device_arrays(
                per_pod[0].shape, sh,
                [jax.device_put(a, d) for a, d in zip(per_pod, devs)])

        def per_device(a):
            by = {s.device: np.asarray(s.data) for s in a.addressable_shards}
            return [by[d] for d in devs]

        ef = None
        steps = [[] for _ in pods]
        for g in grads:
            gg = {k: glob([v[p] for p in pods]) for k, v in g.items()}
            if ef is None:
                ef = {k: glob([np.zeros_like(v[p]) for p in pods])
                      for k, v in g.items()}
            g2, ef, _ = reduce(gg, ef)
            gd = {k: per_device(v) for k, v in g2.items()}
            ed = {k: per_device(v) for k, v in ef.items()}
            for i in range(len(pods)):
                steps[i].append({"grads": {k: gd[k][i] for k in gd},
                                 "ef": {k: ed[k][i] for k in ed}})
        return steps

    pod4 = run(jax.make_mesh((P,), ("pod",)), list(range(P)))
    pod2 = [None] * P
    mesh2 = jax.make_mesh((2,), ("pod",), devices=jax.devices()[:2])
    for j in range(P // 2):
        pair = [j, P // 2 + j]  # rank 2 i + j: pod i at data position j
        for i, steps in enumerate(run(mesh2, pair)):
            pod2[pair[i]] = steps
    out["compress"] = {"pod4": pod4, "pod2": pod2}
    with open(outp, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    _jax_main(sys.argv[1], sys.argv[2])
