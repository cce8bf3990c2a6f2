# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""The port's model on a device mesh, on spawned gloo ranks, held against
the JAX package's mesh-free calls (the reference's own mesh tests fail in
JAX 0.9.0 on explicit mesh axes) and the port's one-process forward.

  * ``shard_act``: a no-op without a mesh; on a mesh the reference's
    resolution rule on a table of cases (``act_pspec``);
  * reduced qwen2, mamba2, deepseek and jamba in float32 on (2, 2) and
    (1, 2) ("data", "model") meshes: the gathered ``train_logits`` and
    aux loss within 1e-5 of JAX's mesh-free ``train_logits`` and of the
    port's one-process forward, and every gradient leaf against
    ``jax.grad``; under ``use_pallas_attention`` the kernel route (its
    plain version on a CPU tensor) sees each rank's own heads;
  * context parallelism on a (1, 3) mesh (4 query heads, S = 12,
    ``attn_seq_shard``): each rank attends its 4 query rows at offset
    4 r, within 1e-5; under ``use_pallas_attention`` the query sequence
    is gathered for the kernel;
  * a train step on (2, 2): the loss, every gradient leaf and the
    parameters after one AdamW step against JAX's mesh-free
    ``make_train_step`` (tests/test_torch_train.py's tolerances); a run
    killed at step 2 and resumed from its checkpoint bit-equal to an
    uninterrupted one; ``launch.train.main`` on the mesh; and
    ``--production-mesh`` on a 4-rank group raising with 256 in the
    message;
  * the host-copy backend of ranks that share one card
    (``launch.mesh.register_host_backend``) on 3 ranks.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train import step as jstep  # noqa: E402

import _torch_ranks as ranks  # noqa: E402
from _torch_port import jax_leaves, model_pair  # noqa: E402

TOL = 1e-5  # f32 logits, a few layers, sums split over ranks
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5  # tests/test_torch_train.py's
ARCHS = {"qwen2": "qwen2-1.5b", "mamba2": "mamba2-370m",
         "deepseek": "deepseek-v2-lite-16b",
         "jamba": "jamba-1.5-large-398b"}
B, S = 4, 12
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=4)
TIMEOUT = 300


def _f32(arch, **kw):
    return dataclasses.replace(jget(arch, reduced=True), dtype="float32",
                               **kw)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}


def _case(name, seed, **over):
    """(rank case, JAX mesh-free logits and aux, port one-process logits
    and aux) of a reduced arch."""
    # the JAX side on its plain attention: the kernel route's math
    jcfg = _f32(ARCHS[name], **{k: v for k, v in over.items()
                                if k != "use_pallas_attention"})
    jm, jp, tm, tp = model_pair(jcfg, seed=seed, **over)
    b = _batch(jcfg, seed)
    jl, jaux = jm.train_logits(jp, {k: jnp.asarray(v) for k, v in b.items()})
    with torch.no_grad():
        tl, taux = tm.train_logits(tp, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
    case = {"arch": ARCHS[name], "over": over, "batch": b,
            "params": jax.tree_util.tree_map(np.asarray, jp),
            "grad": not over}
    want = [(np.asarray(jl), float(jaux)), (tl.numpy(), float(taux))]
    if case["grad"]:
        (loss, _), grads = jax.value_and_grad(jm.loss, has_aux=True)(
            jp, {k: jnp.asarray(v) for k, v in b.items()})
        want.append((float(loss), jax_leaves(grads)))
    return (case, *want)


FORWARD = {"qwen2": {}, "mamba2": {}, "deepseek": {}, "jamba": {},
           "qwen2_kernel": {"use_pallas_attention": True}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One rank group per mesh, all of them running at once."""
    import concurrent.futures as cf

    want, cases = {}, {}
    for i, (name, over) in enumerate(FORWARD.items()):
        cases[name], *want[name] = _case(name.split("_")[0], i, **over)
    cp = {"cp": {"attn_seq_shard": True},
          "cp_kernel": {"attn_seq_shard": True,
                        "use_pallas_attention": True}}
    cp_cases = {}
    for name, over in cp.items():
        cp_cases[name], *want[name] = _case("qwen2", 7, **over)
    jcfg = _f32("qwen2-1.5b")
    jm, jp, _, _ = model_pair(jcfg, seed=11)
    batches = [_batch(jcfg, 20 + i) for i in range(4)]
    tmp = tmp_path_factory.mktemp("mesh")
    train = {"arch": "qwen2-1.5b", "opt": OPT, "batches": batches,
             "params": jax.tree_util.tree_map(np.asarray, jp),
             "dir": str(tmp / "ckpt")}
    jobs = {"2x2": (4, {"shape": (2, 2), "forward": cases, "train": train}),
            "1x2": (2, {"shape": (1, 2), "forward": cases}),
            "1x3": (3, {"shape": (1, 3), "forward": cp_cases})}
    with cf.ThreadPoolExecutor(4) as ex:
        futs = {k: ex.submit(ranks.run_ranks, ranks.mesh_model_program,
                             world, tmp / k, cfg, timeout=TIMEOUT)
                for k, (world, cfg) in jobs.items()}
        futs["host"] = ex.submit(
            ranks.run_ranks, ranks.host_backend_program, 3, tmp / "host",
            str(tmp / "host"), timeout=TIMEOUT, init=False)
        got = {k: f.result() for k, f in futs.items()}
    return {"got": got, "want": want, "jax_train": (jm, jp, batches)}


# ------------------------------------------------------------ shard_act
class _Mesh:
    """The two attributes ``act_pspec`` reads of a DeviceMesh."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(axes.values())


@pytest.mark.parametrize("axes,shape,args,want", [
    # the reference's rule (src/repro/models/layers.py:103-129): 'batch'
    # -> the ('pod', 'data') axes present when the dim divides their
    # product, 'tp' -> 'model' when the dim divides it, else None;
    # trailing dims None
    (dict(data=2, model=2), (4, 12, 64), ("batch",), ("data", None, None)),
    (dict(data=2, model=2), (3, 12, 64), ("batch",), (None, None, None)),
    (dict(data=2, model=2), (4, 12, 4, 16), ("batch", None, "tp"),
     ("data", None, "model", None)),
    (dict(data=1, model=3), (4, 12, 4, 16), ("batch", None, "tp"),
     ("data", None, None, None)),
    (dict(data=1, model=3), (4, 12, 4, 16), ("batch", "tp"),
     ("data", "model", None, None)),
    (dict(data=16, model=16), (256, 4096, 12, 128), ("batch", None, "tp"),
     ("data", None, None, None)),
    (dict(pod=2, data=16, model=16), (256, 4096, 8960), ("batch", None, "tp"),
     (("pod", "data"), None, "model")),
    (dict(pod=2, data=16, model=16), (16, 8), ("batch",), (None, None)),
    (dict(data=4), (8, 6), ("batch", "tp"), ("data", None)),
    (dict(data=2, model=2), (4, 6), (None, "bogus"), (None, None)),
])
def test_shard_act_resolves_as_the_reference(axes, shape, args, want):
    from repro_torch.models.layers import act_pspec

    assert act_pspec(shape, args, _Mesh(**axes)) == want


def test_shard_act_without_a_mesh_is_the_tensor_itself():
    from repro_torch.launch.mesh import ambient_mesh, use_mesh
    from repro_torch.models.layers import shard_act

    x = torch.randn(4, 3, 2)
    assert ambient_mesh() is None
    assert shard_act(x, "batch", None, "tp") is x
    with use_mesh(None):
        assert shard_act(x, "batch") is x


# -------------------------------------------------------------- forward
@pytest.mark.parametrize("mesh", ["2x2", "1x2"])
@pytest.mark.parametrize("name", list(FORWARD))
def test_mesh_forward_matches_jax_and_one_process(runs, mesh, name):
    (jl, jaux), (tl, taux) = runs["want"][name][:2]
    for r, got in enumerate(runs["got"][mesh]):
        g = got["forward"][name]
        np.testing.assert_allclose(g["logits"], jl, rtol=TOL, atol=TOL,
                                   err_msg=f"rank {r} vs JAX")
        np.testing.assert_allclose(g["logits"], tl, rtol=TOL, atol=TOL,
                                   err_msg=f"rank {r} vs one process")
        np.testing.assert_allclose(g["aux"], jaux, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(g["aux"], taux, rtol=TOL, atol=TOL)
        # the batch over 'data', the vocab over 'model'
        assert g["placements"] == "(Shard(dim=0), Shard(dim=2))", g


def test_kernel_route_sees_each_ranks_heads(runs):
    """Reduced qwen2 (4 query heads, 2 kv heads) under
    ``use_pallas_attention``: on (2, 2) the kernel route gets each rank's
    2 query heads of its 2 batch rows, on (1, 2) 2 heads of all 4."""
    for mesh, shape in (("2x2", (2, 2, S, 16)), ("1x2", (4, 2, S, 16))):
        for got in runs["got"][mesh]:
            seen = got["forward"]["qwen2_kernel"]["flash"]
            assert seen and all(s == shape for s in seen), (mesh, seen)


@pytest.mark.parametrize("mesh", ["2x2", "1x2"])
@pytest.mark.parametrize("name", ["qwen2", "mamba2", "deepseek", "jamba"])
def test_mesh_gradients_match_jax(runs, mesh, name):
    """``make_grad_fn`` on the mesh (every gradient leaf gathered) against
    ``jax.value_and_grad`` of JAX's mesh-free loss, at
    tests/test_torch_train.py's bounds: the parts the ranks split (heads,
    channels, vocab rows, batch rows) must sum back to one gradient."""
    loss, grads = runs["want"][name][2]
    for r, got in enumerate(runs["got"][mesh]):
        g = got["forward"][name]
        np.testing.assert_allclose(g["loss"], loss, rtol=1e-5)
        assert set(g["grads"]) == set(grads)
        for k, want in grads.items():
            want = np.asarray(want, np.float32)
            np.testing.assert_allclose(
                g["grads"][k], want, rtol=GRAD_RTOL,
                atol=GRAD_ATOL * max(float(np.abs(want).max()), 1e-30),
                err_msg=f"rank {r} {k}")


# ------------------------------------------------- context parallelism
@pytest.mark.parametrize("name", ["cp", "cp_kernel"])
def test_context_parallel_matches_jax_and_one_process(runs, name):
    """4 query heads do not divide the (1, 3) mesh's 'model' axis: the
    query sequence splits over it instead, and the logits are the
    mesh-free ones ("attn_seq_shard changes layout only, never
    values")."""
    (jl, _), (tl, _) = runs["want"][name][:2]
    for r, got in enumerate(runs["got"]["1x3"]):
        g = got["forward"][name]
        np.testing.assert_allclose(g["logits"], jl, rtol=TOL, atol=TOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(g["logits"], tl, rtol=TOL, atol=TOL)
        if name == "cp":  # rank r attends rows [4 r, 4 r + 4)
            assert g["chunked"] and all(
                c == (S // 3, r * S // 3) for c in g["chunked"]), g
        else:  # the kernel gets the whole sequence and every head
            assert g["flash"] and all(
                s == (B, 4, S, 16) for s in g["flash"]), g


# ------------------------------------------------- ranks sharing a card
def test_host_backend_collectives(runs):
    """``register_host_backend`` (gloo on host copies, for ranks sharing
    one card): on 3 ranks, rank r holding x + r with x = arange(12) as
    (3, 4), the gather, the sum, its scatter, an all-to-all (row shards
    to column shards) and a broadcast give what they must."""
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    for r, got in enumerate(runs["got"]["host"]):
        np.testing.assert_array_equal(
            got["gather"], np.concatenate([x[:1] + q for q in range(3)]))
        np.testing.assert_array_equal(got["reduce"], 3 * x + 3)
        np.testing.assert_array_equal(got["scatter"], (3 * x + 3)[r:r + 1])
        whole = np.concatenate([x + q for q in range(3)])
        np.testing.assert_array_equal(  # torch.chunk's split: 2, 2, 0
            got["shard_to_shard"], whole[:, min(2 * r, 4):2 * r + 2])
        np.testing.assert_array_equal(got["broadcast"], x)


# -------------------------------------------------------------- training
def _jax_reference(runs):
    jm, jp, batches = runs["jax_train"]
    b = {k: jnp.asarray(v) for k, v in batches[0].items()}
    (loss, _), grads = jax.value_and_grad(jm.loss, has_aux=True)(jp, b)
    jcfg = joptim.AdamWConfig(**OPT)
    after, _, met = jax.jit(jstep.make_train_step(jm, jcfg))(
        jp, joptim.init_opt_state(jp, jcfg), b)
    return float(loss), jax_leaves(grads), jax_leaves(after), float(
        met["grad_norm"])


def test_mesh_train_step_matches_jax(runs):
    loss, grads, after, gnorm = _jax_reference(runs)
    for r, got in enumerate(runs["got"]["2x2"]):
        t = got["train"]
        np.testing.assert_allclose(t["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(t["grad_norm"], gnorm, rtol=1e-4)
        assert set(t["grads"]) == set(grads)
        for k, want in grads.items():
            want = np.asarray(want, np.float32)
            np.testing.assert_allclose(
                t["grads"][k], want, rtol=GRAD_RTOL,
                atol=GRAD_ATOL * max(float(np.abs(want).max()), 1e-30),
                err_msg=f"rank {r} {k}")
        # the first AdamW step moves a parameter by about lr g / |g|: a
        # gradient element within the gradient bound of zero may land
        # anywhere in [-1, 1] of that ratio (a move of at most 2 lr);
        # every other element is held to 1e-5
        for k, want in after.items():
            g = np.asarray(grads[k], np.float32)
            clear = np.abs(g) > 10 * GRAD_ATOL * np.abs(g).max()
            got, want = t["after"][k], np.asarray(want)
            np.testing.assert_allclose(got[clear], want[clear], rtol=1e-5,
                                       atol=1e-6, err_msg=f"rank {r} {k}")
            assert np.all(np.abs(got - want) <= 2 * OPT["lr"]), k


def test_mesh_resume_is_bit_equal(runs):
    for got in runs["got"]["2x2"]:
        res = got["train"]["resume"]
        assert res == {"preempted": True, "start": 2, "equal": True}


def test_launcher_trains_on_the_mesh(runs):
    for got in runs["got"]["2x2"]:
        end, loss = got["train"]["launcher"]
        assert end == 2 and np.isfinite(loss)


def test_production_mesh_flag_needs_256_ranks(runs):
    for got in runs["got"]["2x2"]:
        msg = got["train"]["production"]
        assert msg is not None and "256" in msg and "4" in msg, msg
