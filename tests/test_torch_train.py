# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""The port's training math (``repro_torch.train``, remat, the gradient
of the kernel routes) held against the JAX package's (``repro.train``,
``jax.grad``) on the CPU, float32, at reduced sizes: AdamW, ``lr_at`` and
``global_norm`` over three steps of the same gradients; every leaf of
``jax.grad(model.loss)`` for the reduced dense, MLA + MoE (dense and
dispatch), Mamba2, Jamba and Whisper models; microbatched gradients;
remat ``full`` and ``dots`` bit-equal to no remat; a 5-step loss
trajectory; and ``kernels.autograd.PlainGrad``, whose gradient is the
plain version's, bit for bit."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.convert import model_params_from_jax  # noqa: E402
from repro_torch.kernels.autograd import PlainGrad, with_plain_grad  # noqa
from repro_torch.train import optim as toptim  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.tree import leaves_with_keys, tree_map  # noqa: E402

from _torch_port import jax_leaves, model_pair, torch_leaves  # noqa: E402

GRAD_RTOL = 1e-4  # f32 gradients through a few layers, XLA vs ATen order
GRAD_ATOL = 1e-5  # times the leaf's largest JAX gradient
TRAJ_RTOL = 1e-4  # a 5-step loss trajectory


def _np(x):
    return np.asarray(x, np.float32)


def _f32(arch, **kw):
    return dataclasses.replace(jget(arch, reduced=True), dtype="float32",
                               **kw)


def _batch(cfg, B=2, S=8, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.encoder is not None:
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.n_prefix:
        out["prefix"] = rng.standard_normal(
            (B, cfg.n_prefix, cfg.d_model)).astype(np.float32)
    return out


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _hold_grads(jg, tg, msg=""):
    """Every leaf within GRAD_RTOL and GRAD_ATOL x its largest JAX
    gradient."""
    jl, tl = jax_leaves(jg), torch_leaves(tg)
    assert set(jl) == set(tl), set(jl) ^ set(tl)
    for k in sorted(jl):
        want = _np(jl[k])
        size = float(np.abs(want).max())
        np.testing.assert_allclose(tl[k], want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * max(size, 1e-30),
                                   err_msg=f"{msg} {k}")


# ------------------------------------------------------------------ AdamW
def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "blk": {"b": rng.standard_normal((5,)).astype(np.float32),
                    "k": rng.standard_normal((3, 4, 2)).astype(np.float32)}}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax_over_three_steps(state_dtype):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=1.0,
              state_dtype=state_dtype)
    jcfg, tcfg = joptim.AdamWConfig(**kw), toptim.AdamWConfig(**kw)
    params = _tree(0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = model_params_from_jax(params, "cpu")
    js, ts = joptim.init_opt_state(jp, jcfg), toptim.init_opt_state(tp, tcfg)
    assert ts.step.dtype == torch.int32 and ts.m["w"].dtype == getattr(
        torch, state_dtype)
    for i in range(3):
        g = jax.tree_util.tree_map(lambda x: 3.0 * x, _tree(10 + i))
        jp, js, jm = joptim.adamw_update(
            jp, jax.tree_util.tree_map(jnp.asarray, g), js, jcfg)
        tp, ts, tm = toptim.adamw_update(
            tp, model_params_from_jax(g, "cpu"), ts, tcfg)
        assert int(ts.step) == int(js.step) == i + 1
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(torch_leaves(tp)["w"],
                                   _np(jax_leaves(jp)["w"]), rtol=1e-5,
                                   atol=1e-6)
        for name, jt, tt in (("params", jp, tp), ("m", js.m, ts.m),
                             ("v", js.v, ts.v)):
            jl, tl = jax_leaves(jt), leaves_with_keys(tt)
            for k in jl:
                # bf16 moments: within one bf16 ulp of the JAX rounding
                tol = 2 ** -7 if name != "params" and state_dtype == \
                    "bfloat16" else 1e-5
                np.testing.assert_allclose(
                    tl[k].float().numpy(), _np(jl[k]), rtol=tol, atol=1e-7,
                    err_msg=f"step {i + 1} {name} {k}")


@pytest.mark.parametrize("cfg", [
    dict(lr=3e-4, warmup_steps=100, total_steps=10_000),
    dict(lr=1e-3, warmup_steps=2, total_steps=20, min_lr_frac=0.0),
    dict(lr=1.0, warmup_steps=0, total_steps=7, min_lr_frac=0.5)])
def test_lr_at_matches_jax(cfg):
    jc, tc = joptim.AdamWConfig(**cfg), toptim.AdamWConfig(**cfg)
    for s in [0, 1, 2, 3, 50, 99, 100, 101, 5000, 9999, 10_000, 20_000]:
        want = float(joptim.lr_at(jnp.int32(s), jc))
        got = toptim.lr_at(torch.tensor(s, dtype=torch.int32), tc)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0,
                                   err_msg=str(s))


def test_global_norm_matches_jax():
    tree = _tree(3)
    want = float(joptim.global_norm(jax.tree_util.tree_map(jnp.asarray,
                                                           tree)))
    got = toptim.global_norm(model_params_from_jax(tree, "cpu"))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_adamw_clips_and_skips_decay_on_vectors():
    """A gradient far over the clip is scaled to norm grad_clip; a 1-D
    leaf with zero gradient does not decay, a 2-D one does."""
    cfg = toptim.AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.5)
    p = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    g = {"w": torch.zeros(2, 2), "b": torch.zeros(2)}
    p, st, m = toptim.adamw_update(p, g, toptim.init_opt_state(p, cfg), cfg)
    assert torch.equal(p["b"], torch.ones(2))
    assert bool((p["w"] < 1).all())
    g = {"w": torch.full((2, 2), 1e3), "b": torch.zeros(2)}
    _, st, m = toptim.adamw_update(p, g, st, cfg)
    assert float(m["grad_norm"]) == pytest.approx(2e3)
    assert int(st.step) == 2


# -------------------------------------------------------------- gradients
GRAD_CASES = {  # name: (arch, config overrides, batch seed)
    "qwen2": ("qwen2-1.5b", {}, 0),
    "deepseek_dense": ("deepseek-v2-lite-16b", {}, 0),
    "deepseek_dispatch": ("deepseek-v2-lite-16b", {"impl": "dispatch"}, 3),
    "mamba2": ("mamba2-370m", {}, 0),
    "jamba": ("jamba-1.5-large-398b", {}, 0),
    "whisper": ("whisper-small", {}, 0),
}


def _grad_pair(name):
    arch, moe, seed = GRAD_CASES[name]
    jcfg = _f32(arch)
    if moe:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=16.0, **moe))
    return (*model_pair(jcfg, use_pallas_attention=True),
            _batch(jcfg, seed=seed))


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_loss_backward_matches_jax_grad(name):
    """``Model.loss(...).backward()`` against ``jax.grad(model.loss)``,
    leaf for leaf; the port on its kernel routes (their plain versions on
    the CPU)."""
    jm, jp, tm, tp, b = _grad_pair(name)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jm.loss(p, _jb(b)), has_aux=True)(jp)
    for p in leaves_with_keys(tp).values():
        p.requires_grad_(True)
    tl, _ = tm.loss(tp, _tb(b))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    _hold_grads(jg, tree_map(lambda p: p.grad, tp), name)


@pytest.mark.parametrize("n", [2, 4])
def test_microbatched_grads_match_one_batch_and_jax(n):
    jm, jp, tm, tp, _ = _grad_pair("qwen2")
    b = _batch(jm.cfg, B=4, S=8, seed=5)
    jcfg = jstep.TrainStepConfig(num_microbatches=n)
    tcfg = tstep.TrainStepConfig(num_microbatches=n)
    jg, jmet = jstep.make_grad_fn(jm, jcfg)(jp, _jb(b))
    tg, tmet = tstep.make_grad_fn(tm, tcfg)(tp, _tb(b))
    _hold_grads(jg, tg, f"n={n}")
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-5, err_msg=k)
    one, _ = tstep.make_grad_fn(tm, tstep.TrainStepConfig())(tp, _tb(b))
    for k, v in torch_leaves(one).items():
        np.testing.assert_allclose(torch_leaves(tg)[k], v, rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_split_micro_refuses_a_ragged_batch():
    with pytest.raises(ValueError, match="not divisible"):
        tstep._split_micro({"tokens": torch.zeros(5, 3)}, 2)


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("name", ["qwen2", "mamba2", "whisper",
                                  "deepseek_dense"])
def test_remat_is_bit_equal_to_no_remat(name, policy):
    """``cfg.remat`` recomputes the same numbers: loss and every gradient
    bit-equal to the run without it, on the CPU."""
    _, _, tm, tp, b = _grad_pair(name)
    from repro_torch.models import Model

    grads = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tm.cfg, remat=remat, remat_policy=policy)
        g, met = tstep.make_grad_fn(Model(cfg, device="cpu"),
                                    tstep.TrainStepConfig())(tp, _tb(b))
        grads[remat] = (torch_leaves(g), float(met["loss"]))
    assert grads[True][1] == grads[False][1]
    for k, v in grads[False][0].items():
        np.testing.assert_array_equal(grads[True][0][k], v, err_msg=k)


def test_remat_recomputes_the_blocks():
    """Under remat the blocks run twice per step (forward and recompute);
    under no_grad (serving) once, with no checkpoint."""
    from repro_torch.models import Model, transformer

    _, _, tm, tp, b = _grad_pair("qwen2")
    calls = []
    real = transformer._apply_block

    def counting(*a, **kw):
        calls.append(kw.get("mode"))
        return real(*a, **kw)

    cfg = dataclasses.replace(tm.cfg, remat=True)
    model = Model(cfg, device="cpu")
    try:
        transformer._apply_block = counting
        tstep.make_grad_fn(model, tstep.TrainStepConfig())(tp, _tb(b))
        assert len(calls) == 2 * cfg.n_blocks
        calls.clear()
        with torch.no_grad():
            model.loss(tp, _tb(b))
        assert len(calls) == cfg.n_blocks
    finally:
        transformer._apply_block = real


def test_train_step_trajectory_matches_jax():
    """Five AdamW steps of ``make_train_step`` on five batches: the loss
    trajectory within TRAJ_RTOL of the JAX package's."""
    jm, jp, tm, tp, _ = _grad_pair("qwen2")
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5)
    jcfg, tcfg = joptim.AdamWConfig(**kw), toptim.AdamWConfig(**kw)
    jfn = jax.jit(jstep.make_train_step(jm, jcfg))
    tfn = tstep.make_train_step(tm, tcfg)
    js, ts = joptim.init_opt_state(jp, jcfg), toptim.init_opt_state(tp, tcfg)
    jloss, tloss = [], []
    for i in range(5):
        b = _batch(jm.cfg, seed=20 + i)
        jp, js, jmet = jfn(jp, js, _jb(b))
        tp, ts, tmet = tfn(tp, ts, _tb(b))
        jloss.append(float(jmet["loss"]))
        tloss.append(float(tmet["loss"]))
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(tloss, jloss, rtol=TRAJ_RTOL)


# ---------------------------------------------- the kernel routes' Function
def _ssd_inputs(seed=0, b=2, L=32, h=4, g=2, p=16, n=16):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    return (0.5 * f(b, L, h, p), -0.1 * f(b, L, h).abs(), 0.5 * f(b, L, g, n),
            0.5 * f(b, L, g, n))


def _detached(fn, counter):
    """A stand-in for a CUDA kernel: ``fn``'s outputs as fresh tensors
    with no ``grad_fn`` (the kernels write through ``data_ptr()``)."""
    def kernel(*a, **kw):
        counter.append(1)
        with torch.no_grad():
            out = fn(*a, **kw)
        return tuple(o.clone() for o in out) if isinstance(out, tuple) \
            else out.clone()
    return kernel


def _grads(fn, inputs, seed=1):
    """Gradients of a fixed random projection of ``fn``'s outputs."""
    xs = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    rng = np.random.default_rng(seed)
    loss = sum((o * torch.from_numpy(rng.standard_normal(o.shape).astype(
        np.float32))).sum() for o in outs)
    return torch.autograd.grad(loss, xs)


def _routes():
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.ssd_chunk.ops import ssd_plain

    rng = np.random.default_rng(4)
    qkv = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           for s in ((2, 4, 24, 16), (2, 2, 24, 16), (2, 2, 24, 16))]
    return {"ssd": (ssd_plain, _ssd_inputs(), {"chunk": 8}),
            "flash": (attention_ref, qkv, {"causal": True, "kv_len": 20})}


@pytest.mark.parametrize("route", ["ssd", "flash"])
def test_plain_grad_function_is_bit_equal_to_autograd(route):
    """``PlainGrad`` with the plain version as its forward: outputs and
    every input gradient bit-equal to autograd through the plain
    version."""
    plain, inputs, kw = _routes()[route]
    direct = _grads(lambda *x: plain(*x, **kw), inputs)
    wrapped = _grads(lambda *x: PlainGrad.apply(plain, plain, kw, *x),
                     inputs)
    for a, b in zip(direct, wrapped):
        assert torch.equal(a, b)


@pytest.mark.parametrize("route", ["ssd", "flash"])
def test_detached_kernel_route_gets_the_plain_gradient(route):
    """A forward whose outputs carry no grad_fn (as the CUDA kernels'
    do): bare, it drops the gradient (the fault ``with_plain_grad``
    repairs); wrapped, the gradient is the plain version's, bit for bit,
    and the forward ran once."""
    plain, inputs, kw = _routes()[route]
    launches = []
    kernel = _detached(plain, launches)
    direct = _grads(lambda *x: plain(*x, **kw), inputs)
    got = _grads(lambda *x: with_plain_grad(kernel, plain, *x, **kw), inputs)
    assert len(launches) == 1
    for a, b in zip(direct, got):
        assert torch.equal(a, b)
    xs = [t.clone().requires_grad_(True) for t in inputs]
    bare = kernel(*xs, **kw)
    for o in bare if isinstance(bare, tuple) else (bare,):
        assert o.grad_fn is None and not o.requires_grad


def test_plain_ssd_gradient_is_finite_at_strong_decay():
    """The plain SSD's gradient, the kernel route's backward, stays
    finite where exp(acum_i - acum_j) above the diagonal overflows
    (|acum| ~ 300 in a chunk of 64), and its forward is unchanged: L is
    0 there either way."""
    from repro_torch.kernels.ssd_chunk.ops import ssd_plain

    X, _, B, C = _ssd_inputs(L=64)
    Adt = torch.full(X.shape[:3], -5.0)
    grads = _grads(lambda *x: ssd_plain(*x, chunk=64), (X, Adt, B, C))
    assert all(torch.isfinite(g).all() for g in grads)
    from repro_torch.models.mamba import ssd

    Y, _ = ssd_plain(X, Adt, B, C, chunk=64)
    Yp, _ = ssd(X, Adt, B, C, 64, use_pallas=False)
    assert torch.isfinite(Y).all()
    torch.testing.assert_close(Y, Yp, rtol=1e-5, atol=1e-5)


def test_with_plain_grad_costs_inference_nothing():
    """Under inference_mode / no_grad, or with no input requiring a
    gradient, the forward runs alone: no Function node, no saved
    inputs."""
    plain, inputs, kw = _routes()["ssd"]
    launches = []
    kernel = _detached(plain, launches)
    xs = [t.clone().requires_grad_(True) for t in inputs]
    with torch.inference_mode():
        out = with_plain_grad(kernel, plain, *xs, **kw)
    assert all(o.grad_fn is None for o in out)
    with torch.no_grad():
        out = with_plain_grad(kernel, plain, *xs, **kw)
    assert all(o.grad_fn is None for o in out)
    out = with_plain_grad(kernel, plain, *inputs, **kw)
    assert all(o.grad_fn is None for o in out)
    assert len(launches) == 3


@pytest.mark.parametrize("policy", ["none", "full", "dots"])
def test_kernel_route_in_a_mamba_model_under_remat(policy, monkeypatch):
    """Reduced Mamba2 with its SSD route swapped for a detached stand-in
    of the kernel under ``with_plain_grad``: loss and gradients bit-equal
    to the plain route's; the stand-in runs once per layer, twice under
    remat (the recompute re-launches it)."""
    from repro_torch.kernels.ssd_chunk.ops import ssd_plain
    from repro_torch.models import Model, mamba

    _, _, tm, tp, b = _grad_pair("mamba2")
    cfg = dataclasses.replace(tm.cfg, remat=policy != "none",
                              remat_policy="dots" if policy == "dots"
                              else "full")
    model = Model(cfg, device="cpu")
    plain_g, plain_m = tstep.make_grad_fn(model, tstep.TrainStepConfig())(
        tp, _tb(b))
    launches = []
    kernel = _detached(ssd_plain, launches)
    monkeypatch.setattr(mamba, "ssd_chunks", lambda X, Adt, B, C, *, chunk:
                        with_plain_grad(kernel, ssd_plain, X, Adt, B, C,
                                        chunk=chunk))
    got_g, got_m = tstep.make_grad_fn(model, tstep.TrainStepConfig())(
        tp, _tb(b))
    assert len(launches) == cfg.n_layers * (1 if policy == "none" else 2)
    assert float(got_m["loss"]) == float(plain_m["loss"])
    for k, v in torch_leaves(plain_g).items():
        np.testing.assert_array_equal(torch_leaves(got_g)[k], v, err_msg=k)
