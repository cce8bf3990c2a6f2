# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of the Mamba2 layer (``repro.models.mamba``) and of Mamba2-370m
serving (``repro.configs.mamba2_370m`` through ``Model`` and
``ServeDriver``), held against the JAX package on the reduced config in
float32, with the JAX parameters carried across by
``model_params_from_jax``.

The port's train and prefill take the SSD kernel route
(``ssd(..., use_pallas=True)``, the plain version on a CPU tensor); the
JAX layer takes its einsum route; the two compute the same function.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.serve import ServeDriver as JDriver  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import Model, init_cache  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models.layers import tree_map  # noqa: E402
from repro_torch.serve import ServeDriver  # noqa: E402
from repro_torch.tree import leaves_with_keys  # noqa: E402

from _torch_port import (TIE, assert_leaves_match, jax_leaves,  # noqa: E402
                         model_pair, port_config, torch_leaves)

ARCH = "mamba2-370m"
TOL = 1e-4  # f32 through a few layers, XLA vs ATen summation order


def _f32():
    return dataclasses.replace(jget(ARCH, reduced=True), dtype="float32")


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol,
                               atol=tol)


def _layer_params(cfg, seed):
    """Random values for every leaf of one Mamba layer (the decay A_log
    and dt_bias too, so the heads decay at different rates)."""
    rng = np.random.default_rng(seed)
    spec = tmamba.mamba_spec(port_config(cfg))
    return {k: (0.3 * rng.standard_normal(d.shape)).astype(np.float32)
            for k, d in spec.items()}


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_jax(reduced):
    j = jget(ARCH, reduced=reduced)
    t = get_config(ARCH, reduced=reduced)
    assert t == port_config(j)
    assert (t.n_blocks, t.param_count()) == (j.n_blocks, j.param_count())
    assert all(t.layer_kind(i) == "M" for i in range(t.n_layers))


def test_param_count():
    cfg = get_config(ARCH)
    assert cfg.param_count() == jget(ARCH).param_count() == 368_276_992
    assert 0.3e9 <= cfg.param_count() <= 0.45e9
    # the parameter tree itself (the analytic count above is the JAX
    # package's formula: it counts two norms per layer and no conv bias)
    sizes = []
    tree_map(lambda d: sizes.append(int(np.prod(d.shape))),
             Model(cfg, device="cpu").spec())
    jtree = JModel(jget(ARCH)).abstract_params()
    assert sum(sizes) == sum(int(np.prod(v.shape)) for v in
                             jax.tree_util.tree_leaves(jtree)) == 368_338_432


def test_model_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None legitimately runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(get_config(ARCH, reduced=True))


# ---------------------------------------------------------------- layer
@pytest.mark.parametrize("S", [16, 21])  # one whole chunk; padded to two
def test_layer_train_prefill_decode_match_jax(S):
    """mamba_train, mamba_prefill (output, conv cache, ssm state) and one
    mamba_decode step against JAX, float32."""
    jcfg = _f32()
    tcfg = port_config(jcfg)
    p = _layer_params(jcfg, S)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    B = 2
    x = np.random.default_rng(1).standard_normal(
        (B, S + 1, jcfg.d_model)).astype(np.float32)
    _close(tmamba.mamba_train(tp, torch.from_numpy(x[:, :S]), tcfg),
           jmamba.mamba_train(jp, jnp.asarray(x[:, :S]), jcfg))

    jc0 = jmamba.mamba_init_cache(jcfg, B, jnp.float32)
    tc = tmamba.mamba_init_cache(tcfg, B, torch.float32, "cpu")
    conv, ssm = tc["conv"], tc["ssm"]
    jout, jc = jmamba.mamba_prefill(jp, jnp.asarray(x[:, :S]), jc0, jcfg)
    tout, tc = tmamba.mamba_prefill(tp, torch.from_numpy(x[:, :S]), tc, tcfg)
    assert tc["conv"] is conv and tc["ssm"] is ssm  # written in place
    _close(tout, jout)
    assert_leaves_match(jax_leaves(jc), torch_leaves(tc))

    jout, jc = jmamba.mamba_decode(jp, jnp.asarray(x[:, S:]), jc, jcfg)
    tout, tc = tmamba.mamba_decode(tp, torch.from_numpy(x[:, S:]), tc, tcfg)
    assert tc["conv"] is conv and tc["ssm"] is ssm
    _close(tout, jout)
    assert_leaves_match(jax_leaves(jc), torch_leaves(tc))


def test_layer_takes_the_ssd_chunks_route(monkeypatch):
    """Train and prefill send the intra-chunk term through ``ssd_chunks``
    (the kernel on the card), once per call; decode never does."""
    cfg = port_config(_f32())
    tp = {k: torch.from_numpy(v) for k, v in _layer_params(cfg, 0).items()}
    calls = []
    route = tmamba.ssd_chunks

    def counted(*a, **kw):
        calls.append(kw["chunk"])
        return route(*a, **kw)

    monkeypatch.setattr(tmamba, "ssd_chunks", counted)
    x = torch.randn(2, 20, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    tmamba.mamba_train(tp, x, cfg)
    cache = tmamba.mamba_init_cache(cfg, 2, torch.float32, "cpu")
    tmamba.mamba_prefill(tp, x, cache, cfg)
    assert calls == [cfg.ssm.chunk] * 2
    tmamba.mamba_decode(tp, x[:, :1], cache, cfg)
    assert len(calls) == 2


# ---------------------------------------------------------------- model
def test_init_cache_shapes():
    cfg = get_config(ARCH, reduced=True)
    caches = init_cache(cfg, 3, 99, device="cpu")
    c = caches["blocks"]["l0"]
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    assert tuple(c["conv"].shape) == (cfg.n_blocks, 3, s.conv_width - 1,
                                      di + 2 * s.d_state)
    assert tuple(c["ssm"].shape) == (cfg.n_blocks, 3, s.n_heads(cfg.d_model),
                                     s.head_dim, s.d_state)
    assert c["conv"].dtype == torch.bfloat16 and c["ssm"].dtype == \
        torch.float32
    jc = jinit_cache(jget(ARCH, reduced=True), 3, 99)
    assert {k: v.shape for k, v in jax_leaves(jc).items()} == {
        k: tuple(v.shape) for k, v in leaves_with_keys(caches).items()}


def test_model_train_prefill_decode_match_jax():
    """train_logits, prefill's last logits and caches, a decode step,
    float32, across a padded chunk boundary (S = 20, chunk 16)."""
    jm, jp, tm, tp = model_pair(_f32())
    cfg = jm.cfg
    B, S = 2, 20
    toks = _tokens(cfg, B, S)
    want, _ = jm.train_logits(jp, {"tokens": jnp.asarray(toks)})
    got, aux = tm.train_logits(tp, {"tokens": torch.from_numpy(toks)})
    _close(got, want)
    assert float(aux) == 0.0

    jl, jc, je = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S - 1])},
                            jinit_cache(cfg, B, S + 4, jnp.float32))
    tl, tc, te = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S - 1])},
                            init_cache(tm.cfg, B, S + 4, torch.float32,
                                       device="cpu"))
    assert je is None and te is None
    _close(tl, jl)
    assert_leaves_match(jax_leaves(jc), torch_leaves(tc))
    jd, jc = jm.decode_step(jp, jnp.asarray(toks[:, S - 1:]), jc,
                            jnp.int32(S - 1))
    td, tc = tm.decode_step(tp, torch.from_numpy(toks[:, S - 1:]), tc, S - 1)
    _close(td, jd)
    assert_leaves_match(jax_leaves(jc), torch_leaves(tc))


@pytest.mark.parametrize("P", [2, 13])  # shorter than the conv window; not
def test_prefill_decode_match_train_logits(P):
    """Teacher-forced decode reproduces the training forward's logits (the
    port alone, tests/test_serve.py's check): the stacked caches are
    written in place, or decode would run from zero state."""
    _, _, tm, tp = model_pair(_f32())
    cfg = tm.cfg
    B, S = 2, P + 4
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=P))
    logits, _ = tm.train_logits(tp, {"tokens": toks})
    caches = init_cache(cfg, B, S, torch.float32, device="cpu")
    last, caches, _ = tm.prefill(tp, {"tokens": toks[:, :P]}, caches)
    torch.testing.assert_close(last, logits[:, P - 1], rtol=TOL, atol=TOL)
    assert caches["blocks"]["l0"]["ssm"].abs().max() > 0
    for t in range(P, S):
        step, caches = tm.decode_step(tp, toks[:, t:t + 1], caches, t)
        torch.testing.assert_close(step, logits[:, t], rtol=TOL, atol=TOL)


def test_bf16_train_logits_within_rounding():
    """The config's own dtype (bf16 activations over f32 weights): the
    port's kernel-route states are float32 where the JAX layer's einsum
    route keeps bf16, so the two agree to a rounding bound only."""
    jm, jp, tm, tp = model_pair(jget(ARCH, reduced=True))
    toks = _tokens(jm.cfg, 2, 20, seed=5)
    want, _ = jm.train_logits(jp, {"tokens": jnp.asarray(toks)})
    got, _ = tm.train_logits(tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    _close(got, want, 5e-2)


# -------------------------------------------------------------- serving
def _jax_gaps(jm, jp, prompts, out, n_new):
    """The JAX model's relative top-2 logit gap at every generated token."""
    B, P = prompts.shape
    caches = jinit_cache(jm.cfg, B, P + n_new + 4, jnp.float32)
    logits, caches, _ = jm.prefill(jp, {"tokens": jnp.asarray(prompts)},
                                   caches)
    steps = [np.asarray(logits)]
    for i in range(n_new - 1):
        logits, caches = jm.decode_step(
            jp, jnp.asarray(out[:, P + i:P + i + 1]), caches,
            jnp.int32(P + i))
        steps.append(np.asarray(logits))
    top = np.sort(np.stack(steps), axis=-1)[..., -2:]
    return (top[..., 1] - top[..., 0]) / np.maximum(1.0, np.abs(top[..., 1]))


def test_generate_matches_jax():
    """Greedy tokens equal to the JAX ServeDriver's on a fixture whose top-2
    logit gaps all exceed 1e-4 (relative)."""
    jm, jp, tm, tp = model_pair(_f32())
    B, P, n_new = 3, 19, 7
    prompts = _tokens(jm.cfg, B, P, seed=2)
    max_seq = P + n_new + 4
    want = np.asarray(JDriver(model=jm, max_seq=max_seq, batch=B).generate(
        jp, jnp.asarray(prompts), n_new))
    gaps = _jax_gaps(jm, jp, prompts, want, n_new)
    assert gaps.min() > TIE, f"near-tie fixture: min gap {gaps.min()}"
    got = ServeDriver(model=tm, max_seq=max_seq, batch=B).generate(
        tp, torch.from_numpy(prompts), n_new)
    assert got.dtype == torch.int32 and got.shape == (B, P + n_new)
    np.testing.assert_array_equal(got.numpy(), want)


def test_partial_batch():
    """Fewer requests than slots: padded up to the slot count and dropped
    again, equal to the same rows of a full batch and to the JAX
    ServeDriver's partial batch."""
    jm, jp, tm, tp = model_pair(_f32())
    prompts = _tokens(jm.cfg, 3, 9, seed=4)
    driver = ServeDriver(model=tm, max_seq=20, batch=3)
    full = driver.generate(tp, torch.from_numpy(prompts), 5)
    part = driver.generate(tp, torch.from_numpy(prompts[:2]), 5)
    assert part.shape == (2, 14)
    torch.testing.assert_close(part, full[:2])
    jpart = JDriver(model=jm, max_seq=20, batch=3).generate(
        jp, jnp.asarray(prompts[:2]), 5)
    np.testing.assert_array_equal(part.numpy(), np.asarray(jpart))


def test_launcher_runs_on_the_cpu(capsys, monkeypatch):
    """``launch.serve --arch mamba2-370m``: every layer's prefill goes
    through ``ssd_chunks`` once per generate, decode never."""
    calls = []
    route = tmamba.ssd_chunks

    def counted(*a, **kw):
        calls.append(kw["chunk"])
        return route(*a, **kw)

    monkeypatch.setattr(tmamba, "ssd_chunks", counted)
    out = launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "20",
                             "--new-tokens", "3"])
    assert tuple(out.shape) == (2, 23)
    assert "mamba2-370m on cpu" in capsys.readouterr().out
    cfg = get_config(ARCH, reduced=True)
    assert calls == [cfg.ssm.chunk] * cfg.n_layers
