# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Every architecture of the registry (``repro_torch.configs``) held
against the JAX package's (``repro.configs``): the configurations field
for field, the parameter layout key for key at full size, and, at
reduced size on the same parameters (the JAX init carried across by
``model_params_from_jax``), the training forward with its MoE aux loss,
the loss, prefill and decode, float32 within TOL; greedy generation
token for token for the MoE and hybrid models.  The counts, helpers and
the parameter trees of all ten are in tests/test_torch_models.py."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.configs import all_archs as jall  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import model_spec as jmodel_spec  # noqa: E402
from repro.serve import ServeDriver as JDriver  # noqa: E402
from repro_torch.configs import all_archs, get_config  # noqa: E402
from repro_torch.models import init_cache, model_spec  # noqa: E402
from repro_torch.serve import ServeDriver  # noqa: E402

from _torch_port import (TIE, jax_leaves, model_pair,  # noqa: E402
                         port_config, torch_leaves)
from test_torch_serve import _jax_gaps  # noqa: E402

ARCHS = jall()
MOE = ["grok-1-314b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b"]
# held by tests/test_torch_models.py's train / prefill / decode test
DENSE = ["whisper-small", "qwen2-1.5b", "phi-3-vision-4.2b", "chatglm3-6b"]
TOL = 1e-4  # f32 logits through a few layers, XLA vs ATen summation order


def _f32(arch, **kw):
    return dataclasses.replace(jget(arch, reduced=True), dtype="float32",
                               **kw)


def _batch(cfg, B, S, seed=0):
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


def _np(x):
    return np.asarray(x, np.float32)


def _defs(spec, prefix=""):
    """Flat {path: (shape, axes, init, dtype)} of a spec tree of either
    package."""
    out = {}
    for k, v in spec.items():
        if isinstance(v, dict):
            out.update(_defs(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(v.shape), tuple(v.axes), v.init,
                               v.dtype)
    return out


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_jax(arch, reduced):
    assert get_config(arch, reduced=reduced) == port_config(
        jget(arch, reduced=reduced))


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_layout_equals_jax(arch):
    """Key for key, shape for shape, with the logical axes and inits."""
    assert _defs(model_spec(get_config(arch))) == _defs(
        jmodel_spec(jget(arch)))


@pytest.mark.parametrize("name", ["CONFIG", "reduced"])
def test_paper_ivm_equals_jax(name):
    from repro.configs import paper_ivm as jivm
    from repro_torch.configs import paper_ivm as tivm

    j = getattr(jivm, name)
    t = getattr(tivm, name)
    j, t = (j() if callable(j) else j), (t() if callable(t) else t)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.lengthscale == j.lengthscale
    for regime in ("batch", "stream"):
        assert (dataclasses.replace(t, regime=regime).lengthscale
                == dataclasses.replace(j, regime=regime).lengthscale)
    assert "paper-ivm" not in all_archs()


# --------------------------------------------------------------- model
def _caches_match(jc, tc, msg):
    """Cache leaves: the same keys, shapes and dtypes, values within TOL
    (a state deep in the stack carries every layer's rounding)."""
    jl, tl = jax_leaves(jc), torch_leaves(tc)
    assert set(jl) == set(tl), set(jl) ^ set(tl)
    for k in sorted(jl):
        assert (jl[k].shape, jl[k].dtype) == (tl[k].shape, tl[k].dtype), k
        np.testing.assert_allclose(tl[k], jl[k], rtol=TOL, atol=TOL,
                                   err_msg=f"{msg} {k}")


def _train(jm, jp, tm, tp, b):
    want, jaux = jm.train_logits(jp, _jb(b))
    got, taux = tm.train_logits(tp, _tb(b))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                               atol=1e-6)
    jl, jparts = jm.loss(jp, _jb(b))
    tl, tparts = tm.loss(tp, _tb(b))
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(tparts[k]), float(jparts[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-6)
    return float(taux)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in DENSE])
def test_train_prefill_decode_match_jax(arch):
    """train_logits and aux, loss, prefill's logits and caches, two decode
    steps and their caches, float32, the port on its kernel routes (their
    plain versions on the CPU); the other four architectures in
    tests/test_torch_models.py."""
    jm, jp, tm, tp = model_pair(_f32(arch), use_pallas_attention=True)
    cfg = jm.cfg
    B, S = 2, 8
    b = _batch(cfg, B, S)
    aux = _train(jm, jp, tm, tp, b)
    assert (aux > 0) == (arch in MOE)

    max_seq = S + cfg.n_prefix + 4
    pre = dict(b, tokens=b["tokens"][:, :S - 2])
    jl, jc, je = jm.prefill(jp, _jb(pre), jinit_cache(cfg, B, max_seq,
                                                      jnp.float32))
    tl, tc, te = tm.prefill(tp, _tb(pre), init_cache(
        tm.cfg, B, max_seq, torch.float32, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=TOL, atol=TOL)
    _caches_match(jc, tc, "prefill")
    for t in (S - 2, S - 1):
        pos = t + cfg.n_prefix
        jd, jc = jm.decode_step(jp, jnp.asarray(b["tokens"][:, t:t + 1]), jc,
                                jnp.int32(pos), enc_out=je)
        td, tc = tm.decode_step(tp, torch.from_numpy(b["tokens"][:, t:t + 1]),
                                tc, pos, enc_out=te)
        np.testing.assert_allclose(td.numpy(), _np(jd), rtol=TOL, atol=TOL,
                                   err_msg=f"decode at {pos}")
        _caches_match(jc, tc, f"decode at {pos}")


@pytest.mark.parametrize("arch", MOE)
def test_dispatch_route_matches_jax(arch):
    """The MoE models on ``impl="dispatch"``: at the config's capacity
    (drops included) and at a capacity that drops nothing."""
    for factor in (1.25, 16.0):
        jcfg = _f32(arch)
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, impl="dispatch", capacity_factor=factor))
        jm, jp, tm, tp = model_pair(jcfg, use_pallas_attention=True)
        _train(jm, jp, tm, tp, _batch(jcfg, 2, 8, seed=3))


@pytest.mark.parametrize("arch", MOE)
def test_bf16_train_logits_within_rounding(arch):
    """The configs' own dtypes (bf16 activations over f32 parameters):
    logits within the reference's bf16 gate."""
    jm, jp, tm, tp = model_pair(jget(arch, reduced=True),
                                use_pallas_attention=True)
    b = _batch(jm.cfg, 2, 8, seed=2)
    want, _ = jm.train_logits(jp, _jb(b))
    got, _ = tm.train_logits(tp, _tb(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("arch", MOE)
def test_generate_matches_jax(arch):
    """Greedy tokens equal to the JAX ServeDriver's on a fixture whose top-2
    logit gaps all exceed TIE (relative)."""
    jm, jp, tm, tp = model_pair(_f32(arch), use_pallas_attention=True)
    B, P, n_new = 3, 6, 7
    prompts = np.random.default_rng(0).integers(
        0, jm.cfg.vocab, (B, P)).astype(np.int32)
    max_seq = P + n_new + 4
    want = np.asarray(JDriver(model=jm, max_seq=max_seq, batch=B).generate(
        jp, jnp.asarray(prompts), n_new))
    gaps = _jax_gaps(jm, jp, prompts, {}, want, n_new)
    assert gaps.min() > TIE, f"near-tie fixture: min gap {gaps.min()}"
    got = ServeDriver(model=tm, max_seq=max_seq, batch=B).generate(
        tp, torch.from_numpy(prompts), n_new)
    assert got.dtype == torch.int32 and got.shape == (B, P + n_new)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", MOE)
def test_launcher_runs_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve as launch_serve

    out = launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "4",
                             "--new-tokens", "3"])
    assert tuple(out.shape) == (2, 7)
    assert f"{arch} on cpu" in capsys.readouterr().out
