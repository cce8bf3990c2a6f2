# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""The port's MoE FFN (``repro_torch.models.moe``) and MLA attention
(``repro_torch.models.attention.mla_*``) held against the JAX package on
the same numpy parameters and inputs, float32, within TOL; the router's
top-k indices and the dispatch's drop set exactly.

Every fixture keeps its router probabilities clear of ties: the gap
between any two of a token's probabilities around its k-th choice
exceeds TIE_P, so ``torch.topk`` and ``jax.lax.top_k`` pick the same
experts.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import config as jconfig  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

from _torch_port import port_config  # noqa: E402

TOL = 1e-4  # f32 through a few matmuls, XLA vs ATen summation order
TIE_P = 1e-5  # router probability gaps around the k-th choice


def _cfg(impl="dense", capacity=1.25, n_shared=0, top_k=2, E=4):
    return jconfig.ModelConfig(
        name="t", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4,
        head_dim=8, d_ff=64, vocab=64, dtype="float32",
        moe=jconfig.MoEConfig(n_experts=E, top_k=top_k, n_shared=n_shared,
                              expert_ff=48, impl=impl,
                              capacity_factor=capacity),
        ffn_pattern="E")


def _params(spec, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return tlayers.tree_map(
        lambda d: (scale * rng.standard_normal(d.shape)).astype(np.float32),
        spec)


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


def _j(p):
    return _tree(p, jnp.asarray)


def _t(p):
    return _tree(p, torch.from_numpy)


def _np(x):
    return np.asarray(x, np.float32)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _assert_tie_free(p, x, top_k):
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ p["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    s = -np.sort(-probs, -1)
    gaps = s[:, :top_k] - s[:, 1:top_k + 1]  # every gap up to the k-th
    assert gaps.min() > TIE_P, f"near-tie router fixture: {gaps.min()}"


# ----------------------------------------------------------------- router
@pytest.mark.parametrize("shape,top_k,E", [((2, 16, 32), 2, 4),
                                           ((40, 32), 2, 4),
                                           ((3, 8, 32), 6, 16)])
def test_route_matches_jax(shape, top_k, E):
    jcfg = _cfg(top_k=top_k, E=E)
    p = _params(jmoe.moe_spec(jcfg), 0, scale=0.2)
    x = _x(1, shape)
    _assert_tie_free(p, x, top_k)
    jv, ji, ja = jmoe._route(_j(p), jnp.asarray(x), jcfg)
    tv, ti, ta = tmoe._route(_t(p), torch.from_numpy(x), port_config(jcfg))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), _np(jv), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    assert tv.dtype == ta.dtype == torch.float32


# -------------------------------------------------------- dense / dispatch
@pytest.mark.parametrize("impl", ["dense", "dispatch"])
@pytest.mark.parametrize("n_shared", [0, 2])
def test_moe_matches_jax(impl, n_shared):
    jcfg = _cfg(impl, n_shared=n_shared)
    p = _params(jmoe.moe_spec(jcfg), 2)
    x = _x(3, (2, 16, 32))
    _assert_tie_free(p, x, 2)
    jy, ja = jmoe.apply_moe(_j(p), jnp.asarray(x), jcfg)
    ty, ta = tmoe.apply_moe(_t(p), torch.from_numpy(x), port_config(jcfg))
    np.testing.assert_allclose(ty.numpy(), _np(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


def _jax_drops(idx, E, cap):
    """The (token, choice) pairs the reference drops: its dispatch order,
    step for step (repro/models/moe.py, moe_dispatch), on its top-k."""
    N, k = idx.shape
    flat_e = idx.reshape(N * k)
    flat_tok = jnp.repeat(jnp.arange(N, dtype=jnp.int32), k)
    order = jnp.argsort(flat_e, stable=True)
    se, stok = flat_e[order], flat_tok[order]
    counts = jnp.zeros((E,), jnp.int32).at[flat_e].add(1)
    starts = jnp.cumsum(counts) - counts
    rank = jnp.arange(N * k, dtype=jnp.int32) - starts[se]
    valid = np.asarray(rank < cap)
    return sorted(zip(np.asarray(stok)[~valid].tolist(),
                      np.asarray(se)[~valid].tolist()))


@pytest.mark.parametrize("n_shared", [0, 1])
def test_dispatch_drops_the_same_tokens_as_jax(n_shared):
    """At capacity 0.25 most pairs overflow: the port drops exactly the
    reference's pairs, and y agrees within TOL."""
    jcfg = _cfg("dispatch", capacity=0.25, n_shared=n_shared)
    tcfg = port_config(jcfg)
    p = _params(jmoe.moe_spec(jcfg), 4)
    x = _x(5, (2, 64, 32))
    _assert_tie_free(p, x, 2)
    N = 2 * 64
    cap = tmoe.capacity(tcfg, N)
    assert cap == 16  # 128 tokens * 2 / 4 experts * 0.25
    _, jidx, _ = jmoe._route(_j(p), jnp.asarray(x.reshape(N, 32)), jcfg)
    _, tidx, _ = tmoe._route(_t(p), torch.from_numpy(x.reshape(N, 32)), tcfg)
    order, slot, valid = tmoe.dispatch_slots(tidx, 4, cap)
    stok = torch.arange(N).repeat_interleave(2)[order]
    se = tidx.reshape(-1)[order]
    got = sorted(zip(stok[~valid].tolist(), se[~valid].tolist()))
    want = _jax_drops(jidx, 4, cap)
    assert got == want and len(want) > N  # most of the 256 pairs drop
    assert bool((slot[~valid] == 4 * cap).all())
    jy, _ = jmoe.apply_moe(_j(p), jnp.asarray(x), jcfg)
    ty, _ = tmoe.apply_moe(_t(p), torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), _np(jy), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_tokens,factor,want", [
    (32, 8.0, 128), (128, 0.25, 16), (7, 1.25, 8), (100, 1.0, 56),
    (4096, 64 / 6, 4096)])
def test_capacity_rounds_up_to_eight(n_tokens, factor, want):
    jcfg = _cfg(capacity=factor, top_k=2 if want != 4096 else 6,
                E=4 if want != 4096 else 64)
    tcfg = port_config(jcfg)
    m = jcfg.moe
    cap = int(n_tokens * m.top_k / m.n_experts * m.capacity_factor)
    ref = max(8, cap - cap % 8 + (8 if cap % 8 else 0))
    assert tmoe.capacity(tcfg, n_tokens) == ref == want


def test_dispatch_equals_dense_at_big_capacity():
    """No drops at capacity 8: dispatch equals dense, as in the reference
    (tests/test_model_components.py:69-79), and both equal JAX's dense."""
    jcfg = _cfg("dense", n_shared=1)
    p = _params(jmoe.moe_spec(jcfg), 6)
    x = _x(7, (2, 16, 32))
    _assert_tie_free(p, x, 2)
    yd, ad = tmoe.apply_moe(_t(p), torch.from_numpy(x), port_config(jcfg))
    ys, as_ = tmoe.apply_moe(_t(p), torch.from_numpy(x), port_config(
        dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, impl="dispatch", capacity_factor=8.0))))
    torch.testing.assert_close(ys, yd, rtol=2e-4, atol=2e-5)
    assert float(as_) == float(ad)
    jy, _ = jmoe.apply_moe(_j(p), jnp.asarray(x), jcfg)
    np.testing.assert_allclose(ys.numpy(), _np(jy), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", ["dense", "dispatch"])
def test_moe_bf16_matches_jax(impl):
    """bf16 activations over f32 weights (the configs' dtypes): y within
    the reference's bf16 gate."""
    jcfg = dataclasses.replace(_cfg(impl, capacity=8.0, n_shared=1),
                               dtype="bfloat16")
    p = _params(jmoe.moe_spec(jcfg), 8)
    x = _x(9, (2, 16, 32))
    jy, _ = jmoe.apply_moe(_j(p), jnp.asarray(x, jnp.bfloat16), jcfg)
    ty, _ = tmoe.apply_moe(_t(p), torch.from_numpy(x).to(torch.bfloat16),
                           port_config(jcfg))
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(), _np(jy), rtol=3e-2,
                               atol=3e-2)


# ------------------------------------------------------------------- MLA
def _mla_cfg():
    from repro.configs import get_config as jget

    return dataclasses.replace(jget("deepseek-v2-lite-16b", reduced=True),
                               dtype="float32", attn_chunk=4)


def test_chunked_attention_takes_a_narrower_v():
    """qk width 24 against v width 16 (MLA's 192 / 128 at small size),
    several query chunks."""
    q, k = _x(10, (2, 9, 4, 24)), _x(11, (2, 9, 4, 24))
    v = _x(12, (2, 9, 4, 16))
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True, chunk=4)
    got = tattn.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=True, chunk=4)
    assert got.shape == (2, 9, 4, 16)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_mla_train_matches_jax():
    jcfg = _mla_cfg()
    p = _params(jattn.mla_spec(jcfg), 13)
    x = _x(14, (2, 11, jcfg.d_model))
    want = jattn.mla_train(_j(p), jnp.asarray(x), jcfg)
    got = tattn.mla_train(_t(p), torch.from_numpy(x), port_config(jcfg))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


def test_mla_prefill_and_decode_match_jax():
    """Prefill writes the compressed cache (ckv, krope) as the reference
    does; three absorbed decode steps then match it, cache and output."""
    jcfg = _mla_cfg()
    tcfg = port_config(jcfg)
    p = _params(jattn.mla_spec(jcfg), 15)
    B, S, T = 2, 6, 12
    x = _x(16, (B, S + 3, jcfg.d_model))
    jc = jattn.mla_init_cache(jcfg, B, T, jnp.float32)
    tc = tattn.mla_init_cache(tcfg, B, T, torch.float32, "cpu")
    jy, jc = jattn.mla_prefill(_j(p), jnp.asarray(x[:, :S]), jc, jcfg)
    ty, tc = tattn.mla_prefill(_t(p), torch.from_numpy(x[:, :S]), tc, tcfg)
    np.testing.assert_allclose(ty.numpy(), _np(jy), rtol=TOL, atol=TOL)
    for key in ("ckv", "krope"):
        np.testing.assert_allclose(tc[key].numpy(), _np(jc[key]), rtol=TOL,
                                   atol=TOL, err_msg=key)
    for t in range(S, S + 3):
        jy, jc = jattn.mla_decode(_j(p), jnp.asarray(x[:, t:t + 1]), jc,
                                  jnp.int32(t), jcfg)
        ty, tc = tattn.mla_decode(_t(p), torch.from_numpy(x[:, t:t + 1]),
                                  tc, t, tcfg)
        np.testing.assert_allclose(ty.numpy(), _np(jy), rtol=TOL, atol=TOL,
                                   err_msg=f"decode at {t}")
        for key in ("ckv", "krope"):
            np.testing.assert_allclose(tc[key].numpy(), _np(jc[key]),
                                       rtol=TOL, atol=TOL, err_msg=key)


# ------------------------------------------------------------ parameters
@pytest.mark.parametrize("init,shape", [("lecun", (3, 5, 7)),
                                        ("normal:0.02", (64, 9)),
                                        ("lecun", (11,))])
def test_leaf_init_scales_in_place_with_the_same_values(init, shape):
    """The in-place scale draws the very values of ``std * randn``."""
    d = tlayers.ParamDef(shape, (None,) * len(shape), init)
    got = tlayers._leaf_init(d, torch.Generator().manual_seed(3), "cpu")
    std = (float(init.split(":")[1]) if init.startswith("normal:")
           else (shape[0] if len(shape) == 1
                 else int(np.prod(shape[:-1]))) ** -0.5)
    want = std * torch.randn(shape, generator=torch.Generator().manual_seed(
        3))
    assert torch.equal(got, want)
