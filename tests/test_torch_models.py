# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of the model stack (``repro.models``, ``repro.configs``) held
against the JAX package on the same numpy inputs and the same
parameters (the JAX init carried across by ``model_params_from_jax``).

The port runs with ``use_pallas_attention=True`` (its kernel route,
which is the plain attention on a CPU tensor); the JAX package runs its
chunked attention, since its kernel route needs a TPU, and the two
compute the same function.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import config as jconfig  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import all_archs, get_config  # noqa: E402
from repro_torch.models import Model, init_cache  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

from _torch_port import (assert_leaves_match, jax_leaves,  # noqa: E402
                         model_pair, port_config, torch_leaves)

# the reduced configs whose layers the port runs (attention + dense FFN)
DENSE = ["whisper-small", "qwen2-1.5b", "phi-3-vision-4.2b", "chatglm3-6b"]
ALL = ["grok-1-314b", "deepseek-v2-lite-16b", "whisper-small", "qwen2-1.5b",
       "chatglm3-6b", "phi3-mini-3.8b", "mistral-nemo-12b",
       "jamba-1.5-large-398b", "mamba2-370m", "phi-3-vision-4.2b"]
TOL = 1e-4  # f32 logits through a few layers, XLA vs ATen summation order


def _rng(seed):
    return np.random.default_rng(seed)


def _np(x):
    return np.asarray(x, np.float32)


def _f32(arch):
    return dataclasses.replace(jget(arch, reduced=True), dtype="float32")


def _batch(cfg, B, S, seed=0):
    rng = _rng(seed)
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


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("name", ["ModelConfig", "EncoderConfig",
                                  "MoEConfig", "MLAConfig", "SSMConfig"])
def test_config_fields_and_defaults_match_jax(name):
    jf = {f.name: f.default for f in dataclasses.fields(getattr(jconfig,
                                                                name))}
    tf = {f.name: f.default for f in dataclasses.fields(getattr(tconfig,
                                                                name))}
    assert jf == tf


@pytest.mark.parametrize("reduced", [False, True])
def test_whisper_config_matches_jax(reduced):
    j = jget("whisper-small", reduced=reduced)
    t = get_config("whisper-small", reduced=reduced)
    assert t == port_config(j)
    assert (t.hd, t.n_blocks, t.param_count()) == (j.hd, j.n_blocks,
                                                   j.param_count())
    assert t.activation_dtype == torch.bfloat16
    o = get_config("whisper-small", use_pallas_attention=True,
                   dtype="float32")
    assert o.use_pallas_attention and o.activation_dtype == torch.float32


@pytest.mark.parametrize("arch", ALL)
def test_param_count_matches_jax(arch):
    j = jget(arch)
    assert port_config(j).param_count() == j.param_count()
    assert port_config(j).active_param_count() == j.active_param_count()
    for name in ("is_hybrid", "is_ssm_only", "sub_quadratic"):
        assert getattr(port_config(j), name) == getattr(j, name), name
    assert [port_config(j).layer_kind(i) for i in range(j.n_layers)] == [
        j.layer_kind(i) for i in range(j.n_layers)]
    assert [port_config(j).ffn_kind(i) for i in range(j.n_layers)] == [
        j.ffn_kind(i) for i in range(j.n_layers)]


def test_whisper_small_size():
    assert 0.2e9 <= get_config("whisper-small").param_count() <= 0.3e9


def test_get_config_registry():
    from repro.configs import all_archs as jall

    assert all_archs() == jall() == ALL
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("gpt-2")


def test_model_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None legitimately runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(get_config("whisper-small", reduced=True))


# ------------------------------------------------------ parameter trees
@pytest.mark.parametrize("arch", ALL)
def test_init_tree_matches_jax_layout(arch):
    """The port's seeded init has the JAX tree's keys, shapes and dtypes;
    constant leaves are equal, random leaves have the JAX init's scale."""
    jcfg = jget(arch, reduced=True)
    jl = jax_leaves(jax.tree_util.tree_map(
        np.asarray, JModel(jcfg).init(jax.random.PRNGKey(0))))
    model = Model(port_config(jcfg), device="cpu")
    tl = torch_leaves(model.init(torch.Generator().manual_seed(0)))
    assert set(jl) == set(tl)
    for k in jl:
        assert (jl[k].shape, jl[k].dtype) == (tl[k].shape, tl[k].dtype), k
        if np.all(jl[k] == jl[k].flat[0]):
            np.testing.assert_array_equal(jl[k], tl[k], err_msg=k)
        elif jl[k].size >= 1000:
            assert abs(tl[k].std() / jl[k].std() - 1) < 0.1, k
    # registered on the module under the same paths
    sd = model.state_dict()
    assert {k.replace(".", "/")[len("params/"):] for k in sd} == set(tl)


@pytest.mark.parametrize("arch", ALL)
def test_model_params_from_jax_key_for_key(arch):
    _, jp, tm, tp = model_pair(_f32(arch))
    jl = jax_leaves(jp)
    assert_leaves_match(jl, torch_leaves(tp))
    for k in jl:  # carried exactly
        assert torch_leaves(tp)[k].tobytes() == jl[k].tobytes(), k


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_jax(kind, dtype):
    rng = _rng(1)
    x = (3 * rng.standard_normal((2, 5, 48)) + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(48).astype(np.float32),
         "bias": rng.standard_normal(48).astype(np.float32)}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jlayers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x, jdt), kind)
    got = tlayers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x).to(getattr(torch, dtype)),
                             kind)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("pos_shape", ["S", "BS", "decode"])
@pytest.mark.parametrize("frac", [1.0, 0.5, 0.1])
def test_rope_matches_jax(frac, pos_shape):
    rng = _rng(2)
    B, S = (2, 1) if pos_shape == "decode" else (2, 7)
    x = rng.standard_normal((B, S, 3, 16)).astype(np.float32)
    pos = {"S": np.arange(S), "BS": rng.integers(0, 500, (B, S)),
           "decode": np.full((1, 1), 37)}[pos_shape].astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), frac=frac,
                              theta=10_000.0)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             frac=frac, theta=10_000.0)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_matches_jax(kind):
    rng = _rng(3)
    spec = tlayers.mlp_spec(24, 40, kind)
    p = {k: (0.2 * rng.standard_normal(d.shape)).astype(np.float32)
         for k, d in spec.items()}
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    want = jlayers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), kind)
    got = tlayers.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), kind)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_embed_lookup_matches_jax():
    rng = _rng(4)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, (3, 4)).astype(np.int32)
    want = jlayers.embed_lookup(jnp.asarray(table), jnp.asarray(ids),
                                jnp.bfloat16)
    got = tlayers.embed_lookup(torch.from_numpy(table),
                               torch.from_numpy(ids), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("S,T,chunk,kv_len,q_offset,causal", [
    (7, 7, 512, None, 0, True), (7, 7, 512, None, 0, False),
    (13, 13, 4, None, 0, True),  # several query chunks, ragged last
    (1, 20, 512, 9, 8, False),  # decode against a cache
    (5, 30, 2, 30, 0, False),  # cross-attention shape
])
def test_chunked_attention_matches_jax(S, T, chunk, kv_len, q_offset,
                                       causal):
    rng = _rng(S + T)
    q = rng.standard_normal((2, S, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, T, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, T, 2, 8)).astype(np.float32)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal, chunk=chunk,
                                   kv_len=kv_len, q_offset=q_offset)
    got = tattn.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  chunk=chunk, kv_len=kv_len,
                                  q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["whisper-small", "qwen2-1.5b"])
@pytest.mark.parametrize("route", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_gqa_train_matches_jax(arch, route, causal):
    """Both routes of the port (kernel route: the plain flash version on
    the CPU; chunked) against JAX's chunked route."""
    jcfg = _f32(arch)
    rng = _rng(5)
    spec = tattn.gqa_spec(port_config(jcfg))
    p = {k: (0.3 * rng.standard_normal(d.shape)).astype(np.float32)
         for k, d in spec.items()}
    x = rng.standard_normal((2, 11, jcfg.d_model)).astype(np.float32)
    want = jattn.gqa_train({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), jcfg, causal=causal)
    got = tattn.gqa_train({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x),
                          port_config(jcfg, use_pallas_attention=route),
                          causal=causal)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_cross_attention_matches_jax():
    jcfg = _f32("whisper-small")
    rng = _rng(6)
    spec = tattn.cross_spec(port_config(jcfg))
    p = {k: (0.3 * rng.standard_normal(d.shape)).astype(np.float32)
         for k, d in spec.items()}
    x = rng.standard_normal((2, 3, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    want = jattn.cross_attend(jp, jnp.asarray(x),
                              jattn.cross_encode(jp, jnp.asarray(enc), jcfg),
                              jcfg)
    tcfg = port_config(jcfg)
    got = tattn.cross_attend(tp, torch.from_numpy(x), tattn.cross_encode(
        tp, torch.from_numpy(enc), tcfg), tcfg)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- model
def test_whisper_encoder_matches_jax():
    jm, jp, tm, tp = model_pair(_f32("whisper-small"),
                                use_pallas_attention=True)
    frames = _batch(jm.cfg, 2, 4)["frames"]
    want = jm._encode(jp, jnp.asarray(frames))
    got = tm._encode(tp, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_train_prefill_decode_match_jax(arch):
    """train_logits, prefill's last logits and a decode step, float32,
    the port on its kernel route."""
    jm, jp, tm, tp = model_pair(_f32(arch), use_pallas_attention=True)
    cfg = jm.cfg
    B, S = 2, 8
    b = _batch(cfg, B, S)
    want, _ = jm.train_logits(jp, _jb(b))
    got, aux = tm.train_logits(tp, _tb(b))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)
    assert float(aux) == 0.0

    max_seq = S + cfg.n_prefix + 4
    pre = dict(b, tokens=b["tokens"][:, :S - 1])
    jl, jc, je = jm.prefill(jp, _jb(pre), jinit_cache(cfg, B, max_seq,
                                                      jnp.float32))
    tl, tc, te = tm.prefill(tp, _tb(pre), init_cache(
        tm.cfg, B, max_seq, torch.float32, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=TOL, atol=TOL)
    assert (te is None) == (je is None)
    assert_leaves_match(jax_leaves(jc), torch_leaves(tc))
    pos = S - 1 + cfg.n_prefix
    jd, jc = jm.decode_step(jp, jnp.asarray(b["tokens"][:, S - 1:]), jc,
                            jnp.int32(pos), enc_out=je)
    td, tc = tm.decode_step(tp, torch.from_numpy(b["tokens"][:, S - 1:]), tc,
                            pos, enc_out=te)
    np.testing.assert_allclose(td.numpy(), _np(jd), rtol=TOL, atol=TOL)
    assert_leaves_match(jax_leaves(jc), torch_leaves(tc))


def test_whisper_bf16_matches_jax():
    """The config's own dtype (bf16 activations over f32 weights):
    logits within the JAX tests' bf16 tolerance."""
    jm, jp, tm, tp = model_pair(jget("whisper-small", reduced=True),
                                use_pallas_attention=True)
    b = _batch(jm.cfg, 2, 6, seed=1)
    want, _ = jm.train_logits(jp, _jb(b))
    got, _ = tm.train_logits(tp, _tb(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=2e-2,
                               atol=2e-2)
