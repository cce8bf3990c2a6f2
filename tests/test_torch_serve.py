# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of batched serving (``repro.serve.engine``, ``repro.launch.
serve``): the port's prefill/decode against its own training forward,
and its greedy ``ServeDriver.generate`` against the JAX package's on the
same parameters and inputs."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.serve import ServeDriver as JDriver  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import init_cache  # noqa: E402
from repro_torch.serve import ServeDriver, make_decode_step  # noqa: E402

from _torch_port import TIE, model_pair  # noqa: E402

DENSE = ["whisper-small", "qwen2-1.5b", "phi-3-vision-4.2b", "chatglm3-6b"]


def _frontend(cfg, B, seed):
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.encoder is not None:
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.n_prefix:
        out["prefix"] = rng.standard_normal(
            (B, cfg.n_prefix, cfg.d_model)).astype(np.float32)
    return out


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()} or None


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()} or None


def _pair(arch, dtype="float32"):
    jcfg = dataclasses.replace(jget(arch, reduced=True), dtype=dtype)
    return model_pair(jcfg, use_pallas_attention=True)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_train_logits(arch):
    """Teacher-forced decode reproduces the training forward's logits
    (the port alone; tests/test_serve.py's check)."""
    _, _, model, params = _pair(arch)
    cfg = model.cfg
    B, S = 2, 8
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(
        np.int32))
    fe = _t(_frontend(cfg, B, 2)) or {}
    logits, _ = model.train_logits(params, {"tokens": toks, **fe})
    caches = init_cache(cfg, B, S + cfg.n_prefix + 4, torch.float32,
                        device="cpu")
    last, caches, enc_out = model.prefill(
        params, {"tokens": toks[:, :S - 1], **fe}, caches)
    torch.testing.assert_close(last, logits[:, S - 2], rtol=2e-3, atol=2e-3)
    step, _ = model.decode_step(params, toks[:, S - 1:], caches,
                                S - 1 + cfg.n_prefix, enc_out=enc_out)
    torch.testing.assert_close(step, logits[:, S - 1], rtol=2e-3, atol=2e-3)


def _jax_gaps(jm, jp, prompts, fe, out, n_new):
    """The JAX model's relative top-2 logit gap at every generated token,
    replaying the generated tokens through its prefill and decode."""
    from repro.models import init_cache as jinit_cache

    cfg = jm.cfg
    B, P = prompts.shape
    caches = jinit_cache(cfg, B, P + n_new + cfg.n_prefix + 4, jnp.float32)
    logits, caches, enc = jm.prefill(jp, {"tokens": jnp.asarray(prompts),
                                          **(_j(fe) or {})}, caches)
    steps = [np.asarray(logits)]
    for i in range(n_new - 1):
        logits, caches = jm.decode_step(
            jp, jnp.asarray(out[:, P + i:P + i + 1]), caches,
            jnp.int32(P + i + cfg.n_prefix), enc_out=enc)
        steps.append(np.asarray(logits))
    gaps = []
    for lg in steps:
        top = np.sort(lg, axis=-1)[:, -2:]
        gaps.append((top[:, 1] - top[:, 0]) / np.maximum(1.0,
                                                         np.abs(top[:, 1])))
    return np.array(gaps)


@pytest.mark.parametrize("arch", ["whisper-small", "qwen2-1.5b",
                                  "phi-3-vision-4.2b"])
def test_generate_matches_jax(arch):
    """Greedy tokens equal to the JAX ServeDriver's on a fixture whose top-2
    logit gaps all exceed 1e-4 (relative), so summation order cannot
    flip a token."""
    jm, jp, tm, tp = _pair(arch)
    cfg = jm.cfg
    B, P, n_new = 3, 6, 7
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (B, P)).astype(np.int32)
    fe = _frontend(cfg, B, 1)
    max_seq = P + n_new + cfg.n_prefix + 4
    want = np.asarray(JDriver(model=jm, max_seq=max_seq, batch=B).generate(
        jp, jnp.asarray(prompts), n_new, frontend=_j(fe)))
    gaps = _jax_gaps(jm, jp, prompts, fe, want, n_new)
    assert gaps.min() > TIE, f"near-tie fixture: min gap {gaps.min()}"
    got = ServeDriver(model=tm, max_seq=max_seq, batch=B).generate(
        tp, torch.from_numpy(prompts), n_new, frontend=_t(fe))
    assert got.dtype == torch.int32 and got.shape == (B, P + n_new)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ["whisper-small", "qwen2-1.5b"])
def test_partial_batch(arch):
    """Fewer requests than slots: padded up to the slot count, the output
    masked back to B rows, equal to the same rows in a full batch and to
    the JAX ServeDriver's partial batch."""
    jm, jp, tm, tp = _pair(arch)
    cfg = jm.cfg
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, cfg.vocab, (3, 5)).astype(np.int32)
    fe = _frontend(cfg, 3, 5)
    driver = ServeDriver(model=tm, max_seq=20, batch=3)
    full = driver.generate(tp, torch.from_numpy(prompts), 5,
                           frontend=_t(fe))
    part = driver.generate(tp, torch.from_numpy(prompts[:2]), 5,
                           frontend=_t({k: v[:2] for k, v in fe.items()}))
    assert part.shape == (2, 10)
    torch.testing.assert_close(part, full[:2])
    jpart = JDriver(model=jm, max_seq=20, batch=3).generate(
        jp, jnp.asarray(prompts[:2]), 5,
        frontend=_j({k: v[:2] for k, v in fe.items()}))
    np.testing.assert_array_equal(part.numpy(), np.asarray(jpart))
    with pytest.raises(ValueError, match="slot count"):
        driver.generate(tp, torch.zeros((4, 5), dtype=torch.int32), 2,
                        frontend=_t(_frontend(cfg, 4, 0)))


def test_bf16_generate_runs():
    """The config's own dtype: tokens in range, prompts kept."""
    _, _, tm, tp = _pair("whisper-small", dtype="bfloat16")
    prompts = torch.randint(0, tm.cfg.vocab, (2, 4),
                            generator=torch.Generator().manual_seed(0),
                            dtype=torch.int32)
    out = ServeDriver(model=tm, max_seq=16, batch=2).generate(
        tp, prompts, 4, frontend=_t(_frontend(tm.cfg, 2, 0)))
    assert torch.equal(out[:, :4], prompts)
    assert 0 <= int(out.min()) and int(out.max()) < tm.cfg.vocab


def test_decode_step_sampling_is_greedy_only():
    _, _, tm, _ = _pair("whisper-small")
    with pytest.raises(ValueError):
        make_decode_step(tm, sample="top_k")


def test_launcher_runs_on_the_cpu(capsys):
    out = launch_serve.main(["--arch", "whisper-small", "--reduced",
                             "--device", "cpu", "--batch", "2",
                             "--prompt-len", "4", "--new-tokens", "3"])
    assert tuple(out.shape) == (2, 7)
    assert "whisper-small on cpu" in capsys.readouterr().out


def test_launcher_takes_the_flash_attention_route(monkeypatch):
    """Every encoder layer of a generate goes through the flash-attention
    entry (the kernel on the card, its plain version here)."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention

    calls = []
    route = attention.flash_attention

    def counted(*a, **kw):
        calls.append(kw.get("causal"))
        return route(*a, **kw)

    monkeypatch.setattr(attention, "flash_attention", counted)
    launch_serve.main(["--arch", "whisper-small", "--reduced", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "4",
                       "--new-tokens", "3"])
    n_enc = get_config("whisper-small", reduced=True).encoder.n_layers
    assert calls == [False] * n_enc


def test_launcher_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--arch", "whisper-small", "--reduced"])
