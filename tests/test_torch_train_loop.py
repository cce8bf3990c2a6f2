# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""The port's fault-tolerant loop, compression and launcher
(``repro_torch.train.loop``, ``train.compress``, ``launch.train``) on the
CPU: the twins of tests/test_train_loop.py (the restart bit-equal to the
uninterrupted run) and tests/test_compress.py (``_quantize`` bit-equal
to the JAX package's), a ``(params, opt_state)`` checkpoint written by
either package's ``run_training`` resumed by the other's and matching
its own continuation, and the launcher end to end."""
import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.ckpt import CheckpointStore as JStore  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.data import TokenStreamSpec as JSpec  # noqa: E402
from repro.data import deterministic_batch_fn as jbatch_fn  # noqa: E402
from repro.train import compress as jcompress  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro.train.loop import LoopConfig as JLoopConfig  # noqa: E402
from repro.train.loop import run_training as jrun  # noqa: E402
from repro_torch.ckpt import CheckpointStore, MemoryStore  # noqa: E402
from repro_torch.convert import opt_state_from_jax  # noqa: E402
from repro_torch.data import TokenStreamSpec  # noqa: E402
from repro_torch.data import deterministic_batch_fn  # noqa: E402
from repro_torch.train import compress  # noqa: E402
from repro_torch.train import optim, step  # noqa: E402
from repro_torch.train.loop import LoopConfig, run_training  # noqa: E402
from repro_torch.tree import leaves_with_keys  # noqa: E402

from _torch_port import jax_leaves, model_pair, torch_leaves  # noqa: E402

CROSS_RTOL, CROSS_ATOL = 1e-4, 1e-5  # params after 2 steps, XLA vs ATen


@pytest.fixture(scope="module")
def setup():
    """The reduced qwen2 (2 layers), float32, the JAX init carried across;
    the port's train step, its batch stream; a fresh parameter copy per
    call (the port's step updates in place)."""
    jcfg = dataclasses.replace(jget("qwen2-1.5b", reduced=True), n_layers=2,
                               dtype="float32")
    jm, jp, tm, tp = model_pair(jcfg)
    opt_cfg = optim.AdamWConfig(lr=1e-3, total_steps=20, warmup_steps=2)
    train_step = step.make_train_step(tm, opt_cfg)
    batch_fn = deterministic_batch_fn(
        0, TokenStreamSpec(vocab=jcfg.vocab, seq=16, batch=4), device="cpu")
    return jm, jp, tm, lambda: _clone(tp), opt_cfg, train_step, batch_fn


def _clone(tree):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.detach().clone(), tree)


def test_loss_decreases(setup):
    _, _, _, fresh, opt_cfg, train_step, batch_fn = setup
    p = fresh()
    opt = optim.init_opt_state(p, opt_cfg)
    losses = []
    for _ in range(10):
        p, opt, m = train_step(p, opt, batch_fn(0))  # same batch: overfit
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def _run(setup, store, total, preempt_at=None, **kw):
    _, _, _, fresh, opt_cfg, train_step, batch_fn = setup
    p = fresh()
    opt = optim.init_opt_state(p, opt_cfg)
    calls = {"n": 0}

    def sig():
        calls["n"] += 1
        return preempt_at is not None and calls["n"] >= preempt_at

    cfg = LoopConfig(total_steps=total, ckpt_every=3, log_every=100)
    return run_training(train_step, p, opt, batch_fn, store, cfg,
                        preemption_signal=sig, log=lambda s: None, **kw)


@pytest.mark.parametrize("kind", ["disk", "memory"])
def test_restart_is_bit_equal(tmp_path, setup, kind):
    """Kill after 6 steps, restart: params, moments and the last metrics
    bit-equal to the uninterrupted run."""
    make = ((lambda n: CheckpointStore(tmp_path / n)) if kind == "disk"
            else (lambda n: MemoryStore()))
    pA, oA, repA = _run(setup, make("a"), total=10)
    sB = make("b")
    _, _, rep1 = _run(setup, sB, total=10, preempt_at=6)
    assert rep1.preempted and rep1.end_step == 6
    assert sB.latest_step() == 6
    pB, oB, rep2 = _run(setup, sB, total=10)
    assert rep2.start_step == 6 and rep2.end_step == 10
    assert rep2.last_metrics == repA.last_metrics
    for a, b in ((pA, pB), (oA, oB)):
        la, lb = leaves_with_keys(a), leaves_with_keys(b)
        assert set(la) == set(lb)
        for k in la:
            assert torch.equal(la[k], lb[k]), k
    assert int(oB.step) == 10


def test_checkpoint_keys_follow_jax(tmp_path, setup):
    """``(params, OptState)`` saves under the JAX key scheme."""
    store = CheckpointStore(tmp_path)
    _run(setup, store, total=1)
    import json

    keys = set(json.loads((tmp_path / "step_000000001" / "MANIFEST.json")
                          .read_text())["leaves"])
    assert {"0/embed", "1/m/embed", "1/v/embed", "1/step"} <= keys
    jm, jp = setup[0], setup[1]
    jopt = joptim.init_opt_state(jp, joptim.AdamWConfig())
    from repro.ckpt.store import _flatten_with_keys

    assert keys == set(_flatten_with_keys((jp, jopt)))


def test_straggler_detection(tmp_path, setup):
    _, _, _, fresh, opt_cfg, train_step, batch_fn = setup

    class FakeClock:
        t = 0.0

        def __call__(self):
            return self.t

    clock = FakeClock()
    slow = {8}

    def slow_step(p, o, b):
        out = train_step(p, o, b)
        clock.t += 1.0 if slow_step.calls in slow else 0.1
        slow_step.calls += 1
        return out

    slow_step.calls = 0
    p = fresh()
    cfg = LoopConfig(total_steps=12, ckpt_every=100, log_every=100,
                     straggler_factor=4.0)
    _, _, rep = run_training(slow_step, p, optim.init_opt_state(p, opt_cfg),
                             batch_fn, CheckpointStore(tmp_path), cfg,
                             log=lambda s: None, clock=clock)
    assert rep.stragglers == [9]


def test_watchdog_raises(tmp_path, setup):
    _, _, _, fresh, opt_cfg, train_step, batch_fn = setup

    class FakeClock:
        t = 0.0

        def __call__(self):
            self.t += 0.1
            return self.t

    p = fresh()
    cfg = LoopConfig(total_steps=3, ckpt_every=100, max_step_s=0.05)
    with pytest.raises(TimeoutError):
        run_training(train_step, p, optim.init_opt_state(p, opt_cfg),
                     batch_fn, CheckpointStore(tmp_path), cfg,
                     log=lambda s: None, clock=FakeClock())


def test_microbatch_equivalence(setup):
    _, _, tm, fresh, _, _, batch_fn = setup
    batch = batch_fn(0)
    g1, _ = step.make_grad_fn(tm, step.TrainStepConfig())(fresh(), batch)
    g4, _ = step.make_grad_fn(tm, step.TrainStepConfig(
        num_microbatches=4))(fresh(), batch)
    for k, v in torch_leaves(g1).items():
        np.testing.assert_allclose(torch_leaves(g4)[k], v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_loop_logs_every_metric_as_floats(tmp_path, setup):
    """``log_every`` lines carry every metric; the metrics come back as
    floats."""
    lines = []
    _, _, _, fresh, opt_cfg, train_step, batch_fn = setup
    p = fresh()
    cfg = LoopConfig(total_steps=2, ckpt_every=100, log_every=1)
    _, _, rep = run_training(train_step, p, optim.init_opt_state(p, opt_cfg),
                             batch_fn, CheckpointStore(tmp_path), cfg,
                             log=lines.append)
    assert len(lines) == 2 and "grad_norm=" in lines[-1]
    assert set(rep.last_metrics) == {"loss", "ce", "aux", "lr", "grad_norm"}
    assert all(isinstance(v, float) for v in rep.last_metrics.values())


# --------------------------------------------- checkpoints across packages
def _jax_side(setup):
    jm, jp = setup[0], setup[1]
    kw = dict(lr=1e-3, total_steps=20, warmup_steps=2)
    jcfg = joptim.AdamWConfig(**kw)
    jfn = jax.jit(jstep.make_train_step(jm, jcfg))
    jb = jbatch_fn(0, JSpec(vocab=jm.cfg.vocab, seq=16, batch=4))
    return jp, jcfg, jfn, jb


def _jax_run(setup, root, total):
    jp, jcfg, jfn, jb = _jax_side(setup)
    return jrun(jfn, jp, joptim.init_opt_state(jp, jcfg), jb, JStore(root),
                JLoopConfig(total_steps=total, ckpt_every=2, log_every=100),
                log=lambda s: None)


def _port_run(setup, root, total):
    return _run(setup, CheckpointStore(root), total)


def _hold(port_tree, jax_tree, msg):
    jl, tl = jax_leaves(jax_tree), torch_leaves(port_tree)
    assert set(jl) == set(tl), set(jl) ^ set(tl)
    for k in jl:
        np.testing.assert_allclose(tl[k], np.asarray(jl[k]),
                                   rtol=CROSS_RTOL, atol=CROSS_ATOL,
                                   err_msg=f"{msg} {k}")


def test_jax_checkpoint_resumes_in_the_port(tmp_path, setup):
    """The JAX loop trains 4 steps into a store; the port's loop resumes
    it at step 4 and trains to 6, matching the JAX loop's own
    continuation."""
    _jax_run(setup, tmp_path / "j", total=4)
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    jp6, jo6, jrep = _jax_run(setup, tmp_path / "j", total=6)
    tp6, to6, trep = _port_run(setup, tmp_path / "t", total=6)
    assert (trep.start_step, trep.end_step) == (jrep.start_step,
                                                jrep.end_step) == (4, 6)
    _hold(tp6, jp6, "params")
    _hold(to6, jo6, "opt_state")
    np.testing.assert_allclose(trep.last_metrics["loss"],
                               jrep.last_metrics["loss"], rtol=1e-5)


def test_port_checkpoint_resumes_in_jax(tmp_path, setup):
    """The reverse: the port trains 4 steps, the JAX loop resumes at 4 and
    trains to 6, matching the port's own continuation."""
    _port_run(setup, tmp_path / "t", total=4)
    shutil.copytree(tmp_path / "t", tmp_path / "j")
    tp6, to6, trep = _port_run(setup, tmp_path / "t", total=6)
    jp6, jo6, jrep = _jax_run(setup, tmp_path / "j", total=6)
    assert jrep.start_step == trep.start_step == 4
    _hold(tp6, jp6, "params")
    _hold(to6, jo6, "opt_state")


def test_opt_state_from_jax(setup):
    jp = setup[1]
    js = joptim.init_opt_state(jp, joptim.AdamWConfig())
    js = js._replace(step=jnp.int32(7),
                     m=jax.tree_util.tree_map(lambda x: x + 1.0, js.m))
    ts = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, js), "cpu")
    assert isinstance(ts, optim.OptState)
    assert int(ts.step) == 7 and ts.step.dtype == torch.int32
    jl, tl = jax_leaves(js), torch_leaves(ts)
    assert set(jl) == set(tl)
    for k in jl:
        np.testing.assert_array_equal(tl[k], np.asarray(jl[k]), err_msg=k)


# ------------------------------------------------------------ compression
def test_quantize_is_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(256) * 3.0).astype(np.float32)
    x[:4] = [0.5, -0.5, 1.5, 2.5]  # ties: both round half to even
    for arr in (x, np.zeros(8, np.float32), x.reshape(16, 16)):
        jq, js = jcompress._quantize(jnp.asarray(arr))
        tq, ts = compress._quantize(torch.from_numpy(arr))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert float(ts) == float(js)
        np.testing.assert_array_equal(
            compress._dequantize(tq, ts).numpy(),
            np.asarray(jcompress._dequantize(jq, js)))


def test_quantize_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        256).astype(np.float32) * 3.0)
    q, s = compress._quantize(x)
    err = (compress._dequantize(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-6


def test_inactive_without_pod_group():
    c = compress.Compressor()
    g = {"w": torch.ones(4)}
    ef = c.init_ef(g)
    g2, ef2, m = c.compress_reduce(g, ef)
    assert g2 is g and ef2 is ef
    assert float(m["compress_ratio"]) == 1.0


def test_leaf_at_one_pod_matches_jax():
    """The error-feedback body at npods = 1 against the JAX package's
    ``_leaf`` run over a one-pod mesh axis (its psums are then the
    values themselves)."""
    from repro.compat import shard_map
    from jax.sharding import PartitionSpec as P

    rng = np.random.default_rng(2)
    g = rng.standard_normal(64).astype(np.float32)
    e = (0.01 * rng.standard_normal(64)).astype(np.float32)
    mesh = jax.make_mesh((1,), ("pod",))
    jc = jcompress.Compressor(mesh=mesh)
    fn = shard_map(jc._leaf, mesh=mesh, in_specs=(P(), P()),
                   out_specs=(P(), P()), check_vma=False)
    jg, je = fn(jnp.asarray(g), jnp.asarray(e))
    tg, te = compress.Compressor()._leaf(torch.from_numpy(g),
                                         torch.from_numpy(e))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6,
                               atol=1e-7)


def test_error_feedback_cancels_bias():
    """Simulated 2-pod loop of the port's ``_quantize``: the EF mean is
    unbiased over steps."""
    rng = np.random.default_rng(0)
    T, D = 200, 32
    g_true = rng.normal(0, 1, (T, 2, D)).astype(np.float32)
    es = [torch.zeros(D), torch.zeros(D)]
    acc_c = np.zeros(D, np.float64)
    acc_e = np.zeros(D, np.float64)
    for t in range(T):
        outs = []
        for i in range(2):
            v = torch.from_numpy(g_true[t, i]) + es[i]
            q, s = compress._quantize(v)
            deq = compress._dequantize(q, s)
            outs.append(deq.numpy())
            es[i] = v - deq
        acc_c += np.mean(outs, axis=0)
        acc_e += g_true[t].mean(0)
    assert np.abs(acc_c - acc_e).max() / T < 0.01


def test_reference_reduce_matches_jax():
    rng = np.random.default_rng(3)
    pods = [{"w": rng.standard_normal((3, 2)).astype(np.float32)}
            for _ in range(3)]
    want = jcompress.reference_reduce(
        [jax.tree_util.tree_map(jnp.asarray, p) for p in pods])
    got = compress.reference_reduce(
        [{"w": torch.from_numpy(p["w"])} for p in pods])
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               rtol=1e-6)


def test_train_step_with_compressor(setup):
    """The compressing step with no pod group: the plain step's result
    and ``compress_ratio`` 1.0."""
    _, _, tm, fresh, opt_cfg, train_step, batch_fn = setup
    c = compress.Compressor()
    fn = step.make_train_step(tm, opt_cfg, compressor=c)
    p = fresh()
    p1, o1, ef, m = fn(p, optim.init_opt_state(p, opt_cfg), batch_fn(0),
                       c.init_ef(p))
    q = fresh()
    p2, o2, m2 = train_step(q, optim.init_opt_state(q, opt_cfg), batch_fn(0))
    assert float(m["compress_ratio"]) == 1.0
    for k, v in leaves_with_keys(p2).items():
        assert torch.equal(leaves_with_keys(p1)[k], v), k


# --------------------------------------------------------------- launcher
def test_train_launcher_end_to_end(tmp_path, capsys):
    from repro_torch.launch import train

    _, _, rep, sel = train.main([
        "--arch", "qwen2-1.5b", "--reduced", "--steps", "3", "--batch", "4",
        "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
        "--device", "cpu", "--coreset-k", "4"])
    out = capsys.readouterr().out
    assert "[train] done: steps 0->3" in out
    assert "[train] coreset:" in out
    assert rep.end_step == 3 and np.isfinite(rep.last_metrics["loss"])
    assert sel.n_seen == 12 and 0 < sel.n_selected <= 4
    assert CheckpointStore(tmp_path).committed_steps() == [2, 3]


def test_train_launcher_cuts_layers(tmp_path):
    """``--layers N`` trains the config's first N layers at its widths:
    the trained tree of a one-layer cut of the reduced qwen2 has the
    leaves, and the shapes, of a model built from the cut config."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import Model

    params, _, rep, _ = train.main([
        "--arch", "qwen2-1.5b", "--reduced", "--layers", "1", "--steps",
        "1", "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
        "--device", "cpu"])
    cut = dataclasses.replace(get_config("qwen2-1.5b", reduced=True),
                              n_layers=1)
    want = Model(cut, device="cpu").init(torch.Generator().manual_seed(0))
    assert rep.end_step == 1 and np.isfinite(rep.last_metrics["loss"])
    assert ({k: tuple(v.shape) for k, v in leaves_with_keys(params).items()}
            == {k: tuple(v.shape)
                for k, v in leaves_with_keys(want).items()})
    assert get_config("qwen2-1.5b", reduced=True).n_layers > 1


def test_train_launcher_coreset_matches_jax_at_width_64():
    """At d_model = 64 (the reduced configs) the port's 64-wide histogram
    coreset selects what the JAX package's selector selects on the same
    batches."""
    from repro.data import CoresetSelector as JSel
    from repro_torch.data import CoresetSelector

    assert jget("qwen2-1.5b", reduced=True).d_model == 64
    spec = TokenStreamSpec(vocab=512, seq=16, batch=4)
    fn = deterministic_batch_fn(0, spec, device="cpu")
    jsel = JSel(K=4, d=64, T=500, eps=0.01)
    tsel = CoresetSelector(K=4, d=64, T=500, eps=0.01, device="cpu")
    for s in range(3):
        toks = fn(s)["tokens"]
        hist = torch.nn.functional.one_hot(toks.long() % 64,
                                           64).float().mean(1)
        tsel.update(hist)
        jsel.update(jax.nn.one_hot(jnp.asarray(toks.numpy()) % 64,
                                   64).mean(1))
    assert tsel.n_selected == jsel.n_selected
    np.testing.assert_allclose(tsel.summary()[0].numpy(),
                               np.asarray(jsel.summary()[0]), rtol=1e-5,
                               atol=1e-6)
