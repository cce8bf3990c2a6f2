# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""The port's CUDA kernels against their plain versions, on the card.

Skipped without a card (the kernels have no CPU mode); on the card run
``PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py``
(the machine with the card has no JAX, which ``tests/conftest.py`` imports).
``chip_smoke.py`` holds the same comparisons at the full shapes.
"""
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("n", [0, 5, 70])
def test_gain_traced_matches_plain(cuda, kind, n):
    from repro_torch.kernelmath import KernelParams
    from repro_torch.kernels.rbf_gain import gain_traced, gain_traced_ref

    g = torch.Generator(device=cuda).manual_seed(n + 10 * kind)
    K, d, B = 70, 33, 200
    X = 0.2 * torch.randn(B, d, generator=g, device=cuda)
    feats = 0.2 * torch.randn(K, d, generator=g, device=cuda)
    linv = torch.tril(0.1 * torch.randn(K, K, generator=g, device=cuda))
    linv += torch.eye(K, device=cuda)
    kern = KernelParams(torch.tensor(3.0, device=cuda),
                        torch.tensor(kind, dtype=torch.int32, device=cuda))
    nt = torch.tensor([n], dtype=torch.int32, device=cuda)
    got = gain_traced(X, feats, linv, nt, kern.inv2l2.reshape(1),
                      kern.kind_id.reshape(1), a=1.0)
    want = gain_traced_ref(X, feats, linv, nt[0], kern, a=1.0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_pod_step_kernel_matches_plain(cuda):
    from repro_torch.core.api import make
    from repro_torch.core.spec import SessionSpec
    from repro_torch.kernels.pod_step import pod_step
    from repro_torch.tree import tree_map

    spec = SessionSpec(K=12, d=9, T=6, eps=0.1, lengthscale=0.5)
    algo = make(spec, device=cuda)
    ref_algo = make(spec.replace(backend="torch"), device=cuda)
    rows = [algo.init(algo.hyper(K=k, kernel_kind=kind))
            for k, kind in ((12, "rbf"), (5, "linear_norm"), (8, "rbf"))]
    ker = tree_map(lambda *xs: torch.stack(xs), *rows)
    ref = tree_map(lambda t: t.clone(), ker)
    g = torch.Generator(device=cuda).manual_seed(0)
    for C, counts in ((40, [40, 17, 0]), (1, [1, 1, 0]), (40, [40, 40, 3])):
        chunks = torch.randn(3, C, 9, generator=g, device=cuda)
        counts = torch.tensor(counts, dtype=torch.int32, device=cuda)
        pod_step(algo, ker, chunks, counts, backend="cuda")
        pod_step(ref_algo, ref, chunks, counts, backend="torch")
        for a, b in ((ker.ld.n, ref.ld.n), (ker.j, ref.j), (ker.t, ref.t),
                     (ker.n_fused, ref.n_fused)):
            assert torch.equal(a, b)
        assert torch.equal(ker.ld.feats, ref.ld.feats)
        torch.testing.assert_close(ker.ld.Linv, ref.ld.Linv, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("kind", ["rbf", "linear_norm"])
@pytest.mark.parametrize("B,n", [(1, 0), (1, 70), (5000, 0), (5000, 33),
                                 (5000, 70)])
def test_gain_static_matches_plain(cuda, kind, B, n):
    from repro_torch.kernels.rbf_gain import gain_ref, gain_static

    g = torch.Generator(device=cuda).manual_seed(B + n)
    K, d = 70, 33
    X = 0.2 * torch.randn(B, d, generator=g, device=cuda)
    feats = 0.2 * torch.randn(K, d, generator=g, device=cuda)
    linv = torch.tril(0.1 * torch.randn(K, K, generator=g, device=cuda))
    linv += torch.eye(K, device=cuda)
    nt = torch.tensor([n], dtype=torch.int32, device=cuda)
    got = gain_static(X, feats, linv, nt, a=1.0, inv2l2=3.0, kind=kind)
    mask = (torch.arange(K, device=cuda) < n).float()[None, :]
    want = gain_ref(X, feats, linv, mask, a=1.0, inv2l2=3.0, kind=kind)[:, 0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_gain_traced_instance_axis_matches_plain(cuda):
    from repro_torch.kernelmath import KernelParams
    from repro_torch.kernels.rbf_gain import gain_traced, gain_traced_ref

    g = torch.Generator(device=cuda).manual_seed(7)
    I, K, d, B = 9, 40, 33, 300
    X = 0.2 * torch.randn(B, d, generator=g, device=cuda)
    feats = 0.2 * torch.randn(I, K, d, generator=g, device=cuda)
    linv = torch.tril(0.1 * torch.randn(I, K, K, generator=g, device=cuda))
    linv += torch.eye(K, device=cuda)
    n = torch.randint(0, K + 1, (I,), generator=g, device=cuda).int()
    kern = KernelParams(torch.tensor(3.0, device=cuda),
                        torch.tensor(0, dtype=torch.int32, device=cuda))
    got = gain_traced(X, feats, linv, n, kern.inv2l2.reshape(1),
                      kern.kind_id.reshape(1), a=1.0)
    want = gain_traced_ref(X, feats, linv, n, kern, a=1.0)
    assert got.shape == (I, B)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_streamed_pod_step_matches_plain(cuda):
    """K_max = 600: feats and Linv of a session far past what shared
    memory could hold (the global layout tier, Linv in device memory);
    the result is the plain loop's."""
    from repro_torch.core.api import make
    from repro_torch.core.spec import SessionSpec
    from repro_torch.kernels.pod_step import layout, pod_step
    from repro_torch.tree import tree_map

    K, d = 600, 24
    assert (layout(K, d).tier, layout(K, d).bt) == ("global", 32)
    spec = SessionSpec(K=K, d=d, T=6, eps=0.1, lengthscale=1.0)
    algo = make(spec, device=cuda)
    ref_algo = make(spec.replace(backend="torch"), device=cuda)
    rows = [algo.init(algo.hyper(K=k, kernel_kind=kind))
            for k, kind in ((600, "rbf"), (40, "linear_norm"), (200, "rbf"))]
    ker = tree_map(lambda *xs: torch.stack(xs), *rows)
    ref = tree_map(lambda t: t.clone(), ker)
    g = torch.Generator(device=cuda).manual_seed(1)
    for C, counts in ((300, [300, 120, 0]), (300, [300, 300, 300])):
        chunks = 0.3 * torch.randn(3, C, d, generator=g, device=cuda)
        counts = torch.tensor(counts, dtype=torch.int32, device=cuda)
        pod_step(algo, ker, chunks, counts, backend="cuda")
        pod_step(ref_algo, ref, chunks, counts, backend="torch")
        for a, b in ((ker.ld.n, ref.ld.n), (ker.j, ref.j), (ker.t, ref.t),
                     (ker.n_fused, ref.n_fused)):
            assert torch.equal(a, b)
        assert torch.equal(ker.ld.feats, ref.ld.feats)
        torch.testing.assert_close(ker.ld.Linv, ref.ld.Linv, rtol=1e-5,
                                   atol=1e-5)


# The pod step at the main path's shape and at the edges of its candidate
# window.  Inputs are drawn on the CPU from a seed and moved to the card;
# the plain loop (pod_step_ref) runs on the card beside the kernel.
POD_TIERS = ((10, 500, 0.05), (50, 1000, 0.01), (100, 2500, 0.005))


def _pod_algo(cuda, K, d, dtype=torch.float32, T=1000, eps=0.01):
    from repro_torch.core.functions import (KernelConfig, LogDet,
                                            rbf_lengthscale_stream)
    from repro_torch.core.threesieves import ThreeSieves

    f = LogDet(K=K, d=d, kernel=KernelConfig("rbf", rbf_lengthscale_stream(d)),
               dtype=dtype, device=cuda)
    return ThreeSieves(f=f, T=T, eps=eps)


def _pod_state(algo, rows):
    """Stacked sessions of ``algo`` from hyper() keyword dicts."""
    from repro_torch.tree import tree_map

    return tree_map(lambda *xs: torch.stack(xs),
                    *[algo.init(algo.hyper(**r)) for r in rows])


def _mixture(g, S, C, d, *, clusters=64, spread=1.0):
    """chip_smoke.py's mixture at the stream lengthscale, on the CPU."""
    centers = (2.0 / d) * torch.randn(clusters, d, generator=g)
    z = torch.randint(0, clusters, (S * C,), generator=g)
    X = centers[z] + (spread / d) * torch.randn(S * C, d, generator=g)
    return X.reshape(S, C, d)


def _hold_pod(algo, ker, ref, chunks, counts, *, tie=1e-4, fval_tol=1e-5,
              factors=True):
    """One kernel step of ``ker`` against one plain step of ``ref`` on
    the same chunk: integers equal, appended rows bit-equal, fval (and,
    with ``factors``, L and Linv) within the tolerance; the fixtures keep
    every decided item's margin above ``tie``.  Returns the new ref and
    the longest session's passes."""
    from repro_torch.kernels.pod_step import pod_step, pod_step_ref

    dev = ker.ld.feats.device
    chunks, counts = chunks.to(dev), torch.tensor(counts, dtype=torch.int32,
                                                  device=dev)
    before = ker.n_fused.clone()
    pod_step(algo, ker, chunks, counts, backend="cuda")
    margins = [dict() for _ in range(chunks.shape[0])]
    ref = pod_step_ref(algo, ref, chunks, counts, margins=margins)
    for name in ("n", "n_queries"):
        assert torch.equal(getattr(ker.ld, name), getattr(ref.ld, name)), name
    for name in ("j", "t", "n_fused"):
        assert torch.equal(getattr(ker, name), getattr(ref, name)), name
    assert torch.equal(ker.ld.feats, ref.ld.feats)
    for name in ("L", "Linv", "fval") if factors else ("fval",):
        torch.testing.assert_close(getattr(ker.ld, name).float(),
                                   getattr(ref.ld, name).float(),
                                   rtol=fval_tol if name == "fval" else 1e-5,
                                   atol=fval_tol if name == "fval" else 1e-5)
    decided = [m for d in margins for m in d.values()]
    assert not decided or min(decided) > tie
    return ref, int((ker.n_fused - before).max())


def test_pod_step_refill_matches_plain(cuda):
    """A refill from empty summaries at the main path's shape (K = 100,
    d = 256, C = 1024; the three tiers, a third of them linear_norm): the
    shared layout tier, about 100 serial passes for a pro session, each
    accept carrying the rest of the 32-row window to the new state."""
    from repro_torch.kernels.pod_step import layout

    K, d, C = 100, 256, 1024
    assert layout(K, d).tier == "shared"
    algo = _pod_algo(cuda, K, d)
    rows = [dict(K=k, T=T, eps=eps, kernel_kind=kind)
            for k, T, eps in POD_TIERS for kind in ("rbf", "linear_norm")]
    ker = _pod_state(algo, rows)
    ref = _pod_state(algo, rows)
    chunks = _mixture(torch.Generator().manual_seed(11), len(rows), C, d)
    _, passes = _hold_pod(algo, ker, ref, chunks, [C] * len(rows))
    assert passes >= 100 and int(ker.ld.n.max()) == K


@pytest.mark.parametrize("case", ["window_last_row", "ragged", "c1", "nv0"])
def test_pod_step_window_edges_match_plain(cuda, case):
    """Where the candidate window is cut: an acceptor on the window's last
    row (33 far-apart items, every one accepted: row 31 closes the first
    window, row 32 opens the next), ragged counts around the 32-row
    window with C = 45 (not a multiple of it) over tight clusters, whose
    rejections walk from window to window, C = 1, and counts of 0."""
    K, d = 100, 64
    algo = _pod_algo(cuda, K, d, T=40)
    rows = [dict(K=100, T=40), dict(K=50, T=25, kernel_kind="linear_norm"),
            dict(K=100, T=7), dict(K=10, T=20), dict(K=100, T=300),
            dict(K=60, T=12)]
    S = len(rows)
    ker, ref = _pod_state(algo, rows), _pod_state(algo, rows)
    g = torch.Generator().manual_seed(5)
    warm = _mixture(g, S, 45, d, clusters=8, spread=0.3)
    ref, _ = _hold_pod(algo, ker, ref, warm, [45, 20, 33, 45, 1, 32])
    if case == "window_last_row":
        chunks = 400.0 / d * torch.randn(S, 33, d, generator=g)
        counts = [33] * S
    elif case == "ragged":
        chunks = _mixture(g, S, 45, d, clusters=8, spread=0.3)
        counts = [45, 31, 32, 33, 0, 44]
    elif case == "c1":
        chunks = _mixture(g, S, 1, d, clusters=8, spread=0.3)
        counts = [1, 1, 0, 1, 1, 1]
    else:
        chunks = _mixture(g, S, 45, d)
        counts = [0] * S
    before = ker.ld.n.clone()
    _hold_pod(algo, ker, ref, chunks, counts)
    if case == "window_last_row":  # 33 accepts where the summary had room
        room = torch.clamp(ker.hp.k_cap - before, max=33)
        assert torch.equal(ker.ld.n - before, room)
        assert int(room.max()) == 33
    if case == "nv0":
        assert torch.equal(ker.ld.n, before)


def test_pod_step_saturating_round_matches_plain(cuda):
    """Summaries one row short of their cap that reject every item of the
    chunk price all C rows once (window after window) at n = K - 1; a full
    summary prices nothing.  The summaries hold one tight cluster
    (factored by ``LogDet.refactor``), so f(S) stays far below the top
    rung and the last free row's threshold above every gain."""
    import dataclasses

    from repro_torch.tree import tree_map

    K, d, C = 40, 64, 300
    algo = _pod_algo(cuda, K, d, T=100000)
    rows = [dict(K=40, T=100000), dict(K=40, T=100000), dict(K=20, T=100000),
            dict(K=20, T=100000)]
    S = len(rows)
    g = torch.Generator().manual_seed(3)
    feats = _mixture(g, S, K, d, clusters=1, spread=0.3).to(cuda)
    n = torch.tensor([39, 39, 19, 20], dtype=torch.int32, device=cuda)
    ker = dataclasses.replace(_pod_state(algo, rows),
                              ld=algo.f.refactor(feats, n))
    ref = tree_map(lambda t: t.clone(), ker)
    chunks = _mixture(g, S, C, d)
    ref, passes = _hold_pod(algo, ker, ref, chunks, [C] * S)
    assert torch.equal(ker.ld.n, n) and passes == 1
    assert torch.equal(ker.ld.n_queries, torch.full_like(n, C))


@pytest.mark.parametrize("K,d,layouts", [
    (100, 256, [("shared", 32), ("global", 32), ("shared", 8)]),
    (600, 24, [("global", 32), ("global", 16), ("global", 8)])])
def test_pod_step_layout_tiers_give_the_same_bits(cuda, K, d, layouts):
    """The layout tier moves Linv between shared and device memory and
    the window size moves where full pricing happens, and nothing else:
    the same rounds under each leave bit-equal states (the window's
    running norms are the chains a full pricing runs)."""
    from repro_torch.kernels.pod_step import pod_step
    from repro_torch.tree import leaves_with_keys

    algo = _pod_algo(cuda, K, d, T=30)
    rows = [dict(K=K, T=30), dict(K=60, T=9, kernel_kind="linear_norm"),
            dict(K=K // 2, T=200)]
    states = [_pod_state(algo, rows) for _ in layouts]
    g = torch.Generator().manual_seed(K)
    for C, spread in ((700, 1.0), (300, 0.3), (1, 1.0)):
        chunks = _mixture(g, len(rows), C, d, clusters=8,
                          spread=spread).to(cuda)
        counts = torch.tensor([C, C // 2, C], dtype=torch.int32, device=cuda)
        for (tier, window), st in zip(layouts, states):
            pod_step(algo, st, chunks, counts, backend="cuda", tier=tier,
                     window=window)
        first = leaves_with_keys(states[0])
        for other in states[1:]:
            for key, t in leaves_with_keys(other).items():
                assert torch.equal(first[key], t), key
    assert int(states[0].ld.n.max()) > 20


def test_pod_step_bf16_refill_matches_plain(cuda):
    """A bf16 refill at the main path's shape (K = 100, d = 256, C = 1024):
    the carry stays bf16, the integers and rows equal the plain loop's,
    fval within 0.05 (tests/test_pod_step_kernel.py's bf16 pin); decided
    items keep a margin above one bf16 ulp (1e-2)."""
    K, d, C = 100, 256, 1024
    algo = _pod_algo(cuda, K, d, dtype=torch.bfloat16)
    rows = [dict(K=k, T=T, eps=eps) for k, T, eps in POD_TIERS]
    ker, ref = _pod_state(algo, rows), _pod_state(algo, rows)
    chunks = _mixture(torch.Generator().manual_seed(12), len(rows), C, d)
    _, passes = _hold_pod(algo, ker, ref, chunks, [C] * len(rows), tie=1e-2,
                          fval_tol=0.05, factors=False)
    for name in ("feats", "L", "Linv", "fval"):
        assert getattr(ker.ld, name).dtype == torch.bfloat16, name
    assert passes >= 100


def test_pod_step_shared_memory_matches_the_host(cuda):
    """``pod_step_smem_bytes`` of the built library equals the host's
    ``smem_bytes`` for both tiers and every window."""
    from repro_torch.kernels.pod_step import KERNEL, smem_bytes
    from repro_torch.kernels.pod_step.kernel import TIERS, WINDOW_ROWS

    lib = KERNEL.get()
    for K in (1, 10, 100, 101, 192, 600, 1024, 3072):
        for d in (9, 24, 256, 512):
            for tier in TIERS:
                for bt in WINDOW_ROWS:
                    assert lib.pod_step_smem_bytes(
                        TIERS.index(tier), bt, K, d) == smem_bytes(
                        K, d, bt, tier), (K, d, tier, bt)


# ---------------------------------------------------------- flash attention
ATTN_SHAPES = [  # B, Hq, Hkv, Sq, Sk, dh: the JAX kernel tests' shapes
    (1, 2, 2, 128, 128, 64),
    (2, 4, 2, 256, 256, 64),  # GQA 2:1
    (1, 8, 1, 128, 384, 128),  # MQA, rectangular
    (2, 2, 2, 100, 100, 64),  # ragged (padding path)
    (1, 4, 4, 64, 64, 32),  # small blocks
]
ATTN_CASES = [(*s, c) for s in ATTN_SHAPES for c in (True, False)
              if not (c and s[3] != s[4])]  # causal needs Sq == Sk


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,dh,causal", ATTN_CASES)
def test_flash_attention_kernel_matches_plain(cuda, B, Hq, Hkv, Sq, Sk, dh,
                                              causal, dtype):
    from repro_torch.kernels.flash_attention import (KERNEL, attention_ref,
                                                     flash_attention)

    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(Sq + dh)
    q = (0.5 * torch.randn(B, Hq, Sq, dh, generator=g, device=cuda)).to(dt)
    k = (0.5 * torch.randn(B, Hkv, Sk, dh, generator=g, device=cuda)).to(dt)
    v = torch.randn(B, Hkv, Sk, dh, generator=g, device=cuda).to(dt)
    before = KERNEL.launches
    got = flash_attention(q, k, v, causal=causal, backend="cuda")
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    want = attention_ref(q, k, v, causal=causal)
    assert got.dtype == dt and got.shape == want.shape
    tol = 2e-2 if dt == torch.bfloat16 else 2e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_attention_kernel_kv_len_and_refusals(cuda):
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)

    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(2, 4, 70, 64, generator=g, device=cuda)
    k = torch.randn(2, 2, 90, 64, generator=g, device=cuda)
    v = torch.randn(2, 2, 90, 64, generator=g, device=cuda)
    for causal in (False, True):
        got = flash_attention_cuda(q, k, v, causal=causal, kv_len=77)
        want = attention_ref(q, k, v, causal=causal, kv_len=77)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    # past 256 the head width runs (O's columns split over the grid), and
    # past 65,535 batch x column blocks (the tiles on a flat grid); what is
    # left to refuse: a width below 1
    wide = torch.randn(2, 4, 70, 257, generator=g, device=cuda)
    kv = wide[:, :2].contiguous()
    got = flash_attention_cuda(wide, kv, kv, kv_len=70)
    torch.testing.assert_close(got, attention_ref(wide, kv, kv), rtol=2e-4,
                               atol=2e-4)
    with pytest.raises(ValueError, match="head width 0 "):
        empty = torch.zeros(2, 4, 70, 0, device=cuda)
        flash_attention_cuda(empty, empty[:, :2], empty[:, :2])
    tall = torch.randn(32768, 1, 1, 264, generator=g, device=cuda)
    torch.testing.assert_close(flash_attention_cuda(tall, tall, tall),
                               attention_ref(tall, tall, tall), rtol=2e-4,
                               atol=2e-4)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention_cuda(q, k, v, kv_len=91)


def test_whisper_encoder_kernel_route_matches_plain(cuda):
    """The encoder at a reduced depth and Whisper-small's head width (64)
    through the kernel, against the plain chunked route, float32."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import KERNEL
    from repro_torch.models import Model

    cfg = dataclasses.replace(
        get_config("whisper-small", dtype="float32",
                   use_pallas_attention=True), n_layers=2,
        encoder=dataclasses.replace(get_config("whisper-small").encoder,
                                    n_layers=2))
    model = Model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(1)
    frames = torch.randn(2, 1500, cfg.d_model, generator=g, device=cuda)
    before = KERNEL.launches
    got = model._encode(params, frames)
    assert KERNEL.launches == before + 2
    plain = Model(dataclasses.replace(cfg, use_pallas_attention=False),
                  device=cuda)
    want = plain._encode(params, frames)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


def test_flash_backend_cuda_refuses_cpu_tensors():
    """Needs no card: the kernel route on a CPU tensor raises, it never
    falls back to the plain version."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_cuda)

    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="backend"):
        flash_attention(q, q, q, backend="pallas")


# ------------------------------------------------------------------ SSD
SSD_SHAPES = [  # b, h, c, q, p, n
    (1, 1, 1, 16, 16, 16),  # the reduced config's tile (16/16/16)
    (2, 3, 4, 16, 16, 16),
    (1, 2, 4, 32, 32, 16),
    (2, 1, 2, 48, 64, 128),  # mamba2-370m head_dim / d_state, q = 48
    (1, 2, 2, 256, 64, 128),  # the mamba2-370m tile
    (1, 1, 2, 256, 128, 32),
]


def _ssd_inputs(cuda, b, h, c, q, p, n, dtype, decay=1.0, seed=0, g=None):
    """The model's layout: X (b, L, h, p), Adt (b, L, h), B/C (b, L, g, n)
    (g = h: per head), L = c q."""
    g = h if g is None else g
    gen = torch.Generator(device=cuda).manual_seed(seed)
    L = c * q
    X = torch.randn(b, L, h, p, generator=gen, device=cuda)
    Adt = -decay * torch.nn.functional.softplus(
        torch.randn(b, L, h, generator=gen, device=cuda))
    B = torch.randn(b, L, g, n, generator=gen, device=cuda)
    C = torch.randn(b, L, g, n, generator=gen, device=cuda)
    dt = getattr(torch, dtype)
    return [t.to(dt) for t in (X, Adt, B, C)]


def _assert_ssd_close(got, want, dtype, exact=None):
    """tests/test_ssd_kernel.py's elementwise rtol = atol (2e-2 bf16, 1e-5
    float32) and chip_smoke.py's bound on the largest output (1e-2 bf16,
    1e-5 float32).

    ``exact`` (float64 results of the same formula, ``_ssd_f64``) replaces
    the elementwise float32 gate for state widths past 256: there the
    plain version itself misses float64 by more than 1e-5 (up to 1e-4 at
    n = 520, q = 16, where its product runs in another summation order
    than the kernel's), so the kernel is held to its largest error
    against float64 being at most twice the plain version's, beside the
    bound on the largest output."""
    tol, scaled = (2e-2, 1e-2) if dtype == "bfloat16" else (1e-5, 1e-5)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape
        if exact is None:
            torch.testing.assert_close(a.float(), b.float(), rtol=tol,
                                       atol=tol)
        else:
            e = exact[i]
            mine = (a.double() - e).abs().max().item()
            plain = (b.double() - e).abs().max().item()
            assert mine <= 2 * plain, (mine, plain)
        err = (a.float() - b.float()).abs().max().item()
        assert err <= scaled * b.float().abs().max().item()


def _ssd_f64(X, Adt, B, C, q):
    """Y (b, L, h, p) and the states (b, c, h, p, n) of the intra-chunk
    formula (``ssd_chunk_ref``'s) in float64, B / C per group."""
    b, L, h, p = X.shape
    g, c = B.shape[2], L // q
    Xc, Bc, Cc = (t.double().reshape(b, c, q, t.shape[2], -1)
                  for t in (X, B, C))
    Bc, Cc = (t.repeat_interleave(h // g, 3) for t in (Bc, Cc))
    acum = torch.cumsum(Adt.double().reshape(b, c, q, h), 2)
    tri = torch.ones(q, q, dtype=torch.bool, device=X.device).tril()
    Lm = torch.exp(torch.where(tri[None, None, :, :, None],
                               acum[:, :, :, None] - acum[:, :, None],
                               float("-inf")))
    S = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc) * Lm
    Y = torch.einsum("bcijh,bcjhp->bcihp", S, Xc).reshape(b, L, h, p)
    decay = torch.exp(acum[:, :, -1:] - acum)
    st = torch.einsum("bcjhn,bcjh,bcjhp->bchpn", Bc, decay, Xc)
    return Y, st


@pytest.mark.parametrize("decay", [1.0, 0.01])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,c,q,p,n", SSD_SHAPES)
def test_ssd_chunk_kernel_matches_plain(cuda, b, h, c, q, p, n, dtype,
                                        decay):
    """Per-head B / C (the JAX signature): the dtype's route (bf16: the
    tensor-core kernel, float32: the CUDA-core one) against the plain
    version, one launch per call."""
    from repro_torch.kernels.ssd_chunk import (KERNEL, ROUTE_LAUNCHES,
                                               ssd_chunk_cuda, ssd_chunks)

    X, Adt, B, C = _ssd_inputs(cuda, b, h, c, q, p, n, dtype, decay, q + n)
    route = "tensor-core" if dtype == "bfloat16" else "cuda-core"
    before, routed = KERNEL.launches, ROUTE_LAUNCHES[route]
    Y, st = ssd_chunk_cuda(X, Adt, B, C, chunk=q)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    assert ROUTE_LAUNCHES[route] == routed + 1
    Yr, sr = ssd_chunks(X, Adt, B, C, chunk=q, backend="torch")
    assert Y.dtype == X.dtype and st.dtype == torch.float32
    assert torch.isfinite(Y.float()).all() and torch.isfinite(st).all()
    _assert_ssd_close((Y, st), (Yr, sr), dtype)


def test_ssd_chunks_kernel_route_matches_plain(cuda):
    """The model-layout wrapper: kernel route against plain route."""
    from repro_torch.kernels.ssd_chunk import ssd_chunks

    g = torch.Generator(device=cuda).manual_seed(5)
    b, L, h, p, n = 2, 512, 4, 64, 128
    X = torch.randn(b, L, h, p, generator=g, device=cuda)
    Adt = -torch.nn.functional.softplus(torch.randn(b, L, h, generator=g,
                                                    device=cuda))
    B = torch.randn(b, L, h, n, generator=g, device=cuda)
    C = torch.randn(b, L, h, n, generator=g, device=cuda)
    Y, st = ssd_chunks(X, Adt, B, C, chunk=256, backend="cuda")
    Yr, sr = ssd_chunks(X, Adt, B, C, chunk=256, backend="torch")
    assert st.shape == (b, 2, h, p, n)
    torch.testing.assert_close(Y, Yr, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(st, sr, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("q", [16, 64, 256])
@pytest.mark.parametrize("n", [16, 32, 64, 128])
@pytest.mark.parametrize("p", [16, 32, 64, 128])
def test_ssd_tensor_core_grouped_strided(cuda, p, n, q):
    """The tensor-core kernel on the model's layout read in place: X, B
    and C as views into one wide (b, L, width) row, as the prefill's conv
    output holds them, and Adt a strided view, with B / C per group for
    g = 1, 2 and h (= 4), against the plain version on the per-head
    repeat; the grouped call equals the per-head call bit for bit (each
    head's arithmetic is the same)."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk_cuda, ssd_chunks

    b, c, h = 2, 2, 4
    L = c * q
    gen = torch.Generator(device=cuda).manual_seed(p + n + q)
    for g in (1, 2, h):
        width = h * p + 2 * g * n + 8  # rows on 16 bytes
        wide = torch.randn(b, L, width, generator=gen, device=cuda).bfloat16()
        X = wide[..., :h * p].unflatten(-1, (h, p))
        B = wide[..., h * p:h * p + g * n].unflatten(-1, (g, n))
        C = wide[..., h * p + g * n:h * p + 2 * g * n].unflatten(-1, (g, n))
        Adt = (-torch.nn.functional.softplus(torch.randn(
            b, L, 2 * h, generator=gen, device=cuda)))[..., ::2].bfloat16()
        assert not (X.is_contiguous() or B.is_contiguous())
        Y, st = ssd_chunk_cuda(X, Adt, B, C, chunk=q)
        want = ssd_chunks(X, Adt, B, C, chunk=q, backend="torch")
        _assert_ssd_close((Y, st), want, "bfloat16")
        per_head = ssd_chunk_cuda(
            X, Adt, *(t.repeat_interleave(h // g, dim=2) for t in (B, C)),
            chunk=q)
        assert torch.equal(Y, per_head[0]) and torch.equal(st, per_head[1])


@pytest.mark.parametrize("g", [1, 2, 4])
def test_ssd_cuda_core_grouped_matches_plain(cuda, g):
    """The float32 CUDA-core kernel reads B / C per group by index."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk_cuda, ssd_chunks

    X, Adt, B, C = _ssd_inputs(cuda, 2, 4, 2, 64, 32, 64, "float32", g=g,
                               seed=g)
    got = ssd_chunk_cuda(X, Adt, B, C, chunk=64)
    _assert_ssd_close(got, ssd_chunks(X, Adt, B, C, chunk=64,
                                      backend="torch"), "float32")


def test_ssd_chunk_kernel_refusals(cuda):
    from repro_torch.kernels.ssd_chunk import ssd_chunk_cuda

    X, Adt, B, C = _ssd_inputs(cuda, 1, 1, 1, 32, 16, 16, "float32")
    with pytest.raises(TypeError, match="dtype"):
        ssd_chunk_cuda(X.half(), Adt.half(), B.half(), C.half(), chunk=32)
    with pytest.raises(ValueError, match="Adt"):
        ssd_chunk_cuda(X, Adt.bfloat16(), B, C, chunk=32)
    # every width from 1 up runs (X 24 wide, a chunk of 272, and p or n of
    # 257 on the _wide kernel included); a width below 1, a chunk that
    # does not divide L and one past 4,096 raise
    from repro_torch.kernels.ssd_chunk import ssd_chunks

    for args in ((torch.cat([X] * 17, -1)[..., :257], Adt, B, C),
                 (X, Adt, *(torch.cat([t] * 17, -1)[..., :257]
                            for t in (B, C)))):
        _assert_ssd_close(ssd_chunk_cuda(*args, chunk=32),
                          ssd_chunks(*args, chunk=32, backend="torch"),
                          "float32", exact=_ssd_f64(*args, 32)
                          if args[2].shape[-1] > 256 else None)
    with pytest.raises(ValueError, match="width 0 .* 1 and up"):
        ssd_chunk_cuda(X[..., :0], Adt, B, C, chunk=32)
    with pytest.raises(ValueError, match="not a multiple of the chunk 24"):
        ssd_chunk_cuda(X, Adt, B, C, chunk=24)
    with pytest.raises(ValueError, match="chunk 8192 not supported: 1 to "
                                         "4096"):
        ssd_chunk_cuda(*_ssd_inputs(cuda, 1, 1, 1, 8192, 16, 16,
                                    "float32"), chunk=8192)
    with pytest.raises(ValueError, match="chunk 0 "):
        ssd_chunk_cuda(X, Adt, B, C, chunk=0)
    for t in (ssd_chunk_cuda(torch.cat([X, X[..., :8]], -1), Adt, B, C,
                             chunk=32),
              ssd_chunk_cuda(*_ssd_inputs(cuda, 1, 1, 1, 272, 16, 16,
                                          "float32"), chunk=272)):
        assert all(torch.isfinite(x).all() for x in t)
    with pytest.raises(ValueError, match="group"):
        ssd_chunk_cuda(*_ssd_inputs(cuda, 1, 3, 1, 32, 16, 16, "float32",
                                    g=2), chunk=32)


def test_mamba2_layer_kernel_route_matches_plain(cuda):
    """One Mamba2-370m layer at full width through ``mamba_prefill`` on the
    kernel route, against the same layer on the plain route, float32; one
    kernel launch per layer."""
    import dataclasses
    import functools

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_chunk import KERNEL
    from repro_torch.models import Model, init_cache
    from repro_torch.models import mamba

    cfg = dataclasses.replace(get_config("mamba2-370m", dtype="float32"),
                              n_layers=1)
    model = Model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 500), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    route = mamba.ssd_chunks
    out = {}
    for backend in ("auto", "torch"):
        mamba.ssd_chunks = functools.partial(route, backend=backend)
        try:
            caches = init_cache(cfg, 2, 512, device=cuda)
            before = KERNEL.launches
            with torch.inference_mode():
                logits, caches, _ = model.prefill(params, {"tokens": tokens},
                                                  caches)
            launched = KERNEL.launches - before
        finally:
            mamba.ssd_chunks = route
        out[backend] = (logits, caches["blocks"]["l0"]["ssm"], launched)
    assert out["auto"][2] == 1 and out["torch"][2] == 0
    torch.testing.assert_close(out["auto"][0], out["torch"][0], rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(out["auto"][1], out["torch"][1], rtol=1e-4,
                               atol=1e-4)


# ------------------------------------- the redesigned kernels (tensor cores)
def _attn_inputs(cuda, B, Hq, Hkv, Sq, Sk, dh, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = (0.5 * torch.randn(B, Hq, Sq, dh, generator=g, device=cuda)).to(dtype)
    k = (0.5 * torch.randn(B, Hkv, Sk, dh, generator=g, device=cuda)).to(dtype)
    v = torch.randn(B, Hkv, Sk, dh, generator=g, device=cuda).to(dtype)
    return q, k, v


def _assert_bf16_close(got, want):
    """The bf16 gates of chip_smoke.py: 2e-2 elementwise and 1e-2 of the
    largest output."""
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dh", [32, 64, 96, 128])
def test_flash_tensor_core_kernel_matches_plain(cuda, dh, causal):
    """bf16 takes the wgmma kernel: every head width, causal and full,
    GQA 12 / 2, two kv tiles and a ragged tail (S = 300)."""
    from repro_torch.kernels.flash_attention import (KERNEL, attention_ref,
                                                     flash_attention_cuda,
                                                     launch_geometry)

    assert launch_geometry(torch.bfloat16, 1, 12, 300, dh)[0] == "tensor-core"
    q, k, v = _attn_inputs(cuda, 1, 12, 2, 300, 300, dh, torch.bfloat16,
                           dh + causal)
    before = KERNEL.launches
    got = flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    _assert_bf16_close(got, attention_ref(q, k, v, causal=causal))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [64, 100, 1500])
def test_flash_tensor_core_through_wrapper(cuda, S, causal):
    """Sq = Sk in {64, 100, 1500} through ``flash_attention``, which pads
    to the TPU kernel's blocks and masks the padding with kv_len."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)

    q, k, v = _attn_inputs(cuda, 2, 4, 2, S, S, 64, torch.bfloat16, S)
    got = flash_attention(q, k, v, causal=causal, backend="cuda")
    _assert_bf16_close(got, attention_ref(q, k, v, causal=causal))


@pytest.mark.parametrize("kv_len", [0, 1, 77, 200])
def test_flash_tensor_core_kv_len(cuda, kv_len):
    """kv_len < Sk straight into the kernel, down to every key masked
    (kv_len = 0: the reference averages V over all Sk keys)."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)

    q, k, v = _attn_inputs(cuda, 2, 4, 2, 130, 256, 64, torch.bfloat16,
                           kv_len)
    got = flash_attention_cuda(q, k, v, causal=False, kv_len=kv_len)
    _assert_bf16_close(got, attention_ref(q, k, v, causal=False,
                                          kv_len=kv_len))


def test_flash_tensor_core_unaligned_view(cuda):
    """A contiguous bf16 view that does not start on 16 bytes is copied
    for TMA, not refused."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)

    q, k, v = _attn_inputs(cuda, 1, 2, 2, 128, 128, 32, torch.bfloat16, 5)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    qv = flat[1:].view_as(q)
    qv.copy_(q)
    assert qv.is_contiguous() and qv.data_ptr() % 16
    got = flash_attention_cuda(qv, k, v, causal=True)
    _assert_bf16_close(got, attention_ref(q, k, v, causal=True))


GAIN_NS = (0, 1, 63, 64, 65)  # and K


def _logdet_linv(feats, n, kern, a):
    """The LogDet state's Linv for summaries holding the first n rows of
    feats (I, K, d): the inverse Cholesky factor of I + a k(F_n, F_n),
    zero outside its n x n block."""
    from repro_torch.kernelmath import pairwise_traced

    K = feats.shape[-2]
    eye = torch.eye(K, device=feats.device)
    L = torch.linalg.cholesky(eye + a * pairwise_traced(feats, feats, kern))
    linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    live = torch.arange(K, device=feats.device) < n[:, None]  # (I, K)
    return (linv * (live[:, :, None] & live[:, None, :])).contiguous()


@pytest.mark.parametrize("K", [100, 1024])
@pytest.mark.parametrize("B", [1, 7, 1024, 1025])
@pytest.mark.parametrize("I", [1, 49, 147])
def test_gain_traced_tiles_match_plain(cuda, I, B, K):
    """Every tile the geometry picks (8 to 64 rows), ragged B, stacked
    summaries whose n cycle through 0, 1, 63, 64, 65 and K (at I = 1
    each n in its own call), both kernel kinds, against LogDet's own
    factors (``test_gain_traced_matches_plain`` takes any Linv)."""
    from repro_torch.kernelmath import KernelParams
    from repro_torch.kernels.rbf_gain import gain_traced, gain_traced_ref

    d = 64
    g = torch.Generator(device=cuda).manual_seed(I + B + K)
    X = 0.2 * torch.randn(B, d, generator=g, device=cuda)
    feats = 0.2 * torch.randn(I, K, d, generator=g, device=cuda)
    ns = [*GAIN_NS, K]
    calls = ([torch.tensor([n], dtype=torch.int32, device=cuda) for n in ns]
             if I == 1 else
             [torch.tensor([ns[i % len(ns)] for i in range(I)],
                           dtype=torch.int32, device=cuda)])
    for kind in (0, 1):
        kern = KernelParams(torch.tensor(3.0, device=cuda),
                            torch.tensor(kind, dtype=torch.int32,
                                         device=cuda))
        for n in calls:
            linv = _logdet_linv(feats, n, kern, 1.0)
            got = gain_traced(X, feats, linv, n, kern.inv2l2.reshape(1),
                              kern.kind_id.reshape(1), a=1.0)
            want = gain_traced_ref(X, feats, linv, n, kern, a=1.0)
            assert got.shape == (I, B)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["rbf", "linear_norm"])
@pytest.mark.parametrize("B", [1, 65536])
def test_gain_static_paper_shapes_match_plain(cuda, kind, B):
    """An ISI query (B = 1) and a Greedy round (B = 65,536) at the
    comparison's K = 100, d = 256, n in {0, 37, 100}."""
    from repro_torch.kernels.rbf_gain import gain_ref, gain_static

    K, d = 100, 256
    g = torch.Generator(device=cuda).manual_seed(B)
    X = torch.randn(B, d, generator=g, device=cuda) / d ** 0.5
    feats = torch.randn(K, d, generator=g, device=cuda) / d ** 0.5
    linv = torch.tril(0.1 * torch.randn(K, K, generator=g, device=cuda))
    linv += torch.eye(K, device=cuda)
    for n in (0, 37, K):
        nt = torch.tensor([n], dtype=torch.int32, device=cuda)
        got = gain_static(X, feats, linv, nt, a=1.0, inv2l2=0.5, kind=kind)
        mask = (torch.arange(K, device=cuda) < n).float()[None, :]
        want = gain_ref(X, feats, linv, mask, a=1.0, inv2l2=0.5,
                        kind=kind)[:, 0]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------- bf16 summaries on the card
def _bf16_three_sieves(cuda, backend=None, K=12, d=9):
    from repro_torch.core.functions import KernelConfig, LogDet
    from repro_torch.core.threesieves import ThreeSieves

    f = LogDet(K=K, d=d, kernel=KernelConfig("rbf", 0.5),
               dtype=torch.bfloat16, backend=backend, device=cuda)
    return ThreeSieves(f=f, T=6, eps=0.1)


def test_pod_step_kernel_bf16_matches_plain(cuda):
    """A bf16 carry through the pod-step kernel (storage bf16, arithmetic
    float32, the TPU kernel's rounding points) against the plain per-slot
    loop: integers equal, fval within 0.05 (tests/test_pod_step_kernel.py's
    bf16 pin), feats / L / Linv still bf16; decisions within a bf16 ulp of
    their threshold would be near-ties, and the fixture has none."""
    from repro_torch.kernels.pod_step import pod_step, pod_step_ref
    from repro_torch.tree import tree_map

    algo = _bf16_three_sieves(cuda)
    rows = [algo.init(algo.hyper(K=k, kernel_kind=kind))
            for k, kind in ((12, "rbf"), (5, "linear_norm"), (8, "rbf"))]
    ker = tree_map(lambda *xs: torch.stack(xs), *rows)
    ref = tree_map(lambda t: t.clone(), ker)
    g = torch.Generator(device=cuda).manual_seed(0)
    margins = []
    for C, counts in ((40, [40, 17, 0]), (1, [1, 1, 0]), (40, [40, 40, 3])):
        chunks = torch.randn(3, C, 9, generator=g, device=cuda)
        counts = torch.tensor(counts, dtype=torch.int32, device=cuda)
        pod_step(algo, ker, chunks, counts, backend="cuda")
        margins += [{} for _ in range(3)]
        ref = pod_step_ref(algo, ref, chunks, counts, margins=margins[-3:])
        for a, b in ((ker.ld.n, ref.ld.n), (ker.j, ref.j), (ker.t, ref.t),
                     (ker.n_fused, ref.n_fused),
                     (ker.ld.n_queries, ref.ld.n_queries)):
            assert torch.equal(a, b)
        for name in ("feats", "L", "Linv", "fval"):
            assert getattr(ker.ld, name).dtype == torch.bfloat16, name
        torch.testing.assert_close(ker.ld.fval.float(), ref.ld.fval.float(),
                                   rtol=0.05, atol=0.05)
        assert torch.equal(ker.ld.feats, ref.ld.feats)
    assert min(m for d in margins for m in d.values()) > 1e-2
    assert int(ker.ld.n.sum()) > 0


def test_bf16_gains_kernel_matches_plain(cuda):
    """A bf16 summary's gains through the float32 kernels (the wrapper
    upcasts x, feats and Linv, exactly) against the plain route, both cast
    to bf16 by the oracle: within one bf16 ulp (2^-7 relative), as the two
    float32 results round to neighbours at most."""
    from repro_torch.core.functions import KernelConfig, LogDet
    from repro_torch.kernelmath import KernelParams
    from repro_torch.kernels.rbf_gain import KERNEL, KERNEL_STATIC

    g = torch.Generator(device=cuda).manual_seed(4)
    K, d, B = 40, 24, 500
    f = LogDet(K=K, d=d, kernel=KernelConfig("rbf", 1.5),
               dtype=torch.bfloat16, device=cuda)
    st = f.init()
    for x in 0.5 * torch.randn(30, d, generator=g, device=cuda):
        st = f.append(st, x)
    X = 0.5 * torch.randn(B, d, generator=g, device=cuda)
    kern = KernelParams(torch.tensor(0.2222, device=cuda),
                        torch.tensor(0, dtype=torch.int32, device=cuda))
    plain = LogDet(K=K, d=d, kernel=f.kernel, dtype=torch.bfloat16,
                   backend="torch", device=cuda)
    for kp in (kern, None):
        counter = KERNEL if kp is not None else KERNEL_STATIC
        before = counter.launches
        got = f.gains(st, X, kp)
        assert counter.launches == before + 1
        want = plain.gains(st, X, kp)
        assert got.dtype == want.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=2 ** -7)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_head_width_96_matches_plain(cuda, dtype, causal):
    """phi3-mini-3.8b's head width on both routes (bf16: three 64-byte
    swizzled column blocks, m64n96k16; float32: the CUDA-core kernel),
    ragged S = 300 through the padding wrapper, 32 / 32 heads."""
    from repro_torch.kernels.flash_attention import (KERNEL, attention_ref,
                                                     flash_attention)

    dt = getattr(torch, dtype)
    q, k, v = _attn_inputs(cuda, 1, 32, 32, 300, 300, 96, dt, 96 + causal)
    before = KERNEL.launches
    got = flash_attention(q, k, v, causal=causal, backend="cuda")
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    want = attention_ref(q, k, v, causal=causal)
    if dt == torch.bfloat16:
        _assert_bf16_close(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


ANY_DH = [8, 12, 24, 40, 48, 80, 100, 112, 136, 160, 192, 200, 256]


@pytest.mark.parametrize("dh", ANY_DH)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_any_head_width_matches_plain(cuda, dtype, dh):
    """Every head width up to 256 launches the kernel: the narrowest
    instance at least as wide, the columns past dh read as zeros (TMA's
    fill in bf16, predicated loads in float32) and never stored; a bf16
    width that is no multiple of 8 (12, 100) is staged zero-padded.  bf16
    causal GQA 8 / 2 at S = 300; float32 ragged (Sq 70, Sk 90, kv_len
    77, GQA 4 / 2); the scale is the real width's."""
    from repro_torch.kernels.flash_attention import (KERNEL, attention_ref,
                                                     flash_attention,
                                                     flash_attention_cuda)

    dt = getattr(torch, dtype)
    before = KERNEL.launches
    if dt == torch.bfloat16:
        q, k, v = _attn_inputs(cuda, 2, 8, 2, 300, 300, dh, dt, dh)
        got = flash_attention(q, k, v, causal=True, backend="cuda")
        _assert_bf16_close(got, attention_ref(q, k, v, causal=True))
    else:
        q, k, v = _attn_inputs(cuda, 2, 4, 2, 70, 90, dh, dt, dh)
        got = flash_attention_cuda(q, k, v, causal=False, kv_len=77)
        want = attention_ref(q, k, v, causal=False, kv_len=77)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1 and got.shape == q.shape


def test_mamba2_layer_bf16_takes_the_tensor_core_route(cuda):
    """One Mamba2-370m layer at full width in bf16: the prefill's one SSD
    launch takes the tensor-core kernel on B / C per group, and its
    logits stay within chip_smoke.py's bf16 gate (5e-2) of the plain
    route."""
    import dataclasses
    import functools

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_chunk import ROUTE_LAUNCHES
    from repro_torch.models import Model, init_cache
    from repro_torch.models import mamba

    cfg = dataclasses.replace(get_config("mamba2-370m"), n_layers=1)
    assert cfg.dtype == "bfloat16"
    model = Model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 500), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    route = mamba.ssd_chunks
    out = {}
    for backend in ("auto", "torch"):
        mamba.ssd_chunks = functools.partial(route, backend=backend)
        try:
            before = ROUTE_LAUNCHES["tensor-core"]
            with torch.inference_mode():
                logits, _, _ = model.prefill(
                    params, {"tokens": tokens},
                    init_cache(cfg, 2, 512, device=cuda))
            out[backend] = (logits, ROUTE_LAUNCHES["tensor-core"] - before)
        finally:
            mamba.ssd_chunks = route
    assert out["auto"][1] == 1 and out["torch"][1] == 0
    err = (out["auto"][0].float() - out["torch"][0].float()).abs().max()
    assert float(err) <= 5e-2


# ---------------------------------------------------- grouped gain_traced
@pytest.mark.parametrize("G,per", [(1, 49), (4, 3), (16, 49), (64, 5)])
@pytest.mark.parametrize("B", [1, 300, 1024])
def test_gain_traced_groups_match_plain(cuda, G, per, B):
    """Grouped candidates (one chunk and one kernel per group of
    summaries) against the plain version, and each group bit for bit the
    ungrouped launch of its own summaries; G = 1 bit for bit the call
    without a group axis."""
    from repro_torch.kernelmath import KernelParams
    from repro_torch.kernels.rbf_gain import gain_traced, gain_traced_ref

    g = torch.Generator(device=cuda).manual_seed(G * 1000 + B)
    K, d, I = 100, 64, G * per
    X = 0.2 * torch.randn(G, B, d, generator=g, device=cuda)
    feats = 0.2 * torch.randn(I, K, d, generator=g, device=cuda)
    n = torch.randint(0, K + 1, (I,), generator=g, device=cuda,
                      dtype=torch.int32)
    inv2l2 = 1.0 + 3.0 * torch.rand(G, generator=g, device=cuda)
    kind = (torch.arange(G, device=cuda) % 2).to(torch.int32)
    # each group's summaries carry LogDet's own factors under its kernel
    linv = torch.cat([_logdet_linv(
        feats[j * per:(j + 1) * per], n[j * per:(j + 1) * per],
        KernelParams(inv2l2[j], kind[j]), 1.0) for j in range(G)])
    got = gain_traced(X, feats, linv, n, inv2l2, kind, a=1.0)
    want = gain_traced_ref(X, feats, linv, n, KernelParams(inv2l2, kind),
                           a=1.0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for j in range(G):
        rows = slice(j * per, (j + 1) * per)
        one = gain_traced(X[j].contiguous(), feats[rows].contiguous(),
                          linv[rows].contiguous(), n[rows].contiguous(),
                          inv2l2[j:j + 1].contiguous(),
                          kind[j:j + 1].contiguous(), a=1.0)
        assert torch.equal(got[rows], one), j
    if G == 1:
        flat = gain_traced(X[0].contiguous(), feats, linv, n, inv2l2, kind,
                           a=1.0)
        assert torch.equal(got, flat)
    if G > 1:  # groups that do not split the summaries evenly
        with pytest.raises(ValueError, match="equal runs per group"):
            gain_traced(X, feats[:I - 1].contiguous(),
                        linv[:I - 1].contiguous(), n[:I - 1].contiguous(),
                        inv2l2, kind, a=1.0)
    with pytest.raises(ValueError, match=f"inv2l2 must be {G} "):
        gain_traced(X, feats, linv, n, inv2l2.repeat(2), kind, a=1.0)


def _stacked_tenants(cuda, name, S, K=20, d=16):
    from repro_torch.core.api import make
    from repro_torch.core.spec import SessionSpec
    from repro_torch.tree import tree_map

    spec = SessionSpec(algo=name, K=K, d=d, eps=0.2, lengthscale=0.6)
    algo = make(spec, device=cuda)
    plain = make(spec.replace(backend="torch"), device=cuda)
    rows = [algo.init(algo.hyper(K=(K, 5, 12)[s % 3], lengthscale=(
        0.6, 0.9, 0.4)[s % 3], kernel_kind=("rbf", "linear_norm")[s % 2]))
        for s in range(S)]
    return algo, plain, tree_map(lambda *xs: torch.stack(xs), *rows)


@pytest.mark.parametrize("name", ["sievestreaming", "sievestreaming++",
                                  "salsa"])
def test_stacked_pod_step_matches_the_per_slot_loop(cuda, name):
    """The batched stacked-sieve step (one grouped ``gain_traced`` launch
    per round) against the per-slot loop of ``run_batched`` on the same
    kernel and against the plain loop: integers equal, floats within
    1e-5 (the appends run as batched products of another shape); the
    first round's gains bit for bit the per-slot launches', as the same
    kernel prices the same rows."""
    from repro_torch.kernels.pod_step import pod_step
    from repro_torch.kernels.rbf_gain import KERNEL
    from repro_torch.tree import leaves_with_keys, tree_map

    S, C, d = 6, 64, 16
    algo, plain, fast = _stacked_tenants(cuda, name, S)
    loop = tree_map(lambda t: t.clone(), fast)
    ref = tree_map(lambda t: t.clone(), fast)
    g = torch.Generator(device=cuda).manual_seed(3)
    for counts in ([C, 0, 17, C, 1, 40], [5, C, C, 0, 33, C]):
        chunks = 0.5 * torch.randn(S, C, d, generator=g, device=cuda)
        counts = torch.tensor(counts, dtype=torch.int32, device=cuda)
        grouped = algo._gains_slots(fast, chunks)
        for s in range(S):
            row = tree_map(lambda t, s=s: t[s], fast)
            assert torch.equal(grouped[s], algo._gains_all(row, chunks[s]))
        before = KERNEL.launches
        pod_step(algo, fast, chunks, counts, backend="cuda")
        rounds = KERNEL.launches - before
        pod_step(algo, loop, chunks, counts, backend="torch")
        pod_step(plain, ref, chunks, counts, backend="torch")
        loop_launches = KERNEL.launches - before - rounds
        assert 0 < rounds < loop_launches
        a = leaves_with_keys(fast)
        for other in (loop, ref):
            b = leaves_with_keys(other)
            for k in a:
                if a[k].dtype.is_floating_point:
                    torch.testing.assert_close(a[k], b[k], rtol=1e-5,
                                               atol=1e-5)
                else:
                    assert torch.equal(a[k], b[k]), k


def test_pipeline_final_state_equals_direct_ingest(cuda):
    """The double-buffered pipeline (pinned copy on a side stream, routed
    on the card) ends in the state of ``pod.ingest`` per batch, bit for
    bit."""
    import numpy as np

    from repro_torch.core.api import make
    from repro_torch.ingest import IngestPipeline, ReplaySource
    from repro_torch.serve.summarize import SummarizerPod
    from repro_torch.tree import leaves_with_keys

    S, C, d, B = 8, 32, 16, 128
    algo = make("threesieves", K=10, d=d, eps=0.1, T=20, lengthscale=0.7,
                device=cuda)
    pod = SummarizerPod(algo=algo, sessions=S, chunk=C, device=cuda)
    rng = np.random.default_rng(0)
    feed = [(rng.integers(0, S, B).astype(np.int32),
             rng.standard_normal((B, d)).astype(np.float32))
            for _ in range(5)]

    def fresh():
        st = pod.init()
        for sid in range(S):
            st, _, _ = pod.admit(st, sid)
        return st

    direct = fresh()
    for sids, X in feed:
        direct, _ = pod.ingest(direct, torch.from_numpy(sids).to(cuda),
                               torch.from_numpy(X).to(cuda))
    timings = []
    pipe = IngestPipeline(pod, source=ReplaySource.from_batches(feed),
                          batch=B, timings=timings)
    st, stats = pipe.run(fresh())
    a, b = leaves_with_keys(direct), leaves_with_keys(st)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert stats["batches"] == 5 and len(timings) == 5
    assert all(t["h2d"][1] >= t["h2d"][0] and t["step"][1] >= t["step"][0]
               for t in timings)


def _card_pod(cuda, dtype=torch.float32, S=8, C=32, d=16, K=10):
    from repro_torch.core.functions import KernelConfig, LogDet
    from repro_torch.core.threesieves import ThreeSieves
    from repro_torch.serve.summarize import SummarizerPod

    f = LogDet(K=K, d=d, kernel=KernelConfig("rbf", 0.7), dtype=dtype,
               device=cuda)
    return SummarizerPod(algo=ThreeSieves(f=f, T=20, eps=0.1), sessions=S,
                         chunk=C, device=cuda)


def _card_batches(cuda, S, d, n, B=128, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [(torch.randint(0, S, (B,), generator=g, device=cuda,
                           dtype=torch.int32),
             torch.randn(B, d, generator=g, device=cuda))
            for _ in range(n)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip_on_the_card_bit_equal(cuda, tmp_path, dtype):
    """checkpoint -> restore -> continue on the card: from the disk store
    (sync and async) and the memory store, the continued pod equals the
    pod that never stopped, bit for bit, f32 and bf16."""
    from repro_torch.ckpt import CheckpointStore, MemoryStore
    from repro_torch.tree import leaves_with_keys

    pod = _card_pod(cuda, getattr(torch, dtype))
    st = pod.init()
    for sid in range(pod.sessions):
        st, _, _ = pod.admit(st, sid)
    batches = _card_batches(cuda, pod.sessions, 16, 3)
    for sids, X in batches[:2]:
        st, _ = pod.ingest(st, sids, X)
    disk, mem = CheckpointStore(tmp_path), MemoryStore()
    pod.save(disk, 1, st)
    disk.save_async(2, st)
    pod.save(mem, 1, st)
    cont, _ = pod.ingest(st, *batches[2])
    disk.wait()
    want = leaves_with_keys(cont)
    assert want["algo/ld/feats"].dtype == getattr(torch, dtype)
    for store, step in ((disk, 1), (disk, 2), (mem, 1)):
        got, _ = pod.restore(store, step)
        assert got.sid.device.type == cuda.type
        got, _ = pod.ingest(got, *batches[2])
        got = leaves_with_keys(got)
        assert all(torch.equal(got[k], want[k]) for k in want), (store, step)


def test_handoff_moves_sessions_bit_equal_to_the_control_fleet(cuda):
    """Two pods on the card under a fleet of buffer-mode pipelines: the
    sessions moved by ``maybe_rebalance`` end bit for bit where the same
    batches leave them in a fleet that never moved them."""
    import numpy as np

    from repro_torch.ingest import IngestPipeline, PodRouter, TaggedBuffer
    from repro_torch.serve import PodAutoscaler, ScalePolicy
    from repro_torch.tree import leaves_with_keys, tree_map

    S, d, C = 8, 16, 64
    rng = np.random.default_rng(3)
    feed = [(rng.integers(0, 12, 48).astype(np.int32),
             rng.standard_normal((48, d)).astype(np.float32))
            for _ in range(3)]

    def run(move):
        pods = {0: _card_pod(cuda, S=S, C=C), 1: _card_pod(cuda, S=S, C=C)}
        pipes = {i: IngestPipeline(p, buffer=TaggedBuffer(4096), batch=64,
                                   get_timeout=30.0)
                 for i, p in pods.items()}
        router = PodRouter(pipelines=pipes)
        states = {i: p.init() for i, p in pods.items()}
        for sid in range(12):
            pid = 0 if sid < 8 else 1
            states[pid], _, _ = pods[pid].admit(states[pid], sid)
            router.assign([sid], pid)
        asc = PodAutoscaler(router=router, pods=pods, policy=ScalePolicy(
            max_occupancy=0.9, victims=3))
        rep = None
        for i, (sids, X) in enumerate(feed):
            router.put(sids, X)
            if move and i == 1:
                states, rep = asc.maybe_rebalance(states)
            for pid in pods:
                states[pid], _ = pipes[pid].run(states[pid], max_batches=1)
        rows = {}
        for pid, p in pods.items():
            for sid, slot in p.routing_table(states[pid]).items():
                rows[sid] = leaves_with_keys(
                    tree_map(lambda l: l[slot], states[pid]))
        return rows, rep

    moved, rep = run(True)
    control, _ = run(False)
    assert rep is not None and rep.ok and len(rep.moved) == 3
    assert sorted(moved) == sorted(control) == list(range(12))
    for sid in moved:
        for k in control[sid]:
            if k == "drops_unknown":
                continue  # the pod-scoped ledger stays with the pod
            assert torch.equal(moved[sid][k], control[sid][k]), (sid, k)


def test_merge_kernel_route_matches_the_plain_route(cuda):
    """``DistributedSummarizer.merge`` on ``gain_static`` (one launch a
    round) against the same merge on the plain route."""
    from repro_torch.core.api import make
    from repro_torch.data import DistributedSummarizer
    from repro_torch.kernels.rbf_gain import KERNEL_STATIC

    kw = dict(K=12, d=16, T=30, eps=0.1, lengthscale=2.0)
    algo = make("threesieves", device=cuda, **kw)
    plain = make("threesieves", backend="torch", device=cuda, **kw)
    g = torch.Generator(device=cuda).manual_seed(0)
    X = torch.randn(4 * 256, 16, generator=g, device=cuda)
    X += 3.0 * torch.arange(4, device=cuda).repeat_interleave(256)[:, None]
    dist = DistributedSummarizer(algo, shards=4)
    states = dist.update(dist.init(), X)
    KERNEL_STATIC.launches = 0
    ker = dist.merge(states).ld
    assert KERNEL_STATIC.launches == 12
    ref = DistributedSummarizer(plain, shards=4).merge(states).ld
    assert int(ker.n) == int(ref.n) > 1
    assert torch.equal(ker.feats, ref.feats)
    torch.testing.assert_close(ker.fval, ref.fval, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ker.Linv, ref.Linv, rtol=1e-5, atol=1e-5)


# ------------------------------------------ MoE, MLA and Jamba's SSD groups
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_jamba_groups_match_plain(cuda, dtype):
    """B / C in 8 groups of 32 heads (Jamba's published SSD layout, 256
    heads) at a cut length: the dtype's kernel against the plain version
    under the gates of ``_assert_ssd_close``."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk_cuda, ssd_chunks

    X, Adt, B, C = _ssd_inputs(cuda, 1, 256, 2, 256, 64, 128, dtype, g=8,
                               seed=8)
    got = ssd_chunk_cuda(X, Adt, B, C, chunk=256)
    _assert_ssd_close(got, ssd_chunks(X, Adt, B, C, chunk=256,
                                      backend="torch"), dtype)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "grok-1-314b",
                                  "jamba-1.5-large-398b"])
def test_reduced_moe_models_on_the_card_match_the_cpu(cuda, arch):
    """The reduced MoE models on the card against the same parameters on
    the CPU: train logits and aux, prefill and one decode step, float32
    within the port's model tolerance (1e-4).  Float32, not the configs'
    bf16: bf16 rounding that differs between cuBLAS and the CPU moves
    some top-k router choices (grok and jamba failed a 5e-2 bf16 gate on
    the H100 that way), a step no fixed tolerance bounds.  The plain
    attention route (flash at the reduced head width, 16, is held by
    ``test_flash_head_width_16_matches_plain``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model, init_cache
    from repro_torch.models.layers import tree_map

    cfg = get_config(arch, reduced=True, dtype="float32")
    cpu = Model(cfg, device="cpu")
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    card = Model(cfg, device=cuda)
    p_card = card.load(tree_map(lambda t: t.to(cuda), p_cpu))
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    out = {}
    with torch.inference_mode():
        for name, m, p, dev in (("cpu", cpu, p_cpu, "cpu"),
                                ("card", card, p_card, cuda)):
            tok = tokens.to(dev)
            logits, aux = m.train_logits(p, {"tokens": tok})
            caches = init_cache(cfg, 2, 20, device=dev)
            last, caches, _ = m.prefill(p, {"tokens": tok[:, :15]}, caches)
            step, _ = m.decode_step(p, tok[:, 15:], caches, 15)
            out[name] = [t.float().cpu() for t in (logits, aux, last, step)]
    for a, b in zip(out["card"], out["cpu"]):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# ------------------------------------------- training through the kernels
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [64, 300])
def test_flash_head_width_16_matches_plain(cuda, dtype, causal, S):
    """Head width 16 (every reduced config's), GQA, on both kernels: bf16
    on the tensor cores (32-byte swizzle, m64n16k16), float32 on the CUDA
    cores; S = 300 pads to 384 keys."""
    from repro_torch.kernels.flash_attention import (KERNEL, attention_ref,
                                                     flash_attention)

    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(S + causal)
    q = (0.5 * torch.randn(2, 4, S, 16, generator=g, device=cuda)).to(dt)
    k = (0.5 * torch.randn(2, 2, S, 16, generator=g, device=cuda)).to(dt)
    v = torch.randn(2, 2, S, 16, generator=g, device=cuda).to(dt)
    before = KERNEL.launches
    got = flash_attention(q, k, v, causal=causal, backend="cuda")
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    want = attention_ref(q, k, v, causal=causal)
    tol = 2e-2 if dt == torch.bfloat16 else 2e-4
    assert got.dtype == dt
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _grads_of(fn, inputs, seed=0):
    xs = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator(device=xs[0].device).manual_seed(seed)
    loss = sum((o.float() * torch.randn(o.shape, generator=g,
                                        device=o.device)).sum()
               for o in outs)
    return torch.autograd.grad(loss, xs)


@pytest.mark.parametrize("route", ["ssd", "flash"])
def test_kernel_route_gradient_is_the_plain_gradient(cuda, route):
    """The kernel routes under ``with_plain_grad`` (float32): the input
    gradients equal those of the plain route, which runs the same plain
    autograd on the same inputs; the forward launched the kernel once."""
    from repro_torch.kernels.flash_attention import KERNEL as FLASH
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_chunk import KERNEL as SSD
    from repro_torch.kernels.ssd_chunk import ssd_chunks

    g = torch.Generator(device=cuda).manual_seed(5)
    if route == "ssd":
        kern = SSD
        inputs = (0.5 * torch.randn(2, 64, 4, 16, generator=g, device=cuda),
                  -0.1 * torch.rand(2, 64, 4, generator=g, device=cuda),
                  0.5 * torch.randn(2, 64, 2, 16, generator=g, device=cuda),
                  0.5 * torch.randn(2, 64, 2, 16, generator=g, device=cuda))

        def run(backend):
            return lambda *x: ssd_chunks(*x, chunk=16, backend=backend)
    else:
        kern = FLASH
        inputs = tuple(torch.randn(2, h, 100, 16, generator=g, device=cuda)
                       for h in (4, 2, 2))

        def run(backend):
            return lambda *x: flash_attention(*x, causal=True,
                                              backend=backend)
    before = kern.launches
    got = _grads_of(run("cuda"), inputs)
    assert kern.launches == before + 1
    want = _grads_of(run("torch"), inputs)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_kernel_route_costs_inference_nothing(cuda):
    """Under inference_mode the kernel route returns the kernel's own
    outputs: no autograd node."""
    from repro_torch.kernels.ssd_chunk import ssd_chunks

    X = torch.randn(1, 32, 2, 16, device=cuda, requires_grad=True)
    Adt = -0.1 * torch.rand(1, 32, 2, device=cuda)
    B = torch.randn(1, 32, 1, 16, device=cuda)
    with torch.inference_mode():
        Y, st = ssd_chunks(X, Adt, B, B, chunk=16, backend="cuda")
    assert Y.grad_fn is None and st.grad_fn is None


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-1.5-large-398b",
                                  "qwen2-1.5b", "whisper-small"])
def test_reduced_model_gradients_on_the_kernel_routes(cuda, arch, remat):
    """``Model.loss(...).backward()`` of the reduced models on the card,
    float32, with ``use_pallas_attention`` (flash at head width 16) and
    the SSD kernel: every leaf's gradient within 1e-4 of its largest
    value on the plain routes, with and without remat; each kernel
    launched once per layer, twice under remat."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import KERNEL as FLASH
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_chunk import KERNEL as SSD
    from repro_torch.kernels.ssd_chunk import ssd_chunks
    from repro_torch.models import Model, attention, mamba
    from repro_torch.train.step import TrainStepConfig, make_grad_fn
    from repro_torch.tree import leaves_with_keys

    cfg = dataclasses.replace(get_config(
        arch, reduced=True, dtype="float32", use_pallas_attention=True),
        remat=remat)
    model = Model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 64), generator=g,
                                     device=cuda, dtype=torch.int32)}
    if cfg.encoder is not None:
        batch["frames"] = torch.randn(2, cfg.encoder.n_frames, cfg.d_model,
                                      generator=g, device=cuda)
    grad_fn = make_grad_fn(model, TrainStepConfig())
    n0 = SSD.launches + FLASH.launches
    got = leaves_with_keys(grad_fn(params, batch)[0])
    launched = SSD.launches + FLASH.launches - n0
    kernel_layers = sum(cfg.layer_kind(i) == "M" for i in range(
        cfg.n_layers)) + sum(cfg.layer_kind(i) == "A" for i in range(
            cfg.n_layers)) + (cfg.encoder.n_layers if cfg.encoder else 0)
    assert launched == kernel_layers * (2 if remat else 1)

    def flash_plain(q, k, v, *, causal=True):
        return flash_ops.flash_attention(q, k, v, causal=causal,
                                         backend="torch")

    def ssd_plain(X, Adt, B, C, *, chunk):
        return ssd_chunks(X, Adt, B, C, chunk=chunk, backend="torch")

    saved = mamba.ssd_chunks, attention.flash_attention
    try:
        mamba.ssd_chunks, attention.flash_attention = ssd_plain, flash_plain
        want = leaves_with_keys(grad_fn(params, batch)[0])
    finally:
        mamba.ssd_chunks, attention.flash_attention = saved
    for k, w in want.items():
        size = w.abs().max().item()
        err = (got[k] - w).abs().max().item()
        assert err <= 1e-4 * size, (k, err, size)


# ------------------------------------- scale-out: ranks sharing the card
def _ranks_pod_cfg():
    import numpy as np

    rng = np.random.default_rng(3)
    P, S, N, D = 2, 3, 40, 9
    sids = [[100 + 10 * p + s for s in range(S)] for p in range(P)]
    specs = [[dict(K=12, T=6, eps=0.1, lengthscale=0.5),
              dict(K=5, T=6, eps=0.1, lengthscale=0.5,
                   kernel_kind="linear_norm"),
              dict(K=8, T=6, eps=0.1, lengthscale=0.5)] for _ in range(P)]
    batch_sids = [np.concatenate([rng.choice(sids[p] + [999, -1], size=N)
                                  for p in range(P)]).astype(np.int32)
                  for _ in range(4)]
    batch_X = [rng.standard_normal((P * N, D)).astype(np.float32)
               for _ in range(4)]
    return {"d": D, "algo": dict(K=12, T=6, eps=0.1, lengthscale=0.5),
            "S": S, "C": 16, "N": N, "sids": sids, "specs": specs,
            "segments": [("data", "data", False, [0]),
                         ("data_routed", "data", True, [1]),
                         ("pod_data", "pod_data", False, [2, 3])],
            "batch_sids": batch_sids, "batch_X": batch_X,
            "device": "cuda", "backend": "auto"}


def test_sharded_pod_on_two_ranks_bit_equal_to_one_pod(cuda, tmp_path):
    """Two gloo ranks sharing the card, 3 sessions each, through
    ``make_sharded_update`` (plain, pre-routed, and the ("pod", "data")
    tuple axis) on the ``pod_step`` kernel: every leaf bit for bit the
    one-process pod of the 6 sessions fed the same items (the
    unknown-id ledger, one a pod, in sum)."""
    import _torch_ranks as ranks
    from repro_torch.convert import join_sharded, state_to_numpy

    cfg = _ranks_pod_cfg()
    got = ranks.run_ranks(ranks.sharded_pod_program, 2, tmp_path, cfg)
    pod = ranks._tpod(dict(cfg, S=2 * cfg["S"]))
    state = ranks._admitted(pod, sum(cfg["sids"], []),
                            sum(cfg["specs"], []))
    for name, _, _, batches in cfg["segments"]:
        for b in batches:
            state, _ = pod.ingest(
                state, torch.from_numpy(cfg["batch_sids"][b]).to(cuda),
                torch.from_numpy(cfg["batch_X"][b]).to(cuda))
        want = state_to_numpy(state)
        joined = join_sharded([g[name]["state"] for g in got])
        for k, a in want.items():
            if k == "drops_unknown":  # pod-scoped: on each pod's slot 0
                assert a.sum() == joined[k].sum() > 0, name
                continue
            assert (a == joined[k]).all(), (name, k)


def test_mesh_merge_on_two_ranks_bit_equal_to_the_loop(cuda, tmp_path):
    """``DistributedSummarizer`` on a two-rank gloo mesh on the card (the
    all-gather of CUDA tensors over gloo) against the one-process loop
    at ``shards=2``: the merged summary bit for bit on both ranks."""
    import numpy as np

    import _torch_ranks as ranks
    from repro_torch.convert import state_to_numpy
    from repro_torch.core.api import make
    from repro_torch.data import DistributedSummarizer

    rng = np.random.default_rng(4)
    batches = [rng.standard_normal((2 * 128, 16)).astype(np.float32)
               for _ in range(3)]
    algo = dict(K=12, T=30, eps=0.1, lengthscale=2.0)
    cfg = {"d": 16, "algo": algo, "B": 128, "batches": batches,
           "device": "cuda", "backend": "auto"}
    got = ranks.run_ranks(ranks.sharded_merge_program, 2, tmp_path, cfg)
    loop = DistributedSummarizer(make("threesieves", d=16, device=cuda,
                                      **algo), shards=2)
    states = loop.init()
    for X in batches:
        states = loop.update(states, torch.from_numpy(X).to(cuda))
    want = state_to_numpy(loop.merge(states).ld)
    assert int(want["n"]) > 1
    for g in got:
        for k, a in want.items():
            assert (a == g["merged"][k]).all(), k


def test_one_rank_nccl_collectives_compressor_and_merge(cuda, tmp_path):
    import _torch_ranks as ranks

    out = ranks.run_ranks(ranks.nccl_program, 1, tmp_path, {},
                          backend="nccl")[0]
    assert out == {"gather": True, "reduce": True, "compress": True,
                   "merge": True}


WIDE_DH = [257, 264, 300, 320, 384, 500, 512, 1024]


@pytest.mark.parametrize("dh", WIDE_DH)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_wide_head_width_matches_plain(cuda, dtype, dh):
    """Head widths past 256: O's columns split into ceil(dh / 256) blocks
    along the grid, each block summing S over the full dh from 64-column
    slices of Q and K (bf16: the ``_wide`` tensor-core kernel, TMA and
    wgmma; float32: the ``_wide`` CUDA-core kernel); the route counters
    move by one launch.  bf16 causal GQA 8 / 2 at S = 300 through the
    wrapper (500 is staged zero-padded to 504), float32 ragged (Sq 70, Sk
    90, kv_len 77)."""
    from repro_torch.kernels.flash_attention import (KERNEL, ROUTE_LAUNCHES,
                                                     attention_ref,
                                                     flash_attention,
                                                     flash_attention_cuda)

    dt = getattr(torch, dtype)
    route = "tensor-core" if dt == torch.bfloat16 else "cuda-core"
    before, routed = KERNEL.launches, ROUTE_LAUNCHES[route]
    if dt == torch.bfloat16:
        q, k, v = _attn_inputs(cuda, 2, 8, 2, 300, 300, dh, dt, dh)
        got = flash_attention(q, k, v, causal=True, backend="cuda")
        _assert_bf16_close(got, attention_ref(q, k, v, causal=True))
    else:
        q, k, v = _attn_inputs(cuda, 2, 4, 2, 70, 90, dh, dt, dh)
        got = flash_attention_cuda(q, k, v, causal=False, kv_len=77)
        want = attention_ref(q, k, v, causal=False, kv_len=77)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1 and got.shape == q.shape
    assert ROUTE_LAUNCHES[route] == routed + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_wide_causal_and_short_column(cuda, dtype):
    """dh 320 causal on both routes at S = 1024 (several query and key
    tiles, a block of O on each side of column 160), and the kernel fed
    one column short must fail the bf16 / float32 gate."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)

    dt = getattr(torch, dtype)
    q, k, v = _attn_inputs(cuda, 1, 4, 2, 1024, 1024, 320, dt, 11)
    want = attention_ref(q, k, v, causal=True)
    got = flash_attention_cuda(q, k, v, causal=True)
    short = flash_attention_cuda(*(torch.cat([t[..., :-1], torch.zeros_like(
        t[..., -1:])], -1) for t in (q, k, v)), causal=True)
    scaled = 1e-2 if dt == torch.bfloat16 else 1e-4
    size = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= scaled * size
    assert (short.float() - want.float()).abs().max().item() > scaled * size


ANY_SSD = [  # (p, n, q, g of 4 heads)
    (8, 8, 24, 1), (48, 48, 24, 4), (96, 96, 100, 1), (256, 256, 24, 1),
    (8, 256, 100, 4), (256, 8, 100, 1), (48, 96, 512, 1), (96, 48, 512, 4),
    (256, 256, 512, 1), (8, 8, 1024, 1), (5, 13, 7, 1), (200, 1, 1, 4),
    (1, 120, 300, 1),
    # past 256: the _wide kernels (p in column blocks, n in 64-column
    # slices)
    (320, 320, 64, 1), (320, 320, 256, 4), (512, 512, 64, 4),
    (512, 512, 256, 1), (512, 128, 100, 1), (257, 300, 24, 4),
    (40, 520, 16, 1), (1024, 1024, 64, 1)]


@pytest.mark.parametrize("p,n,q,g", ANY_SSD)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_any_width_and_chunk_matches_plain(cuda, dtype, p, n, q, g):
    """Widths that are no instance (p on the next of 16 .. 256 with zero
    columns, n rounded up to 16 with zero columns; widths that are no
    multiple of 8 staged zero-padded), chunks that are no multiple of 16
    (the last tile's rows past q read zeros) and past 256 (G streamed at
    p = n = 256, q = 512 and at q = 1024), widths past 256 (the _wide
    kernels), B / C per group: one launch on the dtype's route, against
    the plain version."""
    from repro_torch.kernels.ssd_chunk import (KERNEL, ROUTE_LAUNCHES,
                                               ssd_chunk_cuda, ssd_chunks)

    X, Adt, B, C = _ssd_inputs(cuda, 2, 4, 2, q, p, n, dtype, 1.0,
                               p + n + q, g=g)
    route = "tensor-core" if dtype == "bfloat16" else "cuda-core"
    before, routed = KERNEL.launches, ROUTE_LAUNCHES[route]
    Y, st = ssd_chunk_cuda(X, Adt, B, C, chunk=q)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    assert ROUTE_LAUNCHES[route] == routed + 1
    assert Y.shape == X.shape and st.shape == (2, 2, 4, p, n)
    assert torch.isfinite(Y.float()).all() and torch.isfinite(st).all()
    exact = (_ssd_f64(X, Adt, B, C, q) if dtype == "float32" and n > 256
             else None)
    _assert_ssd_close((Y, st), ssd_chunks(X, Adt, B, C, chunk=q,
                                          backend="torch"), dtype, exact)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_past_a_grid_axis_of_65535_matches_plain(cuda, dtype):
    """b h = 65,536 (mamba2-370m's 32 heads at batch 2,048, L = chunk =
    16, p 64, n 128): the float32 launch's (batch, head) axis and the
    bf16 one's (batch, chunk) axis lie on the flat grid; one launch on the
    dtype's route, within the gates of the plain version."""
    from repro_torch.kernels.ssd_chunk import (KERNEL, ROUTE_LAUNCHES,
                                               ssd_chunk_cuda)
    from repro_torch.kernels.ssd_chunk.ops import ssd_plain

    X, Adt, B, C = _ssd_inputs(cuda, 2048, 32, 1, 16, 64, 128, dtype, g=1)
    route = "tensor-core" if dtype == "bfloat16" else "cuda-core"
    before, routed = KERNEL.launches, ROUTE_LAUNCHES[route]
    got = ssd_chunk_cuda(X, Adt, B, C, chunk=16)
    torch.cuda.synchronize()
    assert (KERNEL.launches, ROUTE_LAUNCHES[route]) == (before + 1,
                                                        routed + 1)
    _assert_ssd_close(got, ssd_plain(X, Adt, B, C, chunk=16), dtype)


@pytest.mark.parametrize("dh", [64, 1024])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_past_a_grid_axis_of_65535_matches_plain(cuda, dtype, causal,
                                                        dh):
    """B x column blocks of 65,536 (B = 65,536 at dh 64; 16,384 at dh
    1,024, four blocks), one head, S = 16: the tiles on the flat grid,
    within the flash gates of ``attention_ref``."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_cuda)

    B = 65536 if dh == 64 else 16384
    q, k, v = _attn_inputs(cuda, B, 1, 1, 16, 16, dh, getattr(torch, dtype),
                           dh)
    got = flash_attention_cuda(q, k, v, causal=causal)
    want = attention_ref(q, k, v, causal=causal)
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# ------------------- the float32 kernels: every width, views read in place
F32_FLASH_CASES = [  # (name, B, Hq, Hkv, Sq, Sk, kv_len, causal)
    ("ragged_full", 2, 4, 2, 70, 90, 77, False),
    ("causal_gqa", 1, 6, 2, 130, 130, 121, True),
]


@pytest.mark.parametrize("case", F32_FLASH_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("dh", [8, 96, 256, 264, 1024, 1100])
def test_flash_f32_every_width_matches_plain(cuda, dh, case):
    """The float32 kernel at head widths 8 (the 16 instance), 96 (on 128),
    256, 264 (on 512), 1,024 (the widest one block holds: S once per key
    tile) and 1,100 (two column blocks of 1,024), ragged kv_len, full and
    causal GQA: one launch on the CUDA-core route within 2e-4 elementwise
    and 1e-4 of the largest output of ``attention_ref``; the kernel told
    to keep the keys past kv_len must fail that gate."""
    from repro_torch.kernels.flash_attention import (KERNEL, ROUTE_LAUNCHES,
                                                     attention_ref,
                                                     flash_attention_cuda)

    _, B, Hq, Hkv, Sq, Sk, kv_len, causal = case
    q, k, v = _attn_inputs(cuda, B, Hq, Hkv, Sq, Sk, dh, torch.float32,
                           dh + Sq)
    before, routed = KERNEL.launches, ROUTE_LAUNCHES["cuda-core"]
    got = flash_attention_cuda(q, k, v, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    assert (KERNEL.launches, ROUTE_LAUNCHES["cuda-core"]) == (before + 1,
                                                              routed + 1)
    want = attention_ref(q, k, v, causal=causal, kv_len=kv_len)
    assert got.dtype == torch.float32 and got.shape == q.shape
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    size = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-4 * size
    bad = flash_attention_cuda(q, k, v, causal=causal, kv_len=Sk)
    assert (bad - want).abs().max().item() > 1e-4 * size


def _views(cuda, view, b, L, h, g, p, n, seed):
    """X, Adt, B, C of the model layout as views that are not contiguous:
    ``L`` a slice along the sequence (steps 8 ..), ``h`` a slice of heads
    (and of their groups) of larger tensors."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    Lx, hx, gx = (L + 8, h, g) if view == "L" else (L, 2 * h, 2 * g)
    X = torch.randn(b, Lx, hx, p, generator=gen, device=cuda)
    Adt = -torch.nn.functional.softplus(torch.randn(b, Lx, hx, generator=gen,
                                                    device=cuda))
    B = torch.randn(b, Lx, gx, n, generator=gen, device=cuda)
    C = torch.randn(b, Lx, gx, n, generator=gen, device=cuda)
    if view == "L":
        return X[:, 8:], Adt[:, 8:], B[:, 8:], C[:, 8:]
    # heads h .. 2 h of 2 h and the groups g .. 2 g they read
    hs, gs = slice(h, 2 * h), slice(g, 2 * g)
    return X[:, :, hs], Adt[:, :, hs], B[:, :, gs], C[:, :, gs]


F32_SSD_VIEWS = [  # (view, b, L, h, g, q, p, n)
    ("L", 2, 32, 8, 1, 1, 16, 16),
    ("h", 2, 64, 4, 2, 16, 64, 128),
    ("L", 2, 512, 8, 2, 256, 64, 128),
    ("h", 1, 4096, 2, 1, 4096, 64, 128),
    ("L", 2, 128, 4, 1, 64, 320, 64),
    ("h", 1, 64, 4, 2, 32, 64, 300),
]


@pytest.mark.parametrize("case", F32_SSD_VIEWS,
                         ids=lambda c: f"{c[0]}_g{c[4]}_q{c[5]}_p{c[6]}_n{c[7]}")
def test_ssd_f32_reads_model_views_in_place(cuda, case, monkeypatch):
    """The float32 kernel on views of the model layout that are not
    contiguous (a slice along L, a slice of heads and their groups), B / C
    in one group and in more, chunks of 1, 16, 256 and 4,096, p or n past
    256: read where they lie (no copy of X, B or C), one launch on the
    CUDA-core route, within the plain version's gates (float64 for n past
    256, as ``_assert_ssd_close`` says); the plain output without the
    diagonal must fail them."""
    from repro_torch.kernels.ssd_chunk import (KERNEL, ROUTE_LAUNCHES,
                                               ssd_chunk_cuda)
    from repro_torch.kernels.ssd_chunk import kernel as sk
    from repro_torch.kernels.ssd_chunk.ops import ssd_plain

    view, b, L, h, g, q, p, n = case
    X, Adt, B, C = _views(cuda, view, b, L, h, g, p, n, p + n + q)
    assert not X.is_contiguous() and not B.is_contiguous()
    assert all(sk.reads_in_place(t) for t in (X, B, C))
    copies = []
    clone = torch.Tensor.clone
    monkeypatch.setattr(torch.Tensor, "clone", lambda self, *a, **k: (
        copies.append(self.shape), clone(self, *a, **k))[1])
    before, routed = KERNEL.launches, ROUTE_LAUNCHES["cuda-core"]
    got = ssd_chunk_cuda(X, Adt, B, C, chunk=q)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert copies == []
    assert (KERNEL.launches, ROUTE_LAUNCHES["cuda-core"]) == (before + 1,
                                                              routed + 1)
    want = ssd_plain(X, Adt, B, C, chunk=q)
    _assert_ssd_close(got, want, "float32",
                      _ssd_f64(X, Adt, B, C, q) if n > 256 else None)
    Yr = want[0]
    cb = (C * B).sum(-1, keepdim=True).repeat_interleave(h // g, dim=2)
    bad = Yr - cb * X
    assert (bad - Yr).abs().max().item() > 1e-5 * Yr.abs().max().item()
