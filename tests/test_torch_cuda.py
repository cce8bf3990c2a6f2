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
    """K_max = 600 (BT = 32): feats and Linv of a session far past what
    shared memory could hold; the result is the plain loop's."""
    from repro_torch.core.api import make
    from repro_torch.core.spec import SessionSpec
    from repro_torch.kernels.pod_step import layout, pod_step
    from repro_torch.tree import tree_map

    K, d = 600, 24
    assert layout(K)[0] == 32
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
