# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of ``repro/data/streams.py``: the numpy-drawn streams
(``session_stream``, ``token_stream``, ``deterministic_batch_fn``) equal
the reference value for value; the mixtures, drawn on a
``torch.Generator``, match it in distribution (component count, spread,
noise, drift), each statistic within a bound stated beside it."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import streams as js  # noqa: E402
from repro_torch.data import streams as ts  # noqa: E402


@pytest.mark.parametrize("drift", [0.0, 0.4])
@pytest.mark.parametrize("as_numpy", [True, False])
def test_session_stream_equals_jax(drift, as_numpy):
    spec_j = js.MixtureSpec(n_components=3, d=6, spread=2.0, noise=0.3)
    spec_t = ts.MixtureSpec(n_components=3, d=6, spread=2.0, noise=0.3)
    ids = np.array([7, 9, 11, 13], np.int32)
    jg = js.session_stream(5, spec_j, 4, 17, drift_per_batch=drift,
                           session_ids=ids, as_numpy=True)
    tg = ts.session_stream(5, spec_t, 4, 17, drift_per_batch=drift,
                           session_ids=ids, as_numpy=as_numpy, device="cpu")
    for (a, b), (c, d) in itertools.islice(zip(jg, tg), 4):
        c, d = (c, d) if as_numpy else (c.numpy(), d.numpy())
        assert c.dtype == np.int32 and d.dtype == np.float32
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    with pytest.raises(ValueError, match="session_ids"):
        next(ts.session_stream(0, spec_t, 3, 4, session_ids=ids,
                               device="cpu"))


def test_token_stream_equals_jax():
    spec_j = js.TokenStreamSpec(vocab=29, seq=7, batch=3, embed_d=5)
    spec_t = ts.TokenStreamSpec(vocab=29, seq=7, batch=3, embed_d=5)
    for (jb, je), (tb, te) in itertools.islice(zip(
            js.token_stream(2, spec_j), ts.token_stream(2, spec_t,
                                                        device="cpu")), 3):
        for k in ("tokens", "labels"):
            assert tb[k].dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(jb[k]), tb[k].numpy())
        assert te.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(je), te.numpy())


def test_deterministic_batch_fn_equals_jax():
    spec_j = js.TokenStreamSpec(vocab=50, seq=9, batch=4)
    spec_t = ts.TokenStreamSpec(vocab=50, seq=9, batch=4)
    jf = js.deterministic_batch_fn(3, spec_j)
    tf = ts.deterministic_batch_fn(3, spec_t, device="cpu")
    for step in (0, 5, 5, 1):
        jb, tb = jf(step), tf(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(np.asarray(jb[k]), tb[k].numpy())


def _draw(gen, n):
    return np.concatenate([np.asarray(x) for x in itertools.islice(gen, n)])


def test_gaussian_mixture_matches_in_distribution():
    """Items of both packages: the item spread sqrt(spread^2 + noise^2)
    per coordinate (within 15 %: 16 component means decide it), the
    noise around the nearest mean (within 5 %), shapes and dtype;
    deterministic in the seed."""
    spec_j = js.MixtureSpec(n_components=16, d=8, spread=3.0, noise=0.5)
    spec_t = ts.MixtureSpec(n_components=16, d=8, spread=3.0, noise=0.5)
    xj = _draw(js.gaussian_mixture(0, spec_j, 512), 8)
    xt = _draw(ts.gaussian_mixture(0, spec_t, 512, device="cpu"), 8)
    assert xt.shape == xj.shape == (4096, 8) and xt.dtype == np.float32
    want = np.sqrt(3.0 ** 2 + 0.5 ** 2)
    for x in (xj, xt):
        assert abs(x.std() / want - 1) < 0.15
    g = ts.gaussian_mixture(0, spec_t, 512, device="cpu")
    means = 3.0 * torch.randn(16, 8, generator=torch.Generator().manual_seed(
        0)).numpy()
    d2 = ((xt[:, None, :] - means[None]) ** 2).sum(-1)
    resid = xt - means[d2.argmin(1)]
    assert abs(resid.std() / 0.5 - 1) < 0.05
    np.testing.assert_array_equal(next(g).numpy(), xt[:512])


def test_drifting_mixture_introduces_classes_and_drifts():
    """One component at first, a new one every ``introduce_every`` chunks
    (the number of distinct clusters seen, as in the reference), and
    means that random-walk: the mean displacement after t chunks grows
    like drift * sqrt(t) (within 30 %, from 16 x 8 coordinates)."""
    spec = ts.MixtureSpec(n_components=4, d=8, spread=20.0, noise=0.05)
    chunks = [c.numpy() for c in itertools.islice(ts.drifting_mixture(
        1, spec, 64, drift_per_chunk=0.0, introduce_every=2,
        device="cpu"), 8)]
    for i, c in enumerate(chunks):
        # clusters 40 apart, noise 0.05: distinct rounded centers
        n_clusters = len(np.unique(np.round(c[:, 0] / 5.0)))
        assert n_clusters <= min(1 + i // 2, 4)
    assert len(np.unique(np.round(chunks[-1][:, 0] / 5.0))) >= 3
    spec = ts.MixtureSpec(n_components=16, d=8, spread=1.0, noise=0.0)
    xs = [c.numpy() for c in itertools.islice(ts.drifting_mixture(
        2, spec, 4096, drift_per_chunk=0.05, device="cpu"), 17)]
    jx = [np.asarray(c) for c in itertools.islice(js.drifting_mixture(
        2, js.MixtureSpec(n_components=16, d=8, spread=1.0, noise=0.0),
        4096, drift_per_chunk=0.05), 17)]
    for x in (xs, jx):
        first, last = np.unique(x[0], axis=0), np.unique(x[16], axis=0)
        assert len(first) == len(last) == 16
        # each mean moved by N(0, 0.05^2 * 16) per coordinate, far less
        # than the means lie apart: match each to its nearest old mean
        near = ((last[:, None] - first[None]) ** 2).sum(-1).argmin(1)
        assert len(set(near.tolist())) == 16
        d = last - first[near]
        assert abs(np.sqrt((d ** 2).mean()) / 0.2 - 1) < 0.3
