"""The classical baselines (``models/csp.py``, ``models/riemann.py``)
against the JAX package's.

Trials drawn with numpy from a seed, each class adding its own rhythm
through its own spatial pattern.  An eigenvector's sign, and the order of
equal eigenvalues, are the solver's choice, so the comparisons are of what
does not depend on them: CSP's log-variance features (atol 5e-5, through
two ``eigh`` in f32) and the filters' spans, LDA's scores (1e-4), the
covariances (1e-6), the Karcher mean (1e-5), the tangent features (2e-5)
and both pipelines' predictions (equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_cases  # noqa: F401 (caps torch's threads)

from eegnetreplication_tpu.models import csp as jax_csp
from eegnetreplication_tpu.models import riemann as jax_riemann
from eegnetreplication_tpu_torch.models import csp, riemann

N, C, T = 96, 8, 128


def _data(seed=0, c=C):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 4, N)
    x = rng.randn(N, c, T).astype(np.float32)
    patterns = rng.randn(4, c)
    for k in range(4):
        wave = np.sin(np.arange(T) * (0.2 + 0.1 * k))
        x[y == k] += (0.8 * patterns[k][:, None] * wave).astype(np.float32)
    return x, y


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


@pytest.fixture(scope="module")
def data():
    return _data()


def test_class_covariances(data):
    x, y = data
    want = jax_csp._class_covariances(jnp.asarray(x), jnp.asarray(y))
    got = csp._class_covariances(_t(x), _t(y))
    for w, g in zip(want, got):
        _close(g, w, 1e-6)


def test_csp_features_and_filter_spans(data):
    x, y = data
    jf = np.asarray(jax_csp.csp_fit(jnp.asarray(x), jnp.asarray(y)))
    tf = csp.csp_fit(_t(x), _t(y)).numpy()
    assert tf.shape == jf.shape == (8, C)
    # each filter equals the JAX one up to its sign
    for a, b in zip(tf, jf):
        assert min(np.abs(a - b).max(), np.abs(a + b).max()) < 5e-4
    want = jax_csp.csp_transform(jnp.asarray(x), jnp.asarray(jf))
    _close(csp.csp_transform(_t(x), _t(tf)), want, 5e-5)
    # features are blind to the filters' signs
    _close(csp.csp_transform(_t(x), _t(-tf)),
           csp.csp_transform(_t(x), _t(tf)), 1e-6)


def test_lda_scores(data):
    x, y = data
    feats = np.asarray(jax_csp.csp_transform(
        jnp.asarray(x), jax_csp.csp_fit(jnp.asarray(x), jnp.asarray(y))))
    for shrinkage in (0.0, 0.1, 0.5):
        jm = jax_csp.lda_fit(jnp.asarray(feats), jnp.asarray(y), shrinkage)
        tm = csp.lda_fit(_t(feats), _t(y), shrinkage)
        _close(tm.means, jm.means, 1e-5)
        _close(csp.lda_scores(tm, _t(feats)),
               jax_csp.lda_scores(jm, jnp.asarray(feats)), 1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_csp_lda_predictions_are_equal(seed):
    x, y = _data(seed)
    want = np.asarray(jax_csp.csp_lda_fit_predict(
        jnp.asarray(x[:64]), jnp.asarray(y[:64]), jnp.asarray(x[64:])))
    got = csp.csp_lda_fit_predict(_t(x[:64]), _t(y[:64]), _t(x[64:]))
    np.testing.assert_array_equal(got.numpy(), want)
    assert csp.csp_lda_accuracy(x[:64], y[:64], x[64:], y[64:]) \
        == pytest.approx(jax_csp.csp_lda_accuracy(x[:64], y[:64], x[64:],
                                                  y[64:]))


def test_trial_covariances_and_karcher_mean(data):
    x, _ = data
    jc = np.asarray(jax_riemann.trial_covariances(jnp.asarray(x)))
    tc = riemann.trial_covariances(_t(x))
    _close(tc, jc, 1e-6)
    for n_iter in (1, 10):
        want = jax_riemann.riemannian_mean(jnp.asarray(jc), n_iter)
        _close(riemann.riemannian_mean(_t(jc), n_iter), want, 1e-5)


def test_spd_functions(data):
    x, _ = data
    covs = np.asarray(jax_riemann.trial_covariances(jnp.asarray(x[:6])))
    for fn_j, fn_t in ((jnp.sqrt, torch.sqrt), (jnp.log, torch.log)):
        _close(riemann._spd_fn(_t(covs), fn_t),
               jax_riemann._spd_fn(jnp.asarray(covs), fn_j), 1e-5)
    sym = covs - covs.mean(0)            # symmetric, indefinite
    _close(riemann._spd_fn(_t(sym), torch.exp, floor=None),
           jax_riemann._spd_fn(jnp.asarray(sym), jnp.exp, floor=None), 1e-5)


def test_tangent_features(data):
    x, _ = data
    covs = np.asarray(jax_riemann.trial_covariances(jnp.asarray(x)))
    mean = np.asarray(jax_riemann.riemannian_mean(jnp.asarray(covs)))
    want = jax_riemann.tangent_features(jnp.asarray(covs), jnp.asarray(mean))
    got = riemann.tangent_features(_t(covs), _t(mean))
    assert got.shape == (N, C * (C + 1) // 2)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("seed", [0, 2])
def test_tangent_lda_predictions_are_equal(seed):
    x, y = _data(seed)
    want = np.asarray(jax_riemann.tangent_lda_fit_predict(
        jnp.asarray(x[:64]), jnp.asarray(y[:64]), jnp.asarray(x[64:])))
    got = riemann.tangent_lda_fit_predict(_t(x[:64]), _t(y[:64]),
                                          _t(x[64:]))
    np.testing.assert_array_equal(got.numpy(), want)
    assert riemann.tangent_lda_accuracy(x[:64], y[:64], x[64:], y[64:]) \
        == pytest.approx(jax_riemann.tangent_lda_accuracy(
            x[:64], y[:64], x[64:], y[64:]))
    assert float(np.mean(want == y[64:])) > 0.5
