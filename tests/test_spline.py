import numpy as np
import pytest
import jax.numpy as jnp
from scipy.interpolate import interp1d, splrep, splev

from vega_tpu.ops.spline import (
    notaknot_second_derivative_matrix, spline_eval)


def test_matches_scipy_interp1d_cubic():
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 10, 60))
    y = np.sin(x) + 0.1 * rng.normal(size=60)
    s_mat = notaknot_second_derivative_matrix(x)
    xq = rng.uniform(x[0], x[-1], 700)
    mine, oob = spline_eval(jnp.array(x), jnp.array(y),
                            jnp.array(s_mat @ y), jnp.array(xq))
    ref = interp1d(x, y, kind='cubic')(xq)
    np.testing.assert_allclose(np.array(mine), ref, rtol=0, atol=1e-12)
    assert not np.any(np.array(oob))


def test_matches_scipy_splrep():
    rng = np.random.default_rng(1)
    x = np.linspace(-3, 7, 200)
    y = np.exp(-0.3 * x) * np.cos(2 * x)
    s_mat = notaknot_second_derivative_matrix(x)
    xq = rng.uniform(-3, 7, 500)
    mine, _ = spline_eval(jnp.array(x), jnp.array(y),
                          jnp.array(s_mat @ y), jnp.array(xq))
    ref = splev(xq, splrep(x, y, k=3, s=0))
    np.testing.assert_allclose(np.array(mine), ref, rtol=0, atol=1e-12)


def test_out_of_bounds_flag():
    x = np.linspace(0, 1, 10)
    y = x ** 2
    s_mat = notaknot_second_derivative_matrix(x)
    vals, oob = spline_eval(jnp.array(x), jnp.array(y), jnp.array(s_mat @ y),
                            jnp.array([-0.1, 0.5, 1.1]))
    np.testing.assert_array_equal(np.array(oob), [True, False, True])
    assert np.isfinite(np.array(vals)).all()


def test_batched_eval():
    x = np.linspace(0, 1, 30)
    ys = np.stack([x ** 2, np.sin(3 * x), np.exp(x)])
    s_mat = notaknot_second_derivative_matrix(x)
    ms = ys @ s_mat.T
    xq = np.linspace(0.05, 0.95, 40)
    vals, _ = spline_eval(jnp.array(x), jnp.array(ys)[:, None, :],
                          jnp.array(ms)[:, None, :], jnp.array(xq)[None, :])
    assert vals.shape == (3, 1, 40)
    for i, y in enumerate(ys):
        ref = interp1d(x, y, kind='cubic')(xq)
        np.testing.assert_allclose(np.array(vals[i, 0]), ref, atol=1e-12)


@pytest.mark.parametrize('dtype, atol', [(np.float64, 1e-12),
                                         (np.float32, 2e-5)])
def test_spline_legendre_stage_matches_scipy(dtype, atol):
    """The P->xi stage as PktoXi.compute runs it (four multipole splines
    on the log-r knots, summed against P_ell(mu)) at the production
    sizes: 814 uniform log-r knots, 5,000 query bins."""
    from scipy.interpolate import CubicSpline
    from scipy.special import eval_legendre

    from vega_tpu.pktoxi import legendre

    rng = np.random.default_rng(0)
    knots = np.linspace(np.log(0.05), np.log(2.0e4), 814)
    ells = (0, 2, 4, 6)
    y = np.cumsum(rng.normal(size=(len(ells), 814)), axis=1) * 0.05
    m = y @ notaknot_second_derivative_matrix(knots).T
    log_r = np.log(rng.uniform(1.0, 300.0, 5000))
    mu = rng.uniform(-1.0, 1.0, 5000)

    vals, oob = spline_eval(knots.astype(dtype),
                            jnp.asarray(y[:, None, :], dtype),
                            jnp.asarray(m[:, None, :], dtype),
                            jnp.asarray(log_r[None, :], dtype))
    mu_j = jnp.asarray(mu, dtype)
    stage = jnp.sum(vals[:, 0, :] * jnp.stack([legendre(ell, mu_j)
                                               for ell in ells]), axis=0)

    ref = sum(CubicSpline(knots, y[i], bc_type='not-a-knot')(log_r)
              * eval_legendre(ell, mu) for i, ell in enumerate(ells))
    assert stage.dtype == dtype
    assert not np.any(np.asarray(oob))
    np.testing.assert_allclose(np.asarray(stage, np.float64), ref,
                               rtol=0, atol=atol)
