"""Not-a-knot cubic spline as precomputed dense operators + jit evaluation.

The reference interpolates FFTLog outputs onto the (AP-rescaled) model r
grid with scipy.interpolate.interp1d(kind='cubic') per likelihood call
(reference: pktoxi.py:144,191) and with splrep/splev in the legacy path
(pktoxi.py:276-277). Both are the unique not-a-knot cubic interpolant, so
we reproduce them exactly with:

  1. a host-precomputed dense matrix S (n x n) mapping sampled values y to
     spline second derivatives M = S @ y (the knots are static), and
  2. a jitted gather + cubic Hermite evaluation at the (traced) query
     points.

Per-eval cost: one (n x n) matmul + gathers + FMA, batched over
multipoles and tracer pairs. The scipy per-call spline build disappears.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def notaknot_second_derivative_matrix(x_knots: np.ndarray) -> np.ndarray:
    """Dense (n, n) matrix S with M = S @ y giving the spline second
    derivatives of the not-a-knot cubic interpolant through (x, y)."""
    x = np.asarray(x_knots, dtype=np.float64)
    n = len(x)
    if n < 4:
        raise ValueError('Need at least 4 knots for a not-a-knot cubic spline')
    h = np.diff(x)

    a_mat = np.zeros((n, n))
    b_mat = np.zeros((n, n))

    # Interior C1 continuity conditions
    for i in range(1, n - 1):
        a_mat[i, i - 1] = h[i - 1] / 6.0
        a_mat[i, i] = (h[i - 1] + h[i]) / 3.0
        a_mat[i, i + 1] = h[i] / 6.0
        b_mat[i, i - 1] = 1.0 / h[i - 1]
        b_mat[i, i] = -1.0 / h[i - 1] - 1.0 / h[i]
        b_mat[i, i + 1] = 1.0 / h[i]

    # Not-a-knot: third derivative continuous at x[1] and x[n-2]
    a_mat[0, 0] = h[1]
    a_mat[0, 1] = -(h[0] + h[1])
    a_mat[0, 2] = h[0]
    a_mat[n - 1, n - 3] = h[n - 2]
    a_mat[n - 1, n - 2] = -(h[n - 3] + h[n - 2])
    a_mat[n - 1, n - 1] = h[n - 3]

    return np.linalg.solve(a_mat, b_mat)


def spline_eval(x_knots, y, second_derivs, x_query):
    """Evaluate the cubic spline at x_query (jit-safe; supports leading
    batch dims on y/second_derivs broadcast against x_query).

    Parameters
    ----------
    x_knots : (n,) static knot positions (ascending)
    y : (..., n) sampled values
    second_derivs : (..., n) spline second derivatives (S @ y)
    x_query : (..., m) query points

    Returns
    -------
    values : (..., m)
    oob : (..., m) bool, True where x_query is outside the knot range
        (values there are computed with clamped coordinates; callers turn
        the flag into the chi^2 = 1e100 penalty, preserving the reference's
        VegaBoundsError semantics, vega_interface.py:270-279)
    """
    x_knots_np = np.asarray(x_knots)
    n = x_knots_np.shape[0]
    spacing = np.diff(x_knots_np)
    uniform = np.allclose(spacing, spacing[0], rtol=1e-12, atol=1e-14)

    x_knots = jnp.asarray(x_knots)
    oob = (x_query < x_knots[0]) | (x_query > x_knots[-1])
    xq = jnp.clip(x_query, x_knots[0], x_knots[-1])

    if uniform:
        # log-spaced r -> uniform knots: direct arithmetic indexing
        # instead of a binary search per query
        step = (x_knots_np[-1] - x_knots_np[0]) / (n - 1)
        j = jnp.clip(((xq - x_knots[0]) / step).astype(jnp.int32), 0, n - 2)
        # guard against float roundoff landing one interval high/low
        j = jnp.where(xq < x_knots[j], j - 1, j)
        j = jnp.where(xq >= x_knots[jnp.minimum(j + 1, n - 1)], j + 1, j)
        j = jnp.clip(j, 0, n - 2)
    else:
        j = jnp.clip(jnp.searchsorted(x_knots, xq, side='right') - 1,
                     0, n - 2)
    x_lo = x_knots[j]
    x_hi = x_knots[j + 1]
    h = x_hi - x_lo

    batch = jnp.broadcast_shapes(y.shape[:-1], j.shape[:-1])
    y_b = jnp.broadcast_to(y, batch + y.shape[-1:])
    m_b = jnp.broadcast_to(second_derivs, batch + second_derivs.shape[-1:])
    j_b = jnp.broadcast_to(j, batch + j.shape[-1:])
    y_lo = jnp.take_along_axis(y_b, j_b, axis=-1)
    y_hi = jnp.take_along_axis(y_b, j_b + 1, axis=-1)
    m_lo = jnp.take_along_axis(m_b, j_b, axis=-1)
    m_hi = jnp.take_along_axis(m_b, j_b + 1, axis=-1)

    t_hi = (x_hi - xq) / h
    t_lo = (xq - x_lo) / h
    h2 = h * h / 6.0
    vals = (
        y_lo * t_hi + y_hi * t_lo
        + m_lo * h2 * (t_hi * t_hi * t_hi - t_hi)
        + m_hi * h2 * (t_lo * t_lo * t_lo - t_lo)
    )
    return vals, oob
