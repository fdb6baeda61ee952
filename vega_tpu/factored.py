"""Factored linear model representation for batched evaluation.

The standard BAO sampling case (bias/beta-like parameters sampled, every
grid-shaping parameter fixed) makes the whole correlation-function model
LINEAR in a small vector of per-evaluation scalar coefficients:

    xi(theta) = sum_t  c_t(theta) * v_t

where the v_t are parameter-independent basis vectors and the c_t are
cheap scalar functions of the sampled parameters (Kaiser products, metal
bias products, broadband coefficients, additive-term amplitudes...).

`FactoredXi` carries (coeffs, V) through the xi-space pipeline so every
linear operator downstream of the Hankel transform — bias z-evolution,
growth, metal matrices, additive templates, broadband design columns,
the distortion matrix, masking, and ultimately the chi^2 quadratic form —
is pushed onto the basis stack V. Under `jax.vmap` the basis work is
unbatched and therefore hoisted out of the batch: each likelihood
evaluation reduces to the coefficient scalars plus one (T,) x (T, T)
quadratic form, instead of (mu_k x k) grid arithmetic, a distortion
matmul and an (n x n) covariance quadratic form per evaluation.

This is the compiled-graph replacement for the reference's value-cache layer
(reference: power_spectrum.py:311-324, metals.py:144-207): instead of
caching factor grids between Python calls, the linear structure is made
explicit so XLA executes the expensive part once per batch.

Everything here is exact linear-algebra reassociation: chi^2 values agree
with the dense pipeline to float-reassociation level (~1e-15 relative in
f64; pinned by tests/test_factored.py).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import jax
import jax.numpy as jnp


def has_tracer(*vals):
    """True if any value is a jax tracer (i.e. depends on a sampled
    parameter in the current trace; fixed config parameters stay Python
    floats all the way through `_get_lcl_prms`)."""
    return any(isinstance(v, jax.core.Tracer) for v in vals)


# --------------------------------------------------------------------------
# Grid-trace context (see vega_tpu/gridcollapse.py)
#
# During a grid-collapse sweep the designated "grid parameters" (ap/at and
# friends) are traced node values whose tracers are ALLOWED inside basis
# rows: the factored classification treats them as row-safe, so FactoredXi
# survives with a (traced) V that is a pure function of the grid
# parameters. Coefficients must still not depend on them — that invariant
# is enforced structurally by the sweep (vmap out_axes=None on the
# coefficient vector).
# --------------------------------------------------------------------------
_GRID_CTX = threading.local()


def grid_param_names():
    """Names whose tracers are row-safe in the current trace."""
    return getattr(_GRID_CTX, 'names', frozenset())


@contextmanager
def grid_trace(names):
    prev = getattr(_GRID_CTX, 'names', frozenset())
    _GRID_CTX.names = frozenset(names)
    try:
        yield
    finally:
        _GRID_CTX.names = prev


def keyed_tracer(key, val):
    """has_tracer for a single named parameter value, ignoring tracers of
    grid parameters (their dependence lives in the basis rows)."""
    return has_tracer(val) and key not in grid_param_names()


class RecordingParams:
    """Read-only params view recording every accessed (key, value) pair,
    so a factor can be classified static (none of the parameters it
    actually read is traced) without hard-coding its parameter list.
    Accesses to grid parameters (see `grid_trace`) do not count as
    traced: their tracers are allowed inside basis rows."""

    def __init__(self, params):
        self._params = params
        self.accessed = []

    def __getitem__(self, key):
        val = self._params[key]
        self.accessed.append((key, val))
        return val

    def get(self, key, default=None):
        val = self._params.get(key, default)
        self.accessed.append((key, val))
        return val

    def __contains__(self, key):
        return key in self._params

    def traced(self):
        grid = grid_param_names()
        return any(has_tracer(v) for k, v in self.accessed if k not in grid)


class FactoredXi:
    """xi = coeffs @ V with scalar coefficients (possibly traced/batched)
    and a (T, n) basis stack V that must not depend on sampled
    parameters."""

    __slots__ = ('coeffs', 'V')

    def __init__(self, coeffs, V):
        self.coeffs = list(coeffs)
        self.V = V
        assert self.V.ndim == 2 and self.V.shape[0] == len(self.coeffs)

    @property
    def n_terms(self):
        return len(self.coeffs)

    def coeff_vector(self):
        return jnp.stack([jnp.asarray(c, dtype=self.V.dtype)
                          for c in self.coeffs])

    def dense(self):
        return self.coeff_vector() @ self.V

    # ----- linear operations (all return new FactoredXi) -----
    def scale(self, scalar):
        return FactoredXi([scalar * c for c in self.coeffs], self.V)

    def mul_vec(self, vec):
        """Elementwise multiply by a parameter-independent vector."""
        return FactoredXi(self.coeffs, self.V * jnp.asarray(vec)[None, :])

    def add_vec(self, vec, coeff=1.0):
        """Add coeff * vec as a new term (vec parameter-independent)."""
        return FactoredXi(self.coeffs + [coeff],
                          jnp.vstack([self.V, jnp.asarray(vec)[None, :]]))

    def add_terms(self, terms):
        """Add [(coeff, vec)] pairs as new terms."""
        if not terms:
            return self
        rows = jnp.stack([jnp.asarray(v) for _, v in terms])
        return FactoredXi(self.coeffs + [c for c, _ in terms],
                          jnp.vstack([self.V, rows]))

    def __add__(self, other):
        if isinstance(other, FactoredXi):
            return FactoredXi(self.coeffs + other.coeffs,
                              jnp.vstack([self.V, other.V]))
        return NotImplemented

    def matmul(self, mat):
        """Apply a matrix M: xi -> M @ xi (pushed onto every basis row)."""
        return FactoredXi(self.coeffs, self.V @ jnp.asarray(mat).T)

    def mask(self, idx):
        """Restrict to masked bins: xi -> xi[idx]."""
        return FactoredXi(self.coeffs, self.V[:, idx])


def densify(xi):
    """Dense vector view of a possibly-factored xi."""
    if isinstance(xi, FactoredXi):
        return xi.dense()
    return xi
