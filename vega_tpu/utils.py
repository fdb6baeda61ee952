"""Shared utilities: file resolution, bias/beta algebra, covariance helpers.

JAX re-imagination of the reference's vega/utils.py. The numba-jitted
scalar kernels there (sinc, hubble, growth) become plain jax/numpy ops here;
the LRU caches are dropped entirely because everything downstream is traced
into a single jitted likelihood (caching is the compiler's job).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

import vega_tpu

BLIND_FIXED_PARS = [
    'ap_full', 'at_full', 'aiso_full', 'epsilon_full', 'phi_full',
]

VEGA_BLINDED_PARS = {
    'phi_smooth': ['all'],
    'growth_rate': ['all'],
}


class VegaModelError(Exception):
    """Base class for model-domain failures (reference: utils.py:444-453).

    Under jit these become branchless penalty flags rather than Python
    exceptions; this class survives for host-side (init-time) failures.
    """


class VegaBoundsError(VegaModelError):
    pass


class VegaArinyoError(VegaModelError):
    pass


def sinc(x):
    """Unnormalized sinc sin(x)/x with sinc(0)=1 (reference: utils.py:28-42).

    The reference divides blindly (returns nan at 0); the k grids used never
    contain 0 so behaviour is identical where it matters, but we keep a safe
    form so jit gradients are clean.
    """
    import jax.numpy as jnp
    x = jnp.asarray(x)
    safe = jnp.where(x == 0, 1.0, x)
    return jnp.where(x == 0, 1.0, jnp.sin(safe) / safe)


_LN2_HI = 6.93147180369123816490e-01  # Cody-Waite split of ln 2
_LN2_LO = 1.90821492927058770002e-10
_INV_LN2 = 1.4426950408889634074
# Taylor 1/k! for k = 10 .. 0 (Horner order)
_EXP_COEFFS = (1.0 / 3628800.0, 1.0 / 362880.0, 1.0 / 40320.0,
               1.0 / 5040.0, 1.0 / 720.0, 1.0 / 120.0, 1.0 / 24.0,
               1.0 / 6.0, 0.5, 1.0, 1.0)


def fast_exp64(x):
    """Reduced-precision f64 exp for the hot loops (~2e-13 relative).

    jnp.exp is accurate to ~1e-16; the chi^2 parity budget is 1e-8
    relative, so a Cody-Waite reduction plus a degree-10 Taylor
    polynomial (max rel err ~2e-13 for |r| <= ln2/2) is
    indistinguishable in results with fewer f64 operations where the
    (muk x k)-grid exponentials are a large share of the work.

    Range: exact-shaped for x in (-87.3, 709); inputs below 2^-126
    flush to exactly 0 (the physics factors this describes are
    dampings — a value of 1e-38 is already physically zero). +inf
    produces nan rather than inf (the model's bad-parameter flags test
    isfinite, so both propagate identically). nan propagates.
    """
    import jax.numpy as jnp
    x = jnp.asarray(x)
    n = jnp.round(x * _INV_LN2)
    r = (x - n * _LN2_HI) - n * _LN2_LO
    p = _EXP_COEFFS[0]
    for c in _EXP_COEFFS[1:]:
        p = p * r + c
    # Exact 2^n from f32 exponent bits (jnp.exp2 is itself an
    # approximation — exp(n ln2) — with ~4e-6 error at |n| ~ 100; the
    # f64 ldexp equivalent would need emulated int64 ops)
    from jax import lax
    nc = jnp.clip(n, -126.0, 127.0).astype(jnp.int32)
    scale = lax.bitcast_convert_type(
        (nc + 127) << 23, jnp.float32).astype(x.dtype)
    return jnp.where(n < -126.0, 0.0, p * scale)


def use_fast_exp():
    """Trace-time switch for :func:`grid_exp` (VEGA_TPU_FAST_EXP=1).

    Off by default: its effect on throughput has not been measured on
    the GPU. Kept as validated infrastructure (chi^2 parity at 1e-9,
    tests/test_fast_exp.py) for configurations where the exp share of
    the dense pipeline is large.
    """
    import os
    return os.environ.get('VEGA_TPU_FAST_EXP', '').strip() == '1'


def grid_exp(x):
    """exp() for the hot (muk x k)-grid factors: fast_exp64 when
    VEGA_TPU_FAST_EXP=1, jnp.exp otherwise. Fully differentiable either way (fast_exp64 is
    plain arithmetic, so jax.grad/hessian trace through it)."""
    import jax.numpy as jnp
    if use_fast_exp():
        return fast_exp64(x)
    return jnp.exp(x)


def np_sinc(x):
    """Numpy twin of :func:`sinc` for host-side init work."""
    x = np.asarray(x, dtype=float)
    out = np.ones_like(x)
    nz = x != 0
    out[nz] = np.sin(x[nz]) / x[nz]
    return out


def _tracer_bias_beta(params, name):
    """Resolve (bias, beta) for one tracer from any two of
    (bias, bias_eta, beta) — reference: utils.py:45-82.

    This is trace-time logic: which keys exist is static per config, the
    arithmetic is traced.
    """
    growth_rate = params.get('growth_rate', 0.970386)

    bias = params.get('bias_' + name, None)
    bias_eta = params.get('bias_eta_' + name, None)
    beta = params.get('beta_' + name, None)

    err_msg = ('For each tracer, specify two of (bias, bias_eta, beta). '
               f'Offending tracer: {name}')

    if bias is None:
        assert bias_eta is not None and beta is not None, err_msg
        bias = bias_eta * growth_rate / beta

    if bias_eta is None:
        assert bias is not None and beta is not None, err_msg

    if beta is None:
        assert bias is not None and bias_eta is not None, err_msg
        beta = bias_eta * growth_rate / bias

    return bias, beta


def bias_beta(params, tracer1_name, tracer2_name):
    """(bias1, beta1, bias2, beta2) for a tracer pair (reference: utils.py:85-108)."""
    bias1, beta1 = _tracer_bias_beta(params, tracer1_name)
    if tracer1_name == tracer2_name:
        bias2, beta2 = bias1, beta1
    else:
        bias2, beta2 = _tracer_bias_beta(params, tracer2_name)
    return bias1, beta1, bias2, beta2


def find_file(path):
    """Resolve a path: absolute, vega_tpu/models, tests, repo root, or the
    read-only reference checkout (for parity fixtures).

    Mirrors reference utils.py:230-268 search order, extended with the
    reference tree so parity tests can load the upstream data files without
    copying them.
    """
    input_path = Path(os.path.expandvars(str(path)))

    if input_path.is_file():
        return input_path

    pkg_path = Path(os.path.dirname(vega_tpu.__file__))
    candidates = [
        pkg_path / 'models' / input_path,
        pkg_path.parents[0] / 'tests' / input_path,
        pkg_path.parents[0] / input_path,
    ]
    # Reference checkout (read-only), used for parity fixtures only.
    # VEGA_TPU_NO_REFERENCE=1 forbids the fallback (self-containment
    # tests); the shipped assets in vega_tpu/models/ already cover all
    # standard data (see scripts/vendor_model_data.py).
    ref = Path('/root/reference')
    if ref.is_dir() and os.environ.get('VEGA_TPU_NO_REFERENCE') != '1':
        candidates += [
            ref / 'vega' / 'models' / input_path,
            ref / 'tests' / input_path,
            ref / input_path,
        ]
    for cand in candidates:
        if cand.is_file():
            return cand

    raise RuntimeError(f'The path/file does not exist: {input_path}')


# Content-keyed caches for the O(n^3) covariance factorizations. These
# dominate multi-interface cold starts (measured: 44 s of a 55 s first
# chi^2 on a 1-core host was Cholesky/inv of the SAME four covariances
# an earlier interface had already factorized) — any process that
# builds several VegaInterface instances over the same data (test
# suites, scan/MC drivers, config sweeps) repeats identical LAPACK
# work. Hashing the 10-100 MB inputs costs ~10 ms/GB with blake2b;
# the factorizations cost tens of seconds. The inverse cache is
# byte-bounded (FIFO eviction, VEGA_TPU_INVCOV_CACHE_MB, default
# 4096) so a driver sweeping many distinct covariances/masks cannot
# grow RSS without bound.
_INVCOV_CACHE = {}
_LOGDET_CACHE = {}


def _invcov_cache_insert(key, out):
    budget = float(os.environ.get('VEGA_TPU_INVCOV_CACHE_MB', '4096'))
    budget_bytes = int(budget * 2**20)
    if out.nbytes > budget_bytes:
        return                       # too big to cache at all
    held = sum(v.nbytes for v in _INVCOV_CACHE.values())
    while _INVCOV_CACHE and held + out.nbytes > budget_bytes:
        _, evicted = _INVCOV_CACHE.popitem()   # LIFO is fine: any eviction
        held -= evicted.nbytes                 # keeps the bound; dict has
    _INVCOV_CACHE[key] = out                   # no popfirst pre-3.12


def _cov_key(cov_mat, data_mask):
    import hashlib
    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(cov_mat).view(np.uint8))
    h.update(np.ascontiguousarray(data_mask).view(np.uint8))
    h.update(repr((cov_mat.shape, str(cov_mat.dtype))).encode())
    return h.digest()


def compute_masked_invcov(cov_mat, data_mask, check_posdef=True):
    """Masked inverse covariance (reference: utils.py:271-298).

    Host-side init work; stays numpy/LAPACK. Content-cached per process
    (callers must not mutate the returned array in place).
    """
    key = (_cov_key(cov_mat, data_mask), bool(check_posdef))
    cached = _INVCOV_CACHE.get(key)
    if cached is not None:
        return cached

    masked_cov = cov_mat[np.ix_(data_mask, data_mask)]

    if check_posdef:
        try:
            np.linalg.cholesky(cov_mat)
        except np.linalg.LinAlgError:
            print('WARNING: Full matrix is not positive definite')
        try:
            np.linalg.cholesky(masked_cov)
        except np.linalg.LinAlgError:
            print('WARNING: Reduced matrix is not positive definite')

    out = np.linalg.inv(masked_cov)
    out.setflags(write=False)      # shared across interfaces: freeze
    _invcov_cache_insert(key, out)
    return out


def compute_log_cov_det(cov_mat, data_mask):
    """log|C| of the masked covariance (reference: utils.py:301-318).
    Content-cached per process like compute_masked_invcov."""
    key = _cov_key(cov_mat, data_mask)
    cached = _LOGDET_CACHE.get(key)
    if cached is not None:
        return cached
    masked_cov = cov_mat[np.ix_(data_mask, data_mask)]
    out = float(np.linalg.slogdet(masked_cov)[1])
    _LOGDET_CACHE[key] = out
    return out


def get_blinding(blind_pars, blinding_strat):
    """Parameter-level blinding offsets (reference: utils.py:321-372).

    The blinding files live on NERSC; outside that environment this always
    returns None for the supported strategies, exactly like the reference.
    """
    assert blinding_strat is not None, 'Blinding failed, do not run!!!'
    print(f'Blinding parameters: {blind_pars}')

    if ('ap' in blind_pars) or ('at' in blind_pars) or ('alpha' in blind_pars):
        blinding_type = 'bao'
    elif ('growth_rate' in blind_pars) or ('phi_smooth' in blind_pars):
        blinding_type = 'full-shape'
    else:
        raise ValueError(f'No blinding implemented for parameters {blind_pars}')

    blinding_choices = {
        'desi_y1': {'full-shape': None, 'bao': None},
        'desi_y3': {'full-shape': None, 'bao': None},
    }

    if blinding_strat not in blinding_choices:
        raise ValueError(f'Unknown blinding version: {blinding_strat}.')

    blinding_file = blinding_choices[blinding_strat][blinding_type]
    if blinding_file is None:
        return None

    blinding = {}
    with np.load(blinding_file) as file:
        for par in blind_pars:
            if par not in VEGA_BLINDED_PARS:
                raise ValueError(f'Blinding for parameter {par} not implemented.')
            blinding[par] = float(file[par])
    return blinding


def apply_blinding(params, blinding):
    """Apply blinding offsets in-place (reference: utils.py:375-393)."""
    for par, val in blinding.items():
        params[par] += (np.pi - np.exp(val ** 2))
    return params


def convert_instance_to_dictionary(inst):
    """Public attributes of an object as a dict (reference: utils.py:111-125)."""
    return {name: getattr(inst, name) for name in dir(inst)
            if not name.startswith('__')}


def compute_gauss_smoothing(sigma_par, sigma_trans, k_par_grid, k_trans_grid):
    """Anisotropic Gaussian smoothing factor (reference: utils.py:396-421)."""
    return np.exp(-(k_par_grid ** 2 * sigma_par ** 2
                    + k_trans_grid ** 2 * sigma_trans ** 2) / 2)


def compute_kn_smoothing(scale_par, k_grid, n):
    """k^n smoothing factor (reference: utils.py:423-441)."""
    return np.exp(-scale_par ** 2 * k_grid ** n / 2)


# Drop-in surface: the reference exposes the growth machinery from
# vega.utils (reference: utils.py:128-227); here it lives in cosmo.py
# (init-time host work). Re-exported so `from vega_tpu.utils import
# growth_function` works for reference users.
from .cosmo import (hubble, growth_integrand,  # noqa: E402,F401
                    get_growth_interp, growth_function)
