"""Anisotropic power-spectrum model P(k, mu_k) — the elementwise hot path.

JAX counterpart of the reference's vega/power_spectrum.py. Three
architectural differences:

1. Everything in `compute` is jax-traceable: parameters arrive as (possibly
   traced) scalars in a dict, all config branching happens at trace time,
   and the whole multiplicative pipeline fuses into a single XLA kernel on
   the (num_bins_muk x num_k) grid.
2. The reference's value-dependent caches (HCD factor, peak-NL, Arinyo,
   Gaussian smoothing LRUs; reference power_spectrum.py:311-324,407-417,
   459-479) are deleted: under jit recompute is free and caching would
   break functional purity.
3. Failure modes (Arinyo NaN/Inf -> VegaArinyoError, reference
   power_spectrum.py:468-469) become a penalty flag returned alongside the
   result, which the likelihood turns into chi^2 = 1e100 branchlessly.
"""

from __future__ import annotations

import os

import numpy as np
import jax.numpy as jnp

from . import utils
from .factored import RecordingParams as _RecordingParams
from .factored import has_tracer as _has_tracer
from .statics import register as register_static, resolve


class FactoredPk:
    """P(k, mu_k) = sum_t coeffs[t] * bases[t].

    coeffs are (possibly traced, possibly vmapped) scalars; bases are
    (mu_k, k) grids that do NOT depend on sampled parameters, so under
    vmap every grid-sized operation on them stays unbatched and the
    per-evaluation work is one tiny contraction. Downstream linear
    operators (Legendre projection, FFTLog, spline solve) are pushed
    through the bases (see PktoXi.compute), which is exact up to float
    reassociation (~1e-16 relative).
    """

    __slots__ = ('coeffs', 'bases')

    def __init__(self, coeffs, bases):
        assert len(coeffs) == len(bases)
        self.coeffs = list(coeffs)
        self.bases = list(bases)

    def dense(self):
        out = self.coeffs[0] * self.bases[0]
        for c, b in zip(self.coeffs[1:], self.bases[1:]):
            out = out + c * b
        return out


# (mu_k x k) grid bundles are identical for every tracer pair of one
# dataset (same k grid, quadrature and bin sizes) — the DR16 flagship
# config builds 42 PowerSpectrum instances whose grids and sinc binning
# windows would otherwise be recomputed 42 times (~25% of interface
# init). Keyed on grid content, shared process-wide.
_GRID_BUNDLE_CACHE = {}


def _grid_bundle(k_grid, num_bins_muk, quadrature, bin_size_rp,
                 bin_size_rt, use_Gk):
    key = (hash(k_grid.tobytes()), k_grid.size, num_bins_muk, quadrature,
           bin_size_rp, bin_size_rt, use_Gk)
    bundle = _GRID_BUNDLE_CACHE.get(key)
    if bundle is not None:
        return bundle
    if quadrature == 'midpoint':
        muk_grid = (np.arange(num_bins_muk) + 0.5) / num_bins_muk
        muk_weights = np.full(num_bins_muk, 1.0 / num_bins_muk)
    elif quadrature == 'gauss-legendre':
        nodes, gl_weights = np.polynomial.legendre.leggauss(num_bins_muk)
        muk_grid = (nodes + 1.0) / 2.0
        muk_weights = gl_weights / 2.0
    else:
        raise ValueError(
            f'Unknown muk-quadrature "{quadrature}" '
            '(use midpoint or gauss-legendre)')
    muk_grid = muk_grid[:, None]
    k_par_grid = k_grid * muk_grid
    k_trans_grid = k_grid * np.sqrt(1 - muk_grid ** 2)
    # Static binning window G(k) (reference caches it lazily at
    # power_spectrum.py:139-141; here it is init-time). Computed with
    # numpy: eager jax ops at init would each dispatch (and compile) on
    # the device for a one-off host-side table.
    pk_Gk = None
    pk_gk_ref = None
    if use_Gk:
        gk = np.ones_like(k_par_grid)
        if bin_size_rp != 0:
            gk = gk * utils.np_sinc(k_par_grid * bin_size_rp / 2)
        if bin_size_rt != 0:
            gk = gk * utils.np_sinc(k_trans_grid * bin_size_rt / 2)
        pk_Gk = gk
        pk_gk_ref = register_static(pk_Gk, 'gk')
    bundle = (muk_grid, muk_weights, k_par_grid, k_trans_grid,
              register_static(k_par_grid, 'kpar'),
              register_static(k_trans_grid, 'ktrans'),
              pk_Gk, pk_gk_ref)
    _GRID_BUNDLE_CACHE[key] = bundle
    return bundle


class PowerSpectrum:
    """Power-spectrum model for one tracer pair.

    Parity notes: matches reference power_spectrum.py:18-196 factor by
    factor; golden-sum tests in tests/test_pk.py pin the agreement.
    """

    def __init__(self, config, fiducial, tracer1, tracer2, dataset_name=None):
        self._config = config
        self.tracer1_name = tracer1['name']
        self.tracer2_name = tracer2['name']
        self._corr_name = f'{self.tracer1_name}x{self.tracer2_name}'
        self.tracer1_type = tracer1['type']
        self.tracer2_type = tracer2['type']
        self._name = dataset_name

        self.k_grid = np.asarray(fiducial['k'], dtype=np.float64)
        self._bin_size_rp = config.getfloat('bin_size_rp')
        self._bin_size_rt = config.getfloat('bin_size_rt')
        self.use_Gk = config.getboolean('model binning', True)
        self.skip_nl_model_in_peak = config.getboolean(
            'skip-nl-model-in-peak', False)

        self.pk_damping_scale = config.getfloat('pk-damping-scale', None)
        self.pk_damping_power = config.getint('pk-damping-power', 2)

        self.hcd_model = config.get('model-hcd', None)
        self._add_uvb = config.getboolean('UVB-fluctuations', False)
        self._add_heii = config.getboolean('HeII-reionization', False)

        self.small_scale_nl = config.get('small scale nl', None)
        self.fullshape_smoothing = config.get('fullshape smoothing', None)
        self.velocity_dispersion = config.get('velocity dispersion', None)
        self.mock_bin_size = config.getfloat('mock-bin-size', None)
        self.mock_los_smoothing = config.get('mock-los-smoothing', None)

        # Fvoigt HCD profile table (reference: power_spectrum.py:59-68)
        self._Fvoigt_data = None
        if self.hcd_model is not None and 'fvoigt' in self.hcd_model:
            assert 'fvoigt_model' in config.keys(), \
                'No fvoigt_model specified in config'
            fvoigt_model = config.get('fvoigt_model')
            if '/' not in fvoigt_model:
                path = utils.find_file(f'fvoigt_models/Fvoigt_{fvoigt_model}.txt')
            else:
                path = fvoigt_model
            self._Fvoigt_data = np.loadtxt(path)

        # Fiducial Pk rescaled to z_eff for the Arinyo Delta^2
        # (reference: power_spectrum.py:72-73)
        self._pk_fid = np.asarray(fiducial['pk_full']) * (
            (1 + fiducial['z_fiducial']) / (1. + fiducial['z_eff'])) ** 2

        num_bins_muk = config.getint('num_bins_muk', 1000)
        # mu_k quadrature: 'midpoint' reproduces the reference's
        # 1000-bin rectangle rule exactly (power_spectrum.py:76);
        # 'gauss-legendre' replaces it with an N-node Gauss-Legendre
        # rule on (0, 1) — the mu integrands are smooth, so ~64 nodes
        # match the converged integral better than 1000 midpoint bins at
        # ~1/15 of the grid work (a validated performance mode, not a
        # parity mode; see docs/performance.md and tests/test_muk_quadrature.py)
        quadrature = config.get('muk-quadrature', 'midpoint')
        # Large (muk x k) grids go through the statics store (shared by
        # all tracer pairs on the same grids; see vega_tpu.statics), and
        # the whole bundle is memoized across instances (_grid_bundle)
        (self.muk_grid, self.muk_weights, self.k_par_grid,
         self.k_trans_grid, self._kpar_ref, self._ktrans_ref,
         self.pk_Gk, self._pk_gk_ref) = _grid_bundle(
            self.k_grid, num_bins_muk, quadrature,
            self._bin_size_rp, self._bin_size_rt, self.use_Gk)

    def _kp(self):
        return resolve(self._kpar_ref)

    def _kt(self):
        return resolve(self._ktrans_ref)

    # ------------------------------------------------------------------
    # Main pipeline
    # ------------------------------------------------------------------
    def compute(self, pk_lin, params, fast_metals=False):
        """Build P(k, mu_k); returns (pk, bad_flag).

        Mirrors reference power_spectrum.py:87-196 stage by stage.
        """
        peak = bool(params['peak'])
        factor, bad = self._shared_factor(params, fast_metals,
                                          skip_nl=(self.skip_nl_model_in_peak
                                                   and peak))
        pk_full = jnp.asarray(pk_lin) * factor
        if peak:
            pk_full = pk_full * self.compute_peak_nl(params)
        return pk_full, bad

    def compute_peak_smooth(self, params, pk_peak_lin, pk_smooth_lin):
        """Both components of one evaluation: returns
        (pk_peak, pk_smooth, bad).

        Same factors as two `compute` passes (reference
        power_spectrum.py:87-196 called per component behind value
        caches), restructured for batched evaluation throughput:

        - every factor whose parameters are not being sampled stays
          *unbatched* under vmap, so the per-evaluation work collapses to
          the Kaiser polynomial and one or two grid multiplies — the
          factors are accumulated most-likely-static first so a traced
          factor never poisons the static prefix;
        - the linear pk and the static accumulator multiply *before* the
          (typically batched) Kaiser term;
        - the Kaiser x HCD/UV algebra is division-free (see
          `compute_tracer_polys`).

        All reorderings are exact in real arithmetic; float reassociation
        differences are ~1e-16 relative, far below the 1e-9 parity
        budget.
        """
        bad = jnp.asarray(False)

        def mul(acc, fac):
            if fac is None:
                return acc
            return fac if acc is None else acc * fac

        # Factors shared by peak and smooth, most-likely-static first
        rec_common = _RecordingParams(params)
        common = None
        if self.pk_damping_scale is not None:
            common = mul(common, jnp.exp(
                -self.pk_damping_scale ** 2
                * self.k_grid ** self.pk_damping_power / 2))
        if self.use_Gk:
            if (f'par binsize {self._name}' in params
                    or f'per binsize {self._name}' in params):
                common = mul(common, self.compute_Gk(rec_common))
            else:
                common = mul(common, resolve(self._pk_gk_ref))
        if self.mock_bin_size is not None:
            common = mul(common, self._compute_mock_binsize_gk(rec_common))
        if self.velocity_dispersion is not None:
            if 'lorentz_gauss' in self.velocity_dispersion:
                common = mul(common,
                             self.compute_velocity_dispersion_lorentz(
                                 rec_common))
                common = mul(common,
                             self.compute_velocity_dispersion_gauss(
                                 rec_common))
            elif 'gauss' in self.velocity_dispersion:
                common = mul(common,
                             self.compute_velocity_dispersion_gauss(
                                 rec_common))
            elif 'lorentz' in self.velocity_dispersion:
                common = mul(common,
                             self.compute_velocity_dispersion_lorentz(
                                 rec_common))
            else:
                raise ValueError(
                    '"velocity dispersion" must be "gauss" or "lorentz"')

        # Non-linear factors, skipped in the peak when configured
        rec_nl = _RecordingParams(params)
        nl = None
        if self.small_scale_nl is not None:
            if 'arinyo' in self.small_scale_nl:
                dnl, dnl_bad = self.compute_dnl_arinyo(rec_nl)
                nl = mul(nl, dnl)
                bad = bad | dnl_bad
            elif 'mcdonald' in self.small_scale_nl:
                nl = mul(nl, self.compute_dnl_mcdonald())
            else:
                raise ValueError("Incorrect 'small scale nl' specified")
        if self.fullshape_smoothing is not None:
            if 'gauss' in self.fullshape_smoothing:
                nl = mul(nl, self.compute_fullshape_gauss_smoothing(rec_nl))
            elif 'exp' in self.fullshape_smoothing:
                nl = mul(nl, self.compute_fullshape_exp_smoothing(rec_nl))
            else:
                raise ValueError(
                    '"fullshape smoothing" must be "gauss" or "exp"')

        rec_peak = _RecordingParams(params)
        peak_nl = self.compute_peak_nl(rec_peak)

        smooth_static = mul(mul(jnp.asarray(pk_smooth_lin), common), nl)
        peak_static = jnp.asarray(pk_peak_lin)
        peak_static = mul(peak_static, common)
        if not self.skip_nl_model_in_peak:
            peak_static = mul(peak_static, nl)
        peak_static = mul(peak_static, peak_nl)

        # Factored fast path: when every grid-shaped factor is static and
        # the Kaiser term decomposes into scalar coefficients x static
        # basis grids, return FactoredPk so the projection/FFTLog work
        # hoists out of the batch (see class docstring). Active only
        # inside a trace (eager calls keep the plain grids).
        if (os.environ.get('VEGA_TPU_FACTORED', '1') == '1'
                and _has_tracer(*params.values())
                and not (rec_common.traced() or rec_nl.traced()
                         or rec_peak.traced())):
            terms = self._kaiser_product_terms(params)
            if terms is not None:
                pk_peak = FactoredPk(
                    [c for c, _ in terms],
                    [peak_static * g for _, g in terms])
                pk_smooth = FactoredPk(
                    [c for c, _ in terms],
                    [smooth_static * g for _, g in terms])
                return pk_peak, pk_smooth, bad

        kaiser = self.compute_kaiser_poly(params)
        pk_peak = peak_static * kaiser
        pk_smooth = smooth_static * kaiser
        return pk_peak, pk_smooth, bad

    # ------------------------------------------------------------------
    # Kaiser decomposition for the factored fast path
    # ------------------------------------------------------------------
    def _tracer_poly_terms(self, params, name, bias, beta):
        """Decompose one tracer's Kaiser polynomial
        T = b_eff + bb_eff * muk^2 into [(coeff, key, mupow)] where every
        key names a grid that does not depend on sampled parameters.
        Returns None when a grid-shaping parameter is sampled."""
        b_terms = [(bias, 'one')]
        bb_terms = [(bias * beta, 'one')]

        if (self._add_uvb or self._add_heii) and name == 'LYA':
            if self._add_uvb:
                lam = params['lambda_uv']
                b_prim = params['bias_prim']
                if _has_tracer(lam, b_prim):
                    return None
                b_terms.append((params['bias_gamma'], ('uv', lam, b_prim)))
            if self._add_heii:
                lam = params['lambda_HeII']
                b_prim = params['bias_prim']
                if _has_tracer(lam, b_prim):
                    return None
                b_terms.append((params['bias_gamma_e'], ('uv', lam, b_prim)))

        if self.hcd_model is not None and name == 'LYA':
            hcd_shape_pars = [params.get('L0_hcd'), params.get('L0_fvoigt'),
                              params.get('L0_sinc')]
            if _has_tracer(*hcd_shape_pars):
                return None
            bias_hcd = params.get(f'bias_hcd_{self._corr_name}')
            if bias_hcd is None:
                bias_hcd = params['bias_hcd']
            beta_hcd = params.get(f'beta_hcd_{self._corr_name}')
            if beta_hcd is None:
                beta_hcd = params['beta_hcd']
            b_terms.append((bias_hcd, 'hcd'))
            bb_terms.append((bias_hcd * beta_hcd, 'hcd'))

        return ([(c, key, 0) for c, key in b_terms]
                + [(c, key, 2) for c, key in bb_terms])

    def _poly_basis_grid(self, key, params):
        """Resolve a basis key from `_tracer_poly_terms` to its grid."""
        if key == 'one':
            return None                     # multiplicative identity
        if key == 'hcd':
            return self._hcd_profile(params)
        if isinstance(key, tuple) and key[0] == 'uv':
            _, lam, b_prim = key
            w_k = np.arctan(self.k_grid * lam) / (self.k_grid * lam)
            return jnp.asarray(w_k / (1 + b_prim * w_k)
                               * np.ones_like(self.muk_grid))
        raise KeyError(key)

    def _kaiser_product_terms(self, params):
        """Kaiser factor as merged [(coeff, grid)] product terms, or None
        when not decomposable. Exact (up to reassociation) against
        `compute_kaiser_poly`."""
        bias1, beta1, bias2, beta2 = utils.bias_beta(
            params, self.tracer1_name, self.tracer2_name)
        t1 = self._tracer_poly_terms(params, self.tracer1_name, bias1, beta1)
        t2 = self._tracer_poly_terms(params, self.tracer2_name, bias2, beta2)
        if t1 is None or t2 is None:
            return None

        merged = {}
        for c1, k1, p1 in t1:
            for c2, k2, p2 in t2:
                key = (tuple(sorted([repr(k1), repr(k2)])), p1 + p2)
                coeff = c1 * c2
                if key in merged:
                    prev_c, _ = merged[key]
                    merged[key] = (prev_c + coeff, merged[key][1])
                else:
                    merged[key] = (coeff, (k1, k2, p1 + p2))

        grid_cache = {}

        def basis(k):
            rk = repr(k)
            if rk not in grid_cache:
                grid_cache[rk] = self._poly_basis_grid(k, params)
            return grid_cache[rk]

        muk2 = jnp.asarray(self.muk_grid ** 2 * np.ones_like(self.k_grid))
        mu_pows = {0: None, 2: muk2, 4: muk2 * muk2}

        terms = []
        for coeff, (k1, k2, mupow) in merged.values():
            grid = mu_pows[mupow]
            for k in (k1, k2):
                g = basis(k)
                if g is not None:
                    grid = g if grid is None else grid * g
            if grid is None:
                grid = jnp.asarray(np.ones_like(self.muk_grid)
                                   * np.ones_like(self.k_grid))
            terms.append((coeff, grid))
        return terms

    def compute_tracer_polys(self, params):
        """Per-tracer Kaiser polynomial coefficients (b_eff, bb_eff) with
        T_i(muk) = b_eff_i + bb_eff_i * muk^2, folding in the UV/HeII and
        HCD effective biases WITHOUT the beta_eff division of the
        reference (power_spectrum.py:263-309): since
        beta_eff = (b*beta + b_hcd*beta_hcd*F)/b_eff, the product
        b_eff*(1 + beta_eff*muk^2) telescopes to
        b_eff + (b*beta + b_hcd*beta_hcd*F)*muk^2 exactly."""
        bias1, beta1, bias2, beta2 = utils.bias_beta(
            params, self.tracer1_name, self.tracer2_name)

        polys = []
        for name, bias, beta in ((self.tracer1_name, bias1, beta1),
                                 (self.tracer2_name, bias2, beta2)):
            b_eff = bias
            bb_eff = bias * beta
            if (self._add_uvb or self._add_heii) and name == 'LYA':
                # UV/HeII shift the bias only; bias*beta is invariant
                # (beta_eff = beta * bias / bias_eff)
                b_eff, _ = self.compute_bias_beta_uv_heii(bias, beta, params)
            if self.hcd_model is not None and name == 'LYA':
                bias_hcd = params.get(f'bias_hcd_{self._corr_name}')
                if bias_hcd is None:
                    bias_hcd = params['bias_hcd']
                beta_hcd = params.get(f'beta_hcd_{self._corr_name}')
                if beta_hcd is None:
                    beta_hcd = params['beta_hcd']
                f_hcd = self._hcd_profile(params)
                b_eff = b_eff + bias_hcd * f_hcd
                bb_eff = bb_eff + (bias_hcd * beta_hcd) * f_hcd
            polys.append((b_eff, bb_eff))
        return polys

    def compute_kaiser_poly(self, params):
        """Kaiser factor from the division-free tracer polynomials."""
        (b1, bb1), (b2, bb2) = self.compute_tracer_polys(params)
        muk2 = self.muk_grid ** 2
        return (b1 + bb1 * muk2) * (b2 + bb2 * muk2)

    def _shared_factor(self, params, fast_metals=False, skip_nl=False):
        """Every multiplicative factor except the peak broadening — the
        part shared between the peak and smooth components of one
        evaluation, so it is computed once (the reference recomputes it
        per component and leans on value caches)."""
        bad = jnp.asarray(False)

        bias1, beta1, bias2, beta2 = utils.bias_beta(
            params, self.tracer1_name, self.tracer2_name)

        if self._add_uvb or self._add_heii:
            if self.tracer1_name == 'LYA':
                bias1, beta1 = self.compute_bias_beta_uv_heii(bias1, beta1, params)
            if self.tracer2_name == 'LYA':
                bias2, beta2 = self.compute_bias_beta_uv_heii(bias2, beta2, params)

        if self.hcd_model is not None:
            if self.tracer1_name == 'LYA':
                bias1, beta1 = self.compute_bias_beta_hcd(bias1, beta1, params)
            if self.tracer2_name == 'LYA':
                bias2, beta2 = self.compute_bias_beta_hcd(bias2, beta2, params)

        factor = self.compute_kaiser(bias1, beta1, bias2, beta2, fast_metals)

        if self.small_scale_nl is not None and not skip_nl:
            if 'arinyo' in self.small_scale_nl:
                dnl, dnl_bad = self.compute_dnl_arinyo(params)
                factor = factor * dnl
                bad = bad | dnl_bad
            elif 'mcdonald' in self.small_scale_nl:
                factor = factor * self.compute_dnl_mcdonald()
            else:
                raise ValueError("Incorrect 'small scale nl' specified")

        if self.use_Gk:
            # Per-dataset binsize overrides in the parameters take
            # precedence over the config bin sizes (reference:
            # power_spectrum.py:139-141 via compute_Gk's params lookup)
            if (f'par binsize {self._name}' in params
                    or f'per binsize {self._name}' in params):
                factor = factor * self.compute_Gk(params)
            else:
                factor = factor * resolve(self._pk_gk_ref)

        if self.mock_bin_size is not None:
            factor = factor * self._compute_mock_binsize_gk(params)

        if self.fullshape_smoothing is not None and not skip_nl:
            if 'gauss' in self.fullshape_smoothing:
                factor = factor * self.compute_fullshape_gauss_smoothing(params)
            elif 'exp' in self.fullshape_smoothing:
                factor = factor * self.compute_fullshape_exp_smoothing(params)
            else:
                raise ValueError(
                    '"fullshape smoothing" must be "gauss" or "exp"')

        if self.velocity_dispersion is not None:
            if 'lorentz_gauss' in self.velocity_dispersion:
                factor = factor * self.compute_velocity_dispersion_lorentz(params)
                factor = factor * self.compute_velocity_dispersion_gauss(params)
            elif 'gauss' in self.velocity_dispersion:
                factor = factor * self.compute_velocity_dispersion_gauss(params)
            elif 'lorentz' in self.velocity_dispersion:
                factor = factor * self.compute_velocity_dispersion_lorentz(params)
            else:
                raise ValueError(
                    '"velocity dispersion" must be "gauss" or "lorentz"')

        if self.pk_damping_scale is not None:
            factor = factor * jnp.exp(
                -self.pk_damping_scale ** 2
                * self.k_grid ** self.pk_damping_power / 2)

        return factor, bad

    # ------------------------------------------------------------------
    # Factors
    # ------------------------------------------------------------------
    def compute_kaiser(self, bias1, beta1, bias2, beta2, fast_metals=False):
        """Kaiser term (reference: power_spectrum.py:198-222)."""
        muk2 = self.muk_grid ** 2
        pk = (1 + beta1 * muk2) * (1 + beta2 * muk2)
        if not fast_metals:
            pk = pk * (bias1 * bias2)
        return pk

    def compute_bias_beta_uv_heii(self, bias, beta, params):
        """UV background fluctuations and HeII reionization effective
        biases (reference: power_spectrum.py:224-261)."""
        bias_eff = bias
        if self._add_uvb:
            bias_gamma = params['bias_gamma']
            bias_prim = params['bias_prim']
            lambda_uv = params['lambda_uv']
            w_k = jnp.arctan(self.k_grid * lambda_uv) / (self.k_grid * lambda_uv)
            bias_eff = bias_eff + bias_gamma * w_k / (1 + bias_prim * w_k)
        if self._add_heii:
            bias_gamma_e = params['bias_gamma_e']
            bias_prim = params['bias_prim']
            lambda_heii = params['lambda_HeII']
            w_k = jnp.arctan(self.k_grid * lambda_heii) / (self.k_grid * lambda_heii)
            bias_eff = bias_eff + bias_gamma_e * w_k / (1 + bias_prim * w_k)
        beta_eff = beta * bias / bias_eff
        return bias_eff, beta_eff

    def compute_bias_beta_hcd(self, bias, beta, params):
        """HCD effective biases (reference: power_spectrum.py:263-309).
        Scale-dependent: promotes bias/beta to (muk, k) grids."""
        bias_hcd = params.get(f'bias_hcd_{self._corr_name}', None)
        if bias_hcd is None:
            bias_hcd = params['bias_hcd']
        beta_hcd = params.get(f'beta_hcd_{self._corr_name}', None)
        if beta_hcd is None:
            beta_hcd = params['beta_hcd']

        f_hcd = self._hcd_profile(params)
        bias_eff = bias + bias_hcd * f_hcd
        beta_eff = (bias * beta + bias_hcd * beta_hcd * f_hcd) / bias_eff
        return bias_eff, beta_eff

    def _hcd_profile(self, params):
        """The HCD suppression profile F(k_par) on the grid
        (reference: power_spectrum.py:263-309 inner branches)."""
        if 'Rogers' in self.hcd_model:
            # Fourier transform of a Lorentzian profile (Rogers et al. 2018)
            return utils.grid_exp(-params['L0_hcd'] * self._kp())
        elif 'fvoigt' in self.hcd_model:
            assert self._Fvoigt_data is not None
            L0 = params.get('L0_fvoigt', 1.)
            k_data = self._Fvoigt_data[:, 0]
            f_data = self._Fvoigt_data[:, 1]
            return jnp.interp(L0 * self._kp(), k_data, f_data,
                              left=1., right=0.)
        elif 'sinc' in self.hcd_model:
            L0 = params.get('L0_sinc', 1.)
            return utils.sinc(self._kp() * L0)
        raise ValueError(f'Unknown hcd model {self.hcd_model}. '
                         "Choose from ['Rogers', 'fvoigt', 'sinc']")

    def compute_peak_nl(self, params):
        """BAO peak non-linear broadening (reference:
        power_spectrum.py:382-417)."""
        sigma_par = params.get('sigmaNL_par', None)
        sigma_trans = params.get('sigmaNL_per', None)
        growth_rate = params.get('growth_rate')
        if sigma_par is None and sigma_trans is not None:
            sigma_par = sigma_trans * (1 + growth_rate)
        elif sigma_trans is None and sigma_par is not None:
            sigma_trans = sigma_par / (1 + growth_rate)
        elif sigma_par is None and sigma_trans is None:
            raise ValueError('No parameters for peak NL found. '
                             'Add sigmaNL_par and/or sigmaNL_per.')
        peak_nl = (self._kp() ** 2 * sigma_par ** 2
                   + self._kt() ** 2 * sigma_trans ** 2)
        return utils.grid_exp(-peak_nl / 2)

    def compute_dnl_mcdonald(self):
        """McDonald 2003 non-linear term (reference:
        power_spectrum.py:419-433)."""
        assert self.tracer1_name == 'LYA' and self.tracer2_name == 'LYA'
        kvel = 1.22 * (1 + self.k_grid / 0.923) ** 0.451
        dnl = ((self.k_grid / 6.4) ** 0.569 - (self.k_grid / 15.3) ** 2.01
               - (self.k_grid * self.muk_grid / kvel) ** 1.5)
        return jnp.exp(dnl)

    def compute_dnl_arinyo(self, params):
        """Arinyo et al. 2015 non-linear term; returns (dnl, bad_flag)
        (reference: power_spectrum.py:435-479)."""
        two_lya = 'LY' in self.tracer1_name and 'LY' in self.tracer2_name
        one_lya = 'LY' in self.tracer1_name or 'LY' in self.tracer2_name

        q1 = params['dnl_arinyo_q1']
        kv = params['dnl_arinyo_kv']
        av = params['dnl_arinyo_av']
        bv = params['dnl_arinyo_bv']
        kp = params['dnl_arinyo_kp']
        q2 = params.get('dnl_arinyo_q2', 0.)

        delta_sq = self.k_grid ** 3 * self._pk_fid / (2 * np.pi ** 2)
        growth = q1 * delta_sq + q2 * delta_sq ** 2
        pec_velocity = (self.k_grid / kv) ** av * jnp.abs(self.muk_grid) ** bv
        pressure = (self.k_grid / kp) * (self.k_grid / kp)
        dnl = utils.grid_exp(growth * (1 - pec_velocity) - pressure)

        bad = ~jnp.all(jnp.isfinite(dnl))
        if two_lya:
            return dnl, bad
        if one_lya:
            return jnp.sqrt(dnl), bad
        return jnp.ones(dnl.shape), jnp.asarray(False)

    def _gk_window(self, bin_size_rp, bin_size_rt):
        """Binning window G(k) = sinc * sinc (reference:
        power_spectrum.py:481-502). Accepts traced bin sizes."""
        gk = 1.
        if not (isinstance(bin_size_rp, float) and bin_size_rp == 0):
            gk = gk * utils.sinc(self._kp() * bin_size_rp / 2)
        if not (isinstance(bin_size_rt, float) and bin_size_rt == 0):
            gk = gk * utils.sinc(self._kt() * bin_size_rt / 2)
        return gk

    def compute_Gk(self, params):
        """Binning window with per-dataset overrides (reference:
        power_spectrum.py:481-502)."""
        bin_size_rp = params.get(f'par binsize {self._name}', self._bin_size_rp)
        bin_size_rt = params.get(f'per binsize {self._name}', self._bin_size_rt)
        return self._gk_window(bin_size_rp, bin_size_rt)

    def _compute_mock_binsize_gk(self, params):
        """Mock pixelization smoothing (reference: power_spectrum.py:143-160)."""
        bin_size = self.mock_bin_size
        par_size, per_size = bin_size, bin_size
        los = self.mock_los_smoothing
        if los == 'growth':
            par_size = bin_size * (1 + params['growth_rate'])
        elif los == 'amplitude':
            par_size = bin_size * (1 + params['los_smooth_amp'])
        elif los == 'only-los':
            per_size = 0.
        elif los is not None:
            raise ValueError(f'Unknown mock LOS smoothing option {los}.')
        gk = utils.sinc(self._kp() * par_size / 2)
        if not (isinstance(per_size, float) and per_size == 0):
            gk = gk * utils.sinc(self._kt() * per_size / 2)
        return gk

    def compute_fullshape_gauss_smoothing(self, params):
        """Full-shape Gaussian smoothing (reference:
        power_spectrum.py:504-553), incl. the squared variant and the
        per-tracer / metal fallbacks."""
        def gauss(sig_par, sig_trans):
            return utils.grid_exp(-(self._kp() ** 2 * sig_par ** 2
                                    + self._kt() ** 2 * sig_trans ** 2) / 2)

        check1 = self.tracer1_name in ['LYA', 'QSO']
        check2 = self.tracer2_name in ['LYA', 'QSO']

        if ('par_sigma_smooth' in params) or ('per_sigma_smooth' in params):
            sigma_par = params.get('par_sigma_smooth', None)
            sigma_trans = params.get('per_sigma_smooth', None)
            if sigma_par is None and sigma_trans is None:
                raise ValueError(
                    'Fullshape gaussian smoothing requested without '
                    'par_sigma_smooth and/or per_sigma_smooth.')
            if sigma_par is None:
                sigma_par = sigma_trans
            if sigma_trans is None:
                sigma_trans = sigma_par
            return gauss(sigma_par, sigma_trans) ** 2

        if (('par_sigma_smooth_metals' in params)
                and ('per_sigma_smooth_metals' in params)
                and not (check1 and check2)):
            return gauss(params['par_sigma_smooth_metals'],
                         params['per_sigma_smooth_metals']) ** 2

        return (gauss(params[f'par_sigma_smooth_{self.tracer1_name}'],
                      params[f'per_sigma_smooth_{self.tracer1_name}'])
                * gauss(params[f'par_sigma_smooth_{self.tracer2_name}'],
                        params[f'per_sigma_smooth_{self.tracer2_name}']))

    def compute_fullshape_exp_smoothing(self, params):
        """Gaussian + exponential smoothing for london mocks
        (reference: power_spectrum.py:560-586)."""
        gauss_sm = (self._kp() ** 2 * params['par_sigma_smooth'] ** 2
                    + self._kt() ** 2 * params['per_sigma_smooth'] ** 2)
        exp_sm = (jnp.abs(self._kp()) * params['par_exp_smooth'] ** 2
                  + jnp.abs(self._kt()) * params['per_exp_smooth'] ** 2)
        return utils.grid_exp(-gauss_sm / 2) * utils.grid_exp(-exp_sm)

    def compute_velocity_dispersion_gauss(self, params):
        """Gaussian velocity dispersion (reference:
        power_spectrum.py:588-611)."""
        assert 'discrete' in (self.tracer1_type, self.tracer2_type)
        smoothing = 1.
        if self.tracer1_type == 'discrete':
            sigma = params['sigma_velo_disp_gauss_' + self.tracer1_name]
            smoothing = smoothing * utils.grid_exp(
                -0.25 * (self._kp() * sigma) ** 2)
        if self.tracer2_type == 'discrete':
            sigma = params['sigma_velo_disp_gauss_' + self.tracer2_name]
            smoothing = smoothing * utils.grid_exp(
                -0.25 * (self._kp() * sigma) ** 2)
        return smoothing * jnp.ones(self._kp().shape)

    def compute_velocity_dispersion_lorentz(self, params):
        """Lorentzian velocity dispersion (reference:
        power_spectrum.py:613-636)."""
        assert 'discrete' in (self.tracer1_type, self.tracer2_type)
        smoothing = 1.
        if self.tracer1_type == 'discrete':
            sigma = params['sigma_velo_disp_lorentz_' + self.tracer1_name]
            smoothing = smoothing / jnp.sqrt(1 + (self._kp() * sigma) ** 2)
        if self.tracer2_type == 'discrete':
            sigma = params['sigma_velo_disp_lorentz_' + self.tracer2_name]
            smoothing = smoothing / jnp.sqrt(1 + (self._kp() * sigma) ** 2)
        return smoothing * jnp.ones(self._kp().shape)
