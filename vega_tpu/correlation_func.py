"""Correlation-function (xi-space) model for one tracer pair.

JAX counterpart of the reference's vega/correlation_func.py:
AP coordinate rescaling, bias redshift evolution, growth, QSO radiation,
relativistic/asymmetry terms, UV shotnoise and the DESI instrumental
systematics correction. All static quantities (growth factor on the z
grid, z-evolution bases, the A(tau) shotnoise table, the instrumental-
systematics template) are precomputed on the host at init; `compute` is
jax-traceable.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from scipy.interpolate import interp1d
from scipy.special import expn

from . import utils
from .cosmo import growth_function


class CorrelationFunction:
    """xi-space model (reference: correlation_func.py:10-115 for the
    configuration surface)."""

    def __init__(self, config, fiducial, coordinates, scale_params,
                 tracer1, tracer2, cosmo=None, metal_corr=False):
        self._config = config
        self._r = np.asarray(coordinates.r_grid)
        self._mu = np.asarray(coordinates.mu_grid)
        self._z = coordinates.z_grid
        self._multipole = config.getint('single_multipole', -1)
        self._tracer1 = tracer1
        self._tracer2 = tracer2
        self._corr_name = f'{tracer1["name"]}x{tracer2["name"]}'
        self._z_eff = fiducial['z_eff']
        self._scale_params = scale_params
        self._metal_corr = metal_corr
        self._use_new_bias_evol = config.getboolean('new-bias-evolution', False)
        self._rescale_coords_systematics = config.getboolean(
            'rescale-coords-systematics', False)

        self.init_bias_evol(tracer1['type'], tracer2['type'], cosmo)

        # delta rp only for the cross (reference: correlation_func.py:64-69)
        self._delta_rp_name = None
        if tracer1['type'] == 'discrete' and tracer2['type'] != 'discrete':
            self._delta_rp_name = 'drp_' + tracer1['name']
        elif tracer2['type'] == 'discrete' and tracer1['type'] != 'discrete':
            self._delta_rp_name = 'drp_' + tracer2['name']

        # Growth factor, precomputed on the (static) z grid
        # (reference: correlation_func.py:71-80)
        self._z_fid = fiducial['z_fiducial']
        self._Omega_m = fiducial.get('Omega_m', None)
        self._Omega_de = fiducial.get('Omega_de', None)
        if not config.getboolean('old_growth_func', False):
            self.xi_growth = self.compute_growth(
                self._z, self._z_fid, self._Omega_m, self._Omega_de)
        else:
            self.xi_growth = self.compute_growth_old(
                self._z, self._z_fid, self._Omega_m, self._Omega_de)

        # QSO radiation (reference: correlation_func.py:82-91)
        self.radiation_flag = config.getboolean('radiation effects', False)
        if self.radiation_flag:
            names = [tracer1['name'], tracer2['name']]
            if not ('QSO' in names and 'LYA' in names):
                raise ValueError('QSO radiation effects only apply to the '
                                 'cross (QSOxLya)')

        # Relativistic effects / standard asymmetry
        # (reference: correlation_func.py:93-105)
        self.relativistic_flag = config.getboolean('relativistic correction', False)
        self.asymmetry_flag = config.getboolean('standard asymmetry', False)
        if self.relativistic_flag or self.asymmetry_flag:
            types = [tracer1['type'], tracer2['type']]
            if ('continuous' not in types) or (types[0] == types[1]):
                raise ValueError('Relativistic effects and standard asymmetry '
                                 'only work for the cross')

        # UV shotnoise A(tau) table (reference: correlation_func.py:107-112)
        self.uv_shotnoise_flag = config.getboolean('UVB-shotnoise', False)
        self._uv_shotnoise_tau = None
        self._uv_shotnoise_A = None
        if self.uv_shotnoise_flag:
            self._uv_shotnoise_tau, self._uv_shotnoise_A = \
                self.compute_shotnoise_A()

        # DESI instrumental systematics template: the rt interpolation only
        # depends on the static grid, so it is precomputed here rather than
        # per call (reference: correlation_func.py:553-595)
        self._desi_syst_template = None

    # ------------------------------------------------------------------
    def compute(self, pk, pk_lin, pktoxi_obj, params):
        """xi model for the input P(k); returns (xi, bad_flag)
        (reference: correlation_func.py:117-161).

        A FactoredXi from the transform stays factored through the
        multiplicative and additive stages when the parameters those
        stages actually read are not sampled (the RecordingParams
        classification); any traced stage densifies first, preserving
        the dense pipeline's values exactly."""
        from .factored import (FactoredXi, RecordingParams, densify,
                               has_tracer)

        xi, rescaled_r, rescaled_mu, bad = self.compute_core(
            pk, pktoxi_obj, params)

        rec = RecordingParams(params)
        evol = self.compute_bias_evol(rec)
        if isinstance(xi, FactoredXi) and rec.traced():
            xi = xi.dense()
        if isinstance(xi, FactoredXi):
            xi = xi.mul_vec(evol * jnp.asarray(self.xi_growth))
        else:
            xi = xi * evol
            xi = xi * self.xi_growth

        if self.radiation_flag and not bool(params['peak']):
            if isinstance(xi, FactoredXi):
                # strength is linear; the shape reads the other three
                # radiation parameters (and the rescaled coordinates,
                # concrete here since xi stayed factored)
                rad_pars = dict(params)
                rad_pars['qso_rad_strength'] = 1.0
                rec_rad = RecordingParams(rad_pars)
                shape = self.compute_qso_radiation(rec_rad, rescaled_r,
                                                   rescaled_mu)
                if rec_rad.traced():
                    xi = xi.dense() + params['qso_rad_strength'] * shape
                else:
                    xi = xi.add_vec(shape, coeff=params['qso_rad_strength'])
            else:
                xi = xi + self.compute_qso_radiation(params, rescaled_r,
                                                     rescaled_mu)

        if self.relativistic_flag:
            term = self.compute_xi_relativistic(pk_lin, pktoxi_obj, params)
            xi = densify(xi) + term if isinstance(xi, FactoredXi) else xi + term

        if self.asymmetry_flag:
            term = self.compute_xi_asymmetry(pk_lin, pktoxi_obj, params)
            xi = densify(xi) + term if isinstance(xi, FactoredXi) else xi + term

        if self.uv_shotnoise_flag:
            # amplitude (bias_gamma^2 * amp * lambda_uv) is linear; the
            # shape reads lambda_uv and possibly the rescaled coords
            from .factored import keyed_tracer
            if isinstance(xi, FactoredXi) and not keyed_tracer(
                    'lambda_uv', params['lambda_uv']):
                lam = params['lambda_uv']
                r = (jnp.sqrt(rescaled_r ** 2 + rescaled_mu ** 2)
                     if self._rescale_coords_systematics
                     else jnp.asarray(self._r))
                shape = lam / r * self.uv_A(r / lam)
                if 'bias_gamma' in params:
                    bias_gamma = params['bias_gamma']
                elif 'bias_gamma_e' in params:
                    bias_gamma = params['bias_gamma_e']
                else:
                    raise ValueError(
                        'UV shotnoise requested but bias_gamma or '
                        'bias_gamma_e is not in the parameters.')
                amp = bias_gamma ** 2 * params['uv_shotnoise_amp']
                xi = xi.add_vec(shape, coeff=amp)
            else:
                xi = densify(xi) + self.compute_uv_shotnoise(
                    params, rescaled_r, rescaled_mu)

        return xi, bad

    def compute_core(self, pk, pktoxi_obj, params):
        """Hankel transform + AP rescaling (reference:
        correlation_func.py:163-198)."""
        from .factored import RecordingParams

        # The recording view tracks WHICH parameters the rescaling read,
        # so tracers of designated grid parameters (grid-collapse sweeps,
        # vega_tpu/gridcollapse.py) count as row-safe: the transform
        # stays factored with basis rows that are functions of (ap, at).
        rec = RecordingParams(params)
        delta_rp = 0.
        if self._delta_rp_name is not None:
            delta_rp = rec.get(self._delta_rp_name, 0.)

        ap, at = self._scale_params.get_ap_at(
            rec, corr_name=self._corr_name, metal_corr=self._metal_corr)

        rescaled_r, rescaled_mu = self._rescale_coords(
            self._r, self._mu, ap, at, delta_rp)

        xi, bad = pktoxi_obj.compute(
            rescaled_r, rescaled_mu, pk, self._multipole,
            coords_param_free=not rec.traced())
        return xi, rescaled_r, rescaled_mu, bad

    @staticmethod
    def _rescale_coords(r, mu, ap, at, delta_rp=0.):
        """AP rescaling (reference: correlation_func.py:200-236);
        branchless at r = 0."""
        r = jnp.asarray(r)
        mu = jnp.asarray(mu)
        mask = r != 0
        rp = r * mu + delta_rp * mask
        rt = r * jnp.sqrt(1 - mu ** 2)
        rescaled_rp = ap * rp
        rescaled_rt = at * rt
        # guard the sqrt ARGUMENT, not just the output: sqrt'(0) = inf,
        # and where(mask, nan_grad_branch, 0) still propagates NaN
        # through the backward pass (0 * inf). Metal grids contain
        # r = 0 bins, so with metal-scaling this is a live path for
        # d(chi2)/d(ap, at).
        sq = rescaled_rp ** 2 + rescaled_rt ** 2
        pos = mask & (sq > 0)
        rescaled_r = jnp.sqrt(jnp.where(pos, sq, 1.0))
        rescaled_mu = jnp.where(pos, rescaled_rp, 0.0) \
            / jnp.where(pos, rescaled_r, 1.0)
        return jnp.where(pos, rescaled_r, 0.0), rescaled_mu

    # ------------------------------------------------------------------
    # Bias z-evolution
    # ------------------------------------------------------------------
    def init_bias_evol(self, type1, type2, cosmo=None):
        """Precompute relative z-evolution bases (reference:
        correlation_func.py:238-274)."""
        self._rel_z_evol = (1. + np.asarray(self._z)) / (1 + self._z_eff)
        if type1 == type2:
            self._use_new_bias_evol = False
            return
        if cosmo is None:
            if self._use_new_bias_evol:
                print('Warning: No cosmology found in xcf files, '
                      'using mean redshift evolution.')
            self._use_new_bias_evol = False
            return

        # Split redshifts along the line of sight: rp ~ (z_F - z_Q) D_H(z)
        rp = self._r * self._mu
        dist_hubble = cosmo.get_dist_hubble(self._z)
        z_q = self._z - rp / (2 * dist_hubble)
        z_f = self._z + rp / (2 * dist_hubble)
        rel_q = (1. + z_q) / (1 + self._z_eff)
        rel_f = (1. + z_f) / (1 + self._z_eff)
        self._rel_z_evol_1 = rel_q if type1 == 'discrete' else rel_f
        self._rel_z_evol_2 = rel_q if type2 == 'discrete' else rel_f

    def compute_bias_evol(self, params):
        """(reference: correlation_func.py:276-299)"""
        if self._use_new_bias_evol:
            rel_1, rel_2 = self._rel_z_evol_1, self._rel_z_evol_2
        else:
            rel_1, rel_2 = self._rel_z_evol, self._rel_z_evol
        evol = self._get_tracer_evol(params, self._tracer1['name'], rel_1)
        evol = evol * self._get_tracer_evol(params, self._tracer2['name'], rel_2)
        return evol

    def _get_tracer_evol(self, params, tracer_name, rel_z_evol):
        handle_name = f'z evol {tracer_name}'
        if handle_name in self._config:
            evol_model = self._config.get(handle_name, 'standard')
        else:
            evol_model = self._config.get('z evol', 'standard')
        if 'croom' in evol_model:
            assert not self._use_new_bias_evol, \
                'Croom model is not supported with new bias evol'
            return self._bias_evol_croom(params, tracer_name)
        return self._bias_evol_std(params, tracer_name, rel_z_evol)

    @staticmethod
    def _bias_evol_std(params, tracer_name, rel_z_evol):
        """(1+z)^alpha power law (reference: correlation_func.py:332-349)."""
        p0 = params[f'alpha_{tracer_name}']
        return jnp.asarray(rel_z_evol) ** p0

    def _bias_evol_croom(self, params, tracer_name):
        """Croom et al. 2005 QSO model (reference:
        correlation_func.py:351-370)."""
        assert tracer_name == 'QSO'
        p0 = params['croom_par0']
        p1 = params['croom_par1']
        z = jnp.asarray(self._z)
        return (p0 + p1 * (1. + z) ** 2) / (p0 + p1 * (1 + self._z_eff) ** 2)

    # ------------------------------------------------------------------
    # Growth (host-side, init only)
    # ------------------------------------------------------------------
    def compute_growth(self, z_grid=None, z_fid=None, Omega_m=None,
                       Omega_de=None):
        """D(z)^2 / D(z_fid)^2 (reference: correlation_func.py:372-403)."""
        if z_grid is None:
            z_grid = self._z
        if z_fid is None:
            z_fid = self._z_fid
        if Omega_m is None:
            Omega_m = self._Omega_m
        if Omega_de is None:
            Omega_de = self._Omega_de

        if Omega_de is None:
            growth = (1 + z_fid) / (1. + np.asarray(z_grid))
            return growth ** 2
        growth = growth_function(z_grid, Omega_m, Omega_de)
        growth = growth / growth_function(z_fid, Omega_m, Omega_de)
        return growth ** 2

    def compute_growth_old(self, z_grid=None, z_fid=None, Omega_m=None,
                           Omega_de=None):
        """Deprecated 100-point growth integration (reference:
        correlation_func.py:405-444); kept for config compatibility."""
        from scipy.integrate import quad

        def hubble(z):
            return np.sqrt(Omega_m * (1 + z) ** 3 + Omega_de
                           + (1 - Omega_m - Omega_de) * (1 + z) ** 2)

        def dD1(a):
            z = 1 / a - 1
            return 1. / (a * hubble(z)) ** 3

        nbins, zmax = 100, 5.
        z = zmax * np.arange(nbins, dtype=float) / (nbins - 1)
        d1 = np.zeros(nbins)
        for i in range(nbins):
            a = 1 / (1 + z[i])
            d1[i] = 2.5 * Omega_m * hubble(z[i]) * quad(dD1, 0, a)[0]
        d1_interp = interp1d(z, d1)
        growth = d1_interp(z_grid) / d1_interp(z_fid)
        return growth ** 2

    # ------------------------------------------------------------------
    # Additive terms
    # ------------------------------------------------------------------
    def compute_qso_radiation(self, params, rescaled_r, rescaled_mu):
        """QSO transverse proximity effect (reference:
        correlation_func.py:446-489)."""
        assert 'QSO' in [self._tracer1['name'], self._tracer2['name']]
        assert self._tracer1['name'] != self._tracer2['name']

        delta_rp = params.get(self._delta_rp_name, 0.)
        if self._rescale_coords_systematics:
            rp = rescaled_r * rescaled_mu + delta_rp
            rt = rescaled_r * jnp.sqrt(1 - rescaled_mu ** 2)
        else:
            rp = jnp.asarray(self._r * self._mu) + delta_rp
            rt = jnp.asarray(self._r * np.sqrt(1 - self._mu ** 2))

        r_shift = jnp.sqrt(rp ** 2 + rt ** 2)
        r_safe = jnp.where(r_shift != 0, r_shift, 1.0)
        mu_shift = rp / r_safe

        strength = params['qso_rad_strength']
        asymmetry = params['qso_rad_asymmetry']
        lifetime = params['qso_rad_lifetime']
        decrease = params['qso_rad_decrease']

        xi_rad = strength / (r_safe ** 2) * (
            1 - asymmetry * (1 - mu_shift ** 2))
        xi_rad = xi_rad * jnp.exp(
            -r_shift * ((1 + mu_shift) / lifetime + 1 / decrease))
        return xi_rad

    def compute_xi_relativistic(self, pk, pktoxi_obj, params):
        """(reference: correlation_func.py:491-520)"""
        assert 'continuous' in [self._tracer1['type'], self._tracer2['type']]
        assert self._tracer1['type'] != self._tracer2['type']
        delta_rp = params.get(self._delta_rp_name, 0.)
        ap, at = self._scale_params.get_ap_at(params,
                                              metal_corr=self._metal_corr)
        rescaled_r, rescaled_mu = self._rescale_coords(
            self._r, self._mu, ap, at, delta_rp)
        return pktoxi_obj.pk_to_xi_relativistic(
            rescaled_r, rescaled_mu, pk, params)

    def compute_xi_asymmetry(self, pk, pktoxi_obj, params):
        """(reference: correlation_func.py:522-551)"""
        assert 'continuous' in [self._tracer1['type'], self._tracer2['type']]
        assert self._tracer1['type'] != self._tracer2['type']
        delta_rp = params.get(self._delta_rp_name, 0.)
        ap, at = self._scale_params.get_ap_at(params,
                                              metal_corr=self._metal_corr)
        rescaled_r, rescaled_mu = self._rescale_coords(
            self._r, self._mu, ap, at, delta_rp)
        return pktoxi_obj.pk_to_xi_asymmetry(
            rescaled_r, rescaled_mu, pk, params)

    def compute_desi_instrumental_systematics(self, params, bin_size_rp):
        """Fiber-positioner sky-noise correlation (reference:
        correlation_func.py:553-595). The rt interpolation is static, so
        the template is precomputed; per eval it is amplitude * template."""
        if self._tracer1['type'] != self._tracer2['type']:
            raise ValueError('DESI instrumental systematics model only '
                             'applies to auto-correlation functions.')
        if self._desi_syst_template is None:
            rp = self._r * self._mu
            rt = self._r * np.sqrt(1 - self._mu ** 2)
            w = (rp > 0) & (rp < bin_size_rp)
            path = utils.find_file(
                'instrumental_systematics/'
                'desi-instrument-syst-for-forest-auto-correlation.csv')
            table = np.genfromtxt(path, delimiter=',', names=True)
            interp = interp1d(table['RT'], table['XI'], kind='linear')
            template = np.zeros(rt.shape)
            template[w] = interp(rt[w])
            self._desi_syst_template = template

        amp = params.get('desi_inst_sys_amp', 0.0003189935987295203)
        return amp * jnp.asarray(self._desi_syst_template)

    # ------------------------------------------------------------------
    # UV shotnoise
    # ------------------------------------------------------------------
    @staticmethod
    def compute_shotnoise_A(ntau=100, nrho=10000):
        """A(tau) from Eq. 19 of Gontcho A Gontcho et al. (1404.7425)
        (reference: correlation_func.py:597-626); host-side init work."""
        tau = np.linspace(0.01, 5, ntau)
        rho = np.linspace(0.0001, 10, nrho)
        drho = rho[1] - rho[0]
        a_vals = np.zeros(tau.size)
        for i, t in enumerate(tau):
            a_vals[i] = -np.sum(
                drho * np.exp(-rho) / rho * (
                    expn(1, rho * np.sqrt(1 + (t / rho) ** 2))
                    - expn(1, rho * np.abs(1 - t / rho))))
        return tau, a_vals

    def uv_A(self, tau):
        """Interpolated A(tau) (reference: correlation_func.py:628-647)."""
        if self._uv_shotnoise_A is None:
            self._uv_shotnoise_tau, self._uv_shotnoise_A = \
                self.compute_shotnoise_A()
        return jnp.interp(tau, self._uv_shotnoise_tau, self._uv_shotnoise_A,
                          left=self._uv_shotnoise_A[0], right=0.)

    def compute_uv_shotnoise(self, params, rescaled_r, rescaled_mu):
        """(reference: correlation_func.py:649-686)"""
        shotnoise_amp = params['uv_shotnoise_amp']
        lambda_uv = params['lambda_uv']
        if 'bias_gamma' in params:
            bias_gamma = params['bias_gamma']
        elif 'bias_gamma_e' in params:
            bias_gamma = params['bias_gamma_e']
        else:
            raise ValueError('UV shotnoise requested but bias_gamma or '
                             'bias_gamma_e is not in the parameters.')
        if self._rescale_coords_systematics:
            r = jnp.sqrt(rescaled_r ** 2 + rescaled_mu ** 2)
        else:
            r = jnp.asarray(self._r)
        return (bias_gamma ** 2 * shotnoise_amp * lambda_uv / r
                * self.uv_A(r / lambda_uv))
