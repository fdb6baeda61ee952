"""Per-correlation model assembly: peak/smooth decomposition, metals,
systematics, broadbands and the distortion matrix.

Counterpart of the reference's vega/model.py. `compute` is jax-traceable
end to end and returns (xi, bad_flag); the distortion matrix application
is a dense matmul (the reference uses a sparse csr dot,
model.py:143-144).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

import jax

from . import broadband_poly, metals
from . import correlation_func as corr_func
from . import pktoxi, power_spectrum
from .statics import is_identity, register as register_static, resolve


def _concrete(x):
    """True when x can be materialized (saving components only makes
    sense on eager evaluations; under jit the values are tracers)."""
    from .factored import FactoredXi
    if isinstance(x, (power_spectrum.FactoredPk, FactoredXi)):
        return False    # factored forms only exist inside a trace
    return not isinstance(x, jax.core.Tracer)


class Model:
    """Correlation model for one component (reference: model.py:8-77)."""

    def __init__(self, corr_item, fiducial, scale_params, data=None):
        self._corr_item = corr_item
        self._model_pk = corr_item.model_pk

        assert corr_item.model_coordinates is not None

        self._data = data
        data_has_distortion = False
        if self._data is not None:
            data_has_distortion = self._data.has_distortion
        self._has_distortion_mat = (corr_item.has_distortion
                                    and data_has_distortion)

        corr_item.config['model']['bin_size_rp'] = \
            str(corr_item.data_coordinates.rp_binsize)
        corr_item.config['model']['bin_size_rt'] = \
            str(corr_item.data_coordinates.rt_binsize)

        self.save_components = fiducial.get('save-components', False)
        if self.save_components:
            self.pk = {'peak': {}, 'smooth': {}, 'full': {}}
            self.xi = {'peak': {}, 'smooth': {}, 'full': {}}
            self.xi_distorted = {'peak': {}, 'smooth': {}, 'full': {}}

        self.broadband = None
        if 'broadband' in corr_item.config:
            self.broadband = broadband_poly.BroadbandPolynomials(
                corr_item.config['broadband'], corr_item.name,
                corr_item.model_coordinates, corr_item.dist_model_coordinates)

        self.Pk_core = power_spectrum.PowerSpectrum(
            corr_item.config['model'], fiducial, corr_item.tracer1,
            corr_item.tracer2, corr_item.name)

        self.PktoXi = pktoxi.PktoXi.init_from_Pk(
            self.Pk_core, corr_item.config['model'])

        self.Xi_core = corr_func.CorrelationFunction(
            corr_item.config['model'], fiducial, corr_item.model_coordinates,
            scale_params, corr_item.tracer1, corr_item.tracer2,
            cosmo=corr_item.cosmo)

        self.metals = None
        if corr_item.has_metals:
            self.metals = metals.Metals(corr_item, fiducial, scale_params,
                                        data)
            self.no_metal_decomp = corr_item.config['model'].getboolean(
                'no-metal-decomp', True)

        self._instrumental_systematics_flag = \
            corr_item.config['model'].getboolean(
                'desi-instrumental-systematics', False)

        # Dense distortion matrix, shipped to device once via the statics
        # store. When the matrix is exactly the identity (the reference
        # substitutes eye matrices for absent distortion, data.py:78) the
        # matmul is skipped entirely — numerically identical, no 50MB
        # constant.
        self._dist_mat = None
        if self._has_distortion_mat:
            dist = np.asarray(self._data.distortion_mat, dtype=np.float64)
            if not is_identity(dist):
                self._dist_mat = register_static(dist, 'dmat')

    # ------------------------------------------------------------------
    def _compute_model(self, pars, pk_lin, component='smooth',
                       xi_metals=None, pk_model=None, bad_in=None):
        """One component's correlation function (reference: model.py:79-155).
        Returns (xi, bad_flag). pk_model may be precomputed by compute()
        so the peak/smooth passes share their common factor pipeline."""
        if pk_model is None:
            pk_model, bad = self.Pk_core.compute(pk_lin, pars)
        else:
            bad = bad_in if bad_in is not None else jnp.asarray(False)

        if self._model_pk:
            return self.PktoXi.compute_pk_ells(pk_model), bad

        xi_model, xi_bad = self.Xi_core.compute(
            pk_model, pk_lin, self.PktoXi, pars)
        bad = bad | xi_bad

        if self.save_components and _concrete(pk_model):
            self.pk[component]['core'] = np.asarray(pk_model)
            self.xi[component]['core'] = np.asarray(xi_model)

        from .factored import FactoredXi, RecordingParams, densify

        if self._corr_item.has_metals:
            if self.no_metal_decomp and xi_metals is not None:
                xi_model = self._add_xi(xi_model, xi_metals)
            elif not self.no_metal_decomp:
                xi_m, m_bad = self.metals.compute(pars, pk_lin, component)
                xi_model = self._add_xi(xi_model, xi_m)
                bad = bad | m_bad
                if self.save_components and _concrete(xi_m):
                    self.pk[component].update(self.metals.pk[component])
                    self.xi[component].update(self.metals.xi[component])
                    self.xi_distorted[component].update(
                        self.metals.xi_distorted[component])

        if self._instrumental_systematics_flag and component != 'peak':
            # amplitude * static template — a natural factored term
            amp = pars.get('desi_inst_sys_amp', None)
            syst_pars = pars if amp is None else {'desi_inst_sys_amp': 1.0}
            template = self.Xi_core.compute_desi_instrumental_systematics(
                syst_pars, self._corr_item.data_coordinates.rp_binsize)
            if isinstance(xi_model, FactoredXi):
                xi_model = xi_model.add_vec(
                    template, coeff=1.0 if amp is None else amp)
            else:
                xi_model = xi_model + (template if amp is None
                                       else amp * template)

        if self.broadband is not None:
            xi_model = self._apply_broadband(xi_model, pars, 'pre')

        if self._dist_mat is not None:
            dmat = jnp.asarray(resolve(self._dist_mat))
            if isinstance(xi_model, FactoredXi):
                xi_model = xi_model.matmul(dmat)
            else:
                xi_model = dmat @ xi_model

        if self.broadband is not None:
            xi_model = self._apply_broadband(xi_model, pars, 'post')

        if self.save_components and _concrete(xi_model):
            self.xi_distorted[component]['core'] = np.asarray(xi_model)

        return xi_model, bad

    @staticmethod
    def _add_xi(a, b):
        """Add two xi values, keeping the factored form when both sides
        carry one (mixed forms densify the factored side)."""
        from .factored import FactoredXi
        if isinstance(a, FactoredXi) and isinstance(b, FactoredXi):
            return a + b
        if isinstance(a, FactoredXi):
            return a.dense() + b
        if isinstance(b, FactoredXi):
            return a + b.dense()
        return a + b

    def _apply_broadband(self, xi_model, pars, position):
        """Multiplicative then additive broadband at one position
        (pre/post distortion), preserving the factored form: the
        multiplicative polynomial is parameter-static unless its
        coefficients are sampled, and the additive polynomial is linear
        in its coefficients (design-matrix columns become terms)."""
        from .factored import FactoredXi, RecordingParams

        if isinstance(xi_model, FactoredXi):
            rec = RecordingParams(pars)
            bb_mul = self.broadband.compute(rec, f'{position}-mul')
            if rec.traced():
                # sampled mul-coefficient: densify, apply BOTH stages
                # here and return (falling through would multiply by the
                # mul-broadband a second time)
                xi_model = xi_model.dense() * bb_mul
                return xi_model + self.broadband.compute(pars,
                                                         f'{position}-add')
            if not (isinstance(bb_mul, float) and bb_mul == 1.):
                xi_model = xi_model.mul_vec(
                    bb_mul * jnp.ones(xi_model.V.shape[1]))
            terms = self.broadband.compute_add_terms(pars, position)
            if terms is None:
                return (xi_model.dense()
                        + self.broadband.compute(pars, f'{position}-add'))
            return xi_model.add_terms(terms)

        xi_model = xi_model * self.broadband.compute(pars, f'{position}-mul')
        xi_model = xi_model + self.broadband.compute(pars, f'{position}-add')
        return xi_model

    def compute(self, pars, pk_full, pk_smooth):
        """Peak/smooth decomposition (reference: model.py:157-187).
        Returns (xi_full, bad_flag).

        The multiplicative factor pipeline (Kaiser, HCD, NL, windows,
        smoothings) is identical for the peak and smooth components of
        one evaluation, so it is built once and only the peak broadening
        differs (the reference recomputes it per component behind value
        caches)."""
        pars = dict(pars)
        pk_peak_lin = np.asarray(pk_full) - np.asarray(pk_smooth)

        pars['peak'] = True
        pk_peak, pk_smooth_grid, bad_f = self.Pk_core.compute_peak_smooth(
            pars, pk_peak_lin, pk_smooth)
        xi_peak, bad_peak = self._compute_model(
            pars, pk_peak_lin, 'peak', pk_model=pk_peak, bad_in=bad_f)

        pars['peak'] = False
        xi_metals = None
        bad_metals = jnp.asarray(False)
        if self._corr_item.has_metals and self.no_metal_decomp:
            xi_metals, bad_metals = self.metals.compute(pars, pk_full, 'full')

        xi_smooth, bad_smooth = self._compute_model(
            pars, pk_smooth, 'smooth', xi_metals=xi_metals,
            pk_model=pk_smooth_grid)

        from .factored import FactoredXi
        if isinstance(xi_peak, FactoredXi):
            xi_peak = xi_peak.scale(pars['bao_amp'])
        else:
            xi_peak = pars['bao_amp'] * xi_peak
        xi_full = self._add_xi(xi_peak, xi_smooth)
        return xi_full, bad_peak | bad_metals | bad_smooth

    def compute_direct(self, pars, pk_full):
        """Direct full-Pk model (reference: model.py:189-208)."""
        pars = dict(pars)
        pars['peak'] = False
        return self._compute_model(pars, pk_full, 'full')
