"""Metal-contamination correlations.

Counterpart of the reference's vega/metals.py. Structural changes:

- The metal xi caches (reference: metals.py:144-207) are deleted — under
  jit every metal sub-correlation is a handful of fused matmuls, so the
  whole stack (~15 tracer pairs) is recomputed per eval and XLA batches
  the identical-shaped pipelines.
- Metal distortion matrices are dense f64 arrays applied as dense matmuls
  (or skipped entirely when the test flag substitutes the identity).
- The new-metals distortion matrices from stacked-delta weights remain
  host-side numpy at init (irregular histogram work; reference:
  metals.py:502-752).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

import jax

from . import coordinates as coordinates_mod
from . import correlation_func as corr_func
from . import pktoxi, power_spectrum, utils
from .cosmo import ABSORBER_IGM
from .io.fits import read_fits
from .statics import is_identity, register as register_static, resolve


class Metals:
    """Metal correlations for one correlation component
    (reference: metals.py:13-142 for the configuration surface)."""

    growth_rate = None
    fast_metals = False

    def __init__(self, corr_item, fiducial, scale_params, data=None):
        self._corr_item = corr_item
        self.cosmo = corr_item.cosmo
        self._data = data
        self.size = corr_item.model_coordinates.rp_grid.size
        self._coordinates = corr_item.model_coordinates
        self.rp_only_metal_mats = corr_item.config['model'].getboolean(
            'rp_only_metal_mats', False)

        self.zmin = corr_item.config['data'].getfloat('zmin', 0.0)
        self.zmax = corr_item.config['data'].getfloat('zmax', 10.0)

        self.separate_metal_auto_biases = corr_item.config['model'].getboolean(
            'separate-metal-auto-biases', False)
        self.single_metal_beta = corr_item.config['model'].getboolean(
            'single-metal-beta', False)

        self.fast_metals = corr_item.config['model'].getboolean(
            'fast_metals', False)
        self.fast_metal_bias = corr_item.config['model'].getboolean(
            'fast_metal_bias', True)
        if self.fast_metals or self.separate_metal_auto_biases:
            self.fast_metal_bias = True

        if 'growth_rate' in fiducial:
            self.growth_rate = fiducial['growth_rate']

        self.save_components = fiducial.get('save-components', False)
        if self.save_components and (self.fast_metals
                                     or self.separate_metal_auto_biases):
            raise ValueError('Cannot save pk/cf components in fast_metals '
                             'mode. Either turn fast_metals off, or turn off '
                             'write_pk/write_cf.')
        self.pk = {'peak': {}, 'smooth': {}, 'full': {}}
        self.xi = {'peak': {}, 'smooth': {}, 'full': {}}
        self.xi_distorted = {'peak': {}, 'smooth': {}, 'full': {}}

        self.main_tracers = [corr_item.tracer1['name'],
                             corr_item.tracer2['name']]
        self.is_auto_correlation = (self.main_tracers[0]
                                    == self.main_tracers[1])
        self.main_tracer_types = [corr_item.tracer1['type'],
                                  corr_item.tracer2['type']]

        self.new_metals = corr_item.new_metals
        if self.new_metals:
            self.metal_matrix_config = corr_item.config['metal-matrix']
            self.rp_nbins = self._coordinates.rp_nbins
            self.rt_nbins = self._coordinates.rt_nbins

        self.Pk_metal = {}
        self.PktoXi = {}
        self.Xi_metal = {}
        self.rp_metal_dmats = {}
        self._metal_mat_refs = {}
        if corr_item.has_metals:
            for corr_hash in corr_item.metal_correlations:
                name1, name2 = corr_hash
                tracer1 = corr_item.tracer_catalog[name1]
                tracer2 = corr_item.tracer_catalog[name2]

                if self.new_metals:
                    if self.rp_only_metal_mats:
                        dmat, rp, rt, z = self.compute_metal_rp_dmat(
                            name1, name2)
                    else:
                        dmat, rp, rt, z = self.compute_metal_dmat(
                            name1, name2)
                    self.rp_metal_dmats[corr_hash] = register_static(
                        dmat, 'newmetal')
                    metal_coordinates = \
                        coordinates_mod.Coordinates.init_from_grids(
                            self._coordinates, rp, rt, z)
                else:
                    if corr_hash in data.metal_coordinates:
                        metal_coordinates = data.metal_coordinates[corr_hash]
                    else:
                        metal_coordinates = \
                            data.metal_coordinates[corr_hash[::-1]]

                if self._data is not None:
                    corr_item.config['metals']['bin_size_rp'] = \
                        str(corr_item.data_coordinates.rp_binsize)
                    corr_item.config['metals']['bin_size_rt'] = \
                        str(corr_item.data_coordinates.rt_binsize)

                self.Pk_metal[corr_hash] = power_spectrum.PowerSpectrum(
                    corr_item.config['metals'], fiducial, tracer1, tracer2,
                    corr_item.name)
                self.PktoXi[corr_hash] = pktoxi.PktoXi.init_from_Pk(
                    self.Pk_metal[corr_hash], corr_item.config['model'])
                self.Xi_metal[corr_hash] = corr_func.CorrelationFunction(
                    corr_item.config['metals'], fiducial, metal_coordinates,
                    scale_params, tracer1, tracer2, metal_corr=True,
                    cosmo=self.cosmo)

        # Batched execution plan: None means fall back to the unrolled
        # per-pair loop (exotic metal configs)
        self._stacked_plans = None
        if corr_item.has_metals:
            self._stacked_plans = self._plan_stacking(corr_item)

    # ------------------------------------------------------------------
    # Stacked (batched) metal pipeline
    # ------------------------------------------------------------------
    def _plan_stacking(self, corr_item):
        """Group metal pairs into classes whose whole Pk->Xi pipelines are
        identical tensor programs differing only in scalars, so the ~15
        sub-correlations run as ONE batched computation per class.

        Returns None (fall back to the unrolled loop) when per-pair
        structure differs in ways the stacked path does not express.
        """
        metals_config = corr_item.config['metals']
        # Flags the stacked path does not support (rare in metal configs)
        unsupported = ['model-hcd', 'UVB-fluctuations', 'HeII-reionization',
                       'radiation effects', 'relativistic correction',
                       'standard asymmetry', 'UVB-shotnoise',
                       'single_multipole', 'new-bias-evolution',
                       'rescale-coords-systematics', 'pk-damping-scale']
        if any(key in metals_config for key in unsupported):
            return None
        # the metal PktoXi is built from the [model] section; the
        # extrapolated transform is non-linear in P, which the moment
        # factorization cannot express
        if corr_item.config['model'].getboolean('fht_extrap', False):
            return None
        if self.save_components or self.rp_only_metal_mats:
            return None
        if self._scale_params_like_metal_scaling():
            return None
        # Croom evolution needs the per-tracer branch; fall back
        for key in metals_config:
            if key.startswith('z evol') and 'croom' in metals_config[key]:
                return None

        has_arinyo = ('small scale nl' in metals_config
                      and 'arinyo' in metals_config['small scale nl'])

        classes = {}
        for corr_hash in corr_item.metal_correlations:
            name1, name2 = corr_hash
            t1 = corr_item.tracer_catalog[name1]
            t2 = corr_item.tracer_catalog[name2]
            drp_name = None
            if t1['type'] == 'discrete' and t2['type'] != 'discrete':
                drp_name = 'drp_' + name1
            elif t2['type'] == 'discrete' and t1['type'] != 'discrete':
                drp_name = 'drp_' + name2
            # Arinyo exponent per pair (reference: power_spectrum.py:448-477)
            if has_arinyo:
                two_lya = 'LY' in name1 and 'LY' in name2
                one_lya = 'LY' in name1 or 'LY' in name2
                exp = 1.0 if two_lya else (0.5 if one_lya else 0.0)
            else:
                exp = 0.0
            key = (t1['type'], t2['type'], drp_name, exp)
            classes.setdefault(key, []).append(corr_hash)

        plans = []
        for (type1, type2, drp_name, arinyo_exp), hashes in classes.items():
            xi_objs = [self.Xi_metal[h] for h in hashes]
            coords_r = np.stack([np.asarray(x._r) for x in xi_objs])
            coords_mu = np.stack([np.asarray(x._mu) for x in xi_objs])
            growth = np.stack([np.asarray(x.xi_growth) * np.ones_like(x._r)
                               for x in xi_objs])
            rel_z = np.stack([np.asarray(x._rel_z_evol)
                              * np.ones_like(x._r) for x in xi_objs])

            # Symmetry factor (reference: metals.py:237-239)
            sym = np.array([2.0 if (self.is_auto_correlation and h[0] != h[1])
                            else 1.0 for h in hashes])

            # Kaiser moment tables: the pair dependence of the metal Pk is
            # exactly (1 + (b1+b2) mu^2 + b1 b2 mu^4), so only THREE
            # mu-moment Legendre projections of the shared grid are needed
            # per class, independent of the number of pairs.
            pktoxi_rep = self.PktoXi[hashes[0]]
            muk = np.asarray(self.Pk_metal[hashes[0]].muk_grid).ravel()
            moment_proj = np.stack([
                pktoxi_rep.legendre_proj * muk[None, :] ** m
                for m in (0, 2, 4)
            ])  # (3, n_ell, n_muk)

            plan = {
                'hashes': hashes,
                'types': (type1, type2),
                'drp_name': drp_name,
                'r': register_static(coords_r, 'met_r'),
                'mu': register_static(coords_mu, 'met_mu'),
                'growth': register_static(growth, 'met_growth'),
                'rel_z': register_static(rel_z, 'met_relz'),
                'arinyo_exp': arinyo_exp,
                'moment_proj': moment_proj,
                'sym': sym,
                'pk_rep': self.Pk_metal[hashes[0]],
                'pktoxi_rep': pktoxi_rep,
            }
            plans.append(plan)
        return plans

    def _scale_params_like_metal_scaling(self):
        sp = self.Xi_metal[next(iter(self.Xi_metal))]._scale_params \
            if self.Xi_metal else None
        return bool(sp is not None and sp.metal_scaling)

    def _pair_weights_and_betas(self, local_pars):
        """Per-pair (weight, beta1, beta2, alpha1, alpha2) scalars
        matching the unrolled loop's algebra (reference: metals.py:286-334)."""
        out = {}
        for corr_hash in self._corr_item.metal_correlations:
            name1, name2 = corr_hash
            pars = dict(local_pars)
            if self.single_metal_beta:
                if name1 not in self.main_tracers:
                    pars[f'beta_{name1}'] = pars['beta_metals']
                if name2 not in self.main_tracers:
                    pars[f'beta_{name2}'] = pars['beta_metals']
            bias1, beta1, bias2, beta2 = utils.bias_beta(pars, name1, name2)
            is_cross_main = (name1 in self.main_tracers
                             or name2 in self.main_tracers)
            weight = bias1 * bias2
            if (self.separate_metal_auto_biases and not is_cross_main
                    and name1 != name2):
                if f'bias_{name1}_{name2}' in pars:
                    weight = weight * pars[f'bias_{name1}_{name2}']
                elif f'bias_{name2}_{name1}' in pars:
                    weight = weight * pars[f'bias_{name2}_{name1}']
                else:
                    raise ValueError(
                        f'No separate auto bias for {corr_hash}.')
            alpha1 = pars[f'alpha_{name1}']
            alpha2 = pars[f'alpha_{name2}']
            out[corr_hash] = (weight, beta1, beta2, alpha1, alpha2)
        return out

    def compute_stacked(self, pars, pk_lin, component):
        """Batched metal computation: one tensor program per class
        (algebraically identical to the unrolled `compute`)."""
        local_pars = dict(pars)
        if self.fast_metals:
            if 'growth_rate' in local_pars and self.growth_rate is not None:
                local_pars['growth_rate'] = self.growth_rate

        import os
        from .factored import FactoredXi, RecordingParams, has_tracer

        pair_scalars = self._pair_weights_and_betas(local_pars)
        xi_metals = jnp.zeros(self.size)
        bad = jnp.asarray(False)

        # Factored accumulation (see vega_tpu/factored.py): active only
        # inside a trace, like the FactoredPk fast path
        factored = None
        if (os.environ.get('VEGA_TPU_FACTORED', '1') == '1'
                and has_tracer(*local_pars.values())):
            factored = {'coeffs': [], 'rows': []}

        for plan in self._stacked_plans:
            hashes = plan['hashes']
            weights = jnp.stack(
                [pair_scalars[h][0] * plan['sym'][i]
                 for i, h in enumerate(hashes)])
            beta1 = jnp.stack([pair_scalars[h][1] for h in hashes])
            beta2 = jnp.stack([pair_scalars[h][2] for h in hashes])
            alpha1 = jnp.stack([pair_scalars[h][3] for h in hashes])
            alpha2 = jnp.stack([pair_scalars[h][4] for h in hashes])

            # Shared (mu_k, k) grid: pk_lin times every factor that is
            # identical across the class (arinyo via the class exponent).
            # The recording view classifies the grid static when none of
            # the parameters these factors read is sampled — the factored
            # fast path below then applies (see vega_tpu/factored.py).
            rec_shared = RecordingParams(local_pars)
            pk_obj = plan['pk_rep']
            shared, shared_bad = self._class_shared_factors(
                pk_obj, rec_shared)
            bad = bad | shared_bad
            grid = jnp.broadcast_to(
                jnp.asarray(pk_lin),
                (pk_obj.muk_grid.shape[0], len(pk_obj.k_grid)))
            if shared is not None:
                grid = grid * shared
            if pk_obj.small_scale_nl is not None \
                    and 'arinyo' in pk_obj.small_scale_nl \
                    and plan['arinyo_exp'] != 0.0:
                dnl, dnl_bad = pk_obj.compute_dnl_arinyo(rec_shared)
                bad = bad | dnl_bad
                if plan['arinyo_exp'] == 1.0:
                    grid = grid * dnl
                else:
                    grid = grid * jnp.sqrt(dnl)

            # Kaiser moment factorization: project the shared grid with
            # the three mu^(0,2,4)-weighted Legendre tables ONCE, then each
            # pair is a 3-term FMA with s = b1+b2, q = b1*b2. The (p, mu_k,
            # k) tensor of the naive batching never materializes.
            pktoxi_obj = plan['pktoxi_rep']
            proj_m = jnp.einsum('mln,nk->mlk',
                                jnp.asarray(plan['moment_proj']), grid)
            fft_ops = jnp.asarray(resolve(pktoxi_obj.fft_ops))
            sd_ops = jnp.asarray(resolve(pktoxi_obj.fft_sd_ops))
            t_m = jnp.einsum('lij,mlj->mli', fft_ops, proj_m)   # (3, l, n)
            d_m = jnp.einsum('lij,mlj->mli', sd_ops, proj_m)

            s_p = beta1 + beta2
            q_p = beta1 * beta2

            # Rescaled coordinates (ap = at = 1 for metals without
            # metal-scaling; reference: scale_parameters.py:56-57)
            r_grid = jnp.asarray(resolve(plan['r']))        # (p, n)
            mu_grid = jnp.asarray(resolve(plan['mu']))
            drp = (local_pars.get(plan['drp_name'], 0.)
                   if plan['drp_name'] is not None else 0.)
            mask = r_grid != 0
            rp = r_grid * mu_grid + drp * mask
            rt = r_grid * jnp.sqrt(1 - mu_grid ** 2)
            # sqrt argument guarded at r = 0 bins (sqrt'(0) = inf makes
            # the backward pass NaN even under an output where-mask)
            sq = rp ** 2 + rt ** 2
            pos = mask & (sq > 0)
            resc_r = jnp.sqrt(jnp.where(pos, sq, 1.0))
            resc_mu = jnp.where(pos, rp, 0.) / jnp.where(pos, resc_r, 1.0)
            log_r = jnp.log(jnp.where(pos, resc_r, 1.0))

            from .ops.spline import spline_eval
            from .pktoxi import legendre

            alphas = [pair_scalars[h][3] for h in hashes] \
                + [pair_scalars[h][4] for h in hashes]
            from .factored import keyed_tracer
            drp_key = plan['drp_name'] if plan['drp_name'] is not None else ''
            factorable = (factored is not None
                          and not rec_shared.traced()
                          and not keyed_tracer(drp_key, drp)
                          and not has_tracer(*alphas))

            if factorable:
                # Keep the (3, p) moment x pair structure unbatched:
                # spline + Legendre + z-evolution + metal matrices act on
                # parameter-independent moment vectors; the per-eval work
                # is the coefficient scalars only.
                vals, oob = spline_eval(
                    pktoxi_obj.logr_knots, t_m[:, :, None, :],
                    d_m[:, :, None, :], log_r[None, :, :])   # (3,l,p,n)
                bad = bad | jnp.any(
                    jnp.reshape(oob, log_r.shape) & mask)
                leg = jnp.stack([legendre(ell, resc_mu)
                                 for ell in pktoxi_obj.ell_vals])  # (l,p,n)
                s_mpn = jnp.einsum('mlpn,lpn->mpn', vals, leg)
                s_mpn = jnp.where(mask[None, :, :], s_mpn, 0.)
                rel_z = jnp.asarray(resolve(plan['rel_z']))
                growth = jnp.asarray(resolve(plan['growth']))
                evol = rel_z ** jnp.asarray(alphas[:len(hashes)])[:, None] \
                    * rel_z ** jnp.asarray(alphas[len(hashes):])[:, None]
                s_mpn = s_mpn * (evol * growth)[None, :, :]

                coeff_mp = [jnp.ones_like(s_p), s_p, q_p]   # (3 of (p,))
                for i, h in enumerate(hashes):
                    rows = jnp.stack([
                        self.apply_metal_matrix(s_mpn[m, i], h)
                        for m in range(3)])                  # (3, n)
                    for m in range(3):
                        factored['coeffs'].append(
                            weights[i] * coeff_mp[m][i])
                    factored['rows'].append(rows)
                continue

            # This plan cannot factor: fold any factored contributions
            # back into the dense accumulator and stay dense
            if factored is not None and factored['rows']:
                xi_metals = xi_metals + FactoredXi(
                    factored['coeffs'],
                    jnp.concatenate(factored['rows'])).dense()
            factored = None
            coeffs = jnp.stack([jnp.ones_like(s_p), s_p, q_p])  # (3, p)
            xi_knots = jnp.einsum('mp,mli->pli', coeffs, t_m)
            m_knots = jnp.einsum('mp,mli->pli', coeffs, d_m)

            vals, oob = spline_eval(
                pktoxi_obj.logr_knots, xi_knots, m_knots,
                log_r[:, None, :])                           # (p, l, n)
            bad = bad | jnp.any(oob[:, 0, :] & mask)

            leg = jnp.stack([legendre(ell, resc_mu)
                             for ell in pktoxi_obj.ell_vals])  # (l, p, n)
            xi_stack = jnp.einsum('pln,lpn->pn', vals, leg)
            xi_stack = jnp.where(mask, xi_stack, 0.)

            # Bias z-evolution and growth (std model; reference:
            # correlation_func.py:332-349)
            rel_z = jnp.asarray(resolve(plan['rel_z']))
            xi_stack = xi_stack * rel_z ** alpha1[:, None] \
                * rel_z ** alpha2[:, None]
            xi_stack = xi_stack * jnp.asarray(resolve(plan['growth']))

            # Metal matrices + weighted accumulation
            contributions = []
            for i, h in enumerate(hashes):
                xi_i = self.apply_metal_matrix(xi_stack[i], h)
                contributions.append(weights[i] * xi_i)
            xi_metals = xi_metals + sum(contributions)

        if factored is not None and factored['rows']:
            return FactoredXi(factored['coeffs'],
                              jnp.concatenate(factored['rows'])), bad
        return xi_metals, bad

    def _class_shared_factors(self, pk_obj, local_pars):
        """Multiplicative (nmuk, nk) factors shared by every pair of a
        class: binning window, mock smoothing, full-shape smoothing,
        velocity dispersion (reference: power_spectrum.py:137-196)."""
        factor = None
        bad = jnp.asarray(False)

        def mul(fac, new):
            return new if fac is None else fac * new

        if pk_obj.use_Gk:
            factor = mul(factor, resolve(pk_obj._pk_gk_ref))
        if pk_obj.mock_bin_size is not None:
            factor = mul(factor, pk_obj._compute_mock_binsize_gk(local_pars))
        if pk_obj.fullshape_smoothing is not None:
            if 'gauss' in pk_obj.fullshape_smoothing:
                factor = mul(factor,
                             pk_obj.compute_fullshape_gauss_smoothing(
                                 local_pars))
            elif 'exp' in pk_obj.fullshape_smoothing:
                factor = mul(factor,
                             pk_obj.compute_fullshape_exp_smoothing(
                                 local_pars))
        if pk_obj.velocity_dispersion is not None:
            if 'lorentz_gauss' in pk_obj.velocity_dispersion:
                factor = mul(factor,
                             pk_obj.compute_velocity_dispersion_lorentz(
                                 local_pars))
                factor = mul(factor,
                             pk_obj.compute_velocity_dispersion_gauss(
                                 local_pars))
            elif 'gauss' in pk_obj.velocity_dispersion:
                factor = mul(factor,
                             pk_obj.compute_velocity_dispersion_gauss(
                                 local_pars))
            elif 'lorentz' in pk_obj.velocity_dispersion:
                factor = mul(factor,
                             pk_obj.compute_velocity_dispersion_lorentz(
                                 local_pars))
        if pk_obj.small_scale_nl is not None \
                and 'mcdonald' in pk_obj.small_scale_nl:
            factor = mul(factor, pk_obj.compute_dnl_mcdonald())
        return factor, bad

    # ------------------------------------------------------------------
    def compute_metal_corr(self, pars, pk_lin, corr_hash, fast_metals,
                           add_metal_dmat=True, component=None):
        """One metal sub-correlation (reference: metals.py:209-256).
        Returns (xi, bad_flag)."""
        pk, bad_pk = self.Pk_metal[corr_hash].compute(
            pk_lin, pars, fast_metals=fast_metals)
        xi, bad_xi = self.Xi_metal[corr_hash].compute(
            pk, pk_lin, self.PktoXi[corr_hash], pars)
        bad = bad_pk | bad_xi

        # Cross-metal symmetry in autos (reference: metals.py:237-239)
        if self.is_auto_correlation and corr_hash[0] != corr_hash[1]:
            xi = xi * 2

        if self.save_components and not isinstance(pk, jax.core.Tracer):
            assert not fast_metals, 'You need to set fast_metal_bias=False.'
            assert component is not None, 'Provide a component name.'
            self.pk[component][corr_hash] = np.asarray(pk)
            self.xi[component][corr_hash] = np.asarray(xi)

        if not add_metal_dmat:
            return xi, bad

        dmat_xi = self.apply_metal_matrix(xi, corr_hash)
        if self.save_components and not isinstance(dmat_xi, jax.core.Tracer):
            self.xi_distorted[component][corr_hash] = np.asarray(dmat_xi)
        return dmat_xi, bad

    # -- reference-named drop-in surface --------------------------------
    # The reference splits the per-pair computation into three cached
    # entry points (metals.py:144-256); here caching is unnecessary
    # (recompute is free under jit), so these are views over
    # compute_metal_corr that drop the bad-flag.
    def compute_metal_corr_slow(self, pars, pk_lin, corr_hash, fast_metals,
                                add_metal_dmat=True, component=None):
        xi, _ = self.compute_metal_corr(pars, pk_lin, corr_hash, fast_metals,
                                        add_metal_dmat, component)
        return xi

    def compute_xi_metal_metal(self, pk_lin, pars, corr_hash):
        return self.compute_metal_corr_slow(pars, pk_lin, corr_hash,
                                            fast_metals=True)

    def compute_xi_metal_cross_main(self, pk_lin, pars, corr_hash,
                                    beta1, beta2):
        del beta1, beta2  # reference cache-key arguments; no cache here
        xi, _ = self.compute_metal_corr(pars, pk_lin, corr_hash,
                                        fast_metals=True,
                                        add_metal_dmat=False)
        return self.apply_metal_matrix(xi, corr_hash)

    def compute(self, pars, pk_lin, component):
        """Sum of all metal correlations (reference: metals.py:258-336).
        Returns (xi_metals, bad_flag). All caching is gone: the bias
        product factorization of the reference's fast-metals mode is
        algebraically identical to recomputing, and recompute is free
        under jit."""
        assert self._corr_item.has_metals

        if self._stacked_plans is not None:
            return self.compute_stacked(pars, pk_lin, component)

        local_pars = dict(pars)

        if self.fast_metals:
            if 'growth_rate' in local_pars and self.growth_rate is not None:
                local_pars['growth_rate'] = self.growth_rate

        xi_metals = jnp.zeros(self.size)
        bad = jnp.asarray(False)
        for corr_hash in self._corr_item.metal_correlations:
            name1, name2 = corr_hash

            if self.single_metal_beta:
                if name1 not in self.main_tracers:
                    local_pars[f'beta_{name1}'] = local_pars['beta_metals']
                if name2 not in self.main_tracers:
                    local_pars[f'beta_{name2}'] = local_pars['beta_metals']

            bias1, beta1, bias2, beta2 = utils.bias_beta(
                local_pars, name1, name2)
            del beta1, beta2

            is_cross_with_main = (name1 in self.main_tracers
                                  or name2 in self.main_tracers)

            if is_cross_with_main:
                bias_product = bias1 * bias2
            elif self.separate_metal_auto_biases and name1 != name2:
                if f'bias_{name1}_{name2}' in local_pars:
                    factor = local_pars[f'bias_{name1}_{name2}']
                elif f'bias_{name2}_{name1}' in local_pars:
                    factor = local_pars[f'bias_{name2}_{name1}']
                else:
                    raise ValueError(
                        'Separate metal auto biases is on, but no '
                        f'bias_{name1}_{name2} or bias_{name2}_{name1} '
                        f'parameter found for {corr_hash}.')
                bias_product = bias1 * bias2 * factor
            else:
                bias_product = bias1 * bias2

            use_fast_bias = (self.fast_metals or self.fast_metal_bias)
            xi, xi_bad = self.compute_metal_corr(
                local_pars, pk_lin, corr_hash, fast_metals=use_fast_bias,
                component=component)
            bad = bad | xi_bad
            if use_fast_bias:
                xi_metals = xi_metals + bias_product * xi
            else:
                xi_metals = xi_metals + xi

        return xi_metals, bad

    def apply_metal_matrix(self, xi, corr_hash):
        """(reference: metals.py:338-367); identity matrices (test mode)
        are skipped entirely."""
        if self.new_metals:
            if self.rp_only_metal_mats:
                dmat = jnp.asarray(resolve(self.rp_metal_dmats[corr_hash]))
                return (dmat @ xi.reshape(self.rp_nbins,
                                          self.rt_nbins)).flatten()
            return jnp.asarray(resolve(self.rp_metal_dmats[corr_hash])) @ xi

        if corr_hash not in self._metal_mat_refs:
            alt_hash = corr_hash if corr_hash in self._data.metal_mats \
                else corr_hash[::-1]
            dmat = self._data.metal_mats[alt_hash]
            if dmat is not None and is_identity(dmat):
                dmat = None
            if dmat is not None:
                dmat = register_static(np.asarray(dmat, dtype=np.float64),
                                       'metalmat')
            self._metal_mat_refs[corr_hash] = dmat

        dmat = self._metal_mat_refs[corr_hash]
        if dmat is None:  # identity substitute in test mode
            return xi
        return jnp.asarray(resolve(dmat)) @ xi

    # ------------------------------------------------------------------
    # New-metals distortion matrices (host-side init work;
    # reference: metals.py:369-752)
    # ------------------------------------------------------------------
    @staticmethod
    def rebin(vector, rebin_factor):
        size = vector.size
        return vector[:(size // rebin_factor) * rebin_factor].reshape(
            (size // rebin_factor), rebin_factor).mean(-1)

    def get_forest_weights(self, main_tracer):
        """(reference: metals.py:389-416)"""
        assert main_tracer['type'] == 'continuous'
        hdul = read_fits(utils.find_file(main_tracer['weights-path']))
        wave = 10 ** hdul[1]['LOGLAM']
        weights = hdul[1]['WEIGHT']
        rebin_factor = self.metal_matrix_config.getint('rebin_factor', None)
        if rebin_factor is not None:
            wave = self.rebin(wave, rebin_factor)
            weights = self.rebin(weights, rebin_factor)
        return wave, weights

    def get_qso_weights(self, tracer):
        """(reference: metals.py:418-449)"""
        assert tracer['type'] == 'discrete'
        hdul = read_fits(utils.find_file(tracer['weights-path']))
        z_qso_cat = hdul[1]['Z']
        z_ref = self.metal_matrix_config.getfloat('z_ref_objects', 2.25)
        z_evol = self.metal_matrix_config.getfloat('z_evol_objects', 1.44)
        qso_z_bins = self.metal_matrix_config.getint('z_bins_objects', 1000)
        weights_cat = ((1. + z_qso_cat) / (1. + z_ref)) ** (z_evol - 1.)

        histo_w, zbins = np.histogram(z_qso_cat, bins=qso_z_bins,
                                      weights=weights_cat)
        histo_wz, _ = np.histogram(z_qso_cat, bins=zbins,
                                   weights=weights_cat * z_qso_cat)
        selection = histo_w > 0
        z_qso = histo_wz[selection] / histo_w[selection]
        return z_qso, histo_w[selection]

    def get_rp_pairs(self, z1, z2):
        """(reference: metals.py:451-478)"""
        if np.any(z1 < 0) or np.any(z2 < 0):
            raise ValueError(
                'Attempting to compute distance to a negative redshift')
        r1 = self.cosmo.get_r_comov(z1)
        r2 = self.cosmo.get_r_comov(z2)
        rp_pairs = (r1[:, None] - r2[None, :]).ravel()
        if 'discrete' not in self.main_tracer_types:
            rp_pairs = np.abs(rp_pairs)
        mean_distance = ((r1[:, None] + r2[None, :]) / 2).ravel()
        return rp_pairs, mean_distance

    def get_forest_weight_scaling(self, z, true_abs, assumed_abs):
        """(reference: metals.py:480-500)"""
        true_alpha = self.metal_matrix_config.getfloat(f'alpha_{true_abs}')
        assumed_alpha = self.metal_matrix_config.getfloat(
            f'alpha_{assumed_abs}', 2.9)
        return (1 + z) ** (true_alpha + assumed_alpha - 2)

    def _tracer_weights(self, tracer, main_idx, true_abs):
        if self.main_tracer_types[main_idx] == 'continuous':
            wave, weights = self.get_forest_weights(tracer)
            true_z = wave / ABSORBER_IGM[true_abs] - 1.
            assumed_z = wave / ABSORBER_IGM[self.main_tracers[main_idx]] - 1.
            scaling = self.get_forest_weight_scaling(
                true_z, true_abs, self.main_tracers[main_idx])
        else:
            true_z, weights = self.get_qso_weights(tracer)
            assumed_z = true_z
            scaling = 1.
        return true_z, assumed_z, weights, scaling

    def _pair_histogram_native(self, true_abs_1, true_abs_2, rp_edges,
                               n_ratio_bins):
        """Streamed O(n1*n2) pair histograms via the C++ kernel
        (vega_tpu/native/pair_hist.cpp); returns None when unavailable."""
        from .native import (native_available, pair_histograms,
                             pair_ratio_range)
        if not native_available():
            return None

        true_z1, assumed_z1, weights1, scaling_1 = self._tracer_weights(
            self._corr_item.tracer1, 0, true_abs_1)
        true_z2, assumed_z2, weights2, scaling_2 = self._tracer_weights(
            self._corr_item.tracer2, 1, true_abs_2)
        if np.any(true_z1 < 0) or np.any(true_z2 < 0):
            raise ValueError(
                'Attempting to compute distance to a negative redshift')

        true_r1 = self.cosmo.get_r_comov(true_z1)
        true_r2 = self.cosmo.get_r_comov(true_z2)
        assumed_r1 = self.cosmo.get_r_comov(assumed_z1)
        assumed_r2 = self.cosmo.get_r_comov(assumed_z2)
        abs_rp = int('discrete' not in self.main_tracer_types)

        ratio_edges = None
        if n_ratio_bins:
            lo, hi = pair_ratio_range(true_r1, assumed_r1, true_r2,
                                      assumed_r2)
            if lo == hi:  # np.histogram degenerate-range convention
                lo, hi = lo - 0.5, hi + 0.5
            ratio_edges = np.linspace(lo, hi, n_ratio_bins + 1)

        out = pair_histograms(
            true_r1, assumed_r1, true_z1 * np.ones_like(true_r1),
            assumed_z1 * np.ones_like(assumed_r1),
            weights1 * scaling_1 * np.ones_like(true_r1),
            true_r2, assumed_r2, true_z2 * np.ones_like(true_r2),
            assumed_z2 * np.ones_like(assumed_r2),
            weights2 * scaling_2 * np.ones_like(true_r2),
            abs_rp, self.zmin, self.zmax, rp_edges, ratio_edges)
        h2, sum_true, sum_assumed, sum_assumed_rp, sum_z, ratio_hist = out
        ratios = ((ratio_edges[1:] + ratio_edges[:-1]) / 2
                  if ratio_edges is not None else None)
        return (h2, sum_true, sum_assumed, sum_assumed_rp, sum_z,
                ratio_hist, ratios)

    def compute_metal_dmat(self, true_abs_1, true_abs_2):
        """Full 2D (rp (x) rt) metal distortion matrix from stacked-delta
        weights (reference: metals.py:502-654). Uses the streamed C++
        pair-histogram kernel when available; the numpy path materializes
        the full pair arrays like the reference."""
        rp_edges = np.linspace(self._coordinates.rp_min,
                               self._coordinates.rp_max, self.rp_nbins + 1)
        rt_edges = np.linspace(0, self._coordinates.rt_max,
                               self.rt_nbins + 1)

        native = self._pair_histogram_native(
            true_abs_1, true_abs_2, rp_edges, 4 * rt_edges.size)
        if native is not None:
            (rp_1d_dmat, _, sum_w, sum_w_rp, sum_w_z, ratio_weights,
             ratios) = native
            col_sum = np.sum(rp_1d_dmat, axis=0)
            rp_1d_dmat = rp_1d_dmat / (col_sum + (col_sum == 0))
            return self._assemble_metal_dmat(
                rp_1d_dmat, sum_w, sum_w_rp, sum_w_z, ratio_weights,
                ratios, rt_edges)

        true_z1, assumed_z1, weights1, scaling_1 = self._tracer_weights(
            self._corr_item.tracer1, 0, true_abs_1)
        true_z2, assumed_z2, weights2, scaling_2 = self._tracer_weights(
            self._corr_item.tracer2, 1, true_abs_2)

        true_rp_pairs, true_mean_dist = self.get_rp_pairs(true_z1, true_z2)
        assumed_rp_pairs, assumed_mean_dist = self.get_rp_pairs(
            assumed_z1, assumed_z2)

        weights = ((weights1 * scaling_1)[:, None]
                   * (weights2 * scaling_2)[None, :]).ravel()
        zpair = (assumed_z1[:, None] + assumed_z2[None, :]) / 2.
        weights = weights * ((zpair >= self.zmin)
                             & (zpair <= self.zmax)).ravel()

        rp_1d_dmat, _, _ = np.histogram2d(
            assumed_rp_pairs, true_rp_pairs, bins=(rp_edges, rp_edges),
            weights=weights)
        col_sum = np.sum(rp_1d_dmat, axis=0)
        rp_1d_dmat /= (col_sum + (col_sum == 0))

        # Distance-ratio histogram with solid-angle weighting, restricted
        # to small true rp (reference: metals.py:585-588)
        ratio_weights, ratio_bins = np.histogram(
            assumed_mean_dist / true_mean_dist, bins=4 * rt_edges.size,
            weights=weights / true_mean_dist ** 2
            * (np.abs(true_rp_pairs) < 20.))
        ratios = (ratio_bins[1:] + ratio_bins[:-1]) / 2

        # Effective coordinates (reference: metals.py:624-654)
        sum_w, _ = np.histogram(assumed_rp_pairs, bins=rp_edges,
                                weights=weights)
        sum_w_rp, _ = np.histogram(assumed_rp_pairs, bins=rp_edges,
                                   weights=weights * assumed_rp_pairs)
        sum_w_z, _ = np.histogram(
            assumed_rp_pairs, bins=rp_edges,
            weights=weights
            * ((true_z1[:, None] + true_z2[None, :]) / 2.).ravel())
        return self._assemble_metal_dmat(
            rp_1d_dmat, sum_w, sum_w_rp, sum_w_z, ratio_weights, ratios,
            rt_edges)

    def _assemble_metal_dmat(self, rp_1d_dmat, sum_w, sum_w_rp, sum_w_z,
                             ratio_weights, ratios, rt_edges):
        """rt distortion from the ratio histogram + (rp (x) rt) assembly
        and effective coordinates (reference: metals.py:592-654)."""
        rt_centers = (rt_edges[:-1] + rt_edges[1:]) / 2
        rt_half = self._coordinates.rt_binsize / 2
        oversample = 7
        delta_rt = np.linspace(-rt_half, rt_half * (1 - 2 / oversample),
                               oversample)[None, :]
        rt_1d_dmat = np.zeros((self.rt_nbins, self.rt_nbins))
        for i, rt in enumerate(rt_centers):
            rt_1d_dmat[:, i], _ = np.histogram(
                (ratios[:, None] * (rt + delta_rt)[None, :]).ravel(),
                bins=rt_edges,
                weights=(ratio_weights[:, None]
                         * (rt + delta_rt)[None, :]).ravel())
        col_sum = np.sum(rt_1d_dmat, axis=0)
        rt_1d_dmat /= (col_sum + (col_sum == 0))

        n_total = self.rp_nbins * self.rt_nbins
        dmat = np.einsum('ij,kl->ikjl', rp_1d_dmat, rt_1d_dmat).reshape(
            n_total, n_total)

        rp_eff_1d = sum_w_rp / (sum_w + (sum_w == 0))
        z_eff_1d = sum_w_z / (sum_w + (sum_w == 0))

        r1 = np.arange(self.rt_nbins) * self._coordinates.rt_max / self.rt_nbins
        r2 = (1 + np.arange(self.rt_nbins)) * \
            self._coordinates.rt_max / self.rt_nbins
        rt_eff_1d = (2 * (r2 ** 3 - r1 ** 3)) / (3 * (r2 ** 2 - r1 ** 2))

        full_index = np.arange(n_total)
        rt_index = full_index % self.rt_nbins
        rp_index = full_index // self.rt_nbins
        return (dmat, rp_eff_1d[rp_index], rt_eff_1d[rt_index],
                z_eff_1d[rp_index])

    def compute_metal_rp_dmat(self, true_abs_1, true_abs_2):
        """rp-only metal distortion matrix (reference: metals.py:656-752).
        Uses the streamed C++ pair-histogram kernel when available."""
        rp_edges = np.linspace(self._coordinates.rp_min,
                               self._coordinates.rp_max, self.rp_nbins + 1)

        native = self._pair_histogram_native(true_abs_1, true_abs_2,
                                             rp_edges, 0)
        if native is not None:
            dmat, sum_true, sum_w, sum_w_rp, sum_w_z, _, _ = native
            dmat = dmat * ((sum_true > 0)
                           / (sum_true + (sum_true == 0)))[None, :]
            return self._assemble_metal_rp_dmat(dmat, sum_w, sum_w_rp,
                                                sum_w_z)

        true_z1, assumed_z1, weights1, scaling_1 = self._tracer_weights(
            self._corr_item.tracer1, 0, true_abs_1)
        true_z2, assumed_z2, weights2, scaling_2 = self._tracer_weights(
            self._corr_item.tracer2, 1, true_abs_2)

        true_rp_pairs, _ = self.get_rp_pairs(true_z1, true_z2)
        assumed_rp_pairs, _ = self.get_rp_pairs(assumed_z1, assumed_z2)

        weights = ((weights1 * scaling_1)[:, None]
                   * (weights2 * scaling_2)[None, :]).ravel()
        zpair = (assumed_z1[:, None] + assumed_z2[None, :]) / 2.
        weights = weights * ((zpair >= self.zmin)
                             & (zpair <= self.zmax)).ravel()

        dmat, _, _ = np.histogram2d(
            assumed_rp_pairs, true_rp_pairs, bins=(rp_edges, rp_edges),
            weights=weights)
        sum_true, _ = np.histogram(true_rp_pairs, bins=rp_edges,
                                   weights=weights)
        dmat *= ((sum_true > 0) / (sum_true + (sum_true == 0)))[None, :]

        sum_w, _ = np.histogram(assumed_rp_pairs, bins=rp_edges,
                                weights=weights)
        sum_w_rp, _ = np.histogram(assumed_rp_pairs, bins=rp_edges,
                                   weights=weights * assumed_rp_pairs)
        sum_w_z, _ = np.histogram(
            assumed_rp_pairs, bins=rp_edges,
            weights=weights
            * ((true_z1[:, None] + true_z2[None, :]) / 2.).ravel())
        return self._assemble_metal_rp_dmat(dmat, sum_w, sum_w_rp, sum_w_z)

    def _assemble_metal_rp_dmat(self, dmat, sum_w, sum_w_rp, sum_w_z):
        """Effective-coordinate assembly for the rp-only matrix
        (reference: metals.py:731-752)."""
        rp_eff = sum_w_rp / (sum_w + (sum_w == 0))
        z_eff = sum_w_z / (sum_w + (sum_w == 0))

        n_total = self.rp_nbins * self.rt_nbins
        full_rp_eff = np.zeros(n_total)
        full_rt_eff = np.zeros(n_total)
        full_z_eff = np.zeros(n_total)
        rp_indices = np.arange(self.rp_nbins)
        rt_bins = np.arange(self._coordinates.rt_binsize / 2,
                            self._coordinates.rt_max,
                            self._coordinates.rt_binsize)
        for j in range(self.rt_nbins):
            indices = j + self.rt_nbins * rp_indices
            full_rp_eff[indices] = rp_eff
            full_rt_eff[indices] = rt_bins[j]
            full_z_eff[indices] = z_eff
        return dmat, full_rp_eff, full_rt_eff, full_z_eff
