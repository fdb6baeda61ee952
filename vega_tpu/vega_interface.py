"""Main interface: config parsing, per-correlation model construction, and
the compiled chi^2 / log-likelihood.

Counterpart of the reference's vega/vega_interface.py with one central
architectural change: the whole model + chi^2 pipeline for all
correlations compiles into a single jitted function of the sampled
parameters. Model-domain failures (interpolation out of bounds, Arinyo
NaN) surface as a flag inside the graph and yield chi^2 = 1e100
branchlessly, preserving the reference's exception semantics
(vega_interface.py:268-279) without host round-trips.

Batched evaluation (`chi2_batch`, `log_lik_batch`) vmaps the same graph
over parameter batches — this replaces the reference's MPI fan-out of
sampler live points and Monte-Carlo fits (bin/run_vega_mpi.py).
"""

from __future__ import annotations

import configparser
import copy
import os.path

import numpy as np
import scipy.stats
import jax
import jax.numpy as jnp

from . import utils
from .statics import STATICS, register as register_static, resolve
from .analysis import Analysis
from .correlation_item import CorrelationItem
from .data import Data
from .io.fits import read_fits
from .minimizer import Minimizer
from .model import Model
from .output import Output
from .parameters.param_utils import get_default_values
from .scale_parameters import ScaleParameters

PENALTY_CHI2 = 1e100


def parse_ini(path):
    """Case-preserving INI parser (reference: vega_interface.py:51-53)."""
    config = configparser.ConfigParser()
    config.optionxform = lambda option: option
    config.read(utils.find_file(os.path.expandvars(str(path))))
    return config


class VegaInterface:
    """Main interface (reference: vega_interface.py:22-206)."""

    _blind = None
    _use_global_cov = False
    global_cov = None

    def __init__(self, main_path):
        self.main_config = parse_ini(main_path)

        self.fiducial = self._read_fiducial(self.main_config['fiducial'])
        self.fiducial['z_eff'] = self.main_config['data sets'].getfloat('zeff')
        write_cf = self.main_config['output'].getboolean('write_cf', False)
        write_pk = self.main_config['output'].getboolean('write_pk', False)
        self.fiducial['save-components'] = write_cf or write_pk
        ini_files = self.main_config['data sets'].get('ini files').split()
        global_cov_file = self.main_config['data sets'].get(
            'global-cov-file', None)

        control = (self.main_config['control']
                   if 'control' in self.main_config else {})
        self.model_pk = self.main_config['control'].getboolean(
            'model_pk', False) if 'control' in self.main_config else False
        self.low_mem_mode = (self.main_config['control'].getboolean(
            'low_mem_mode', False) if 'control' in self.main_config else False)
        self.low_mem_mode &= global_cov_file is not None
        self.marginalize_in_fit = (self.main_config['control'].getboolean(
            'marginalize-in-fit', False)
            if 'control' in self.main_config else False)
        del control

        # Correlation items
        self.corr_items = {}
        for path in ini_files:
            config = parse_ini(path)
            name = config['data'].get('name')
            self.corr_items[name] = CorrelationItem(config, self.model_pk)
            self.corr_items[name].low_mem_mode = self.low_mem_mode

        # Parameters
        self.params = self._read_parameters(self.corr_items,
                                            self.main_config['parameters'])
        self.sample_params = self._read_sample(self.main_config['sample'])
        # Snapshot of the config-derived sampling limits: the grid
        # payload depends on them through measure_dc_max, but the
        # payload fingerprint hashes the CONFIG, so a programmatic
        # post-init mutation (vega.sample_params['limits'][...] = ...)
        # must be detected and folded into the fingerprint explicitly
        # (_get_grid_collapsed) or a stale cached payload could serve.
        self._config_limits = {
            k: tuple(v) if isinstance(v, (tuple, list)) else v
            for k, v in self.sample_params['limits'].items()}

        # Growth rate handling (reference: vega_interface.py:90-107)
        use_template_growth = True
        if 'control' in self.main_config:
            use_template_growth = self.main_config['control'].getboolean(
                'use_template_growth_rate', True)
        if use_template_growth and 'growth_rate' in self.fiducial:
            assert 'growth_rate' not in self.sample_params['limits'], (
                'use_template_growth_rate is True, but growth_rate is '
                'sampled. Remove it from [sample] or set '
                'use_template_growth_rate = False.')
            self.params['growth_rate'] = self.fiducial['growth_rate']
        elif 'growth_rate' not in self.fiducial:
            if 'growth_rate' in self.params:
                self.fiducial['growth_rate'] = self.params['growth_rate']

        if 'par_sigma_smooth' in self.params:
            self.fiducial['par_sigma_smooth'] = self.params['par_sigma_smooth']
        if 'per_sigma_smooth' in self.params:
            self.fiducial['per_sigma_smooth'] = self.params['per_sigma_smooth']

        # Data
        self.data = {}
        self._has_data = all(item.has_data
                             for item in self.corr_items.values())
        for name, corr_item in self.corr_items.items():
            self.data[name] = (Data(corr_item,
                                    marginalize_in_fit=self.marginalize_in_fit)
                               if self._has_data else None)

        self._blind = False
        self._rnsps = None
        if self._has_data:
            self._init_blinding()

        self.scale_params = ScaleParameters(self.main_config['cosmo-fit type'])

        # Models
        self.models = {}
        if self._has_data:
            for name, corr_item in self.corr_items.items():
                self.models[name] = Model(corr_item, self.fiducial,
                                          self.scale_params, self.data[name])

        # Monte Carlo config
        self.mc_config = None
        if 'monte carlo' in self.main_config:
            self.mc_config = {'params': {}}
            for param, value in self.main_config['mc parameters'].items():
                self.mc_config['params'][param] = float(value)
            self.mc_config['sample'] = self._read_sample(
                self.main_config['monte carlo'])

        # Priors
        self.priors = {}
        if 'priors' in self.main_config:
            self.priors = self._init_priors(self.main_config['priors'])
            for param in self.priors:
                not_sampled = param not in self.sample_params['limits']
                if self.mc_config is not None:
                    not_sampled &= param not in self.mc_config['sample']['limits']
                if not_sampled:
                    raise ValueError('Prior specified for a parameter that '
                                     f'is not sampled: {param}')

        # Global covariance
        cov_scale = None
        if 'control' in self.main_config:
            cov_scale = self.main_config['control'].getfloat('cov_scale', None)
        if global_cov_file is not None:
            self.read_global_cov(global_cov_file, cov_scale)
            self._use_global_cov = True

        # Minimizer / analysis
        if not self.sample_params['limits']:
            self.minimizer = None
        else:
            self.minimizer = Minimizer(
                self.chi2, self.sample_params,
                grad_func=self.chi2_gradient, hess_func=self.chi2_hessian,
                valgrad_func=self.chi2_value_and_gradient,
                valgradhess_func=self.chi2_value_grad_hess)
        self.analysis = Analysis(self.chi2, self.sample_params,
                                 self.main_config, self.corr_items,
                                 self.data, self.mc_config, self.global_cov,
                                 grad_func=self.chi2_gradient,
                                 hess_func=self.chi2_hessian, vega=self)

        self.corr_num_marg_modes = {}
        if self._has_data:
            for name in self.corr_items:
                self.corr_num_marg_modes[name] = self.data[name].num_marg_modes

        # Sampler flags (reference: vega_interface.py:187-195)
        self.run_sampler = False
        self.sampler = None
        if 'control' in self.main_config:
            self.run_sampler = self.main_config['control'].getboolean(
                'run_sampler', False)
            self.sampler = self.main_config['control'].get('sampler', None)
            if self.run_sampler:
                if self.sampler not in ['Polychord', 'PocoMC', 'NestedJax',
                                        'HMC']:
                    raise ValueError('Sampler not recognized. Use Polychord, '
                                     'PocoMC, NestedJax or HMC.')
                if self.sampler not in self.main_config:
                    raise RuntimeError(
                        'run_sampler set, but no sampler config found')

        self.output = Output(self.main_config['output'], self.data,
                             self.corr_items, self.analysis)

        self.monte_carlo = False

        self.plots = None
        if self._has_data:
            from .plots.plot import VegaPlots
            self.plots = VegaPlots(vega_data=self.data)

        # The compiled chi^2 graph (built lazily on first call); large
        # constants (inverse covariances, marginalization matrices) are
        # passed through the statics store as device-resident arguments
        self._jit_chi2 = None
        self._static_refs_ready = False

    # ------------------------------------------------------------------
    # Model + chi2 graph
    # ------------------------------------------------------------------
    def _model_graph(self, local_params, direct_pk=None,
                     keep_factored=False):
        """Traceable model for all components; returns (model_cf, bad).

        keep_factored=True (the chi^2 graph) preserves FactoredXi values
        so the quadratic-form evaluation can hoist the basis work out of
        vmapped batches; every other caller gets dense vectors."""
        from .factored import densify
        model_cf = {}
        bad = jnp.asarray(False)
        for name in self.corr_items:
            if direct_pk is None:
                cf, cf_bad = self.models[name].compute(
                    local_params, self.fiducial['pk_full'],
                    self.fiducial['pk_smooth'])
            else:
                cf, cf_bad = self.models[name].compute_direct(
                    local_params, direct_pk)
            model_cf[name] = cf if keep_factored else densify(cf)
            bad = bad | cf_bad
        return model_cf, bad

    def _ensure_static_refs(self):
        """Register the large chi^2-side constants in the statics store
        (lazy: computing the inverse covariances happens once here)."""
        if self._static_refs_ready:
            return
        self._invcov_refs = {}
        self._marg_template_refs = {}
        self._marg_coeff_refs = {}
        if not self._use_global_cov:
            for name in self.corr_items:
                self._invcov_refs[name] = register_static(
                    self.data[name].inv_masked_cov, 'invcov')
        else:
            self._global_invcov_ref = register_static(
                self.masked_global_invcov, 'ginvcov')
        for name in self.corr_items:
            corr_data = self.data[name]
            if corr_data.marg_templates is not None:
                self._marg_template_refs[name] = register_static(
                    np.asarray(corr_data.marg_templates), 'margt')
            if corr_data.marg_diff2coeff_matrix is not None:
                self._marg_coeff_refs[name] = register_static(
                    corr_data.marg_diff2coeff_matrix, 'margc')
        self._static_refs_ready = True

    def _collapsed_graph(self, sample_params, data_vecs, cov_scales):
        """Basis-collapse pass: the parameter-independent tensors of the
        factored chi^2 quadratic form, per correlation.

        Traced with the SAME code and the same sampled-parameter key set
        as `_chi2_graph`, so the factored term order matches exactly; the
        outputs only depend on the statics, so jax's dead-code
        elimination strips all coefficient arithmetic from this graph —
        and, symmetrically, passing the result back into `_chi2_graph`
        as `collapsed` strips all basis construction from the per-eval
        graph. One collapse run per sampled-parameter set replaces the
        per-call basis work entirely (see vega_tpu/factored.py).
        """
        from .factored import FactoredXi

        self._ensure_static_refs()
        local_params = self._get_lcl_prms(sample_params)
        if self.marginalize_in_fit or self._use_global_cov:
            return {}
        model_cf, _ = self._model_graph(local_params, keep_factored=True)
        out = {}
        for name in self.corr_items:
            if not isinstance(model_cf[name], FactoredXi):
                continue
            fxi = model_cf[name].mask(self.data[name].model_mask)
            inv_cov = jnp.asarray(resolve(self._invcov_refs[name]))
            w_mat = fxi.V @ inv_cov                  # (T, nm)
            # reference coefficients (at the collapse-time parameter
            # values): the chi^2 quadratic form centers on c0 so the
            # large-magnitude d'Cd / c'Ac cancellation disappears; m0
            # MUST be c0 @ V for the centering to be exact
            c0 = fxi.coeff_vector()
            out[name] = {'W': w_mat, 'A': w_mat @ fxi.V.T,
                         # unmasked basis stack: model = coeffs @ V
                         # (compute_model's fast path)
                         'V': model_cf[name].V,
                         'c0': c0, 'm0': c0 @ fxi.V}
        return out

    def _grid_collapse_node(self, sample_params, data_vecs):
        """One node of the grid-collapse sweep (vega_tpu/gridcollapse.py):
        the quadratic-form tensors of the factored chi^2 at fixed grid-
        parameter values, traced under a `grid_trace` context so the
        basis rows carry the (vmapped) node tracers.

        Returns ({name: {'A': (T, T), 'e': (T,)}}, {name: c0}, bad)."""
        from .factored import FactoredXi

        local_params = self._get_lcl_prms(sample_params)
        model_cf, bad = self._model_graph(local_params, keep_factored=True)
        payload, c0s = {}, {}
        for name in self.corr_items:
            if not isinstance(model_cf[name], FactoredXi):
                continue
            fxi = model_cf[name].mask(self.data[name].model_mask)
            inv_cov = jnp.asarray(resolve(self._invcov_refs[name]))
            w_mat = fxi.V @ inv_cov
            payload[name] = {'A': w_mat @ fxi.V.T,
                             'e': w_mat @ jnp.asarray(data_vecs[name])}
            c0s[name] = fxi.coeff_vector()
        return payload, c0s, bad

    def _chi2_graph(self, sample_params, data_vecs, cov_scales,
                    collapsed=None):
        """Traceable chi^2 of the sampled parameters.

        data_vecs: dict name -> masked data vector (or the concatenated
        vector under the '_global' key when a global covariance is used).
        cov_scales: dict name -> inverse-covariance scale factor (1 unless
        Monte-Carlo rescaling is active).
        collapsed: optional precomputed basis-collapse tensors from
        `_collapsed_graph` (keyed by correlation); when present the
        basis work drops out of this graph entirely. A grid-collapse
        payload (carrying '__grid__', see vega_tpu/gridcollapse.py)
        additionally removes the nonlinear scale parameters from the
        traced model: the model trace runs at the spec's reference
        values (only the coefficient functions survive DCE) and the
        grid-parameter dependence enters through the Chebyshev
        interpolation of the per-node quadratic forms.
        """
        from .factored import FactoredXi, densify

        self._ensure_static_refs()
        local_params = self._get_lcl_prms(sample_params)

        grid_spec = collapsed.get('__grid__') if collapsed else None
        grid_psi_vec = grid_wall = None
        if grid_spec is not None:
            from .gridcollapse import GRID_WALL_CHI2, grid_tvecs
            # psi lives in SAMPLED space: the sweep fed node values in as
            # sampled parameters (blinding etc. applied inside each node)
            grid_psi_vec, grid_excess = grid_tvecs(grid_spec, sample_params)
            grid_wall = GRID_WALL_CHI2 * grid_excess
            # coefficient trace at the reference values: the sampled
            # grid parameters are replaced BEFORE the blinding transform
            # so the substitution lives in the same space as the nodes
            sample_ref = dict(sample_params)
            for n, v in zip(grid_spec.names, grid_spec.ref):
                sample_ref[n] = v
            model_params = self._get_lcl_prms(sample_ref)
        else:
            model_params = local_params

        keep_factored = (not self.marginalize_in_fit
                         and not self._use_global_cov)
        if grid_spec is None:
            model_cf, bad = self._model_graph(model_params,
                                              keep_factored=keep_factored)
        else:
            # Per-correlation choice: grid-covered correlations trace at
            # the reference values (their chi^2 comes from the payload);
            # any correlation that did not stay factored under the grid
            # trace is evaluated densely with the TRUE traced values.
            model_cf = {}
            bad = jnp.asarray(False)
            for name in self.corr_items:
                pars = (model_params if name in collapsed
                        else local_params)
                cf, cf_bad = self.models[name].compute(
                    pars, self.fiducial['pk_full'],
                    self.fiducial['pk_smooth'])
                model_cf[name] = cf if keep_factored else densify(cf)
                bad = bad | cf_bad

        marg_coeff = {}
        if self.marginalize_in_fit:
            marg_coeff = self._marg_coeff_graph(model_cf, data_vecs)
            for name in self.data:
                if name in self._marg_template_refs:
                    model_cf[name] = model_cf[name] + jnp.asarray(resolve(
                        self._marg_template_refs[name])) @ marg_coeff[name]

        if self._use_global_cov:
            full_model = jnp.concatenate(
                [densify(model_cf[name]) for name in self.corr_items])
            diff = data_vecs['_global'] - full_model[self.full_model_mask]
            inv_cov = jnp.asarray(resolve(self._global_invcov_ref))
            chi2 = diff @ (inv_cov @ diff)
        else:
            chi2 = 0.
            for name in self.corr_items:
                corr_data = self.data[name]
                inv_cov = jnp.asarray(resolve(self._invcov_refs[name]))
                if isinstance(model_cf[name], FactoredXi):
                    # Quadratic form in the factored coefficients:
                    #   chi2 = d'Cinv d - 2 c.(W d) + c.(W V').c
                    # with W = V_masked Cinv. Every n-sized or (n, n)-
                    # sized operand is parameter-independent, so under
                    # vmap the whole prefix hoists out of the batch and
                    # each evaluation costs O(T^2). Exact reassociation
                    # of diff' Cinv diff. With precomputed `collapsed`
                    # tensors the basis construction is dead code here
                    # and jax eliminates it from the compiled graph.
                    fxi = model_cf[name].mask(corr_data.model_mask)
                    c = fxi.coeff_vector()
                    d = data_vecs[name]
                    if grid_spec is not None and name in collapsed:
                        from .gridcollapse import grid_corr_chi2
                        assert collapsed[name]['cref'].shape == c.shape, (
                            'grid-collapse tensors do not match the '
                            'factored term structure — stale grid cache')
                        chi2_corr = grid_corr_chi2(
                            collapsed[name], grid_psi_vec, c)
                    elif collapsed is not None and name in collapsed:
                        w_mat = collapsed[name]['W']
                        a_mat = collapsed[name]['A']
                        assert a_mat.shape == (fxi.n_terms, fxi.n_terms), (
                            'collapsed tensors do not match the factored '
                            'term structure — stale collapse cache')
                        # centered quadratic form: with the residual
                        # r = d - m0 against the collapse-time model and
                        # dc = c - c0, diff = r - V'dc exactly, so
                        #   chi2 = r'Cr - 2 dc.(W r) + dc.(A dc)
                        # — same O(T^2) per-eval cost, but no
                        # large-magnitude cancellation (the uncentered
                        # d'Cd - 2c.Wd + c.Ac loses ~5 digits in f64 and
                        # is unusable in f32)
                        dc = c - collapsed[name]['c0']
                        if 'y' in collapsed[name]:
                            # data terms pre-reduced on the host
                            # (_with_collapse_data_terms): the per-eval
                            # graph touches nothing data-vector-sized
                            chi2_corr = (collapsed[name]['s']
                                         - 2.0 * (dc @ collapsed[name]['y'])
                                         + dc @ (a_mat @ dc))
                        else:
                            r = d - collapsed[name]['m0']  # m0 masked
                            chi2_corr = (r @ (inv_cov @ r)
                                         - 2.0 * (dc @ (w_mat @ r))
                                         + dc @ (a_mat @ dc))
                    else:
                        w_mat = fxi.V @ inv_cov         # (T, nm)
                        a_mat = w_mat @ fxi.V.T         # (T, T)
                        chi2_corr = (d @ (inv_cov @ d)
                                     - 2.0 * (c @ (w_mat @ d))
                                     + c @ (a_mat @ c))
                else:
                    model_corr = model_cf[name][corr_data.model_mask]
                    diff = data_vecs[name] - model_corr
                    chi2_corr = diff @ (inv_cov @ diff)
                chi2 = chi2 + cov_scales[name] * chi2_corr

        chi2 = chi2 + self._prior_chi2_graph(local_params)
        if grid_wall is not None:
            # smooth boundary wall of the grid-collapse node domain
            # (see gridcollapse.GRID_WALL_CHI2)
            chi2 = chi2 + grid_wall
        chi2 = jnp.where(bad, PENALTY_CHI2, chi2)
        return chi2, marg_coeff

    def _marg_coeff_graph(self, model_cf, data_vecs):
        """Best-fit marginalization-template coefficients
        (reference: vega_interface.py:546-579)."""
        coeffs = {}
        for name in self.corr_items:
            corr_data = self.data[name]
            if name not in self._marg_coeff_refs:
                continue
            diff = data_vecs[name] - model_cf[name][corr_data.model_mask]
            coeffs[name] = jnp.asarray(
                resolve(self._marg_coeff_refs[name])) @ diff
        return coeffs

    def _prior_chi2_graph(self, local_params):
        chi2 = 0.
        for param, prior in self.priors.items():
            if param not in local_params:
                raise AssertionError(
                    'You have specified a prior for a parameter not in the '
                    f'model. Offending parameter: {param}')
            chi2 = chi2 + ((local_params[param] - prior[0]) ** 2
                           / prior[1] ** 2)
        return chi2

    def _chi2_graph_bound(self, sample_params, data_vecs, cov_scales,
                          statics, collapsed=None):
        with STATICS.bind(statics):
            return self._chi2_graph(sample_params, data_vecs, cov_scales,
                                    collapsed=collapsed)

    def get_collapsed(self, sample_names, with_data_terms=True):
        """Device-resident basis-collapse tensors for one sampled-
        parameter set (cached; one jitted collapse run per set).

        The collapse pass costs one model-graph compile + execution, and
        removes all basis work from every subsequent chi^2 / gradient /
        Hessian / batched-likelihood graph for this parameter set.

        ``with_data_terms=False`` skips the data-side (y, s) hoisting —
        required by consumers that batch OVER data vectors (the
        Monte-Carlo engine), where no single active data vector exists.
        """
        import os
        key = frozenset(sample_names)
        if not key or os.environ.get('VEGA_TPU_FACTORED', '1') != '1' \
                or self.marginalize_in_fit or self._use_global_cov:
            return {}
        grid_names = self._grid_candidate_names(key)
        if grid_names:
            if not with_data_terms:
                # grid payloads bake the active data vector in entirely,
                # so they cannot serve a batch of per-mock data vectors
                return {}
            return self._get_grid_collapsed(key, grid_names)
        if not hasattr(self, '_collapsed_cache'):
            self._collapsed_cache = {}
        if key not in self._collapsed_cache:
            self._ensure_static_refs()
            def collapse_bound(sp, dv, cs, st):
                with STATICS.bind(st):
                    return self._collapsed_graph(sp, dv, cs)

            fn = jax.jit(collapse_bound)
            sample_now = {name: float(self.params.get(name, 0.0))
                          for name in sample_names}
            # The collapse tensors are data-independent; dummy data vecs
            # keep this usable before any MC mock exists
            dummy_data = {name: np.zeros(int(np.sum(
                self.data[name].data_mask))) for name in self.corr_items}
            cov_scales = {name: 1.0 for name in self.corr_items}

            out = fn(sample_now, dummy_data, cov_scales,
                     STATICS.device_tree())
            # cache HOST copies: the data terms are reduced on the host
            # (_with_collapse_data_terms) and device copies are made
            # lazily (_device_collapsed)
            self._collapsed_cache[key] = jax.tree.map(
                lambda x: np.asarray(x), out)
        if not with_data_terms:
            return self._collapsed_cache[key]
        return self._with_collapse_data_terms(key,
                                              self._collapsed_cache[key])

    def _with_collapse_data_terms(self, key, collapsed):
        """Merge the data-side reductions of the centered quadratic form
        into a plain-collapse payload:  y = W r  and  s = r'C r  with
        r = d - m0 against the ACTIVE data vector. Exact hoisting of the
        per-call unbatched prefix (host f64) — each chi^2 evaluation is
        then two (T,)-sized contractions with no data-vector arithmetic
        at all. Cached per data version; consumers that batch OVER data
        vectors (the Monte-Carlo engine) strip these keys and keep the
        in-graph r = d - m0 form."""
        if not collapsed:
            return collapsed
        vecs = self._current_data_vecs()
        data_key = (key, self.monte_carlo,
                    tuple(id(v) for v in vecs.values()))
        if not hasattr(self, '_collapse_data_cache'):
            self._collapse_data_cache = {}
        if data_key not in self._collapse_data_cache:
            merged = {}
            for name, tensors in collapsed.items():
                d = np.asarray(vecs[name])
                r = d - tensors['m0']
                inv_cov = np.asarray(self.data[name].inv_masked_cov)
                merged[name] = dict(tensors,
                                    y=tensors['W'] @ r,
                                    s=float(r @ (inv_cov @ r)))
            self._collapse_data_cache[data_key] = merged
        return self._collapse_data_cache[data_key]

    def _device_collapsed(self, collapsed):
        """Default-device copy of a (host-cached) collapse payload,
        memoized by payload identity."""
        if not collapsed:
            return collapsed
        if not hasattr(self, '_collapsed_device_memo'):
            self._collapsed_device_memo = {}
        key = id(collapsed)
        if key not in self._collapsed_device_memo:
            self._collapsed_device_memo[key] = jax.tree.map(
                jnp.asarray, collapsed)
        return self._collapsed_device_memo[key]

    def _serial_args(self, collapsed):
        """Device-resident (statics_tree, collapsed, data_vecs) for the
        serial (unbatched) chi^2 / derivative providers."""
        return (STATICS.device_tree(), self._device_collapsed(collapsed),
                self._current_data_vecs_device())

    # ------------------------------------------------------------------
    # Grid collapse (nonlinear scale parameters; vega_tpu/gridcollapse.py)
    # ------------------------------------------------------------------
    def _control_get(self, option, default=None):
        if 'control' in self.main_config:
            return self.main_config['control'].get(option, default)
        return default

    def _grid_candidate_names(self, key):
        """Sampled parameters that should be handled by the grid
        collapse: the known nonlinear scale parameters plus any names
        designated via [control] grid-params."""
        import os
        from .gridcollapse import is_known_grid_param
        if os.environ.get('VEGA_TPU_GRID_COLLAPSE', '1') != '1':
            return ()
        designated = set((self._control_get('grid-params') or '').split())
        names = [n for n in sorted(key)
                 if is_known_grid_param(n) or n in designated]
        return tuple(names)

    def _grid_dim_setup(self, name):
        """(lo, hi, degree, ref) for one grid dimension."""
        import os
        from .gridcollapse import ALPHA_LIKE
        value = float(self.params.get(name, 1.0 if name in ALPHA_LIKE
                                      else 0.0))
        override = self._control_get(f'grid-domain-{name}')
        if override is not None:
            lo, hi = (float(v) for v in override.split())
        else:
            limits = self.sample_params['limits'].get(name)
            if limits is None and self.mc_config is not None:
                limits = self.mc_config['sample']['limits'].get(name)
            if limits is None or limits[0] is None or limits[1] is None:
                lo, hi = value - 0.25, value + 0.25
            else:
                lo, hi = float(limits[0]), float(limits[1])
            if name in ALPHA_LIKE or name.startswith('alpha_smooth'):
                # the alpha-like domain defaults to a window around the
                # current value: the chi^2 oscillates on the BAO scale in
                # alpha, so node count grows with domain width
                pad = float(self._control_get(
                    'grid-domain-pad',
                    os.environ.get('VEGA_TPU_GRID_PAD', '0.25')))
                lo, hi = max(lo, value - pad), min(hi, value + pad)
        degree = self._control_get(f'grid-nodes-{name}')
        if degree is None:
            degree = os.environ.get('VEGA_TPU_GRID_NODES')
        if degree is None:
            # alpha-like default 32: measured max |delta chi2| vs the
            # dense pipeline on the reference DR16-subset config over
            # the full +/-0.25 production domain is 1.7e-10 at 32
            # nodes/dim and 1.4e-10 at 64 (benchmarks/grid_accuracy.py,
            # 2026-08-19) — node convergence saturates well below 32,
            # and the validated mode truncation bounds the payload
            # error independently of the node count; 32 keeps the
            # one-time sweep ~200 s instead of ~850 s on a 1-core host.
            # On the synthetic DR16-shaped config the measured bound is
            # ~4e-3 (tests/test_grid_collapse.py, docs/performance.md).
            if name in ALPHA_LIKE or name.startswith('alpha_smooth'):
                degree = 32
            elif name.startswith('drp_'):
                degree = 12
            elif name.startswith('sigma_velo_disp_'):
                # smooth velocity-dispersion damping: spectrally
                # converged well below 12 nodes over the default [0, 15]
                # sampling window (tests/test_grid_collapse.py,
                # benchmarks/table6_accuracy)
                degree = 12
            else:
                degree = 16
        ref = min(max(value, lo), hi)
        return lo, hi, int(degree), ref

    def _get_grid_collapsed(self, key, grid_names):
        """Cached grid-collapse payload for one sampled-parameter set
        (re-built when the active data vectors change, e.g. Monte-Carlo
        mocks)."""
        import os
        from .gridcollapse import GridSpec, build_grid_payload

        vecs = self._current_data_vecs()
        data_key = (self.monte_carlo,) + tuple(id(v) for v in vecs.values())
        if not hasattr(self, '_grid_cache'):
            self._grid_cache = {}
        cache_key = (key, data_key)
        if cache_key in self._grid_cache:
            return self._grid_cache[cache_key]

        from .gridcollapse import plan_components

        dims = [self._grid_dim_setup(n) for n in grid_names]
        degrees = [d[2] for d in dims]
        spec = GridSpec(grid_names, [d[0] for d in dims],
                        [d[1] for d in dims], degrees,
                        [d[3] for d in dims])
        # Node-grid schedule: one full tensor when affordable, else the
        # anisotropic combination (pairs at full resolution, higher
        # interactions at mid level) — the sweep cost of the 3-4-dim
        # Table-6 BAO regime drops from prod(degrees) to a few thousand
        # dense evaluations (gridcollapse.plan_components).
        comb_mode = self._control_get('grid-combination', 'auto')
        comb_order = int(self._control_get('grid-interaction-order', 3))
        components = plan_components(spec, mode=comb_mode,
                                     order=comb_order)
        sweep_nodes = sum(int(np.prod(degs)) for degs, _ in components)
        max_nodes = int(os.environ.get('VEGA_TPU_GRID_MAX_NODES', 40000))
        if sweep_nodes > max_nodes:
            print(f'INFO: grid collapse disabled: {spec} needs '
                  f'{sweep_nodes} swept nodes > {max_nodes} '
                  '(VEGA_TPU_GRID_MAX_NODES); using the dense path')
            self._grid_cache[cache_key] = {}
            return {}
        self._ensure_static_refs()
        mode_budget = self._control_get('grid-mode-budget')
        if mode_budget is None:
            mode_budget = os.environ.get('VEGA_TPU_GRID_MODE_BUDGET', 2e-4)
        mode_budget = float(mode_budget)
        svd_tol = float(os.environ.get('VEGA_TPU_GRID_SVD_TOL', 1e-12))

        # Disk cache: the node sweep is deterministic in its inputs, so
        # a matching content fingerprint lets fresh sampler/scan/MC
        # processes of the same fit load the payload instead of paying
        # the one-time sweep (Monte-Carlo mode is excluded — mock data
        # vectors change per realization and bake into the payload).
        from .gridcollapse import (payload_cache_dir, payload_fingerprint,
                                   load_payload, save_payload)
        disk_path = None
        if not self.monte_carlo:
            cache_dir = payload_cache_dir()
            if cache_dir is not None:
                # fold programmatically-mutated sampling limits into the
                # fingerprint (config-derived limits hash to nothing, so
                # existing cache entries stay valid)
                current_limits = {
                    k: tuple(v) if isinstance(v, (tuple, list)) else v
                    for k, v in self.sample_params['limits'].items()}
                extra = (None if current_limits
                         == getattr(self, '_config_limits', current_limits)
                         else repr(sorted(current_limits.items())))
                fp = payload_fingerprint(self, sorted(key), spec,
                                         mode_budget, svd_tol,
                                         components=components,
                                         extra=extra)
                os.makedirs(cache_dir, exist_ok=True)
                disk_path = os.path.join(cache_dir, f'grid_{fp}.npz')
                if os.path.exists(disk_path):
                    try:
                        payload = load_payload(disk_path)
                        self._grid_cache[cache_key] = payload
                        return payload
                    except Exception as exc:    # corrupt cache entry
                        print(f'WARNING: ignoring unreadable grid-payload '
                              f'cache entry {disk_path} ({exc})')

        payload = build_grid_payload(
            self, sorted(key), grid_names, spec,
            svd_tol=svd_tol, mode_budget=mode_budget,
            components=components,
            checkpoint_dir=(None if disk_path is None
                            else disk_path + '.sweep'))
        if len(payload) <= 1:       # only '__grid__': nothing factored
            payload = {}
        elif disk_path is not None:
            save_payload(disk_path, payload)
        if disk_path is not None:
            # sweep checkpoints are superseded by the saved payload
            import shutil
            shutil.rmtree(disk_path + '.sweep', ignore_errors=True)
        # host (numpy) payload cached; device copies via _device_collapsed
        self._grid_cache[cache_key] = payload
        return payload

    def _get_jit_chi2(self):
        if self._jit_chi2 is None:
            self._ensure_static_refs()
            self._jit_chi2 = jax.jit(self._chi2_graph_bound)
        return self._jit_chi2

    def chi2_value_and_gradient(self, params):
        """(chi^2, d(chi^2)/d(theta)) from one jitted graph.

        The minimizer's hot path: L-BFGS-B consumes value+gradient
        together, so fusing them halves the cold-compile count (one
        graph instead of chi^2 + grad) and the per-step dispatches.
        """
        if getattr(self, '_jit_chi2_valgrad', None) is None:
            self._ensure_static_refs()
            self._jit_chi2_valgrad = jax.jit(jax.value_and_grad(
                lambda p, dv, cs, st, co:
                self._chi2_graph_bound(p, dv, cs, st, co)[0]))
        collapsed = self.get_collapsed(params.keys())
        statics, co, data_vecs = self._serial_args(collapsed)
        val, grads = self._jit_chi2_valgrad(
            {k: float(v) for k, v in params.items()},
            data_vecs, self._current_cov_scales(), statics, co)
        self._valgrad_keys = frozenset(params.keys())
        return float(val), {k: float(v) for k, v in grads.items()}

    def chi2_gradient(self, params):
        """Exact d(chi^2)/d(theta) for the sampled parameters via jax.grad
        — replaces MINUIT's finite-difference gradient evaluations.

        Shares the value_and_grad graph with chi2_value_and_gradient
        (the value is free in reverse mode), so a workflow that asks for
        gradients and then fits pays ONE derivative-graph compile."""
        return self.chi2_value_and_gradient(params)[1]

    def chi2_value_grad_hess(self, params):
        """(chi^2, gradient, Hessian) from ONE jitted graph — used by the
        minimizer when VEGA_TPU_FUSED_FIT=1 and the collapsed fast path
        applies: every L-BFGS step then also computes the Hessian, so
        the split value+gradient and Hessian graphs stay the default.
        Returns None when the collapse does not apply.
        """
        if not self.get_collapsed(params.keys()):
            return None
        if getattr(self, '_jit_chi2_vgh', None) is None:
            self._ensure_static_refs()

            def fn(p, dv, cs, st, co):
                return self._chi2_graph_bound(p, dv, cs, st, co)[0]

            def fused(p, dv, cs, st, co):
                val, grads = jax.value_and_grad(fn)(p, dv, cs, st, co)
                hess = jax.hessian(fn)(p, dv, cs, st, co)
                return val, grads, hess

            self._jit_chi2_vgh = jax.jit(fused)
        collapsed = self.get_collapsed(params.keys())
        statics, co, data_vecs = self._serial_args(collapsed)
        val, grads, hess = self._jit_chi2_vgh(
            {k: float(v) for k, v in params.items()},
            data_vecs, self._current_cov_scales(), statics, co)
        names = list(params.keys())
        return (float(val), {k: float(v) for k, v in grads.items()},
                {n1: {n2: float(hess[n1][n2]) for n2 in names}
                 for n1 in names})

    def chi2_hessian(self, params, free_names):
        """Exact chi^2 Hessian over free_names via jax.hessian. The jit
        is cached per free-parameter set (re-jitting per call would cost
        a fresh compile on every minimize)."""
        self._ensure_static_refs()
        fixed = {k: float(v) for k, v in params.items()
                 if k not in free_names}
        free = {k: float(params[k]) for k in free_names}

        if not hasattr(self, '_hess_cache'):
            self._hess_cache = {}
        key = tuple(sorted(free_names))
        if key not in self._hess_cache:
            def fn(free_p, fixed_p, dv, cs, statics, co):
                return self._chi2_graph_bound({**fixed_p, **free_p}, dv,
                                              cs, statics, co)[0]
            self._hess_cache[key] = jax.jit(jax.hessian(fn))

        collapsed = self.get_collapsed(params.keys())
        statics, co, data_vecs = self._serial_args(collapsed)
        hess = self._hess_cache[key](
            free, fixed, data_vecs, self._current_cov_scales(), statics, co)
        return {n1: {n2: float(hess[n1][n2]) for n2 in free_names}
                for n1 in free_names}

    def _current_data_vecs(self):
        if self._use_global_cov:
            if self.monte_carlo:
                return {'_global': self.analysis.current_mc_mock}
            return {'_global': np.concatenate(
                [self.data[name].masked_data_vec
                 for name in self.corr_items])}
        if self.monte_carlo:
            return {name: self.data[name].masked_mc_mock
                    for name in self.corr_items}
        return {name: self.data[name].masked_data_vec
                for name in self.corr_items}

    def _current_data_vecs_device(self):
        """Device-resident data vectors, cached so repeated chi^2 calls do
        not re-transfer them."""
        vecs = self._current_data_vecs()
        key = (self.monte_carlo,) + tuple(id(v) for v in vecs.values())
        if getattr(self, '_data_vec_cache_key', None) != key:
            self._data_vec_cache = {k: jnp.asarray(v)
                                    for k, v in vecs.items()}
            self._data_vec_cache_key = key
        return self._data_vec_cache

    def _current_cov_scales(self):
        scales = {}
        for name in self.corr_items:
            corr_data = self.data[name]
            if self.monte_carlo and corr_data.scaled_inv_masked_cov is not None:
                # scaled_inv = inv / scale
                scales[name] = 1.0 / corr_data._scale
            else:
                scales[name] = 1.0
        return scales

    # ------------------------------------------------------------------
    # Public API (mirrors the reference)
    # ------------------------------------------------------------------
    def compute_model(self, params=None, run_init=True, direct_pk=None,
                      marg_coeff=None):
        """Model correlations for each component as numpy arrays
        (reference: vega_interface.py:208-248).

        The standard path goes through a jitted graph (one compile per
        parameter-key-set); eager tracing is kept only for run_init,
        direct_pk and save-components modes (which store intermediates).
        """
        local_params = self._get_lcl_prms(params)

        use_jit = (not run_init and direct_pk is None and not self.model_pk
                   and not self.fiducial.get('save-components', False))
        if use_jit:
            self._ensure_static_refs()
            model_cf = self._compute_model_fast(params)
            if model_cf is None:
                if getattr(self, '_jit_model', None) is None:
                    def model_bound(lp, statics):
                        with STATICS.bind(statics):
                            return self._model_graph(lp)
                    self._jit_model = jax.jit(model_bound)
                cf_dict, bad = self._jit_model(local_params,
                                               STATICS.device_tree())
                if bool(bad):
                    raise utils.VegaModelError(
                        'Model evaluation failed (out-of-bounds '
                        'interpolation or non-finite factor)')
                model_cf = {name: np.asarray(cf)
                            for name, cf in cf_dict.items()}
        else:
            model_cf = {}
            if run_init:
                self.models = {}
                self._jit_model = None
                self._jit_chi2 = None
                self._jit_chi2_valgrad = None
                self._jit_chi2_vgh = None
                self._valgrad_keys = None
                self._hess_cache = {}
                self._collapsed_cache = {}
                self._grid_cache = {}
                self._jit_model_coeffs = {}
            for name, corr_item in self.corr_items.items():
                if run_init:
                    self.models[name] = Model(
                        corr_item, self.fiducial, self.scale_params,
                        self.data[name])
                if direct_pk is None:
                    cf, bad = self.models[name].compute(
                        local_params, self.fiducial['pk_full'],
                        self.fiducial['pk_smooth'])
                else:
                    cf, bad = self.models[name].compute_direct(
                        local_params, direct_pk)
                if self.model_pk:
                    model_cf[name] = np.asarray(cf)
                    continue
                if bool(bad):
                    raise utils.VegaModelError(
                        f'Model evaluation failed for {name} '
                        '(out-of-bounds interpolation or non-finite factor)')
                model_cf[name] = np.asarray(cf)

        if marg_coeff is not None:
            for name in self.data:
                if self.data[name].marg_templates is not None:
                    model_cf[name] = model_cf[name] + \
                        self.data[name].marg_templates.dot(marg_coeff[name])

        return model_cf

    def _compute_model_fast(self, params):
        """Model vectors via the factored fast path: a coefficients-only
        jitted graph (all basis work dead-code-eliminated) contracted
        with the collapse pass's basis stacks. Returns None when the
        factored form does not apply (then the dense graph is used).

        params=None evaluates at the stored values of the configured
        sample parameters, sharing the compiled graph with bestfit-model
        and Monte-Carlo-fiducial calls.
        """
        from .factored import FactoredXi

        if params is None:
            if not self.sample_params['limits']:
                return None
            sample_params = {name: float(self.params[name])
                             for name in self.sample_params['limits']}
        else:
            sample_params = {k: float(v) for k, v in params.items()}

        if self._grid_candidate_names(frozenset(sample_params)):
            # grid payloads carry quadratic-form tensors, not basis
            # stacks — model vectors go through the dense graph (and
            # building the payload here would be a wasted node sweep)
            return None
        collapsed = self.get_collapsed(sample_params.keys())
        if not collapsed:
            return None

        key = frozenset(sample_params.keys())
        if not hasattr(self, '_jit_model_coeffs'):
            self._jit_model_coeffs = {}
        if key not in self._jit_model_coeffs:
            kinds = {}

            def coeffs_bound(sp, statics):
                with STATICS.bind(statics):
                    model_cf, bad = self._model_graph(
                        self._get_lcl_prms(sp), keep_factored=True)
                out = {}
                for name, cf in model_cf.items():
                    if isinstance(cf, FactoredXi):
                        kinds[name] = 'coeffs'
                        out[name] = cf.coeff_vector()
                    else:
                        kinds[name] = 'dense'
                        out[name] = cf
                return out, bad

            self._jit_model_coeffs[key] = (jax.jit(coeffs_bound), kinds)

        fn, kinds = self._jit_model_coeffs[key]
        out, bad = fn(sample_params, STATICS.device_tree())
        if bool(bad):
            raise utils.VegaModelError(
                'Model evaluation failed (out-of-bounds interpolation '
                'or non-finite factor)')
        model_cf = {}
        for name, vec in out.items():
            if kinds[name] == 'coeffs' and name in collapsed:
                model_cf[name] = np.asarray(vec) @ np.asarray(
                    collapsed[name]['V'])
            elif kinds[name] == 'coeffs':
                return None     # factored but no collapse tensors
            else:
                model_cf[name] = np.asarray(vec)
        return model_cf

    def chi2(self, params=None, direct_pk=None, return_marg_coeff=False):
        """Full chi^2 (reference: vega_interface.py:250-325). Jitted on the
        standard path; the direct_pk path stays eager."""
        assert self._has_data

        if direct_pk is not None:
            return self._chi2_eager(params, direct_pk, return_marg_coeff)

        sample_params = {} if params is None else dict(params)
        cov_scales = self._current_cov_scales()

        # Reuse the already-compiled value+gradient graph when the plain
        # chi^2 graph isn't compiled yet and the parameter key set
        # matches (e.g. log_lik right after a fit): one compile fewer.
        # A params=None
        # call can always use it — passing the stored values explicitly
        # is identical to letting _get_lcl_prms fill them in.
        if (params is None and self._jit_chi2 is None
                and not self.marginalize_in_fit
                and getattr(self, '_jit_chi2_valgrad', None) is not None
                and getattr(self, '_valgrad_keys', None)
                and all(n in self.params for n in self._valgrad_keys)):
            sample_params = {n: float(self.params[n])
                             for n in self._valgrad_keys}
        marg_coeff = {}
        collapsed = self.get_collapsed(sample_params.keys())
        statics, co, data_vecs = self._serial_args(collapsed)
        if (self._jit_chi2 is None and not self.marginalize_in_fit
                and getattr(self, '_jit_chi2_valgrad', None) is not None
                and getattr(self, '_valgrad_keys', None)
                == frozenset(sample_params.keys())):
            val, _ = self._jit_chi2_valgrad(
                {k: float(v) for k, v in sample_params.items()},
                data_vecs, cov_scales, statics, co)
            chi2 = float(val)
        else:
            chi2, marg_coeff = self._get_jit_chi2()(
                sample_params, data_vecs, cov_scales, statics, co)
            chi2 = float(chi2)

        if return_marg_coeff:
            marg_coeff = {k: np.asarray(v) for k, v in marg_coeff.items()}
            if not self.marginalize_in_fit:
                marg_coeff = self.compute_marg_coeff(
                    self.compute_model(params, run_init=False))
            return chi2, marg_coeff
        return chi2

    def _chi2_eager(self, params=None, direct_pk=None,
                    return_marg_coeff=False):
        """Eager chi^2 used for the direct-Pk path."""
        try:
            model_cf = self.compute_model(params, run_init=False,
                                          direct_pk=direct_pk)
        except utils.VegaModelError:
            return (PENALTY_CHI2, None) if return_marg_coeff else PENALTY_CHI2

        marg_coeff = None
        if return_marg_coeff or self.marginalize_in_fit:
            marg_coeff = self.compute_marg_coeff(model_cf)
        if self.marginalize_in_fit:
            for name in self.data:
                if self.data[name].marg_templates is not None:
                    model_cf[name] = model_cf[name] + \
                        self.data[name].marg_templates.dot(marg_coeff[name])

        if self._use_global_cov:
            full_data = self._current_data_vecs()['_global']
            full_model = np.concatenate(
                [model_cf[name] for name in self.corr_items])
            diff = full_data - full_model[self.full_model_mask]
            chi2 = diff.T.dot(self.masked_global_invcov.dot(diff))
        else:
            chi2 = 0.
            for name in self.corr_items:
                corr_data = self.data[name]
                model_corr = model_cf[name][corr_data.model_mask]
                if self.monte_carlo:
                    diff = corr_data.masked_mc_mock - model_corr
                    chi2 += diff.T.dot(
                        corr_data.scaled_inv_masked_cov.dot(diff))
                else:
                    diff = corr_data.masked_data_vec - model_corr
                    chi2 += diff.T.dot(corr_data.inv_masked_cov.dot(diff))

        chi2 += float(self._prior_chi2_graph(self._get_lcl_prms(params)))
        if return_marg_coeff:
            return chi2, marg_coeff
        return chi2

    def log_lik(self, params=None, direct_pk=None, return_marg_coeff=False):
        """Full log-likelihood (reference: vega_interface.py:327-387)."""
        assert self._has_data

        if return_marg_coeff:
            chi2, marg_coeff = self.chi2(params, direct_pk, True)
        else:
            chi2 = self.chi2(params, direct_pk)

        log_lik = self._log_norm() - 0.5 * chi2
        for prior in self.priors.values():
            log_lik += self._gaussian_lik_prior(prior[1])

        if return_marg_coeff:
            if marg_coeff:
                corr_names = sorted(n for n in self.corr_items
                                    if n in marg_coeff)
                marg_list = (np.hstack([marg_coeff[c] for c in corr_names])
                             if corr_names else np.array([]))
            else:
                marg_list = None
            return log_lik, marg_list
        return log_lik

    def _log_norm(self):
        log_norm = 0.
        for name in self.corr_items:
            log_norm -= 0.5 * self.data[name].data_size * np.log(2 * np.pi)
            if not self._use_global_cov:
                if self.monte_carlo and \
                        self.data[name].scaled_log_cov_det is not None:
                    log_norm -= 0.5 * self.data[name].scaled_log_cov_det
                else:
                    log_norm -= 0.5 * self.data[name].log_cov_det
        if self._use_global_cov:
            log_norm -= 0.5 * self.masked_global_log_cov_det
        return log_norm

    # ------------------------------------------------------------------
    # Batched (vmapped) likelihood — the device-batched replacement for
    # MPI fan-out of sampler points (SURVEY.md section 2.3)
    # ------------------------------------------------------------------
    def chi2_batch(self, param_batches):
        """chi^2 for a batch: dict of name -> (n_batch,) arrays."""
        self._ensure_static_refs()
        data_vecs = self._current_data_vecs()
        cov_scales = self._current_cov_scales()
        fn = jax.vmap(
            lambda p, st, co: self._chi2_graph_bound(p, data_vecs,
                                                     cov_scales, st, co)[0],
            in_axes=(0, None, None))
        return np.asarray(jax.jit(fn)(
            param_batches, STATICS.device_tree(),
            self._device_collapsed(
                self.get_collapsed(param_batches.keys()))))

    def log_lik_batch(self, param_batches):
        chi2 = self.chi2_batch(param_batches)
        log_lik = self._log_norm() - 0.5 * chi2
        for prior in self.priors.values():
            log_lik += self._gaussian_lik_prior(prior[1])
        return log_lik

    # ------------------------------------------------------------------
    def _get_lcl_prms(self, params=None):
        """Local parameter dict with blinding applied
        (reference: vega_interface.py:389-421)."""
        local_params = copy.copy(self.params)
        if params is not None:
            local_params.update(params)

        assert self._blind is not None
        if self._rnsps is not None:
            assert self._blind
            local_params = utils.apply_blinding(local_params, self._rnsps)
            for par in local_params:
                if par in utils.BLIND_FIXED_PARS:
                    local_params[par] = 1.
        return local_params

    def compute_prior_chi2(self, params=None):
        """(reference: vega_interface.py:423-446)"""
        return float(self._prior_chi2_graph(self._get_lcl_prms(params)))

    def compute_marg_coeff(self, model_cf):
        """(reference: vega_interface.py:546-579)"""
        coeffs = {}
        for name in self.corr_items:
            corr_data = self.data[name]
            if corr_data.marg_diff2coeff_matrix is None:
                continue
            if self.monte_carlo:
                diff = corr_data.masked_mc_mock \
                    - model_cf[name][corr_data.model_mask]
            else:
                diff = corr_data.masked_data_vec \
                    - model_cf[name][corr_data.model_mask]
            coeffs[name] = corr_data.marg_diff2coeff_matrix.dot(diff)
        return coeffs

    # ------------------------------------------------------------------
    # Monte Carlo (reference: vega_interface.py:448-544)
    # ------------------------------------------------------------------
    def get_fiducial_for_monte_carlo(self, print_func=print):
        mc_params = self.mc_config['params']
        mc_start_from_fit = self.main_config['control'].get(
            'mc_start_from_fit', None)

        if mc_start_from_fit is not None:
            from .postprocess.fit_results import FitResults
            print_func(f'Reading input fit {mc_start_from_fit}')
            existing_fit = FitResults(utils.find_file(mc_start_from_fit))
            mc_params = existing_fit.params | mc_params
        elif self.sample_params['limits']:
            print_func('Running initial fit')
            self.minimize()
            mc_params = self.bestfit.values | mc_params

        use_measured = self.main_config['control'].getboolean(
            'use_measured_fiducial', False)
        if use_measured:
            fiducial_model = {}
            for name in self.corr_items:
                path = self.main_config['control'].get(f'mc_fiducial_{name}')
                hdul = read_fits(utils.find_file(path))
                fiducial_model[name] = hdul[1]['DA']
        else:
            use_full_pk = self.main_config['control'].getboolean(
                'use_full_pk_for_mc', False)
            fiducial_model = self.compute_model(
                mc_params, run_init=False,
                direct_pk=self.fiducial['pk_full'] if use_full_pk else None)
        return fiducial_model

    def initialize_monte_carlo(self, scale=None, print_func=print):
        fiducial_model = self.get_fiducial_for_monte_carlo(print_func)

        sample_params = self.mc_config['sample']
        self.minimizer = Minimizer(
            self.chi2, sample_params,
            grad_func=self.chi2_gradient, hess_func=self.chi2_hessian,
            valgrad_func=self.chi2_value_and_gradient,
            valgradhess_func=self.chi2_value_grad_hess)

        forecast = self.main_config['control'].getboolean('forecast', False)
        seed = self.main_config['control'].getint('mc_seed', 0)

        if self._use_global_cov:
            if scale is None and 'global_cov_rescale' in self.main_config['control']:
                scale = self.main_config['control'].getfloat(
                    'global_cov_rescale')
            mocks = self.analysis.create_global_monte_carlo(
                fiducial_model, seed=seed, scale=scale, forecast=forecast)
        else:
            mocks = self.analysis.create_monte_carlo_sim(
                fiducial_model, seed=seed, scale=scale, forecast=forecast)

        self.monte_carlo = True
        return mocks

    # ------------------------------------------------------------------
    def set_fast_metals(self):
        """Activate fast metals on every model (drop-in surface for the
        reference's method, vega_interface.py:657-664). Under jit the
        metal pipeline is already fully factored, so this only toggles
        the flag the reference's workflow scripts expect to flip."""
        print('Warning! Activating fast metals for minimizing/sampling.')
        for name in self.corr_items:
            metals = getattr(self.models[name], 'metals', None)
            if metals is not None:
                metals.fast_metals = True

    # ------------------------------------------------------------------
    def minimize(self):
        """Minimize chi^2 over the sampled parameters
        (reference: vega_interface.py:581-644)."""
        if self.minimizer is None:
            print('No sampled parameters. Skipping minimization.')
            return

        self.minimizer.minimize()

        self.bestfit_model = self.compute_model(self.minimizer.values,
                                                run_init=False)
        self.total_data_size = 0
        self.bestfit_corr_stats = {}
        num_pars = len(self.sample_params['limits'])

        print('\n----------------------------------------------------')
        for name in self.corr_items:
            corr_data = self.data[name]
            data_size = corr_data.effective_data_size
            self.total_data_size += data_size

            if self.monte_carlo and self._use_global_cov:
                chisq = 0
                diff = None
            elif self.monte_carlo:
                diff = corr_data.masked_mc_mock \
                    - self.bestfit_model[name][corr_data.model_mask]
                chisq = diff.T.dot(corr_data.scaled_inv_masked_cov.dot(diff))
            else:
                diff = corr_data.masked_data_vec \
                    - self.bestfit_model[name][corr_data.model_mask]
                chisq = diff.T.dot(corr_data.inv_masked_cov.dot(diff))

            bestfit_marg_coeff = None
            if corr_data.marg_diff2coeff_matrix is not None and diff is not None:
                bestfit_marg_coeff = corr_data.marg_diff2coeff_matrix.dot(diff)
                self.bestfit_model[name] = self.bestfit_model[name] + \
                    corr_data.marg_templates.dot(bestfit_marg_coeff)

            reduced_chisq = chisq / (data_size - num_pars)
            p_value = 1 - scipy.stats.chi2.cdf(chisq, data_size - num_pars)
            print(f'{name} chi^2/(ndata-nparam): {chisq:.1f}/({data_size}'
                  f'-{num_pars}) = {reduced_chisq:.3f}, PTE={p_value:.2f}')
            print('----------------------------------------------------')
            self.bestfit_corr_stats[name] = {
                'masked_size': data_size, 'chisq': chisq,
                'reduced_chisq': reduced_chisq, 'p_value': p_value,
                'bestfit_marg_coeff': bestfit_marg_coeff,
            }

        self.chisq = self.minimizer.fmin.fval
        self.reduced_chisq = self.chisq / (self.total_data_size - num_pars)
        self.p_value = 1 - scipy.stats.chi2.cdf(
            self.chisq, self.total_data_size - num_pars)
        print(f'Total chi^2/(ndata-nparam): {self.chisq:.1f}/'
              f'({self.total_data_size}-{num_pars}) = '
              f'{self.reduced_chisq:.3f}, PTE={self.p_value:.2f}')
        print('----------------------------------------------------\n')
        if not self.minimizer.fmin.is_valid:
            print('Invalid fit!!! Check data, covariance, model and priors.')

    @property
    def bestfit(self):
        return self.minimizer

    # ------------------------------------------------------------------
    # Fisher sensitivity (reference: vega_interface.py:956-1071)
    # ------------------------------------------------------------------
    def compute_sensitivity_exact(self, nominal=None, verbose=True):
        """Model sensitivity via exact jax.jacfwd derivatives — same
        output structure as compute_sensitivity but with no
        finite-difference truncation error (the reference only has the
        central-difference version).

        partials[n][p] has shape (2, 2, n_bins): axes are
        (distorted / undistorted, peak / smooth).
        """
        if nominal is None:
            if self.bestfit is None or not self.bestfit.run_flag:
                raise RuntimeError(
                    'No nominal parameter values provided or saved')
            nominal = {name: (self.bestfit.values[name],
                              self.bestfit.errors[name])
                       for name in self.bestfit.values}

        base_params = copy.deepcopy(self.params)
        for pname, (pvalue, _) in nominal.items():
            base_params[pname] = pvalue
        free = {p: float(base_params[p]) for p in nominal}
        fixed = {k: v for k, v in base_params.items() if k not in nominal}
        bao_amp = self.params['bao_amp']
        self._ensure_static_refs()

        def components(free_p, statics):
            """Per-correlation (distorted/undistorted, peak/smooth)
            component stacks as a traced pytree."""
            with STATICS.bind(statics):
                local = dict(fixed)
                local.update(free_p)
                out = {}
                for name, model in self.models.items():
                    pars = dict(local)
                    pk_full = self.fiducial['pk_full']
                    pk_smooth = self.fiducial['pk_smooth']
                    pk_peak_lin = np.asarray(pk_full) - np.asarray(pk_smooth)

                    pars['peak'] = True
                    skip = model.Pk_core.skip_nl_model_in_peak
                    f_peak, _ = model.Pk_core._shared_factor(pars,
                                                             skip_nl=skip)
                    pk_p = (jnp.asarray(pk_peak_lin) * f_peak
                            * model.Pk_core.compute_peak_nl(pars))
                    xi_peak, _ = model.Xi_core.compute(
                        pk_p, pk_peak_lin, model.PktoXi, pars)

                    pars['peak'] = False
                    f_smooth = (model.Pk_core._shared_factor(pars)[0]
                                if skip else f_peak)
                    pk_s = jnp.asarray(pk_smooth) * f_smooth
                    xi_smooth, _ = model.Xi_core.compute(
                        pk_s, pk_smooth, model.PktoXi, pars)
                    if model._corr_item.has_metals:
                        from .factored import densify
                        xi_m, _ = model.metals.compute(pars, pk_full, 'full')
                        xi_smooth = xi_smooth + densify(xi_m)

                    if model._dist_mat is not None:
                        dm = jnp.asarray(resolve(model._dist_mat))
                        xi_peak_d = dm @ xi_peak
                        xi_smooth_d = dm @ xi_smooth
                    else:
                        xi_peak_d, xi_smooth_d = xi_peak, xi_smooth
                    out[name] = jnp.stack([
                        jnp.stack([xi_peak_d, xi_smooth_d]),
                        jnp.stack([xi_peak, xi_smooth]),
                    ])  # (2 dist, 2 comp, n_bins)
                return out

        jac = jax.jit(jax.jacfwd(components))(free, STATICS.device_tree())

        self.sensitivity = dict(nominal=copy.deepcopy(nominal),
                                partials={}, fisher={})
        for name in self.corr_items:
            self.sensitivity['partials'][name] = {}
            self.sensitivity['fisher'][name] = {}
            for pname in nominal:
                part = np.array(jac[name][pname])
                # apply the bao_amp weighting the reference folds into the
                # peak partials (vega_interface.py:1017-1030)
                part[:, 0, :] *= bao_amp
                self.sensitivity['partials'][name][pname] = part

        self._fill_fisher(nominal, verbose)

    def _fill_fisher(self, nominal, verbose=True):
        if verbose:
            print('Computing Fisher information for each pair of parameters.')
        for pindex1, pname1 in enumerate(nominal):
            for pindex2, pname2 in enumerate(nominal):
                if pindex1 > pindex2:
                    continue
                for n in self.corr_items:
                    rp = self.corr_items[n].model_coordinates.rp_grid
                    fisher = np.zeros((2, len(rp)))
                    mask = self.data[n].data_mask
                    for idistort in range(2):
                        partial1 = self.sensitivity['partials'][n][pname1][
                            idistort].sum(axis=0)
                        partial2 = self.sensitivity['partials'][n][pname2][
                            idistort].sum(axis=0)
                        masked_info = (partial1[mask] * self.data[
                            n].inv_masked_cov.dot(partial2[mask]))
                        fisher[idistort, mask] = masked_info
                        fisher[idistort, ~mask] = np.nan
                    self.sensitivity['fisher'][n][(pname1, pname2)] = fisher

    def compute_sensitivity(self, nominal=None, frac=0.1, verbose=True):
        """Model sensitivity and Fisher information per (rt, rp) bin.

        Same outputs as the reference's central finite differences; frac
        and the nominal (value, error) interface are preserved.
        """
        if nominal is None:
            if self.bestfit is None or not self.bestfit.run_flag:
                raise RuntimeError(
                    'No nominal parameter values provided or saved')
            nominal = {name: (self.bestfit.values[name],
                              self.bestfit.errors[name])
                       for name in self.bestfit.values}

        params = copy.deepcopy(self.params)
        for pname, (pvalue, _) in nominal.items():
            params[pname] = pvalue

        self.sensitivity = dict(nominal=copy.deepcopy(nominal),
                                partials={}, fisher={})
        for name in self.corr_items:
            self.sensitivity['partials'][name] = {}
            self.sensitivity['fisher'][name] = {}

        self.fiducial['save-components'] = True
        bao_amp = self.params['bao_amp']
        for pindex, (pname, (pvalue, perror)) in enumerate(nominal.items()):
            if verbose:
                print(f'Calculating sensitivity for [{pindex}] {pname} at'
                      f' {pvalue:.4f} +/- {perror:.4f}')
            delta = frac * perror
            for sign in (+1, -1):
                params[pname] = pvalue + sign * delta
                cfs = self.compute_model(params, run_init=True)
                for n in cfs:
                    if pname not in self.sensitivity['partials'][n]:
                        rp = self.corr_items[n].model_coordinates.rp_grid
                        self.sensitivity['partials'][n][pname] = \
                            np.zeros((2, 2, len(rp)))
                    model = self.models[n]
                    part = self.sensitivity['partials'][n][pname]
                    part[0, 0] += sign * bao_amp * \
                        model.xi_distorted['peak']['core']
                    part[0, 1] += sign * model.xi_distorted['smooth']['core']
                    part[1, 0] += sign * bao_amp * model.xi['peak']['core']
                    part[1, 1] += sign * model.xi['smooth']['core']
            for n in self.corr_items:
                self.sensitivity['partials'][n][pname] /= 2 * delta
            params[pname] = pvalue

        if verbose:
            print('Computing Fisher information for each pair of parameters.')
        for pindex1, pname1 in enumerate(nominal):
            for pindex2, pname2 in enumerate(nominal):
                if pindex1 > pindex2:
                    continue
                for n in self.corr_items:
                    rp = self.corr_items[n].model_coordinates.rp_grid
                    fisher = np.zeros((2, len(rp)))
                    mask = self.data[n].data_mask
                    for idistort in range(2):
                        partial1 = self.sensitivity['partials'][n][pname1][
                            idistort].sum(axis=0)
                        partial2 = self.sensitivity['partials'][n][pname2][
                            idistort].sum(axis=0)
                        masked_info = (partial1[mask] * self.data[
                            n].inv_masked_cov.dot(partial2[mask]))
                        fisher[idistort, mask] = masked_info
                        fisher[idistort, ~mask] = np.nan
                    self.sensitivity['fisher'][n][(pname1, pname2)] = fisher

    # ------------------------------------------------------------------
    # Config readers (reference: vega_interface.py:666-851)
    # ------------------------------------------------------------------
    @staticmethod
    def _read_fiducial(fiducial_config):
        path = fiducial_config.get('filename')
        path = utils.find_file(os.path.expandvars(path))
        print(f'INFO: reading input Pk {path}')
        hdul = read_fits(path)
        fiducial = {
            'z_fiducial': hdul[1].header['ZREF'],
            'Omega_m': hdul[1].header['OM'],
            'Omega_de': hdul[1].header['OL'],
            'k': hdul[1]['K'].astype(np.float64),
            'pk_full': hdul[1]['PK'].astype(np.float64),
            'pk_smooth': hdul[1]['PKSB'].astype(np.float64),
        }
        if 'F_ZREF' in hdul[1].header:
            fiducial['growth_rate'] = hdul[1].header['F_ZREF']
        return fiducial

    @staticmethod
    def _read_parameters(corr_items, parameters_config):
        params = {}
        for name, corr_item in corr_items.items():
            if 'parameters' in corr_item.config:
                for param, value in corr_item.config.items('parameters'):
                    params[param] = float(value)
        for param, value in parameters_config.items():
            params[param] = float(value)
        return params

    def _read_sample(self, sample_config):
        """(reference: vega_interface.py:738-816)"""
        sample_params = {'limits': {}, 'values': {}, 'errors': {}, 'fix': {}}
        default_values = get_default_values()

        def check_param(param):
            if param not in default_values:
                raise ValueError(f'Default values not found for: {param}. '
                                 'Add them to default_values.txt or provide '
                                 'the full sampling specification.')

        for param, values in sample_config.items():
            if param not in self.params:
                print(f'Warning: sampled parameter {param} was not '
                      'specified under [parameters]; it will be skipped.')
                continue
            values_list = values.split()

            if len(values_list) > 1:
                lower = (None if values_list[0] == 'None'
                         else float(values_list[0]))
                upper = (None if values_list[1] == 'None'
                         else float(values_list[1]))
                sample_params['limits'][param] = (lower, upper)
            else:
                if values_list[0] not in ['True', 'true', 't', 'y', 'yes']:
                    continue
                check_param(param)
                sample_params['limits'][param] = \
                    default_values[param]['limits']

            if len(values_list) > 2:
                sample_params['values'][param] = float(values_list[2])
            else:
                check_param(param)
                sample_params['values'][param] = self.params[param]

            if len(values_list) > 3:
                assert len(values_list) == 4
                sample_params['errors'][param] = float(values_list[3])
            else:
                check_param(param)
                sample_params['errors'][param] = default_values[param]['error']

            sample_params['fix'][param] = False

        return sample_params

    @staticmethod
    def _gaussian_chi2_prior(value, mean, sigma):
        return (value - mean) ** 2 / sigma ** 2

    @staticmethod
    def _gaussian_lik_prior(sigma):
        return -0.5 * np.log(2 * np.pi) - np.log(sigma)

    @staticmethod
    def _init_priors(prior_config):
        """(reference: vega_interface.py:827-851)"""
        prior_dict = {}
        for param, prior in prior_config.items():
            prior_list = prior.split()
            if len(prior_list) != 3:
                raise ValueError('Prior format: "<param> = gaussian <mean> '
                                 '<sigma>"')
            if prior_list[0] not in ['gaussian', 'Gaussian']:
                raise ValueError('Only gaussian priors are supported.')
            prior_dict[param] = np.array(prior_list[1:]).astype(float)
        return prior_dict

    def _init_blinding(self):
        """(reference: vega_interface.py:853-886)"""
        blinding_strat = None
        for data_obj in self.data.values():
            if data_obj.blind:
                self._blind = True
                if blinding_strat is None:
                    blinding_strat = data_obj.blinding_strat
                elif blinding_strat != data_obj.blinding_strat:
                    raise ValueError(
                        'Different blinding strategies found in data sets.')

        if not self._blind:
            return

        blind_pars = []
        for par in self.sample_params['limits']:
            if par in utils.BLIND_FIXED_PARS:
                raise ValueError(
                    f'Running on blind data, parameter {par} must be fixed.')
            if par not in utils.VEGA_BLINDED_PARS:
                continue
            tracers = utils.VEGA_BLINDED_PARS[par]
            if any(corr.check_if_blind_corr(tracers)
                   for corr in self.corr_items.values()):
                blind_pars += [par]

        if blind_pars:
            self._rnsps = utils.get_blinding(blind_pars, blinding_strat)

        if ('bias_QSO' in self.sample_params['limits']
                and 'beta_QSO' in self.sample_params['limits']):
            raise ValueError(
                'Running on blind data and sampling bias_QSO and beta_QSO.')

    # ------------------------------------------------------------------
    def read_global_cov(self, global_cov_file, scale=None):
        """Joint covariance handling (reference: vega_interface.py:888-954)."""
        print(f'INFO: Reading global covariance from {global_cov_file}')
        hdul = read_fits(utils.find_file(global_cov_file))
        self.global_cov = hdul[1]['COV'].astype(float)

        if scale is not None:
            print('Rescaling covariance by a factor of: ', scale)
            self.global_cov *= scale
        self._use_global_cov = True

        self.full_data_mask = np.concatenate(
            [self.data[name].data_mask for name in self.corr_items])
        self.full_model_mask = np.concatenate(
            [self.data[name].model_mask for name in self.corr_items])

        if any(item.marginalize_small_scales
               for item in self.corr_items.values()):
            print('Updating global covariance with marginalization templates.')
            j = 0
            for name in self.corr_items:
                data = self.data[name]
                ndata = data.full_data_size
                wd = data.data_mask
                if self.corr_items[name].marginalize_small_scales:
                    block = self.global_cov[j:j + ndata, j:j + ndata]
                    if data.cov_marg_update is not None:
                        block[np.ix_(wd, wd)] += data.cov_marg_update
                    if self.low_mem_mode:
                        del data.cov_marg_update
                j += ndata

        if self.low_mem_mode:
            masked_cov = self.global_cov[np.ix_(self.full_data_mask,
                                                self.full_data_mask)]
            del self.global_cov
            self.global_cov = None
            self.masked_global_log_cov_det = np.linalg.slogdet(masked_cov)[1]
            self.masked_global_invcov = np.linalg.inv(masked_cov)
            del masked_cov
        else:
            self.masked_global_invcov = utils.compute_masked_invcov(
                self.global_cov, self.full_data_mask)
            self.masked_global_log_cov_det = utils.compute_log_cov_det(
                self.global_cov, self.full_data_mask)
