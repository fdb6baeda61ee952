"""P(k, mu_k) -> xi(r, mu) transform plan.

JAX counterpart of the reference's vega/pktoxi.py. The per-call
scipy machinery there (mcfit FFTLog + interp1d per multipole,
pktoxi.py:99-163) becomes three fused dense contractions on device:

  1. Legendre projection:   pk_ell = P_proj @ pk          (n_ell, n_k)
  2. FFTLog + spline solve: xi_knots = L_ell @ pk_ell     (batched matmul)
                            m_knots  = SL_ell @ pk_ell
  3. gather + cubic eval at log(rescaled r), times P_ell(mu), summed.

All operators are precomputed on the host at init (see ops/fftlog.py,
ops/spline.py). The multipole LRU cache of the reference (pktoxi.py:165)
is dropped: under jit the transform is a handful of matmuls.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from numpy import fft as npfft
from scipy.special import loggamma

from .ops.fftlog import FFTLogP2Xi
from .ops.spline import notaknot_second_derivative_matrix, spline_eval
from .statics import register as register_static, resolve

# scipy.special.legendre(ell) monomial coefficients (poly1d order,
# highest power first); exact binary fractions, so Horner evaluation
# reproduces the reference bit-for-bit.
LEGENDRE_COEFFS = {
    0: [1.0],
    1: [1.0, 0.0],
    2: [1.5, 0.0, -0.5],
    3: [2.5, 0.0, -1.5, 0.0],
    4: [4.375, 0.0, -3.75, 0.0, 0.375],
    5: [7.875, 0.0, -8.75, 0.0, 1.875, 0.0],
    6: [14.4375, 0.0, -19.6875, 0.0, 6.5625, 0.0, -0.3125],
}


# Shared dense-operator cache: (k_bytes, ell_vals, old_fftlog, lowring)
# -> (fft_ops, logr_knots, fft_sd_ops). Init-time only.
_OPERATOR_CACHE = {}
_LEGACY_OPERATOR_CACHE = {}


def legendre(ell, x):
    """Evaluate P_ell(x) by Horner's rule on the monomial coefficients,
    matching scipy.special.legendre(ell)(x)."""
    coeffs = LEGENDRE_COEFFS[ell]
    out = jnp.zeros_like(x) + coeffs[0]
    for c in coeffs[1:]:
        out = out * x + c
    return out


def _hamilton_operators(k, ell_vals, n_exp, project_scale):
    """Dense operators for the legacy Hamilton-2000 transform
    (conventions of the reference's Pk2Mp, pktoxi.py:230-279).

    Returns (ops, logr_knots) with ops[i] mapping the input spectrum
    (a multipole if project_scale, else the raw 1D pk) to xi samples
    at the shifted knots log(r) - dr/2.
    """
    k = np.asarray(k, dtype=np.float64)
    k0 = k[0]
    log_span = np.log(k.max() / k0)
    n = len(k)
    emm = n * npfft.fftfreq(n)
    r = 1.0 * np.exp(-emm * log_span / n)
    dr = abs(np.log(r[1] / r[0]))
    order = np.argsort(r)
    r_sorted = r[order]

    q = 2.0 - n_exp - 0.5
    x = q + 2j * np.pi * emm / log_span

    ops = []
    for ell in ell_vals:
        mu = ell + 0.5
        lg1 = loggamma((mu + 1 + x) / 2)
        lg2 = loggamma((mu + 1 - x) / 2)
        um = (k0 * 1.0) ** (-2j * np.pi * emm / log_span) \
            * 2 ** x * np.exp(lg1 - lg2)
        um[0] = um[0].real
        # Linear operator: input -> fft -> *um -> ifft -> sort -> /r^(3-n)
        weight = k ** n_exp * np.sqrt(np.pi / 2)
        if project_scale:
            # the standard path folds (-1)^(ell//2)/(2 pi^2) into the
            # projected multipole (reference: pktoxi.py:260)
            weight = weight * ((-1.0) ** (ell // 2) / (2 * np.pi ** 2))
        basis = np.eye(n) * weight[None, :]
        an = npfft.fft(basis, axis=1) * um[None, :]
        xi_rows = npfft.ifft(an, axis=1)[:, order].real
        xi_rows /= r_sorted[None, :] ** (3 - n_exp)
        xi_rows[:, -1] = 0.0
        ops.append(np.ascontiguousarray(xi_rows.T))
    return np.stack(ops), np.log(r_sorted) - dr / 2


class PktoXi:
    """Transform plan for one tracer pair on fixed (k, mu_k) grids
    (reference: pktoxi.py:12-59 for the configuration surface)."""

    def __init__(self, k_grid, muk_grid, name1, name2, config,
                 muk_weights=None):
        self.name1 = name1
        self.name2 = name2
        self.k_grid = np.asarray(k_grid, dtype=np.float64)
        self.muk_grid = np.asarray(muk_grid)
        self.dmuk = 1.0 / len(muk_grid)
        # quadrature weights for the mu_k projection (midpoint rule's
        # uniform 1/N unless the PowerSpectrum supplies Gauss-Legendre
        # weights; see power_spectrum.py muk-quadrature)
        if muk_weights is None:
            muk_weights = np.full(len(self.muk_grid), self.dmuk)
        self.muk_weights = np.asarray(muk_weights, dtype=np.float64)

        self.ell_max = config.getint('ell_max', 6)
        self._old_fftlog = config.getboolean('old_fftlog', False)
        # mcfit's extrap=True (reference: pktoxi.py:41-43): the input
        # P_ell is power-law-extrapolated into the FFT padding region
        # instead of zero-padded. Implemented as transform operators on
        # the extended k grid plus an in-trace power-law continuation
        # (the continuation is non-linear in P, so the factored fast
        # path densifies first; see compute()).
        self._extrap = config.getboolean('fht_extrap', False)
        self._lowring = config.getboolean('fht_lowring', True)

        self.ell_vals = tuple(np.arange(0, self.ell_max + 1, 2))

        # Legendre projection matrix, with the quadrature and (2l+1)
        # weights folded in (reference: pktoxi.py:95,138)
        muk = self.muk_grid.ravel()
        self.legendre_proj = np.stack([
            np.polyval(LEGENDRE_COEFFS[ell], muk)
            * self.muk_weights * (2 * ell + 1)
            for ell in self.ell_vals
        ])  # (n_ell, n_muk)

        # The dense transform operators only depend on (k grid, ell_max,
        # lowring, old_fftlog) — identical across the ~16 tracer pairs per
        # correlation — so they are built once and shared.
        import os
        pad_env = os.environ.get('VEGA_TPU_FFT_PAD', 'mcfit')
        pad_to = None if pad_env == 'mcfit' else int(pad_env)
        lowring_branch = os.environ.get('VEGA_TPU_LOWRING', '')
        cache_key = (self.k_grid.tobytes(), self.ell_vals,
                     self._old_fftlog, self._lowring, pad_env,
                     self._extrap, lowring_branch)
        self._extrap_geom = None
        if cache_key not in _OPERATOR_CACHE:
            if self._old_fftlog:
                ops, logr = self._build_legacy_operators(
                    self.ell_vals, n_exp=2, project_scale=True)
            elif self._extrap:
                ops, logr = self._build_extrap_operators(pad_to)
            else:
                fftlogs = [FFTLogP2Xi(self.k_grid, ell,
                                      lowring=self._lowring, pad_to=pad_to)
                           for ell in self.ell_vals]
                logr = np.log(fftlogs[0].r_grid)
                ops = np.stack([f.operator() for f in fftlogs])
            s_mat = notaknot_second_derivative_matrix(logr)
            # pk_ell -> spline second derivatives, fused into one matmul
            sd_ops = np.einsum('ij,ljk->lik', s_mat, ops)
            _OPERATOR_CACHE[cache_key] = (
                register_static(ops, 'fftops'), logr,
                register_static(sd_ops, 'fftsd'))
        self.fft_ops, self.logr_knots, self.fft_sd_ops = \
            _OPERATOR_CACHE[cache_key]
        if self._extrap and not self._old_fftlog:
            from .ops.fftlog import default_pad_size
            n = len(self.k_grid)
            n_fft = default_pad_size(n) if pad_to is None \
                else max(int(pad_to), n)
            delta = np.log(self.k_grid[-1] / self.k_grid[0]) / (n - 1)
            n_pad = n_fft - n
            self._extrap_geom = (n_pad // 2, n_pad - n_pad // 2, delta)

        # Lazily-built legacy operators for the relativistic / asymmetry
        # additive terms (reference: pktoxi.py:321-382 use the legacy path)
        self._rel_ops = None
        self._asy_ops = None

    @classmethod
    def init_from_Pk(cls, pk, config):
        """Construct from a PowerSpectrum (reference: pktoxi.py:61-77)."""
        return cls(pk.k_grid, pk.muk_grid, pk.tracer1_name, pk.tracer2_name,
                   config, muk_weights=getattr(pk, 'muk_weights', None))

    # ------------------------------------------------------------------
    # fht_extrap support (mcfit extrap=True; reference: pktoxi.py:41-43)
    # ------------------------------------------------------------------
    def _build_extrap_operators(self, pad_to):
        """Transform operators acting on the EXTENDED (n_fft) input grid:
        the k grid continued geometrically into the padding region with
        the same centered split as the zero-pad path; output rows sliced
        back to the original r grid."""
        from .ops.fftlog import FFTLogP2Xi, default_pad_size
        k = self.k_grid
        n = len(k)
        n_fft = default_pad_size(n) if pad_to is None else max(int(pad_to), n)
        delta = np.log(k[-1] / k[0]) / (n - 1)
        n_pad = n_fft - n
        pad_l = n_pad // 2
        pad_r = n_pad - pad_l
        k_full = np.concatenate([
            k[0] * np.exp(-delta * np.arange(pad_l, 0, -1)),
            k,
            k[-1] * np.exp(delta * np.arange(1, pad_r + 1)),
        ])
        ops = []
        logr = None
        for ell in self.ell_vals:
            tr = FFTLogP2Xi(k_full, ell, lowring=self._lowring, pad_to=0)
            full = tr.operator()                       # (n_fft, n_fft)
            # output rows on the original r grid: r_i = e^lnxy / k[n-1-i]
            # sits at extended index pad_r + i
            ops.append(full[pad_r:pad_r + n, :])
            if logr is None:
                logr = np.log(tr.r_grid[pad_r:pad_r + n])
        return np.stack(ops), logr

    def _extrap_pad(self, pk_ells):
        """Power-law continuation of each multipole into the padding
        region (jax-traceable; the mcfit extrap=True input treatment).
        Ends with zeros or sign flips fall back to zero padding."""
        pad_l, pad_r, _ = self._extrap_geom

        def continuation(f_edge, f_inward, steps):
            # geometric continuation f_edge * rho^step with the per-index
            # ratio rho = f_edge / f_inward in the outward direction;
            # zero or sign-flipping edges fall back to zero padding
            # (mcfit's extrap requires same-sign ends too)
            safe = (f_edge * f_inward > 0)
            rho = jnp.where(safe, jnp.abs(f_edge / jnp.where(
                f_inward == 0, 1.0, f_inward)), 1.0)
            vals = f_edge[..., None] * rho[..., None] ** steps
            return jnp.where(safe[..., None], vals, 0.0)

        # left block, outermost first: steps pad_l..1 outward
        left = continuation(pk_ells[..., 0], pk_ells[..., 1],
                            jnp.arange(pad_l, 0, -1))
        right = continuation(pk_ells[..., -1], pk_ells[..., -2],
                             jnp.arange(1, pad_r + 1))
        return jnp.concatenate([left, pk_ells, right], axis=-1)

    # ------------------------------------------------------------------
    # Main transform
    # ------------------------------------------------------------------
    def compute_pk_ells(self, pk):
        """P(k, mu_k) -> multipoles (n_ell, n_k) (reference: pktoxi.py:79-97)."""
        from .power_spectrum import FactoredPk
        if isinstance(pk, FactoredPk):
            pk = pk.dense()
        return self.legendre_proj @ pk

    def compute(self, r_grid, mu_grid, pk, single_ell=-1,
                coords_param_free=False):
        """Full transform to xi on the (traced) r/mu grids; returns
        (xi, oob_flag) (reference: pktoxi.py:99-163).

        The reference's VegaBoundsError on out-of-range interpolation
        becomes the oob flag here.

        A FactoredPk input pushes the (linear) projection + FFTLog +
        spline-solve operators through its static basis grids, so under
        vmap the grid-sized work runs once per batch and each evaluation
        is a (n_t) x (n_t, n_ell, n_r) contraction. When the rescaled
        coordinates are additionally parameter-independent (ap/at/drp
        not sampled) the spline + Legendre(mu) evaluation is linear too
        and the result stays factored (FactoredXi): the per-evaluation
        work downstream collapses entirely onto the coefficients (see
        vega_tpu/factored.py).
        """
        from .factored import FactoredXi
        from .power_spectrum import FactoredPk
        if isinstance(pk, FactoredPk) and self._extrap_geom is not None:
            # the power-law continuation is non-linear in P — no
            # factored form through an extrapolated transform
            pk = pk.dense()
        if isinstance(pk, FactoredPk):
            basis = jnp.stack(pk.bases)                    # (t, muk, k)
            pk_ells_t = jnp.einsum('lm,tmk->tlk',
                                   jnp.asarray(self.legendre_proj), basis)
            knots_t = jnp.einsum('lij,tlj->tli',
                                 resolve(self.fft_ops), pk_ells_t)
            mknots_t = jnp.einsum('lij,tlj->tli',
                                  resolve(self.fft_sd_ops), pk_ells_t)

            # coords_param_free comes from the caller's parameter
            # classification (NOT from tracer-ness of r_grid: under
            # omnistaging every in-trace array is a tracer even when it
            # is parameter-independent)
            if single_ell < 0 and coords_param_free:
                mask = r_grid != 0
                safe_r = jnp.where(mask, r_grid, 1.0)
                log_r = jnp.log(safe_r)
                vals, oob = spline_eval(self.logr_knots, knots_t,
                                        mknots_t, log_r)   # (t, l, n)
                legendre_mu = jnp.stack([legendre(ell, mu_grid)
                                         for ell in self.ell_vals])
                rows = jnp.einsum('tln,ln->tn', vals, legendre_mu)
                rows = jnp.where(mask[None, :], rows, 0.0)
                oob_any = jnp.any(jnp.reshape(oob, mask.shape) & mask)
                return FactoredXi(pk.coeffs, rows), oob_any

            theta = jnp.stack(pk.coeffs)                   # (t,)
            xi_knots = jnp.einsum('t,tli->li', theta, knots_t)
            m_knots = jnp.einsum('t,tli->li', theta, mknots_t)
        else:
            pk_ells = self.legendre_proj @ pk              # (n_ell, n_k)
            if self._extrap_geom is not None:
                pk_ells = self._extrap_pad(pk_ells)        # (n_ell, n_fft)
            xi_knots = jnp.einsum('lij,lj->li',
                                  resolve(self.fft_ops), pk_ells)
            m_knots = jnp.einsum('lij,lj->li',
                                 resolve(self.fft_sd_ops), pk_ells)

        mask = r_grid != 0
        safe_r = jnp.where(mask, r_grid, 1.0)
        log_r = jnp.log(safe_r)

        if not single_ell < 0:
            li = list(self.ell_vals).index(int(single_ell))
            vals, oob = spline_eval(self.logr_knots, xi_knots[li],
                                    m_knots[li], log_r)
            xi = jnp.where(mask, vals, 0.0)
            return xi, jnp.any(oob & mask)

        legendre_mu = jnp.stack([legendre(ell, mu_grid)
                                 for ell in self.ell_vals])
        vals, oob = spline_eval(self.logr_knots, xi_knots[:, None, :],
                                m_knots[:, None, :], log_r[None, :])
        vals = vals[:, 0, :]                                    # (n_ell, n_r)
        xi = jnp.sum(vals * legendre_mu, axis=0)
        xi = jnp.where(mask, xi, 0.0)
        return xi, jnp.any(oob[0] & mask)

    # ------------------------------------------------------------------
    # Legacy FFTLog (Hamilton 2000 conventions of the reference's Pk2Mp,
    # pktoxi.py:230-279) — used by the relativistic / asymmetry terms and
    # by the old_fftlog compatibility mode.
    # ------------------------------------------------------------------
    def _build_legacy_operators(self, ell_vals, n_exp, project_scale):
        """Dense operators for the legacy transform (see
        _hamilton_operators)."""
        return _hamilton_operators(self.k_grid, tuple(ell_vals),
                                   n_exp, project_scale)

    def _legacy_eval(self, ops, logr_knots, sd_ops, spectra, r_grid):
        log_r = jnp.log(jnp.where(r_grid != 0, r_grid, 1.0))
        xi_knots = jnp.einsum('lij,lj->li', ops, spectra)
        m_knots = jnp.einsum('lij,lj->li', sd_ops, spectra)
        vals, _ = spline_eval(logr_knots, xi_knots[:, None, :],
                              m_knots[:, None, :], log_r[None, :])
        return vals[:, 0, :]

    def _get_legacy_ops(self, ell_vals, n_exp, project_scale=False):
        key = (self.k_grid.tobytes(), ell_vals, n_exp, project_scale)
        if key not in _LEGACY_OPERATOR_CACHE:
            ops, logr = self._build_legacy_operators(
                ell_vals, n_exp=n_exp, project_scale=project_scale)
            s_mat = notaknot_second_derivative_matrix(logr)
            _LEGACY_OPERATOR_CACHE[key] = (
                ops, logr, np.einsum('ij,ljk->lik', s_mat, ops))
        return _LEGACY_OPERATOR_CACHE[key]

    def _get_rel_ops(self):
        return self._get_legacy_ops((1, 3), 1)

    def _get_asy_ops(self):
        return self._get_legacy_ops((0, 2), 2)

    def pk_to_xi_relativistic(self, r_grid, mu_grid, pk, params):
        """Relativistic dipole + octupole (Bonvin et al. 2014)
        (reference: pktoxi.py:321-350)."""
        ops, logr, sd_ops = self._get_rel_ops()
        spectra = jnp.stack([jnp.asarray(pk), jnp.asarray(pk)])
        vals = self._legacy_eval(ops, logr, sd_ops, spectra, r_grid)
        xi_rel = (params['Arel1'] * vals[0] * legendre(1, mu_grid)
                  + params['Arel3'] * vals[1] * legendre(3, mu_grid))
        return xi_rel

    def pk_to_xi_asymmetry(self, r_grid, mu_grid, pk, params):
        """Standard asymmetry (Bonvin et al. 2014)
        (reference: pktoxi.py:352-382)."""
        ops, logr, sd_ops = self._get_asy_ops()
        spectra = jnp.stack([jnp.asarray(pk), jnp.asarray(pk)])
        vals = self._legacy_eval(ops, logr, sd_ops, spectra, r_grid)
        xi_asy = ((params['Aasy0'] * vals[0] - params['Aasy2'] * vals[1])
                  * r_grid * legendre(1, mu_grid))
        xi_asy += params['Aasy3'] * vals[1] * r_grid * legendre(3, mu_grid)
        return xi_asy

    # ------------------------------------------------------------------
    # Reference-named drop-in surface. The reference keeps three extra
    # public entry points (pktoxi.py:166-319): the cached per-multipole
    # interpolator split (compute_xi_ell / compute_xi) and the outdated
    # Hamilton-2000 path (Pk2Mp / pk_to_xi). Here they are host-facing
    # views over the dense operators; no caching (recompute is free).
    # ------------------------------------------------------------------
    def compute_xi_ell(self, pk, ell_vals, *cache_pars):
        """Per-multipole Xi_ell(log r) evaluators (reference:
        pktoxi.py:166-193). *cache_pars are accepted for signature
        compatibility and ignored."""
        del cache_pars
        pk_ells = self.legendre_proj @ jnp.asarray(pk)
        if self._extrap_geom is not None:
            pk_ells = self._extrap_pad(pk_ells)
        xi_knots = np.asarray(jnp.einsum('lij,lj->li',
                                         resolve(self.fft_ops), pk_ells))
        m_knots = np.asarray(jnp.einsum('lij,lj->li',
                                        resolve(self.fft_sd_ops), pk_ells))
        logr = self.logr_knots
        out = {}
        for i, ell in enumerate(self.ell_vals):
            if ell not in ell_vals:
                continue

            def interp(log_r_query, _k=xi_knots[i], _m=m_knots[i]):
                q = np.atleast_1d(np.asarray(log_r_query, dtype=float))
                vals, oob = spline_eval(logr, _k[None, None, :],
                                        _m[None, None, :], q[None, :])
                if bool(np.any(np.asarray(oob))):
                    from .utils import VegaBoundsError
                    raise VegaBoundsError(
                        'Xi_ell interpolation out of range.')
                return np.asarray(vals)[0, 0]

            out[ell] = interp
        return out

    def compute_xi(self, xi_ell_interp, r_grid, mu_grid):
        """Sum the interpolated multipoles times P_ell(mu) (reference:
        pktoxi.py:195-228)."""
        r_grid = np.asarray(r_grid)
        mask = r_grid != 0
        full_xi = np.zeros(len(r_grid))
        for ell, interp in xi_ell_interp.items():
            xi_ell = np.zeros(len(r_grid))
            xi_ell[mask] = interp(np.log(r_grid[mask]))
            full_xi += xi_ell * np.asarray(
                legendre(ell, jnp.asarray(mu_grid)))
        return full_xi

    @staticmethod
    def Pk2Mp(ar, k, pk, ell_vals, muk, dmuk, tform=None):
        """Outdated reference API (pktoxi.py:230-279): Hamilton-2000
        FFTLog multipole transform, served by the same dense legacy
        operators as the relativistic/asymmetry terms. Returns a numpy
        (n_ell, len(ar)) array indexed by ell//2 like the reference."""
        k = np.asarray(k, dtype=np.float64)
        ell_vals = tuple(int(e) for e in ell_vals)
        n_exp = 1 if tform == 'rel' else 2
        project = tform not in ('rel', 'asy')
        ops, logr = _hamilton_operators(k, ell_vals, n_exp=n_exp,
                                        project_scale=project)
        s_mat = notaknot_second_derivative_matrix(logr)
        sd_ops = np.einsum('ij,ljk->lik', s_mat, ops)
        log_ar = np.log(np.asarray(ar, dtype=float))
        muk = np.asarray(muk)
        xi = np.zeros((len(ell_vals), len(log_ar)))
        for i, ell in enumerate(ell_vals):
            if project:
                spec = np.sum(dmuk * np.polyval(LEGENDRE_COEFFS[ell], muk)
                              * pk, axis=0) * (2 * ell + 1)
            else:
                spec = np.asarray(pk, dtype=float)
            knots = ops[i] @ spec
            m = sd_ops[i] @ spec
            vals, _ = spline_eval(logr, knots[None, None, :],
                                  m[None, None, :], log_ar[None, :])
            xi[ell // 2] = np.asarray(vals)[0, 0]
        return xi

    def pk_to_xi(self, r_grid, mu_grid, pk, multipole=-1):
        """Outdated reference API (pktoxi.py:281-319): full correlation
        via the Hamilton-2000 conventions."""
        ell_vals = self.ell_vals
        if not multipole < 0:
            ell_vals = (int(multipole),)
        ops, logr, sd_ops = self._get_legacy_ops(ell_vals, n_exp=2,
                                                 project_scale=True)
        proj = np.stack([np.polyval(LEGENDRE_COEFFS[ell], self.muk_grid.ravel())
                         * self.muk_weights * (2 * ell + 1)
                         for ell in ell_vals])
        pk_ells = proj @ jnp.asarray(pk)
        vals = self._legacy_eval(ops, logr, sd_ops, pk_ells, r_grid)
        if not multipole < 0:
            return vals[0]
        legendre_mu = jnp.stack([legendre(ell, mu_grid)
                                 for ell in ell_vals])
        return jnp.sum(vals * legendre_mu, axis=0)
