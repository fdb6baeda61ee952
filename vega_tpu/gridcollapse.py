"""Grid collapse: the factored quadratic form as a function of the
nonlinear scale parameters.

The basis collapse (vega_tpu/factored.py, VegaInterface.get_collapsed)
removes all grid-sized work from the per-evaluation chi^2 graph whenever
the sampled parameters enter the model only through scalar coefficients.
Sampling (alpha_par, alpha_perp) — the BAO regime — breaks that: the AP
rescaling moves the spline evaluation points of the Pk->xi transform
(reference: correlation_func.py:200-236), so the basis rows themselves
become functions of a small set of "grid parameters" g (ap/at or any
other scale parametrisation, drp_* shifts).

This module extends the collapse to that regime. The model stays LINEAR
in the coefficient vector c; only the basis moves with g:

    xi(c, g)   = c @ V(g)
    chi2(c, g) = d'Ci d - 2 c.(V(g) Ci d) + c.(V(g) Ci V(g)') c
               = s(g) - 2 dc.y(g) + dc.A(g) dc          (centered on c0)

with A(g) = V Ci V' (T, T), y(g) = V Ci d - A c0, s(g) = chi2(c0, g) —
all smooth functions of the one-to-three grid parameters. The collapse
sweep evaluates them EXACTLY at a tensor grid of Chebyshev-Gauss nodes
(one vmapped run of the standard collapse graph under a `grid_trace`
context, so the factored classification treats the node tracers as
row-safe), Chebyshev-transforms the node tensors, and compresses the
(coefficient, payload) matrix with an SVD — as TWO independent blocks:
the A block (curvature tensors, uniform magnitude over the domain,
~97% of the columns) and the sy block (centered linear term + value,
whose norms are set by the domain-EDGE chi^2). Each likelihood
evaluation then costs:

    t_d   = Chebyshev values of the normalized g_d      (sum(Q_d) flops)
    psi_b = prod_d t_d[modes_b[d]]  per block b         (M kept modes)
    p_b   = (psi_b @ B_b) @ F_b                         (M x R, R x cols)
    chi2  = s - 2 dc.y + dc.(A dc)                      (T^2)

all in f64, with M the number of RETAINED tensor-product Chebyshev
modes after the error-budgeted truncation (see build_grid_payload: the
transformed spectrum decays fast, so M is a few hundred even when
prod(Q_d) = 4096)

— a few hundred kFLOP instead of the ~73 MFLOP dense path (spline +
distortion matmul + masked-covariance quadratic form per evaluation),
putting the BAO-sampled regime on the same footing as the nuisance-only
collapse. Values match the dense pipeline to the Chebyshev interpolation
error, measured by tests/test_grid_collapse.py and reported in
docs/performance.md; outside the node domain the evaluation returns the
chi^2 = 1e100 penalty (the same semantics as the reference's
VegaBoundsError for out-of-range interpolation).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
from jax.tree_util import register_pytree_node_class


# Sampled parameters that move basis rows instead of coefficients
# (reference: scale_parameters.py:12-230 for the alpha parametrisations,
# correlation_func.py:64-69 for drp). Everything else that breaks the
# factored classification (sigma NL, HCD scales, smoothings...) can be
# designated explicitly via [control] grid-params.
ALPHA_LIKE = {
    'ap', 'at', 'aiso', 'epsilon', 'phi', 'alpha',
    'ap_full', 'at_full', 'aiso_full', 'epsilon_full',
    'phi_full', 'alpha_full', 'phi_smooth', 'alpha_smooth',
}


def is_known_grid_param(name):
    # sigma_velo_disp_* (QSO velocity-dispersion damping, reference
    # power_spectrum.py:588-636) is sampled in the reference's own
    # DR16 combined fit (examples/eBOSS_DR16/main_combined.ini) and
    # enters the model nonlinearly through the Pk damping — a smooth
    # one-dimensional factor, ideal Chebyshev material, so it is grid-
    # served by default rather than pushing the crosses onto the dense
    # path.
    return (name in ALPHA_LIKE or name.startswith('alpha_smooth_')
            or name.startswith('drp_')
            or name.startswith('sigma_velo_disp_'))


@register_pytree_node_class
class GridSpec:
    """Static description of the node grid: parameter names, domains,
    per-dimension node counts and the reference values substituted into
    the coefficient trace. Everything lives in pytree aux_data, so the
    spec rides through jit as (hashable) structure, not as arrays."""

    def __init__(self, names, lo, hi, degrees, ref):
        self.names = tuple(names)
        self.lo = tuple(float(v) for v in lo)
        self.hi = tuple(float(v) for v in hi)
        self.degrees = tuple(int(d) for d in degrees)
        self.ref = tuple(float(v) for v in ref)

    @property
    def n_nodes(self):
        return int(np.prod(self.degrees))

    def tree_flatten(self):
        return (), (self.names, self.lo, self.hi, self.degrees, self.ref)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*aux)

    def __repr__(self):
        dims = ', '.join(
            f'{n}: [{lo:.4g}, {hi:.4g}] x{d}'
            for n, lo, hi, d in zip(self.names, self.lo, self.hi,
                                    self.degrees))
        return f'GridSpec({dims})'


# --------------------------------------------------------------------------
# Chebyshev machinery (host side)
# --------------------------------------------------------------------------
def cheb_nodes(n):
    """Chebyshev-Gauss points on (-1, 1), ascending."""
    k = np.arange(n)
    return np.sort(np.cos((2 * k + 1) * np.pi / (2 * n)))


def cheb_transform_matrix(n):
    """(n, n) matrix M with a = M @ f mapping values at `cheb_nodes(n)`
    to Chebyshev coefficients (exact for polynomials of degree < n)."""
    x = cheb_nodes(n)
    theta = np.arccos(x)
    k = np.arange(n)[:, None]
    mat = np.cos(k * theta[None, :]) * (2.0 / n)
    mat[0] *= 0.5
    return mat


def cheb_values(x, n):
    """T_0(x) .. T_{n-1}(x) by the three-term recurrence (traceable)."""
    vals = [jnp.ones_like(x), x]
    for _ in range(2, n):
        vals.append(2 * x * vals[-1] - vals[-2])
    return jnp.stack(vals[:n])


# --------------------------------------------------------------------------
# Per-evaluation graph helpers (traceable)
# --------------------------------------------------------------------------
# chi^2 wall strength outside the node domain, per unit of squared
# normalized excess (half-domain-widths). Chosen so the wall dwarfs any
# physical chi^2 within ~1% of a domain width while staying FINITE and
# smooth: a hard 1e100 penalty destroys Wolfe line searches (the first
# L-BFGS trial step often lands outside the domain and the interpolating
# line search diverges on the cliff), whereas the quadratic wall pushes
# optimizers back inside. The dense pipeline's out-of-bounds points keep
# the reference's 1e100 semantics — only the grid-domain boundary is
# softened, and only because it is an artifact of the node domain, not
# of the model.
GRID_WALL_CHI2 = 1e8


def grid_tvecs(spec, sample_params):
    """Per-dimension Chebyshev basis values for one evaluation point.

    Returns (tvecs, excess): tvecs is a tuple of per-dimension value
    vectors T_0..T_{deg-1} evaluated at the domain-clamped normalized
    point; excess is the summed squared normalized distance outside the
    domain (0 inside), which the chi^2 graph turns into the smooth
    GRID_WALL_CHI2 boundary wall. The full tensor basis is never
    materialized per evaluation — each correlation gathers only its
    retained modes (psi_from_modes), so the per-eval basis cost is
    O(sum(deg) + n_kept_modes) instead of O(prod(deg)).
    """
    tvecs = []
    excess = jnp.asarray(0.0)
    for name, lo, hi, deg in zip(spec.names, spec.lo, spec.hi,
                                 spec.degrees):
        x = (2.0 * sample_params[name] - (lo + hi)) / (hi - lo)
        excess = excess + jnp.maximum(jnp.abs(x) - 1.0, 0.0) ** 2
        tvecs.append(cheb_values(jnp.clip(x, -1.0, 1.0), deg))
    return tuple(tvecs), excess


def psi_from_modes(tvecs, modes):
    """Tensor-basis values of the retained Chebyshev modes.

    modes is an int32 (D, M) array of per-dimension mode indices
    (unraveled rows of the node tensor); returns the (M,) vector
    psi_m = prod_d T_{modes[d, m]}(x_d) — D gathers of M elements each
    instead of the N = prod(deg) outer-product kron.
    """
    psi = tvecs[0][modes[0]]
    for d in range(1, len(tvecs)):
        psi = psi * tvecs[d][modes[d]]
    return psi


def grid_corr_chi2(corr_payload, tvecs, coeffs):
    """chi^2 contribution of one correlation from its grid payload.

    The payload is stored as two independently mode-truncated and
    SVD-compressed blocks (see build_grid_payload): the A block (the
    t x t curvature tensors, uniform magnitude over the domain) and
    the sy block (the centered linear term y and value s, whose norms
    are set by the domain-edge chi^2). Both contract in the working
    precision (f64 by default).
    """
    c_ref = corr_payload['cref']
    t = c_ref.shape[0]
    dc = coeffs - c_ref
    psi_a = psi_from_modes(tvecs, corr_payload['modes_A'])
    p_a = (psi_a @ corr_payload['B_A']) @ corr_payload['F_A']
    psi_sy = psi_from_modes(tvecs, corr_payload['modes_sy'])
    p_sy = (psi_sy @ corr_payload['B_sy']) @ corr_payload['F_sy']
    a_mat = p_a.reshape(t, t)
    y = p_sy[:t]
    s = p_sy[t]
    return s - 2.0 * (dc @ y) + dc @ (a_mat @ dc)


# --------------------------------------------------------------------------
# Payload disk cache
# --------------------------------------------------------------------------
# Bump when the payload format or the sweep semantics change.
PAYLOAD_CACHE_VERSION = 3


def payload_fingerprint(vega, sample_names, spec, mode_budget, svd_tol,
                        components=None, extra=None):
    """Content hash of everything the grid payload depends on: the full
    resolved configuration, the external array content the config only
    names by path (fiducial Pk template, distortion matrices, metal
    matrices and their coordinate grids — so swapping a file's content
    at the same path invalidates the cache), the active data vectors and
    masked inverse covariances, ALL current parameter values (the node
    sweep bakes every non-sampled parameter into the payload via the
    local-param resolution, not just the sampled ones), the
    float-precision mode, the node spec, and the truncation/compression
    knobs. Deliberately NOT hashed: the process-global statics registry,
    which would make the fingerprint depend on unrelated interfaces
    built earlier in the same process.

    A matching fingerprint implies a bit-identical payload (the sweep is
    deterministic), so sampler / scan / MC driver processes of the same
    fit skip the one-time node sweep entirely (~200 s at the shipped
    32x32 default on a 1-core host) and go straight to compile."""
    import hashlib
    import io

    import jax

    h = hashlib.blake2b(digest_size=20)
    h.update(str(PAYLOAD_CACHE_VERSION).encode())

    def eat(label, arr):
        h.update(label.encode())
        arr = np.ascontiguousarray(arr)
        h.update(repr((arr.shape, str(arr.dtype))).encode())
        h.update(arr.tobytes())

    buf = io.StringIO()
    vega.main_config.write(buf)
    for name, item in sorted(vega.corr_items.items()):
        buf.write(f'[[{name}]]\n')
        item.config.write(buf)
    h.update(buf.getvalue().encode())

    # File-backed model constants (content, not path).
    for key in sorted(vega.fiducial):
        val = vega.fiducial[key]
        if isinstance(val, np.ndarray):
            eat(f'fid:{key}', val)
        else:
            h.update(f'fid:{key}={val!r}'.encode())

    for name, vec in sorted(vega._current_data_vecs().items()):
        h.update(name.encode())
        h.update(np.ascontiguousarray(vec).tobytes())
        h.update(np.ascontiguousarray(
            vega.data[name].inv_masked_cov).tobytes())
        corr_data = vega.data[name]
        if corr_data.has_distortion:
            eat(f'{name}:dmat', corr_data.distortion_mat)
        for pair, mat in sorted(getattr(corr_data, 'metal_mats',
                                        {}).items()):
            if mat is not None:
                eat(f'{name}:met:{pair}', mat)
        for pair, coords in sorted(getattr(corr_data, 'metal_coordinates',
                                           {}).items()):
            eat(f'{name}:metrp:{pair}', coords.rp_grid)
            eat(f'{name}:metrt:{pair}', coords.rt_grid)
            eat(f'{name}:metz:{pair}', coords.z_grid)

    # The sweep resolves EVERY parameter through _get_lcl_prms, so a
    # programmatically mutated non-sampled parameter (e.g.
    # vega.params['sigmaNL_par'] = ...) changes the payload: hash them
    # all, not just the sampled names.
    for name in sorted(vega.params):
        h.update(f'{name}={vega.params[name]!r}'.encode())
    # f32-mode payloads must never serve an f64 run (or vice versa).
    h.update(f'x64={bool(jax.config.jax_enable_x64)}'.encode())
    h.update(repr((spec.names, spec.lo, spec.hi, spec.degrees,
                   spec.ref)).encode())
    h.update(repr((float(mode_budget), float(svd_tol),
                   os.environ.get('VEGA_TPU_GRID_PROBES', '512'),
                   os.environ.get('VEGA_TPU_GRID_DC_DRAWS', '256'))).encode())
    # node-grid schedule (combination components + validation probes):
    # a different schedule is a different payload
    if components is None:
        components = plan_components(spec)
    h.update(repr((tuple(components),
                   os.environ.get('VEGA_TPU_GRID_VALIDATE', ''))).encode())
    # caller-supplied extra content (e.g. post-init-mutated sampling
    # limits, which reach the payload through measure_dc_max); None —
    # the common case — hashes nothing, keeping existing entries valid
    if extra is not None:
        h.update(repr(extra).encode())
    return h.hexdigest()


def payload_cache_dir():
    """None when caching is disabled (VEGA_TPU_GRID_CACHE=0)."""
    if os.environ.get('VEGA_TPU_GRID_CACHE', '1') != '1':
        return None
    return os.environ.get(
        'VEGA_TPU_GRID_CACHE_DIR',
        os.path.expanduser('~/.cache/vega_tpu_grid'))


def save_payload(path, payload):
    spec = payload['__grid__']
    arrays = {'__spec__': np.array(
        repr((spec.names, spec.lo, spec.hi, spec.degrees, spec.ref)))}
    for name, corr in payload.items():
        if name == '__grid__':
            continue
        for part, arr in corr.items():
            arrays[f'{name}::{part}'] = arr
    tmp = f'{path}.{os.getpid()}.tmp'
    with open(tmp, 'wb') as fh:
        np.savez(fh, **arrays)          # file object: no suffix magic
    os.replace(tmp, path)


def load_payload(path):
    from ast import literal_eval
    with np.load(path) as data:
        names, lo, hi, degrees, ref = literal_eval(
            str(data['__spec__']))
        payload = {'__grid__': GridSpec(names, lo, hi, degrees, ref)}
        for key in data.files:
            if key == '__spec__':
                continue
            name, part = key.split('::', 1)
            payload.setdefault(name, {})[part] = data[key]
    return payload


def _mode_probe_psi(spec, modes, n_probe, rng):
    """(n_probe, M) tensor-product Chebyshev basis values of the given
    ``modes`` ((D, M) per-dimension indices) at a uniform probe cloud
    over the normalized domain (host numpy). Built per present mode
    rather than per full-tensor node so sparse (combination-technique)
    mode sets never materialize the prod(degrees) tensor."""
    psi = np.ones((n_probe, modes.shape[1]))
    for d, deg in enumerate(spec.degrees):
        x = rng.uniform(-1.0, 1.0, size=n_probe)
        tv = np.empty((n_probe, deg))
        tv[:, 0] = 1.0
        if deg > 1:
            tv[:, 1] = x
        for k in range(2, deg):
            tv[:, k] = 2.0 * x * tv[:, k - 1] - tv[:, k - 2]
        psi *= tv[:, modes[d]]
    return psi


def _budgeted_cut(weight, sens_cols, psi, err_of_delta, budget):
    """Smallest weight-ranked retained set whose measured interpolant
    error at the probe cloud stays within ``budget``. Returns indices
    into the rows of ``sens_cols`` (ascending)."""
    n = weight.shape[0]
    order = np.argsort(-weight)                 # strongest first

    def max_err(n_keep):
        dropped = order[n_keep:]
        if dropped.size == 0:
            return 0.0
        return err_of_delta(psi[:, dropped] @ sens_cols[dropped])

    lo, hi = 1, n
    while lo < hi:
        mid = (lo + hi) // 2
        if max_err(mid) <= budget:
            hi = mid
        else:
            lo = mid + 1
    return np.sort(order[:lo])


def select_payload_modes(coef, t, spec, mode_budget, dc_max, modes=None):
    """Retained-mode row indices for the two payload blocks of one
    correlation's Chebyshev coefficient matrix ``coef``
    ((n_modes_present, t*t + t + 1), columns ordered [A, y, s]).

    Returns (kept_A, kept_sy): ascending indices into the ROWS of
    ``coef`` for the A block (curvature tensors) and the sy block
    (centered linear term + value), truncated independently — the two
    blocks are stored, compressed and contracted separately
    (grid_corr_chi2).

    Modes are ranked by payload weight and each cutoff is VALIDATED:
    the smallest retained set whose measured pointwise interpolant
    error at a uniform probe cloud stays within half of ``mode_budget``
    per block, where the error at a probe x bounds the chi^2 error
    UNCONDITIONALLY over the coefficient range a sampler can reach:

        |delta chi2(x)| <= |ds(x)| + 2 dc_max ||dy(x)||
                           + dc_max^2 ||dA(x)||_F

    with ``dc_max`` the measured bound on ||c(theta) - c0|| over the
    sampling box (measure_dc_max; floored at 1 so the bound is never
    weaker than the legacy unit-ball criterion). The Frobenius norm is
    estimated via a Johnson-Lindenstrauss sketch. On payloads whose
    spectrum has a coherent tail (e.g. near-noiseless data where the
    domain-corner chi^2 reaches 1e8) this keeps everything — the
    budget is honored, not assumed.

    ``modes``: optional (D, n_modes_present) per-dimension mode indices
    of the coef rows (defaults to the full tensor in C order).
    """
    n_present = coef.shape[0]
    if modes is None:
        modes = np.stack(np.unravel_index(
            np.arange(n_present), spec.degrees)).astype(np.int32)
    if mode_budget <= 0 or n_present <= 1:
        idx = np.arange(n_present)
        return idx, idx

    n_probe = int(os.environ.get('VEGA_TPU_GRID_PROBES', 512))
    rng = np.random.default_rng(20260819)
    psi = _mode_probe_psi(spec, modes, n_probe, rng)

    a_coef = coef[:, :t * t]
    y_coef = coef[:, t * t:t * t + t]
    s_coef = coef[:, t * t + t]
    half = 0.5 * mode_budget

    # A block: err(x) = dc_max^2 ||dA(x)||_F (JL sketch)
    n_sketch = min(16, t * t)
    sketch = rng.normal(size=(t * t, n_sketch)) / np.sqrt(n_sketch)
    sens_a = dc_max ** 2 * (a_coef @ sketch)
    kept_a = _budgeted_cut(
        np.linalg.norm(sens_a, axis=1), sens_a, psi,
        lambda delta: float(np.linalg.norm(delta, axis=1).max()), half)

    # sy block: err(x) = |ds(x)| + 2 dc_max ||dy(x)||
    sens_sy = np.concatenate(
        [s_coef[:, None], 2.0 * dc_max * y_coef], axis=1)
    kept_sy = _budgeted_cut(
        np.abs(s_coef) + 2.0 * dc_max * np.linalg.norm(y_coef, axis=1),
        sens_sy, psi,
        lambda delta: float((np.abs(delta[:, 0])
                             + np.linalg.norm(delta[:, 1:], axis=1)).max()),
        half)
    return kept_a, kept_sy


def measure_dc_max(vega, sample_names, spec, c0s):
    """Measured bound on ||c(theta) - c0||_2 per correlation over the
    box a sampler can visit.

    The mode-truncation chi^2 budget (select_payload_modes) bounds
    |delta chi2| by |ds| + 2 dc_max ||dy|| + dc_max^2 ||dA||_F, so it
    is only as unconditional as the dc_max it uses. This measures the
    actual coefficient range: the coefficient vectors c(theta) are
    evaluated (one tiny vmapped host graph — the basis work is dead
    code and XLA eliminates it) at the corners and at uniform draws of
    the SAMPLING LIMITS of every non-grid sampled parameter (grid
    parameters pinned at the spec reference — the sweep's structural
    out_axes=None proof guarantees c does not depend on them), and the
    observed max ||c - c0|| is inflated by a 1.25 safety margin and
    floored at 1.0 so the budget is never weaker than the legacy
    |dc| <= 1 criterion. Parameters sampled without finite limits stay
    pinned at their current values (and are reported in the returned
    note).

    Returns (dc_max: {corr: float}, note: str describing the probe
    set)."""
    import jax
    from .factored import grid_trace
    from .statics import STATICS

    base = {}
    varying = []
    for name in sorted(sample_names):
        if name in spec.names:
            continue
        base[name] = float(vega.params.get(name, 0.0))
        limits = vega.sample_params['limits'].get(name)
        if limits is not None and limits[0] is not None \
                and limits[1] is not None:
            varying.append((name, float(limits[0]), float(limits[1])))
    for name, ref in zip(spec.names, spec.ref):
        base[name] = float(ref)

    n_draws = int(os.environ.get('VEGA_TPU_GRID_DC_DRAWS', 256))
    rng = np.random.default_rng(20260820)
    n_var = len(varying)
    if n_var == 0 or n_draws <= 0:
        return ({name: 1.0 for name in c0s},
                'no finite-limit non-grid sampled parameters varied')

    # corners (exact box vertices; subsampled beyond 2^8) + uniform
    if n_var <= 8:
        corners = np.stack(np.meshgrid(
            *[[lo, hi] for _, lo, hi in varying],
            indexing='ij')).reshape(n_var, -1).T
    else:
        corners = np.where(
            rng.integers(0, 2, size=(256, n_var)).astype(bool),
            np.array([hi for _, _, hi in varying]),
            np.array([lo for _, lo, _ in varying]))
    uniform = np.stack(
        [rng.uniform(lo, hi, size=n_draws) for _, lo, hi in varying],
        axis=-1)
    draws = np.concatenate([corners, uniform])              # (P, n_var)

    batch = {name: jnp.full(draws.shape[0], val)
             for name, val in base.items()}
    for i, (name, _, _) in enumerate(varying):
        batch[name] = jnp.asarray(draws[:, i])

    dummy_data = {name: np.zeros_like(np.asarray(v))
                  for name, v in vega._current_data_vecs().items()}

    def coeff_fn(sp, dvecs, statics):
        # mirror the sweep's trace exactly (grid_trace context) so the
        # factored term structure — and hence the coefficient layout —
        # matches the c0 produced by the node sweep
        with STATICS.bind(statics), grid_trace(spec.names):
            _, cs, _bad = vega._grid_collapse_node(sp, dvecs)
        return cs

    fn = jax.jit(jax.vmap(coeff_fn, in_axes=(0, None, None)))
    cs = fn(batch, dummy_data, STATICS.device_tree())

    out = {}
    for name, c0 in c0s.items():
        c = np.asarray(cs[name])
        measured = float(np.linalg.norm(c - c0[None, :], axis=1).max())
        out[name] = max(1.0, 1.25 * measured)
    note = (f'{corners.shape[0]} corners + {n_draws} uniform draws over '
            + ', '.join(f'{n} in [{lo:g}, {hi:g}]' for n, lo, hi in varying))
    return out, note


# --------------------------------------------------------------------------
# Anisotropic combination technique (3+ grid dimensions)
# --------------------------------------------------------------------------
def _level_degrees(full):
    """Per-dimension degree ladder for the combination levels
    (0, 1, 2) -> (1, mid, full). Level 0 is the single midpoint node
    (a constant interpolant), level 1 roughly half resolution, level 2
    the full configured degree."""
    full = int(full)
    if full <= 2:
        return (1, full) if full == 2 else (1,)
    mid = max(2, (full + 1) // 2)
    if mid >= full:                                       # pragma: no cover
        mid = full - 1
    return (1, mid, full)


def plan_components(spec, mode='auto', order=3, max_tensor=None):
    """Node-grid components [(degrees_vec, coeff)] for the payload
    sweep.

    A full tensor of Chebyshev-Gauss nodes is exact but its sweep cost
    is prod(degrees) dense model evaluations — unaffordable beyond two
    or three wide dimensions (the full Table-6 BAO regime is FOUR:
    ap, at, drp_QSO, sigma_velo_disp_lorentz_QSO; reference
    examples/eBOSS_DR16/main_combined.ini [sample]). For >= 3
    dimensions past ``max_tensor`` total nodes this returns an
    anisotropic Smolyak/ANOVA COMBINATION schedule instead: tensor
    interpolants at mixed per-dimension levels (1 node, ~half degree,
    full degree), summed with the standard telescoping coefficients

        f  ~=  sum_l  c_l * f_l,
        c_l = sum_{z in {0,1}^d, l+z in I} (-1)^|z|,

    over a downward-closed level-index set I that keeps every PAIR of
    dimensions at full tensor resolution (the (ap, at) chi^2 ridge
    oscillates on the BAO scale along a diagonal, so joint high modes
    of pairs are physical) and caps >= ``order``-way interactions at
    the mid level (cross-group couplings — e.g. the sigma_velo damping
    mildly modulating the (ap, at) ridge — are smooth and small). Each
    f_l's Chebyshev coefficients embed exactly into the global tensor
    mode space, so the combination collapses into ONE sparse-mode
    payload served by the unchanged per-eval graph (psi_from_modes
    gathers arbitrary mode sets). Accuracy is then validated
    downstream: the mode truncation budget is measured on the combined
    coefficients, and build_grid_payload cross-checks the interpolant
    against the dense pipeline at probe points (grid-validate-probes).

    mode: 'auto' (combination when d >= 3 and the tensor exceeds
    max_tensor), 'always', or 'never' ([control] grid-combination).
    order: highest interaction order included (at mid resolution);
    pairs are always full ([control] grid-interaction-order).
    max_tensor: full-tensor node budget (env VEGA_TPU_GRID_MAX_TENSOR,
    default 4096).
    """
    import itertools

    if max_tensor is None:
        max_tensor = int(os.environ.get('VEGA_TPU_GRID_MAX_TENSOR', 4096))
    d = len(spec.degrees)
    use_comb = (mode == 'always'
                or (mode == 'auto' and d >= 3
                    and spec.n_nodes > int(max_tensor)))
    if mode == 'never' or not use_comb:
        return [(tuple(spec.degrees), 1.0)]

    ladders = [_level_degrees(f) for f in spec.degrees]
    tops = [len(lad) - 1 for lad in ladders]

    def member(lvl):
        if any(v > t for v, t in zip(lvl, tops)):
            return False
        n_active = sum(v > 0 for v in lvl)
        if n_active <= 2:
            return True
        return n_active <= order and max(lvl) <= 1

    index_set = {lvl for lvl in itertools.product(range(3), repeat=d)
                 if member(lvl)}
    components = []
    for lvl in sorted(index_set):
        coeff = 0.0
        for z in itertools.product((0, 1), repeat=d):
            up = tuple(a + b for a, b in zip(lvl, z))
            if up in index_set:
                coeff += (-1.0) ** sum(z)
        if coeff != 0.0:
            components.append(
                (tuple(ladders[i][v] for i, v in enumerate(lvl)), coeff))
    return components


def component_nodes(spec, degrees):
    """(prod(degrees), D) node coordinates of one tensor component in
    PARAMETER units (C order, first dimension outermost)."""
    axes = [0.5 * (lo + hi) + 0.5 * (hi - lo) * cheb_nodes(deg)
            for lo, hi, deg in zip(spec.lo, spec.hi, degrees)]
    mesh = np.meshgrid(*axes, indexing='ij')
    return np.stack([m.ravel() for m in mesh], axis=-1)


# --------------------------------------------------------------------------
# The node sweep (chunked, on the default device)
# --------------------------------------------------------------------------
def sweep_chunk_fn(vega, spec):
    """Jitted collapse of one chunk of grid nodes.

    fn(chunk, base, dvecs, statics) with chunk a (n, D) array of node
    coordinates in the order of ``spec.names``, base the non-grid
    sampled values, dvecs the masked data vectors and statics the
    statics tree; returns ({corr: {'A': (n, T, T), 'e': (n, T)}},
    {corr: c0}, bad (n,)). ``out_axes=None`` on the coefficient vectors
    is a structural proof that no coefficient depends on a grid
    parameter — vmap raises otherwise (the payload tensors would then be
    inconsistent across nodes)."""
    from .factored import grid_trace
    from .statics import STATICS

    def node_fn(gvals, base, dvecs, statics):
        sp = dict(base)
        for i, n in enumerate(spec.names):
            sp[n] = gvals[i]
        with STATICS.bind(statics), grid_trace(spec.names):
            return vega._grid_collapse_node(sp, dvecs)

    return jax.jit(jax.vmap(node_fn, in_axes=(0, None, None, None),
                            out_axes=(0, None, 0)))


def build_grid_payload(vega, sample_names, grid_names, spec,
                       sweep_chunk=None, svd_tol=None, mode_budget=None,
                       components=None, n_validate=None,
                       checkpoint_dir=None):
    """Run the collapse sweep over the node grid(s) and build the
    per-correlation payloads.

    Returns a dict {'__grid__': spec, corr_name: {'B_A', 'F_A',
    'modes_A', 'B_sy', 'F_sy', 'modes_sy', 'cref', 'dc_max',
    'probe_err'}} (numpy host arrays; callers ship them as jit
    arguments). Correlations whose model does not stay factored under
    the grid trace are absent — the chi^2 graph evaluates those densely
    with the true traced values.

    components: node-grid schedule from plan_components (default:
    plan_components(spec) with env defaults) — one full tensor, or the
    anisotropic combination for 3+ wide dimensions. All components are
    swept in ONE chunked vmapped run; their Chebyshev coefficients are
    accumulated (with the telescoping combination weights) into a
    single sparse tensor-mode set, so the per-evaluation graph is
    identical either way.

    n_validate: number of extra uniform-random interior points swept
    alongside the nodes and used to cross-check the FINAL payload
    (truncated + SVD-compressed interpolant) against the exact collapse
    tensors at those points — a direct, served-payload-vs-dense bound
    |ds| + 2 dc_max ||dy|| + dc_max^2 ||dA||_F on the chi^2 error,
    reported per correlation as 'probe_err'. Defaults to 8 whenever the
    combination (more than one component) is in play, else 0; env
    VEGA_TPU_GRID_VALIDATE. A probe error above 5x the mode budget
    prints a loud WARNING naming the knobs to raise.

    mode_budget: per-correlation ABSOLUTE chi^2 error budget for
    Chebyshev mode truncation (select_payload_modes). The transformed
    payload spectrum decays fast on realistic data (the quadratic form
    is smooth in the scale parameters), so most of the prod(degrees)
    tensor-product modes contribute nothing pointwise: modes are ranked
    by weight and the cutoff is chosen by VALIDATING the truncated
    interpolant against the full one at a probe cloud — scaled by the
    MEASURED coefficient range over the sampling box (measure_dc_max),
    so the budget holds unconditionally over the points a sampler can
    visit, not just the unit coefficient ball. This cuts the per-eval
    psi @ B contraction from prod(degrees) rows to the retained modes,
    making the wide production domain cheap per evaluation (see
    docs/performance.md for retained counts measured on the reference
    DR16-subset config). Default 2e-4 (env VEGA_TPU_GRID_MODE_BUDGET /
    [control] grid-mode-budget), subdominant to the ~4e-3
    node-convergence error; 0 disables truncation.

    checkpoint_dir: directory for per-chunk-group sweep checkpoints.
    Completed groups are written as part files and
    reloaded on retry, so an interrupted multi-hour combination sweep
    resumes where it stopped instead of starting over; the caller
    removes the directory once the final payload is persisted
    (VegaInterface.get_collapsed keys it by the payload fingerprint).
    """
    from .statics import STATICS

    if sweep_chunk is None:
        sweep_chunk = int(os.environ.get('VEGA_TPU_GRID_SWEEP_CHUNK', 32))
    if svd_tol is None:
        svd_tol = float(os.environ.get('VEGA_TPU_GRID_SVD_TOL', 1e-12))
    if mode_budget is None:
        mode_budget = float(os.environ.get(
            'VEGA_TPU_GRID_MODE_BUDGET', 2e-4))
    if components is None:
        components = plan_components(spec)
    if n_validate is None:
        n_validate = int(os.environ.get(
            'VEGA_TPU_GRID_VALIDATE',
            8 if len(components) > 1 else 0))

    vega._ensure_static_refs()

    # Node list: every component's tensor grid back to back, plus the
    # validation probes at the end (C order within each component).
    comp_blocks = [component_nodes(spec, degs) for degs, _ in components]
    comp_sizes = [b.shape[0] for b in comp_blocks]
    if n_validate > 0:
        rng_val = np.random.default_rng(20260821)
        val_nodes = np.stack(
            [rng_val.uniform(lo + 0.02 * (hi - lo), hi - 0.02 * (hi - lo),
                             size=n_validate)
             for lo, hi in zip(spec.lo, spec.hi)], axis=-1)
        comp_blocks.append(val_nodes)
    nodes = np.concatenate(comp_blocks, axis=0)            # (N, G)

    base_sampled = {name: float(vega.params.get(name, 0.0))
                    for name in sample_names}
    data_vecs = {name: np.asarray(v)
                 for name, v in vega._current_data_vecs().items()}

    corr_names = list(vega.corr_items)

    n_nodes = nodes.shape[0]
    pad = (-n_nodes) % sweep_chunk
    nodes_padded = np.pad(nodes, [(0, pad), (0, 0)], mode='edge')
    node_chunks = nodes_padded.reshape(-1, sweep_chunk, nodes.shape[1])

    # One jitted chunk, looped in Python: dispatch costs microseconds
    # against the chunk's compute, and the loop gives what a long sweep
    # (the 3+-dim combination schedules) needs — progress and
    # RESUMABILITY: completed chunk groups are checkpointed to
    # ``checkpoint_dir`` (keyed by the payload fingerprint, see
    # get_collapsed) and reloaded instead of re-swept on retry.
    import time
    one = sweep_chunk_fn(vega, spec)
    statics_tree = STATICS.device_tree()
    dvecs_device = jax.device_put(data_vecs)
    group = int(os.environ.get('VEGA_TPU_GRID_SWEEP_GROUP', 16))
    n_chunks = node_chunks.shape[0]
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)

    part_payloads, part_c0s, part_bad = [], [], []
    t0_sweep = time.time()
    swept_chunks = 0
    for g0 in range(0, n_chunks, group):
        g1 = min(g0 + group, n_chunks)
        part_path = None
        if checkpoint_dir is not None:
            part_path = os.path.join(
                checkpoint_dir,
                f'part_{g0:06d}_{g1 - g0}x{sweep_chunk}.npz')
        if part_path is not None and os.path.exists(part_path):
            with np.load(part_path) as z:
                pp = {}
                for k in z.files:
                    if k.startswith('p::'):
                        _, corr, piece = k.split('::')
                        pp.setdefault(corr, {})[piece] = z[k]
                part_payloads.append(pp)
                part_c0s.append({k[3:]: z[k] for k in z.files
                                 if k.startswith('c::')})
                part_bad.append(z['bad'])
            continue

        grp_p, grp_c, grp_b = [], [], []
        for ci in range(g0, g1):
            p, c, b = one(node_chunks[ci], base_sampled, dvecs_device,
                          statics_tree)
            grp_p.append(jax.tree_util.tree_map(np.asarray, p))
            grp_c.append({k: np.asarray(v) for k, v in c.items()})
            grp_b.append(np.asarray(b))
        pp = {corr: {piece: np.concatenate(
                  [g[corr][piece] for g in grp_p], axis=0)
              for piece in grp_p[0][corr]}
              for corr in grp_p[0]}
        cc = {k: np.stack([g[k] for g in grp_c]) for k in grp_c[0]}
        bb = np.concatenate(grp_b)
        part_payloads.append(pp)
        part_c0s.append(cc)
        part_bad.append(bb)
        if part_path is not None:
            arrays = {'bad': bb}
            for corr, pieces in pp.items():
                for piece, arr in pieces.items():
                    arrays[f'p::{corr}::{piece}'] = arr
            for corr, arr in cc.items():
                arrays[f'c::{corr}'] = arr
            tmp = f'{part_path}.{os.getpid()}.tmp'
            with open(tmp, 'wb') as fh:
                np.savez(fh, **arrays)  # file object: no suffix magic
            os.replace(tmp, part_path)
        # the ETA counts only chunks swept by this process, not ones
        # reloaded from checkpoints
        swept_chunks += g1 - g0
        elapsed = time.time() - t0_sweep
        per_chunk = elapsed / swept_chunks
        print(f'INFO: grid sweep {g1}/{n_chunks} chunks '
              f'({per_chunk:.2f} s/chunk, '
              f'~{per_chunk * (n_chunks - g1):.0f} s left)',
              file=sys.stderr)

    payload_nodes = {
        corr: {piece: np.concatenate(
                   [p[corr][piece] for p in part_payloads], axis=0)
               for piece in part_payloads[0][corr]}
        for corr in part_payloads[0]}
    c0s = {k: np.concatenate([c[k] for c in part_c0s], axis=0)
           for k in part_c0s[0]}
    bad = np.concatenate(part_bad)

    bad = np.asarray(bad).reshape(-1)[:n_nodes]
    if bad.any():
        first = nodes[np.argmax(bad)]
        raise ValueError(
            'Grid collapse: the model is out of bounds (spline range or '
            f'non-finite factor) at {int(bad.sum())} of {n_nodes} nodes, '
            f'first at {dict(zip(spec.names, first))}. Narrow the grid '
            'domain ([control] grid-domain-<param> = lo hi) or the '
            'sampling limits.')

    # chunk-level c0 consistency (out_axes=None already proved node-level)
    c0s = {k: np.asarray(v) for k, v in c0s.items()}
    for name, c0 in c0s.items():
        if c0.ndim == 2:
            assert np.allclose(c0[0], c0), \
                f'coefficient vector varies across sweep chunks for {name}'
            c0s[name] = c0[0]

    # Measured coefficient range over the sampling box: makes the
    # truncation budget unconditional (see measure_dc_max).
    c0s_np = c0s
    dc_maxes, dc_note = measure_dc_max(vega, sample_names, spec, c0s_np)
    if dc_maxes:
        worst = max(dc_maxes.values())
        print(f'INFO: grid collapse dc_max = {worst:.3g} '
              f'(coefficient range over {dc_note})', file=sys.stderr)

    # per-degree Chebyshev transform matrices, shared across components
    tmat_cache = {}

    def tmat(deg):
        if deg not in tmat_cache:
            tmat_cache[deg] = cheb_transform_matrix(deg)
        return tmat_cache[deg]

    out = {'__grid__': spec}
    for name in corr_names:
        if name not in payload_nodes:
            continue
        a_nodes = np.asarray(payload_nodes[name]['A'])
        e_nodes = np.asarray(payload_nodes[name]['e'])
        a_nodes = a_nodes.reshape(-1, *a_nodes.shape[-2:])[:n_nodes]
        e_nodes = e_nodes.reshape(-1, e_nodes.shape[-1])[:n_nodes]
        c0 = c0s_np[name]
        t = c0.shape[0]

        d_masked = data_vecs[name]
        inv_cov = np.asarray(vega.data[name].inv_masked_cov)
        d_ci_d = float(d_masked @ (inv_cov @ d_masked))

        # centered pieces, exact f64 on the host:
        #   y_q = e_q - A_q c0 ;  s_q = chi2(c0, g_q)
        y_nodes = e_nodes - np.einsum('qts,s->qt', a_nodes, c0)
        s_nodes = (d_ci_d - 2.0 * e_nodes @ c0
                   + np.einsum('t,qts,s->q', c0, a_nodes, c0))

        payload = np.concatenate(
            [a_nodes.reshape(n_nodes, t * t), y_nodes,
             s_nodes[:, None]], axis=1)                     # (N, D)
        n_cols = payload.shape[1]

        # Per-component Chebyshev transforms, accumulated (with the
        # telescoping combination weights) into the global sparse
        # tensor-mode set. A coefficient of degree k on a component
        # grid IS the global mode k (same domain normalization), so the
        # embedding is exact index arithmetic, not interpolation.
        lin_parts, coef_parts = [], []
        offset = 0
        for (degs, weight), size in zip(components, comp_sizes):
            block = payload[offset:offset + size]
            coef = block.reshape(tuple(degs) + (n_cols,))
            for axis, deg in enumerate(degs):
                coef = np.moveaxis(
                    np.tensordot(tmat(deg), coef, axes=(1, axis)),
                    0, axis)
            coef = coef.reshape(size, n_cols)
            midx = np.stack(np.unravel_index(np.arange(size), degs))
            lin_parts.append(np.ravel_multi_index(midx, spec.degrees))
            coef_parts.append(weight * coef)
            offset += size
        all_lin = np.concatenate(lin_parts)
        all_coef = np.concatenate(coef_parts, axis=0)
        uniq, inv = np.unique(all_lin, return_inverse=True)
        acc = np.zeros((uniq.size, n_cols))
        np.add.at(acc, inv, all_coef)
        modes = np.stack(np.unravel_index(uniq, spec.degrees)
                         ).astype(np.int32)                 # (D, M)

        corr_payload = finalize_corr_payload(
            acc, modes, c0, spec, mode_budget, dc_maxes[name], svd_tol)

        # Served-payload validation at the held-out probe points: the
        # exact collapse tensors at those points vs the final truncated
        # + SVD-compressed interpolant, combined into the chi^2 bound.
        probe_err = 0.0
        if n_validate > 0:
            exact_rows = payload[offset:offset + n_validate]
            tv_tables = {}
            for d, deg in enumerate(spec.degrees):
                x = ((2.0 * nodes[offset:offset + n_validate, d]
                      - (spec.lo[d] + spec.hi[d]))
                     / (spec.hi[d] - spec.lo[d]))
                tv = np.empty((n_validate, deg))
                tv[:, 0] = 1.0
                if deg > 1:
                    tv[:, 1] = x
                for k in range(2, deg):
                    tv[:, k] = 2.0 * x * tv[:, k - 1] - tv[:, k - 2]
                tv_tables[d] = tv

            def probe_psi(block_modes):
                psi = np.ones((n_validate, block_modes.shape[1]))
                for d in range(len(spec.degrees)):
                    psi *= tv_tables[d][:, block_modes[d]]
                return psi

            p_a = (probe_psi(corr_payload['modes_A'])
                   @ corr_payload['B_A']) @ corr_payload['F_A']
            p_sy = (probe_psi(corr_payload['modes_sy'])
                    @ corr_payload['B_sy']) @ corr_payload['F_sy']
            da = np.linalg.norm(p_a - exact_rows[:, :t * t], axis=1)
            dy = np.linalg.norm(
                p_sy[:, :t] - exact_rows[:, t * t:t * t + t], axis=1)
            ds = np.abs(p_sy[:, t] - exact_rows[:, t * t + t])
            dc_max = dc_maxes[name]
            probe_err = float(
                (ds + 2.0 * dc_max * dy + dc_max ** 2 * da).max())
            if probe_err > 5.0 * mode_budget and mode_budget > 0:
                print(f'WARNING: grid-collapse payload for {name} misses '
                      f'the dense collapse by up to chi^2 ~ {probe_err:.3g} '
                      f'at {n_validate} held-out probe points (budget '
                      f'{mode_budget:g}). Raise the per-dimension node '
                      'counts ([control] grid-nodes-<param>), the '
                      'interaction order ([control] grid-interaction-'
                      'order), or narrow the grid domains.',
                      file=sys.stderr)
        corr_payload['probe_err'] = np.float64(probe_err)
        out[name] = corr_payload

    if len(components) > 1:
        kept = {name: int(out[name]['modes_A'].shape[1])
                for name in out if name != '__grid__'}
        print(f'INFO: grid collapse combination schedule: '
              f'{len(components)} components, '
              f'{sum(comp_sizes)} swept nodes '
              f'(full tensor {spec.n_nodes}); retained A-modes {kept}',
              file=sys.stderr)
    return out


def _svd_compress(coef, svd_tol):
    """(B, F) with B @ F ~= coef, rank chosen by the relative Frobenius
    tail of the singular values."""
    u, s, vt = np.linalg.svd(coef, full_matrices=False)
    if s.size and s[0] > 0:
        tail = np.sqrt(np.cumsum(s[::-1] ** 2))[::-1]
        keep = int(np.searchsorted(-tail, -svd_tol * tail[0]))
        rank = max(1, min(s.size, keep if keep > 0 else 1))
    else:                                               # pragma: no cover
        rank = 1
    return (np.ascontiguousarray(u[:, :rank]),
            np.ascontiguousarray(s[:rank, None] * vt[:rank]))


def finalize_corr_payload(coef, modes, c0, spec, mode_budget, dc_max,
                          svd_tol):
    """Per-correlation payload from a (possibly sparse) Chebyshev
    coefficient matrix.

    coef: (n_modes_present, t*t + t + 1), columns [A, y, s].
    modes: (D, n_modes_present) per-dimension mode indices of the rows
    (None = the full tensor in C order).

    Mode truncation is VALIDATED per block: modes are ranked by payload
    weight and the cutoff is chosen by measuring the truncated-vs-full
    interpolant error at a probe cloud over the domain, scaled by the
    measured coefficient range dc_max (select_payload_modes). Worst-
    case coefficient bounds are useless here (the tail coefficients
    encode the domain-corner chi^2 blow-up coherently and cancel by
    factors of 1e3+ pointwise), so the cutoff is chosen by direct
    evaluation: err(x) = psi_dropped(x) @ coef_dropped is exact linear
    algebra on data already in hand. Each block is then SVD-compressed
    independently, which keeps the edge-chi^2-scaled sy columns out of
    the A block's factors (grid_corr_chi2).
    """
    t = c0.shape[0]
    if modes is None:
        modes = np.stack(np.unravel_index(
            np.arange(coef.shape[0]), spec.degrees)).astype(np.int32)
    kept_a, kept_sy = select_payload_modes(
        coef, t, spec, mode_budget, dc_max, modes=modes)
    b_a, f_a = _svd_compress(coef[kept_a, :t * t], svd_tol)
    b_sy, f_sy = _svd_compress(coef[kept_sy, t * t:], svd_tol)
    return {
        'B_A': b_a, 'F_A': f_a,
        'modes_A': np.ascontiguousarray(modes[:, kept_a]),
        'B_sy': b_sy, 'F_sy': f_sy,
        'modes_sy': np.ascontiguousarray(modes[:, kept_sy]),
        'cref': c0,
        'dc_max': np.float64(dc_max),
    }
