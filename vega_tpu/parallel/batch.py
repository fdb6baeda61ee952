"""Multi-chip batched likelihood evaluation.

This replaces every parallelism pattern in the reference (SURVEY.md
section 2.3 — all four are MPI fan-outs of independent likelihood
evaluations) with its device-batched equivalent: parameter batches are
sharded over a jax.sharding.Mesh, each device evaluates the same jitted
chi^2 graph on its shard (pure SPMD, no collectives on model data — the
static arrays are replicated), and results are gathered for free by the
output sharding.

- sampler live points   (reference: bin/run_vega_mpi.py:24-57)
- Monte-Carlo mock fits (reference: bin/run_vega_mc_mpi.py:53-65)
- saved-mock re-fits    (reference: bin/run_vega_mc_fits_mpi.py:133-152)
- PocoMC particle maps  (reference: bin/run_vega_mpi.py:98-121)
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vega_tpu.statics import STATICS


def make_device_mesh(n_devices=None, axis_name='batch'):
    """1D device mesh over all (or the first n) local devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def _pad_to_multiple(arr, multiple):
    n = arr.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return arr, n
    pad_width = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width, mode='edge'), n


class BatchedLikelihood:
    """Sharded, vmapped chi^2 / log-likelihood over parameter batches.

    Parameters arrive as a dict of name -> (n_batch,) arrays. The batch
    axis is sharded over the mesh; the model constants are replicated.
    """

    def __init__(self, vega, mesh=None, axis_name='batch',
                 chunk_per_device=None):
        """chunk_per_device bounds how many batch items are in flight per
        device at once: inside the jit, chunks run sequentially via
        lax.map while each chunk vmaps+shards across the mesh. This caps
        the device-memory footprint of the per-item (mu_k, k) grids of
        the dense pipeline, so arbitrarily large batches work."""
        import os
        self.vega = vega
        self.mesh = mesh if mesh is not None else make_device_mesh(
            axis_name=axis_name)
        self.axis_name = axis_name
        if chunk_per_device is None:
            chunk_per_device = int(os.environ.get(
                'VEGA_TPU_CHUNK_PER_DEVICE', 128))
        self.chunk_per_device = chunk_per_device
        self._jit_cache = {}

    @property
    def n_devices(self):
        return self.mesh.devices.size

    def _build(self, key):
        if key in self._jit_cache:
            return self._jit_cache[key]

        self.vega._ensure_static_refs()
        data_vecs = {k: jnp.asarray(v) for k, v in
                     self.vega._current_data_vecs().items()}
        cov_scales = self.vega._current_cov_scales()

        def single(params, statics, collapsed):
            return self.vega._chi2_graph_bound(
                params, data_vecs, cov_scales, statics, collapsed)[0]

        def chunked(param_chunks, statics, collapsed):
            # param_chunks: dict of (n_chunks, chunk_total) arrays
            def one_chunk(chunk_params):
                return jax.vmap(single, in_axes=(0, None, None))(
                    chunk_params, statics, collapsed)
            out = jax.lax.map(one_chunk, param_chunks)
            return out.reshape(-1)

        chunk_sharding = NamedSharding(self.mesh, P(None, self.axis_name))
        flat_sharding = NamedSharding(self.mesh, P(self.axis_name))
        replicated = NamedSharding(self.mesh, P())
        fn = jax.jit(
            chunked,
            in_shardings=(chunk_sharding, replicated, replicated),
            out_shardings=flat_sharding,
        )
        self._jit_cache[key] = fn
        return fn

    def prepare(self, param_batches):
        """(fn, args, n) for one batch: the jitted sharded step, its
        arguments (the batch padded to a multiple of devices x chunk and
        reshaped into chunks, the statics and the collapse payload) and
        the batch size before padding. ``fn(*args)`` evaluates it;
        ``fn.lower(*args)`` exposes the compiled step."""
        names = tuple(sorted(param_batches.keys()))
        batches = {k: np.asarray(v, dtype=np.float64)
                   for k, v in param_batches.items()}
        n = len(next(iter(batches.values())))
        # never pad beyond the actual batch: the chunk width shrinks for
        # small batches (a new width retraces, matching its use pattern)
        per_dev = min(self.chunk_per_device,
                      -(-n // self.n_devices))
        chunk_total = per_dev * self.n_devices
        padded = {}
        for k, v in batches.items():
            arr, _ = _pad_to_multiple(v, chunk_total)
            padded[k] = arr.reshape(-1, chunk_total)
        fn = self._build(names)
        collapsed = self.vega._device_collapsed(
            self.vega.get_collapsed(names))
        statics = STATICS.device_tree()
        if jax.process_count() > 1:
            # Multi-host (DCN): jit inputs must be global jax.Arrays.
            # Every process holds the same full numpy batch, so each
            # just materializes its addressable shards.
            chunk_sh = NamedSharding(self.mesh, P(None, self.axis_name))
            repl = NamedSharding(self.mesh, P())

            def globalize(a, sh):
                arr = np.asarray(a)
                return jax.make_array_from_callback(
                    arr.shape, sh, lambda idx: arr[idx])

            padded = {k: globalize(v, chunk_sh) for k, v in padded.items()}
            statics = jax.tree.map(lambda a: globalize(a, repl), statics)
            collapsed = jax.tree.map(lambda a: globalize(a, repl), collapsed)
        return fn, (padded, statics, collapsed), n

    def chi2(self, param_batches):
        """chi^2 for each row of the batch; pads the batch to a multiple
        of (devices x chunk) and strips the padding on return."""
        fn, args, n = self.prepare(param_batches)
        with self.mesh:
            out = fn(*args)
        if jax.process_count() > 1:
            # gather the sharded result so every host sees all values
            # (the one DCN crossing; reference analogue: MPI gather of
            # per-rank results)
            from jax.experimental import multihost_utils
            out = multihost_utils.process_allgather(out, tiled=True)
        return np.asarray(out)[:n]

    def log_lik(self, param_batches):
        chi2 = self.chi2(param_batches)
        log_lik = self.vega._log_norm() - 0.5 * chi2
        for prior in self.vega.priors.values():
            log_lik += self.vega._gaussian_lik_prior(prior[1])
        return log_lik

    def traceable_log_lik(self, names):
        """(batch_fn, statics, collapsed) for COMPOSITION inside a
        caller's jit — the device-fused sampler loops (nested.py's
        on-device slice evolution) build their whole per-iteration
        update around it, turning O(num_repeats x max_shrink) blocking
        dispatches per NS iteration into ONE.

        batch_fn(theta, statics, collapsed) -> (n,) log-likelihoods for
        a (n, ndim) matrix of PHYSICAL parameter values, columns
        ordered as ``names``; trace-safe (vmapped single-evaluation
        graph, no host sync). statics / collapsed are the device trees
        to pass through the caller's jit boundary."""
        names = tuple(names)
        self.vega._ensure_static_refs()
        data_vecs = {k: jnp.asarray(v) for k, v in
                     self.vega._current_data_vecs().items()}
        cov_scales = self.vega._current_cov_scales()
        log_norm = float(self.vega._log_norm())
        for prior in self.vega.priors.values():
            log_norm += float(self.vega._gaussian_lik_prior(prior[1]))

        def single(params, statics, collapsed):
            chi2 = self.vega._chi2_graph_bound(
                params, data_vecs, cov_scales, statics, collapsed)[0]
            return log_norm - 0.5 * chi2

        def batch_fn(theta, statics, collapsed):
            params = {name: theta[:, i] for i, name in enumerate(names)}
            return jax.vmap(single, in_axes=(0, None, None))(
                params, statics, collapsed)

        collapsed = self.vega._device_collapsed(
            self.vega.get_collapsed(names))
        return batch_fn, STATICS.device_tree(), collapsed


def _spd_cholesky(a):
    """Plain-jnp Cholesky, unrolled over the (static, small) dimension.

    With n_free ~ O(10) the batched (n_free, n_free) Newton systems
    factor as a few elementwise operations of the batched graph, with
    no solver-library call; an indefinite matrix yields NaN, which the
    damping ladder of _newton_minimize_batched checks for."""
    n = a.shape[-1]
    l = jnp.zeros_like(a)
    for j in range(n):
        s = a[..., j, j] - jnp.sum(l[..., j, :j] ** 2, axis=-1)
        ljj = jnp.sqrt(s)
        l = l.at[..., j, j].set(ljj)
        if j + 1 < n:
            r = (a[..., j + 1:, j]
                 - jnp.einsum('...ik,...k->...i', l[..., j + 1:, :j],
                              l[..., j, :j]))
            l = l.at[..., j + 1:, j].set(r / ljj[..., None])
    return l


def _spd_solve(a, b):
    """Solve a @ x = b for symmetric positive-definite a via the
    unrolled Cholesky + unrolled substitutions (b: (..., n) or
    (..., n, m)); everything is elementwise jnp, no lapack calls."""
    l = _spd_cholesky(a)
    n = a.shape[-1]
    vector = b.ndim == a.ndim - 1
    if vector:
        b = b[..., None]
    y = jnp.zeros_like(b)
    for j in range(n):  # forward substitution
        r = b[..., j, :] - jnp.einsum('...k,...km->...m',
                                      l[..., j, :j], y[..., :j, :])
        y = y.at[..., j, :].set(r / l[..., j, j][..., None])
    x = jnp.zeros_like(b)
    for j in reversed(range(n)):  # back substitution with L^T
        r = y[..., j, :] - jnp.einsum('...k,...km->...m',
                                      l[..., j + 1:, j], x[..., j + 1:, :])
        x = x.at[..., j, :].set(r / l[..., j, j][..., None])
    return x[..., 0] if vector else x


def _spd_inv(a):
    return _spd_solve(a, jnp.eye(a.shape[-1], dtype=a.dtype))


def _newton_minimize_batched(chi2_of, x0, lo, hi, batch_inputs, mesh,
                             axis_name, max_iterations,
                             chunk_per_device=None, collapsed=None):
    """Shared batched damped-Newton minimizer.

    chi2_of(x, batch_elem, statics, collapsed) -> scalar; batch_inputs is a pytree
    whose leaves carry the (padded) batch axis — mock data vectors for
    the Monte-Carlo engine, fixed scan-parameter values for the chi^2
    scan. Every iteration evaluates the exact jax gradient + Hessian
    for the whole batch, sharded over the mesh.

    Chunked like BatchedLikelihood: the Hessian graph holds several
    model forwards per element, so only chunk_per_device elements per
    device are in flight at once (lax.map over chunks); a batch-64
    Hessian fit of the DR16 config would otherwise need ~47 GB of HBM.

    Returns (x, errors, cov, chi2, valid) with the batch axis leading.
    """
    import os
    n_free = x0.shape[0]
    if chunk_per_device is None:
        chunk_per_device = int(os.environ.get(
            'VEGA_TPU_FIT_CHUNK_PER_DEVICE', 8))

    if collapsed is None:
        collapsed = {}
    grad_fn = jax.grad(chi2_of)
    hess_fn = jax.hessian(chi2_of)

    def _project_active(x, g):
        """Active-set mask: coordinates pinned at a bound with the
        gradient pushing outward. Plain clip() of the full Newton step
        is NOT enough: its fixed points have (H^-1 g)_free = 0, which
        can hold with g_free != 0 — the free coordinates stall at the
        unconstrained direction's zero instead of the constrained
        optimum. The projected (KKT-reduced) system below solves the
        free subspace exactly."""
        eps = 1e-12 + 1e-9 * jnp.abs(x)
        active = (((x <= lo + eps) & (g > 0))
                  | ((x >= hi - eps) & (g < 0)))
        return active, jnp.where(active, 0.0, g)

    def newton_step(x, batch_elem, statics, co):
        g = grad_fn(x, batch_elem, statics, co)
        h = hess_fn(x, batch_elem, statics, co)
        active, g_proj = _project_active(x, g)
        free = ~active
        h_proj = (jnp.where(free[:, None] & free[None, :], h, 0.0)
                  + jnp.diag(jnp.where(active, 1.0, 0.0)))
        # Adaptive Levenberg damping: an indefinite Hessian (flat or
        # noise-dominated likelihood, early iterations far from the
        # minimum) makes the plain Cholesky solve NaN. Solve at a ladder
        # of damping strengths and keep the least-damped finite step;
        # the strongest level approximates scaled gradient descent.
        # (max(n_free, 1) keeps the all-params-scanned case finite.)
        tr = jnp.abs(jnp.trace(h_proj)) / max(n_free, 1) + 1e-12
        eye = jnp.eye(n_free)
        steps = [_spd_solve(h_proj + lam * eye, g_proj)
                 for lam in (1e-6 * tr, 1e-2 * tr, tr, 1e2 * tr)]
        step = jnp.zeros_like(g)    # last resort: stay put
        for s in steps[::-1]:
            s_ok = jnp.all(jnp.isfinite(s))
            step = jnp.where(s_ok, s, step)
        x_new = jnp.clip(x - step, lo, hi)
        return x_new, g_proj, h

    def fit_one(batch_elem, statics, co):
        # while_loop instead of a fixed-length scan: Newton converges in
        # ~10-20 steps, so iterating to the max_iterations cap would
        # waste ~10x device work. Under vmap the loop runs until every
        # batch element satisfies the gradient tolerance (or the cap).
        def cond(carry):
            _, g, it = carry
            g_norm = jnp.max(jnp.abs(g), initial=0.0)  # 0 if no free params
            return (it < max_iterations) & (g_norm > 1e-6)

        def body(carry):
            x, _, it = carry
            x_new, g, _ = newton_step(x, batch_elem, statics, co)
            return (x_new, g, it + 1)

        x, g, _ = jax.lax.while_loop(
            cond, body, (x0, jnp.full(n_free, jnp.inf), 0))
        # curvature at the converged point (the loop's h lags one step)
        h = hess_fn(x, batch_elem, statics, co)
        chi2 = chi2_of(x, batch_elem, statics, co)
        cov = 2.0 * _spd_inv(h)
        errors = jnp.sqrt(jnp.clip(jnp.diag(cov), 0, None))
        # a fit is only valid with a stationary point AND a positive-
        # definite curvature there (indefinite Hessian -> NaN Cholesky)
        valid = (jnp.all(jnp.abs(g) < 1e-3)
                 & jnp.all(jnp.isfinite(cov)) & jnp.all(jnp.isfinite(chi2)))
        return x, errors, cov, chi2, valid

    leaves = jax.tree.leaves(batch_inputs)
    n = leaves[0].shape[0]
    n_dev = mesh.devices.size
    per_dev = min(chunk_per_device, -(-n // n_dev))
    chunk_total = per_dev * n_dev

    def pad_and_chunk(v):
        arr = np.asarray(v)
        pad = (-arr.shape[0]) % chunk_total
        if pad:
            arr = np.pad(arr, [(0, pad)] + [(0, 0)] * (arr.ndim - 1),
                         mode='edge')
        return jnp.asarray(
            arr.reshape((-1, chunk_total) + arr.shape[1:]))

    chunked_inputs = jax.tree.map(pad_and_chunk, batch_inputs)

    def run(batch, statics, co):
        def one_chunk(chunk):
            return jax.vmap(fit_one, in_axes=(0, None, None))(
                chunk, statics, co)
        return jax.lax.map(one_chunk, batch)

    chunk_sharding = NamedSharding(mesh, P(None, axis_name))
    replicated = NamedSharding(mesh, P())
    fit_batched = jax.jit(
        run,
        in_shardings=(jax.tree.map(lambda _: chunk_sharding,
                                   chunked_inputs), replicated, replicated),
    )
    with mesh:
        out = fit_batched(chunked_inputs, STATICS.device_tree(), collapsed)
    # merge chunks and strip the internal padding back to n rows
    # (explicit leading dim: reshape(-1) is ambiguous for zero-size
    # leaves, e.g. x of shape (B, 0) when every parameter is scanned)
    return jax.tree.map(
        lambda a: a.reshape((a.shape[0] * a.shape[1],)
                            + a.shape[2:])[:n], out)


def batched_chi2_scan(vega, grids, sample_params=None, mesh=None,
                      axis_name='batch', max_iterations=100):
    """1D/2D profile chi^2 scan with ALL grid points minimized
    simultaneously on device.

    The reference re-runs MIGRAD serially at every grid point
    (reference: analysis.py:53-124, O(minutes) each); here the grid is
    the batch axis of one damped-Newton optimization with exact jax
    derivatives, sharded over the mesh.

    grids: dict of 1 or 2 entries, param -> 1D array of fixed values.
    Returns a list of dicts in C order over the grid (outer loop =
    first grid param, matching the serial Analysis.chi2_scan), each
    {free name: bestfit, scan name: fixed value, 'fval': chi^2}.
    """
    if mesh is None:
        mesh = make_device_mesh(axis_name=axis_name)
    if sample_params is None:
        sample_params = vega.sample_params
    scan_names = list(grids.keys())
    if not 1 <= len(scan_names) <= 2:
        raise ValueError('chi2 scan supports one or two parameters')
    free_names = [n for n in sample_params['limits'] if n not in scan_names]

    mesh_axes = np.meshgrid(*[np.asarray(grids[n]) for n in scan_names],
                            indexing='ij')
    scan_vals = np.stack([ax.ravel() for ax in mesh_axes], axis=-1)
    n_points = scan_vals.shape[0]

    x0 = jnp.array([sample_params['values'][n] for n in free_names])
    lo = jnp.array([(-jnp.inf if sample_params['limits'][n][0] is None
                     else sample_params['limits'][n][0])
                    for n in free_names])
    hi = jnp.array([(jnp.inf if sample_params['limits'][n][1] is None
                     else sample_params['limits'][n][1])
                    for n in free_names])

    vega._ensure_static_refs()
    data_vecs = {k: jnp.asarray(v)
                 for k, v in vega._current_data_vecs().items()}
    cov_scales = vega._current_cov_scales()

    def chi2_of(x, point, statics, collapsed):
        params = {n: x[i] for i, n in enumerate(free_names)}
        params.update({n: point[i] for i, n in enumerate(scan_names)})
        return vega._chi2_graph_bound(params, data_vecs, cov_scales,
                                      statics, collapsed)[0]

    padded, _ = _pad_to_multiple(scan_vals, mesh.devices.size)
    x, _, _, chi2, valid = _newton_minimize_batched(
        chi2_of, x0, lo, hi, jnp.asarray(padded), mesh, axis_name,
        max_iterations,
        collapsed=vega._device_collapsed(
            vega.get_collapsed(free_names + scan_names)))

    x = np.asarray(x)[:n_points]
    chi2 = np.asarray(chi2)[:n_points]
    results = []
    for g in range(n_points):
        row = {name: float(x[g, i]) for i, name in enumerate(free_names)}
        row.update({name: float(scan_vals[g, i])
                    for i, name in enumerate(scan_names)})
        row['fval'] = float(chi2[g])
        results.append(row)
    return results


class MonteCarloEngine:
    """Batched Monte-Carlo mock generation + fitting.

    Mock generation is fiducial + L @ N(0, 1) with the Cholesky factor of
    the masked covariance (reference: data.py:726-756), vmapped over
    realizations with jax.random keys replacing np.random.seed(seed+rank)
    (reference: bin/run_vega_mc_mpi.py:53-61).
    """

    def __init__(self, vega, mesh=None, axis_name='batch'):
        self.vega = vega
        self.mesh = mesh if mesh is not None else make_device_mesh(
            axis_name=axis_name)
        self.axis_name = axis_name

    def generate_mocks(self, fiducial_model, num_mocks, seed=0, scale=None):
        """Device-batched mock data vectors for each correlation.

        Returns dict name -> (num_mocks, n_masked) arrays.
        """
        key = jax.random.PRNGKey(seed)
        mocks = {}
        for name in self.vega.corr_items:
            data = self.vega.data[name]
            item_scale = 1. if scale is None else scale
            masked_cov = data.cov_mat[np.ix_(data.data_mask, data.data_mask)]
            chol = np.linalg.cholesky(item_scale * masked_cov)

            fid = np.asarray(fiducial_model[name])
            if fid.size != data.full_data_size:
                mask = data.dist_model_coordinates.get_mask_to_other(
                    data.data_coordinates)
                fid = fid[mask]
            fid_masked = fid[data.data_mask]

            key, sub = jax.random.split(key)
            noise = jax.random.normal(
                sub, (num_mocks, fid_masked.size), dtype=jnp.float64)
            mocks[name] = np.asarray(
                fid_masked[None, :] + noise @ jnp.asarray(chol).T)
        return mocks

    def fit_mocks(self, mocks, sample_params=None, max_iterations=200):
        """Fit every mock with a batched, vmapped Newton/damped-GN loop.

        All mocks are optimized simultaneously: each iteration evaluates
        the chi^2 gradient and Hessian (exact, via jax) for the whole
        batch, sharded across devices. Returns a dict with bestfit values,
        errors, covariances, chi^2 and validity flags per mock.
        """
        vega = self.vega
        if sample_params is None:
            sample_params = (vega.mc_config['sample']
                             if vega.mc_config is not None
                             else vega.sample_params)
        names = list(sample_params['limits'].keys())
        x0 = jnp.array([sample_params['values'][n] for n in names])
        lo = jnp.array([(-jnp.inf if sample_params['limits'][n][0] is None
                         else sample_params['limits'][n][0]) for n in names])
        hi = jnp.array([(jnp.inf if sample_params['limits'][n][1] is None
                         else sample_params['limits'][n][1]) for n in names])

        vega._ensure_static_refs()
        corr_names = list(vega.corr_items.keys())
        num_mocks = len(next(iter(mocks.values())))
        mock_arrays = {k: jnp.asarray(v) for k, v in mocks.items()}
        cov_scales = {name: 1.0 for name in corr_names}

        def chi2_of(x, data_vecs, statics, collapsed):
            params = {n: x[i] for i, n in enumerate(names)}
            return vega._chi2_graph_bound(params, data_vecs, cov_scales,
                                          statics, collapsed)[0]

        padded = {}
        for k, v in mock_arrays.items():
            arr, _ = _pad_to_multiple(np.asarray(v), self.mesh.devices.size)
            padded[k] = jnp.asarray(arr)

        # Data-dependent payload pieces cannot serve a batch of per-mock
        # data vectors: with_data_terms=False skips both the pre-reduced
        # (y, s) hoisting (the graph keeps the in-graph r = d - m0 form
        # per mock) and grid-collapse payloads (which bake the data in
        # entirely: mock fits with sampled scale parameters run dense).
        collapsed = vega._device_collapsed(
            vega.get_collapsed(names, with_data_terms=False))

        x, errors, cov, chi2, valid = _newton_minimize_batched(
            chi2_of, x0, lo, hi, padded, self.mesh, self.axis_name,
            max_iterations, collapsed=collapsed)

        sl = slice(0, num_mocks)
        return {
            'names': names,
            'values': np.asarray(x)[sl],
            'errors': np.asarray(errors)[sl],
            'covariances': np.asarray(cov)[sl],
            'chisq': np.asarray(chi2)[sl],
            'valid': np.asarray(valid)[sl],
        }
