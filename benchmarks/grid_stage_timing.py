#!/usr/bin/env python
"""Attribute the per-batch wall-clock of the grid-collapse chi^2 path.

Times, on the active backend (the GPU unless JAX_PLATFORMS=cpu):

  0. a no-op dispatch            -> dispatch floor
  1. psi only                    -> Chebyshev recurrences + outer
  2. psi @ B_i (all corrs)       -> mode contraction
  3. (psi @ B_i) @ F_i           -> payload interpolation
  4. full quadratic forms        -> + dc A dc terms
  5. the production chi^2 graph  -> everything incl. coefficients

Usage: python benchmarks/grid_stage_timing.py [batch_size]
Writes one line per stage; differences between consecutive stages are
the stage costs. Uses the flagship DR16-subset config when the
reference checkout is present, else the synthetic full-size twin.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault('VEGA_TPU_GRID_PAD', '0.06')
os.environ.setdefault('VEGA_TPU_GRID_NODES', '20')

import jax
import jax.numpy as jnp
import numpy as np


def main():
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 2048

    from vega_tpu.vega_interface import VegaInterface
    from vega_tpu.parallel import BatchedLikelihood
    from vega_tpu.gridcollapse import (grid_tvecs, grid_corr_chi2,
                                       psi_from_modes)

    if os.path.isdir('/root/reference/tests'):
        os.chdir('/root/reference/tests')
        vega = VegaInterface('full_configs/main.ini')
        sampled = {'bias_eta_LYA': -0.2008, 'beta_LYA': 1.67,
                   'ap': 1.0, 'at': 1.0}
    else:
        import tempfile
        from vega_tpu.testing import make_synthetic_dataset
        workdir = tempfile.mkdtemp(prefix='vega_tpu_prof_')
        vega = VegaInterface(make_synthetic_dataset(workdir, cross=True))
        sampled = {'bias_LYA': -0.117, 'beta_LYA': 1.67,
                   'ap': 1.0, 'at': 1.0}

    payload = vega.get_collapsed(frozenset(sampled))
    spec = payload['__grid__']
    names = [n for n in payload if n != '__grid__']
    print('payload:', {n: (payload[n]['B_A'].shape, payload[n]['F_A'].shape,
                           payload[n]['B_sy'].shape, payload[n]['F_sy'].shape)
                       for n in names})

    rng = np.random.default_rng(0)
    batches = {k: jnp.asarray(v + 0.005 * np.abs(v)
                              * rng.normal(size=batch))
               for k, v in sampled.items()}
    dev_payload = {n: {k: jnp.asarray(v) for k, v in payload[n].items()}
                   for n in names}
    # random but fixed dc stand-ins (the real coefficient trace is what
    # stage 5 adds on top)
    dcs = {n: jnp.asarray(rng.normal(size=(batch,
                                           payload[n]['cref'].shape[0]))
                          * 0.01)
           for n in names}

    def stage0(b):
        return b['ap'] * 1.0

    # psi is now per-correlation: the retained Chebyshev modes are
    # gathered from the per-dimension value vectors (mode truncation),
    # so each stage builds tvecs once and psi per correlation.
    def stage1(b):
        def one(a, t):
            tv, exc = grid_tvecs(spec, {'ap': a, 'at': t})
            out = exc
            for n in names:
                out = out + psi_from_modes(tv, dev_payload[n]['modes_A']).sum()
                out = out + psi_from_modes(tv, dev_payload[n]['modes_sy']).sum()
            return out
        return jax.vmap(one)(b['ap'], b['at'])

    def stage2(b, pl):
        def one(a, t):
            tv, _ = grid_tvecs(spec, {'ap': a, 'at': t})
            out = 0.
            for n in names:
                psi = psi_from_modes(tv, pl[n]['modes_A'])
                out = out + (psi @ pl[n]['B_A']).sum()
                psi_sy = psi_from_modes(tv, pl[n]['modes_sy'])
                out = out + (psi_sy @ pl[n]['B_sy']).sum()
            return out
        return jax.vmap(one)(b['ap'], b['at'])

    def stage3(b, pl):
        def one(a, t):
            tv, _ = grid_tvecs(spec, {'ap': a, 'at': t})
            out = 0.
            for n in names:
                psi = psi_from_modes(tv, pl[n]['modes_A'])
                out = out + ((psi @ pl[n]['B_A']) @ pl[n]['F_A']).sum()
                psi_sy = psi_from_modes(tv, pl[n]['modes_sy'])
                out = out + ((psi_sy @ pl[n]['B_sy']) @ pl[n]['F_sy']).sum()
            return out
        return jax.vmap(one)(b['ap'], b['at'])

    def stage4(b, pl, dc):
        def one(a, t, dci):
            tv, _ = grid_tvecs(spec, {'ap': a, 'at': t})
            out = 0.
            for n in names:
                out = out + grid_corr_chi2(pl[n], tv,
                                           pl[n]['cref'] + dci[n])
            return out
        return jax.vmap(one)(b['ap'], b['at'], dc)

    bl = BatchedLikelihood(vega)

    def run(label, fn, *args):
        jitted = jax.jit(fn)
        t0 = time.time()
        jax.block_until_ready(jitted(*args))
        compile_s = time.time() - t0
        reps = 10
        t0 = time.time()
        for _ in range(reps):
            out = jitted(*args)
        jax.block_until_ready(out)
        per = (time.time() - t0) / reps
        print(f'{label:34s} {per * 1e3:9.2f} ms/batch '
              f'({batch / per:9.0f} evals/s)  [compile {compile_s:.1f}s]')
        return per

    print(f'\nbatch = {batch}, backend = {jax.default_backend()}')
    run('0 dispatch floor', stage0, batches)
    run('1 + psi (cheb + outer)', stage1, batches)
    run('2 + psi @ B', stage2, batches, dev_payload)
    run('3 + (psi @ B) @ F', stage3, batches, dev_payload)
    run('4 + quadratic forms', stage4, batches, dev_payload, dcs)

    # ---- the real coefficient trace (what stage 5 adds over stage 4) ----
    from vega_tpu.statics import STATICS
    from vega_tpu.factored import FactoredXi

    # production replaces grid params with the spec reference values for
    # the model trace, so the coefficient chains never see ap/at
    ref_subst = dict(zip(spec.names, spec.ref))

    def coeff_one(sample_params, statics):
        with STATICS.bind(statics):
            sp = dict(sample_params)
            sp.update(ref_subst)
            local = vega._get_lcl_prms(sp)
            model_cf, bad = vega._model_graph(local, keep_factored=True)
            out = 0.
            for n in names:
                fxi = model_cf[n].mask(vega.data[n].model_mask)
                out = out + fxi.coeff_vector().sum()
            return out + jnp.where(bad, 1e100, 0.)

    statics = STATICS.device_tree()

    def stage_c(b, st):
        return jax.vmap(coeff_one, in_axes=(0, None))(b, st)

    def stage_c128(b, st):
        c = min(128, batch)
        chunks = {k: v.reshape(-1, c) for k, v in b.items()}
        return jax.lax.map(
            lambda ch: jax.vmap(coeff_one, in_axes=(0, None))(ch, st),
            chunks).reshape(-1)

    def stage_c_f32(b, st):
        b32 = {k: v.astype(jnp.float32) for k, v in b.items()}
        return jax.vmap(coeff_one, in_axes=(0, None))(b32, st)

    run('C real coeff trace (one vmap)', stage_c, batches, statics)
    run('C128 coeff trace (lax.map 128)', stage_c128, batches, statics)
    run('Cf32 coeff trace (f32 params)', stage_c_f32, batches, statics)

    # ---- production graph with pre-staged device args (no host work) ----
    names_key = tuple(sorted(batches.keys()))
    per_dev = min(bl.chunk_per_device, -(-batch // bl.n_devices))
    chunk_total = per_dev * bl.n_devices
    padded = {k: jnp.asarray(np.asarray(v).reshape(-1, chunk_total))
              for k, v in batches.items()}
    fn = bl._build(names_key)
    collapsed_dev = vega._device_collapsed(vega.get_collapsed(names_key))
    with bl.mesh:
        run('P production fn(device args)', fn, padded, statics,
            collapsed_dev)

    t0 = time.time()
    chi2 = bl.chi2({k: np.asarray(v) for k, v in batches.items()})
    print(f'[production compile+run {time.time() - t0:.1f}s]')
    reps = 5
    t0 = time.time()
    for _ in range(reps):
        chi2 = bl.chi2({k: np.asarray(v) for k, v in batches.items()})
    per = (time.time() - t0) / reps
    print(f'{"5 production bl.chi2 (host+dev)":34s} {per * 1e3:9.2f} ms/batch '
          f'({batch / per:9.0f} evals/s)')
    assert np.all(np.isfinite(chi2))


if __name__ == '__main__':
    main()
