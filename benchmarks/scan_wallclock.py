#!/usr/bin/env python
"""Wall-clock of the batched 40x40 (ap, at) profile scan on hardware.

Round-4 verdict follow-up: docs/performance.md claimed "a 40x40 contour
scan costs one compile plus one sharded device run" with CPU-mesh
validation only (tests/test_batched_scan.py); this script MEASURES it
on the accelerator this process sees (run with JAX_PLATFORMS=cpu for
the host number).

Setup: the reference DR16-subset headline config
(/root/reference/tests/full_configs/main.ini) with (ap, at,
bias_eta_LYA, beta_LYA) sampled — a 40x40 grid of fixed (ap, at)
pinned over [0.95, 1.05]^2, the two bias parameters re-minimized at
every grid point by the batched damped-Newton optimizer with exact jax
derivatives (parallel.batched_chi2_scan: the 1600 grid points ARE the
batch axis). The grid collapse serves every evaluation, so the scan is
the same regime the 31.9k evals/s headline measures.

The reference runs the equivalent scan as 1600 SERIAL MIGRAD
minimizations (reference analysis.py:53-124, run_vega.py scan mode) at
its measured 1.17 evals/s single-core chi^2 rate
(benchmarks/reference_baseline.json) — O(100) finite-difference
evaluations per 2-free-parameter MIGRAD fit puts the equivalent at
~1600 x 85 s ~ 38 hours on one core.

Writes benchmarks/scan_wallclock.json; quoted in docs/performance.md.
"""

import json
import os
import sys
import time

import numpy as np


def main():
    import jax
    sys.stderr.write(f'devices: {jax.devices()}\n')

    from vega_tpu.vega_interface import VegaInterface
    from vega_tpu.parallel import batched_chi2_scan, make_device_mesh

    os.chdir('/root/reference/tests')
    t0 = time.time()
    vega = VegaInterface('full_configs/main.ini')
    # the headline BAO-sampled set (bench.py): the scan pins (ap, at)
    # and re-minimizes the linear bias parameters at every grid point
    vega.sample_params['limits'].update({
        'ap': (0.8, 1.2), 'at': (0.8, 1.2)})
    vega.sample_params['values'].update({'ap': 1.0, 'at': 1.0})
    init_s = time.time() - t0

    n = int(os.environ.get('VEGA_TPU_SCAN_N', 40))
    grids = {'ap': np.linspace(0.95, 1.05, n),
             'at': np.linspace(0.95, 1.05, n)}

    # collapse sweep (host; disk-cached across processes) timed apart
    t0 = time.time()
    vega.get_collapsed(('ap', 'at', 'bias_eta_LYA', 'beta_LYA'))
    collapse_s = time.time() - t0

    mesh = make_device_mesh()
    t0 = time.time()
    results = batched_chi2_scan(vega, grids, mesh=mesh)
    first_run_s = time.time() - t0          # includes the XLA compile

    t0 = time.time()
    results = batched_chi2_scan(vega, grids, mesh=mesh)
    warm_run_s = time.time() - t0           # the per-scan marginal cost

    fvals = np.array([r['fval'] for r in results])
    assert np.all(np.isfinite(fvals))
    imin = int(np.argmin(fvals))
    out = {
        'config': 'reference tests/full_configs/main.ini, '
                  '(ap, at) 40x40 over [0.95, 1.05]^2, '
                  'bias_eta_LYA+beta_LYA re-minimized per point',
        'backend': jax.default_backend(),
        'n_grid': len(results),
        'init_s': round(init_s, 1),
        'collapse_s': round(collapse_s, 1),
        'first_run_s': round(first_run_s, 1),
        'warm_run_s': round(warm_run_s, 1),
        'min_fval': float(fvals[imin]),
        'argmin': {k: results[imin][k] for k in ('ap', 'at')},
        'reference_equiv': '1600 serial MIGRAD fits at 1.17 evals/s '
                           'single core (reference_baseline.json) '
                           '~ 38 h',
    }
    path = os.environ.get('VEGA_TPU_SCAN_OUT') or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), 'scan_wallclock.json')
    with open(path, 'w') as fh:
        json.dump(out, fh, indent=2)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == '__main__':
    sys.exit(main())
