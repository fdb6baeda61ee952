"""Self-contained eBOSS-DR16-style analysis on synthetic data.

Reproduces the STRUCTURE of the DR16 flagship analysis (reference:
examples/eBOSS_DR16/main_combined.ini) without the SDSS download: four
correlations (two Lya auto regions + two QSO crosses) with the DR16
model options (Rogers2018 HCD, Arinyo small-scale NL, BAO broadening,
Lorentz velocity dispersion, metals), data vectors drawn from the
model's own truth, and three fits:

  1. auto     (lyaxlya + lyaxlyb)           — ap/at + nuisance sampled
  2. cross    (lyaxqso + lybxqso)
  3. combined (all four, per-corr covariances)
  4. combined-globalcov (all four through one joint covariance — the
     global-covariance code path, reference: vega_interface.py:888-954)

Each fit must recover the injected truth (ap = at = 1) within errors.

Run from this directory (or anywhere):
  python run_synthetic.py [--workdir DIR] [--tiny]
"""

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from vega_tpu.io.fits import read_fits, write_fits      # noqa: E402
from vega_tpu.testing import (                          # noqa: E402
    DR16_CORRS as CORRS, DR16_FIT_TYPES as FIT_TYPES,
    DR16_PARAMETERS as PARAMETERS, DR16_SAMPLED as SAMPLED,
    build_dr16_configs as build_configs,
    regenerate_dr16_from_truth as regenerate_from_truth)
from vega_tpu.vega_interface import VegaInterface       # noqa: E402

# The full Table-6-style sampled set (reference:
# examples/eBOSS_DR16/main_combined.ini [sample]): BAO + Lya bias/RSD +
# HCD + the metal biases + the QSO cross nuisances. ALL FOUR nonlinear
# scale parameters (ap, at, drp_QSO, sigma_velo_disp_lorentz_QSO) are
# known grid parameters, so the whole set rides the grid-collapse fast
# path out of the box — ap/at on the production +-0.25 window, drp and
# sigma over their full sampling limits ([-3, 3] and [0, 15]). The
# 4-dim node tensor would be ~147k sweep evaluations; the anisotropic
# combination schedule (gridcollapse.plan_components) sweeps ~8k
# instead, with the payload validated against held-out exact collapse
# points (probe_err) at build time.
SAMPLED_FULL = SAMPLED + [
    'bias_hcd', 'beta_hcd',
    'bias_SiII(1260)', 'bias_SiIII(1207)',
    'drp_QSO', 'sigma_velo_disp_lorentz_QSO',
]

# Production run: the defaults ARE the production settings — no
# narrowing needed since the combination schedule keeps the sweep
# affordable.
CONTROL_FULL = {}

# CI-sized node budget for the slow-tier test (tests/test_dr16_example
# .py): same code path (4-dim combination schedule), ~2k swept nodes.
CONTROL_FULL_TEST = {
    'grid-nodes-ap': '16', 'grid-nodes-at': '16',
    'grid-nodes-drp_QSO': '8',
    'grid-nodes-sigma_velo_disp_lorentz_QSO': '6',
}


def make_global_cov(workdir, main_path):
    """Block-diagonal joint covariance over the four correlations."""
    vega = VegaInterface(main_path)
    blocks = [read_fits(workdir / f'{CORRS[name][0]}.fits')[1]['CO']
              for name in vega.corr_items]
    n = sum(len(b) for b in blocks)
    cov = np.zeros((n, n))
    off = 0
    for b in blocks:
        cov[off:off + len(b), off:off + len(b)] = b
        off += len(b)
    path = workdir / 'global_cov.fits'
    write_fits(path, [{'name': 'COV', 'columns': {'COV': cov}}])
    return path


def run_fit(label, main_path, sampled=SAMPLED):
    vega = VegaInterface(main_path)
    vega.minimize()
    values = dict(vega.bestfit.values)
    errors = dict(vega.bestfit.errors)
    print(f'\n=== {label}: chi2 = {vega.chisq:.2f} '
          f'(reduced {vega.reduced_chisq:.3f}) ===')
    for par in sampled:
        truth = PARAMETERS[par]
        pull = (values[par] - truth) / max(errors[par], 1e-12)
        print(f'  {par:10s} = {values[par]:+.4f} +- {errors[par]:.4f} '
              f'(truth {truth:+.4f}, pull {pull:+.2f})')
        assert abs(pull) < 5, f'{label}: {par} recovery failed'
    return values, errors


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--workdir', default=None)
    parser.add_argument('--tiny', action='store_true',
                        help='smaller grids for a quick smoke run')
    parser.add_argument('--full-params', action='store_true',
                        help='sample the full Table-6-style parameter '
                             'set (BAO + HCD + metal biases + QSO cross '
                             'nuisances) in the combined fit')
    args = parser.parse_args()

    workdir = Path(args.workdir or tempfile.mkdtemp(prefix='dr16_synth_'))
    workdir.mkdir(parents=True, exist_ok=True)
    nt = 20 if args.tiny else 50
    print(f'workdir: {workdir}')

    mains = build_configs(workdir, nt)
    regenerate_from_truth(workdir, mains['combined'], nt)

    for label in ('auto', 'cross', 'combined'):
        run_fit(label, mains[label])

    if args.full_params:
        fmains = build_configs(
            workdir, nt, extension='full',
            fit_types={'combined': FIT_TYPES['combined']},
            sample_params=SAMPLED_FULL, control_extra=CONTROL_FULL)
        run_fit('combined-full-params', fmains['combined'],
                sampled=SAMPLED_FULL)

    # Global-covariance variant of the combined fit
    gcov = make_global_cov(workdir, mains['combined'])
    gmains = build_configs(workdir, nt, extension='gcov',
                           global_cov_file=gcov,
                           fit_types={'combined': FIT_TYPES['combined']})
    run_fit('combined-globalcov', gmains['combined'])

    print('\nAll four fits recover the injected truth.')


if __name__ == '__main__':
    main()
