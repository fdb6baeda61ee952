#!/usr/bin/env python
"""End-to-end BAO posterior + evidence on one device.

The flagship demonstration of what the one-graph design buys: a full
auto+cross Lyman-alpha likelihood with (alpha_par, alpha_perp,
bias, beta) sampled, driven by the native batched nested sampler
(vega_tpu/samplers/nested.py) through device-batched likelihood
evaluations. The reference runs this analysis class through PolyChord
over MPI at "order 10^2 - 10^4 core hours" (reference README.rst:170);
here the whole posterior + evidence comes from one device.

Two datasets:

- ``synthetic`` (default): a DR16-shaped auto+cross injection at
  ap = at = 1 with realistic per-bin S/N (vega_tpu.testing), so the
  posterior genuinely constrains the BAO scale — an injection-recovery
  demonstration (mean within ~1 sigma of the truth, sigma_ap ~ 1%%).
- ``dr16``: the reference checkout's DR16-subset parity fixture
  (tests/full_configs). Its shipped covariance is the identity, so the
  posterior is intentionally prior-dominated — useful as a timing
  benchmark on real data shapes, not as a constraint.

Usage:

    python examples/dr16_subset/bao_posterior.py \
        [--dataset synthetic|dr16] [--num-live 512] [--precision 1e-3] \
        [--workdir /tmp/bao_demo] [--cpu]

Measured numbers live in docs/performance.md ("End-to-end BAO
posterior").
"""

import argparse
import configparser
import os
import sys
import time
from pathlib import Path

REFERENCE = Path(os.environ.get('VEGA_REFERENCE', '/root/reference'))
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def _sampler_sections(config, workdir, args):
    config['control']['run_sampler'] = 'True'
    config['control']['sampler'] = ('HMC' if args.sampler == 'hmc'
                                    else 'Polychord')
    config['Polychord'] = {
        'path': str(workdir),
        'name': f'bao_posterior_{args.dataset}',
        'num_live': str(args.num_live),
        'precision': str(args.precision),
        'resume': 'False',   # never pick up a stale checkpoint
        'seed': '0',
    }
    if args.batch_size:
        config['Polychord']['batch_size'] = str(args.batch_size)
    config['HMC'] = {
        'path': str(workdir),
        'name': f'bao_posterior_hmc_{args.dataset}',
        'num_chains': '32',
        'num_samples': '600',
        'num_warmup': '400',
        'seed': '0',
    }


def _read_ini(path):
    config = configparser.ConfigParser()
    config.optionxform = lambda option: option
    config.read(path)
    return config


def build_synthetic_config(workdir, args):
    """DR16-shaped auto+cross injection at ap = at = 1 with realistic
    per-bin uncertainties; the posterior must recover the injection."""
    from vega_tpu.testing import make_synthetic_dataset
    main_path = make_synthetic_dataset(
        str(workdir), cross=True,
        sample={'ap': '0.9 1.1', 'at': '0.9 1.1',
                'bias_LYA': 'True', 'beta_LYA': 'True'})
    config = _read_ini(main_path)
    _sampler_sections(config, workdir, args)
    with open(main_path, 'w') as f:
        config.write(f)
    return main_path


def build_dr16_config(workdir, args):
    """The DR16-subset parity fixture with the BAO scale parameters
    sampled (identity covariance: timing benchmark, not a constraint)."""
    config = _read_ini(REFERENCE / 'tests' / 'full_configs' / 'main.ini')
    config['data sets']['ini files'] = ' '.join(
        str(REFERENCE / 'tests' / 'full_configs' / f'{c}.ini')
        for c in ('lyalya_lyalya', 'lyalya_lyalyb',
                  'lyalya_qso', 'lyalyb_qso'))
    config['sample']['ap'] = '0.8 1.2'
    config['sample']['at'] = '0.8 1.2'
    _sampler_sections(config, workdir, args)
    main_path = workdir / 'main.ini'
    with open(main_path, 'w') as f:
        config.write(f)
    return main_path


def main(argv=None):
    pars = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    pars.add_argument('--dataset', choices=('synthetic', 'dr16'),
                      default='synthetic')
    pars.add_argument('--sampler', choices=('ns', 'hmc'), default='ns',
                      help='ns: native nested sampling (posterior + '
                           'evidence); hmc: native exact-gradient HMC '
                           '(posterior only)')
    # 512 live points with the default batch_size (num_live // 4 = 128)
    # keeps every likelihood call at the one compiled chunk width (128)
    pars.add_argument('--num-live', type=int, default=512)
    pars.add_argument('--precision', type=float, default=1e-3)
    pars.add_argument('--batch-size', type=int, default=None)
    pars.add_argument('--workdir', type=str, default='/tmp/bao_demo')
    pars.add_argument('--cpu', action='store_true',
                      help='force the CPU backend (smoke-testing)')
    args = pars.parse_args(argv)

    if args.cpu:
        import jax
        jax.config.update('jax_platforms', 'cpu')

    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)

    import numpy as np

    from vega_tpu.parallel import BatchedLikelihood, make_device_mesh
    # the native batched sampler, explicitly: BatchedLikelihood.log_lik
    # takes parameter BATCHES, which the external pypolychord wrapper
    # (per-point callback) cannot drive
    from vega_tpu.samplers.nested import NestedSampler
    from vega_tpu.vega_interface import VegaInterface

    t0 = time.time()
    cwd = os.getcwd()
    if args.dataset == 'dr16':
        main_path = build_dr16_config(workdir, args)
        os.chdir(REFERENCE / 'tests')
    else:
        main_path = build_synthetic_config(workdir, args)
    try:
        vega = VegaInterface(str(main_path))
        t_init = time.time() - t0

        batched = BatchedLikelihood(vega, mesh=make_device_mesh())
        # one throwaway batch to split compile time out of sampling time
        # (>= chunk_per_device * n_devices so the compiled chunk width
        # matches the sampler's)
        warm_n = batched.chunk_per_device * batched.n_devices
        t1 = time.time()
        _ = batched.log_lik(
            {name: np.full(warm_n, vega.sample_params['values'][name])
             for name in vega.sample_params['limits']})
        t_compile = time.time() - t1

        t2 = time.time()
        if args.sampler == 'hmc':
            from vega_tpu.samplers.hmc import HMC
            sampler = HMC(vega.main_config['HMC'],
                          vega.sample_params['limits'], batched)
        else:
            # pass the BatchedLikelihood ITSELF (not its bound log_lik)
            # so the sampler can fuse the whole per-iteration slice
            # evolution into one on-device kernel (nested.py
            # _build_device_evolve), one dispatch per NS iteration
            sampler = NestedSampler(vega.main_config['Polychord'],
                                    vega.sample_params['limits'],
                                    batched,
                                    vega.corr_num_marg_modes)
        results = sampler.run()
        t_sample = time.time() - t2
    finally:
        os.chdir(cwd)

    names = list(vega.sample_params['limits'].keys())
    w = results.get('weights')
    if w is None:
        w = np.ones(len(results['samples']))
    mean = np.average(results['samples'], weights=w, axis=0)
    std = np.sqrt(np.average((results['samples'] - mean) ** 2,
                             weights=w, axis=0))
    print(f'\n=== BAO posterior ({args.dataset}, {args.sampler}, '
          f'{len(names)} sampled params) ===')
    if args.sampler == 'hmc':
        ess = float(np.min(results['ess']))
        print(f'init {t_init:.1f} s | compile {t_compile:.1f} s | '
              f'warmup+sampling {t_sample:.1f} s '
              f'(min ESS {ess:.0f} -> {ess / t_sample:.0f} ESS/s) | '
              f'total {time.time() - t0:.1f} s')
    else:
        n_evals = getattr(sampler, '_n_evals', 0)
        print(f'init {t_init:.1f} s | compile {t_compile:.1f} s | '
              f'sampling {t_sample:.1f} s ({n_evals} likelihood evals) | '
              f'total {time.time() - t0:.1f} s')
        print(f'logZ = {results["logz"]:.4f} '
              f'+/- {results["logz_err"]:.4f}')
    for i, name in enumerate(names):
        print(f'{name:>16s} = {mean[i]:+.5f} +/- {std[i]:.5f}')
    return results


if __name__ == '__main__':
    main()
