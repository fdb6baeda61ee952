"""Tutorial 6 — Batched likelihoods, samplers, Monte-Carlo campaigns.

The device-batched replacement for the reference's MPI fan-outs: parameter
batches shard over a jax device Mesh, the native nested / SMC samplers
drive the batched likelihood, and mock campaigns fit every realization
simultaneously.

Run:  python 06_samplers_and_batching.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import configparser
import tempfile
from pathlib import Path

import numpy as np

from vega_tpu.parallel import (BatchedLikelihood, MonteCarloEngine,
                               make_device_mesh)
from vega_tpu.samplers.nested import NestedSampler
from vega_tpu.testing import make_synthetic_dataset
from vega_tpu.vega_interface import VegaInterface

workdir = Path(tempfile.mkdtemp(prefix='vega_tutorial_'))
vega = VegaInterface(make_synthetic_dataset(workdir, cross=False,
                                            size='tiny'))

# --- 1. Batched likelihood over a device mesh ------------------------
mesh = make_device_mesh()                  # all local devices, 1D
bl = BatchedLikelihood(vega, mesh=mesh)
batch = {'bias_LYA': np.linspace(-0.13, -0.10, 64),
         'beta_LYA': np.full(64, 1.67)}
chi2 = bl.chi2(batch)
print(f'64 chi^2 values in one sharded call: '
      f'min {chi2.min():.2f} at bias = '
      f'{batch["bias_LYA"][chi2.argmin()]:+.4f}')

# --- 2. Native nested sampling (posterior + evidence) ----------------
config = configparser.ConfigParser()
config.optionxform = lambda option: option
config['s'] = {'path': str(workdir), 'name': 'demo', 'num_live': '100',
               'num_repeats': '6', 'precision': '0.05', 'resume': 'False'}
limits = {'bias_LYA': (-0.15, -0.09), 'beta_LYA': (1.3, 2.1)}
ns = NestedSampler(config['s'], limits, bl.log_lik)
ns_results = ns.run()
mean = np.average(ns_results['samples'], axis=0,
                  weights=ns_results['weights'])
print(f'NS: logZ = {ns_results["logz"]:.2f}, posterior mean '
      f'bias = {mean[0]:+.4f}, beta = {mean[1]:.3f}')
# (chains land in getdist-compatible demo.txt / demo.paramnames)

# --- 2b. Exact-gradient HMC (posterior; no evidence) ------------------
# The chi^2 is one differentiable XLA graph, so HMC gets exact
# gradients and the whole trajectory loop runs on-device (lax.scan,
# chains vmapped) — something the reference's black-box likelihood
# cannot offer its samplers.
from vega_tpu.samplers.hmc import HMC

config['h'] = {'path': str(workdir), 'name': 'demo_hmc',
               'num_chains': '16', 'num_samples': '400',
               'num_warmup': '200', 'num_leapfrog': '10'}
hmc = HMC(config['h'], limits, bl)
hmc_results = hmc.run()
print(f'HMC: accept {hmc_results["accept_rate"]:.2f}, '
      f'max R-hat {hmc_results["r_hat"].max():.3f}, '
      f'mean bias = {hmc_results["samples"][:, 0].mean():+.4f}')

# --- 3. Monte-Carlo campaign: generate + fit all mocks at once -------
fiducial = vega.compute_model(run_init=False)
vega.monte_carlo = True
engine = MonteCarloEngine(vega, mesh=mesh)
mocks = engine.generate_mocks(fiducial, num_mocks=32, seed=1)
fits = engine.fit_mocks(mocks, sample_params=vega.sample_params,
                        max_iterations=50)
ok = int(np.sum(fits['valid']))
print(f'MC campaign: {ok}/32 valid fits, '
      f'<bias> = {fits["values"][:, 0].mean():+.4f} '
      f'(truth {vega.params["bias_LYA"]:+.4f})')
