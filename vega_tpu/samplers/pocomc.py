"""PocoMC driver (config-compatible with the reference's
samplers/pocomc.py).

When pocomc is installed the external sampler is driven; otherwise the
same config is routed to the device-batched SMC sampler (samplers/smc.py),
which accepts the PocoMC option names (n_effective, seed).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

try:
    import pocomc
    from scipy.stats import uniform
    HAS_POCOMC = True
except ImportError:
    HAS_POCOMC = False

from .sampler_interface import Sampler
from .smc import SMCSampler


class PocoMC(Sampler):
    """(reference: samplers/pocomc.py:10-81)"""

    def __new__(cls, sampler_config, limits, log_lik_func):
        if not HAS_POCOMC:
            print('pocomc not available: using the native batched SMC '
                  'sampler with the PocoMC settings.')
            return SMCSampler(sampler_config, limits, log_lik_func)
        return super().__new__(cls)

    def get_sampler_settings(self, sampler_config, num_params, num_derived):
        self.precondition = sampler_config.getboolean('precondition', True)
        self.dynamic = sampler_config.getboolean('dynamic', False)
        self.n_effective = sampler_config.getint('n_effective', 512)
        self.n_active = sampler_config.getint('n_active', 256)
        self.n_total = sampler_config.getint('n_total', 1024)
        self.n_evidence = sampler_config.getint('n_evidence', 0)
        self.save_every = sampler_config.getint('save_every', 3)
        self.use_mpi = sampler_config.getboolean('use_mpi', False)
        self.num_cpu = sampler_config.getint('num_cpu', 64)
        self.pocomc_output = Path(self.path) / f'{self.name}_states'

        self.prior = pocomc.Prior([
            uniform(self.limits[par][0],
                    self.limits[par][1] - self.limits[par][0])
            for par in self.limits])

    def run(self):
        def vec_log_lik(theta):
            params = {name: theta[:, i]
                      for i, name in enumerate(self.names)}
            return np.asarray(self.log_lik(params))

        sampler = pocomc.Sampler(
            prior=self.prior, likelihood=vec_log_lik, vectorize=True,
            precondition=self.precondition, dynamic=self.dynamic,
            n_effective=self.n_effective, n_active=self.n_active,
            output_dir=self.pocomc_output)
        sampler.run(n_total=self.n_total, n_evidence=self.n_evidence,
                    save_every=self.save_every)
        self.write_pocomc_chain(sampler)
        return sampler

    def write_pocomc_chain(self, pocomc_sampler):
        """(reference: samplers/pocomc.py:57-81)"""
        samples, weights, logl, logp = pocomc_sampler.posterior()
        chain_path = Path(self.path) / (self.name + '.txt')
        chain = np.column_stack((weights, logl, samples))
        print(f'Writing chain to {chain_path}')
        np.savetxt(chain_path, chain,
                   header='Weights, Log Likelihood, ' + ', '.join(self.names))
        stats_path = Path(self.path) / (self.name + '.stats')
        np.savetxt(stats_path, np.column_stack((weights, logl, logp)),
                   header='Weights, Log Likelihood, Log Prior')
        logZ, logZerr = pocomc_sampler.evidence()
        print(f'log(Z) = {logZ} +/- {logZerr}')

    # reference method name (samplers/pocomc.py:57)
    write_chain = write_pocomc_chain
