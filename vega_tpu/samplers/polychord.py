"""PolyChord driver (config-compatible with the reference's
samplers/polychord.py).

When pypolychord is installed the external sampler is driven with the
same settings surface as the reference; otherwise the same config is
routed to the device-batched NestedSampler (samplers/nested.py),
which accepts the PolyChord option names (num_live, num_repeats,
precision, resume, seed).
"""

from __future__ import annotations

try:
    import pypolychord
    from pypolychord.priors import UniformPrior
    from pypolychord.settings import PolyChordSettings
    HAS_POLYCHORD = True
except ImportError:
    HAS_POLYCHORD = False

from .nested import NestedSampler
from .sampler_interface import Sampler


class Polychord(Sampler):
    """(reference: samplers/polychord.py:8-127)"""

    def __new__(cls, sampler_config, limits, log_lik_func,
                derived_dict=None):
        if not HAS_POLYCHORD:
            print('pypolychord not available: using the native batched '
                  'nested sampler with the PolyChord settings.')
            return NestedSampler(sampler_config, limits, log_lik_func,
                                 derived_dict=derived_dict)
        return super().__new__(cls)

    def get_sampler_settings(self, sampler_config, num_params, num_derived):
        seed = sampler_config.getint('seed', 0)
        num_live = sampler_config.getint('num_live', 25 * num_params)
        num_repeats = sampler_config.getint('num_repeats', 5 * num_params)
        precision = sampler_config.getfloat('precision', 0.001)
        resume = sampler_config.getboolean('resume', True)
        write_dead = sampler_config.getboolean('write_dead', True)
        boost_posterior = sampler_config.getfloat('boost_posterior', 0.0)
        do_clustering = sampler_config.getboolean('do_clustering', False)
        cluster_posteriors = sampler_config.getboolean(
            'cluster_posteriors', False)
        maximise = sampler_config.getboolean('maximise', False)

        self.settings = PolyChordSettings(
            num_params, num_derived, base_dir=self.path,
            file_root=self.name, seed=seed, nlive=num_live,
            num_repeats=num_repeats, precision_criterion=precision,
            write_resume=resume, read_resume=resume,
            boost_posterior=boost_posterior, do_clustering=do_clustering,
            cluster_posteriors=cluster_posteriors, equals=False,
            write_dead=write_dead, maximise=maximise, write_live=False,
            write_prior=False)

    def run(self):
        """(reference: samplers/polychord.py:94-127)"""
        def log_lik(theta):
            params = {name: theta[i] for i, name in enumerate(self.names)}
            log_lik_val, marg_coeff = self.log_lik(
                params, return_marg_coeff=True)
            return log_lik_val, marg_coeff

        def prior(hypercube):
            return [UniformPrior(lims[0], lims[1])(hypercube[i])
                    for i, lims in enumerate(self.limits.values())]

        def dumper(live, dead, logweights, logZ, logZ_err):
            pass

        pypolychord.run_polychord(log_lik, self.num_params,
                                  self.num_derived, self.settings, prior,
                                  dumper)
