"""vega_tpu — JAX likelihood engine for Lyman-alpha forest
correlation-function analyses (BAO and full-shape fits).

A from-scratch JAX/XLA re-imagination of the capabilities of
andreicuceu/vega: the whole model + chi^2 pipeline compiles to a single
jitted function of the parameter vector, with vmap/shard_map batching of
likelihood evaluations across accelerator devices replacing the
reference's MPI fan-out.
"""

__version__ = '0.1.0'

import os as _os

import jax as _jax

# f64 everywhere: the correctness oracle is chi^2 agreement with the
# reference at ~1e-9 relative. VEGA_TPU_X64=0 opts into the f32 mode.
if _os.environ.get('VEGA_TPU_X64', '1') != '0':
    _jax.config.update('jax_enable_x64', True)

# f32 products at full f32 precision: without the pin XLA:GPU may run
# f32 dots in TF32 (about three decimal digits), which would silently
# break the f32 mode's accuracy. f64 products are unaffected.
_jax.config.update('jax_default_matmul_precision', 'highest')

# Persistent compilation cache: JAX_COMPILATION_CACHE_DIR wins when set
# (JAX reads it itself); otherwise a fixed directory beside the package,
# so every process of one checkout reuses the same compiled graphs.
if not _os.environ.get('JAX_COMPILATION_CACHE_DIR'):
    _jax.config.update('jax_compilation_cache_dir', _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        '.jax_cache'))

_EXPORTS = {
    'VegaInterface': 'vega_tpu.vega_interface',
    'BuildConfig': 'vega_tpu.build_config',
    'FitResults': 'vega_tpu.postprocess.fit_results',
    'VegaPlots': 'vega_tpu.plots.plot',
    'Wedge': 'vega_tpu.plots.wedges',
    'Shell': 'vega_tpu.plots.shell',
    'RtWedge': 'vega_tpu.plots.rt_wedges',
    'run_vega': 'vega_tpu.scripts.run_vega',
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    # Lazy exports keep import-time light and avoid circular imports
    if name in _EXPORTS:
        import importlib
        module = importlib.import_module(_EXPORTS[name])
        return getattr(module, name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
