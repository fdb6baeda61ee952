"""Package start-up and process-level settings, each checked in a fresh
subprocess (they act at import time or on process-global state)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _run(code, *args, extra_env=None, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env['PYTHONPATH'] = str(REPO) + os.pathsep + env.get('PYTHONPATH', '')
    env.update(extra_env or {})
    proc = subprocess.run([sys.executable, '-c', code, *args], env=env,
                          capture_output=True, text=True, timeout=600,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


CACHE_CODE = r"""
import json, jax, vega_tpu
print(json.dumps({'dir': jax.config.jax_compilation_cache_dir}))
"""


@pytest.mark.parametrize('from_env', [True, False],
                         ids=['env-dir', 'checkout-default'])
def test_compile_cache_location(tmp_path, from_env):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits
    at a fixed directory of the checkout, the same in every process."""
    if from_env:
        out = _run(CACHE_CODE, extra_env={
            'JAX_COMPILATION_CACHE_DIR': str(tmp_path)})
        assert out['dir'] == str(tmp_path)
    else:
        out = _run(CACHE_CODE, drop=('JAX_COMPILATION_CACHE_DIR',))
        assert out['dir'] == str(REPO / '.jax_cache')


def test_f32_mode_pins_matmul_precision():
    """VEGA_TPU_X64=0 runs f32, and f32 products are pinned to full f32
    precision (no TF32 on the GPU)."""
    out = _run(r"""
import json, jax, vega_tpu
print(json.dumps({'x64': jax.config.jax_enable_x64,
                  'precision': str(jax.config.jax_default_matmul_precision)}))
""", extra_env={'VEGA_TPU_X64': '0', 'JAX_PLATFORMS': 'cpu'})
    assert out == {'x64': False, 'precision': 'highest'}


def test_interface_and_fit_without_matplotlib(tmp_path):
    """Constructing a VegaInterface, evaluating chi^2 and fitting need no
    matplotlib (the GPU machine may not have it)."""
    out = _run(r"""
import json, sys
sys.modules['matplotlib'] = None          # any import of it now fails
import jax
jax.config.update('jax_platforms', 'cpu')
from vega_tpu.testing import make_synthetic_dataset
from vega_tpu.vega_interface import VegaInterface
vega = VegaInterface(make_synthetic_dataset(sys.argv[1], cross=False,
                                            size='tiny'))
chi2 = vega.chi2({'bias_LYA': -0.12, 'beta_LYA': 1.6})
vega.minimize()
print(json.dumps({'chi2': chi2, 'bias': vega.bestfit.values['bias_LYA'],
                  'mpl': 'matplotlib.pyplot' in sys.modules}))
""", str(tmp_path), extra_env={'JAX_PLATFORMS': 'cpu'})
    assert out['chi2'] > 0
    assert out['bias'] == pytest.approx(-0.117, abs=1e-3)
    assert not out['mpl']
