"""fast_exp64 accuracy and the grid_exp dispatch.

VEGA_TPU_FAST_EXP=1 routes the hot (muk x k)-grid exponentials through
a Cody-Waite + degree-10 Taylor exp (utils.fast_exp64) instead of
jnp.exp. The chi^2 parity budget is 1e-8 relative; the kernel must sit
far inside it.
"""

import os

import numpy as np
import pytest

from vega_tpu import utils


def test_accuracy_across_range():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(-80, 10, 20000),
        rng.uniform(-1, 1, 5000),
        rng.uniform(-1e-6, 1e-6, 1000),
        np.array([0.0, -0.5, 0.25, np.log(2), -np.log(2)]),
    ])
    out = np.asarray(utils.fast_exp64(x))
    ref = np.exp(x)
    np.testing.assert_allclose(out, ref, rtol=5e-13)


def test_flush_and_specials():
    x = np.array([-1000.0, -87.4, -88.0, np.nan, -np.inf])
    out = np.asarray(utils.fast_exp64(x))
    assert out[0] == 0.0  # flushed (exp(-1000) is 0 in any physics sense)
    assert np.all(out[1:3] >= 0)
    assert np.isnan(out[3])
    assert out[4] == 0.0
    # +inf propagates as non-finite (the model's bad flags use isfinite)
    assert not np.isfinite(np.asarray(utils.fast_exp64(np.inf)))


def test_gradients_match_exp():
    import jax
    g_fast = jax.grad(lambda v: utils.fast_exp64(v))(0.3)
    g_ref = jax.grad(lambda v: jax.numpy.exp(v))(0.3)
    np.testing.assert_allclose(float(g_fast), float(g_ref), rtol=1e-10)


def test_env_override(monkeypatch):
    monkeypatch.setenv('VEGA_TPU_FAST_EXP', '1')
    assert utils.use_fast_exp()
    monkeypatch.setenv('VEGA_TPU_FAST_EXP', '0')
    assert not utils.use_fast_exp()
    monkeypatch.delenv('VEGA_TPU_FAST_EXP')
    # off unless explicitly requested
    assert not utils.use_fast_exp()


@pytest.mark.slow
def test_e2e_parity_with_fast_exp(monkeypatch):
    """Full likelihood with fast_exp forced on matches the exact-exp
    graph at the 1e-8 chi^2 parity budget."""
    ref_config = '/root/reference/tests/full_configs/main.ini'
    if not os.path.exists(ref_config):
        pytest.skip('reference data not available')
    from vega_tpu.vega_interface import VegaInterface

    vega = VegaInterface(ref_config)
    params = {name: float(val)
              for name, val in vega.sample_params['values'].items()}

    monkeypatch.setenv('VEGA_TPU_FAST_EXP', '0')
    chi2_exact = float(vega.chi2(params))
    monkeypatch.setenv('VEGA_TPU_FAST_EXP', '1')
    vega._jit_chi2 = None  # retrace with the fast-exp graph
    chi2_fast = float(vega.chi2(params))

    assert chi2_fast == pytest.approx(chi2_exact, rel=1e-9)
