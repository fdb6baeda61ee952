"""The grid-collapse chi^2 in plain f64 at a tiny size (fast tier): it
tracks the dense pipeline to the Chebyshev interpolation error, and the
batched path is an exact reassociation of the serial one."""

import numpy as np
import pytest

NAMES = ('ap', 'at', 'bias_LYA', 'beta_LYA')


@pytest.fixture(scope='module')
def grid_and_dense(tmp_path_factory):
    from vega_tpu.testing import make_synthetic_dataset
    from vega_tpu.vega_interface import VegaInterface

    workdir = tmp_path_factory.mktemp('grid_f64')
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_GRID_CACHE_DIR', str(workdir / 'cache'))
        main_path = make_synthetic_dataset(
            workdir, cross=False, size='tiny', noise=1.0,
            sample={n: 'True' for n in NAMES},
            extra_control='grid-nodes-ap = 24\ngrid-nodes-at = 24\n')
        vega = VegaInterface(main_path)
        assert '__grid__' in vega.get_collapsed(NAMES)
        rng = np.random.default_rng(0)
        points = [{'ap': 1 + rng.uniform(-0.1, 0.1),
                   'at': 1 + rng.uniform(-0.1, 0.1),
                   'bias_LYA': -0.117 * (1 + 0.05 * rng.normal()),
                   'beta_LYA': 1.67 * (1 + 0.05 * rng.normal())}
                  for _ in range(6)]
        grid = np.array([vega.chi2(p) for p in points])
        mp.setenv('VEGA_TPU_GRID_COLLAPSE', '0')
        dense_vega = VegaInterface(main_path)
        dense = np.array([dense_vega.chi2(p) for p in points])
    return vega, points, grid, dense


def test_grid_chi2_tracks_dense(grid_and_dense):
    """Measured on this setup: max |delta chi2| 0.027, relative 7.6e-5
    (24 nodes/dim, points within +-0.1 of the centre)."""
    _, _, grid, dense = grid_and_dense
    np.testing.assert_allclose(grid, dense, rtol=3e-4, atol=0.1)


def test_grid_batched_equals_serial(grid_and_dense):
    vega, points, grid, _ = grid_and_dense
    batched = vega.chi2_batch({n: np.array([p[n] for p in points])
                               for n in NAMES})
    np.testing.assert_allclose(batched, grid, rtol=1e-12)
