"""chip_smoke.py's four-device phase at a tiny size on four virtual CPU
devices: the grid-path batch and a Monte-Carlo campaign sharded over a
4-device mesh agree with a 1-device mesh."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def test_four_device_phase_at_tiny_size(tmp_path, monkeypatch):
    monkeypatch.setenv('VEGA_TPU_GRID_CACHE_DIR', str(tmp_path / 'grid'))
    monkeypatch.setenv('VEGA_TPU_GRID_VALIDATE', '8')
    passed = chip_smoke.run_phases(chip_smoke.four_gpu_phases(tmp_path,
                                                            chip_smoke.TINY))
    assert all(passed.values()), passed
