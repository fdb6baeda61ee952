"""chip_smoke.py at a tiny size on the CPU: every phase builds the
DR16-shaped fit, drives the entry points and runs its comparisons
against the CPU dense reference (here the "device" is the CPU too, so
this checks the wiring and the comparisons, not the card). The script
itself refuses to run without a GPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

PHASES = ['1 device', '2 construct and evaluate', '3 fit',
          '4 batched grid path', '5 batched dense path', '6 f32 mode',
          '7 memory']


@pytest.fixture(scope='module')
def phase_results(tmp_path_factory):
    workdir = tmp_path_factory.mktemp('smoke')
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('VEGA_TPU_GRID_CACHE_DIR', str(workdir / 'grid_cache'))
        mp.setenv('VEGA_TPU_GRID_VALIDATE', '8')
        return chip_smoke.run_phases(
            chip_smoke.one_gpu_phases(workdir, chip_smoke.TINY))


@pytest.mark.parametrize('phase', PHASES)
def test_phase_passes_at_tiny_size(phase_results, phase):
    assert phase_results[phase], f'phase {phase} failed (see stdout)'


def test_main_refuses_a_cpu_only_process(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


@pytest.mark.gpu
def test_chip_smoke_on_the_card(gpu_card):
    proc = subprocess.run(
        [sys.executable, str(REPO / 'chip_smoke.py')], cwd=REPO,
        env={k: v for k, v in os.environ.items()
             if k not in ('JAX_PLATFORMS', 'XLA_FLAGS')},
        capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last['ok'] and last['device']['platform'] == 'gpu'
