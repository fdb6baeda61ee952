"""bench.py wiring check: VEGA_TPU_BENCH_SMOKE=1 runs the whole bench
script on the CPU backend with a tiny synthetic dataset and must print
exactly one valid JSON result line on stdout; outside smoke mode the
script refuses to measure anything but a GPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_bench_smoke_prints_one_json_line():
    env = dict(os.environ, VEGA_TPU_BENCH_SMOKE='1')
    env.pop('JAX_PLATFORMS', None)
    proc = subprocess.run(
        [sys.executable, str(REPO / 'bench.py')], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, proc.stdout
    result = json.loads(lines[0])
    assert result['metric'] == 'likelihood evals/sec/chip'
    assert result['value'] > 0
    assert result['vs_baseline'] > 0
    assert 'unit' in result


def test_bench_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    env.pop('VEGA_TPU_BENCH_SMOKE', None)
    proc = subprocess.run(
        [sys.executable, str(REPO / 'bench.py')], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ''
    assert 'no GPU' in proc.stderr
