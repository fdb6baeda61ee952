#!/usr/bin/env python
"""Benchmark: likelihood evaluations per second per device.

Measures the batched (vmapped) jitted chi^2 throughput on the flagship
auto+cross configuration — the hot loop of every fit, scan, sampler run
and Monte-Carlo pipeline. When the reference checkout's DR16-subset
4-correlation config is available it is used (the BASELINE.md headline
configuration); otherwise a synthetic auto+cross setup of the same shape.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

vs_baseline: the reference (andreicuceu/vega) evaluates the same
4-correlation chi^2 in pure numpy/scipy on a single core. MEASURED on a
host CPU by driving the live reference through the dependency shims
(benchmarks/reference_baseline.py; the reference publishes no number,
BASELINE.md): 1.15 evals/s nuisance-only (warm caches), 1.17 evals/s
with (ap, at) varied. The divisor is the FASTER of the two regimes from
benchmarks/reference_baseline.json (generous to the reference), falling
back to a conservative 10 evals/s if the measurement file is missing.

The default regime samples (ap, at) with the nuisance parameters, served
by the Chebyshev grid collapse (vega_tpu/gridcollapse.py) at the shipped
settings (+/-0.25 alpha domain, 32 nodes/dim), at batch 8192 per device:
the widths MC fleets, chi^2 scans and nested-sampling live-point batches
present. The benchmark needs a GPU and exits non-zero without one;
VEGA_TPU_BENCH_SMOKE=1 is a CPU wiring check of this script at a tiny
size, whose number is not a device measurement.
"""

import contextlib
import json
import os
import sys
import time

def reference_evals_per_sec():
    """Measured single-core throughput of the live reference on this
    host (benchmarks/reference_baseline.py), the faster of its two
    regimes; conservative 10 evals/s fallback when unmeasured."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'benchmarks', 'reference_baseline.json')
    try:
        with open(path) as fh:
            meas = json.load(fh)
        return max(meas['nuisance_only']['evals_per_sec'],
                   meas['bao_sampled']['evals_per_sec'])
    except (OSError, KeyError, ValueError):
        return 10.0


def main():
    # f64 matches the reference at 1e-9 relative; f32 is the opt-in
    # reduced-precision mode
    precision = os.environ.get('VEGA_TPU_BENCH_PRECISION', 'f64')
    if precision == 'f32':
        os.environ['VEGA_TPU_X64'] = '0'
    # VEGA_TPU_BENCH_SMOKE=1: CPU backend, tiny synthetic dataset, small
    # batch — a fast wiring check of this script (used by the test
    # suite; the reported number is NOT a hardware benchmark)
    smoke = os.environ.get('VEGA_TPU_BENCH_SMOKE', '0') == '1'
    import jax
    if precision == 'f32':
        jax.config.update('jax_enable_x64', False)
    if smoke:
        jax.config.update('jax_platforms', 'cpu')
    elif jax.devices()[0].platform != 'gpu':
        print(f'bench.py: no GPU (jax.devices() = {jax.devices()}); a '
              'benchmark measures the card, so nothing was run',
              file=sys.stderr)
        return 1

    import numpy as np

    from vega_tpu.vega_interface import VegaInterface
    from vega_tpu.parallel import BatchedLikelihood, make_device_mesh

    # VEGA_TPU_BENCH_TABLE6=1: the FULL Table-6 sampled regime — all
    # 13 parameters the reference's own DR16 combined fit samples
    # (reference examples/eBOSS_DR16/main_combined.ini [sample],
    # bias_eta naming per the test config) in the batch, with the four
    # nonlinear scale parameters (ap, at, drp_QSO,
    # sigma_velo_disp_lorentz_QSO) served by the 4-dim grid collapse
    # (anisotropic combination schedule, production domains: +/-0.25
    # alphas, drp [-3, 3], sigma [0, 15]; accuracy measured by
    # benchmarks/table6_accuracy.py: max |delta chi2| vs dense 1.6e-3
    # with all 13 varied). Requires the reference checkout.
    bench_table6 = os.environ.get('VEGA_TPU_BENCH_TABLE6', '0') == '1'

    # Prefer the reference DR16-subset config (the BASELINE headline).
    # Init-time INFO prints go to stderr so stdout carries only the JSON.
    with contextlib.redirect_stdout(sys.stderr):
        ref_config = '/root/reference/tests/full_configs/main.ini'
        if bench_table6 and os.path.isdir('/root/reference/tests') \
                and not smoke:
            sys.path.insert(0, os.path.join(
                os.path.dirname(os.path.abspath(__file__)), 'benchmarks'))
            import tempfile
            from table6_accuracy import patch_config
            workdir = tempfile.mkdtemp(prefix='vega_tpu_bench_t6_')
            patch_config(workdir)
            os.chdir(workdir)
            vega = VegaInterface('full_configs/main.ini')
            sampled = {
                'bias_eta_LYA': -0.2008, 'beta_LYA': 1.67,
                'bias_hcd': -0.05, 'beta_hcd': 0.7, 'beta_QSO': 0.255,
                'drp_QSO': 0.0, 'sigma_velo_disp_lorentz_QSO': 6.86,
                'bias_eta_SiII(1190)': -0.0026,
                'bias_eta_SiII(1193)': -0.0012,
                'bias_eta_SiIII(1207)': -0.0037,
                'bias_eta_SiII(1260)': -0.0023,
            }
        elif os.path.isdir('/root/reference/tests') and not smoke:
            os.chdir('/root/reference/tests')
            vega = VegaInterface(ref_config)
            sampled = {'bias_eta_LYA': -0.2008, 'beta_LYA': 1.67}
        else:
            import tempfile
            from vega_tpu.testing import make_synthetic_dataset
            workdir = tempfile.mkdtemp(prefix='vega_tpu_bench_')
            vega = VegaInterface(make_synthetic_dataset(
                workdir, cross=True, size='tiny' if smoke else 'full'))
            sampled = {'bias_LYA': -0.117, 'beta_LYA': 1.67}

    # VEGA_TPU_BENCH_AP=1 (DEFAULT): add (alpha_par, alpha_perp) to the
    # batch — the BAO-sampling regime, served by the grid collapse
    # (vega_tpu/gridcollapse.py; docs/performance.md for the measured
    # chi^2 accuracy bound of that path). This is the regime BAO
    # science actually runs in, so it is the one the headline reports;
    # VEGA_TPU_BENCH_AP=0 measures the nuisance-only collapsed regime.
    bench_ap = os.environ.get('VEGA_TPU_BENCH_AP', '1') == '1'
    if bench_ap:
        sampled = dict(sampled, ap=1.0, at=1.0)
        # The grid collapse runs at the SHIPPED production defaults
        # (+/-0.25 alpha domain, 32 Chebyshev nodes/dim) — the
        # configuration a wide-prior nested-sampling run actually uses.
        # The error-budgeted mode truncation keeps the per-eval payload
        # tiny on the wide domain too (measured on the reference
        # config: max |delta chi2| vs dense = 1.7e-10, 31/1/3/3 of the
        # 1024-4096 tensor modes retained at the default 2e-4 budget;
        # benchmarks/grid_accuracy*.json), so unlike rounds 2-3 no
        # narrowed node budget is applied here.

    n_devices = len(jax.devices())
    mesh = make_device_mesh()
    bl = BatchedLikelihood(vega, mesh=mesh)

    batch_size = int(os.environ.get(
        'VEGA_TPU_BENCH_BATCH', 64 if smoke else 8192)) * n_devices
    rng = np.random.default_rng(0)
    batches = {
        name: val + 0.01 * np.abs(val) * rng.normal(size=batch_size)
        for name, val in sampled.items()
    }

    # One-time basis/grid collapse (grid payloads are served from the
    # disk cache when a previous process of the same fit built them —
    # see gridcollapse.payload_fingerprint), then the compile of the
    # batched step. Reported separately: the sweep is once per fit, the
    # compile once per process.
    t0 = time.time()
    vega.get_collapsed(tuple(sorted(batches)))
    sweep_time = time.time() - t0
    t0 = time.time()
    chi2 = bl.chi2(batches)
    compile_time = time.time() - t0
    assert np.all(np.isfinite(chi2)), 'non-finite chi2 in benchmark'

    # Timed runs: per-round rates, median reported; the median of 5
    # per-round rates is robust to one stalled round where the mean
    # over a single wall-clock interval is not.
    n_rounds = 2 if smoke else 5
    rates = []
    for i in range(n_rounds):
        for name in batches:
            batches[name] = batches[name] + 1e-6  # defeat caching
        t0 = time.time()
        chi2 = bl.chi2(batches)
        rates.append(batch_size / (time.time() - t0))

    evals_per_sec = float(np.median(rates))
    evals_per_sec_per_chip = evals_per_sec / n_devices

    result = {
        'metric': 'likelihood evals/sec/chip',
        'value': round(evals_per_sec_per_chip, 3),
        'unit': f'evals/s/chip (batch={batch_size}, {precision}, '
                f'{n_devices} chip(s), collapse={sweep_time:.1f}s, '
                f'compile={compile_time:.1f}s'
                f'{", Table-6 full sampled set" if bench_table6 else ""})',
        'vs_baseline': round(evals_per_sec_per_chip
                             / reference_evals_per_sec(), 3),
    }
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
