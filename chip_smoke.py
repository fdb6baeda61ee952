#!/usr/bin/env python
"""Smoke run of the likelihood engine on one NVIDIA GPU.

Drives the main path once at full width through the normal entry points
(VegaInterface, minimize, BatchedLikelihood) on the DR16-shaped combined
fit: four correlations with 2,500-bin autos and 5,000-bin crosses,
Rogers2018 HCD, Arinyo, BAO broadening, Lorentz velocity dispersion and
SiII(1260)/SiIII(1207) metals, sampled set (ap, at, bias_LYA, beta_LYA),
data generated noiselessly from the model at the seeded truth
(vega_tpu.testing.build_dr16_configs). Every phase is checked against
the plain reference: the dense f64 pipeline (VEGA_TPU_FACTORED=0) on the
CPU backend of this same process.

    python chip_smoke.py              # one GPU: phases 1-7
    python chip_smoke.py --four-gpus  # only the 4-GPU sharded paths

Each phase prints its result, its tolerance and its wall time. The last
line of stdout is {"ok": true, "device": {...}} when every phase passed;
any failure exits non-zero. Without a GPU it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

# The plain reference runs on the CPU backend of this process.
_PLATFORMS = os.environ.get('JAX_PLATFORMS', '')
if _PLATFORMS and 'cpu' not in _PLATFORMS.split(','):
    os.environ['JAX_PLATFORMS'] = _PLATFORMS + ',cpu'

import numpy as np  # noqa: E402
import jax  # noqa: E402

HERE = Path(__file__).resolve().parent
FULL = {'nt': 50, 'grid_batches': (512, 8192), 'dense_batch': 128,
        'n_ref': 8, 'four_gpu_batch': 4 * 8192, 'n_mocks': 64}
# The same phases at a size the CPU runs in about a minute (tests).
TINY = {'nt': 10, 'grid_batches': (16, 64), 'dense_batch': 8, 'n_ref': 2,
        'four_gpu_batch': 32, 'n_mocks': 8,
        'control': {'grid-nodes-ap': '12', 'grid-nodes-at': '12'}}
NAMES = ('ap', 'at', 'bias_LYA', 'beta_LYA')
# Off-truth evaluation point: the data are noiseless, so chi^2 at the
# truth is ~0 and a relative comparison there would be meaningless.
POINT = {'ap': 1.012, 'at': 0.991, 'bias_LYA': -0.1193, 'beta_LYA': 1.64}

SAME_PATH_RTOL = 1e-9      # f64, GPU against CPU, same pipeline
SHARDED_RTOL = 1e-12       # f64, 4-device mesh against 1-device mesh
F32_RTOL = 1e-2            # tests/test_f32_mode.py pin


class PhaseFailed(Exception):
    pass


def log(msg):
    print(msg, flush=True)


def check(label, err, tol):
    """Print one comparison with its tolerance; raise when it fails."""
    ok = bool(np.all(np.isfinite(err))) and float(np.max(err)) <= tol
    log(f'  {label}: {float(np.max(err)):.3e} (tolerance {tol:.1e}) '
        f'{"PASS" if ok else "FAIL"}')
    if not ok:
        raise PhaseFailed(label)


def rel_err(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-300)


@contextlib.contextmanager
def env(**values):
    """Temporarily set environment options read at trace time."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def cpu_chi2(vega, points, collapsed=None):
    """chi^2 at each point on the CPU backend: the dense f64 pipeline
    (VEGA_TPU_FACTORED=0) when no collapse payload is given, else the
    same payload path as the device."""
    from vega_tpu.statics import STATICS

    cpu = jax.devices('cpu')[0]
    vega._ensure_static_refs()
    statics = jax.device_put(STATICS.host_tree(), cpu)
    data = jax.device_put(vega._current_data_vecs(), cpu)
    co = jax.device_put(collapsed or {}, cpu)
    cov = vega._current_cov_scales()
    fn = jax.jit(vega._chi2_graph_bound)
    factored = '1' if collapsed else '0'
    with env(VEGA_TPU_FACTORED=factored), jax.default_device(cpu):
        return np.array([float(fn({k: float(v) for k, v in p.items()},
                                  data, cov, statics, co)[0])
                         for p in points])


def card_line():
    smi = shutil.which('nvidia-smi')
    if smi is None:
        return 'nvidia-smi not found'
    out = subprocess.run([smi, '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or out.stderr.strip()


def draw_points(vega, spec, n, seed):
    """n points with every sampled parameter uniform inside its sampling
    limits (ap and at also inside the grid-collapse node domain)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in NAMES:
        lo, hi = vega.sample_params['limits'][name]
        if name in spec.names:
            d = spec.names.index(name)
            lo, hi = max(lo, spec.lo[d]), min(hi, spec.hi[d])
        out[name] = rng.uniform(lo, hi, n)
    return out


def rows(batches, idx):
    return [{k: float(v[i]) for k, v in batches.items()} for i in idx]


# --------------------------------------------------------------------------
# Phases (each returns what later phases need)
# --------------------------------------------------------------------------
def phase_device():
    devices = jax.devices()
    log(f'  jax.devices(): {devices}')
    log(f'  device_kind: {devices[0].device_kind}')
    log(f'  card: {card_line()}')
    return devices


def build_fit(workdir, size):
    """The DR16-shaped combined fit, data regenerated from the truth;
    returns its main.ini path."""
    from vega_tpu.testing import (build_dr16_configs,
                                  regenerate_dr16_from_truth)

    mains = build_dr16_configs(workdir, nt=size['nt'],
                               fit_types={'combined': (
                                   'lyaxlya_lyaxlyb_lyaxqso_lybxqso')},
                               control_extra=size.get('control'))
    regenerate_dr16_from_truth(workdir, mains['combined'], size['nt'])
    return mains['combined']


def phase_construct_and_evaluate(main_path):
    """VegaInterface + log_lik() / chi2() on the device at an off-truth
    stored point, against the CPU dense pipeline there."""
    from vega_tpu.vega_interface import VegaInterface

    vega, t = timed(VegaInterface, main_path)
    log(f'  VegaInterface built in {t:.2f} s')
    truth = {k: vega.params[k] for k in POINT}
    vega.params.update(POINT)
    try:
        chi2, t = timed(vega.chi2)
        log(f'  device chi2() = {chi2!r} ({t:.2f} s incl. compile)')
        log_lik = vega.log_lik()
        log(f'  device log_lik() = {log_lik!r}')
        ref = cpu_chi2(vega, [POINT])[0]
    finally:
        vega.params.update(truth)
    log(f'  CPU dense chi2 = {ref!r}')
    check('chi2 |d|/chi2, device vs CPU dense', rel_err(chi2, ref),
          SAME_PATH_RTOL)
    ref_ll = vega._log_norm() - 0.5 * ref
    check('log_lik |d|/|log_lik|, device vs CPU dense',
          rel_err(log_lik, ref_ll), SAME_PATH_RTOL)
    return vega, chi2


def phase_fit(vega):
    """minimize() through the grid collapse: pulls against the injected
    truth, and the device chi^2 at the best fit against the CPU dense
    chi^2 there within the payload's build-time probe error."""
    from vega_tpu.testing import DR16_PARAMETERS

    _, t = timed(vega.minimize)
    log(f'  minimize() in {t:.2f} s')
    payload = vega.get_collapsed(NAMES)
    spec = payload['__grid__']
    log(f'  grid payload: {spec}')
    values = {k: float(v) for k, v in vega.bestfit.values.items()}
    errors = {k: float(v) for k, v in vega.bestfit.errors.items()}
    for name in NAMES:
        pull = (values[name] - DR16_PARAMETERS[name]) / max(errors[name],
                                                            1e-12)
        log(f'  {name} = {values[name]:+.6f} +- {errors[name]:.6f} '
            f'(truth {DR16_PARAMETERS[name]:+.4f})')
        check(f'|pull| {name}', abs(pull), 5.0)
    best = {k: values[k] for k in NAMES}
    chi2 = vega.chi2(best)
    ref = cpu_chi2(vega, [best])[0]
    probe_err = sum(float(payload[c]['probe_err'])
                    for c in payload if c != '__grid__')
    log(f'  device grid chi2 at best fit = {chi2!r}; CPU dense = {ref!r}')
    if not probe_err > 0:
        raise PhaseFailed('payload carries no probe error')
    check('|d chi2| at best fit, grid (device) vs dense (CPU), vs '
          'probe_err', abs(chi2 - ref), probe_err)
    return spec


def phase_batched_grid(vega, spec, size, seed=1):
    """BatchedLikelihood on the grid path at the sampler widths, against
    the same payload on the CPU at n_ref points."""
    from vega_tpu.parallel import BatchedLikelihood

    bl = BatchedLikelihood(vega)
    small, large = size['grid_batches']
    batches = draw_points(vega, spec, large, seed)
    out = {}
    for n in (small, large):
        sub = {k: v[:n] for k, v in batches.items()}
        out[n], t_first = timed(bl.chi2, sub)
        steady = []
        for _ in range(3):
            steady.append(timed(bl.chi2, sub)[1])
        log(f'  batch {n}: first call {t_first:.3f} s, steady median '
            f'{np.median(steady) * 1e3:.3f} ms '
            f'({n / np.median(steady):.1f} evals/s)')
        if not np.all(np.isfinite(out[n])):
            raise PhaseFailed(f'non-finite chi2 at batch {n}')
    check(f'batch {small} vs batch {large} on shared points',
          rel_err(out[small], out[large][:small]), SAME_PATH_RTOL)
    idx = range(size['n_ref'])
    ref = cpu_chi2(vega, rows(batches, idx),
                   collapsed=vega.get_collapsed(NAMES))
    check('grid chi2 |d|/chi2, device batch vs CPU same payload',
          rel_err(out[large][:len(ref)], ref), SAME_PATH_RTOL)
    return bl, batches


def phase_batched_dense(main_path, batches, size):
    """BatchedLikelihood on the dense pipeline against the CPU dense
    pipeline."""
    from vega_tpu.vega_interface import VegaInterface
    from vega_tpu.parallel import BatchedLikelihood

    n = size['dense_batch']
    sub = {k: v[:n] for k, v in batches.items()}
    with env(VEGA_TPU_FACTORED='0'):
        vega = VegaInterface(main_path)
        bl = BatchedLikelihood(vega)
        out, t_first = timed(bl.chi2, sub)
        _, t_steady = timed(bl.chi2, sub)
    log(f'  batch {n}: first call {t_first:.3f} s, steady '
        f'{t_steady * 1e3:.3f} ms ({n / t_steady:.1f} evals/s)')
    ref = cpu_chi2(vega, rows(sub, range(size['n_ref'])))
    check('dense chi2 |d|/chi2, device batch vs CPU dense',
          rel_err(out[:len(ref)], ref), SAME_PATH_RTOL)
    return bl, sub


def phase_f32(main_path, chi2_f64):
    """f32 mode, toggled in-process, against the f64 device value of
    phase 2 at the same point."""
    from vega_tpu.vega_interface import VegaInterface

    prev = jax.config.jax_enable_x64
    jax.config.update('jax_enable_x64', False)
    try:
        vega = VegaInterface(main_path)
        vega.params.update(POINT)
        chi2, t = timed(vega.chi2)
    finally:
        jax.config.update('jax_enable_x64', prev)
    log(f'  f32 device chi2() = {chi2!r} ({t:.2f} s); f64 = {chi2_f64!r}')
    check('chi2 |d|/chi2, f32 vs f64 (device)', rel_err(chi2, chi2_f64),
          F32_RTOL)


def _print_memory(label, compiled):
    mem = compiled.memory_analysis()
    fields = ('argument_size_in_bytes', 'output_size_in_bytes',
              'temp_size_in_bytes', 'alias_size_in_bytes',
              'generated_code_size_in_bytes')
    log(f'  {label}: ' + ', '.join(
        f'{f.replace("_size_in_bytes", "")}={getattr(mem, f, None)}'
        for f in fields))


def phase_memory(vega, spec, grid_bl, grid_batches, dense_bl, dense_sub):
    """compiled.memory_analysis() of the batched chi^2 steps and of one
    grid-sweep chunk."""
    from vega_tpu.gridcollapse import sweep_chunk_fn
    from vega_tpu.statics import STATICS

    fn, args, _ = grid_bl.prepare(grid_batches)
    with grid_bl.mesh:
        _print_memory(f'batched grid chi2 step, batch '
                      f'{len(grid_batches["ap"])}',
                      fn.lower(*args).compile())
    with env(VEGA_TPU_FACTORED='0'):
        fn, args, _ = dense_bl.prepare(dense_sub)
        with dense_bl.mesh:
            _print_memory(f'batched dense chi2 step, batch '
                          f'{len(dense_sub["ap"])}',
                          fn.lower(*args).compile())
    chunk = int(os.environ.get('VEGA_TPU_GRID_SWEEP_CHUNK', 32))
    base = {name: float(vega.params[name]) for name in NAMES}
    nodes = np.tile(np.asarray(spec.ref), (chunk, 1))
    _print_memory(f'grid-sweep chunk of {chunk} nodes',
                  sweep_chunk_fn(vega, spec).lower(
                      nodes, base, vega._current_data_vecs(),
                      STATICS.device_tree()).compile())
    stats = jax.devices()[0].memory_stats() or {}
    log(f'  peak_bytes_in_use: {stats.get("peak_bytes_in_use")}')


def phase_four_devices(main_path, size, n_devices=4, seed=2):
    """The paths users shard over every local device — sampler batches
    on the grid path and a Monte-Carlo campaign — on an n-device mesh
    against a 1-device mesh."""
    from vega_tpu.parallel import (BatchedLikelihood, MonteCarloEngine,
                                   make_device_mesh)
    from vega_tpu.vega_interface import VegaInterface

    if len(jax.devices()) < n_devices:
        raise PhaseFailed(f'needs {n_devices} devices, have '
                          f'{len(jax.devices())}')
    meshes = {n_devices: make_device_mesh(n_devices),
              1: make_device_mesh(1)}
    vega = VegaInterface(main_path)
    _, t = timed(vega.get_collapsed, NAMES)
    spec = vega.get_collapsed(NAMES)['__grid__']
    log(f'  grid payload in {t:.2f} s: {spec}')
    batches = draw_points(vega, spec, size['four_gpu_batch'], seed)
    chi2 = {}
    for n, mesh in meshes.items():
        bl = BatchedLikelihood(vega, mesh=mesh)
        chi2[n], t_first = timed(bl.chi2, batches)
        steady = [timed(bl.chi2, batches)[1] for _ in range(3)]
        log(f'  grid batch {len(batches["ap"])} on {n} device(s): first '
            f'{t_first:.3f} s, steady median {np.median(steady) * 1e3:.3f}'
            f' ms ({len(batches["ap"]) / np.median(steady):.1f} evals/s)')
    check(f'grid chi2 |d|/chi2, {n_devices} devices vs 1',
          rel_err(chi2[n_devices], chi2[1]), SHARDED_RTOL)

    fiducial = vega.compute_model(run_init=False)
    fits = {}
    for n, mesh in meshes.items():
        engine = MonteCarloEngine(vega, mesh=mesh)
        mocks, t_gen = timed(engine.generate_mocks, fiducial,
                             size['n_mocks'], 1)
        fits[n], t_fit = timed(engine.fit_mocks, mocks)
        fits[n]['mocks'] = mocks
        log(f'  {size["n_mocks"]} mocks on {n} device(s): generate '
            f'{t_gen:.3f} s, fit {t_fit:.3f} s, '
            f'{int(fits[n]["valid"].sum())} valid')
    for name in vega.corr_items:
        check(f'mock {name} |d|/|mock|, {n_devices} devices vs 1',
              rel_err(fits[n_devices]['mocks'][name],
                      fits[1]['mocks'][name]), SHARDED_RTOL)
    for n in meshes:
        if not fits[n]['valid'].all():
            raise PhaseFailed(f'invalid mock fits on {n} device(s)')
    # 1e-6 of the statistical error: agreement far below anything a
    # sharding fault would produce, while allowing last-bit differences
    # between the two compiled programs to move the Newton iterates
    dev = np.abs(fits[n_devices]['values'] - fits[1]['values'])
    check(f'mock best fits |d|/sigma, {n_devices} devices vs 1',
          dev / fits[1]['errors'], 1e-6)


# --------------------------------------------------------------------------
def run_phases(phases):
    """Run (name, fn) phases in order. Every phase runs and reports;
    returns {name: passed}."""
    passed = {}
    for name, fn in phases:
        log(f'PHASE {name}')
        t0 = time.perf_counter()
        try:
            fn()
            passed[name] = True
        except Exception:           # reported, and fails the run in main
            traceback.print_exc()
            passed[name] = False
        log(f'PHASE {name}: {"ok" if passed[name] else "FAILED"} in '
            f'{time.perf_counter() - t0:.2f} s')
    return passed


def one_gpu_phases(workdir, size):
    """Phases 1-7 as (name, fn); later phases use what earlier ones
    built."""
    s = {}

    def construct():
        s['main'] = build_fit(workdir, size)
        s['vega'], s['chi2'] = phase_construct_and_evaluate(s['main'])

    def fit():
        s['spec'] = phase_fit(s['vega'])

    def grid():
        s['grid_bl'], s['batches'] = phase_batched_grid(
            s['vega'], s['spec'], size)

    def dense():
        s['dense_bl'], s['dense_sub'] = phase_batched_dense(
            s['main'], s['batches'], size)

    def memory():
        phase_memory(s['vega'], s['spec'], s['grid_bl'], s['batches'],
                     s['dense_bl'], s['dense_sub'])

    return [('1 device', phase_device),
            ('2 construct and evaluate', construct),
            ('3 fit', fit),
            ('4 batched grid path', grid),
            ('5 batched dense path', dense),
            ('6 f32 mode', lambda: phase_f32(s['main'], s['chi2'])),
            ('7 memory', memory)]


def four_gpu_phases(workdir, size):
    return [('1 device', phase_device),
            ('8 four devices',
             lambda: phase_four_devices(build_fit(workdir, size), size))]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--four-gpus', action='store_true',
                        help='run only the 4-GPU sharded paths')
    args = parser.parse_args(argv)

    devices = jax.devices()
    if devices[0].platform != 'gpu':
        print(f'chip_smoke: no GPU (jax.devices() = {devices}); nothing '
              'was run', file=sys.stderr)
        return 1
    from vega_tpu.testing import build_dr16_configs  # noqa: F401 (fail early)

    workdir = HERE / '.smoke_work'
    shutil.rmtree(workdir, ignore_errors=True)
    os.environ['VEGA_TPU_GRID_CACHE_DIR'] = str(workdir / 'grid_cache')
    # held-out validation probes give the payload its probe_err
    os.environ.setdefault('VEGA_TPU_GRID_VALIDATE', '8')

    phases = (four_gpu_phases if args.four_gpus else one_gpu_phases)(
        workdir, FULL)
    if not all(run_phases(phases).values()):
        return 1
    print(json.dumps({'ok': True, 'device': {
        'platform': devices[0].platform, 'kind': devices[0].device_kind,
        'count': len(devices)}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
