"""Self-contained synthetic datasets for tests, benchmarks and demos.

Generates a complete fit setup (fiducial template, correlation data FITS,
main.ini + per-correlation ini) in a target directory with no external
data dependencies. The data vectors are drawn from the framework's own
model at fiducial parameters, so fits have a known truth.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .coordinates import Coordinates
from .io.fits import write_fits
from .models.eisenstein_hu import make_fiducial_template

DEFAULT_PARAMS = {
    'ap': 1.0, 'at': 1.0, 'bao_amp': 1.0,
    'bias_LYA': -0.117, 'beta_LYA': 1.67, 'alpha_LYA': 2.9,
    'bias_QSO': 3.7, 'beta_QSO': 0.26, 'alpha_QSO': 1.44,
    'drp_QSO': 0.0, 'sigma_velo_disp_lorentz_QSO': 6.86,
    'sigmaNL_per': 3.24, 'sigmaNL_par': 6.37,
    'growth_rate': 0.97,
}


def _auto_ini(data_file, name='lyaxlya', extra_model=''):
    return f"""[data]
name = {name}
tracer1 = LYA
tracer2 = LYA
tracer1-type = continuous
tracer2-type = continuous
filename = {data_file}

[cuts]
rp-min = 0.
rp-max = +200.
rt-min = 0.
rt-max = 200.
r-min = 10.
r-max = 180.
mu-min = -1.
mu-max = +1.

[model]
z evol LYA = bias_vs_z_std
{extra_model}
"""


def _cross_ini(data_file, name='qsoxlya', extra_model=''):
    return f"""[data]
name = {name}
tracer1 = QSO
tracer2 = LYA
tracer1-type = discrete
tracer2-type = continuous
filename = {data_file}

[cuts]
rp-min = -200.
rp-max = +200.
rt-min = 0.
rt-max = 200.
r-min = 10.
r-max = 180.
mu-min = -1.
mu-max = +1.

[model]
z evol LYA = bias_vs_z_std
z evol QSO = bias_vs_z_std
velocity dispersion = lorentz
{extra_model}
"""


def _main_ini(ini_files, template_file, out_file, sample=None, zeff=2.33,
              global_cov_file=None, extra_control=''):
    sample = sample or {'bias_LYA': 'True', 'beta_LYA': 'True'}
    sample_block = '\n'.join(f'{k} = {v}' for k, v in sample.items())
    params_block = '\n'.join(f'{k} = {v}' for k, v in DEFAULT_PARAMS.items())
    global_cov_line = (f'global-cov-file = {global_cov_file}'
                       if global_cov_file else '')
    return f"""[data sets]
zeff = {zeff}
ini files = {' '.join(str(f) for f in ini_files)}
{global_cov_line}

[cosmo-fit type]
cosmo fit func = ap_at

[fiducial]
filename = {template_file}

[control]
{extra_control}

[output]
filename = {out_file}

[sample]
{sample_block}

[parameters]
{params_block}
"""


def _write_correlation_data(path, is_cross, z_eff, rng, model_xi=None,
                            noise=0.0, nt=50, with_distortion=False):
    """Write a picca-export-style correlation FITS file with synthetic
    contents (same layout as reference tests/data/*-exp.fits.gz)."""
    if is_cross:
        coords = Coordinates(-200., 200., 200., 2 * nt, nt)
    else:
        coords = Coordinates(0., 200., 200., nt, nt)
    n = coords.rp_grid.size

    if model_xi is None:
        # A smooth placeholder correlation with a BAO-like bump
        r = np.maximum(coords.r_grid, 1.0)
        model_xi = (5e-3 / r ** 1.5 * (1 + 0.3 * np.exp(
            -(r - 105.0) ** 2 / (2 * 15.0 ** 2))))

    # Realistic per-bin uncertainties (S/N ~ 20) so synthetic fits are
    # well-conditioned; written as a diagonal covariance
    sigma = 1e-6 + 0.05 * np.abs(model_xi)
    da = model_xi + noise * sigma * rng.normal(size=n)
    cov = np.diag(sigma ** 2)
    z = np.full(n, z_eff)
    nb = np.full(n, 1000, dtype=np.int64)

    header = {
        'RPMIN': coords.rp_min, 'RPMAX': coords.rp_max,
        'RTMAX': coords.rt_max, 'NP': coords.rp_nbins,
        'NT': coords.rt_nbins, 'BLINDING': 'none',
    }
    columns = {'RP': coords.rp_grid, 'RT': coords.rt_grid, 'Z': z,
               'DA': da, 'CO': cov, 'NB': nb}
    if with_distortion:
        # A mild smoothing distortion along rt (banded, row-normalized)
        dm = np.eye(n) * 0.9
        off = np.eye(n, k=1) * 0.05 + np.eye(n, k=-1) * 0.05
        dm = dm + off
        dm /= dm.sum(axis=1, keepdims=True)
        columns['DM'] = dm
    write_fits(path, [
        {'name': 'COR', 'header': header, 'columns': columns},
        {'name': 'DMATTRI',
         'columns': {'DMRP': coords.rp_grid, 'DMRT': coords.rt_grid,
                     'DMZ': z}},
    ])
    return coords


def metal_rp_shifts(metals, z_eff, main_absorber='LYA', omega_m=0.315):
    """Physical line-of-sight coordinate offsets (Mpc/h) for absorbers of
    each metal line misidentified as `main_absorber`: an absorber at
    observed wavelength w assumed to sit at z_assumed = w/lambda_main - 1
    truly sits at z_true = w/lambda_metal - 1, so its comoving position
    is off by r(z_true) - r(z_assumed).  This is what puts the SiIII(1207)
    contamination bump at rp ~ 21 Mpc/h in the DR16 auto-correlation
    (reference: metals.py:523-535 builds the full per-pair version of
    this inside the new-metals distortion matrices)."""
    from .cosmo import ABSORBER_IGM, Cosmo
    cosmo = Cosmo(Om=omega_m)
    lam_main = ABSORBER_IGM[main_absorber]
    wave = lam_main * (1.0 + z_eff)     # observed wavelength at z_eff
    shifts = {}
    for m in metals:
        z_true = wave / ABSORBER_IGM[m] - 1.0
        shifts[m] = float(cosmo.get_r_comov(z_true)
                          - cosmo.get_r_comov(z_eff))
    return shifts


def write_metal_file(path, coords, z_eff, tracer1, tracer2,
                     metals_in1=(), metals_in2=(), rp_shifts=None):
    """Write a picca-style metal file with coordinate columns for every
    metal pair a Data reader may request (RP_/RT_/Z_ per pair name, both
    orders), and NO distortion columns — with `test = True` in [data]
    the reader substitutes identity metal matrices (mirrors the
    reference's test fixtures, reference data.py:683-684).

    rp_shifts: optional {absorber: Mpc/h offset} (see metal_rp_shifts).
    When given, each pair's RP column is offset by the difference of its
    two absorbers' shifts (main tracers shift by 0), mimicking the
    shifted effective separations real picca metal files carry and
    making different metal lines distinguishable in a fit."""
    pair_names = set()
    for m in metals_in2:
        pair_names.add(f'{tracer1}_{m}')
        pair_names.add(f'{m}_{tracer1}')
    for m in metals_in1:
        pair_names.add(f'{m}_{tracer2}')
        pair_names.add(f'{tracer2}_{m}')
    for m1 in metals_in1:
        for m2 in metals_in2:
            pair_names.add(f'{m1}_{m2}')
            pair_names.add(f'{m2}_{m1}')

    n = coords.rp_grid.size
    z = np.full(n, z_eff)
    header = {
        'RPMIN': coords.rp_min, 'RPMAX': coords.rp_max,
        'RTMAX': coords.rt_max, 'NP': coords.rp_nbins,
        'NT': coords.rt_nbins, 'BLINDING': 'none',
    }
    shifts = rp_shifts or {}
    columns = {}
    for name in sorted(pair_names):
        # pair names are '<abs1>_<abs2>'; absorber names themselves
        # contain no underscores (LYA, QSO, SiII(1260), ...)
        a1, a2 = name.rsplit('_', 1)
        dshift = shifts.get(a2, 0.0) - shifts.get(a1, 0.0)
        columns[f'RP_{name}'] = coords.rp_grid + dshift
        columns[f'RT_{name}'] = coords.rt_grid
        columns[f'Z_{name}'] = z
    write_fits(path, [
        {'name': 'ATTRI', 'header': header,
         'columns': {'DUMMY': np.zeros(1)}},
        {'name': 'MDMAT', 'columns': columns},
    ])
    return path


def make_synthetic_dataset(workdir, cross=True, sample=None, seed=0,
                           noise=0.0, size='full', with_distortion=False,
                           extra_model='', extra_control='',
                           global_cov=False):
    """Create a complete synthetic fit setup; returns the main.ini path.

    size='tiny' shrinks every axis (k grid, mu_k bins, rp/rt bins) for
    fast compile checks and multi-device dry runs. with_distortion adds a
    banded DM matrix; global_cov also writes a block-diagonal joint
    covariance file and points [data sets] at it.
    """
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    tiny = size == 'tiny'
    n_k = 128 if tiny else 814
    nt = 10 if tiny else 50
    model_lines = ('num_bins_muk = 50\nell_max = 6\n' if tiny else '')
    model_lines += extra_model

    template_file = workdir / 'fiducial_eh98.fits'
    make_fiducial_template(template_file, n_k=n_k)

    z_eff = 2.33
    auto_file = workdir / 'cf_synthetic.fits'
    _write_correlation_data(auto_file, False, z_eff, rng, noise=noise,
                            nt=nt, with_distortion=with_distortion)
    ini_files = [workdir / 'lyaxlya.ini']
    ini_files[0].write_text(_auto_ini(auto_file, extra_model=model_lines))

    cross_file = None
    if cross:
        cross_file = workdir / 'xcf_synthetic.fits'
        _write_correlation_data(cross_file, True, z_eff, rng, noise=noise,
                                nt=nt, with_distortion=with_distortion)
        cross_ini = workdir / 'qsoxlya.ini'
        cross_ini.write_text(_cross_ini(cross_file, extra_model=model_lines))
        ini_files.append(cross_ini)

    global_cov_file = None
    if global_cov:
        global_cov_file = workdir / 'global_cov.fits'

    main_path = workdir / 'main.ini'
    main_path.write_text(_main_ini(
        ini_files, template_file, workdir / 'output', sample=sample,
        zeff=z_eff, extra_control=extra_control))

    # Second pass: regenerate the data vectors from the actual model at
    # the default parameters so fits are well-posed (truth = defaults)
    from .io.fits import read_fits
    from .vega_interface import VegaInterface
    vega = VegaInterface(main_path)
    if vega.model_pk:
        # multipole-output mode has no data-space model to resample
        return main_path
    model_cf = vega.compute_model(run_init=False)
    for name, corr_item in vega.corr_items.items():
        is_cross = corr_item.tracer1['type'] != corr_item.tracer2['type']
        fname = cross_file if is_cross else auto_file
        _write_correlation_data(fname, is_cross, z_eff, rng,
                                model_xi=np.asarray(model_cf[name]),
                                noise=noise, nt=nt,
                                with_distortion=with_distortion)

    if global_cov:
        # Block-diagonal joint covariance matching the per-corr ones
        blocks = []
        for name, corr_item in vega.corr_items.items():
            is_cross = corr_item.tracer1['type'] != corr_item.tracer2['type']
            fname = cross_file if is_cross else auto_file
            blocks.append(read_fits(fname)[1]['CO'])
        n_total = sum(b.shape[0] for b in blocks)
        cov = np.zeros((n_total, n_total))
        off = 0
        for b in blocks:
            cov[off:off + len(b), off:off + len(b)] = b
            off += len(b)
        write_fits(global_cov_file, [{'name': 'COV',
                                      'columns': {'COV': cov}}])
        main_path.write_text(_main_ini(
            ini_files, template_file, workdir / 'output', sample=sample,
            zeff=z_eff, global_cov_file=global_cov_file,
            extra_control=extra_control))

    return main_path


# --------------------------------------------------------------------------
# DR16-shaped combined fit (reference: examples/eBOSS_DR16/main_combined.ini)
# --------------------------------------------------------------------------
# The STRUCTURE of the eBOSS DR16 flagship analysis on synthetic data:
# four correlations (two Lya auto regions, two QSO crosses) with the DR16
# model options (Rogers2018 HCD, Arinyo small-scale NL, BAO broadening,
# Lorentz velocity dispersion, SiII(1260)/SiIII(1207) metals). At nt=50
# the autos have 2,500 bins and the crosses 5,000.
DR16_OPTIONS = {
    'scale_params': 'ap_at',
    'template': 'PlanckDR16/PlanckDR16.fits',
    'small_scale_nl': True,
    'bao_broadening': True,
    'hcd_model': 'Rogers2018',
    'velocity_dispersion': 'lorentz',
    'metals': ['SiII(1260)', 'SiIII(1207)'],
    'test': True,       # identity metal matrices (no picca metal files)
}

DR16_PARAMETERS = {
    'ap': 1.0, 'at': 1.0, 'bao_amp': 1.,
    'bias_LYA': -0.117, 'beta_LYA': 1.67, 'alpha_LYA': 2.9,
    'bias_hcd': -0.052, 'beta_hcd': 0.65, 'L0_hcd': 10.,
    'bias_QSO': 3.7, 'beta_QSO': 0.26, 'alpha_QSO': 1.44,
    'drp_QSO': 0.0, 'sigma_velo_disp_lorentz_QSO': 6.86,
    'bias_SiII(1260)': -0.002, 'beta_SiII(1260)': 0.5,
    'alpha_SiII(1260)': 1.,
    'bias_SiIII(1207)': -0.004, 'beta_SiIII(1207)': 0.5,
    'alpha_SiIII(1207)': 1.,
    'sigmaNL_per': 3.24, 'sigmaNL_par': 6.37, 'growth_rate': 0.97,
}

DR16_SAMPLED = ['ap', 'at', 'bias_LYA', 'beta_LYA']

DR16_CORRS = {                # name -> (file stem, is_cross)
    'lyaxlya': ('cf_lya', False),
    'lyaxlyb': ('cf_lyb', False),
    'lyaxqso': ('xcf_lya', True),
    'lybxqso': ('xcf_lyb', True),
}

DR16_FIT_TYPES = {
    'auto': 'lyaxlya_lyaxlyb',
    'cross': 'lyaxqso_lybxqso',
    'combined': 'lyaxlya_lyaxlyb_lyaxqso_lybxqso',
}


def build_dr16_configs(workdir, nt, extension=None, global_cov_file=None,
                       fit_types=None, sample_params=None,
                       control_extra=None):
    """Write the DR16-shaped correlation, metal and ini files into
    ``workdir``; returns {fit label: main.ini path}. The data vectors are
    placeholders until regenerate_dr16_from_truth."""
    from .build_config import BuildConfig

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    correlations = {}
    for name, (stem, is_cross) in DR16_CORRS.items():
        path = workdir / f'{stem}.fits'
        metal_path = workdir / f'metal_{stem}.fits'
        if not path.exists():
            coords = _write_correlation_data(path, is_cross, 2.33, rng,
                                             nt=nt)
            metals = DR16_OPTIONS['metals']
            # Physical line-misidentification rp offsets (puts the
            # SiIII(1207) bump at ~21 Mpc/h and keeps the two metal
            # lines distinguishable — i.e. their biases non-degenerate)
            shifts = metal_rp_shifts(metals, 2.33)
            write_metal_file(metal_path, coords, 2.33,
                             'QSO' if is_cross else 'LYA', 'LYA',
                             metals_in1=() if is_cross else metals,
                             metals_in2=metals, rp_shifts=shifts)
        correlations[name] = {'corr_path': str(path),
                              'metal_path': str(metal_path),
                              'rp-min': -200. if is_cross else 0.}

    mains = {}
    for label, fit_type in (fit_types or DR16_FIT_TYPES).items():
        builder = BuildConfig(options=dict(DR16_OPTIONS), overwrite=True)
        fit_info = {'fitter': True, 'zeff': 2.33,
                    'sample_params': list(sample_params or DR16_SAMPLED)}
        if global_cov_file is not None:
            fit_info['global_cov_file'] = str(global_cov_file)
        name_ext = label if extension is None else f'{label}-{extension}'
        mains[label] = builder.build(
            correlations, fit_type, fit_info, workdir,
            parameters=dict(DR16_PARAMETERS), name_extension=name_ext)
        if control_extra:
            _append_control(mains[label], control_extra)
    return mains


def _append_control(main_path, extra):
    """Merge extra [control] keys into a generated main.ini."""
    import configparser
    config = configparser.ConfigParser()
    config.optionxform = str
    config.read(main_path)
    if 'control' not in config:
        config['control'] = {}
    config['control'].update(extra)
    with open(main_path, 'w') as f:
        config.write(f)


def regenerate_dr16_from_truth(workdir, main_path, nt):
    """Second pass: replace the placeholder data vectors with the model
    evaluated at the injected truth (DR16_PARAMETERS), noiseless."""
    from .vega_interface import VegaInterface

    workdir = Path(workdir)
    vega = VegaInterface(main_path)
    model_cf = vega.compute_model(run_init=False)
    rng = np.random.default_rng(1)
    for name in vega.corr_items:
        stem, is_cross = DR16_CORRS[name]
        _write_correlation_data(workdir / f'{stem}.fits', is_cross, 2.33,
                                rng, model_xi=np.asarray(model_cf[name]),
                                nt=nt)
