#!/usr/bin/env python
"""Fit driver: minimize, optionally scan, write output and diagnostic
plots (reference: vega/scripts/run_vega.py)."""

from vega_tpu.vega_interface import VegaInterface


def run_vega(config_path):
    """Run a complete fit (reference: scripts/run_vega.py:7-81)."""
    vega = VegaInterface(config_path)

    _ = vega.compute_model(run_init=False)

    run_montecarlo = vega.main_config['control'].getboolean(
        'run_montecarlo', False) if 'control' in vega.main_config else False
    if run_montecarlo and vega.mc_config is not None:
        _ = vega.initialize_monte_carlo()
    elif run_montecarlo:
        raise ValueError('You asked to run over a Monte Carlo simulation, '
                         'but no "[monte carlo]" section provided.')

    vega.minimize()

    scan_results = None
    if 'chi2 scan' in vega.main_config:
        scan_results = vega.analysis.chi2_scan()

    if vega.minimizer is not None:
        for par, val in vega.bestfit.values.items():
            vega.params[par] = val

    vega.output.write_results(
        vega.bestfit_model, vega.params, vega.minimizer,
        vega.bestfit_corr_stats, scan_results, vega.models)

    try:
        import matplotlib
    except ImportError:
        print('INFO: matplotlib is not installed: the fit results are '
              'written, the wedge and shell plots are not.')
        return vega
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    num_pars = len(vega.sample_params['limits'])
    out_base = vega.output.outfile
    if out_base.endswith('.fits'):
        out_base = out_base[:-5]
    for name in vega.plots.data:
        legend = (f'Correlation: {name}, Total '
                  r'$\chi^2_\mathrm{best}/(N_\mathrm{data}-N_\mathrm{pars})$'
                  f': {vega.chisq:.1f}/({vega.total_data_size}-{num_pars}) '
                  f'= {vega.reduced_chisq:.3f}, PTE={vega.p_value:.2f}')
        if not vega.bestfit.fmin.is_valid:
            legend = 'Invalid fit! Disregard these results.'

        vega.plots.plot_4wedges(
            models=[vega.bestfit_model[name]], corr_name=name,
            mu_bin_labels=True, model_colors=['r'])
        vega.plots.fig.suptitle(legend, fontsize=14, y=1.03)
        vega.plots.fig.savefig(
            f'{out_base}_{name}_wedges.png', dpi='figure',
            bbox_inches='tight', facecolor='white')
        plt.close(vega.plots.fig)

        vega.plots.plot_4shells(model=vega.bestfit_model[name],
                                corr_name=name)
        vega.plots.fig.suptitle(legend, fontsize=14, y=0.95)
        vega.plots.fig.savefig(
            f'{out_base}_{name}_shells.png', dpi='figure',
            bbox_inches='tight', facecolor='white')
        plt.close(vega.plots.fig)

    return vega


def main(argv=None):
    """Console entry: run_vega <main.ini> (reference: bin/run_vega.py)."""
    import argparse
    parser = argparse.ArgumentParser(description='Run a vega_tpu fit')
    parser.add_argument('config', type=str, help='path to main.ini')
    args = parser.parse_args(argv)
    run_vega(args.config)
    return 0


if __name__ == '__main__':
    import sys
    sys.exit(main())
