"""Console entry points."""

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='vega_tpu — JAX Lyman-alpha forest '
                    'correlation-function likelihood engine')
    sub = parser.add_subparsers(dest='command')

    fit = sub.add_parser('fit', help='Run a fit (minimize + output + plots)')
    fit.add_argument('config', type=str)

    sampler = sub.add_parser('sample', help='Run the sampler')
    sampler.add_argument('config', type=str)
    sampler.add_argument('--n-devices', type=int, default=None)

    mc = sub.add_parser('mc', help='Run Monte-Carlo mock fits')
    mc.add_argument('config', type=str)
    mc.add_argument('--sequential', action='store_true')
    mc.add_argument('--n-devices', type=int, default=None)

    args = parser.parse_args(argv)

    if args.command == 'fit':
        from vega_tpu.scripts.run_vega import run_vega
        run_vega(args.config)
        return 0
    if args.command == 'sample':
        from vega_tpu.scripts.run_vega_sampler import main as run_sampler
        argv2 = [args.config]
        if args.n_devices:
            argv2 += ['--n-devices', str(args.n_devices)]
        return run_sampler(argv2)
    if args.command == 'mc':
        from vega_tpu.scripts.run_vega_mc import main as run_mc
        argv2 = [args.config]
        if args.sequential:
            argv2 += ['--sequential']
        if args.n_devices:
            argv2 += ['--n-devices', str(args.n_devices)]
        return run_mc(argv2)

    parser.print_help()
    return 0


if __name__ == '__main__':
    sys.exit(main())
