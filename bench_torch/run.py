"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's model with weights made from the seed, makes its inputs
from the seed, warms up the cell's shapes (set-up, ``setup_s``), measures
for ``--seconds``, and with ``--trace 1`` profiles a short slice after the
window. Then it frees the program, runs the plain reference on a sample of
what the window produced, and prints each compared number beside its limit
on standard error and, last on standard output, one JSON line. It needs as
many CUDA devices as the cell asks for, and exits with code 3 and no
result line without them.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'), ('TRITON_CACHE_DIR', 'triton')):
        os.environ[var] = os.path.join(ROOT, '.bench_cache', sub)
    sys.path[:1] = [ROOT]  # the checkout's root, not this directory
    from bench_torch import harness

    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T0)
    except harness.NoDevice as e:
        print(f'run.py: {e}', file=sys.stderr)
        return 3
    harness.print_result(result)
    return 0


if __name__ == '__main__':
    sys.exit(main())
