"""The control at a small size on the CPU: the reference in the program's
place, one precision step below the configuration's bfloat16 (bfloat16
autocast, every product's operands and results in float8 e4m3, gradients
in e5m2), reads three times or more what the program computing in bfloat16
reads, on one of the numbers the cell compares. On the card it runs at the
cell's own size, where the limits were set from it:
``python3 bench_torch/control.py --workload <cell> --mode control --seeds ...``."""

import pytest

from bench_torch import compare, control
from bench_torch.tests import tiny

CELLS = {'swinl-train-b2': None, 'swinl-serve-b4': None}


@pytest.mark.parametrize('cell', CELLS)
def test_control_reads_above_the_program(cell):
    program, _ = tiny.numbers(cell, seed=1, config=CELLS[cell], compute_dtype='bfloat16')
    readings = control.reference_readings(tiny.make_run(cell, seed=1, config=CELLS[cell]),
                                          'control')
    compared = compare.load_limits(cell)
    assert any(readings[name] > 3 * program[name] or readings[name] > limit
               for name, limit in compared.items()), (readings, program)


@pytest.mark.parametrize('cell', CELLS)
def test_reference_in_place_reads_nothing(cell):
    readings = control.reference_readings(tiny.make_run(cell, seed=1, config=CELLS[cell]),
                                          'reference')
    assert all(readings[name] < 1e-6 for name in compare.load_limits(cell)), readings
