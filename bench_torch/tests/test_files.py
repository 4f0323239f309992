"""``BENCHMARK.json`` and the files it names: every cell, configuration
and metric loads and names a configuration, traffic, driver, limits and
reader that exist; names, units and lines keep to their characters."""

import json
import os
import re

import pytest

from bench_torch import harness

BENCH = harness.read_json(harness.ROOT, 'BENCHMARK.json')
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
CELLS = {w['name']: w for w in BENCH['workloads']}
METRICS = BENCH['end_to_end'] + BENCH['per_layer']


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                          'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['bench_torch'] and BENCH['command'][1] == 'bench_torch/run.py'
    assert isinstance(BENCH['run_seconds'], int) and 1 <= BENCH['run_seconds'] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize('entry', BENCH['configs'], ids=lambda e: e['name'])
def test_configuration(entry):
    assert NAME.match(entry['name']) and _line(entry['why']) and _line(entry['source'])
    assert entry['file'] == f'bench_torch/configs/{entry["name"]}.json'
    stated = harness.read_json(harness.ROOT, entry['file'])
    assert stated['source'] == entry['source'] and stated['reduced'] == entry['reduced']
    assert all(NAME.match(k) for k in entry['reduced']) and len(entry['reduced']) <= 16
    assert any(w['config'] == entry['name'] for w in BENCH['workloads'])


@pytest.mark.parametrize('cell', list(CELLS))
def test_cell_names_files_that_exist(cell):
    w = CELLS[cell]
    assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
    assert NAME.match(cell) and NAME.match(w['traffic']) and _line(w['why'])
    assert w['chips'] in (1, 4) and w['config'] in {c['name'] for c in BENCH['configs']}
    run = harness.Run(cell, 1, 1, False, 0.0)
    driver = os.path.join(harness.HERE, 'drivers', f'{run.traffic["driver"]}.py')
    assert os.path.exists(driver)
    limits = harness.read_json(harness.HERE, 'limits', f'{cell}.json')['limits']
    assert limits and all(v >= 0 for v in limits.values())  # 0: an exact comparison
    assert any(v > 0 for v in limits.values())
    reported = {m['name'] for m in run.end_to_end}
    assert 'setup_s' in reported and len(reported) >= 2 and run.per_layer


@pytest.mark.parametrize('metric', METRICS, ids=lambda m: m['name'])
def test_metric(metric):
    assert NAME.match(metric['name']) and UNIT.match(metric['unit'])
    assert metric['better'] in ('lower', 'higher')
    for cell in metric.get('workloads', []):
        assert cell in CELLS
    if 'bound' in metric:
        assert set(metric) <= {'name', 'unit', 'better', 'bound', 'source', 'workloads'}
        assert 0.01 <= metric['bound'] <= 0.25
        assert metric['source'] in ('host_clock', 'device_trace')
        return
    assert set(metric) <= {'name', 'unit', 'better', 'source', 'layer', 'moves', 'workloads'}
    assert metric['source'] in ('device_trace', 'program_span', 'program_counter', 'host_clock')
    assert _line(metric['layer'])
    moved = next(m for m in BENCH['end_to_end'] if m['name'] == metric['moves'])
    for cell in metric['workloads']:  # every cell that reads it reports what it moves
        assert 'workloads' not in moved or cell in moved['workloads']
    reader = harness.load_module('metrics', metric['name'])
    assert callable(reader.read)
    if metric['unit'] == '%':
        assert 'roofline' in metric['name'] or 'mfu' in metric['name'] or 'idle' in metric[
            'name']
