"""One run of one cell: find its files by name, run its driver, read its
metrics, check its answers, print its line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. Its
configuration is ``bench_torch/configs/<config>.json``, its traffic
``bench_torch/traffic/<traffic>.json`` (whose ``driver`` names
``bench_torch/drivers/<driver>.py``), its limits
``bench_torch/limits/<cell>.json``, and each per-layer metric
``bench_torch/metrics/<metric>.py``, a ``read(run)`` that returns a number
or ``None`` when its slice holds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class NoDevice(RuntimeError):
    """The run found fewer CUDA devices than its cell asks for."""


def read_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``bench_torch/<kind>/<name>.py`` as a module."""
    path = os.path.join(HERE, kind, f'{name}.py')
    spec = importlib.util.spec_from_file_location(f'bench_torch_{kind}_{name}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def applies(entry: dict, cell: str, reported: set) -> bool:
    """Whether a per-layer metric is reported by ``cell``, which reports
    the end-to-end metrics ``reported``: the cells it lists, or, where it
    lists none, every cell that reports the metric it moves."""
    if 'workloads' in entry:
        return cell in entry['workloads']
    return entry['moves'] in reported


class Run:
    """What one run of a cell knows, and what its driver leaves for the
    metric readers: ``window`` (counts and clock readings of the measured
    window), ``slice`` (the traced slice, or None), ``checks`` ({name:
    (value, limit)}), ``attempted``, ``failed``, ``memory_peak_bytes``."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool, t0: float,
                 device: str | None = None, overrides: dict | None = None):
        self.bench = read_json(ROOT, 'BENCHMARK.json')
        cells = {w['name']: w for w in self.bench['workloads']}
        if workload not in cells:
            raise KeyError(f'no workload {workload!r} in BENCHMARK.json')
        self.cell = cells[workload]
        self.name, self.seed, self.seconds, self.trace, self.t0 = (
            workload, seed, seconds, trace, t0)
        self.config = read_json(HERE, 'configs', f'{self.cell["config"]}.json')
        self.traffic = read_json(HERE, 'traffic', f'{self.cell["traffic"]}.json')
        for key, value in (overrides or {}).items():  # tests run a cell at a small size
            getattr(self, key).update(value)
        self.device_kind = device
        self.window, self.slice, self.checks, self.notes = {}, None, {}, {}
        self.attempted = self.failed = 0
        self.memory_peak_bytes = 0
        self.setup_s = None
        self.end_to_end = [m for m in self.bench['end_to_end']
                           if 'workloads' not in m or workload in m['workloads']]
        reported = {m['name'] for m in self.end_to_end}
        self.per_layer = [m for m in self.bench['per_layer'] if applies(m, workload, reported)]

    # ---------------------------------------------------------------- device

    def open_device(self):
        import torch

        if self.device_kind == 'cpu':  # the tests' rehearsal of a run
            self.device = torch.device('cpu')
            return self.device
        chips = self.cell['chips']
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise NoDevice(f'{self.name} needs {chips} CUDA device(s); found '
                           f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}')
        self.device = torch.device('cuda', 0)
        return self.device

    @property
    def cuda(self) -> bool:
        return self.device.type == 'cuda'

    def synchronize(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize(self.device)

    def set_up_done(self) -> None:
        """The window starts: set-up ends here."""
        self.synchronize()
        self.setup_s = time.perf_counter() - self.t0
        if self.cuda:
            import torch

            torch.cuda.reset_peak_memory_stats(self.device)

    def read_peak(self) -> None:
        if self.cuda:
            import torch

            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated(self.device))

    # ---------------------------------------------------------------- program

    def compute_dtype(self):
        import torch

        return getattr(torch, self.traffic.get('compute_dtype', self.config['compute_dtype']))

    def reference_model(self, device='meta'):
        import torch

        from bench_torch.reference.model import Mask2Former

        with torch.device(device):
            return Mask2Former(self.config)

    def state_dict(self, dtype, device=None):
        from bench_torch.weights import make_state_dict

        return make_state_dict(self.reference_model(), self.seed, device or self.device, dtype)

    def program_model(self, dtype, train: bool = False, remat=False):
        """The program's model of this configuration, holding the
        benchmark's seeded weights in ``dtype``."""
        import torch

        from weed_instance_segmentation_tpu_torch.engine.model_utils import config_for_arch
        from weed_instance_segmentation_tpu_torch.models.mask2former import Mask2Former

        cfg = config_for_arch(self.config['arch'], num_labels=self.config['num_labels'])
        check_config(cfg, self.config)
        with torch.device('meta'):
            model = Mask2Former(cfg, remat=remat)
        model.load_state_dict(self.state_dict(dtype), strict=True, assign=True)
        return model.train(train)

    # ---------------------------------------------------------------- result

    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(
            math.isfinite(v) and v <= limit for v, limit in self.checks.values())

    def result(self) -> dict:
        import torch

        metrics = {}
        if self.trace:
            for entry in self.per_layer:
                value = load_module('metrics', entry['name']).read(self)
                if value is not None:
                    metrics[entry['name']] = {'value': value, 'unit': entry['unit']}
        else:
            for entry in self.end_to_end:
                value = self.setup_s if entry['name'] == 'setup_s' else self.window.get(
                    entry['name'])
                if value is not None:
                    metrics[entry['name']] = {'value': value, 'unit': entry['unit']}
        if self.cuda:
            device = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(self.device),
                      'count': self.cell['chips'], 'memory_peak_bytes': self.memory_peak_bytes}
        else:
            device = {'platform': 'cpu', 'kind': 'cpu', 'count': 1, 'memory_peak_bytes': 0}
        out = {'correct': self.correct(), 'attempted': self.attempted, 'failed': self.failed,
               'metrics': metrics, 'device': device}
        if self.trace and self.slice is not None:
            device['busy_s'] = self.slice.busy_s()
            device['window_s'] = self.slice.wall_s
            out['breakdown'] = self.slice.breakdown()
        out['checks'] = {name: {'value': v, 'limit': limit}
                         for name, (v, limit) in self.checks.items()}
        return out


def check_config(cfg, stated: dict) -> None:
    """Raise where the program's config departs from the configuration
    file on a key both have."""
    import dataclasses

    def compare(obj, want: dict, where: str):
        fields = {f.name for f in dataclasses.fields(obj)}
        for key, value in want.items():
            if key not in fields or key == 'backbone_config':
                continue
            have = getattr(obj, key)
            if json.loads(json.dumps(have)) != json.loads(json.dumps(value)):
                raise ValueError(f'the program runs {where}{key} = {have!r}; the configuration '
                                 f'states {value!r}')

    compare(cfg, stated, '')
    compare(cfg.backbone_config, stated['backbone_config'], 'backbone_config.')


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t0: float,
             device: str | None = None, overrides: dict | None = None) -> dict:
    """Run one cell and return its result line (a dict)."""
    run = Run(workload, seed, seconds, trace, t0, device, overrides)
    run.open_device()
    load_module('drivers', run.traffic['driver']).run(run)
    for key, value in {**run.window, **run.notes}.items():
        print(f'{key} {value!r}', file=sys.stderr)
    return run.result()


def print_result(result: dict) -> None:
    for name, check in result['checks'].items():
        print(f'check {name} {check["value"]!r} limit {check["limit"]!r}', file=sys.stderr)
    print(json.dumps(result), flush=True)
