"""``run.py`` without a CUDA device, and without the program: a non-zero
exit and no result line."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from bench_torch import harness


def _run(cwd: str):
    return subprocess.run([sys.executable, 'bench_torch/run.py', '--workload', 'swinl-serve-b4',
                           '--seed', str(2 ** 31 + 5), '--seconds', '1', '--trace', '0'],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_cuda_device_no_result():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    out = _run(harness.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ''
    assert 'CUDA device' in out.stderr


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / 'bench_torch',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = _run(str(tmp_path))
    assert out.returncode != 0 and '"correct"' not in out.stdout
