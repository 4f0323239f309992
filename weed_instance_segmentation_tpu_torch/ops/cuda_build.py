"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C entry point and is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library under the package's ``build/``
directory on first use, then loaded with ``ctypes``. The library's file name
carries a hash of the source and the flags, so an edited source is rebuilt and
a stale library is never loaded. Sources do not include PyTorch's headers,
which keeps a build to seconds.

A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, 'csrc')
BUILD_DIR = os.path.join(PACKAGE_DIR, 'build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3', '-shared',
              '-Xcompiler', '-fPIC', '-Xptxas', '-v')

# name → (seconds, compiler output) of a build this process ran
build_log: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = os.path.join(home, 'bin', 'nvcc')
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found on PATH or under CUDA_HOME; the CUDA kernels '
                           'need the CUDA toolkit')
    return path


def library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` is built for its current source."""
    with open(os.path.join(CSRC_DIR, f'{name}.cu'), 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f'{name}-{digest}.so')


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, and load it."""
    lib_path = library_path(name)
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f'{lib_path}.{os.getpid()}.tmp'
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp, os.path.join(CSRC_DIR, f'{name}.cu')]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {name}.cu ({proc.returncode}):\n'
                               f'{proc.stdout}{proc.stderr}')
        os.replace(tmp, lib_path)  # atomic: a process building at the same time never loads a partial file
        build_log[name] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    return ctypes.CDLL(lib_path)
