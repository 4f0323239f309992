"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C entry point and is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library under the package's ``build/``
directory on first use, then loaded with ``ctypes``. The library's file name
carries a hash of the source, the shared headers ``csrc/*.cuh`` and the
flags, so an edited source is rebuilt and a stale library is never loaded.
Sources do not include PyTorch's headers, which keeps a build to seconds.

A failed build raises; there is no fallback. The wrappers bind an entry point
with :func:`entry_point`, call it with :func:`launch` (which raises on a CUDA
error), count each call with :func:`count_launch`, check attention inputs
with :func:`check_attention_inputs` and :func:`check_aligned` and size their
grids with :func:`sm_count`.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

from weed_instance_segmentation_tpu_torch.engine import trace

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
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC_DIR, f'{name}.cu')] + sorted(glob.glob(
            os.path.join(CSRC_DIR, '*.cuh'))):
        with open(path, 'rb') as f:
            digest.update(f.read())
    digest = digest.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f'{name}-{digest}.so')


def build_libraries(names) -> None:
    """Compile every ``csrc/<name>.cu`` of ``names`` whose library is
    missing, one ``nvcc`` each, all started together; raise if any fails."""
    jobs = []
    for name in dict.fromkeys(names):
        lib_path = library_path(name)
        if os.path.exists(lib_path):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f'{lib_path}.{os.getpid()}.tmp'
        cmd = [_nvcc(), *NVCC_FLAGS, '-I', CSRC_DIR, '-o', tmp, os.path.join(CSRC_DIR, f'{name}.cu')]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, lib_path, tmp, proc, time.perf_counter()))
    failures = []
    for name, lib_path, tmp, proc, t0 in jobs:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f'nvcc failed for {name}.cu ({proc.returncode}):\n{output}')
            continue
        os.replace(tmp, lib_path)  # atomic: a process building at the same time never loads a partial file
        build_log[name] = (time.perf_counter() - t0, output)
    if failures:
        raise RuntimeError('\n'.join(failures))


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, and load it."""
    build_libraries([name])
    return ctypes.CDLL(library_path(name))


@functools.cache
def entry_point(name: str, symbol: str, pointers: int, ints: int):
    """``extern "C" int symbol(pointers x void*, ints x int, void* stream)``
    of the library of ``csrc/<name>.cu``, bound with ``ctypes``."""
    fn = getattr(load_library(name), symbol)
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(fn, device: torch.device, what: str, *args) -> None:
    """Call a bound entry point on ``device``'s current stream; raise if it
    returns a CUDA error."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'{what} launch failed: CUDA error {err}')


def captured(name: str) -> str:
    """The twin of a launch counter ``wistpu.<op>.launches``:
    ``wistpu.<op>.captured``."""
    return name.removesuffix('.launches') + '.captured'


def count_launch(name: str) -> None:
    """Count one call of a kernel under the counter ``name`` where the
    kernel runs, or under :func:`captured` of it where the current stream is
    capturing a CUDA graph: the capture only records the launch, and every
    replay of the graph makes it (``engine/export.py``)."""
    trace.count(captured(name) if torch.cuda.is_current_stream_capturing() else name)


@functools.cache
def sm_count(device_index: int) -> int:
    """The number of SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def check_aligned(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The bf16 attention kernels' 16-byte vector reads: q, k and v must
    start at 16-byte-aligned addresses. It reads ``data_ptr()``, so only a
    registered operator's CUDA implementation calls it (``torch.export``
    traces with tensors that have no data)."""
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError('the bfloat16 kernels read 16-byte vectors: q, k and v must start '
                         'at 16-byte-aligned addresses')


def check_attention_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, others,
                           head_dims: tuple[int, ...]) -> None:
    """What both attention kernels require: q/k/v all float32 or all bfloat16
    with a head dim in ``head_dims``, and every tensor (q/k/v and ``others``)
    contiguous and on q's device."""
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f'q/k/v must all be float32 or all bfloat16, got '
                        f'{q.dtype}, {k.dtype}, {v.dtype}')
    if q.shape[-1] not in head_dims:
        raise ValueError(f'the kernel takes head_dim in {head_dims}, got q {tuple(q.shape)}')
    if any(not t.is_contiguous() for t in (q, k, v, *others)):
        raise ValueError('the kernel\'s inputs must be contiguous')
    if any(t.device != q.device for t in (k, v, *others)):
        raise ValueError('all inputs must be on one device')
