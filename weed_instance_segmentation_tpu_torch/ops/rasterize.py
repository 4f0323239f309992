"""Host raster ops of the dataset readers: connected components, polygon
fill and exact colour match.

Port of ``weed_instance_segmentation_tpu/ops/rasterize.py``. The primary
implementation is ``native/rasterops.cpp`` (a copy of the JAX package's),
compiled with ``g++`` on first use into the package's ``build/`` directory
(the file name carries a hash of the source) and bound with ``ctypes``. Where
no compiler is found the numpy/scipy fallbacks below run, with a warning;
they give the same labels and pixels (``fill_poly``'s fallback draws with
PIL, imported there).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import warnings

import numpy as np

from weed_instance_segmentation_tpu_torch.ops.cuda_build import BUILD_DIR, PACKAGE_DIR

_SRC = os.path.join(PACKAGE_DIR, 'native', 'rasterops.cpp')
_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')

_lib = None
_lib_tried = False


def _library_path() -> str:
    with open(_SRC, 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f'rasterops-{digest}.so')


def _load_native():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        path = _library_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f'{path}.{os.getpid()}.tmp'
            subprocess.run(['g++', *_FLAGS, '-o', tmp, _SRC], check=True, capture_output=True)
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        lib.wistpu_connected_components.restype = ctypes.c_int32
        lib.wistpu_connected_components.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.wistpu_fill_poly.restype = None
        lib.wistpu_fill_poly.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
        ]
        lib.wistpu_color_match.restype = None
        lib.wistpu_color_match.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        _lib = lib
    except Exception as e:  # no compiler: the fallbacks below
        warnings.warn(f'rasterops C++ library unavailable ({e}); using the Python fallback')
        _lib = None
    return _lib


def native_available() -> bool:
    return _load_native() is not None


def connected_components(mask: np.ndarray) -> tuple[int, np.ndarray]:
    """8-connectivity labels of a binary mask, as ``cv2.connectedComponents``
    numbers them: background 0, components 1..N in row-major order of first
    pixel, ``num_labels = N + 1``."""
    mask = np.ascontiguousarray(mask.astype(np.uint8))
    h, w = mask.shape
    lib = _load_native()
    if lib is not None:
        labels = np.zeros((h, w), dtype=np.int32)
        num = lib.wistpu_connected_components(
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return int(num), labels
    # scipy with the full 3x3 structure, relabelled in first-pixel order
    from scipy import ndimage

    raw, n = ndimage.label(mask, structure=np.ones((3, 3), dtype=np.int32))
    if n == 0:
        return 1, raw.astype(np.int32)
    flat = raw.ravel()
    first = {}
    for v in flat[flat != 0]:
        if v not in first:
            first[v] = len(first) + 1
            if len(first) == n:
                break
    remap = np.zeros(n + 1, dtype=np.int32)
    for old, new in first.items():
        remap[old] = new
    return n + 1, remap[raw]


def fill_poly(canvas: np.ndarray, points: np.ndarray, value: int) -> np.ndarray:
    """Fill a polygon (``points``: (N, 2) int32 (x, y)) into the int32
    ``canvas`` in place, outline included."""
    assert canvas.dtype == np.int32 and canvas.flags['C_CONTIGUOUS']
    points = np.ascontiguousarray(points.astype(np.int32))
    h, w = canvas.shape
    lib = _load_native()
    if lib is not None:
        lib.wistpu_fill_poly(
            canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), h, w,
            points.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(points), int(value),
        )
        return canvas
    from PIL import Image, ImageDraw

    img = Image.new('I', (w, h), 0)
    ImageDraw.Draw(img).polygon([tuple(p) for p in points.tolist()], fill=1, outline=1)
    canvas[np.asarray(img) != 0] = value
    return canvas


def color_match(rgb: np.ndarray, color) -> np.ndarray:
    """Exact per-pixel RGB equality mask (uint8)."""
    rgb = np.ascontiguousarray(rgb.astype(np.uint8))
    h, w = rgb.shape[:2]
    lib = _load_native()
    if lib is not None:
        out = np.zeros((h, w), dtype=np.uint8)
        lib.wistpu_color_match(
            rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
            int(color[0]), int(color[1]), int(color[2]),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out
    return np.all(rgb == np.asarray(color, dtype=np.uint8), axis=-1).astype(np.uint8)
