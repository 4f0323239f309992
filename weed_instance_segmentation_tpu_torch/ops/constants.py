"""Shape-derived constants (masks, indices, tap weights, embeddings) kept on
the device.

The JAX package builds these in numpy at trace time and XLA bakes them into
the compiled program. PyTorch runs eagerly, so each one is built once per
(function, arguments, device, dtype) here instead of being copied to the
device on every call. While ``torch.export`` traces (``engine/export.py``),
the constant is still built as a real tensor, outside the tracer's fake and
proxy modes, so the exported program holds it as a constant and the cache
never keeps a fake tensor for later eager calls.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils._python_dispatch import _disable_current_modes


@functools.lru_cache(maxsize=256)
def device_constant(make, args: tuple, device: torch.device,
                    dtype: torch.dtype | None = None) -> torch.Tensor:
    """``make(*args)`` (a numpy array) as a tensor on ``device``.

    Made outside inference mode, so a constant first built while serving can
    still enter autograd later, and outside any dispatch mode that is
    active, so it is a real tensor. Callers must not write to the result."""
    with torch.inference_mode(False), _disable_current_modes():
        array = np.ascontiguousarray(make(*args))
        return torch.from_numpy(array).to(device=device, dtype=dtype)
