"""Shape-derived constants (masks, indices, tap weights, embeddings) kept on
the device.

The JAX package builds these in numpy at trace time and XLA bakes them into
the compiled program. PyTorch runs eagerly, so each one is built once per
(function, arguments, device, dtype) here instead of being copied to the
device on every call.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def device_constant(make, args: tuple, device: torch.device,
                    dtype: torch.dtype | None = None) -> torch.Tensor:
    """``make(*args)`` (a numpy array) as a tensor on ``device``.

    Made outside inference mode, so a constant first built while serving can
    still enter autograd later. Callers must not write to the result."""
    with torch.inference_mode(False):
        array = np.ascontiguousarray(make(*args))
        return torch.from_numpy(array).to(device=device, dtype=dtype)
