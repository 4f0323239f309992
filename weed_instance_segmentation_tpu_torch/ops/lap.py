"""Linear assignment for the Hungarian matcher, on the host.

Same contract as ``weed_instance_segmentation_tpu/ops/lap.py::
linear_sum_assignment`` (a cost (R, C) with R ≤ C → the column of each row),
solved by ``scipy.optimize.linear_sum_assignment`` as the HF matcher does
(HF:modeling_mask2former.py:474-478). The JAX package's on-device
Jonker–Volgenant solver is not ported: :func:`batched_linear_sum_assignment`
solves every (layer, image) problem of a training step after ONE
device→host copy of the stacked costs.

Its spans (``engine/trace.py``): ``lap.wait``, the blocking copy of the
costs to the host, which waits for the device to finish everything queued
before it; ``lap.solve``, the solves and the copy back; and ``lap.bubble``
around both, whose timing events (on a CUDA device) enclose on the stream
only those two small copies: their device ms are the idle the round trip
opens.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment as _scipy_lsa

from weed_instance_segmentation_tpu_torch.engine import trace


def linear_sum_assignment(cost: np.ndarray) -> np.ndarray:
    """Minimal-cost assignment of R rows to C columns, R ≤ C.

    cost: (R, C) float. Returns col4row (R,) int64, the column assigned to
    each row."""
    cost = np.asarray(cost)
    if cost.ndim != 2 or cost.shape[0] > cost.shape[1]:
        raise ValueError(f'linear_sum_assignment takes (R, C) with R <= C, got {cost.shape}')
    rows, cols = _scipy_lsa(cost)
    col4row = np.empty(cost.shape[0], np.int64)
    col4row[rows] = cols
    return col4row


def batched_linear_sum_assignment(costs: torch.Tensor) -> torch.Tensor:
    """(K, R, C) costs on any device → (K, R) int64 col4row on that device,
    with one device→host copy of the costs and one host→device copy back."""
    costs = costs.detach().float()
    with trace.span('lap.bubble', device=costs.device):
        with trace.span('lap.wait'):
            host = costs.cpu().numpy()
        with trace.span('lap.solve'):
            col4row = np.stack([linear_sum_assignment(c) for c in host])
            return torch.from_numpy(col4row).to(costs.device)
