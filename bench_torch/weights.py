"""Seeded weights and seeds, made by the benchmark.

:func:`make_state_dict` fills the reference model's parameters, by name,
from one normal draw on the device: the same seed gives the same values,
which load into the program (whose state-dict keys are the same) and, after
the window, into the reference. The scales are those of a trained
Mask2Former rather than of its initialiser: unit-variance activations
through every linear layer, residual branches a quarter of that in the
decoders (so that the queries stay distinct through their layers), sampling
offsets of a few cells, a class head and mask embedder confident enough
that the serving threshold keeps some slots and not others.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

# name suffix → (mean, std) for parameters that are not a plain weight or bias;
# a weight of two or more axes otherwise takes std gain / sqrt(fan_in)
_SPECIAL = (
    ('sampling_offsets.bias', 0.0, 2.0),
    ('relative_position_bias_table', 0.0, 0.5),
    ('level_embed', 0.0, 0.5),
    ('queries_embedder', 0.0, 1.0),
    ('queries_features', 0.0, 1.0),
    ('.mean', 0.0, 0.1),
    ('.var', 0.0, 0.1),  # exponentiated below
)
_GAIN = (('class_predictor.weight', 2.0), ('mask_embedder_2.weight', 0.7),
         ('out_proj.weight', 0.25), ('fc2.weight', 0.25))


def derive_seed(seed: int, *stream) -> int:
    """A 63-bit seed for ``stream`` (a name, a number) of run ``seed``."""
    words = [int(seed)] + [int.from_bytes(str(s).encode(), 'little') % 2 ** 63 for s in stream]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def _law(name: str, shape: torch.Size) -> tuple[float, float]:
    for suffix, mean, std in _SPECIAL:
        if name.endswith(suffix):
            return mean, std
    if len(shape) >= 2:
        gain = next((g for suffix, g in _GAIN if name.endswith(suffix)), 1.0)
        return 0.0, gain / float(np.sqrt(np.prod(shape[1:])))
    if name.endswith(('.weight', '.scale')):  # norms
        return 1.0, 0.1
    return 0.0, 0.02  # biases


def make_state_dict(model: nn.Module, seed: int, device, dtype=torch.float32) -> dict:
    """{name: tensor of ``dtype`` on ``device``} for every parameter of
    ``model`` (the reference, any device, meta included)."""
    params = list(model.named_parameters())
    total = sum(p.numel() for _, p in params)
    g = torch.Generator(device=device).manual_seed(derive_seed(seed, 'weights'))
    flat = torch.randn(total, generator=g, device=device)
    out, start = {}, 0
    for name, p in params:
        mean, std = _law(name, p.shape)
        t = flat[start:start + p.numel()].view(p.shape) * std + mean
        if name.endswith('.var'):  # a batch norm's variance stays positive
            t = torch.exp(t)
        out[name] = t.to(dtype)
        start += p.numel()
    return out
