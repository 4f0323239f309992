"""Ranges the benchmark opens around calls into the program's layers, for
the traced slice only: module forwards (by hooks), a module-level function
(by a wrapper), and each MSDA sampling call, whose shapes it also counts;
and the recording of a function's calls outside the window (the decisions
the reference then follows)."""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

MSDA_RANGE = 'bench.msda'
MSDA_BACKWARD = '_MSDABackward'  # the autograd node of the MSDA call (ops/deformable_attention.py)


@contextlib.contextmanager
def module_ranges(modules: dict):
    """{range name: module}: each forward of each module runs in its range."""
    handles, open_ = [], []
    for name, module in modules.items():
        def pre(mod, args, name=name):
            rf = record_function(name)
            rf.__enter__()
            open_.append(rf)

        def post(mod, args, out):
            open_.pop().__exit__(None, None, None)

        handles += [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def function_range(module, attr: str, name: str):
    """``module.attr`` runs in the range ``name``."""
    original = getattr(module, attr)

    def wrapped(*args, **kwargs):
        with record_function(name):
            return original(*args, **kwargs)

    setattr(module, attr, wrapped)
    try:
        yield
    finally:
        setattr(module, attr, original)


@contextlib.contextmanager
def recording(module, attr: str, into: list, pick):
    """Within the block, each call of ``module.attr`` appends ``pick(args,
    result)`` to ``into``."""
    original = getattr(module, attr)

    def wrapped(*args, **kwargs):
        out = original(*args, **kwargs)
        into.append(pick(args, out))
        return out

    setattr(module, attr, wrapped)
    try:
        yield
    finally:
        setattr(module, attr, original)


@contextlib.contextmanager
def msda_ranges(calls: list):
    """Each ``MSDeformAttn.core`` call runs in ``MSDA_RANGE``, and appends
    its shapes to ``calls``: (value shape, value dtype, locations shape,
    locations dtype, spatial shapes, whether a backward follows)."""
    from weed_instance_segmentation_tpu_torch.models.pixel_decoder import MSDeformAttn

    original = MSDeformAttn.__dict__['core']

    def core(value, locations, attn, spatial_shapes):
        calls.append((tuple(value.shape), str(value.dtype).split('.')[-1],
                      tuple(locations.shape), str(locations.dtype).split('.')[-1],
                      tuple(spatial_shapes), torch.is_grad_enabled() and value.requires_grad))
        with record_function(MSDA_RANGE):
            return original.__func__(value, locations, attn, spatial_shapes)

    MSDeformAttn.core = staticmethod(core)
    try:
        yield
    finally:
        MSDeformAttn.core = original
