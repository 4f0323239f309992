"""Multi-scale deformable attention (MSDA) sampling core, plain PyTorch.

Same contract as ``weed_instance_segmentation_tpu/ops/deformable_attention.py
::msda_reference`` and ``ops/msda_select.py::msda``, with the numerics of HF
``multi_scale_deformable_attention`` (HF:modeling_mask2former.py:799-838):
per level, a bilinear sample of the per-head value maps at the sampling
locations (``align_corners=False``, zero padding), then a weighted sum over
levels × points.

Forward: one flat value table over (batch·head·level) and one row gather
per bilinear corner, as ``ops/msda_fused.py`` does, with its rounding:
sampling coordinates and attention weights are cast to float32, each
corner's tap weight is formed in float32 and cast to the value dtype, and
the corners are weighted, summed over points and accumulated in the value
dtype (at bf16, each sum is taken in float32 and rounded).

Backward, split as the JAX package's custom VJP splits it
(``ops/msda_select.py::_msda_hybrid_bwd``):

- location and weight gradients: autograd of the fused form with the value
  table held constant (its graph is built in the forward, so the gathered
  rows are not fetched twice);
- value gradient: each tap's product of cotangent and rounded tap weight,
  in the value dtype as autograd of the fused form forms it, added into a
  float32 table in a fixed order and cast to the value dtype once. The
  JAX package also sums in float32 (``ops/msda_transpose.py``); autograd of
  ``table[idx]`` would add every tap into a table of the value dtype,
  rounding each partial sum to bf16. The order is fixed on every device, so
  two calls give the same bits (:func:`_add_rows`). The dense separable
  einsum of the JAX package is a TPU workaround for row-serial scatters and
  is not ported.

The no-grad forward is a registered operator, ``torch.ops.wistpu.msda_fwd``
(so that ``torch.export`` records it, ``engine/export.py``): for a CPU tensor
it is :func:`_msda_fused`; for a CUDA tensor it launches
``csrc/msda.cu``, one launch a call that computes the same function with the
same rounding (value float32 or bfloat16, head dim in {16, 32, 64},
locations and weights both float32 or both bfloat16, at most four levels),
or raises. Each launch adds one to the counter :data:`LAUNCHES`
(``engine/trace.py``). :func:`msda` takes the operator wherever no input
needs a gradient. The JAX package has no Pallas kernel for MSDA (its routes
are XLA), so the kernel replaces none.

The one exception to "no fallback" in the port: under autograd the forward
and backward stay the plain :class:`_MSDA` on the card too, until the
backward has a kernel of its own.
"""

from __future__ import annotations

import torch

from weed_instance_segmentation_tpu_torch.engine import trace
from weed_instance_segmentation_tpu_torch.ops.cuda_build import count_launch, entry_point, launch

# the span of the value gradient's sums (a trace's device time for them is
# the work launched inside its range)
VALUE_GRAD_RANGE = 'msda value-gradient sum'
_LIBRARY = 'msda'
LAUNCHES = 'wistpu.msda_fwd.launches'
HEAD_DIMS = (16, 32, 64)
MAX_LEVELS = 4


def _taps(spatial_shapes: tuple, l_total: int, b: int, heads: int,
          locations: torch.Tensor, weights: torch.Tensor, dtype: torch.dtype):
    """Per bilinear corner of every level: the flat-table row of each tap
    (B, Q, heads, P) and its weight (attention weight × bilinear weight × in
    bounds), formed in float32 and rounded to ``dtype``."""
    bh_base = (torch.arange(b * heads, device=locations.device) * l_total).reshape(b, 1, heads, 1)
    level_off = 0
    for level, (hl, wl) in enumerate(spatial_shapes):
        loc = locations[:, :, :, level]  # (B, Q, heads, P, 2)
        # grid_sample unnormalize (align_corners=False)
        x = loc[..., 0] * wl - 0.5
        y = loc[..., 1] * hl - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        wx1 = x - x0
        wy1 = y - y0
        base = bh_base + level_off
        level_w = weights[:, :, :, level]
        for dy in (0, 1):
            iy = y0 + dy
            yw = wy1 if dy else 1.0 - wy1
            y_ok = (iy >= 0) & (iy <= hl - 1)
            row = iy.clamp(0, hl - 1).long() * wl
            for dx in (0, 1):
                ix = x0 + dx
                xw = wx1 if dx else 1.0 - wx1
                valid = y_ok & (ix >= 0) & (ix <= wl - 1)
                idx = base + row + ix.clamp(0, wl - 1).long()
                yield idx, (xw * yw * valid * level_w).to(dtype)  # (B, Q, heads, P)
        level_off += hl * wl


def _msda_fused(value, spatial_shapes, sampling_locations, attention_weights):
    b, l_total, heads, head_dim = value.shape
    _, q, _, _, points, _ = sampling_locations.shape
    # flat table: row (bi·heads + h)·L_total + level_off + y·W + x
    table = value.transpose(1, 2).reshape(b * heads * l_total, head_dim)
    out = torch.zeros((b, q, heads, head_dim), dtype=value.dtype, device=value.device)
    for idx, wgt in _taps(spatial_shapes, l_total, b, heads, sampling_locations.float(),
                          attention_weights.float(), value.dtype):
        rows = table[idx.reshape(-1)].reshape(b, q, heads, points, head_dim)
        out += (rows * wgt[..., None]).sum(dim=3)
    return out.reshape(b, q, heads * head_dim)


def _add_rows(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> None:
    """``table[idx[i]] += rows[i]`` for every i, in the order of i. On the
    card ``index_put_`` with ``accumulate`` sorts the indices (a stable
    sort) and adds each run of equal ones in order; ``index_add_`` would add
    with atomics there, in an order that changes from call to call. On the
    CPU ``index_add_`` adds serially."""
    with trace.span(VALUE_GRAD_RANGE):
        if table.is_cuda:
            table.index_put_((idx,), rows, accumulate=True)
        else:
            table.index_add_(0, idx, rows)


def value_grad_sums(g, value_shape, dtype, spatial_shapes, locations, weights):
    """Cotangent (B, Q, heads·D) → the value gradient's float32 sums, a
    (B·heads·L_total, D) table in the flat-table row order: each tap's
    product in ``dtype``, added in a fixed order."""
    b, l_total, heads, head_dim = value_shape
    _, q, _, _, points, _ = locations.shape
    g = g.to(dtype).reshape(b, q, heads, 1, head_dim)
    table = torch.zeros((b * heads * l_total, head_dim), dtype=torch.float32, device=g.device)
    for idx, wgt in _taps(spatial_shapes, l_total, b, heads, locations.float(), weights.float(),
                          dtype):
        taps = (g * wgt[..., None]).float()  # the product rounded to dtype, as autograd forms it
        _add_rows(table, idx.reshape(-1), taps.reshape(-1, head_dim))
    return table


def _value_grad(g, value_shape, dtype, spatial_shapes, locations, weights):
    """Cotangent (B, Q, heads·D) → the value gradient (B, L_total, heads, D):
    :func:`value_grad_sums` cast to ``dtype`` once."""
    b, l_total, heads, head_dim = value_shape
    table = value_grad_sums(g, value_shape, dtype, spatial_shapes, locations, weights)
    return table.reshape(b, heads, l_total, head_dim).transpose(1, 2).to(dtype)


def _check_kernel(value, spatial_shapes, locations, weights) -> None:
    """What the kernel takes (it reads ``data_ptr()``, so only the CUDA
    implementation calls this)."""
    if value.ndim != 4 or locations.ndim != 6 or locations.shape[-1] != 2 \
            or weights.shape != locations.shape[:-1] \
            or locations.shape[0] != value.shape[0] or locations.shape[2] != value.shape[2]:
        raise ValueError(f'value must be (B, L, heads, D), locations (B, Q, heads, levels, '
                         f'points, 2) and weights (B, Q, heads, levels, points), got '
                         f'{tuple(value.shape)}, {tuple(locations.shape)}, {tuple(weights.shape)}')
    if value.dtype not in (torch.float32, torch.bfloat16) or weights.dtype != locations.dtype \
            or locations.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'the kernel takes a float32 or bfloat16 value and float32 or bfloat16 '
                        f'locations and weights of one dtype, got {value.dtype}, '
                        f'{locations.dtype}, {weights.dtype}')
    if value.shape[3] not in HEAD_DIMS:
        raise ValueError(f'the kernel takes head_dim in {HEAD_DIMS}, got value '
                         f'{tuple(value.shape)}')
    levels = locations.shape[3]
    if not 1 <= levels <= MAX_LEVELS or len(spatial_shapes) != levels \
            or sum(h * w for h, w in spatial_shapes) != value.shape[1]:
        raise ValueError(f'the kernel takes 1 to {MAX_LEVELS} levels whose rows sum to the '
                         f"value's {value.shape[1]}, got {spatial_shapes} for locations "
                         f'{tuple(locations.shape)}')
    if any(not t.is_contiguous() for t in (value, locations, weights)):
        raise ValueError('the kernel\'s inputs must be contiguous')
    if any(t.device != value.device for t in (locations, weights)):
        raise ValueError('all inputs must be on one device')
    if value.data_ptr() % 16:
        raise ValueError('the kernel reads 16-byte vectors: value must start at a '
                         '16-byte-aligned address')


def _pairs(flat) -> tuple:
    return tuple(zip(flat[::2], flat[1::2]))


@torch.library.custom_op('wistpu::msda_fwd', mutates_args=(), device_types='cpu',
                         schema='(Tensor value, int[] spatial_shapes, Tensor sampling_locations, '
                                'Tensor attention_weights) -> Tensor')
def _forward_op(value, spatial_shapes, sampling_locations, attention_weights):
    return _msda_fused(value, _pairs(spatial_shapes), sampling_locations, attention_weights)


@_forward_op.register_kernel('cuda')
def _forward_cuda(value, spatial_shapes, sampling_locations, attention_weights):
    shapes = _pairs(spatial_shapes)
    _check_kernel(value, shapes, sampling_locations, attention_weights)
    b, l_total, heads, head_dim = value.shape
    _, q, _, levels, points, _ = sampling_locations.shape
    out = torch.empty((b, q, heads * head_dim), dtype=value.dtype, device=value.device)
    dims = [d for hw in shapes for d in hw] + [0] * (2 * (MAX_LEVELS - levels))
    launch(entry_point(_LIBRARY, 'wis_msda_fwd', 4, 17), value.device,
           f'MSDA forward for value {tuple(value.shape)}', value.data_ptr(),
           sampling_locations.data_ptr(), attention_weights.data_ptr(), out.data_ptr(), b,
           l_total, q, heads, head_dim, levels, points, *dims, int(value.dtype == torch.bfloat16),
           int(sampling_locations.dtype == torch.bfloat16))
    count_launch(LAUNCHES)
    return out


@_forward_op.register_fake
def _forward_fake(value, spatial_shapes, sampling_locations, attention_weights):
    b, _, heads, head_dim = value.shape
    return value.new_empty((b, sampling_locations.shape[1], heads * head_dim))


class _MSDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations, attention_weights):
        ctx.spatial_shapes = spatial_shapes
        ctx.value_shape = value.shape
        ctx.value_dtype = value.dtype
        ctx.save_for_backward(sampling_locations, attention_weights)
        ctx.inner = None
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            # the location and weight gradients' graph, with the values held
            # constant; the forward's result is this graph's output
            with torch.enable_grad():
                loc = sampling_locations.detach().requires_grad_(ctx.needs_input_grad[2])
                w = attention_weights.detach().requires_grad_(ctx.needs_input_grad[3])
                out = _msda_fused(value.detach(), spatial_shapes, loc, w)
            ctx.inner = (out, loc, w)
            return out.detach()
        return _msda_fused(value, spatial_shapes, sampling_locations, attention_weights)

    @staticmethod
    def backward(ctx, g):
        locations, weights = ctx.saved_tensors
        g_value = g_loc = g_w = None
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            if ctx.inner is None:  # the inner graph was freed by the first backward
                raise RuntimeError('msda: backward through this graph a second time is not '
                                   'supported')
            out, loc, w = ctx.inner
            ctx.inner = None
            wanted = [t for t in (loc, w) if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g))
            g_loc = next(grads) if loc.requires_grad else None
            g_w = next(grads) if w.requires_grad else None
        if ctx.needs_input_grad[0]:
            g_value = _value_grad(g, ctx.value_shape, ctx.value_dtype, ctx.spatial_shapes,
                                  locations, weights)
        return g_value, None, g_loc, g_w


def msda(
    value: torch.Tensor,
    spatial_shapes: tuple,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """
    Args:
        value: (B, L_total, heads, head_dim) — per-level feature maps
            flattened and concatenated along L_total.
        spatial_shapes: tuple of (H_l, W_l) per level.
        sampling_locations: (B, Q, heads, levels, points, 2), normalized
            [0, 1] (x, y).
        attention_weights: (B, Q, heads, levels, points), softmaxed over
            levels × points.
    Returns:
        (B, Q, heads * head_dim) in ``value.dtype``.

    With no input needing a gradient this is the operator
    ``torch.ops.wistpu.msda_fwd`` (on CUDA tensors the kernel, which raises
    on what it does not take); otherwise the plain :class:`_MSDA`.
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (value, sampling_locations, attention_weights)):
        return _MSDA.apply(value, tuple(spatial_shapes), sampling_locations, attention_weights)
    return _forward_op(value, [d for hw in spatial_shapes for d in hw], sampling_locations,
                       attention_weights)
