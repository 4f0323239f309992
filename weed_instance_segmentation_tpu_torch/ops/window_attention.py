"""Swin window attention: CUDA kernel (forward and backward) and plain version.

Port of the Pallas TPU kernel ``tools/ab_window_attn.py::
pallas_window_attention`` with the shifted-window mask added (the Pallas
kernel lacks it). Per window ``w`` and head ``h``::

    O = softmax(Q Kᵀ / sqrt(D) + rel_bias[h] + attn_mask[w % nW_img]) V

q/k/v are (NW, H, T, D) with the windows in the order of
``models/swin.py::window_partition`` (image-major), so window ``w`` belongs to
image ``w // nW_img`` and takes mask ``w % nW_img``.

The forward and the backward are registered operators,
``torch.ops.wistpu.window_attention_fwd`` → (O, row log-sum-exp in float32)
and ``torch.ops.wistpu.window_attention_bwd`` → (dQ, dK, dV, dBias summed
over windows), so that ``torch.export`` records them (``engine/export.py``);
the forward's autograd formula calls the backward. For a CUDA tensor each
launches ``csrc/window_attention.cu``; for a CPU tensor the forward is
:func:`window_attention_plain` and the backward its vector-Jacobian product
(:func:`window_attention_vjp_plain`). In bfloat16 the forward and the
backward run on tensor cores, and float32 on CUDA cores. The forward takes
one block per (window, head). Each launch first flags which image windows'
shift masks hold a nonzero entry (a window with an all-zero mask reads
none). Each block of the backward takes one head and a run of windows
(:func:`window_runs`) and writes its dBias partial to a float32 scratch that
a second launch sums in run order, so dBias has the same bits on every call.
The forward takes T ≤ ``MAX_TOKENS``, the backward T ≤
``BACKWARD_MAX_TOKENS``. There is no fallback: on a CUDA tensor the wrapper
launches the kernels or raises. Each forward launch adds one to the counter
:data:`LAUNCHES` (``engine/trace.py``), each backward launch to
:data:`BACKWARD_LAUNCHES`.
"""

from __future__ import annotations

import math

import torch

from weed_instance_segmentation_tpu_torch.ops.cuda_build import (
    check_aligned, check_attention_inputs, count_launch, entry_point, launch, sm_count,
)

_LIBRARY = 'window_attention'
LAUNCHES = 'wistpu.window_attention_fwd.launches'
BACKWARD_LAUNCHES = 'wistpu.window_attention_bwd.launches'
HEAD_DIMS = (16, 32, 64)
MAX_TOKENS = 256  # the forward
BACKWARD_MAX_TOKENS = 144  # the backward: Swin's window 12; its bf16 dBias sum lives in registers


def _scores(q, k, rel_bias, attn_mask) -> torch.Tensor:
    """Float32 scores: Q Kᵀ / sqrt(D) + rel_bias[h] (+ attn_mask[w % nW_img])."""
    nw, heads, tokens, head_dim = q.shape
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(head_dim)
    scores = scores + rel_bias.float()[None]
    if attn_mask is not None:
        n_img_windows = attn_mask.shape[0]
        scores = scores.reshape(-1, n_img_windows, heads, tokens, tokens)
        scores = scores + attn_mask.float()[None, :, None]
        scores = scores.reshape(nw, heads, tokens, tokens)
    return scores


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           rel_bias: torch.Tensor,
                           attn_mask: torch.Tensor | None) -> torch.Tensor:
    """The plain PyTorch version: the matmul + softmax body of
    ``WindowAttention.forward``, computed in float32 and returned in ``q``'s
    dtype."""
    probs = torch.softmax(_scores(q, k, rel_bias, attn_mask), dim=-1)
    return torch.matmul(probs, v.float()).to(q.dtype)


def window_attention_vjp_plain(q, k, v, rel_bias, attn_mask, grad_out):
    """(dQ, dK, dV, dBias) of :func:`window_attention_plain` for the
    cotangent ``grad_out``, in float32 with the operations of its autograd
    graph (the same bits on the CPU); dQ, dK and dV in q's dtype, dBias
    (H, T, T) float32, summed over the windows."""
    probs = torch.softmax(_scores(q, k, rel_bias, attn_mask), dim=-1)
    g = grad_out.float()
    dv = torch.matmul(probs.transpose(-1, -2), g)
    dprobs = torch.matmul(g, v.float().transpose(-1, -2))
    ds = torch._softmax_backward_data(dprobs, probs, -1, torch.float32)
    dbias = ds.sum(dim=0)
    ds = ds / math.sqrt(q.shape[-1])
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(q.float().transpose(-1, -2), ds).transpose(-1, -2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def _check(q, k, v, rel_bias, attn_mask) -> None:
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f'q/k/v must share one (NW, H, T, D) shape, got '
                         f'{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}')
    nw, heads, tokens, _ = q.shape
    if rel_bias.shape != (heads, tokens, tokens):
        raise ValueError(f'rel_bias must be (H, T, T) = {(heads, tokens, tokens)}, '
                         f'got {tuple(rel_bias.shape)}')
    if attn_mask is not None and (attn_mask.ndim != 3 or attn_mask.shape[1:] != (tokens, tokens)
                                  or nw % attn_mask.shape[0]):
        raise ValueError(f'attn_mask must be (nW_img, T, T) with nW_img dividing {nw}, '
                         f'got {tuple(attn_mask.shape)}')


def _check_kernel(q, k, v, rel_bias, attn_mask) -> None:
    extra = [rel_bias] + ([] if attn_mask is None else [attn_mask])
    check_attention_inputs(q, k, v, extra, HEAD_DIMS)
    tokens = q.shape[2]
    if tokens > MAX_TOKENS:
        raise ValueError(f'the kernel takes at most {MAX_TOKENS} tokens, got {tuple(q.shape)}')
    if tokens > BACKWARD_MAX_TOKENS and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, rel_bias)):
        raise ValueError(f'the backward kernel takes at most {BACKWARD_MAX_TOKENS} tokens, got '
                         f'{tuple(q.shape)} with an input that requires grad')
    if any(t.dtype != torch.float32 for t in extra):
        raise TypeError('rel_bias and attn_mask must be float32')


def window_runs(windows: int, heads: int, sms: int) -> int:
    """How many runs of windows the backward splits each head into: one
    (run, head) block for each of ``sms`` SMs (the bf16 block at T = 144
    fills an SM alone), at least one and none empty. Run r takes windows
    r, r + runs, r + 2·runs, …, so the windows with a nonzero shift mask,
    which cost more, spread over the runs."""
    return max(1, min(windows, sms // heads))


def _mask_flags(attn_mask: torch.Tensor) -> torch.Tensor:
    """uint8 (nW_img,): which image windows' shift masks hold a nonzero entry
    (a window with an all-zero mask reads none)."""
    return attn_mask.flatten(1).any(1).view(torch.uint8)


@torch.library.custom_op('wistpu::window_attention_fwd', mutates_args=(), device_types='cpu',
                         schema='(Tensor q, Tensor k, Tensor v, Tensor rel_bias, '
                                'Tensor? attn_mask) -> (Tensor, Tensor)')
def _forward_op(q, k, v, rel_bias, attn_mask):
    scores = _scores(q, k, rel_bias, attn_mask)
    out = torch.matmul(torch.softmax(scores, dim=-1), v.float()).to(q.dtype)
    return out, torch.logsumexp(scores, dim=-1)


@_forward_op.register_kernel('cuda')
def _forward_cuda(q, k, v, rel_bias, attn_mask):
    check_aligned(q, k, v)
    nw, heads, tokens, head_dim = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((nw, heads, tokens), dtype=torch.float32, device=q.device)
    n_img, mask_used = 1, None
    if attn_mask is not None:
        n_img, mask_used = attn_mask.shape[0], _mask_flags(attn_mask)
    launch(entry_point(_LIBRARY, 'wis_window_attention_fwd', 8, 6), q.device,
           f'window attention forward for q {tuple(q.shape)}',
           q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_bias.data_ptr(),
           None if attn_mask is None else attn_mask.data_ptr(),
           None if mask_used is None else mask_used.data_ptr(), out.data_ptr(),
           lse.data_ptr(), nw, heads, tokens, head_dim, n_img, int(q.dtype == torch.bfloat16))
    count_launch(LAUNCHES)
    return out, lse


@_forward_op.register_fake
def _forward_fake(q, k, v, rel_bias, attn_mask):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


@torch.library.custom_op('wistpu::window_attention_bwd', mutates_args=(), device_types='cpu',
                         schema='(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, '
                                'Tensor rel_bias, Tensor? attn_mask, Tensor grad_out) '
                                '-> (Tensor, Tensor, Tensor, Tensor)')
def _backward_op(q, k, v, out, lse, rel_bias, attn_mask, grad_out):
    return window_attention_vjp_plain(q, k, v, rel_bias, attn_mask, grad_out)


@_backward_op.register_kernel('cuda')
def _backward_cuda(q, k, v, out, lse, rel_bias, attn_mask, grad_out):
    if grad_out.data_ptr() % 16:
        grad_out = grad_out.clone()
    nw, heads, tokens, head_dim = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty((heads, tokens, tokens), dtype=torch.float32, device=q.device)
    runs = window_runs(nw, heads, sm_count(q.device.index))
    part = torch.empty((runs, heads, tokens, tokens), dtype=torch.float32, device=q.device)
    n_img, mask_used = 1, None
    if attn_mask is not None:
        n_img, mask_used = attn_mask.shape[0], _mask_flags(attn_mask)
    launch(entry_point(_LIBRARY, 'wis_window_attention_bwd', 14, 7), q.device,
           f'window attention backward for q {tuple(q.shape)}',
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), grad_out.data_ptr(),
           lse.data_ptr(), rel_bias.data_ptr(),
           None if attn_mask is None else attn_mask.data_ptr(),
           None if mask_used is None else mask_used.data_ptr(), dq.data_ptr(),
           dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(), part.data_ptr(), nw, heads,
           tokens, head_dim, n_img, int(q.dtype == torch.bfloat16), runs)
    count_launch(BACKWARD_LAUNCHES)
    return dq, dk, dv, dbias


@_backward_op.register_fake
def _backward_fake(q, k, v, out, lse, rel_bias, attn_mask, grad_out):
    return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
            rel_bias.new_empty(rel_bias.shape, dtype=torch.float32))


def _setup_context(ctx, inputs, output):
    q, k, v, rel_bias, attn_mask = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse, rel_bias, attn_mask)
    ctx.mark_non_differentiable(lse)
    ctx.set_materialize_grads(False)


def _backward(ctx, grad_out, _grad_lse):
    q, k, v, out, lse, rel_bias, attn_mask = ctx.saved_tensors
    dq, dk, dv, dbias = _backward_op(q, k, v, out, lse, rel_bias, attn_mask,
                                     grad_out.to(q.dtype).contiguous())
    return dq, dk, dv, dbias.to(rel_bias.dtype), None


_forward_op.register_autograd(_backward, setup_context=_setup_context)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     rel_bias: torch.Tensor,
                     attn_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(NW, H, T, D) q/k/v, (H, T, T) relative-position bias and an optional
    (nW_img, T, T) shift mask → (NW, H, T, D) in q's dtype.

    On CUDA tensors this launches the kernel (q/k/v float32 or bfloat16,
    contiguous, D in {16, 32, 64}, T ≤ 256, and T ≤ 144 when an input requires
    grad; bfloat16 16-byte aligned; rel_bias and attn_mask float32) and its
    backward kernel under autograd; the mask takes no gradient. On CPU
    tensors it runs :func:`window_attention_plain`."""
    _check(q, k, v, rel_bias, attn_mask)
    if q.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'no kernel for device {q.device}')
    if q.device.type == 'cuda':
        _check_kernel(q, k, v, rel_bias, attn_mask)
    if attn_mask is not None and attn_mask.requires_grad:
        raise ValueError('attn_mask is a constant: it takes no gradient')
    return _forward_op(q, k, v, rel_bias, attn_mask)[0]

