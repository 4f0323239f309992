"""Masked cross-attention of the decoder: CUDA kernel (forward and backward)
and plain version.

Port of the Pallas TPU kernel ``tools/ab_masked_attn.py::
pallas_masked_attention``: per (batch, head)::

    O = softmax(Q Kᵀ + bias) V,    bias = −1e9 where mask, 0 elsewhere

with q (B, H, Q, D) already scaled by D^-0.5, k/v (B, H, S, D) and the
boolean mask (B, 1, Q, S), True = blocked, shared over heads. The mask is the
support of the additive bias the Pallas kernel and the JAX decoder take
(``models/transformer_decoder.py::MaskPredictor``); the kernel reads it as one
byte per score and adds exactly −1e9 in float32, so it computes the same
function. The mask takes no gradient (it comes from ``sigmoid < 0.5``).

The forward and the backward are registered operators,
``torch.ops.wistpu.masked_attention_fwd`` → (O, row log-sum-exp in float32)
and ``torch.ops.wistpu.masked_attention_bwd`` → (dQ, dK, dV), so that
``torch.export`` records them (``engine/export.py``); the forward's autograd
formula calls the backward. For a CUDA tensor each launches
``csrc/masked_attention.cu``: in bfloat16 the forward and the backward's dQ
launch run on tensor cores split over chunks of the keys (:func:`key_chunks`)
into a float32 scratch that a last launch merges (the forward's chunk maxima
and sums) or sums (dQ); float32 runs on CUDA cores with no split. For a CPU
tensor the forward is :func:`masked_attention_plain` and the backward its
vector-Jacobian product (:func:`masked_attention_vjp_plain`). There is no
fallback. Each forward launch adds one to the counter :data:`LAUNCHES`
(``engine/trace.py``), each backward to :data:`BACKWARD_LAUNCHES`.
"""

from __future__ import annotations

import torch

from weed_instance_segmentation_tpu_torch.ops.cuda_build import (
    check_aligned, check_attention_inputs, count_launch, entry_point, launch, sm_count,
)

_LIBRARY = 'masked_attention'
LAUNCHES = 'wistpu.masked_attention_fwd.launches'
BACKWARD_LAUNCHES = 'wistpu.masked_attention_bwd.launches'
HEAD_DIMS = (16, 32, 64)
MAX_QUERIES = 512
MASKED_BIAS = -1e9
KEY_TILE, ROW_TILE = 64, 128  # a bf16 forward or dQ block's key tile and query rows
BLOCKS_PER_SM = 2  # bf16 forward or dQ blocks an SM holds at once (256 threads each)


def _scores(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Float32 scores with the −1e9 bias where ``mask``."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    bias = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device)
    return scores + bias.masked_fill_(mask, MASKED_BIAS)


def masked_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: scores + additive bias → softmax → PV, in
    float32, returned in ``q``'s dtype."""
    probs = torch.softmax(_scores(q, k, mask), dim=-1)
    return torch.matmul(probs, v.float()).to(q.dtype)


def masked_attention_vjp_plain(q, k, v, mask, grad_out):
    """(dQ, dK, dV) of :func:`masked_attention_plain` for the cotangent
    ``grad_out``, in float32 with the operations of its autograd graph (the
    same bits on the CPU), returned in the inputs' dtypes."""
    probs = torch.softmax(_scores(q, k, mask), dim=-1)
    g = grad_out.float()
    dv = torch.matmul(probs.transpose(-1, -2), g)
    dprobs = torch.matmul(g, v.float().transpose(-1, -2))
    ds = torch._softmax_backward_data(dprobs, probs, -1, torch.float32)
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(q.float().transpose(-1, -2), ds).transpose(-1, -2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, mask) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f'q must be (B, H, Q, D) and k/v (B, H, S, D), got '
                         f'{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}')
    b, _, nq, _ = q.shape
    if mask.dtype != torch.bool or mask.shape != (b, 1, nq, k.shape[2]):
        raise ValueError(f'mask must be bool (B, 1, Q, S) = {(b, 1, nq, k.shape[2])}, '
                         f'got {mask.dtype} {tuple(mask.shape)}')


def _check_kernel(q, k, v, mask) -> None:
    check_attention_inputs(q, k, v, [mask], HEAD_DIMS)
    if q.shape[2] > MAX_QUERIES or k.shape[2] < 1:
        raise ValueError(f'the kernel takes at most {MAX_QUERIES} queries and at least one '
                         f'key, got q {tuple(q.shape)}, k {tuple(k.shape)}')


def key_chunks(batch_heads: int, nq: int, ns: int, sms: int) -> int:
    """How many chunks of the keys the bf16 forward and dQ launches split
    into: as many (batch·head, 128-row, chunk) blocks as ``sms`` SMs hold at
    once (``BLOCKS_PER_SM`` each; more would leave a second, partial wave),
    with at least two 64-key tiles a chunk and none left empty (chunk c takes
    tiles [c·t, (c+1)·t), t = ceil(tiles / chunks))."""
    key_tiles = -(-ns // KEY_TILE)
    blocks = batch_heads * -(-nq // ROW_TILE)
    chunks = max(1, min(-(-key_tiles // 2), BLOCKS_PER_SM * sms // blocks))
    return -(-key_tiles // -(-key_tiles // chunks))


@torch.library.custom_op('wistpu::masked_attention_fwd', mutates_args=(), device_types='cpu',
                         schema='(Tensor q, Tensor k, Tensor v, Tensor mask) -> (Tensor, Tensor)')
def _forward_op(q, k, v, mask):
    scores = _scores(q, k, mask)
    out = torch.matmul(torch.softmax(scores, dim=-1), v.float()).to(q.dtype)
    return out, torch.logsumexp(scores, dim=-1)


@_forward_op.register_kernel('cuda')
def _forward_cuda(q, k, v, mask):
    check_aligned(q, k, v)
    b, heads, nq, head_dim = q.shape
    ns, bf16 = k.shape[2], q.dtype == torch.bfloat16
    out = torch.empty_like(q)
    lse = torch.empty((b, heads, nq), dtype=torch.float32, device=q.device)
    chunks, part = 1, None  # the f32 kernel takes no key split
    if bf16:
        chunks = key_chunks(b * heads, nq, ns, sm_count(q.device.index))
        if chunks > 1:  # the chunks' O (chunks, B, H, Q, D), then their row (max, sum)
            part = torch.empty(chunks * b * heads * nq * (head_dim + 2), dtype=torch.float32,
                               device=q.device)
    launch(entry_point(_LIBRARY, 'wis_masked_attention_fwd', 7, 7), q.device,
           f'masked attention forward for q {tuple(q.shape)}',
           q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
           lse.data_ptr(), None if part is None else part.data_ptr(), b, heads, nq, ns,
           head_dim, int(bf16), chunks)
    count_launch(LAUNCHES)
    return out, lse


@_forward_op.register_fake
def _forward_fake(q, k, v, mask):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


@torch.library.custom_op('wistpu::masked_attention_bwd', mutates_args=(), device_types='cpu',
                         schema='(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, '
                                'Tensor mask, Tensor grad_out) -> (Tensor, Tensor, Tensor)')
def _backward_op(q, k, v, out, lse, mask, grad_out):
    return masked_attention_vjp_plain(q, k, v, mask, grad_out)


@_backward_op.register_kernel('cuda')
def _backward_cuda(q, k, v, out, lse, mask, grad_out):
    if grad_out.data_ptr() % 16:
        grad_out = grad_out.clone()
    b, heads, nq, head_dim = q.shape
    ns, bf16 = k.shape[2], q.dtype == torch.bfloat16
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    chunks, dq_part = 0, None  # the f32 kernels take no key split
    if bf16:
        chunks = key_chunks(b * heads, nq, ns, sm_count(q.device.index))
        dq_part = torch.empty((chunks, *q.shape), dtype=torch.float32, device=q.device)
    launch(entry_point(_LIBRARY, 'wis_masked_attention_bwd', 12, 7), q.device,
           f'masked attention backward for q {tuple(q.shape)}',
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), grad_out.data_ptr(),
           lse.data_ptr(), mask.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
           delta.data_ptr(), dq_part.data_ptr() if bf16 else None, b, heads, nq, ns,
           head_dim, int(bf16), chunks)
    count_launch(BACKWARD_LAUNCHES)
    return dq, dk, dv


@_backward_op.register_fake
def _backward_fake(q, k, v, out, lse, mask, grad_out):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _setup_context(ctx, inputs, output):
    q, k, v, mask = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse, mask)
    ctx.mark_non_differentiable(lse)
    ctx.set_materialize_grads(False)


def _backward(ctx, grad_out, _grad_lse):
    q, k, v, out, lse, mask = ctx.saved_tensors
    grads = _backward_op(q, k, v, out, lse, mask, grad_out.to(q.dtype).contiguous())
    return *grads, None


_forward_op.register_autograd(_backward, setup_context=_setup_context)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """q (B, H, Q, D) pre-scaled, k/v (B, H, S, D), mask bool (B, 1, Q, S)
    (True = blocked; no row fully blocked) → (B, H, Q, D) in q's dtype.

    On CUDA tensors this launches the kernel (q/k/v float32 or bfloat16,
    contiguous, D in {16, 32, 64}, Q ≤ 512; bfloat16 16-byte aligned) and,
    under autograd, its backward kernels. On CPU tensors it runs :func:`masked_attention_plain`."""
    _check(q, k, v, mask)
    if q.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'no kernel for device {q.device}')
    if q.device.type == 'cuda':
        _check_kernel(q, k, v, mask)
    return _forward_op(q, k, v, mask)[0]

