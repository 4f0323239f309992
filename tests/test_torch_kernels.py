"""The CUDA kernels' wrappers and, on a card, each kernel against its plain
version: the post-process kernel, the window-attention and
masked-attention kernels forward and backward, and the MSDA forward.

This file imports neither jax nor the JAX package, so the ``cuda`` tests also
run on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda
"""

import ctypes
import json
import math
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from weed_instance_segmentation_tpu_torch.engine import trace
from weed_instance_segmentation_tpu_torch.evaluation.mean_ap import mask_iou_matrix
from weed_instance_segmentation_tpu_torch.models.configuration import Mask2FormerConfig
from weed_instance_segmentation_tpu_torch.models.pixel_decoder import PixelDecoder
from weed_instance_segmentation_tpu_torch.models.swin import shifted_window_attn_mask
from weed_instance_segmentation_tpu_torch.ops import deformable_attention as msda_ops
from weed_instance_segmentation_tpu_torch.ops.masked_attention import (
    BACKWARD_LAUNCHES as MASKED_BACKWARD_LAUNCHES, BLOCKS_PER_SM, KEY_TILE,
    LAUNCHES as MASKED_LAUNCHES, ROW_TILE, key_chunks, masked_attention, masked_attention_plain,
)
from weed_instance_segmentation_tpu_torch.ops.postprocess_kernel import (
    BAND_ROWS, LAUNCHES as POSTPROCESS_LAUNCHES, SHARED_LIMIT, band_plan, bilinear_taps,
    fused_upsample_stats, fused_upsample_stats_plain, shared_layout, tap_table, upsample_plain,
)
from weed_instance_segmentation_tpu_torch.ops.resize import (
    bilinear_resize_matrix, nearest_indices,
)
from weed_instance_segmentation_tpu_torch.ops import window_attention as window_ops
from weed_instance_segmentation_tpu_torch.ops.window_attention import (
    BACKWARD_LAUNCHES as WINDOW_BACKWARD_LAUNCHES, BACKWARD_MAX_TOKENS,
    LAUNCHES as WINDOW_LAUNCHES, window_attention, window_attention_plain, window_runs,
)
from weed_instance_segmentation_tpu_torch.processing.postprocess import (
    post_process_instance_segmentation,
)


@pytest.mark.parametrize('in_size,out_size', [(200, 384), (25, 384), (384, 200), (7, 7), (1, 5)])
def test_taps_hold_the_resize_matrix(in_size, out_size):
    """The kernel's 2-tap arrays are the rows of the plain version's matrix,
    bit for bit."""
    idx, w = bilinear_taps(in_size, out_size)
    assert idx.dtype == np.int32 and w.dtype == np.float32
    dense = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    dense[rows, idx[0]] += w[0]
    dense[rows, idx[1]] += w[1]  # w[1] is 0 where lo == hi
    np.testing.assert_array_equal(dense, bilinear_resize_matrix(in_size, out_size))


def test_tap_gather_form_matches_plain():
    """The kernel's arithmetic (rows first, then columns, two taps each),
    in numpy, against the plain matmul form."""
    logits = np.random.default_rng(0).standard_normal((3, 17, 23)).astype(np.float32)
    (ylo, yhi), (wy0, wy1) = bilinear_taps(17, 40)
    (xlo, xhi), (wx0, wx1) = bilinear_taps(23, 30)
    r0 = wy0[:, None] * logits[:, ylo][:, :, xlo] + wy1[:, None] * logits[:, yhi][:, :, xlo]
    r1 = wy0[:, None] * logits[:, ylo][:, :, xhi] + wy1[:, None] * logits[:, yhi][:, :, xhi]
    up = wx0 * r0 + wx1 * r1
    want = upsample_plain(torch.from_numpy(logits), (40, 30)).numpy()
    np.testing.assert_allclose(up, want, atol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    good = torch.zeros((1, 2, 4, 4))
    with pytest.raises(TypeError, match='float32'):
        fused_upsample_stats(good.double(), (8, 8))
    with pytest.raises(ValueError, match='B, Q, Hm, Wm'):
        fused_upsample_stats(good[0], (8, 8))
    with pytest.raises(ValueError, match='contiguous'):
        fused_upsample_stats(good.transpose(2, 3), (8, 8))
    with pytest.raises(ValueError, match='score_hw'):
        fused_upsample_stats(good, (0, 8))
    with pytest.raises(ValueError, match='no kernel for device'):
        fused_upsample_stats(good.to('meta'), (8, 8))


def test_cpu_tensor_runs_the_plain_version():
    logits = torch.from_numpy(
        np.random.default_rng(1).standard_normal((2, 3, 10, 12)).astype(np.float32))
    launches = trace.counter(POSTPROCESS_LAUNCHES)
    got = fused_upsample_stats(logits, (24, 20))
    want = fused_upsample_stats_plain(logits, (24, 20))
    assert trace.counter(POSTPROCESS_LAUNCHES) == launches
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0].shape == got[1].shape == (2, 3) and got[2].shape == (2, 3, 24, 20)


@pytest.mark.parametrize('hm,wm,sh,sw', [(200, 200, 384, 384), (37, 50, 96, 64),
                                          (300, 300, 128, 128), (50, 60, 100, 70), (1, 1, 1, 1),
                                          (7, 5, 384, 2048), (4000, 30, 10, 10)])
def test_band_plan_covers_every_row_and_fits(hm, wm, sh, sw):
    """Every output row lies in one band; each band's taps read inside its
    staged span; the block's shared memory is within the card's limit; and
    the tap table holds the taps' indices and weights bit for bit."""
    rows, bands, span = band_plan(hm, wm, sh, sw, BAND_ROWS)
    assert 1 <= rows <= BAND_ROWS and bands == -(-sh // rows)
    table = tap_table(hm, sh)
    idx, w = bilinear_taps(hm, sh)
    np.testing.assert_array_equal(table[:, :2].T, idx)
    np.testing.assert_array_equal(table[:, 2:].copy().view(np.float32).T, w)
    for band in range(bands):
        taps = table[band * rows:(band + 1) * rows]
        assert len(taps) >= 1
        r_lo = taps[0, 0]
        assert taps[:, :2].min() == r_lo and taps[:, :2].max() - r_lo < span
    assert shared_layout(wm, sw, rows, span)[2] <= SHARED_LIMIT


def test_band_plan_halves_bands_and_raises_beyond_shared_memory():
    """A downsample's span grows with the ratio, so the band is halved to
    keep a block's shared memory small; a map too wide for even one output
    row raises."""
    rows, _, span = band_plan(1200, 300, 128, 128, BAND_ROWS)
    assert rows < BAND_ROWS and span > rows
    with pytest.raises(ValueError, match='shared memory'):
        band_plan(8, 40000, 16, 16, BAND_ROWS)


def _banded_upsample_stats(logits, score_hw):
    """The kernel's arithmetic in float32 on the CPU: the output rows cut in
    bands (``band_plan``), each band's input rows staged as one span, the
    vertical pass over the span's rows, then the horizontal pass, each with
    the tap table's two taps; per-band partial sums and counts, then each
    map's partials added in band order."""
    b, q, hm, wm = logits.shape
    sh, sw = score_hw
    rows, bands, span = band_plan(hm, wm, sh, sw, BAND_ROWS)
    maps = logits.reshape(b * q, hm, wm)

    def taps(in_size, out_size):
        t = torch.from_numpy(tap_table(in_size, out_size))
        return (t[:, 0].long(), t[:, 1].long(), t[:, 2].contiguous().view(torch.float32),
                t[:, 3].contiguous().view(torch.float32))

    ylo, yhi, wy0, wy1 = taps(hm, sh)
    xlo, xhi, wx0, wx1 = taps(wm, sw)
    sig_part = torch.zeros((b * q, bands))
    cnt_part = torch.zeros((b * q, bands), dtype=torch.int32)
    bins = torch.empty((b * q, sh, sw), dtype=torch.int8)
    for band in range(bands):
        oy = torch.arange(band * rows, min(band * rows + rows, sh))
        r_lo, r_hi = int(ylo[oy[0]]), int(yhi[oy[-1]])
        assert r_hi - r_lo < span
        staged = maps[:, r_lo:r_hi + 1]
        v = (wy0[oy, None] * staged[:, ylo[oy] - r_lo]
             + wy1[oy, None] * staged[:, yhi[oy] - r_lo])
        up = wx0 * v[:, :, xlo] + wx1 * v[:, :, xhi]
        pos = up > 0
        bins[:, oy] = pos.to(torch.int8)
        sig_part[:, band] = torch.where(pos, torch.sigmoid(up), 0.0).sum(dim=(1, 2))
        cnt_part[:, band] = pos.sum(dim=(1, 2), dtype=torch.int32)
    sig = torch.zeros(b * q)
    for band in range(bands):
        sig = sig + sig_part[:, band]
    return (sig.reshape(b, q), cnt_part.sum(dim=1).float().reshape(b, q),
            bins.reshape(b, q, sh, sw))


def _assert_flips_accounted(sig, cnt, bins, logits, score_hw):
    """Against the plain version: a bin may flip only where the plain
    upsample is within 1e-5 of zero (float32 summation order); pos_cnt is
    exact and sig_sum within rtol 1e-5 once each flip has moved its pixel
    in or out of both sums."""
    up = upsample_plain(logits, score_hw)
    p_sig, p_cnt, p_bins = fused_upsample_stats_plain(logits, score_hw)
    flips = bins != p_bins
    if flips.any():
        assert up[flips].abs().max().item() <= 1e-5
    delta = (bins.float() - p_bins.float()) * flips
    assert torch.equal(cnt, p_cnt + delta.sum(dim=(-1, -2)))
    want = p_sig + (delta * torch.sigmoid(up)).sum(dim=(-1, -2))
    assert ((sig - want).abs() <= 1e-5 * want.abs()).all()


UPSAMPLE_CASES = {  # (B, Q, Hm, Wm), (sh, sw)
    'serving-200-to-384': ((1, 2, 200, 200), (384, 384)),
    'misaligned-37x50': ((1, 3, 37, 50), (96, 64)),
    'downsample-300-to-128': ((1, 2, 300, 300), (128, 128)),
    'ragged-bands-byte-stores': ((1, 2, 45, 51), (100, 99)),
    'one-map': ((1, 1, 25, 25), (384, 384)),
}


@pytest.mark.parametrize('case', list(UPSAMPLE_CASES))
def test_banded_upsample_arithmetic_matches_plain(case):
    """The banded kernel's staging, two passes and band-ordered sums,
    rehearsed on the CPU, against the plain matmul form."""
    shape, score_hw = UPSAMPLE_CASES[case]
    logits = torch.from_numpy(
        np.random.default_rng(2).standard_normal(shape).astype(np.float32) * 2)
    sig, cnt, bins = _banded_upsample_stats(logits, score_hw)
    _assert_flips_accounted(sig, cnt, bins, logits, score_hw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU with nvcc: the CUDA kernel has no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('shape,score_hw', [((2, 16, 200, 200), (384, 384)),
                                            ((1, 3, 37, 50), (96, 64)),
                                            ((1, 2, 45, 51), (100, 99)),
                                            ((2, 4, 300, 300), (128, 128)),
                                            ((1, 1, 200, 200), (384, 384)),
                                            ((1, 2, 9, 7), (40, 2100))])
def test_kernel_matches_plain_on_card(cuda_device, shape, score_hw):
    """sig_sum within rtol 1e-5, after allowing each bin flip its sigmoid
    (≈0.5); every flipped bin lies where the plain upsample is within 1e-5
    of zero (a sign change from float32 summation order)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    logits = torch.randn(shape, generator=g, device=cuda_device) * 2
    launches = trace.counter(POSTPROCESS_LAUNCHES)
    sig, cnt, bins = fused_upsample_stats(logits, score_hw)
    torch.cuda.synchronize()
    assert trace.counter(POSTPROCESS_LAUNCHES) == launches + 1
    up = upsample_plain(logits, score_hw)
    p_sig, p_cnt, p_bins = fused_upsample_stats_plain(logits, score_hw)
    flips = bins != p_bins
    if flips.any():
        assert up[flips].abs().max().item() <= 1e-5
    flips_per_map = flips.sum(dim=(-1, -2)).float()
    assert ((cnt - p_cnt).abs() <= flips_per_map).all()
    assert ((sig - p_sig).abs() <= 1e-5 * p_sig.abs() + 0.5001 * flips_per_map).all()


@pytest.mark.cuda
def test_eval_post_process_of_one_image_on_card(cuda_device):
    """The evaluation path's post-process: one image (B 1), 200 queries,
    a non-square target (300 x 500), on the card (one kernel launch) and on
    the CPU (the plain version). Segment ids and labels equal, scores within
    1e-5; id maps equal except where an upsampled logit is within 1e-5 of
    zero."""
    g = torch.Generator().manual_seed(7)
    class_logits = torch.randn((1, 200, 4), generator=g) * 2
    class_logits[:, :, 0] += 3.0  # a few slots above the threshold
    mask_logits = torch.randn((1, 200, 50, 50), generator=g) * 2

    class Out:
        def __init__(self, cls, msk):
            self.class_queries_logits, self.masks_queries_logits = cls, msk

    launches = trace.counter(POSTPROCESS_LAUNCHES)
    got = post_process_instance_segmentation(
        Out(class_logits.to(cuda_device), mask_logits.to(cuda_device)), threshold=0.5,
        target_sizes=[(300, 500)])[0]
    assert trace.counter(POSTPROCESS_LAUNCHES) == launches + 1
    want = post_process_instance_segmentation(Out(class_logits, mask_logits), threshold=0.5,
                                              target_sizes=[(300, 500)])[0]
    assert want['segments_info'], 'no segment kept'
    assert [(s['id'], s['label_id']) for s in got['segments_info']] == \
        [(s['id'], s['label_id']) for s in want['segments_info']]
    for a, b in zip(got['segments_info'], want['segments_info']):
        assert abs(a['score'] - b['score']) <= 1e-5
    up = upsample_plain(mask_logits, (384, 384))[0]
    near = (up.abs() <= 1e-5).any(dim=0).numpy()
    near = near[nearest_indices(384, 300)][:, nearest_indices(384, 500)]
    differ = got['segmentation'] != want['segmentation']
    assert got['segmentation'].shape == (300, 500) and not differ[~near].any()


@pytest.mark.cuda
def test_mask_iou_matrix_on_card_equals_cpu(cuda_device):
    """The intersection product on the card gives the CPU's bits: 0/1
    inputs, float32 sums of integers below 2**24."""
    rng = np.random.default_rng(8)
    preds = rng.random((40, 256, 320)) < 0.4
    gts = rng.random((12, 256, 320)) < 0.6
    got = mask_iou_matrix(preds, gts, device=cuda_device)
    want = mask_iou_matrix(preds, gts, device='cpu')
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_upsample_kernel_takes_logits_off_a_16_byte_boundary(cuda_device):
    """Logits that start 4 bytes past a 16-byte boundary (a contiguous view
    at a storage offset): each band's span is staged by 4-byte copies up to
    the first 16-byte boundary, then by 16-byte copies."""
    shape, score_hw = (1, 3, 40, 48), (96, 96)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    storage = torch.randn(math.prod(shape) + 1, generator=g, device=cuda_device) * 2
    logits = storage[1:].view(shape)
    assert logits.is_contiguous() and logits.data_ptr() % 16 == 4
    sig, cnt, bins = fused_upsample_stats(logits, score_hw)
    _assert_flips_accounted(sig, cnt, bins, logits, score_hw)


@pytest.mark.cuda
def test_upsample_kernel_is_deterministic(cuda_device):
    """Two calls at the serving shape give the same bits of all three
    outputs: the band partials are added in band order, with no atomics."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    logits = torch.randn((4, 200, 200, 200), generator=g, device=cuda_device) * 2
    first = fused_upsample_stats(logits, (384, 384))
    second = fused_upsample_stats(logits, (384, 384))
    for name, a, b in zip(('sig_sum', 'pos_cnt', 'bins'), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_upsample_kernel_launches_only_its_two_kernels(cuda_device, tmp_path):
    """One call runs the band kernel and the band-sum launch, and nothing
    else on the device (the taps are cached there after the first call)."""
    logits = torch.randn((2, 8, 200, 200), device=cuda_device)
    names = _device_kernels(lambda: fused_upsample_stats(logits, (384, 384)), tmp_path)
    assert len(names) == 2, names
    assert 'upsample_stats_band_kernel' in names[0] and 'band_sums_kernel' in names[1], names


def _kernel_vs_plain(kernel, plain, tensors, consts, grad_index, dtype, seed):
    """Run ``kernel`` on ``tensors`` (q, k, v cast to ``dtype``; any further
    tensor stays float32) and ``plain`` on the same values in float32, both
    under autograd with one random cotangent; return the worst error relative
    to the plain result's largest magnitude over the output and the gradients
    of ``tensors[i]`` for ``grad_index``."""
    ins = [(t.to(dtype) if i < 3 else t).requires_grad_(i in grad_index)
           for i, t in enumerate(tensors)]
    ref_ins = [t.detach().float().requires_grad_(i in grad_index) for i, t in enumerate(ins)]
    out = kernel(*ins, *consts)
    ref = plain(*ref_ins, *consts)
    g = torch.Generator(device=out.device).manual_seed(seed)
    cot = torch.randn(out.shape, generator=g, device=out.device)
    out.backward(cot.to(dtype))
    ref.backward(cot.to(dtype).float())
    torch.cuda.synchronize()
    errs = {'out': ((out.float() - ref).abs().max() / ref.abs().max()).item()}
    for i in grad_index:
        want = ref_ins[i].grad
        errs[i] = ((ins[i].grad.float() - want).abs().max() / want.abs().max()).item()
    return errs


WINDOW_CASES = {  # (images, height, width of the padded map, window, heads, head_dim)
    'small': (2, 8, 12, 4, 2, 16),
    'small-d64': (2, 8, 12, 4, 2, 64),
    'swin-t-w7': (2, 14, 21, 7, 3, 32),
    'swin-l-stage1-b2': (2, 204, 204, 12, 6, 32),
    'swin-l-stage3-b2': (2, 60, 60, 12, 24, 32),
    'w12-d64': (1, 24, 24, 12, 2, 64),  # the bf16 backward's one-set-of-tiles path
}
FORWARD_CASES = {  # beyond the backward's T <= 144: T 169 and 256
    'w13': (1, 26, 26, 13, 2, 32),
    'w16-d64': (1, 32, 32, 16, 2, 64),
}


def _window_inputs(case, shifted, device, seed=1):
    """q, k, v (NW, H, T, D), the relative-position bias (H, T, T) and, if
    ``shifted``, the shift mask (nW_img, T, T), all float32."""
    images, h, w, ws, heads, d = {**WINDOW_CASES, **FORWARD_CASES}[case]
    nw, t = images * (h // ws) * (w // ws), ws * ws
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((nw, heads, t, d), generator=g, device=device) for _ in range(3))
    bias = torch.randn((heads, t, t), generator=g, device=device)
    mask = torch.from_numpy(shifted_window_attn_mask(h, w, ws, ws // 2)).to(device) \
        if shifted else None
    return q, k, v, bias, mask


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('shifted', [False, True], ids=['plain', 'shifted'])
@pytest.mark.parametrize('case', list(WINDOW_CASES))
def test_window_attention_kernels_match_plain(cuda_device, case, shifted, dtype, tol):
    """O, dQ, dK, dV and dBias within ``tol`` of the plain version's largest
    magnitude (f32: 1e-4; bf16: 2e-2 against the plain version in f32 on the
    same bf16 values); each call launches the forward and backward kernel
    once."""
    q, k, v, bias, mask = _window_inputs(case, shifted, cuda_device)
    launches = trace.counter(WINDOW_LAUNCHES), trace.counter(WINDOW_BACKWARD_LAUNCHES)
    errs = _kernel_vs_plain(window_attention, window_attention_plain, [q, k, v, bias], [mask],
                            (0, 1, 2, 3), dtype, 2)
    assert (trace.counter(WINDOW_LAUNCHES), trace.counter(WINDOW_BACKWARD_LAUNCHES)) == \
        (launches[0] + 1, launches[1] + 1)
    assert max(errs.values()) <= tol, errs


@pytest.mark.cuda
@pytest.mark.parametrize('shifted', [False, True], ids=['plain', 'shifted'])
@pytest.mark.parametrize('case', list(FORWARD_CASES))
def test_window_attention_forward_alone_matches_plain(cuda_device, case, shifted):
    """The bf16 forward at T beyond the backward's limit (169 and 256), under
    ``no_grad``: O within 2e-2 of the plain version's largest magnitude (in
    f32 on the same bf16 values), one launch."""
    q, k, v, bias, mask = _window_inputs(case, shifted, cuda_device)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    launches = trace.counter(WINDOW_LAUNCHES)
    with torch.no_grad():
        out = window_attention(q, k, v, bias, mask)
        want = window_attention_plain(q.float(), k.float(), v.float(), bias, mask)
    torch.cuda.synchronize()
    assert trace.counter(WINDOW_LAUNCHES) == launches + 1
    assert ((out.float() - want).abs().max() / want.abs().max()).item() <= 2e-2


def _device_kernels(fn, tmp_path, attempts=3) -> list:
    """The names of the device kernels, copies and fills that one call of
    ``fn`` runs, from a ``torch.profiler`` trace (taken again when the
    profiler returns a trace with no device events)."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        path = str(tmp_path / f'trace{attempt}.json')
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
        names = [e['name'] for e in events if e.get('ph') == 'X'
                 and e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset')]
        if names:
            return names
    raise RuntimeError(f'{attempts} profiler traces held no device events')


@pytest.mark.cuda
def test_window_attention_bf16_forward_launches_the_tensor_core_kernel(cuda_device, tmp_path):
    """A bf16 forward runs one device kernel, window_attention_fwd_mma_kernel;
    with the shift mask, also the PyTorch reduction that flags which image
    windows' masks hold a nonzero entry, and no other window kernel."""
    q, k, v, bias, mask = _window_inputs('swin-l-stage3-b2', True, cuda_device)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    with torch.no_grad():
        plain = _device_kernels(lambda: window_attention(q, k, v, bias), tmp_path)
        shifted = _device_kernels(lambda: window_attention(q, k, v, bias, mask), tmp_path)
    assert len(plain) == 1 and 'window_attention_fwd_mma_kernel' in plain[0], plain
    window = [n for n in shifted if 'window_attention' in n]
    assert len(window) == 1 and 'window_attention_fwd_mma_kernel' in window[0], shifted
    assert len(shifted) == 2, shifted


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
def test_window_attention_backward_is_deterministic(cuda_device, dtype):
    """Two backward calls on the same inputs give the same bits of dQ, dK,
    dV and dBias: the dBias partials are summed in run order, with no
    atomics."""
    q, k, v, bias, mask = _window_inputs('swin-l-stage1-b2', True, cuda_device)
    ins = [t.to(dtype).requires_grad_(True) for t in (q, k, v)] + [bias.requires_grad_(True)]
    out = window_attention(*ins, mask)
    cot = torch.randn(out.shape, generator=torch.Generator(device=cuda_device).manual_seed(5),
                      device=cuda_device).to(dtype)
    first, second = (torch.autograd.grad(out, ins, cot, retain_graph=True) for _ in range(2))
    for name, a, b in zip(('dq', 'dk', 'dv', 'dbias'), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize('runs', [1, 7, 29, 36])
def test_window_attention_backward_takes_any_run_count(cuda_device, monkeypatch, runs):
    """The bf16 backward with its 36 windows split into ``runs`` runs (the
    wrapper's own rule aside): one run, 7 of 5 or 6 windows, 29 of 1 or 2,
    and one run a window; output and gradients within 2e-2 of the plain
    version."""
    monkeypatch.setattr(window_ops, 'window_runs', lambda *_: runs)
    q, k, v, bias, mask = _window_inputs('swin-t-w7', True, cuda_device)
    q, k, v, bias = (torch.cat([t] * 3) if t.ndim == 4 else t for t in (q, k, v, bias))
    errs = _kernel_vs_plain(window_attention, window_attention_plain, [q, k, v, bias], [mask],
                            (0, 1, 2, 3), torch.bfloat16, 2)
    assert max(errs.values()) <= 2e-2, errs


@pytest.mark.cuda
def test_window_attention_wrapper_raises_on_what_the_backward_does_not_take(cuda_device):
    """A bf16 view off 16-byte alignment, and a T beyond the backward's
    limit when an input requires grad (before the forward launches); the
    forward alone still takes that T."""
    bias = torch.zeros((1, 16, 16), device=cuda_device)
    q = torch.zeros(16 * 16 + 1, dtype=torch.bfloat16, device=cuda_device)[1:].view(1, 1, 16, 16)
    with pytest.raises(ValueError, match='16-byte-aligned'):
        window_attention(q, q, q, bias)
    t = BACKWARD_MAX_TOKENS + 25
    q = torch.zeros((1, 1, t, 16), device=cuda_device)
    bias = torch.zeros((1, t, t), device=cuda_device, requires_grad=True)
    launches = trace.counter(WINDOW_LAUNCHES)
    with pytest.raises(ValueError, match=f'at most {BACKWARD_MAX_TOKENS} tokens'):
        window_attention(q, q, q, bias)
    assert trace.counter(WINDOW_LAUNCHES) == launches
    with torch.no_grad():
        out = window_attention(q, q, q, bias)
    torch.cuda.synchronize()
    assert out.shape == q.shape and trace.counter(WINDOW_LAUNCHES) == launches + 1


MASKED_CASES = {'small': (2, 2, 10, 40, 16), 'small-d64': (1, 3, 7, 100, 64),
                'q512-d64': (1, 2, 512, 300, 64), 'few-keys': (2, 2, 40, 5, 32),
                'one-key-rows': (2, 2, 40, 300, 32)}
MASKED_CASES.update({f'swin-l-s{s}': (2, 8, 200, s, 32) for s in (10000, 2500, 625)})
MASKED_CASES['swin-l-serving'] = (4, 8, 200, 10000, 32)


def _masked_inputs(case, device, seed=3):
    """q, k, v and a mask with 70 % of the scores blocked, the first query row
    blocked entirely and then every all-blocked row freed (the decoder's
    escape). In ``one-key-rows`` every odd row sees one key, in the last
    64-key tile, so that every other key chunk of that row is all blocked."""
    b, heads, nq, s, d = MASKED_CASES[case]
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, heads, nq, d), generator=g, device=device) * d ** -0.5
    k, v = (torch.randn((b, heads, s, d), generator=g, device=device) for _ in range(2))
    mask = torch.rand((b, 1, nq, s), generator=g, device=device) < 0.7
    mask[:, :, 0] = True
    mask &= ~mask.all(dim=-1, keepdim=True)
    if case == 'one-key-rows':
        rows = torch.arange(1, nq, 2, device=device)
        mask[:, :, rows] = True
        mask[:, :, rows, s - 1 - rows % 40] = False
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', list(MASKED_CASES))
def test_masked_attention_kernels_match_plain(cuda_device, case, dtype, tol):
    """O, dQ, dK and dV with 70 % of the scores masked (and the all-masked-row
    escape) within ``tol`` of the plain version's largest magnitude."""
    q, k, v, mask = _masked_inputs(case, cuda_device)
    launches = trace.counter(MASKED_LAUNCHES), trace.counter(MASKED_BACKWARD_LAUNCHES)
    errs = _kernel_vs_plain(masked_attention, masked_attention_plain, [q, k, v], [mask],
                            (0, 1, 2), dtype, 4)
    assert (trace.counter(MASKED_LAUNCHES), trace.counter(MASKED_BACKWARD_LAUNCHES)) == \
        (launches[0] + 1, launches[1] + 1)
    assert max(errs.values()) <= tol, errs


@pytest.mark.cuda
def test_attention_wrappers_raise_on_shapes_the_kernels_do_not_take(cuda_device):
    q = torch.zeros((2, 2, 16, 8), device=cuda_device)
    with pytest.raises(ValueError, match='head_dim'):
        window_attention(q, q, q, torch.zeros((2, 16, 16), device=cuda_device))
    with pytest.raises(TypeError, match='float32 or all bfloat16'):
        window_attention(q.half(), q.half(), q.half(), torch.zeros((2, 16, 16), device=cuda_device))
    q = torch.zeros((1, 1, 600, 16), device=cuda_device)
    with pytest.raises(ValueError, match='queries'):
        masked_attention(q, q, q, torch.zeros((1, 1, 600, 600), dtype=torch.bool,
                                              device=cuda_device))
    # the bf16 kernels read 16-byte vectors: a view 2 bytes into its storage
    q = torch.zeros(16 * 16 + 1, dtype=torch.bfloat16, device=cuda_device)[1:].view(1, 1, 16, 16)
    with pytest.raises(ValueError, match='16-byte-aligned'):
        masked_attention(q, q, q, torch.zeros((1, 1, 16, 16), dtype=torch.bool,
                                              device=cuda_device))


@pytest.mark.parametrize('batch_heads,nq,ns', [(16, 200, 10000), (16, 200, 2500), (16, 200, 625),
                                               (32, 200, 10000), (4, 40, 5), (2, 512, 300),
                                               (4, 40, 300), (1, 1, 1), (1, 1, 9 * 64)])
def test_dq_chunks_cover_every_key_tile_once(batch_heads, nq, ns):
    """The bf16 forward's and dQ launch's key split (chunk c takes tiles
    [c·t, (c+1)·t) with t = ceil(tiles / chunks)): every 64-key tile in
    exactly one chunk, no chunk empty, at least two tiles a chunk where
    there are two, and no more blocks than a full card holds at once."""
    tiles = -(-ns // KEY_TILE)
    chunks = key_chunks(batch_heads, nq, ns, 132)
    assert 1 <= chunks <= tiles
    per = -(-tiles // chunks)
    spans = [range(c * per, min((c + 1) * per, tiles)) for c in range(chunks)]
    assert [t for span in spans for t in span] == list(range(tiles))
    assert all(len(span) > 0 for span in spans)
    assert per >= min(2, tiles)
    blocks = batch_heads * -(-nq // ROW_TILE)
    assert chunks == 1 or chunks * blocks <= BLOCKS_PER_SM * 132


def _tiled_bf16_backward(q, k, v, mask, dout, chunks):
    """The bf16 backward kernels' arithmetic in float32 on the CPU: P from the
    forward's log-sum-exp, Delta from the output rounded to bf16, P and dS
    rounded to bf16 before the products that use them, dQ summed over key
    chunks of whole 64-key tiles in chunk order, dK and dV over staged chunks
    of 64 queries; every result rounded to bf16."""
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    scores = q @ k.transpose(-1, -2) + torch.zeros(mask.shape).masked_fill_(mask, -1e9)
    lse = torch.logsumexp(scores, dim=-1, keepdim=True)
    out = bf(torch.softmax(scores, dim=-1) @ v)
    delta = (dout * out).sum(-1, keepdim=True)
    tiles, ns = -(-k.shape[2] // KEY_TILE), k.shape[2]
    per = -(-tiles // chunks)
    dq = torch.zeros_like(q)
    for c in range(chunks):
        sl = slice(c * per * KEY_TILE, min((c + 1) * per * KEY_TILE, ns))
        p = torch.exp(scores[..., sl] - lse)
        ds = bf(p * (dout @ v[:, :, sl].transpose(-1, -2) - delta))
        dq = dq + ds @ k[:, :, sl]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for c0 in range(0, q.shape[2], 64):
        sl = slice(c0, c0 + 64)
        p = torch.exp(scores[:, :, sl] - lse[:, :, sl])
        ds = p * (dout[:, :, sl] @ v.transpose(-1, -2) - delta[:, :, sl])
        dv = dv + bf(p).transpose(-1, -2) @ dout[:, :, sl]
        dk = dk + bf(ds).transpose(-1, -2) @ q[:, :, sl]
    return bf(dq), bf(dk), bf(dv)


@pytest.mark.parametrize('case', ['small', 'few-keys', 'swin-l-s625', 'one-key-rows'])
def test_tiled_bf16_backward_arithmetic_matches_plain(case):
    """The bf16 kernels' rounding and splitting, rehearsed on the CPU: within
    the card test's 2e-2 of the plain float32 gradients on the same bf16
    values."""
    q, k, v, mask = (t.to(torch.bfloat16).float() if t.is_floating_point() else t
                     for t in _masked_inputs(case, torch.device('cpu')))
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(4)).to(
        torch.bfloat16).float()
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    masked_attention_plain(*ins, mask).backward(dout)
    b, heads, nq, _ = q.shape
    got = _tiled_bf16_backward(q, k, v, mask, dout, key_chunks(b * heads, nq, k.shape[2], 132))
    for g_, t in zip(got, ins):
        assert ((g_ - t.grad).abs().max() / t.grad.abs().max()).item() <= 2e-2


def _tiled_bf16_forward(q, k, v, mask, chunks):
    """The bf16 forward kernels' arithmetic in float32 on the CPU: the keys
    padded to whole 64-key tiles (a padded key scores −1e9 and its V row is
    zero), each chunk of whole tiles walked 32 keys at a time with an online
    max and sum, P rounded to bf16 before PV and the sum taken over the
    unrounded P, the chunks merged in chunk order, O rounded to bf16.
    Returns (O, lse)."""
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    ns = k.shape[2]
    tiles = -(-ns // KEY_TILE)
    pad = tiles * KEY_TILE - ns
    scores = q @ k.transpose(-1, -2) + torch.zeros(mask.shape).masked_fill_(mask, -1e9)
    scores = F.pad(scores, (0, pad), value=-1e9)
    v = F.pad(v, (0, 0, 0, pad))
    per = -(-tiles // chunks)
    parts = []
    for c in range(chunks):
        m = torch.full((*q.shape[:3], 1), -1e30)
        l, acc = torch.zeros_like(m), torch.zeros_like(q)
        for s0 in range(c * per * KEY_TILE, min((c + 1) * per * KEY_TILE, ns), 32):
            s = scores[..., s0:s0 + 32]
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha, p = torch.exp(m - m_new), torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + bf(p) @ v[:, :, s0:s0 + 32]
            m = m_new
        parts.append((m, l, acc))
    m = torch.stack([m_c for m_c, _, _ in parts]).amax(0)
    l = sum(l_c * torch.exp(m_c - m) for m_c, l_c, _ in parts)
    out = sum(acc_c * torch.exp(m_c - m) for m_c, _, acc_c in parts) / l
    return bf(out), (m + torch.log(l)).squeeze(-1)


@pytest.mark.parametrize('case', ['small', 'few-keys', 'swin-l-s625', 'one-key-rows'])
def test_tiled_bf16_forward_arithmetic_matches_plain(case):
    """The bf16 forward's rounding, key split and (max, sum) merge, rehearsed
    on the CPU: O within the card test's 2e-2 of the plain float32 output on
    the same bf16 values, and lse within 1e-5 of the true log-sum-exp (the
    backward recomputes P from it)."""
    q, k, v, mask = (t.to(torch.bfloat16).float() if t.is_floating_point() else t
                     for t in _masked_inputs(case, torch.device('cpu')))
    b, heads, nq, _ = q.shape
    chunks = key_chunks(b * heads, nq, k.shape[2], 132)
    if case == 'one-key-rows':  # the odd rows' only key is in the last chunk
        assert chunks > 1
    out, lse = _tiled_bf16_forward(q, k, v, mask, chunks)
    want = masked_attention_plain(q, k, v, mask)
    assert ((out - want).abs().max() / want.abs().max()).item() <= 2e-2
    scores = q @ k.transpose(-1, -2) + torch.zeros(mask.shape).masked_fill_(mask, -1e9)
    assert (lse - torch.logsumexp(scores, dim=-1)).abs().max().item() <= 1e-5


# (windows, heads) of the four Swin-L stages at 800² batch 2, tiny-test's
# first two stages at 64 x 96 batch 2, and Swin-T's first stage (T = 49) at
# 800² batch 2
@pytest.mark.parametrize('windows,heads', [(578, 6), (162, 12), (50, 24), (18, 48), (48, 1),
                                           (12, 2), (1682, 3)])
def test_window_runs_cover_every_window_once(windows, heads):
    """The backward's runs (run r takes windows r, r + runs, r + 2·runs, …):
    every window in exactly one run, no run empty, runs within one window of
    each other's length, and no more (run, head) blocks than one wave of 132
    SMs."""
    runs = window_runs(windows, heads, 132)
    assert 1 <= runs <= windows
    spans = [range(r, windows, runs) for r in range(runs)]
    assert sorted(w for span in spans for w in span) == list(range(windows))
    assert min(len(span) for span in spans) >= max(1, len(spans[0]) - 1)
    assert runs * heads <= 132 or runs == 1


def _tiled_bf16_window_backward(q, k, v, bias, mask, dout, runs):
    """The bf16 backward kernel's arithmetic in float32 on the CPU: P from
    the forward's log-sum-exp, Delta from the output rounded to bf16, P and
    dS rounded to bf16 before dV, dK and dQ, and dBias from the unrounded dS
    summed over each run's windows (run r: r, r + runs, …) in window order,
    then over the runs in run order; dQ, dK and dV rounded to bf16."""
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    nw, _, _, d = q.shape
    scores = q @ k.transpose(-1, -2) / math.sqrt(d) + bias
    if mask is not None:
        scores = scores + mask.repeat(nw // mask.shape[0], 1, 1)[:, None]
    lse = torch.logsumexp(scores, dim=-1, keepdim=True)
    out = bf(torch.softmax(scores, dim=-1) @ v)
    delta = (dout * out).sum(-1, keepdim=True)
    p = torch.exp(scores - lse)
    ds = p * (dout @ v.transpose(-1, -2) - delta)
    dq = bf(bf(ds) @ k / math.sqrt(d))
    dk = bf(bf(ds).transpose(-1, -2) @ q / math.sqrt(d))
    dv = bf(bf(p).transpose(-1, -2) @ dout)
    dbias = torch.zeros_like(bias)
    for r in range(runs):
        part = torch.zeros_like(bias)
        for w in range(r, nw, runs):
            part = part + ds[w]
        dbias = dbias + part
    return dq, dk, dv, dbias


@pytest.mark.parametrize('shifted', [False, True], ids=['plain', 'shifted'])
@pytest.mark.parametrize('case', ['small', 'small-d64', 'swin-t-w7'])
def test_tiled_bf16_window_backward_arithmetic_matches_plain(case, shifted):
    """The bf16 backward's rounding and run split, rehearsed on the CPU:
    dQ, dK, dV and dBias within the card test's 2e-2 of the plain float32
    gradients on the same bf16 values."""
    q, k, v, bias, mask = _window_inputs(case, shifted, torch.device('cpu'))
    q, k, v = (t.to(torch.bfloat16).float() for t in (q, k, v))
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(2)).to(
        torch.bfloat16).float()
    ins = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
    window_attention_plain(*ins, mask).backward(dout)
    nw, heads = q.shape[:2]
    runs = window_runs(nw, heads, 132)
    got = _tiled_bf16_window_backward(q, k, v, bias, mask, dout, runs)
    for g_, t in zip(got, ins):
        assert ((g_ - t.grad).abs().max() / t.grad.abs().max()).item() <= 2e-2


def _tiled_bf16_window_forward(q, k, v, bias, mask):
    """The bf16 forward kernel's arithmetic in float32 on the CPU: the scores
    scaled, with the bias and the mask, the tokens padded to whole 16-key
    steps (a padded key scores −1e30 and its V row is zero), the keys walked
    16 at a time with a running max and sum, P rounded to bf16 before PV and
    the sum taken over the unrounded P, O / l rounded to bf16. Returns
    (O, lse)."""
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    nw, _, t, d = q.shape
    scores = q @ k.transpose(-1, -2) / math.sqrt(d) + bias
    if mask is not None:
        scores = scores + mask.repeat(nw // mask.shape[0], 1, 1)[:, None]
    pad = -t % 16
    scores = F.pad(scores, (0, pad), value=-1e30)
    v = F.pad(v, (0, 0, 0, pad))
    m = torch.full((*q.shape[:3], 1), -1e30)
    l, acc = torch.zeros_like(m), torch.zeros_like(q)
    for s0 in range(0, t + pad, 16):
        s = scores[..., s0:s0 + 16]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp(m - m_new), torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + bf(p) @ v[:, :, s0:s0 + 16]
        m = m_new
    return bf(acc / l), (m + torch.log(l)).squeeze(-1)


@pytest.mark.parametrize('case,shifted', [
    *((c, s) for c in ('small', 'small-d64', 'swin-t-w7') for s in (False, True)),
    ('w13', True)], ids=lambda x: x if isinstance(x, str) else ('shifted' if x else 'plain'))
def test_tiled_bf16_window_forward_arithmetic_matches_plain(case, shifted):
    """The bf16 forward's padding, online softmax and rounding, rehearsed on
    the CPU: O within the card test's 2e-2 of the plain float32 output on the
    same bf16 values, and lse within 1e-5 of the true log-sum-exp (the
    backward recomputes P from it). T = 169 (``w13``) is odd and beyond the
    backward's limit: 11 key steps, the last holding 9 keys."""
    q, k, v, bias, mask = _window_inputs(case, shifted, torch.device('cpu'))
    q, k, v = (t.to(torch.bfloat16).float() for t in (q, k, v))
    d = q.shape[3]
    out, lse = _tiled_bf16_window_forward(q, k, v, bias, mask)
    want = window_attention_plain(q, k, v, bias, mask)
    assert ((out - want).abs().max() / want.abs().max()).item() <= 2e-2
    scores = q @ k.transpose(-1, -2) / math.sqrt(d) + bias
    if mask is not None:
        scores = scores + mask.repeat(q.shape[0] // mask.shape[0], 1, 1)[:, None]
    assert (lse - torch.logsumexp(scores, dim=-1)).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_msda_value_grad_same_bits_on_card(cuda_device):
    """The MSDA value gradient on the card at bf16, with hundreds of taps on
    each value row: the same bits from two backward calls (its float32 sums
    are added in a fixed order), and within one bf16 rounding of the CPU's
    serially summed gradient."""
    from weed_instance_segmentation_tpu_torch.ops.deformable_attention import msda

    shapes = ((6, 7), (3, 4))
    g = torch.Generator().manual_seed(5)
    b, q, heads, d, points = 2, 300, 2, 8, 4
    value = torch.randn((b, sum(h * w for h, w in shapes), heads, d), generator=g).bfloat16()
    locations = (torch.rand((b, q, heads, len(shapes), points, 2), generator=g) * 1.2 - 0.1
                 ).bfloat16()
    weights = torch.softmax(torch.randn((b, q, heads, len(shapes) * points), generator=g), -1
                            ).reshape(b, q, heads, len(shapes), points).bfloat16()
    cot = torch.randn((b, q, heads * d), generator=g).bfloat16()
    grads = []
    for device in ('cpu', cuda_device, cuda_device):
        v = value.detach().clone().to(device).requires_grad_(True)
        msda(v, shapes, locations.to(device), weights.to(device)).backward(cot.to(device))
        grads.append(v.grad.cpu())
    cpu, first, second = grads
    assert torch.equal(first, second)
    err = (first.float() - cpu.float()).abs()
    assert (err <= 2 ** -7 * cpu.float().abs() + 1e-6).all(), err.max().item()


@pytest.mark.parametrize('op', ['masked', 'window', 'window-shifted'])
def test_registered_backward_gives_the_plain_gradients(op):
    """On the CPU the registered forward operator's autograd formula calls
    the registered backward operator, whose CPU implementation is the plain
    version's vector-Jacobian product: the same bits as autograd through the
    plain version (dQ, dK, dV, and dBias for window attention)."""
    if op == 'masked':
        q, k, v, mask = _masked_inputs('small', torch.device('cpu'))
        wrapper, plain, ins, consts = masked_attention, masked_attention_plain, [q, k, v], [mask]
    else:
        q, k, v, bias, mask = _window_inputs('small', op == 'window-shifted', torch.device('cpu'))
        wrapper, plain, ins, consts = window_attention, window_attention_plain, [q, k, v, bias], \
            [mask]
    cot = torch.randn(q.shape, generator=torch.Generator().manual_seed(6))
    grads = []
    for fn in (wrapper, plain):
        leaves = [t.clone().requires_grad_(True) for t in ins]
        fn(*leaves, *consts).backward(cot)
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_registered_ops_give_the_wrappers_bits_on_card(cuda_device):
    """Each registered operator called directly on CUDA tensors gives the
    bits of its wrapper (forward and, through autograd, backward; the
    lse float32), and ``torch.export`` of a module that calls the three
    forward wrappers records the operators; the exported program gives the
    module's bits, and its launches are counted."""
    wistpu = torch.ops.wistpu
    q, k, v, mask = (t.to(torch.bfloat16) if t.is_floating_point() else t
                     for t in _masked_inputs('small', cuda_device))
    out, lse = wistpu.masked_attention_fwd(q, k, v, mask)
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = masked_attention(*leaves, mask)
    assert torch.equal(out, want)
    cot = torch.randn_like(want)
    want.backward(cot)
    for got, leaf in zip(wistpu.masked_attention_bwd(q, k, v, out, lse, mask, cot), leaves):
        assert torch.equal(got, leaf.grad)

    wq, wk, wv, bias, wmask = _window_inputs('swin-t-w7', True, cuda_device)
    wq, wk, wv = (t.to(torch.bfloat16) for t in (wq, wk, wv))
    out, lse = wistpu.window_attention_fwd(wq, wk, wv, bias, wmask)
    assert lse.dtype == torch.float32 and lse.shape == wq.shape[:3]
    leaves = [t.clone().requires_grad_(True) for t in (wq, wk, wv, bias)]
    want = window_attention(*leaves, wmask)
    assert torch.equal(out, want)
    cot = torch.randn_like(want)
    want.backward(cot)
    got = wistpu.window_attention_bwd(wq, wk, wv, out, lse, bias, wmask, cot)
    for g_, leaf in zip(got, leaves):
        assert torch.equal(g_, leaf.grad)

    logits = torch.randn((1, 3, 37, 50), generator=torch.Generator(device=cuda_device)
                         .manual_seed(0), device=cuda_device)
    for g_, w in zip(wistpu.fused_upsample_stats(logits, [96, 64]),
                     fused_upsample_stats(logits, (96, 64))):
        assert torch.equal(g_, w)

    class Calls(torch.nn.Module):
        def forward(self, q, k, v, mask, wq, wk, wv, bias, wmask, logits):
            return (masked_attention(q, k, v, mask), window_attention(wq, wk, wv, bias, wmask),
                    *fused_upsample_stats(logits, (96, 64)))

    args = (q, k, v, mask, wq, wk, wv, bias, wmask, logits)
    with torch.no_grad():
        program = torch.export.export(Calls(), args, strict=False)
        want = Calls()(*args)
        launches = (trace.counter(MASKED_LAUNCHES), trace.counter(WINDOW_LAUNCHES),
                    trace.counter(POSTPROCESS_LAUNCHES))
        got = program.module()(*args)
    assert (trace.counter(MASKED_LAUNCHES), trace.counter(WINDOW_LAUNCHES),
            trace.counter(POSTPROCESS_LAUNCHES)) == tuple(n + 1 for n in launches)
    ops = {str(n.target) for n in program.graph.nodes if str(n.target).startswith('wistpu.')}
    assert ops == {'wistpu.masked_attention_fwd.default', 'wistpu.window_attention_fwd.default',
                   'wistpu.fused_upsample_stats.default'}
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# name → (batch, queries, heads, head dim, points, level shapes)
MSDA_CASES = {
    'swin-l-800': (4, 13125, 8, 32, 4, ((25, 25), (50, 50), (100, 100))),  # the encoder at 800²
    'tiny-d16': (2, 37, 2, 16, 4, ((4, 6), (2, 3), (1, 2))),
    'd64': (2, 300, 4, 64, 2, ((12, 10), (6, 5), (3, 3), (2, 2))),
}
# locations that land on the map's edges (0, 1), on exact pixel centres
# (x = loc * W - 0.5 an integer: 0.5 at W 25, 0.25 at W 50 or 12, 0.125 at
# W 100) and outside it
MSDA_SPECIAL = (0.0, 1.0, 0.5, 0.25, 0.125, -0.25, 1.25, 3.0, -2.0)


def _msda_kernel_inputs(case, dtype, device):
    """Value, locations and weights of ``case`` in ``dtype``: locations in
    [-0.3, 1.3] with a fifth of them replaced by :data:`MSDA_SPECIAL`,
    softmaxed weights."""
    b, q, heads, d, points, shapes = MSDA_CASES[case]
    g = torch.Generator().manual_seed(31)
    value = torch.randn((b, sum(h * w for h, w in shapes), heads, d), generator=g)
    locations = torch.rand((b, q, heads, len(shapes), points, 2), generator=g) * 1.6 - 0.3
    special = torch.tensor(MSDA_SPECIAL)[torch.randint(0, len(MSDA_SPECIAL), locations.shape,
                                                        generator=g)]
    locations = torch.where(torch.rand(locations.shape, generator=g) < 0.2, special, locations)
    weights = torch.softmax(torch.randn((b, q, heads, len(shapes) * points), generator=g), -1)
    weights = weights.reshape(locations.shape[:-1])
    return tuple(t.to(device, dtype) for t in (value, locations, weights)) + (shapes,)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
def test_msda_operator_on_cpu_is_the_plain_version(dtype):
    """``torch.ops.wistpu.msda_fwd`` on CPU tensors gives ``_msda_fused``'s
    bits and launches nothing."""
    value, locations, weights, shapes = _msda_kernel_inputs('tiny-d16', dtype, 'cpu')
    launches = trace.counter(msda_ops.LAUNCHES)
    got = torch.ops.wistpu.msda_fwd(value, [d for hw in shapes for d in hw], locations, weights)
    assert torch.equal(got, msda_ops._msda_fused(value, shapes, locations, weights))
    assert got.dtype == dtype and trace.counter(msda_ops.LAUNCHES) == launches


def test_msda_operator_fake_gives_the_output_shape_and_dtype():
    """The operator's fake implementation (what ``torch.export`` traces
    with): (B, Q, heads · D) in the value's dtype, on meta and fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    value, locations, weights, shapes = _msda_kernel_inputs('d64', torch.bfloat16, 'cpu')
    flat = [d for hw in shapes for d in hw]
    want = (2, 300, 4 * 64)
    got = torch.ops.wistpu.msda_fwd(value.to('meta'), flat, locations.to('meta'),
                                    weights.to('meta'))
    assert got.shape == want and got.dtype == torch.bfloat16 and got.device.type == 'meta'
    with FakeTensorMode() as mode:
        got = torch.ops.wistpu.msda_fwd(*(mode.from_tensor(t) for t in (value,)), flat,
                                        mode.from_tensor(locations), mode.from_tensor(weights))
    assert got.shape == want and got.dtype == torch.bfloat16


def test_msda_without_grad_goes_through_the_operator():
    """``msda`` calls the operator where no input needs a gradient (no-grad
    mode, or inputs that need none) and the plain autograd route otherwise."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Calls(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    value, locations, weights, shapes = _msda_kernel_inputs('tiny-d16', torch.float32, 'cpu')
    seen = {}
    for route in ('no_grad', 'no_input_needs_grad', 'grad'):
        leaf = value.clone().requires_grad_(route != 'no_input_needs_grad')
        with torch.set_grad_enabled(route != 'no_grad'), Calls() as calls:
            out = msda_ops.msda(leaf, shapes, locations, weights)
        seen[route] = 'wistpu.msda_fwd.default' in calls.ops
        assert torch.equal(out, msda_ops._msda_fused(value, shapes, locations, weights))
    assert seen == {'no_grad': True, 'no_input_needs_grad': True, 'grad': False}


def test_msda_kernel_check_rejects_what_the_kernel_does_not_take():
    """The CUDA implementation's checks (they read no device): head dims
    outside {16, 32, 64}, other dtypes, mixed location and weight dtypes,
    more than four levels, levels that do not cover the value, and
    non-contiguous inputs raise."""
    value, locations, weights, shapes = _msda_kernel_inputs('tiny-d16', torch.bfloat16, 'cpu')
    msda_ops._check_kernel(value, shapes, locations, weights)
    with pytest.raises(ValueError, match='head_dim'):
        msda_ops._check_kernel(value[..., :8].contiguous(), shapes, locations, weights)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        msda_ops._check_kernel(value.half(), shapes, locations, weights)
    with pytest.raises(TypeError, match='one dtype'):
        msda_ops._check_kernel(value, shapes, locations.float(), weights)
    with pytest.raises(ValueError, match='levels'):
        msda_ops._check_kernel(value, shapes[:2], locations, weights)
    five = (shapes[0], shapes[1], (1, 1), (1, 1), (1, 1))
    wide = torch.zeros((*locations.shape[:3], 5, *locations.shape[4:]), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='1 to 4 levels'):
        msda_ops._check_kernel(torch.zeros((2, 33, 2, 16), dtype=torch.bfloat16), five, wide,
                               wide[..., 0])
    with pytest.raises(ValueError, match='contiguous'):
        msda_ops._check_kernel(value.transpose(1, 2).contiguous().transpose(1, 2), shapes,
                               locations, weights)
    with pytest.raises(ValueError, match=r'\(B, L, heads, D\)'):
        msda_ops._check_kernel(value, shapes, locations[..., :1], weights)


@pytest.fixture(scope='module')
def msda_source_on_cpu(tmp_path_factory):
    """``csrc/msda.cu`` compiled by g++ for the CPU against the host
    stand-ins in ``tests/cuda_host_stub/`` (device intrinsics with their
    round-to-nearest arithmetic, no contracted multiply-add), its launch
    rewritten as a loop over the grid's blocks and threads; the entry point
    ``wis_msda_fwd`` bound with ``ctypes``."""
    if shutil.which('g++') is None:
        pytest.skip('needs g++ to compile the kernel source for the CPU')
    here = os.path.dirname(os.path.abspath(__file__))
    csrc = os.path.join(os.path.dirname(msda_ops.__file__), os.pardir, 'csrc')
    with open(os.path.join(csrc, 'msda.cu')) as f:
        source, launches = re.subn(r'(\w+<[^<>;]*>)<<<([^,]+), ([^,]+), [^>]*>>>',
                                   r'EMULATE_GRID(\2, \3) \1', f.read())
    assert launches == 1
    out = tmp_path_factory.mktemp('msda_cpu')
    src, lib = out / 'msda_cpu.cpp', out / 'libmsda_cpu.so'
    src.write_text(source)
    subprocess.run(['g++', '-std=c++17', '-O1', '-ffp-contract=off', '-shared', '-fPIC',
                    '-I', os.path.join(here, 'cuda_host_stub'), '-I', csrc, '-o', str(lib),
                    str(src)], check=True, capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).wis_msda_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 17 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.parametrize('coords', [torch.float32, torch.bfloat16], ids=['coords-f32',
                                                                         'coords-bf16'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', ['tiny-d16', 'd64', 'd32'])
def test_msda_source_on_the_cpu_gives_the_plain_bits(msda_source_on_cpu, case, dtype, coords):
    """The kernel's own source, run on the CPU one thread after another
    (:func:`msda_source_on_cpu`): its thread mapping, level offsets, bounds
    and the order and rounding of its sums give ``_msda_fused``'s bits, at
    every head dim it takes, with float32 or bfloat16 values, locations and
    weights, up to four levels and two or four points; the entry point
    refuses levels that do not cover the value."""
    if case == 'd32':  # Swin-L's widths at a few queries of small maps
        b, q, heads, d, points, shapes = 2, 45, 8, 32, 4, ((3, 3), (5, 5), (10, 10))
        g = torch.Generator().manual_seed(7)
        value = torch.randn((b, 134, heads, d), generator=g).to(dtype)
        locations = (torch.rand((b, q, heads, 3, points, 2), generator=g) * 1.6 - 0.3).to(coords)
        weights = torch.softmax(torch.randn((b, q, heads, 3 * points), generator=g), -1)
        weights = weights.reshape(b, q, heads, 3, points).to(coords)
    else:
        value, locations, weights, shapes = _msda_kernel_inputs(case, dtype, 'cpu')
        locations, weights = locations.float().to(coords), weights.float().to(coords)
        b, q, heads, d = *locations.shape[:3], value.shape[3]
    levels, points = locations.shape[3:5]
    out = torch.empty((b, q, heads * d), dtype=dtype)
    dims = [n for hw in shapes for n in hw] + [0] * (2 * (4 - levels))
    args = [value.data_ptr(), locations.data_ptr(), weights.data_ptr(), out.data_ptr(), b,
            value.shape[1], q, heads, d, levels, points, *dims, int(dtype == torch.bfloat16),
            int(coords == torch.bfloat16), None]
    assert msda_source_on_cpu(*args) == 0
    assert torch.equal(out, msda_ops._msda_fused(value, shapes, locations, weights))
    args[5] += 1  # l_total
    assert msda_source_on_cpu(*args) != 0


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', list(MSDA_CASES))
def test_msda_kernel_matches_plain_bit_for_bit(cuda_device, case, dtype):
    """The MSDA forward kernel against ``_msda_fused`` on the card: the
    same bits (it forms the same float32 tap weights with no contracted
    multiply-add, rounds them, sums each corner's points in float32 in point
    order and rounds, and adds the corners to an output in the value dtype
    in the plain order), with locations on the edges, at exact pixel
    centres and outside the map; one launch a call, and the same bits from
    a second call."""
    value, locations, weights, shapes = _msda_kernel_inputs(case, dtype, cuda_device)
    launches = trace.counter(msda_ops.LAUNCHES)
    with torch.no_grad():
        got = msda_ops.msda(value, shapes, locations, weights)
        again = msda_ops.msda(value, shapes, locations, weights)
    assert trace.counter(msda_ops.LAUNCHES) == launches + 2
    want = msda_ops._msda_fused(value, shapes, locations, weights)
    assert got.dtype == dtype and got.shape == want.shape
    differ = int((got != want).sum())
    assert differ == 0, f'{differ} of {want.numel()} outputs differ'
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_msda_kernel_launches_six_times_a_swin_l_pixel_decoder_forward(cuda_device):
    """The Swin-L pixel decoder at 800² (bf16, batch 1): six kernel launches
    in a no-grad forward (one an encoder layer), none in a forward under
    autograd (the plain ``_MSDA`` route)."""
    config = Mask2FormerConfig.swin('large', num_labels=5)
    decoder = PixelDecoder(config, config.backbone_config.channels).to(cuda_device,
                                                                      torch.bfloat16)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    features = [torch.randn((1, 800 // s, 800 // s, c), generator=g, device=cuda_device,
                            dtype=torch.bfloat16)
                for s, c in zip((4, 8, 16, 32), config.backbone_config.channels)]
    launches = trace.counter(msda_ops.LAUNCHES)
    with torch.no_grad():
        decoder.eval()(features)
    assert trace.counter(msda_ops.LAUNCHES) - launches == config.encoder_layers == 6
    launches = trace.counter(msda_ops.LAUNCHES)
    decoder.train()(features)[0].float().sum().backward()
    assert trace.counter(msda_ops.LAUNCHES) == launches


@pytest.mark.cuda
def test_msda_kernel_raises_on_what_it_does_not_take(cuda_device):
    """A CUDA tensor takes the kernel or raises: head dim 8 and a float16
    value raise, with no launch."""
    value, locations, weights, shapes = _msda_kernel_inputs('tiny-d16', torch.bfloat16,
                                                            cuda_device)
    launches = trace.counter(msda_ops.LAUNCHES)
    with torch.no_grad():
        with pytest.raises(ValueError, match='head_dim'):
            msda_ops.msda(value[..., :8].contiguous(), shapes, locations, weights)
        with pytest.raises(TypeError, match='float32 or bfloat16'):
            msda_ops.msda(value.half(), shapes, locations, weights)
    assert trace.counter(msda_ops.LAUNCHES) == launches
