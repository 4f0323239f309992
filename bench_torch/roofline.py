"""Work counts and the H100's published peaks.

Every count comes from shapes alone, whatever implements the operation:
each input byte read once and each output byte written once, and the
multiply-adds the mathematics needs. ``bound`` and the peaks are copied
from ``chip_smoke.py``; the attention and post-process counts follow its
``_window_bounds`` and ``postprocess_bytes``.
"""

from __future__ import annotations

import math

# H100 SXM published peaks (dense): HBM bytes/s and FLOP/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {'bfloat16': 989e12, 'float16': 989e12, 'tf32': 495e12, 'float32': 67e12}
SCORE_HW = (384, 384)  # the post-process scores at this size (HF's hard-coded 384²)
BYTES = {'bfloat16': 2, 'float16': 2, 'float32': 4, 'bool': 1, 'int8': 1}


def bound_s(bytes_moved: float, flops: float, dtype: str) -> float:
    """The least time the card could take: bytes over the HBM rate or
    operations over the peak for the input type, whichever is larger."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


# ---------------------------------------------------------------- kernels

def window_attention(nw: int, heads: int, t: int, d: int, dtype: str, masked: bool,
                     mask_windows: int = 0, backward: bool = False) -> tuple[float, float]:
    """(bytes, FLOPs) of windowed attention over q/k/v (NW, H, T, D) with an
    (H, T, T) float32 bias, and (nW_img, T, T) float32 shift mask if
    ``masked``. Forward: q, k, v read, out and the float32 row log-sum-exp
    written; QKᵀ and PV. Backward: q, k, v, out, dout read, dq, dk, dv and
    the float32 bias gradient written; QKᵀ again, dV, dP, dQ, dK."""
    qkv = nw * heads * t * d * BYTES[dtype]
    const = (heads + (mask_windows if masked else 0)) * t * t * 4
    lse = nw * heads * t * 4
    pair = nw * heads * t * t * d
    if backward:
        return 8 * qkv + const + lse + heads * t * t * 4, 10 * pair
    return 4 * qkv + const + lse, 4 * pair


def masked_attention(b: int, heads: int, nq: int, s: int, d: int, dtype: str,
                     backward: bool = False) -> tuple[float, float]:
    """(bytes, FLOPs) of attention of q (B, H, Q, D) over k/v (B, H, S, D)
    with a boolean (B, 1, Q, S) mask. Forward: q, k, v, mask read, out and
    the float32 log-sum-exp written. Backward: q, out, dout, k, v, mask, lse
    read, dq, dk, dv written."""
    q_bytes, kv_bytes = b * heads * nq * d * BYTES[dtype], b * heads * s * d * BYTES[dtype]
    mask, lse = b * nq * s, b * heads * nq * 4
    pair = b * heads * nq * s * d
    if backward:
        return 4 * q_bytes + 4 * kv_bytes + mask + lse, 10 * pair
    return 2 * q_bytes + 2 * kv_bytes + mask + lse, 4 * pair


def postprocess(b: int, q: int, hm: int, wm: int,
                score_hw: tuple = SCORE_HW) -> tuple[float, float]:
    """(bytes, FLOPs) of the fused post-process: float32 logits (B, Q, Hm,
    Wm) read once; int8 bins at the score size and two float32 sums a map
    written once; per score pixel a 2-tap bilinear in each axis, a sigmoid
    and two sums (12 float32 operations, as chip_smoke.py counts them)."""
    out_px = b * q * score_hw[0] * score_hw[1]
    return b * q * hm * wm * 4 + out_px + 2 * b * q * 4, 12 * out_px


def msda(b: int, q: int, heads: int, levels: int, points: int, d: int, value_rows: int,
         dtype: str, coord_dtype: str, backward: bool = False) -> tuple[float, float]:
    """(bytes, FLOPs) of multi-scale deformable attention: the value table
    (B, L, heads, D) read once, the locations (…, 2) and weights read once,
    the output (B, Q, heads·D) written once; per sample, four bilinear taps
    of D multiply-adds. Backward: the same tensors' gradients, and the
    output's gradient read; twice the forward's operations."""
    samples = b * q * heads * levels * points
    value = b * value_rows * heads * d * BYTES[dtype]
    coords = samples * 3 * BYTES[coord_dtype]  # two coordinates and a weight
    out = b * q * heads * d * BYTES[dtype]
    flops = samples * 4 * d * 2
    if backward:
        return 2 * (value + coords + out), 2 * flops
    return value + coords + out, flops


# ---------------------------------------------------------- the whole model

def _linear(tokens: int, cin: int, cout: int) -> float:
    return 2.0 * tokens * cin * cout


def swin_flops(bb: dict, h: int, w: int) -> float:
    """Forward FLOPs of one image through the Swin backbone: the patch
    embedding, every block's projections, window products (on the
    window-padded map, as the model pads it) and MLP, the patch mergings."""
    ps, ws, c = bb['patch_size'], bb['window_size'], bb['embed_dim']
    h, w = math.ceil(h / ps), math.ceil(w / ps)
    total = _linear(h * w, 3 * ps * ps, c)
    for s, depth in enumerate(bb['depths']):
        hp, wp = math.ceil(h / ws) * ws, math.ceil(w / ws) * ws
        padded, real = hp * wp, h * w
        hidden = int(bb['mlp_ratio'] * c)
        block = (4 * _linear(padded, c, c)  # q, k, v, output
                 + 2 * 2.0 * padded * ws * ws * c  # QKᵀ and PV
                 + _linear(real, c, hidden) + _linear(real, hidden, c))
        total += depth * block
        if s < len(bb['depths']) - 1:
            h, w = math.ceil(h / 2), math.ceil(w / 2)
            total += _linear(h * w, 4 * c, 2 * c)
            c *= 2
    return total


def resnet_flops(bb: dict, h: int, w: int) -> float:
    """Forward FLOPs of one image through the bottleneck ResNet's
    convolutions (stride on the 3×3)."""
    width = bb['embed_dim']
    h, w = math.ceil(h / 2), math.ceil(w / 2)
    total = 2.0 * h * w * 3 * 49 * width
    h, w = math.ceil(h / 2), math.ceil(w / 2)
    cin = width
    for s, depth in enumerate(bb['depths']):
        mid = width * 2 ** s
        for i in range(depth):
            stride = 2 if i == 0 and s > 0 else 1
            ho, wo = math.ceil(h / stride), math.ceil(w / stride)
            total += _linear(h * w, cin, mid) + _linear(ho * wo, 9 * mid, mid)
            total += _linear(ho * wo, mid, 4 * mid)
            if i == 0:
                total += _linear(ho * wo, cin, 4 * mid)
            h, w, cin = ho, wo, 4 * mid
    return total


def feature_shapes(cfg: dict, h: int, w: int) -> list:
    """The (H, W) of the four backbone maps at strides 4, 8, 16, 32."""
    bb = cfg['backbone_config']
    if bb['model_type'] == 'swin':
        hs, wsz = math.ceil(h / bb['patch_size']), math.ceil(w / bb['patch_size'])
        out = [(hs, wsz)]
        for _ in range(3):
            hs, wsz = math.ceil(hs / 2), math.ceil(wsz / 2)
            out.append((hs, wsz))
        return out
    out, hs, wsz = [], math.ceil(math.ceil(h / 2) / 2), math.ceil(math.ceil(w / 2) / 2)
    for s in range(4):
        if s:
            hs, wsz = math.ceil(hs / 2), math.ceil(wsz / 2)
        out.append((hs, wsz))
    return out


def backbone_channels(cfg: dict) -> list:
    bb = cfg['backbone_config']
    if bb['model_type'] == 'swin':
        return [bb['embed_dim'] * 2 ** s for s in range(4)]
    return [bb['embed_dim'] * 4 * 2 ** s for s in range(4)]


def head_flops(cfg: dict, h: int, w: int) -> float:
    """Forward FLOPs of one image through the pixel decoder (input
    projections, deformable encoder layers, FPN, mask projection) and the
    masked-attention decoder (every layer's projections, attention products
    and FFN, each mask prediction's MLP and product, the class head)."""
    shapes, chans = feature_shapes(cfg, h, w), backbone_channels(cfg)
    dim, nl = cfg['feature_size'], cfg['num_feature_levels']
    heads, points = cfg['num_attention_heads'], cfg['encoder_n_points']
    levels = list(zip(shapes[::-1][:nl], chans[::-1][:nl]))
    tokens = sum(hh * ww for (hh, ww), _ in levels)
    total = sum(_linear(hh * ww, ch, dim) for (hh, ww), ch in levels)
    layer = (2 * _linear(tokens, dim, dim)  # value and output projections
             + _linear(tokens, dim, heads * nl * points * 3)  # offsets and weights
             + 2.0 * tokens * heads * nl * points * 4 * (dim // heads)  # bilinear taps
             + _linear(tokens, dim, cfg['encoder_feedforward_dim'])
             + _linear(tokens, cfg['encoder_feedforward_dim'], dim))
    total += cfg['encoder_layers'] * layer
    stride = min(cfg['feature_strides'][-nl:])
    fpn = int(math.log2(stride) - math.log2(cfg['common_stride']))
    for (hh, ww), ch in zip(shapes[:fpn][::-1], chans[:fpn][::-1]):
        total += _linear(hh * ww, ch, dim) + _linear(hh * ww, 9 * dim, dim)
    mh, mw = shapes[0]
    total += _linear(mh * mw, dim, cfg['mask_feature_size'])
    hid, nq = cfg['hidden_dim'], cfg['num_queries']
    sizes = [hh * ww for (hh, ww), _ in levels]
    for i in range(cfg['decoder_layers'] - 1):
        s = sizes[i % nl]
        total += (2 * _linear(nq, hid, hid) + 2 * _linear(s, hid, hid)  # cross q, out; k, v
                  + 2 * 2.0 * nq * s * hid  # cross QKᵀ and PV
                  + 4 * _linear(nq, hid, hid) + 2 * 2.0 * nq * nq * hid  # self-attention
                  + _linear(nq, hid, cfg['dim_feedforward'])
                  + _linear(nq, cfg['dim_feedforward'], hid))
    predict = 2 * _linear(nq, hid, hid) + _linear(nq, hid, cfg['mask_feature_size'])
    predict += 2.0 * nq * cfg['mask_feature_size'] * mh * mw + _linear(nq, hid,
                                                                        cfg['num_labels'] + 1)
    return total + cfg['decoder_layers'] * predict


def model_flops(cfg: dict, h: int, w: int) -> float:
    """Forward FLOPs of one image at (h, w) through the whole model."""
    bb = cfg['backbone_config']
    backbone = swin_flops(bb, h, w) if bb['model_type'] == 'swin' else resnet_flops(bb, h, w)
    return backbone + head_flops(cfg, h, w)
