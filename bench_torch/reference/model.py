"""Plain PyTorch Mask2Former: the benchmark's reference forward.

An independent float32 implementation of what the cells run: the serving
pre-process (PIL-style antialiased bilinear resize, ImageNet normalisation),
the Swin or ResNet backbone, the multi-scale deformable-attention pixel
decoder, the masked-attention transformer decoder and the class head, after
HF ``modeling_mask2former.py`` and ``modeling_swin.py``. It imports nothing
of the program: windows are softmaxed with their relative-position bias and
shift mask, the deformable sampling is ``F.grid_sample`` per level (HF's
``multi_scale_deformable_attention``), masked attention is a softmax with
the blocked scores at ``-inf``.

Parameter names are the program's state-dict keys, so one seeded state dict
(``bench_torch/weights.py``) loads into both.

``Numerics`` sets the arithmetic: float32 (the reference), or the control
one precision step below the configuration's bfloat16: the forward under
bfloat16 autocast, as the program computes, with every product computed
in float8: each operand and each result of each matmul and convolution
rounded to e4m3 (activations stored in float8), and the gradient of each
result to e5m2 (a float8 training recipe's backward), with per-tensor
scales.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FP8_MAX = 448.0


MARGINS = (0.05, 0.1, 0.2, 0.3, 0.5, 0.75, 1.0, 1.5, 2.0)  # |logit| edges of a decision's tally


def tally(margins: torch.Tensor, edges=MARGINS) -> list:
    """How many of ``margins`` fall below each edge, between each pair and
    above the last (len(edges) + 1 counts)."""
    at = torch.bucketize(margins.flatten().float(), torch.tensor(edges, device=margins.device))
    return torch.bincount(at, minlength=len(edges) + 1).tolist()


class float32_products:
    """TF32 off for matmuls and convolutions on the card, restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def _fp8(t: torch.Tensor, dtype: torch.dtype, largest: float) -> torch.Tensor:
    """``t`` rounded to ``dtype`` with one scale for the tensor, back in
    ``t``'s dtype."""
    scale = t.abs().amax().float().clamp(min=1e-30) / largest
    return ((t.float() / scale).to(dtype).float() * scale).to(t.dtype)


class _Forward8(torch.autograd.Function):
    """e4m3 in the forward; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return g


class _Output8(torch.autograd.Function):
    """A product's result stored in e4m3; its gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


class Numerics:
    """The arithmetic of products: ``'float32'``, or ``'fp8'``: each
    operand and each result of a matmul or convolution in e4m3, and the
    gradient of each result in e5m2, with per-tensor scales."""

    def __init__(self, mode: str = 'float32'):
        if mode not in ('float32', 'fp8'):
            raise ValueError(f'numerics {mode!r}')
        self.mode = mode

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.mode == 'float32' else _Forward8.apply(t)

    def out(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.mode == 'float32' else _Output8.apply(t)

    def linear(self, x, layer: nn.Linear):
        return self.out(F.linear(self.q(x), self.q(layer.weight), layer.bias))

    def conv(self, x, layer: nn.Conv2d):
        return self.out(F.conv2d(self.q(x), self.q(layer.weight), layer.bias, layer.stride,
                                 layer.padding))

    def matmul(self, a, b):
        return self.out(torch.matmul(self.q(a), self.q(b)))


# ---------------------------------------------------------------- pre-process

def pil_triangle_weights(in_size: int, out_size: int) -> torch.Tensor:
    """(out, in) weights of Pillow's BILINEAR resize (a triangle filter
    widened by the downscale factor, each row normalised)."""
    scale = in_size / out_size
    support = max(scale, 1.0)
    w = torch.zeros((out_size, in_size), dtype=torch.float64)
    for o in range(out_size):
        center = (o + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        taps = torch.arange(lo, hi, dtype=torch.float64)
        k = (1.0 - ((taps + 0.5 - center) / support).abs()).clamp(min=0.0)
        if k.sum() > 0:
            w[o, lo:hi] = k / k.sum()
    return w.float()


def preprocess(images: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    """uint8 (B, H, W, 3) → normalised float32 (B, 3, OH, OW): Pillow's
    bilinear resize (horizontal pass, then vertical), rounded half to even,
    then ``(x / 255 - mean) / std``."""
    _, h, w, _ = images.shape
    dev = images.device
    wx = pil_triangle_weights(w, out_hw[1]).to(dev)
    wy = pil_triangle_weights(h, out_hw[0]).to(dev)
    x = images.float().permute(0, 3, 1, 2)  # (B, 3, H, W)
    x = torch.matmul(x, wx.T)
    x = torch.matmul(wy, x)
    x = torch.round(x).clamp(0.0, 255.0)
    mean = torch.tensor(IMAGENET_MEAN, device=dev)[:, None, None] * 255.0
    std = torch.tensor(IMAGENET_STD, device=dev)[:, None, None] * 255.0
    return (x - mean) / std


# ------------------------------------------------------------------ position

def sine_embedding(h: int, w: int, feats: int, device) -> torch.Tensor:
    """DETR's normalised sine embedding with no padding mask: (H·W, 2·feats),
    channels [y | x], sin and cos interleaved."""
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None].expand(h, w)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :].expand(h, w)
    y = y / (h + 1e-6) * 2 * math.pi
    x = x / (w + 1e-6) * 2 * math.pi
    i = torch.arange(feats, dtype=torch.float32, device=device)
    dim_t = 10000.0 ** (2 * torch.div(i, 2, rounding_mode='floor') / feats)

    def interleave(t):
        t = t[..., None] / dim_t
        return torch.stack((t[..., 0::2].sin(), t[..., 1::2].cos()), dim=-1).flatten(-2)

    return torch.cat((interleave(y), interleave(x)), dim=-1).reshape(h * w, 2 * feats)


# -------------------------------------------------------------------- Swin

def _rel_index(ws: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing='ij'))
    flat = coords.flatten(1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0) + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


def _shift_mask(hp: int, wp: int, ws: int, shift: int) -> torch.Tensor:
    region = torch.zeros((hp, wp))
    cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    n = 0
    for hs in cuts:
        for wsl in cuts:
            region[hs, wsl] = n
            n += 1
    win = region.reshape(hp // ws, ws, wp // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
    return torch.where(win[:, None, :] != win[:, :, None], -100.0, 0.0)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int):
        super().__init__()
        self.heads, self.ws = heads, ws
        self.query, self.key, self.value = (nn.Linear(dim, dim) for _ in range(3))
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * ws - 1) ** 2, heads))
        self.output_dense = nn.Linear(dim, dim)

    def forward(self, x, mask, num: Numerics):
        n, t, c = x.shape
        hd = c // self.heads

        def split(layer):
            return num.linear(x, layer).reshape(n, t, self.heads, hd).transpose(1, 2)

        q, k, v = split(self.query), split(self.key), split(self.value)
        scores = num.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        idx = _rel_index(self.ws).to(x.device)
        scores = scores + self.relative_position_bias_table[idx].permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            scores = (scores.reshape(-1, nw, self.heads, t, t) + mask[None, :, None]).reshape(
                n, self.heads, t, t)
        out = num.matmul(torch.softmax(scores, dim=-1), v)
        return num.linear(out.transpose(1, 2).reshape(n, t, c), self.output_dense)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int, shift: int, rate: float, eps: float,
                 mlp_ratio: float):
        super().__init__()
        self.ws, self.shift, self.rate = ws, shift, rate
        self.layernorm_before = nn.LayerNorm(dim, eps=eps)
        self.attention = WindowAttention(dim, heads, ws)
        self.layernorm_after = nn.LayerNorm(dim, eps=eps)
        self.intermediate_dense = nn.Linear(dim, int(mlp_ratio * dim))
        self.output_dense = nn.Linear(int(mlp_ratio * dim), dim)

    def forward(self, x, num: Numerics, drop):
        b, h, w, c = x.shape
        ws, shift = self.ws, self.shift
        y = self.layernorm_before(x)
        pb, pr = (ws - h % ws) % ws, (ws - w % ws) % ws
        y = F.pad(y, (0, 0, 0, pr, 0, pb))
        hp, wp = h + pb, w + pr
        mask = None
        if shift:
            y = torch.roll(y, (-shift, -shift), (1, 2))
            mask = _shift_mask(hp, wp, ws, shift).to(x.device)
        win = y.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        out = self.attention(win.reshape(-1, ws * ws, c), mask, num)
        y = out.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        y = y.reshape(b, hp, wp, c)
        if shift:
            y = torch.roll(y, (shift, shift), (1, 2))
        y = y[:, :h, :w]
        if drop is not None:
            y = y * drop[0][:, None, None, None]
        x = x + y
        y = num.linear(F.gelu(num.linear(self.layernorm_after(x), self.intermediate_dense)),
                       self.output_dense)
        if drop is not None:
            y = y * drop[1][:, None, None, None]
        return x + y


class PatchMerging(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=eps)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, num: Numerics):
        h, w = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return num.linear(self.norm(x), self.reduction)


class Swin(nn.Module):
    """Swin backbone: the four stage maps (NHWC), each layer-normed before
    its patch merging. Stochastic depth takes its keep draws from the
    caller's generator, one (2, B) uniform draw per block whose rate is
    above zero, in block order."""

    def __init__(self, bb: dict):
        super().__init__()
        self.bb = bb
        dim, eps, ws = bb['embed_dim'], bb['layer_norm_eps'], bb['window_size']
        self.patch_embed = nn.Conv2d(3, dim, bb['patch_size'], stride=bb['patch_size'])
        self.embed_norm = nn.LayerNorm(dim, eps=eps)
        rates = np.linspace(0, bb['drop_path_rate'], sum(bb['depths']))
        k = 0
        for s, depth in enumerate(bb['depths']):
            d = dim * 2 ** s
            for i in range(depth):
                self.add_module(f'stage{s}_block{i}', SwinBlock(
                    d, bb['num_heads'][s], ws, 0 if i % 2 == 0 else ws // 2, float(rates[k]),
                    eps, bb['mlp_ratio']))
                k += 1
            self.add_module(f'stage{s + 1}_norm', nn.LayerNorm(d, eps=1e-5))
            if s < len(bb['depths']) - 1:
                self.add_module(f'downsample{s}', PatchMerging(d, eps))

    def forward(self, pixels, num: Numerics, generator=None):
        ps = self.bb['patch_size']
        h, w = pixels.shape[-2:]
        pixels = F.pad(pixels, (0, (ps - w % ps) % ps, 0, (ps - h % ps) % ps))
        x = self.embed_norm(num.conv(pixels, self.patch_embed).permute(0, 2, 3, 1))
        feats = []
        for s, depth in enumerate(self.bb['depths']):
            for i in range(depth):
                block = getattr(self, f'stage{s}_block{i}')
                drop = None
                if generator is not None and block.rate > 0:
                    keep = 1.0 - block.rate
                    draw = torch.rand((2, x.shape[0]), generator=generator,
                                      device=generator.device).to(x.device)
                    drop = (draw < keep).float() / keep
                x = block(x, num, drop)
            feats.append(getattr(self, f'stage{s + 1}_norm')(x))
            if s < len(self.bb['depths']) - 1:
                x = getattr(self, f'downsample{s}')(x, num)
        return feats


# ------------------------------------------------------------------ ResNet

class FrozenBN(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.scale, self.bias = nn.Parameter(torch.ones(n)), nn.Parameter(torch.zeros(n))
        self.mean, self.var = nn.Parameter(torch.zeros(n)), nn.Parameter(torch.ones(n))

    def forward(self, x):
        return ((x - self.mean[:, None, None]) / torch.sqrt(self.var[:, None, None] + 1e-5)
                * self.scale[:, None, None] + self.bias[:, None, None])


def _conv(cin, cout, k, stride=1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    def __init__(self, cin, mid, stride, down):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, mid, 1), FrozenBN(mid)
        self.conv2, self.bn2 = _conv(mid, mid, 3, stride), FrozenBN(mid)
        self.conv3, self.bn3 = _conv(mid, 4 * mid, 1), FrozenBN(4 * mid)
        if down:
            self.downsample_conv, self.downsample_bn = _conv(cin, 4 * mid, 1, stride), FrozenBN(
                4 * mid)

    def forward(self, x, num: Numerics):
        y = F.relu(self.bn1(num.conv(x, self.conv1)))
        y = F.relu(self.bn2(num.conv(y, self.conv2)))
        y = self.bn3(num.conv(y, self.conv3))
        if hasattr(self, 'downsample_conv'):
            x = self.downsample_bn(num.conv(x, self.downsample_conv))
        return F.relu(x + y)


class ResNet(nn.Module):
    """torchvision's bottleneck ResNet (stride on the 3×3) with frozen batch
    norm: the four stage maps (NHWC)."""

    def __init__(self, bb: dict):
        super().__init__()
        self.depths = bb['depths']
        width = bb['embed_dim']
        self.stem_conv, self.stem_bn = _conv(3, width, 7, 2), FrozenBN(width)
        cin = width
        for s, depth in enumerate(self.depths):
            mid = width * 2 ** s
            for i in range(depth):
                self.add_module(f'stage{s}_block{i}',
                                Bottleneck(cin, mid, 2 if i == 0 and s > 0 else 1, i == 0))
                cin = 4 * mid

    def forward(self, pixels, num: Numerics, generator=None):
        x = F.max_pool2d(F.relu(self.stem_bn(num.conv(pixels, self.stem_conv))), 3, 2, 1)
        feats = []
        for s, depth in enumerate(self.depths):
            for i in range(depth):
                x = getattr(self, f'stage{s}_block{i}')(x, num)
            feats.append(x.permute(0, 2, 3, 1))
        return feats


# ------------------------------------------------------------ pixel decoder

def deformable_sample(value, shapes, locations, weights):
    """HF ``multi_scale_deformable_attention``: value (B, L, heads, D),
    locations (B, Q, heads, levels, points, 2) in [0, 1], weights (B, Q,
    heads, levels, points) → (B, Q, heads·D)."""
    b, _, heads, d = value.shape
    _, q, _, levels, points, _ = locations.shape
    grids = 2 * locations - 1
    sampled = []
    for level, part in enumerate(value.split([h * w for h, w in shapes], dim=1)):
        h, w = shapes[level]
        v = part.flatten(2).transpose(1, 2).reshape(b * heads, d, h, w)
        g = grids[:, :, :, level].transpose(1, 2).flatten(0, 1)  # (B·heads, Q, P, 2)
        sampled.append(F.grid_sample(v, g, mode='bilinear', padding_mode='zeros',
                                     align_corners=False))
    wts = weights.transpose(1, 2).reshape(b * heads, 1, q, levels * points)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * wts).sum(-1)
    return out.view(b, heads * d, q).transpose(1, 2)


class DeformAttn(nn.Module):
    def __init__(self, dim, heads, levels, points):
        super().__init__()
        self.heads, self.levels, self.points = heads, levels, points
        self.value_proj = nn.Linear(dim, dim)
        self.sampling_offsets = nn.Linear(dim, heads * levels * points * 2)
        self.attention_weights = nn.Linear(dim, heads * levels * points)
        self.output_proj = nn.Linear(dim, dim)

    def forward(self, hidden, pos, ref, shapes, num: Numerics):
        b, n, c = hidden.shape
        hs, ls, ps = self.heads, self.levels, self.points
        query = hidden + pos
        value = num.linear(hidden, self.value_proj).view(b, n, hs, c // hs)
        offsets = num.linear(query, self.sampling_offsets).view(b, n, hs, ls, ps, 2)
        attn = torch.softmax(num.linear(query, self.attention_weights).view(b, n, hs, ls * ps),
                             -1).view(b, n, hs, ls, ps)
        norm = torch.tensor([[w, h] for h, w in shapes], dtype=hidden.dtype,
                            device=hidden.device)
        loc = ref[None, :, None, None, None, :] + offsets / norm[None, None, None, :, None, :]
        return num.linear(deformable_sample(value, shapes, loc, attn), self.output_proj)


class EncoderLayer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        dim = cfg['feature_size']
        self.self_attn = DeformAttn(dim, cfg['num_attention_heads'], cfg['num_feature_levels'],
                                    cfg['encoder_n_points'])
        self.self_attn_layer_norm = nn.LayerNorm(dim)
        self.fc1 = nn.Linear(dim, cfg['encoder_feedforward_dim'])
        self.fc2 = nn.Linear(cfg['encoder_feedforward_dim'], dim)
        self.final_layer_norm = nn.LayerNorm(dim)

    def forward(self, x, pos, ref, shapes, num: Numerics):
        x = self.self_attn_layer_norm(x + self.self_attn(x, pos, ref, shapes, num))
        y = num.linear(F.relu(num.linear(x, self.fc1)), self.fc2)
        return self.final_layer_norm(x + y)


def _reference_points(shapes, device):
    pts = []
    for h, w in shapes:
        ys, xs = torch.meshgrid(torch.linspace(0.5, h - 0.5, h, device=device),
                                torch.linspace(0.5, w - 0.5, w, device=device), indexing='ij')
        pts.append(torch.stack((xs.reshape(-1) / w, ys.reshape(-1) / h), -1))
    return torch.cat(pts)


class PixelDecoder(nn.Module):
    def __init__(self, cfg, channels):
        super().__init__()
        self.cfg = cfg
        dim, nl = cfg['feature_size'], cfg['num_feature_levels']
        for level, ch in enumerate(channels[::-1][:nl]):
            self.add_module(f'input_proj_{level}_conv', nn.Conv2d(ch, dim, 1))
            self.add_module(f'input_proj_{level}_norm', nn.GroupNorm(32, dim))
        self.level_embed = nn.Parameter(torch.zeros(nl, dim))
        for i in range(cfg['encoder_layers']):
            self.add_module(f'encoder_layer_{i}', EncoderLayer(cfg))
        stride = min(cfg['feature_strides'][-nl:])
        self.fpn = int(math.log2(stride) - math.log2(cfg['common_stride']))
        for idx, ch in enumerate(channels[:self.fpn][::-1]):
            self.add_module(f'fpn_lateral_{idx}_conv', nn.Conv2d(ch, dim, 1, bias=False))
            self.add_module(f'fpn_lateral_{idx}_norm', nn.GroupNorm(32, dim))
            self.add_module(f'fpn_output_{idx}_conv', nn.Conv2d(dim, dim, 3, padding=1,
                                                                bias=False))
            self.add_module(f'fpn_output_{idx}_norm', nn.GroupNorm(32, dim))
        self.mask_projection = nn.Conv2d(dim, cfg['mask_feature_size'], 1)

    def forward(self, feats, num: Numerics):
        dim, nl = self.cfg['feature_size'], self.cfg['num_feature_levels']
        b = feats[0].shape[0]
        flat, pos, shapes = [], [], []
        for level, f in enumerate(feats[::-1][:nl]):
            x = getattr(self, f'input_proj_{level}_norm')(
                num.conv(f.permute(0, 3, 1, 2), getattr(self, f'input_proj_{level}_conv')))
            h, w = x.shape[-2:]
            shapes.append((h, w))
            flat.append(x.flatten(2).transpose(1, 2))
            pos.append(sine_embedding(h, w, dim // 2, x.device) + self.level_embed[level])
        x, pos = torch.cat(flat, 1), torch.cat(pos)[None]
        ref = _reference_points(shapes, x.device)
        for i in range(self.cfg['encoder_layers']):
            x = getattr(self, f'encoder_layer_{i}')(x, pos, ref, shapes, num)
        outs, start = [], 0
        for h, w in shapes:
            outs.append(x[:, start:start + h * w].transpose(1, 2).reshape(b, dim, h, w))
            start += h * w
        for idx, f in enumerate(feats[:self.fpn][::-1]):
            lat = getattr(self, f'fpn_lateral_{idx}_norm')(
                num.conv(f.permute(0, 3, 1, 2), getattr(self, f'fpn_lateral_{idx}_conv')))
            up = F.interpolate(outs[-1], size=lat.shape[-2:], mode='bilinear',
                               align_corners=False)
            y = num.conv(lat + up, getattr(self, f'fpn_output_{idx}_conv'))
            outs.append(F.relu(getattr(self, f'fpn_output_{idx}_norm')(y)))
        return num.conv(outs[-1], self.mask_projection), outs[:nl]  # NCHW


# ------------------------------------------------------------- transformer

class Attention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(dim, dim)
                                                                for _ in range(4))

    def forward(self, query, key, value, num: Numerics, blocked=None):
        b, t, c = query.shape
        s, hd = key.shape[1], c // self.heads
        q = num.linear(query, self.q_proj).view(b, t, self.heads, hd).transpose(1, 2)
        k = num.linear(key, self.k_proj).view(b, s, self.heads, hd).transpose(1, 2)
        v = num.linear(value, self.v_proj).view(b, s, self.heads, hd).transpose(1, 2)
        scores = num.matmul(q * hd ** -0.5, k.transpose(-1, -2))
        if blocked is not None:
            scores = scores.masked_fill(blocked, float('-inf'))
        out = num.matmul(torch.softmax(scores, -1), v)
        return num.linear(out.transpose(1, 2).reshape(b, t, c), self.out_proj)


class DecoderLayer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        dim = cfg['hidden_dim']
        self.cross_attn = Attention(dim, cfg['num_attention_heads'])
        self.cross_attn_layer_norm = nn.LayerNorm(dim)
        self.self_attn = Attention(dim, cfg['num_attention_heads'])
        self.self_attn_layer_norm = nn.LayerNorm(dim)
        self.fc1 = nn.Linear(dim, cfg['dim_feedforward'])
        self.fc2 = nn.Linear(cfg['dim_feedforward'], dim)
        self.final_layer_norm = nn.LayerNorm(dim)

    def forward(self, x, keys, key_pos, query_pos, blocked, num: Numerics):
        x = self.cross_attn_layer_norm(
            x + self.cross_attn(x + query_pos, keys + key_pos, keys, num, blocked))
        x = self.self_attn_layer_norm(x + self.self_attn(x + query_pos, x + query_pos, x, num))
        return self.final_layer_norm(x + num.linear(F.relu(num.linear(x, self.fc1)), self.fc2))


class MaskPredictor(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        dims = [cfg['hidden_dim']] * 3 + [cfg['mask_feature_size']]
        for i in range(3):
            self.add_module(f'mask_embedder_{i}', nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x, pixel_embed, size, num: Numerics):
        x = F.relu(num.linear(x, self.mask_embedder_0))
        x = F.relu(num.linear(x, self.mask_embedder_1))
        x = num.linear(x, self.mask_embedder_2)
        b, c, h, w = pixel_embed.shape
        logits = num.matmul(x, pixel_embed.flatten(2)).view(b, -1, h, w)
        small = F.interpolate(logits, size=size, mode='bilinear', align_corners=False).flatten(2)
        blocked = small.sigmoid() < 0.5
        blocked = blocked & ~blocked.all(-1, keepdim=True)
        return logits, blocked[:, None], small


class TransformerModule(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        dim, nl = cfg['hidden_dim'], cfg['num_feature_levels']
        self.level_embed = nn.Parameter(torch.zeros(nl, dim))
        self.queries_embedder = nn.Parameter(torch.zeros(cfg['num_queries'], dim))
        self.queries_features = nn.Parameter(torch.zeros(cfg['num_queries'], dim))
        self.layernorm = nn.LayerNorm(dim)
        self.mask_predictor = MaskPredictor(cfg)
        for i in range(cfg['decoder_layers'] - 1):
            self.add_module(f'layer_{i}', DecoderLayer(cfg))

    def forward(self, multi_scale, mask_features, num: Numerics, probe: dict | None = None):
        """``probe``, where given, holds the attention masks each layer used
        (``masks``); with ``forced`` in it, each layer attends under the
        forced mask instead of its own, and reads how far the forced
        decisions lie from its own: ``mask_flips`` of ``mask_decisions``
        differ, and ``mask_tally`` counts them by the reference's margin
        on the decision (``tally``): |logit| of the entry, or, in a row
        that the all-blocked escape opened on one side only, |largest
        logit| of the row, whose sign decides the escape; a forced row
        blocked everywhere, which the escape forbids, counts above every
        edge. ``mask_gap`` is the largest |logit| of a differing entry in
        rows open everywhere on neither side. Forced masks of another shape
        cannot be followed and read ``mask_gap`` inf."""
        cfg = self.cfg
        nl, dim = cfg['num_feature_levels'], cfg['hidden_dim']
        b = mask_features.shape[0]
        keys, key_pos, sizes = [], [], []
        for i, f in enumerate(multi_scale):
            h, w = f.shape[-2:]
            sizes.append((h, w))
            keys.append(f.flatten(2).transpose(1, 2) + self.level_embed[i])
            key_pos.append(sine_embedding(h, w, dim // 2, f.device)[None])
        query_pos = self.queries_embedder[None].expand(b, -1, -1)
        x = self.queries_features[None].expand(b, -1, -1)
        inter = self.layernorm(x)
        logits, blocked, small = self.mask_predictor(inter, mask_features, sizes[0], num)
        states, masks = [inter], [logits]
        forced = (probe or {}).get('forced')
        used, gap, flips, decisions = [], 0.0, 0, 0
        counts = [0] * (len(MARGINS) + 1)
        if forced is not None and len(forced) != cfg['decoder_layers'] - 1:
            forced, gap = None, float('inf')  # decisions of another model
        for i in range(cfg['decoder_layers'] - 1):
            if forced is not None and tuple(forced[i].shape) != tuple(blocked.shape):
                forced, gap = None, float('inf')  # decisions of another batch
            if forced is not None:
                mask = forced[i].to(blocked.device)
                logit = small.detach()[:, None].float()
                differ = mask != blocked
                one_side = (~mask).all(-1, keepdim=True) ^ (~blocked).all(-1, keepdim=True)
                margin = torch.where(one_side, logit.amax(-1, keepdim=True).abs(), logit.abs())
                margin = torch.where(mask.all(-1, keepdim=True), float('inf'), margin)
                counts = [a + c for a, c in zip(counts, tally(margin[differ]))]
                flips += int(differ.sum())
                decisions += differ.numel()
                # rows open everywhere on either side may be the escape's
                differ &= ~((~mask).all(-1, keepdim=True) | (~blocked).all(-1, keepdim=True))
                if bool(differ.any()):
                    gap = max(gap, float(logit.abs()[differ].amax()))
                blocked = mask
            used.append(blocked)
            level = i % nl
            x = getattr(self, f'layer_{i}')(x, keys[level], key_pos[level], query_pos, blocked,
                                            num)
            inter = self.layernorm(x)
            logits, blocked, small = self.mask_predictor(inter, mask_features,
                                                         sizes[(i + 1) % nl], num)
            states.append(inter)
            masks.append(logits)
        if probe is not None:
            probe.update(masks=used, mask_gap=gap, mask_flips=flips, mask_decisions=decisions,
                         mask_tally=counts)
        return states, masks


class Mask2Former(nn.Module):
    """``forward(pixels (B, 3, H, W), numerics, generator, probe)`` → (class
    logits per decoder output, mask logits per decoder output), the final
    output last; ``probe`` as ``TransformerModule.forward`` takes it."""

    def __init__(self, cfg: dict):
        super().__init__()
        bb = cfg['backbone_config']
        if bb['model_type'] == 'swin':
            self.backbone = Swin(bb)
            channels = tuple(bb['embed_dim'] * 2 ** s for s in range(len(bb['depths'])))
        elif bb['model_type'] == 'resnet':
            self.backbone = ResNet(bb)
            channels = tuple(bb['embed_dim'] * 4 * 2 ** s for s in range(len(bb['depths'])))
        else:
            raise ValueError(f'backbone {bb["model_type"]!r}')
        self.pixel_decoder = PixelDecoder(cfg, channels)
        self.transformer_module = TransformerModule(cfg)
        self.class_predictor = nn.Linear(cfg['hidden_dim'], cfg['num_labels'] + 1)

    def forward(self, pixels, num: Numerics | None = None, generator=None,
                probe: dict | None = None):
        num = num or Numerics()
        with torch.autocast(pixels.device.type, dtype=torch.bfloat16,
                            enabled=num.mode == 'fp8'):
            feats = self.backbone(pixels, num, generator)
            mask_features, multi_scale = self.pixel_decoder(feats, num)
            states, masks = self.transformer_module(multi_scale, mask_features, num, probe)
            classes = [num.linear(s, self.class_predictor) for s in states]
        return [c.float() for c in classes], [m.float() for m in masks]
