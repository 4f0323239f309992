"""Masked-attention transformer decoder (HF:modeling_mask2former.py:1418-2097).

Port of ``weed_instance_segmentation_tpu/models/transformer_decoder.py``:
- ``decoder_layers − 1`` layers cycling cross-attention over the 3
  pixel-decoder scales (level ``idx % 3``);
- layer order masked cross-attn → self-attn → FFN, post-norm;
- the attention mask comes from the previous layer's mask prediction
  (sigmoid < 0.5 → masked), with the all-masked-row escape;
- the mask predictor is a 3-layer MLP mask embedder + einsum with the pixel
  embeddings, bilinearly resized to the next level's size
  (``ops/attention_mask.py``: one kernel on the card, the plain chain on the
  CPU).

The masked cross-attention goes through ``ops/masked_attention.py``: the CUDA
kernel (port of the Pallas kernel ``tools/ab_masked_attn.py``) on the card,
its plain version (the additive −1e9 bias) on the CPU. The mask predictor
hands it the boolean mask that the bias is made from. Self-attention stays
plain PyTorch. Batch-first (B, Q, C) layout throughout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from weed_instance_segmentation_tpu_torch.models.configuration import Mask2FormerConfig
from weed_instance_segmentation_tpu_torch.models.position_embedding import sine_position_embedding
from weed_instance_segmentation_tpu_torch.ops.attention_mask import attention_mask
from weed_instance_segmentation_tpu_torch.ops.constants import device_constant
from weed_instance_segmentation_tpu_torch.ops.masked_attention import masked_attention


class MultiheadAttention(nn.Module):
    """Multi-head attention with q scaled by head_dim**-0.5 before the score
    matmul; with a mask, the masked-attention kernel (bias −1e9 where the
    mask is True)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query, key, value, mask=None):
        """query: (B, T, C); key/value: (B, S, C); mask: bool (B, 1, T, S),
        True = blocked, shared over heads."""
        b, t, c = query.shape
        s = key.shape[1]
        heads = self.num_heads
        hd = c // heads
        q = (self.q_proj(query) * hd ** -0.5).reshape(b, t, heads, hd).transpose(1, 2)
        k = self.k_proj(key).reshape(b, s, heads, hd).transpose(1, 2)
        v = self.v_proj(value).reshape(b, s, heads, hd).transpose(1, 2)
        if mask is not None:
            out = masked_attention(q.contiguous(), k.contiguous(), v.contiguous(), mask)
        else:
            probs = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), dim=-1)
            out = torch.matmul(probs, v)
        return self.out_proj(out.transpose(1, 2).reshape(b, t, c))


class MaskPredictor(nn.Module):
    """3-layer MLP mask embedder + einsum with pixel embeddings; also emits
    the attention mask for the next layer (HF:2008-2023)."""

    def __init__(self, config: Mask2FormerConfig):
        super().__init__()
        dims = [config.hidden_dim, config.hidden_dim, config.hidden_dim,
                config.mask_feature_size]
        for i in range(3):
            self.add_module(f'mask_embedder_{i}', nn.Linear(dims[i], dims[i + 1]))

    def forward(self, hidden_states, pixel_embeddings, attn_target_hw):
        """hidden_states: (B, Q, C); pixel_embeddings: (B, H, W, Cmask) NHWC.
        Returns (mask_logits (B, Q, H, W), attn_mask bool (B, 1, Q, T),
        True = blocked)."""
        x = F.relu(self.mask_embedder_0(hidden_states))
        x = F.relu(self.mask_embedder_1(x))
        x = self.mask_embedder_2(x)
        mask_logits = torch.einsum('bqc,bhwc->bqhw', x, pixel_embeddings)
        return mask_logits, attention_mask(mask_logits.detach(), attn_target_hw)


class DecoderLayer(nn.Module):
    """Masked cross-attn → self-attn → FFN, post-norm (HF:1555-1651)."""

    def __init__(self, config: Mask2FormerConfig):
        super().__init__()
        dim = config.hidden_dim
        if config.activation_function not in ('relu', 'gelu'):
            raise ValueError(config.activation_function)
        self.activation = config.activation_function
        self.dropout = config.dropout
        self.cross_attn = MultiheadAttention(dim, config.num_attention_heads)
        self.cross_attn_layer_norm = nn.LayerNorm(dim, eps=1e-5)
        self.self_attn = MultiheadAttention(dim, config.num_attention_heads)
        self.self_attn_layer_norm = nn.LayerNorm(dim, eps=1e-5)
        self.fc1 = nn.Linear(dim, config.dim_feedforward)
        self.fc2 = nn.Linear(config.dim_feedforward, dim)
        self.final_layer_norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, hidden_states, key_feats, key_pos, query_pos, attn_mask):
        if self.training and self.dropout:
            raise NotImplementedError(f'dropout {self.dropout} is not ported: the '
                                      'masked-attention kernel has none')
        x = self.cross_attn(hidden_states + query_pos, key_feats + key_pos, key_feats, attn_mask)
        x = self.cross_attn_layer_norm(hidden_states + x)
        y = self.self_attn(x + query_pos, x + query_pos, x)
        x = self.self_attn_layer_norm(x + y)
        y = self.fc1(x)
        y = F.relu(y) if self.activation == 'relu' else F.gelu(y, approximate='none')
        return self.final_layer_norm(x + self.fc2(y))


class TransformerModule(nn.Module):
    """Query embeddings + masked-attention decoder over the pixel-decoder
    scales (HF:2030-2097 + 1769-1930).

    Returns (intermediate_hidden_states tuple, masks_queries_logits tuple).
    """

    def __init__(self, config: Mask2FormerConfig):
        super().__init__()
        self.config = config
        nl, dim = config.num_feature_levels, config.hidden_dim
        self.level_embed = nn.Parameter(torch.zeros(nl, dim))
        if config.enforce_input_projection or config.feature_size != dim:
            for i in range(nl):
                self.add_module(f'input_proj_{i}', nn.Linear(config.feature_size, dim))
        self.queries_embedder = nn.Parameter(torch.zeros(config.num_queries, dim))
        self.queries_features = nn.Parameter(torch.zeros(config.num_queries, dim))
        self.layernorm = nn.LayerNorm(dim, eps=1e-5)
        self.mask_predictor = MaskPredictor(config)
        for idx in range(config.decoder_layers - 1):
            self.add_module(f'layer_{idx}', DecoderLayer(config))

    def forward(self, multi_scale_features, mask_features):
        cfg = self.config
        nl = cfg.num_feature_levels
        b = multi_scale_features[0].shape[0]

        key_feats, key_pos, size_list = [], [], []
        for i in range(nl):
            feat = multi_scale_features[i]  # NHWC
            h, w = feat.shape[1:3]
            size_list.append((h, w))
            key_pos.append(device_constant(sine_position_embedding, (h, w, cfg.hidden_dim // 2),
                                           feat.device, feat.dtype)[None])
            flat = feat.reshape(b, h * w, -1)
            if hasattr(self, f'input_proj_{i}'):
                flat = getattr(self, f'input_proj_{i}')(flat)
            key_feats.append(flat + self.level_embed[i][None, None])

        query_pos = self.queries_embedder[None].expand(b, -1, -1)
        hidden_states = self.queries_features[None].expand(b, -1, -1)

        inter = self.layernorm(hidden_states)
        pred_mask, attn_mask = self.mask_predictor(inter, mask_features, size_list[0])
        intermediate, mask_logits_all = [inter], [pred_mask]

        for idx in range(cfg.decoder_layers - 1):
            level = idx % nl
            hidden_states = getattr(self, f'layer_{idx}')(
                hidden_states, key_feats[level], key_pos[level], query_pos, attn_mask,
            )
            inter = self.layernorm(hidden_states)
            pred_mask, attn_mask = self.mask_predictor(
                inter, mask_features, size_list[(idx + 1) % nl]
            )
            intermediate.append(inter)
            mask_logits_all.append(pred_mask)

        return tuple(intermediate), tuple(mask_logits_all)
