"""Qwen2-VL vision tower as an ``nn.Module``.

Port of ``livecc_tpu/models/qwen2_vl/vision.py`` (transformers
Qwen2VisionTransformerPretrainedModel semantics): the 3D-conv patch embed as
one matmul over flattened patches, ``depth`` pre-LN blocks with 2D rotary
attention restricted to per-temporal-group segments, a QuickGELU MLP, and
the 2x2 PatchMerger projecting to the LLM width.

Attention: when every temporal group has ``group_size`` patches (every
single-video path, and so the whole streaming path) it runs through K3
``vit_group_attention``. Mixed sizes (the JAX tower's segment-mask ``mha``)
run through K3's bounds form, ``vit_segment_attention``: the bounds come
from the runs of equal ``seg_ids``, read on the host once per tower call
on that path only.

The block and merger linears may be ``ops/quant.py:QuantLinear`` (int8
weights through K5, the serving configuration); ``patch_embed``, the raw
pixels' projection, stays in the model dtype, as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from livecc_tpu_torch.core.config import VisionConfig
from livecc_tpu_torch.models.qwen2_vl.layers import LayerNorm
from livecc_tpu_torch.ops.rope import apply_rotary_vision
from livecc_tpu_torch.ops.vit_attention import (
    segment_bounds, vit_group_attention, vit_segment_attention)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class VisionBlock(nn.Module):
    def __init__(self, cfg: VisionConfig, device=None, dtype=None):
        super().__init__()
        e, m = cfg.embed_dim, cfg.mlp_hidden_dim
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.norm1 = LayerNorm(e, cfg.layer_norm_eps, **kw)
        self.norm2 = LayerNorm(e, cfg.layer_norm_eps, **kw)
        self.qkv = nn.Linear(e, 3 * e, **kw)
        self.proj = nn.Linear(e, e, **kw)
        self.fc1 = nn.Linear(e, m, **kw)
        self.fc2 = nn.Linear(m, e, **kw)

    def forward(self, x, cos, sin, attend) -> torch.Tensor:
        n = x.shape[0]
        h, hd = self.cfg.num_heads, self.cfg.head_dim
        qkv = self.qkv(self.norm1(x)).reshape(n, 3 * h, hd)
        q, k, v = qkv.split(h, dim=1)
        q, k = apply_rotary_vision(q, k, cos, sin)
        x = x + self.proj(attend(q, k, v).reshape(n, h * hd))
        return x + self.fc2(quick_gelu(self.fc1(self.norm2(x))))


class PatchMerger(nn.Module):
    def __init__(self, cfg: VisionConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        merge_dim = cfg.embed_dim * cfg.spatial_merge_size**2
        self.merge_dim = merge_dim
        self.ln_q = LayerNorm(cfg.embed_dim, cfg.layer_norm_eps, **kw)
        self.fc1 = nn.Linear(merge_dim, merge_dim, **kw)
        self.fc2 = nn.Linear(merge_dim, cfg.hidden_size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ln_q(x).reshape(-1, self.merge_dim)
        return self.fc2(F.gelu(self.fc1(y), approximate="none"))


class VisionTower(nn.Module):
    def __init__(self, cfg: VisionConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = nn.Linear(cfg.patch_dim, cfg.embed_dim, bias=False,
                                     device=device, dtype=dtype)
        self.blocks = nn.ModuleList(VisionBlock(cfg, device, dtype) for _ in range(cfg.depth))
        self.merger = PatchMerger(cfg, device, dtype)

    def forward(
        self,
        patches: torch.Tensor,   # [N, patch_dim] processor-layout flattened patches
        cos: torch.Tensor,       # [N, head_dim] (ops.rope.vision_rotary_cos_sin)
        sin: torch.Tensor,
        seg_ids: torch.Tensor,   # [N] int32 per-temporal-group segment ids
        group_size: int | None = None,   # h*w when all groups are equal
    ) -> torch.Tensor:
        """[N, patch_dim] -> [N / merge**2, hidden_size] visual embeddings."""
        n = patches.shape[0]
        h, hd = self.cfg.num_heads, self.cfg.head_dim
        grouped = group_size is not None and n % group_size == 0
        if not grouped:
            cu, max_len = segment_bounds(seg_ids)
            cu = torch.tensor(cu, dtype=torch.int32).to(patches.device)

        def attend(q, k, v):
            if grouped:
                g = group_size
                out = vit_group_attention(q.reshape(n // g, g, h, hd), k.reshape(n // g, g, h, hd),
                                          v.reshape(n // g, g, h, hd))
                return out.reshape(n, h, hd)
            return vit_segment_attention(q, k, v, cu, max_len)

        x = self.patch_embed(patches.to(self.patch_embed.weight.dtype))
        for blk in self.blocks:
            x = blk(x, cos, sin, attend)
        return self.merger(x)
