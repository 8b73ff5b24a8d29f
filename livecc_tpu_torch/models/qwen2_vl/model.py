"""Qwen2-VL combined multimodal model (ViT + LLM + M-RoPE glue).

Port of ``livecc_tpu/models/qwen2_vl/model.py`` (transformers
modeling_qwen2_vl.py semantics):

  * ``get_rope_index`` — per-token 3D (t, h, w) positions plus
    ``rope_deltas``; host-side numpy, copied from the JAX module (which
    imports jax) and pinned to it by ``tests/test_torch_package.py``;
  * ``scatter_video_embeds`` — placeholder slots take the visual embeddings
    in order (a mask-gather, no host sync);
  * ``forward`` — embeddings, the vision tower, the cached text tower (or,
    without a cache, the training one), and optionally the fp32 LM head;
    batched serving clips (``patches`` [B, Np, pd], one clip per row with
    shared tables) run through ONE vision-tower call over all rows'
    groups, as JAX's ``vmap`` (``model.py:220-232``); the embedding lookup
    goes through ``ops/quant.py:embed_lookup`` (plain or int8 table);
  * ``prepare_vision_inputs`` — rotary tables, segment ids and the uniform
    ``group`` of a set of clips, built on the host and moved to a device;
  * ``init_params`` — a model with random weights drawn from a seeded
    ``torch.Generator`` on the target device (no download, no host copy).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from livecc_tpu_torch.core.config import ModelConfig
from livecc_tpu_torch.models.qwen2_vl.text import KVCache, TextModel, lm_logits, text_forward
from livecc_tpu_torch.models.qwen2_vl.vision import VisionTower
from livecc_tpu_torch.ops.quant import embed_lookup, jax_weight
from livecc_tpu_torch.ops.rope import vision_rotary_cos_sin
from livecc_tpu_torch.parallel.tp import vocab_parallel_embed


class Qwen2VL(nn.Module):
    """``visual`` (ViT tower) + ``text`` (LLM tower). Built with every
    parameter frozen; training unfreezes its trainable modules
    (``train/step.py:split_frozen``)."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.visual = VisionTower(cfg.vision, device, dtype)
        self.text = TextModel(cfg.text, device, dtype)
        self.requires_grad_(False)


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                dtype=torch.float32) -> Qwen2VL:
    """Random-init model, drawn on ``device`` from ``generator`` (which must
    live on that device). The JAX scheme: every matrix ~ N(0, 1/fan_in)
    (fan_in = its input width), norm scales 1, biases 0."""
    model = Qwen2VL(cfg, device=device, dtype=dtype)
    for name, p in model.named_parameters():
        if p.ndim == 2:
            p.normal_(0.0, p.shape[1] ** -0.5, generator=generator)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.fill_(1.0)
    return model


# ---------------------------------------------------------------------------
# Host-side vision auxiliaries
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class VisionInputs:
    """ViT inputs for one forward. ``group`` is the per-temporal-group patch
    count (grid h*w) when uniform: the path through K3."""

    patches: torch.Tensor    # [N, patch_dim], or [B, N, patch_dim] (one clip per row)
    cos: torch.Tensor        # [N, head_dim] (shared by every row)
    sin: torch.Tensor        # [N, head_dim]
    seg_ids: torch.Tensor    # [N] int32 (pad patches < 0)
    group: int | None = None


def prepare_vision_inputs(cfg: ModelConfig, patches, grid_thw: list[tuple[int, int, int]],
                          device) -> VisionInputs:
    """ViT inputs for a set of clips (JAX ``model.py:69-88``): rotary tables
    and segment ids (``t + 10**6 * clip``) built on the host, moved with the
    patches to ``device``. When every clip shares one (h, w), ``group`` is
    h * w and the tower runs K3's group form; otherwise its bounds form."""
    cos, sin = vision_rotary_cos_sin(
        grid_thw, cfg.vision.head_dim, spatial_merge_size=cfg.vision.spatial_merge_size
    )
    seg_ids = np.concatenate(
        [np.repeat(np.arange(t) + 10**6 * i, h * w) for i, (t, h, w) in enumerate(grid_thw)]
    ).astype(np.int32)
    hws = {(h, w) for _, h, w in grid_thw}
    group = (grid_thw[0][1] * grid_thw[0][2]) if len(hws) == 1 else None
    return VisionInputs(
        patches=torch.as_tensor(patches).to(device),
        cos=torch.from_numpy(cos).to(device),
        sin=torch.from_numpy(sin).to(device),
        seg_ids=torch.from_numpy(seg_ids).to(device),
        group=group,
    )


# ---------------------------------------------------------------------------
# get_rope_index (host, numpy) — HF Qwen2VLModel.get_rope_index parity
# ---------------------------------------------------------------------------

def get_rope_index(
    cfg: ModelConfig,
    input_ids: np.ndarray,                     # [B, S]
    image_grid_thw: Optional[np.ndarray] = None,   # [n_img, 3]
    video_grid_thw: Optional[np.ndarray] = None,   # [n_vid, 3]
    attention_mask: Optional[np.ndarray] = None,   # [B, S] 1/0
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (position_ids [3, B, S] int32, rope_deltas [B, 1] int32)."""
    input_ids = np.asarray(input_ids)
    b, s = input_ids.shape
    merge = cfg.vision.spatial_merge_size
    if image_grid_thw is None and video_grid_thw is None:
        if attention_mask is not None:
            pos = np.cumsum(attention_mask, axis=-1) - 1
            pos[attention_mask == 0] = 1
            position_ids = np.broadcast_to(pos[None], (3, b, s)).astype(np.int32)
            deltas = (pos.max(-1, keepdims=True) + 1 - s).astype(np.int32)
        else:
            position_ids = np.broadcast_to(np.arange(s)[None, None], (3, b, s)).astype(np.int32)
            deltas = np.zeros((b, 1), np.int32)
        return np.ascontiguousarray(position_ids), deltas

    if attention_mask is None:
        attention_mask = np.ones_like(input_ids)
    position_ids = np.ones((3, b, s), dtype=np.int64)
    image_index = video_index = 0
    deltas = []
    for i in range(b):
        ids = input_ids[i][attention_mask[i] == 1]
        vision_starts = np.where(ids == cfg.vision_start_token_id)[0]
        vision_tokens = ids[vision_starts + 1] if len(vision_starts) else np.array([], ids.dtype)
        image_nums = int((vision_tokens == cfg.image_token_id).sum())
        video_nums = int((vision_tokens == cfg.video_token_id).sum())
        tokens = ids.tolist()
        pos_list: list[np.ndarray] = []
        st = 0
        remain_images, remain_videos = image_nums, video_nums
        for _ in range(image_nums + video_nums):
            ed_image = tokens.index(cfg.image_token_id, st) if (cfg.image_token_id in tokens[st:] and remain_images > 0) else len(tokens) + 1
            ed_video = tokens.index(cfg.video_token_id, st) if (cfg.video_token_id in tokens[st:] and remain_videos > 0) else len(tokens) + 1
            if ed_image < ed_video:
                t, h, w = image_grid_thw[image_index]
                image_index += 1
                remain_images -= 1
                ed = ed_image
            else:
                t, h, w = video_grid_thw[video_index]
                video_index += 1
                remain_videos -= 1
                ed = ed_video
            gt, gh, gw = int(t), int(h) // merge, int(w) // merge
            text_len = ed - st
            st_idx = int(pos_list[-1].max()) + 1 if pos_list else 0
            pos_list.append(np.broadcast_to(np.arange(text_len), (3, text_len)) + st_idx)
            t_idx = np.repeat(np.arange(gt), gh * gw)
            h_idx = np.tile(np.repeat(np.arange(gh), gw), gt)
            w_idx = np.tile(np.arange(gw), gt * gh)
            pos_list.append(np.stack([t_idx, h_idx, w_idx]) + text_len + st_idx)
            st = ed + gt * gh * gw
        if st < len(tokens):
            st_idx = int(pos_list[-1].max()) + 1 if pos_list else 0
            text_len = len(tokens) - st
            pos_list.append(np.broadcast_to(np.arange(text_len), (3, text_len)) + st_idx)
        pos = np.concatenate(pos_list, axis=1)
        position_ids[:, i, attention_mask[i] == 1] = pos
        deltas.append(int(pos.max()) + 1 - int(s))
    return position_ids.astype(np.int32), np.asarray(deltas, np.int32)[:, None]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def scatter_video_embeds(
    cfg: ModelConfig,
    token_embeds: torch.Tensor,   # [B, S, H]
    input_ids: torch.Tensor,      # [B, S]
    video_embeds: torch.Tensor,   # [Nv, H] (all videos concatenated, in order) or [B, Nv, H]
    token_id: int | None = None,  # defaults to video_token_id
) -> torch.Tensor:
    """Place visual embeddings at placeholder slots (order-preserving). With
    per-row embeddings [B, Nv, H] each row's slots take its own clip, and a
    row without placeholders (an idle pool slot) is left as it is."""
    b, s, h = token_embeds.shape
    token_id = cfg.video_token_id if token_id is None else token_id
    video_embeds = video_embeds.to(token_embeds.dtype)
    if video_embeds.ndim == 3:
        mask = input_ids == token_id                                       # [B, S]
        idx = (torch.cumsum(mask.long(), dim=1) - 1).clamp(0, video_embeds.shape[1] - 1)
        gathered = torch.gather(video_embeds, 1, idx[..., None].expand(b, s, h))
        return torch.where(mask[..., None], gathered, token_embeds)
    mask = (input_ids == token_id).reshape(-1)
    idx = torch.cumsum(mask.long(), dim=0) - 1
    gathered = video_embeds[idx.clamp(0, video_embeds.shape[0] - 1)]
    flat = torch.where(mask[:, None], gathered, token_embeds.reshape(-1, h))
    return flat.reshape(b, s, h)


def batched_video_embeds(model: Qwen2VL, vision: VisionInputs) -> torch.Tensor:
    """Per-row clips [B, Np, pd] with shared tables -> [B, Np / merge**2, H].

    One vision-tower call over the flattened [B * Np, pd] patches with the
    rotary tables repeated B times: every row's uniform groups go to K3 in
    ONE launch (B * T / 2 groups for T-frame clips). The merger folds
    consecutive patches, which never cross a row, so each row's embeddings
    equal a separate call's (JAX runs ``vmap``). Without a uniform group
    (clips of different grids) each row's segment ids are offset by the
    ids' span, so no two rows share one, and the tower runs K3's bounds
    form over all rows' segments (the ids are read on the host, as that
    form reads them anyway)."""
    b, n_p, pd = vision.patches.shape
    group = vision.group
    if group is not None and n_p % group == 0:
        seg = vision.seg_ids.repeat(b)
    else:
        ids = vision.seg_ids.cpu()
        span = int(ids.max()) - int(ids.min()) + 1
        rows = torch.arange(b, dtype=ids.dtype).repeat_interleave(n_p)
        seg, group = (ids.repeat(b) + rows * span).to(vision.seg_ids.device), None
    out = model.visual(vision.patches.reshape(b * n_p, pd), vision.cos.repeat(b, 1),
                       vision.sin.repeat(b, 1), seg, group)
    return out.reshape(b, -1, out.shape[-1])


def _visual(model: Qwen2VL, vision: VisionInputs) -> torch.Tensor:
    """The vision tower on one set of clips. A frozen tower (no parameter
    requires grad) runs under ``no_grad``: its activations are not kept and
    K3 runs forward only."""
    frozen = not any(p.requires_grad for p in model.visual.parameters())
    with torch.set_grad_enabled(torch.is_grad_enabled() and not frozen):
        if vision.patches.ndim == 3:
            return batched_video_embeds(model, vision)
        return model.visual(vision.patches, vision.cos, vision.sin, vision.seg_ids, vision.group)


def forward(
    model: Qwen2VL,
    cfg: ModelConfig,
    input_ids: torch.Tensor,                   # [B, S]
    position_ids: torch.Tensor,                # [3, B, S]
    cache: Optional[KVCache] = None,
    vision: Optional[VisionInputs] = None,     # patches [N, pd] or per-row [B, Np, pd]
    kv_limit: Optional[torch.Tensor] = None,
    compute_logits: bool = True,
    attention_mask: Optional[torch.Tensor] = None,   # uncached: bool [B, S] or int32 segments
    vision_images: Optional[VisionInputs] = None,    # image clips -> image_token_id slots
    remat: bool | str = False,
    seq_shard: bool = False,
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Multimodal forward. Returns (fp32 logits [B, S, V], or the final
    hidden states when ``compute_logits`` is False, and the cache). Without
    a cache it is the training forward (JAX ``model.py:197-255``): the text
    tower runs uncached through K4 with ``attention_mask`` and ``remat``.
    On a tensor-parallel model the embedding is vocab-parallel, the ViT and
    the scatter of its embeddings run whole on every rank, and the logits
    are gathered whole on every rank. ``seq_shard`` (training on a split
    tower) runs the text tower sequence-parallel (``text.py``) after the
    embeddings and the scatter of the visual ones."""
    if model.text.tp is None:
        embeds = embed_lookup(jax_weight(model.text.embed), input_ids.long())
    else:               # a vocab-split table (parallel/sharding.py:shard_params)
        embeds = vocab_parallel_embed(jax_weight(model.text.embed), input_ids.long(),
                                      model.text.tp)
    if vision is not None:
        embeds = scatter_video_embeds(cfg, embeds, input_ids, _visual(model, vision))
    if vision_images is not None:
        embeds = scatter_video_embeds(cfg, embeds, input_ids, _visual(model, vision_images),
                                      token_id=cfg.image_token_id)
    hidden, cache = text_forward(model.text, cfg.text, embeds, position_ids, cache,
                                 kv_limit=kv_limit, attention_mask=attention_mask, remat=remat,
                                 seq_shard=seq_shard)
    if not compute_logits:
        return hidden, cache
    return lm_logits(model.text, cfg.text, hidden), cache
