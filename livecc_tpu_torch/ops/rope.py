"""Rotary position embeddings: 1D (vision) and 3-section M-RoPE (text).

Same contracts as ``livecc_tpu/ops/rope.py`` (transformers
modeling_qwen2_vl.py): the vision tables are host-side numpy, the text
cos/sin are computed on the tensor's device, and every rotation runs in
float32 before casting back to the activation dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


# ---------------------------------------------------------------------------
# Vision (1D rotary over an (h, w) patch grid, merge-order layout)
# ---------------------------------------------------------------------------

def vision_rot_pos_ids(grid_thw: list[tuple[int, int, int]], spatial_merge_size: int = 2) -> np.ndarray:
    """Per-patch (h_pos, w_pos) ids in the ViT's 2x2-merge scan order.

    Host-side numpy copy of ``livecc_tpu/ops/rope.py:vision_rot_pos_ids`` (that
    module imports jax); pinned to it by ``tests/test_torch_package.py``.
    """
    out = []
    m = spatial_merge_size
    for t, h, w in grid_thw:
        hpos = np.broadcast_to(np.arange(h)[:, None], (h, w))
        hpos = hpos.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).reshape(-1)
        wpos = np.broadcast_to(np.arange(w)[None, :], (h, w))
        wpos = wpos.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).reshape(-1)
        ids = np.stack([hpos, wpos], axis=-1)          # [h*w, 2]
        out.append(np.tile(ids, (t, 1)))               # repeat over temporal groups
    return np.concatenate(out, axis=0)                  # [sum t*h*w, 2]


def vision_rotary_cos_sin(
    grid_thw: list[tuple[int, int, int]],
    head_dim: int,
    theta: float = 10000.0,
    spatial_merge_size: int = 2,
) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of shape [N, head_dim] for the ViT, float32, host-side."""
    dim = head_dim // 2  # rotary dim per (h, w) component
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    pos = vision_rot_pos_ids(grid_thw, spatial_merge_size)          # [N, 2]
    max_grid = int(max(max(h, w) for _, h, w in grid_thw))
    freqs_full = np.outer(np.arange(max_grid, dtype=np.float64), inv_freq)  # [G, dim/2]
    freqs = freqs_full[pos].reshape(pos.shape[0], -1)               # [N, dim] (h then w)
    emb = np.concatenate([freqs, freqs], axis=-1)                   # [N, head_dim]
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def apply_rotary_vision(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """q, k: [N, heads, head_dim]; cos/sin: [N, head_dim]. Float32 math."""
    dtype = q.dtype
    qf, kf = q.float(), k.float()
    c = cos[:, None, :].float()
    s = sin[:, None, :].float()
    q_out = qf * c + rotate_half(qf) * s
    k_out = kf * c + rotate_half(kf) * s
    return q_out.to(dtype), k_out.to(dtype)


# ---------------------------------------------------------------------------
# Text (M-RoPE)
# ---------------------------------------------------------------------------

def mrope_cos_sin(
    position_ids: torch.Tensor,      # [3, B, S] int
    head_dim: int,
    rope_theta: float,
    mrope_section: tuple[int, int, int],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token cos/sin [B, S, head_dim] with mrope sections already selected.

    Float32 throughout, on ``position_ids``' device. Channels [0:s0] come
    from the t row, [s0:s0+s1] from h, the rest of the half from w, and the
    pattern repeats over the second rotary half.
    """
    dev = position_ids.device
    inv_freq = 1.0 / (rope_theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=dev) / head_dim))
    freqs = position_ids.float()[..., None] * inv_freq            # [3, B, S, head_dim/2]
    emb = torch.cat([freqs, freqs], dim=-1)                         # [3, B, S, head_dim]
    cos, sin = torch.cos(emb), torch.sin(emb)
    sections = list(mrope_section) * 2
    starts = np.cumsum([0] + sections[:-1])
    cos_parts = [cos[i % 3, :, :, st:st + ln] for i, (st, ln) in enumerate(zip(starts, sections))]
    sin_parts = [sin[i % 3, :, :, st:st + ln] for i, (st, ln) in enumerate(zip(starts, sections))]
    return torch.cat(cos_parts, dim=-1), torch.cat(sin_parts, dim=-1)


def apply_mrope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """q: [B, S, Hq, D], k: [B, S, Hk, D]; cos/sin: [B, S, D] (pre-selected)."""
    dtype = q.dtype
    cf = cos[:, :, None, :].float()
    sf = sin[:, :, None, :].float()
    qf, kf = q.float(), k.float()
    q_out = qf * cf + rotate_half(qf) * sf
    k_out = kf * cf + rotate_half(kf) * sf
    return q_out.to(dtype), k_out.to(dtype)
