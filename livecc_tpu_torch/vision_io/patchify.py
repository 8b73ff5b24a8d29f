"""Frames -> Qwen2-VL patch sequence (normalize + 3D patchify), host and device.

Port of ``livecc_tpu/vision_io/patchify.py`` (transformers
Qwen2VLImageProcessor._preprocess semantics): frames are rescaled,
CLIP-normalised and flattened by the same 9-D transpose to
``[grid_t * grid_h * grid_w, C * tps * ps * ps]``. Two paths:

  * ``patchify_video``: numpy in and out, on the host (the data pipeline);
  * ``device_patchify``: the streaming path. uint8 frames go to the device
    (a quarter of the bytes of fp32 patches) and are prepared there;
  * ``device_preprocess``: the same from unscaled frames, resized on their
    device first by JAX's antialiased bicubic (``ops/resize.py``). The
    streaming engine does not call it: the native decoder scales the frames
    it decodes.
"""

from __future__ import annotations

import numpy as np
import torch

from livecc_tpu_torch.ops.resize import resize

# CLIP normalization constants (Qwen2VLImageProcessor defaults).
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)

PATCH_SIZE = 14
TEMPORAL_PATCH_SIZE = 2
MERGE_SIZE = 2


def normalize_frames(frames: torch.Tensor) -> torch.Tensor:
    """uint8/float frames in [0,255], (T, C, H, W) -> CLIP-normalized float32."""
    mean = torch.tensor(IMAGE_MEAN, dtype=torch.float32, device=frames.device).reshape(1, 3, 1, 1)
    std = torch.tensor(IMAGE_STD, dtype=torch.float32, device=frames.device).reshape(1, 3, 1, 1)
    frames = frames.float() * (1.0 / 255.0)
    return (frames - mean) / std


def _patchify(frames: torch.Tensor, patch_size: int, temporal_patch_size: int,
              merge_size: int) -> tuple[torch.Tensor, tuple[int, int, int]]:
    t, c, h, w = frames.shape
    if t % temporal_patch_size != 0:
        reps = temporal_patch_size - t % temporal_patch_size
        frames = torch.cat([frames] + [frames[-1:]] * reps, dim=0)
        t = frames.shape[0]
    grid_t = t // temporal_patch_size
    grid_h, grid_w = h // patch_size, w // patch_size
    patches = frames.reshape(
        grid_t,
        temporal_patch_size,
        c,
        grid_h // merge_size,
        merge_size,
        patch_size,
        grid_w // merge_size,
        merge_size,
        patch_size,
    )
    patches = patches.permute(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = patches.reshape(grid_t * grid_h * grid_w, c * temporal_patch_size * patch_size * patch_size)
    return flat, (grid_t, grid_h, grid_w)


def patchify_video(
    frames: np.ndarray,
    *,
    patch_size: int = PATCH_SIZE,
    temporal_patch_size: int = TEMPORAL_PATCH_SIZE,
    merge_size: int = MERGE_SIZE,
    normalize: bool = True,
) -> tuple[np.ndarray, tuple[int, int, int]]:
    """Host path: (T, C, H, W) frames -> (flatten_patches, grid_thw), numpy
    arrays (float32 when ``normalize``, else the frames' dtype)."""
    x = torch.from_numpy(np.ascontiguousarray(frames))
    if normalize:
        x = normalize_frames(x)
    flat, grid = _patchify(x, patch_size, temporal_patch_size, merge_size)
    return flat.numpy(), grid


def grid_for_frames(t: int, h: int, w: int, cfg) -> tuple[int, int, int]:
    """grid_thw for a [t, h, w] clip as ``device_patchify`` lays it out: CEIL
    on the temporal axis (an odd T counts its padded group)."""
    return (max(-(-t // cfg.temporal_patch_size), 1),
            h // cfg.patch_size, w // cfg.patch_size)


def device_patchify(
    frames: torch.Tensor,      # [T, H, W, C] uint8 (decoder layout, pre-scaled), on the device
    *,
    n_pad: int = 0,
    patch_size: int = PATCH_SIZE,
    temporal_patch_size: int = TEMPORAL_PATCH_SIZE,
    merge_size: int = MERGE_SIZE,
) -> torch.Tensor:
    """Normalize + patchify pre-scaled frames on their device; ``n_pad`` zero
    rows pad the output."""
    x = frames.permute(0, 3, 1, 2).float()                      # TCHW
    x = normalize_frames(x)
    flat, _ = _patchify(x, patch_size, temporal_patch_size, merge_size)
    if n_pad:
        flat = torch.nn.functional.pad(flat, (0, 0, 0, n_pad))
    return flat


def device_preprocess(
    frames: torch.Tensor,      # [T, H, W, C] uint8, on the device
    *,
    out_h: int,
    out_w: int,
    patch_size: int = PATCH_SIZE,
    temporal_patch_size: int = TEMPORAL_PATCH_SIZE,
    merge_size: int = MERGE_SIZE,
) -> torch.Tensor:
    """Raw uint8 frames -> flatten_patches on their device (JAX's
    ``device_preprocess``): ``jax.image.resize``'s antialiased bicubic
    (Keys, a = -0.5; torch's ``bicubic`` computes other values) to
    ``out_h`` x ``out_w``, CLIP normalization and the 3D patchify. T must
    be a multiple of ``temporal_patch_size``."""
    t = frames.shape[0]
    if t % temporal_patch_size:
        raise ValueError(f"device_preprocess: T = {t} frames is not a multiple of "
                         f"temporal_patch_size = {temporal_patch_size}")
    x = resize(frames.float(), (t, out_h, out_w, frames.shape[-1]), "bicubic")
    x = normalize_frames(x.permute(0, 3, 1, 2))                 # TCHW
    flat, _ = _patchify(x, patch_size, temporal_patch_size, merge_size)
    return flat
