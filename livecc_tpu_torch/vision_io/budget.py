"""Frame-pipeline math: fps sampling, smart resize, visual-token budgeting.

A copy of ``livecc_tpu/vision_io/budget.py`` (pure host-side numpy; the
port imports nothing of the JAX package), pinned to it by
``tests/test_torch_live.py``. It reproduces the reference's frame pipeline
so that the port tokenizes videos as the JAX package does:

  * ``smart_resize``      — reference: qwen_vl_utils.vision_process.smart_resize,
    also transformers image_processing_qwen2_vl.py (nearest factor-of-28
    multiples with pixel-count clamping).
  * ``smart_nframes``     — qwen_vl_utils.vision_process.smart_nframes (frame
    count targeting FPS, rounded to FRAME_FACTOR within [min, max] frames).
  * ``strict_fps_sample`` — reference: livecc-utils video_process_patch.py:59-78
    (_read_video_decord_plus strict-fps branch: expected timestamps at 1/FPS
    spacing, FPS_MAX_FRAMES cap with drop-last or linspace, PTS snapping,
    right-pad to a FRAME_FACTOR multiple).
  * ``video_frame_max_pixels`` — video_process_patch.py:93 per-frame pixel
    budget (this is the total-visual-token budgeter: <=24,576 video tokens).

The reference configures these via environment variables read at import time
(video_process_patch.py:10-14). Here they are explicit config on
``VisionBudget`` — no import-order traps.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# Qwen2-VL processor constants (qwen_vl_utils.vision_process defaults).
IMAGE_FACTOR = 28          # patch_size * spatial_merge_size = 14 * 2
FRAME_FACTOR = 2           # temporal_patch_size
DEFAULT_FPS = 2.0
FPS_MIN_FRAMES = 4

# LiveCC overrides (video_process_patch.py:11-14).
LIVECC_VIDEO_MIN_PIXELS = 100 * 28 * 28          # 78_400
LIVECC_VIDEO_MAX_PIXELS = 24576 * 28 * 28        # 19_267_584
LIVECC_FPS_MAX_FRAMES = 480

# Image limits (Qwen2VLImageProcessor defaults: shortest_edge/longest_edge).
IMAGE_MIN_PIXELS = 56 * 56                       # 3_136
IMAGE_MAX_PIXELS = 28 * 28 * 1280                # 1_003_520


@dataclasses.dataclass(frozen=True)
class VisionBudget:
    """Visual-token budget configuration (explicit, not env-var driven).

    Defaults reproduce LiveCC's configuration: total visual tokens <= 24,576,
    >= 100 tokens per 2-frame group, <= 480 frames at 2 fps.
    """

    factor: int = IMAGE_FACTOR
    frame_factor: int = FRAME_FACTOR
    fps: float = DEFAULT_FPS
    fps_min_frames: int = FPS_MIN_FRAMES
    fps_max_frames: int = LIVECC_FPS_MAX_FRAMES
    video_min_pixels: int = LIVECC_VIDEO_MIN_PIXELS
    video_max_pixels: int = LIVECC_VIDEO_MAX_PIXELS
    # qwen_vl_utils sets VIDEO_TOTAL_PIXELS from the VIDEO_MAX_PIXELS env var;
    # under LiveCC's settings the two are equal.
    video_total_pixels: int = LIVECC_VIDEO_MAX_PIXELS
    image_min_pixels: int = IMAGE_MIN_PIXELS
    image_max_pixels: int = IMAGE_MAX_PIXELS

    def image_target(self, height: int, width: int) -> tuple[int, int]:
        """(resized_h, resized_w) for a still image (processor defaults)."""
        return smart_resize(height, width, factor=self.factor,
                            min_pixels=self.image_min_pixels,
                            max_pixels=self.image_max_pixels)

    def video_frame_max_pixels(self, nframes: int) -> float:
        """Per-frame pixel budget for an ``nframes``-frame clip.

        Reference: video_process_patch.py:93 — the budget shrinks as the clip
        grows so the *total* token count stays bounded, but never below
        1.05 * VIDEO_MIN_PIXELS. Kept as float exactly like the reference.
        """
        return max(
            min(self.video_max_pixels, self.video_total_pixels / nframes * self.frame_factor),
            int(self.video_min_pixels * 1.05),
        )

    def spatial_target(self, height: int, width: int, nframes: int) -> tuple[int, int]:
        """(resized_h, resized_w) for a clip — video_process_patch.py:88-100."""
        return smart_resize(
            height,
            width,
            factor=self.factor,
            min_pixels=self.video_min_pixels,
            max_pixels=self.video_frame_max_pixels(nframes),
        )


def round_by_factor(number: float, factor: int) -> int:
    return round(number / factor) * factor


def ceil_by_factor(number: float, factor: int) -> int:
    return math.ceil(number / factor) * factor


def floor_by_factor(number: float, factor: int) -> int:
    return math.floor(number / factor) * factor


def smart_resize(
    height: int,
    width: int,
    factor: int = IMAGE_FACTOR,
    min_pixels: int = 56 * 56,
    max_pixels: int = 14 * 14 * 4 * 1280,
) -> tuple[int, int]:
    """Nearest factor-multiples of (height, width) with pixel-count clamping.

    Behavioral contract (matches transformers Qwen2VLImageProcessor.smart_resize):
      1. both outputs divisible by ``factor``
      2. total pixels within [min_pixels, max_pixels]
      3. aspect ratio preserved as closely as possible
    """
    if max(height, width) / min(height, width) > 200:
        raise ValueError(
            "absolute aspect ratio must be smaller than 200, got "
            f"{max(height, width) / min(height, width)}"
        )
    h_bar = round_by_factor(height, factor)
    w_bar = round_by_factor(width, factor)
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, floor_by_factor(height / beta, factor))
        w_bar = max(factor, floor_by_factor(width / beta, factor))
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = ceil_by_factor(height * beta, factor)
        w_bar = ceil_by_factor(width * beta, factor)
    return h_bar, w_bar


def smart_nframes(
    total_frames: int,
    video_fps: float,
    *,
    nframes: int | None = None,
    fps: float | None = None,
    min_frames: int | None = None,
    max_frames: int | None = None,
    budget: VisionBudget = VisionBudget(),
) -> int:
    """Number of frames to sample for model input.

    Behavioral contract of qwen_vl_utils.vision_process.smart_nframes: either
    an explicit ``nframes`` (rounded to FRAME_FACTOR) or an fps-derived count
    clamped to [min_frames, max_frames] and total_frames, floored to a
    FRAME_FACTOR multiple. Used by the reference at video_process_patch.py:60
    and evaluation harnesses.
    """
    if nframes is not None:
        out = round_by_factor(nframes, budget.frame_factor)
    else:
        fps = budget.fps if fps is None else fps
        min_frames = ceil_by_factor(
            budget.fps_min_frames if min_frames is None else min_frames, budget.frame_factor
        )
        max_frames = floor_by_factor(
            min(budget.fps_max_frames, total_frames) if max_frames is None else max_frames,
            budget.frame_factor,
        )
        out = total_frames / video_fps * fps
        out = min(min(max(out, min_frames), max_frames), total_frames)
        out = floor_by_factor(out, budget.frame_factor)
    if not (budget.frame_factor <= out <= total_frames):
        raise ValueError(
            f"nframes should be in interval [{budget.frame_factor}, {total_frames}], got {out}"
        )
    return int(out)


def linspace_sample(total_frames: int, nframes: int) -> np.ndarray:
    """Uniformly spaced frame indices — video_process_patch.py:61."""
    return np.linspace(0, total_frames - 1, nframes).round().astype(int)


def strict_fps_sample(
    clip_pts: np.ndarray,
    *,
    budget: VisionBudget = VisionBudget(),
    drop_last: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Strict-fps sampling over a PTS table.

    Reference: video_process_patch.py:68-78. Expected timestamps run from
    clip_pts[0] to clip_pts[-1] at 1/fps spacing; if more than fps_max_frames,
    either truncate (drop_last) or linspace-downsample; each expected timestamp
    snaps to the first PTS >= it; the result is right-padded by repeating the
    last frame until its length is a FRAME_FACTOR multiple.

    Args:
      clip_pts: float array of frame presentation timestamps (seconds),
        monotonically non-decreasing.

    Returns:
      (indices_into_clip_pts, sampled_pts) — both padded to a FRAME_FACTOR
      multiple (indices may repeat).
    """
    clip_pts = np.asarray(clip_pts, dtype=np.float64)
    expected = np.arange(clip_pts[0], clip_pts[-1] + 1e-6, 1.0 / budget.fps)
    if len(expected) > budget.fps_max_frames:
        if drop_last:
            expected = expected[: budget.fps_max_frames]
        else:
            keep = np.linspace(0, len(expected) - 1, budget.fps_max_frames).round().astype(int)
            expected = expected[keep]
    # First PTS >= expected timestamp (argmax over the <= mask).
    idxs = (expected[:, None] <= clip_pts[None, :]).argmax(axis=1)
    pts = clip_pts[idxs]
    idxs, pts = list(idxs), list(pts)
    while len(idxs) % budget.frame_factor != 0:
        idxs.append(idxs[-1])
        pts.append(pts[-1])
    return np.asarray(idxs, dtype=np.int64), np.asarray(pts, dtype=np.float64)


def snap_timestamps_to_pts(
    timestamps: np.ndarray,
    video_pts: np.ndarray,
    *,
    index_from: int = 0,
    frame_factor: int = FRAME_FACTOR,
    fps: float = DEFAULT_FPS,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Streaming PTS-cursor snapping for live inference.

    Reference: video_process_patch.py:126-149 (get_smart_resized_clip): pad
    requested timestamps up to a FRAME_FACTOR multiple (extending by 1/fps),
    advance a monotonic cursor through video_pts collecting the first frame
    whose PTS >= each timestamp, then truncate to a FRAME_FACTOR multiple.

    Returns:
      (frame_indices, kept_timestamps, next_cursor). ``next_cursor`` is the
      index after the last consumed frame (pass as ``index_from`` next call).
    """
    timestamps = list(np.asarray(timestamps, dtype=np.float64))
    while len(timestamps) % frame_factor != 0:
        timestamps.append(timestamps[-1] + 1.0 / fps)
    clip_idxs: list[int] = []
    cursor = index_from
    n = len(video_pts)
    for ts in timestamps:
        while cursor < n and video_pts[cursor] < ts:
            cursor += 1
        if cursor >= n:
            break
        clip_idxs.append(cursor)
    while len(clip_idxs) % frame_factor != 0:
        clip_idxs = clip_idxs[:-1]
        timestamps = timestamps[:-1]
    kept = np.asarray(timestamps[: len(clip_idxs)], dtype=np.float64)
    return np.asarray(clip_idxs, dtype=np.int64), kept, (clip_idxs[-1] + 1 if clip_idxs else index_from)


def grid_thw_for(nframes: int, resized_h: int, resized_w: int,
                 patch_size: int = 14, temporal_patch_size: int = 2) -> tuple[int, int, int]:
    """(t, h, w) patch grid for a clip after resize (processor semantics)."""
    grid_t = max(nframes // temporal_patch_size, 1)
    return grid_t, resized_h // patch_size, resized_w // patch_size


def num_video_tokens(grid_thw: tuple[int, int, int], spatial_merge_size: int = 2) -> int:
    """LLM-visible token count for a patch grid (after 2x2 spatial merge)."""
    t, h, w = grid_thw
    return t * h * w // (spatial_merge_size**2)
