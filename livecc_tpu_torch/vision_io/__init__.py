from livecc_tpu_torch.vision_io.budget import (
    FRAME_FACTOR, IMAGE_FACTOR, VisionBudget, grid_thw_for, linspace_sample, num_video_tokens,
    smart_nframes, smart_resize, snap_timestamps_to_pts, strict_fps_sample,
)
from livecc_tpu_torch.vision_io.patchify import (
    IMAGE_MEAN, IMAGE_STD, device_patchify, device_preprocess, grid_for_frames, normalize_frames,
    patchify_video,
)

__all__ = [
    "FRAME_FACTOR", "IMAGE_FACTOR", "VisionBudget", "grid_thw_for", "linspace_sample",
    "num_video_tokens", "smart_nframes", "smart_resize", "snap_timestamps_to_pts",
    "strict_fps_sample",
    "IMAGE_MEAN", "IMAGE_STD", "device_patchify", "device_preprocess", "grid_for_frames",
    "normalize_frames", "patchify_video",
]
