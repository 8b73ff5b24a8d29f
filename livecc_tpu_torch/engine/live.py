"""Real-time streaming session: wall-clock-driven commentary over a video.

Port of ``livecc_tpu/engine/live.py``: the reference's ``live_cc`` generator
and ``video_qa`` API (demo/infer.py:61-242) on top of ``LiveCCEngine``. A
``LiveSession`` owns the video reader, the PTS cursor and the growing KV
cache; each call reports the playback time and yields the commentary of any
newly played frames. Frames are decoded and scaled inside the native decoder
(libswscale), then go to the device as uint8.

``LiveCC(engine, video_loader=...)`` takes any callable that opens a video
as an object with ``VideoReader``'s API (``__len__``, ``frame_size``,
``pts_seconds``, ``avg_fps``, ``get_batch(indices, out_hw)``); the default is
the port's ``VideoReader``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional

import numpy as np

from livecc_tpu_torch.engine.generation import GenerationParams
from livecc_tpu_torch.engine.streaming import LiveCCEngine, StreamState
from livecc_tpu_torch.vision_io.budget import (
    smart_nframes, smart_resize, snap_timestamps_to_pts, strict_fps_sample)


def _video_reader(source) -> Any:
    from livecc_tpu_torch.vision_io.video_reader import VideoReader

    return VideoReader(source)


@dataclasses.dataclass
class LiveSession:
    """One video stream's full state (model cache + decode cursors)."""

    stream: StreamState
    reader: Any
    resized_hw: tuple[int, int]
    video_pts: np.ndarray
    last_timestamp: float
    last_pts_index: int = 0
    query_sent: bool = False
    video_end: bool = False


class LiveCC:
    """Wall-clock streaming driver around ``LiveCCEngine``."""

    def __init__(self, engine: LiveCCEngine, *, live_max_pixels: int = 384 * 28 * 28,
                 video_loader: Callable[[Any], Any] = _video_reader):
        self.engine = engine
        self.live_max_pixels = live_max_pixels
        self.video_loader = video_loader

    def open(self, video) -> LiveSession:
        """Open ``video`` with the loader and resolve its resize target once
        (reference get_smart_resized_video_reader, video_process_patch.py:109-124)."""
        reader = self.video_loader(video)
        budget = self.engine.budget
        nframes = min(len(reader), budget.fps_max_frames)
        h, w = reader.frame_size
        max_pixels = max(
            min(budget.video_max_pixels, budget.video_total_pixels / nframes * budget.frame_factor),
            int(budget.video_min_pixels * 1.05),
        )
        max_pixels = min(max_pixels, self.live_max_pixels)
        rh, rw = smart_resize(h, w, factor=budget.factor,
                              min_pixels=budget.video_min_pixels, max_pixels=max_pixels)
        return LiveSession(
            stream=self.engine.new_stream(),
            reader=reader,
            resized_hw=(rh, rw),
            video_pts=reader.pts_seconds,
            last_timestamp=-1.0 / self.engine.fps,
        )

    def live_cc(
        self,
        session: LiveSession,
        video_timestamp: float,
        query: str | None = None,
        gen: Optional[GenerationParams] = None,
    ) -> Iterator[tuple[tuple[float, float], str]]:
        """Process any frames newly played up to ``video_timestamp``.

        Yields ((t0, t1), text) per interleave chunk, the reference live_cc
        state machine (demo/infer.py:84-180): 0.5 s-spaced timestamps in
        (last, now], PTS-snapped with a monotonic cursor, grouped into a
        6-frame init chunk then 2-frame chunks.
        """
        engine = self.engine
        gen = gen or GenerationParams(
            max_new_tokens=16,
            eos_token_id=engine.cfg.eos_token_id,
            pad_token_id=engine.cfg.pad_token_id,
            repetition_penalty=1.05,
        )
        pts = session.video_pts
        dt = 1.0 / engine.fps
        video_timestamp = min(video_timestamp, float(pts[-1]))
        if session.last_timestamp + dt > pts[-1]:
            session.video_end = True
            return
        initialized = session.last_timestamp >= 0
        if not initialized:
            video_timestamp = max(video_timestamp, engine.initial_fps_frames / engine.fps)
        if video_timestamp <= session.last_timestamp + dt:
            return
        timestamps = np.arange(session.last_timestamp + dt, video_timestamp, dt)
        idxs, kept_ts, cursor = snap_timestamps_to_pts(
            timestamps, pts, index_from=session.last_pts_index,
            frame_factor=engine.streaming_fps_frames, fps=engine.fps,
        )
        if len(idxs) == 0:
            return
        session.last_pts_index = cursor
        session.last_timestamp = float(kept_ts[-1])

        rh, rw = session.resized_hw
        frames = session.reader.get_batch(idxs, out_hw=(rh, rw))       # [T, H, W, 3] uint8

        chunks: list[tuple[np.ndarray, np.ndarray]] = []
        if not initialized:
            k = engine.initial_fps_frames
            chunks.append((frames[:k], kept_ts[:k]))
            frames, kept_ts = frames[k:], kept_ts[k:]
        step = engine.streaming_fps_frames
        for i in range(0, len(frames), step):
            chunks.append((frames[i:i + step], kept_ts[i:i + step]))

        for clip, ts in chunks:
            if len(clip) == 0:
                continue
            t0, t1 = float(ts[0]), float(ts[-1]) + dt
            q = None
            if query and not session.query_sent:
                q = query
                session.query_sent = True
            text = engine.chunk_step(session.stream, clip, t0, t1, q, gen)
            yield (t0, t1), text

    def video_qa(
        self,
        session: LiveSession,
        message: str,
        gen: Optional[GenerationParams] = None,
    ) -> str:
        """Multiturn QA over the same KV cache (demo/infer.py:182-242). The
        video is attached on the first turn only (a whole-clip strict-fps
        read); later turns are text-only continuations."""
        engine = self.engine
        gen = gen or GenerationParams(
            max_new_tokens=512,
            eos_token_id=engine.cfg.eos_token_id,
            pad_token_id=engine.cfg.pad_token_id,
            repetition_penalty=1.05,
        )
        frames = None
        if session.stream.rope_delta is None:
            idxs, _ = strict_fps_sample(session.video_pts, budget=engine.budget)
            nframes = smart_nframes(len(session.video_pts), session.reader.avg_fps,
                                    budget=engine.budget)
            keep = np.linspace(0, len(idxs) - 1, nframes).round().astype(int)
            rh, rw = session.resized_hw
            frames = session.reader.get_batch(idxs[keep], out_hw=(rh, rw))
        return engine.qa_turn(session.stream, frames, message, gen)
