"""Offline commentary-video renderer (reference demo/render/), on the port.

Port of ``livecc_tpu/demo/render.py``. Re-reads a demo result JSON
({video_path, query, commentaries}) and re-encodes the video with
query/response chat bubbles drawn on each frame (reference
demo/render/bubble.py rounded-rect blurred bubbles, video.py compositing).
TTS is a pluggable callable, ``tts(text) -> (samples, sample_rate)``; the
default is the built-in formant synthesizer (``audio/tts.py``, the offline
stand-in for the reference's Kokoro). Each commentary's clip is placed at
its start time on a silence timeline and the track is muxed into the output
mp4 as an AAC stream by the port's native layer
(``vision_io/video_reader.py:encode_video_with_audio``; reference
demo/render/video.py:186-200 overlay semantics).

Host code only: it reads and writes through the port's FFmpeg-backed
``VideoReader`` and encoders, draws with Pillow, and launches no kernel.
The web demo (``demo/app.py``) does not import it.
"""

from __future__ import annotations

import json
from typing import Callable, Optional

import numpy as np
from PIL import Image, ImageDraw, ImageFilter, ImageFont

from livecc_tpu_torch.vision_io.video_reader import (VideoReader, encode_test_video,
                                                     encode_video_with_audio)


def _font(size: int):
    try:
        return ImageFont.truetype("DejaVuSans.ttf", size)
    except OSError:
        return ImageFont.load_default()


def _wrap(draw, text: str, font, max_width: int) -> list[str]:
    lines, cur = [], ""
    for word in text.split():
        trial = (cur + " " + word).strip()
        if draw.textlength(trial, font=font) <= max_width:
            cur = trial
        else:
            if cur:
                lines.append(cur)
            cur = word
    if cur:
        lines.append(cur)
    return lines


def draw_bubble(
    frame: Image.Image,
    text: str,
    *,
    anchor: str = "bottom",      # 'top' = query bubble, 'bottom' = response
    margin: int = 16,
    pad: int = 12,
    radius: int = 14,
    font_size: int = 18,
    fill=(20, 20, 20, 170),
    text_fill=(255, 255, 255, 255),
) -> Image.Image:
    """Blurred rounded-rect bubble (reference bubble.py:16-126 behavior)."""
    frame = frame.convert("RGBA")
    w, h = frame.size
    font = _font(font_size)
    overlay = Image.new("RGBA", frame.size, (0, 0, 0, 0))
    draw = ImageDraw.Draw(overlay)
    lines = _wrap(draw, text, font, w - 2 * (margin + pad))
    if not lines:
        return frame.convert("RGB")
    line_h = font_size + 6
    box_h = len(lines) * line_h + 2 * pad
    box_w = min(max(int(draw.textlength(line, font=font)) for line in lines) + 2 * pad,
                w - 2 * margin)
    x0 = margin
    y0 = margin if anchor == "top" else h - margin - box_h
    # blur the backdrop under the bubble, then draw the bubble on top
    region = frame.crop((x0, y0, x0 + box_w, y0 + box_h)).filter(ImageFilter.GaussianBlur(6))
    frame.paste(region, (x0, y0))
    draw.rounded_rectangle((x0, y0, x0 + box_w, y0 + box_h), radius=radius, fill=fill)
    for i, line in enumerate(lines):
        draw.text((x0 + pad, y0 + pad + i * line_h), line, font=font, fill=text_fill)
    return Image.alpha_composite(frame, overlay).convert("RGB")


def render_commentary_video(
    result_json: str,
    output_path: str,
    *,
    fps: int = 10,
    max_seconds: float | None = None,
    tts: Optional[Callable[[str], tuple[np.ndarray, int]]] = "default",
) -> str:
    """Burn query/commentary bubbles into the video (reference video.py).

    ``tts``: "default" uses the built-in formant synthesizer
    (``audio/tts.py``); a callable substitutes any engine; None renders a
    video-only mp4 (no audio track).
    """
    if tts == "default":
        from livecc_tpu_torch.audio.tts import synthesize as tts
    with open(result_json) as f:
        result = json.load(f)
    reader = VideoReader(result["video_path"])
    pts = reader.pts_seconds
    end = float(pts[-1]) if max_seconds is None else min(max_seconds, float(pts[-1]))
    commentaries = result.get("commentaries", [])

    out_frames = []
    cursor = 0
    for i in range(int(round(end * fps)) + 1):
        t = i / fps
        while cursor < len(pts) - 1 and pts[cursor] < t:
            cursor += 1
        frame = Image.fromarray(reader.get_batch([cursor])[0])
        active = [c for c in commentaries if c[0] <= t]
        if result.get("query"):
            frame = draw_bubble(frame, result["query"], anchor="top")
        if active:
            frame = draw_bubble(frame, active[-1][2], anchor="bottom")
        out_frames.append(np.asarray(frame, np.uint8))
    reader.close()

    if tts is None or not commentaries:
        encode_test_video(output_path, np.stack(out_frames), fps=fps)
        return output_path
    # each commentary's TTS clip at its start time on a silence timeline
    # covering the rendered span, muxed with the video into one mp4
    clips, rate = [], 16000
    for t0, _, text in commentaries:
        samples, rate = tts(text)
        clips.append((float(t0), np.asarray(samples, np.float32)))
    track = np.zeros(int(round(len(out_frames) / fps * rate)) + rate // 10, np.float32)
    for t0, samples in clips:
        lo = int(round(t0 * rate))
        hi = min(lo + len(samples), len(track))
        if lo < len(track):
            track[lo:hi] += samples[: hi - lo]
    peak = np.max(np.abs(track))
    if peak > 1.0:
        track *= 0.95 / peak
    encode_video_with_audio(output_path, np.stack(out_frames), fps, track, rate)
    return output_path
