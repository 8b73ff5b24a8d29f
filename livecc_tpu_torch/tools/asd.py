"""Active-speaker-detection corpus filter (Lighter-ASD pipeline structure).

The port's own copy of ``livecc_tpu/tools/asd.py`` (host numpy; the port
imports nothing of the JAX package). Reference:
data/production/distributed_lighter_asd/ — the talking-head filter: decode
at low resolution (160x288, H x W), detect faces (SCRFD ONNX), track them
with batched IoU matching, window 150 frames every 750, score face tubes +
audio MFCCs with a small ASD net, and keep clips whose talking-head ratio is
<= 0.05 (debug.py:44-55).

The neural pieces are pluggable callables: the face detector is
tools/scrfd.py (``make_detector``, or an ONNX graph through
``load_onnx_detector`` and tools/onnx_torch.py) and the ASD scorer is
tools/lightasd.py (``track_score``). Everything structural (IoU tracking
face_tracker.py:10-41, windowing main.py:33-38, ratio aggregation) is here,
in numpy, equal to the JAX package's output for output.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

Box = np.ndarray  # [4] x1, y1, x2, y2


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N,4] x [M,4] -> [N,M] IoU (face_tracker.py batched matching)."""
    area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(a[:, 3] - a[:, 1], 0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return np.divide(inter, union, out=np.zeros_like(inter, dtype=np.float64),
                     where=union > 0)


def nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float = 0.4) -> np.ndarray:
    """Greedy NMS (face_detector.py:60 torchvision-NMS equivalent)."""
    order = np.argsort(-scores)
    keep = []
    while len(order):
        i = order[0]
        keep.append(i)
        if len(order) == 1:
            break
        ious = box_iou(boxes[i:i + 1], boxes[order[1:]])[0]
        order = order[1:][ious <= iou_threshold]
    return np.asarray(keep, np.int64)


@dataclasses.dataclass
class Track:
    track_id: int
    frames: list[int]
    boxes: list[np.ndarray]

    @property
    def last_box(self) -> np.ndarray:
        return self.boxes[-1]


class FaceTracker:
    """IoU-greedy track association (face_tracker.py:10-41 behavior)."""

    def __init__(self, iou_threshold: float = 0.5, max_gap: int = 10):
        self.iou_threshold = iou_threshold
        self.max_gap = max_gap
        self.tracks: list[Track] = []
        self._next_id = 0

    def update(self, frame_idx: int, boxes: np.ndarray) -> None:
        live = [t for t in self.tracks if frame_idx - t.frames[-1] <= self.max_gap]
        if len(boxes) and live:
            prev = np.stack([t.last_box for t in live])
            ious = box_iou(np.asarray(boxes), prev)          # [new, live]
            used = set()
            order = np.dstack(np.unravel_index(np.argsort(-ious, axis=None), ious.shape))[0]
            assigned = set()
            for bi, ti in order:
                if bi in assigned or ti in used or ious[bi, ti] < self.iou_threshold:
                    continue
                live[ti].frames.append(frame_idx)
                live[ti].boxes.append(np.asarray(boxes[bi]))
                assigned.add(bi)
                used.add(ti)
            new_boxes = [b for i, b in enumerate(boxes) if i not in assigned]
        else:
            new_boxes = list(boxes)
        for b in new_boxes:
            self.tracks.append(Track(self._next_id, [frame_idx], [np.asarray(b)]))
            self._next_id += 1


def window_indices(total_frames: int, window: int = 150, stride: int = 750) -> list[tuple[int, int]]:
    """150-frame analysis windows every 750 frames (main.py:33-38)."""
    out = []
    start = 0
    while start < total_frames:
        out.append((start, min(start + window, total_frames)))
        start += stride
    return out


def talking_ratio(
    frames: np.ndarray,                  # [T, H, W, 3] uint8 low-res decode
    detect_faces: Callable[[np.ndarray], tuple[np.ndarray, np.ndarray]],
    score_track: Callable[[Track, np.ndarray], float],
    *,
    window: int = 150,
    stride: int = 750,
    min_track_len: int = 10,
) -> float:
    """Fraction of analyzed windows judged 'talking head'.

    ``detect_faces(frame) -> (boxes [N,4], scores [N])``;
    ``score_track(track, frames) -> prob`` that the tube is a talking face
    (the Light-ASD CNN+GRU in the reference, lightasd.py:1-23).
    """
    windows = window_indices(len(frames), window, stride)
    if not windows:
        return 0.0
    talking = 0
    for lo, hi in windows:
        tracker = FaceTracker()
        for i in range(lo, hi):
            boxes, scores = detect_faces(frames[i])
            if len(boxes):
                keep = nms(np.asarray(boxes), np.asarray(scores))
                tracker.update(i, np.asarray(boxes)[keep])
        probs = [score_track(t, frames) for t in tracker.tracks
                 if len(t.frames) >= min_track_len]
        if probs and max(probs) > 0.5:
            talking += 1
    return talking / len(windows)


def keep_clip(ratio: float, threshold: float = 0.05) -> bool:
    """Corpus filter: keep clips with talking-head ratio <= 0.05
    (reference debug.py:44-55)."""
    return ratio <= threshold


def mfcc(audio: np.ndarray, sample_rate: int = 16000, n_mfcc: int = 13,
         frame_len: int = 400, hop: int = 160, n_mels: int = 26) -> np.ndarray:
    """Minimal MFCC features for the ASD audio branch (numpy, no deps)."""
    n_frames = max(1 + (len(audio) - frame_len) // hop, 1)
    idx = np.arange(frame_len)[None, :] + hop * np.arange(n_frames)[:, None]
    idx = np.minimum(idx, len(audio) - 1)
    frames = audio[idx] * np.hamming(frame_len)
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    freqs = np.fft.rfftfreq(frame_len, 1.0 / sample_rate)
    mel = 2595 * np.log10(1 + freqs / 700)
    mel_pts = np.linspace(0, mel[-1], n_mels + 2)
    fb = np.zeros((n_mels, len(freqs)))
    for m in range(n_mels):
        lo, ce, hi = mel_pts[m], mel_pts[m + 1], mel_pts[m + 2]
        fb[m] = np.clip(np.minimum((mel - lo) / max(ce - lo, 1e-9),
                                   (hi - mel) / max(hi - ce, 1e-9)), 0, None)
    logmel = np.log(spec @ fb.T + 1e-10)
    # DCT-II
    k = np.arange(n_mels)
    basis = np.cos(np.pi / n_mels * (k[None, :] + 0.5) * np.arange(n_mfcc)[:, None])
    return logmel @ basis.T
