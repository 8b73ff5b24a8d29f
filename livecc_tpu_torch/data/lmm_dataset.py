"""Training dataset: seek-indexed JSONL + dense streaming interleave.

A port of ``livecc_tpu/data/lmm_dataset.py`` (host-side numpy, kept as the
port's own copy on the port's ``data.chat``, ``data.tokenizer``,
``get_rope_index``, ``vision_io.budget`` and ``patchify_video``), which
re-implements the reference dataset's behavior (data/lmm_dataset.py):

  * O(1)-RAM corpus loading: each JSONL's **last line** is a byte-offset
    array; samples are read with seek()+readline() (lmm_dataset.py:23-28,
    55-60,71-77) — 5M-sample corpora never live in memory.
  * streaming interleave: a clip is read at strict 2 fps with per-frame PTS,
    then emitted as [user(Time=a-b s, 6 frames, query), assistant(words<=t
    + ' ...'), user(Time, 2 frames), assistant(...)] turns, ASR words
    aligned by ``get_phrase_before_timestamp`` and trailing empty turns
    trimmed (lmm_dataset.py:105-149).
  * label masking: only assistant spans are supervised —
    labels[im_start+3 : im_end+1] (lmm_dataset.py:184-191).
  * resilience: retry-with-random-resample on any error
    (lmm_dataset.py:194-203). The port counts the retries in
    ``LMMDataset.retries`` (JAX swallows them): behaviour does not change,
    but a broken loader or decoder that a resample hides shows in the count.

Output is a host-side sample dict ready for bucket-padding by the collator:
input_ids / labels / position_ids (full 3D M-RoPE over the interleaved
sequence) + vision patches/grids.
"""

from __future__ import annotations

import dataclasses
import json
import random
import threading
from typing import Any, Callable, Optional, Sequence

import numpy as np

from livecc_tpu_torch.core.config import ModelConfig
from livecc_tpu_torch.data import chat
from livecc_tpu_torch.data.tokenizer import Tokenizer
from livecc_tpu_torch.models.qwen2_vl.model import get_rope_index
from livecc_tpu_torch.vision_io.budget import (
    VisionBudget, linspace_sample, smart_nframes, strict_fps_sample)
from livecc_tpu_torch.vision_io.patchify import patchify_video


def read_last_line(path: str) -> bytes:
    """Last line of a file without reading the file (seek from the end)."""
    with open(path, "rb") as f:
        f.seek(-2, 2)
        while f.read(1) != b"\n":
            f.seek(-2, 1)
        return f.readline()


def get_phrase_before_timestamp(
    text_stream: Sequence[Sequence], timestamp: float, start_from: int = 0
) -> tuple[str, int]:
    """Words fully spoken by ``timestamp``; returns (phrase, next cursor).

    ``text_stream`` rows are (word_start, word_end, word) triples
    (reference lmm_dataset.py:36-43).
    """
    phrase: list[str] = []
    i = start_from
    for i, (ws, we, word) in enumerate(text_stream[start_from:], start=start_from):
        if timestamp >= we:
            phrase.append(word.strip())
        else:
            break
    return " ".join(w for w in phrase if w), i


@dataclasses.dataclass
class DataArguments:
    """Reference DataArguments (lmm_dataset.py:15-20)."""

    annotation_paths: list[str] = dataclasses.field(default_factory=list)
    initial_fps_frames: int = 6            # int(FPS) * 3
    streaming_fps_frames: int = 2          # int(FPS)
    with_context: bool = False


class LMMDataset:
    """Seek-indexed JSONL dataset producing processed single samples."""

    def __init__(
        self,
        *,
        annotation_paths: list[str],
        tokenizer: Tokenizer,
        cfg: ModelConfig,
        budget: VisionBudget | None = None,
        initial_fps_frames: int = 6,
        streaming_fps_frames: int = 2,
        with_context: bool = False,
        video_loader: Optional[Callable[[str], "object"]] = None,
        max_retries: int = 100,
        seed: int = 0,
    ):
        self.handles: list[tuple[str, int]] = []
        for path in annotation_paths:
            if not path.endswith(".jsonl"):
                raise ValueError("annotations must be JSONL with a seek-index last line")
            seeks = json.loads(read_last_line(path))
            self.handles.extend((path, s) for s in seeks)
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.budget = budget or VisionBudget()
        self.initial_fps_frames = initial_fps_frames
        self.streaming_fps_frames = streaming_fps_frames
        self.with_context = with_context
        self.max_retries = max_retries
        self.retries = 0                   # samples replaced by a resample, over all calls
        self._retry_lock = threading.Lock()   # the trainer's loader threads share the count
        self._rng = random.Random(seed)
        if video_loader is None:
            from livecc_tpu_torch.vision_io.video_reader import VideoReader
            video_loader = VideoReader
        self.video_loader = video_loader

    def __len__(self) -> int:
        return len(self.handles)

    def load_conversation(self, index: int) -> list[dict]:
        path, seek = self.handles[index]
        with open(path) as f:
            f.seek(seek)
            return json.loads(f.readline())

    # ------------------------------------------------------------------
    # video reading
    # ------------------------------------------------------------------

    def _read_strict_fps(self, video_path: str, video_start=None, video_end=None):
        """Strict-fps clip + sampled PTS, resized to the per-clip budget."""
        reader = self.video_loader(video_path)
        pts = reader.pts_seconds
        if video_start is not None or video_end is not None:
            lo = pts[0] if not video_start else video_start
            hi = pts[-1] if not video_end else video_end
            keep = (pts >= lo) & (pts <= hi)
            base_idx = np.where(keep)[0]
            pts = pts[keep]
        else:
            base_idx = np.arange(len(pts))
        rel_idx, clip_pts = strict_fps_sample(pts, budget=self.budget)
        idxs = base_idx[rel_idx]
        h, w = reader.frame_size
        rh, rw = self.budget.spatial_target(h, w, nframes=len(idxs))
        frames = reader.get_batch(idxs, out_hw=(rh, rw))    # [T, H, W, 3] u8
        return frames, clip_pts

    # ------------------------------------------------------------------
    # conversation preprocessing
    # ------------------------------------------------------------------

    def preprocess_text(self, element: dict) -> str:
        """Optional title/previous-ASR context (lmm_dataset.py:95-103)."""
        if self.with_context and ("title" in element or "previous" in element):
            previous = element.get("previous", "")
            title = "" if previous else element.get("title", "")
            return (element["text"] + f"\n{title}\n{previous}").strip()
        return element["text"]

    def preprocess_conversation_stream(self, conversation: list[dict]):
        """Dense interleave (reference lmm_dataset.py:105-149)."""
        user_message, assistant_message = conversation
        user_video, user_query = user_message["content"][0], user_message["content"][1]
        assert "video" in user_video, "first user content must be the video"
        text_stream = assistant_message["content"][0]["text_stream"]

        frames, clip_pts = self._read_strict_fps(
            user_video["video"], user_video.get("video_start"), user_video.get("video_end")
        )
        fps = self.budget.fps
        init, step = self.initial_fps_frames, self.streaming_fps_frames

        phrase, cursor = get_phrase_before_timestamp(text_stream, clip_pts[init - 1])
        turns = [
            {"role": "user", "content": [
                {"type": "text", "text": f"Time={0.0:.1f}-{init / fps:.1f}s"},
                {"type": "video"},
                {"type": "text", "text": self.preprocess_text(user_query)},
            ]},
            {"role": "assistant", "content": [{"type": "text", "text": phrase + " ..."}]},
        ]
        clips = [frames[:init]]
        for i in range(init, len(frames), step):
            phrase, cursor = get_phrase_before_timestamp(
                text_stream, clip_pts[i + step - 1], start_from=cursor
            )
            turns.extend([
                {"role": "user", "content": [
                    {"type": "text", "text": f"Time={i / fps:.1f}-{(i + step) / fps:.1f}s"},
                    {"type": "video"},
                ]},
                {"role": "assistant", "content": [{"type": "text", "text": phrase + " ..."}]},
            ])
            clips.append(frames[i:i + step])
        # trim trailing empty turns (lmm_dataset.py:146-148)
        while turns and turns[-1]["content"][0]["text"] == " ...":
            turns = turns[:-2]
            clips = clips[:-1]
        return turns, clips

    def preprocess_conversation_plain(self, conversation: list[dict]):
        """Non-streaming samples (video QA / image SFT): whole-media turns."""
        clips = []
        images = []
        turns = []
        for message in conversation:
            content = message["content"]
            if isinstance(content, str):
                turns.append({"role": message["role"], "content": content})
                continue
            out = []
            for element in content:
                etype = element.get(
                    "type",
                    "text" if "text" in element else ("image" if "image" in element else "video"),
                )
                if etype == "video" or (etype != "image" and "video" in element):
                    reader = self.video_loader(element["video"])
                    n = smart_nframes(len(reader), reader.avg_fps, budget=self.budget)
                    idxs = linspace_sample(len(reader), n)
                    h, w = reader.frame_size
                    rh, rw = self.budget.spatial_target(h, w, nframes=n)
                    clips.append(reader.get_batch(idxs, out_hw=(rh, rw)))
                    out.append({"type": "video"})
                elif etype == "image":
                    images.append(self._load_image(element["image"]))
                    out.append({"type": "image"})
                else:
                    out.append({"type": "text", "text": element["text"]})
            turns.append({"role": message["role"], "content": out})
        return turns, clips, images

    def _load_image(self, source) -> np.ndarray:
        """Image file/array -> [1, H, W, 3] uint8 at the image pixel budget."""
        if isinstance(source, np.ndarray):
            arr = source
        else:
            from PIL import Image
            img = Image.open(source).convert("RGB")
            h, w = self.budget.image_target(img.height, img.width)
            arr = np.asarray(img.resize((w, h), Image.BICUBIC))
        return arr[None]

    # ------------------------------------------------------------------
    # sample assembly
    # ------------------------------------------------------------------

    def build_sample(self, turns: list[dict], clips: list[np.ndarray],
                     images: list[np.ndarray] = ()) -> dict[str, Any]:
        patches_list, grids = [], []
        for clip in clips:
            frames = np.transpose(clip, (0, 3, 1, 2))       # TCHW for host patchify
            p, g = patchify_video(frames)
            patches_list.append(p)
            grids.append(g)
        img_patches, img_grids = [], []
        for img in images:
            p, g = patchify_video(np.transpose(img, (0, 3, 1, 2)))
            img_patches.append(p)
            img_grids.append(g)
        text = chat.render_chat(turns, add_generation_prompt=False)
        text = chat.expand_vision_placeholders(text, video_grid_thw=grids,
                                               image_grid_thw=img_grids)
        input_ids = np.asarray(self.tokenizer.encode(text), np.int32)[None]

        labels = np.full_like(input_ids, -100)
        im_start, im_end = self.cfg.im_start_token_id, self.cfg.im_end_token_id
        # Supervise assistant spans only: tokens after '<|im_start|>assistant\n'
        # through (incl.) '<|im_end|>' — reference lmm_dataset.py:184-191,
        # where the role+newline is 2 tokens so the span starts at st+3. The
        # prefix length is derived from the live tokenizer so byte-level test
        # tokenizers mask the same semantic span.
        prefix = np.asarray(self.tokenizer.encode("assistant\n"), np.int32)
        starts = np.where(input_ids[0] == im_start)[0]
        ends = np.where(input_ids[0] == im_end)[0]
        for st, en in zip(starts, ends):
            span = input_ids[0, st + 1: st + 1 + len(prefix)]
            if len(span) == len(prefix) and np.array_equal(span, prefix):
                lo = st + 1 + len(prefix)
                labels[0, lo:en + 1] = input_ids[0, lo:en + 1]

        grid_arr = np.asarray(grids) if grids else None
        img_grid_arr = np.asarray(img_grids) if img_grids else None
        pos, _ = get_rope_index(self.cfg, input_ids, video_grid_thw=grid_arr,
                                image_grid_thw=img_grid_arr)
        return {
            "input_ids": input_ids,
            "labels": labels,
            "position_ids": pos,
            "pixel_patches": np.concatenate(patches_list) if patches_list else None,
            "video_grid_thw": grid_arr,
            "image_patches": np.concatenate(img_patches) if img_patches else None,
            "image_grid_thw": img_grid_arr,
        }

    def getitem(self, index: int) -> dict[str, Any]:
        conversation = self.load_conversation(index)
        is_stream = any(
            "text_stream" in element
            for message in conversation if message["role"] == "assistant"
            for element in (message["content"] if isinstance(message["content"], list) else [])
        )
        if is_stream:
            turns, clips = self.preprocess_conversation_stream(conversation)
            return self.build_sample(turns, clips)
        turns, clips, images = self.preprocess_conversation_plain(conversation)
        return self.build_sample(turns, clips, images)

    def __getitem__(self, index: int) -> dict[str, Any]:
        for attempt in range(self.max_retries):
            try:
                return self.getitem(index)
            except Exception:
                if attempt == self.max_retries - 1:
                    raise
                with self._retry_lock:
                    self.retries += 1
                index = self._rng.randint(0, len(self) - 1)
        raise RuntimeError("unreachable")


def write_seek_index(path: str) -> None:
    """Append the byte-offset index as the last line of a JSONL corpus
    (the reference's to_conversation.py:7-24 packaging contract)."""
    seeks = []
    with open(path, "rb") as f:
        off = 0
        for line in f:
            seeks.append(off)
            off += len(line)
    with open(path, "a") as f:
        f.write(json.dumps(seeks) + "\n")
