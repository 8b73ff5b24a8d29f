"""Distributed LMM talking-head filter (reference data/production/
distributed_lmm4asd.py).

Port of ``livecc_tpu/tools/lmm4asd.py``. A small Qwen2-VL is shown N evenly
sampled low-res frames of each corpus clip as IMAGES and asked the
reference's fixed question; the filter signal is P('Yes') read from the
softmax at the last position (reference :61-62, token 9454 = ' Yes' in the
Qwen tokenizer — resolved here via the tokenizer, not hardcoded). The
reference runs this as a deepspeed Trainer.predict at per-device batch 64
over node-sharded video lists with chunked output files (:64-100); here
the same surface is one batched uncached forward on the model's device (the
ViT through K3, the LLM through K4's forward on the card), with stride
sharding, idempotent per-chunk files and a merge.

Only each row's last real position goes through the LM head: full logits
of a batch of 64 in the 1024 bucket would be 40 GB of fp32 (JAX takes
them and then the last row).

Deviation noted: the reference bicubic-resizes frames to 320x180 and lets
the HF processor smart_resize them again to 28-multiples (308x168); this
harness decodes straight to smart_resize(320, 180) — one resize, same
final geometry.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from livecc_tpu_torch.core.config import ModelConfig
from livecc_tpu_torch.data import chat
from livecc_tpu_torch.data.tokenizer import Tokenizer
from livecc_tpu_torch.models.qwen2_vl.model import (
    Qwen2VL,
    VisionInputs,
    forward,
    get_rope_index,
    prepare_vision_inputs,
)
from livecc_tpu_torch.models.qwen2_vl.text import lm_logits
from livecc_tpu_torch.vision_io.budget import linspace_sample, smart_resize
from livecc_tpu_torch.vision_io.patchify import patchify_video

# Exact reference prompt (distributed_lmm4asd.py:32), parameterized on N.
QUESTION = ("Here are {n} evenly sampled frames from a YouTube video. "
            "Are there someone always showing their faces and talking? "
            "Answer Yes or No.")


@torch.no_grad()
def yes_prob_at_last(
    model: Qwen2VL,
    cfg: ModelConfig,
    ids: torch.Tensor,          # [B, S]
    pos: torch.Tensor,          # [3, B, S]
    mask: torch.Tensor,         # [B, S] bool
    last: torch.Tensor,         # [B] index of last real token
    yes_id: int,
    vision: VisionInputs,
) -> torch.Tensor:
    """softmax(logits[:, last])[yes_id] per row (reference :61-62), fp32 [B].

    ``vision`` carries the frames as IMAGES — they fill image_token_id
    slots (the reference conversation is N image contents, :27-33)."""
    hidden, _ = forward(model, cfg, ids, pos, attention_mask=mask, vision_images=vision,
                        compute_logits=False)
    at_last = hidden[torch.arange(ids.shape[0], device=ids.device), last]      # [B, H]
    logits = lm_logits(model.text, cfg.text, at_last[:, None, :])[:, 0]
    return torch.softmax(logits, dim=-1)[:, yes_id]


class TalkingHeadPredictor:
    """Batched Yes-prob scoring of corpus clips (Trainer.predict
    replacement), on the model's device."""

    def __init__(
        self,
        model: Qwen2VL,
        cfg: ModelConfig,
        tokenizer: Tokenizer,
        *,
        num_frames: int = 8,
        frame_hw: tuple[int, int] = (320, 180),
        batch_size: int = 64,
        video_loader=None,
        max_read_retries: int = 3,
    ):
        self.model = model
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = next(model.parameters()).device
        self.num_frames = num_frames
        self.frame_hw = smart_resize(*frame_hw)     # (308, 168) for the default
        self.batch_size = batch_size
        self.max_read_retries = max_read_retries
        if video_loader is None:
            from livecc_tpu_torch.vision_io.video_reader import VideoReader
            video_loader = VideoReader
        self.video_loader = video_loader
        self.yes_id = tokenizer.encode("Yes")[0]

    def _read(self, video: str) -> np.ndarray:
        """N linspace-sampled frames at the filter resolution
        (reference :21-26: linspace over the whole video, bicubic resize)."""
        reader = self.video_loader(video)
        idxs = linspace_sample(len(reader), self.num_frames)
        return reader.get_batch(idxs, out_hw=self.frame_hw)

    def encode(self, frames: np.ndarray) -> dict:
        """Frames [N, H, W, 3] -> model inputs, frames as N separate images
        (the reference conversation is N image contents + the question)."""
        patches, grids = [], []
        for f in frames:
            p, g = patchify_video(np.transpose(f[None], (0, 3, 1, 2)))
            patches.append(p)
            grids.append(g)
        content = [{"type": "image", "image": None} for _ in frames]
        content.append({"type": "text", "text": QUESTION.format(n=len(frames))})
        text = chat.render_chat([{"role": "user", "content": content}],
                                add_generation_prompt=True)
        text = chat.expand_vision_placeholders(text, image_grid_thw=grids)
        ids = np.asarray(self.tokenizer.encode(text), np.int32)[None]
        pos, _ = get_rope_index(self.cfg, ids, image_grid_thw=np.asarray(grids))
        return {"ids": ids, "pos": pos, "patches": np.concatenate(patches), "grids": grids}

    def predict_probs(self, videos: Sequence[str]) -> np.ndarray:
        """P('Yes') per video; -1.0 marks unreadable items (the reference ASD
        driver's error convention, main.py:109-111)."""
        out = np.full((len(videos),), -1.0, np.float64)
        batch: list[tuple[int, dict]] = []
        for i, video in enumerate(videos):
            enc = None
            for _ in range(self.max_read_retries):
                try:
                    enc = self.encode(self._read(video))
                    break
                except Exception:
                    continue
            if enc is not None:
                batch.append((i, enc))
            if len(batch) >= self.batch_size:
                self._flush(batch, out)
                batch = []
        if batch:
            self._flush(batch, out)
        return out

    def _flush(self, batch: list[tuple[int, dict]], out: np.ndarray) -> None:
        b = len(batch)
        s_max = max(enc["ids"].shape[1] for _, enc in batch)
        s = 1 << (s_max - 1).bit_length()           # pow2 bucket (JAX: stable jit shapes)
        ids = np.zeros((b, s), np.int32)
        pos = np.zeros((3, b, s), np.int32)
        mask = np.zeros((b, s), bool)
        last = np.zeros((b,), np.int64)
        patches, grids = [], []
        for row, (_, enc) in enumerate(batch):
            n = enc["ids"].shape[1]
            ids[row, :n] = enc["ids"][0]
            pos[:, row, :n] = enc["pos"][:, 0]
            pos[:, row, n:] = pos[:, row, n - 1:n] + np.arange(1, s - n + 1)
            mask[row, :n] = True
            last[row] = n - 1
            patches.append(enc["patches"])
            grids.extend(enc["grids"])
        vision = prepare_vision_inputs(self.cfg, np.concatenate(patches), grids, self.device)
        probs = yes_prob_at_last(
            self.model, self.cfg, *(torch.from_numpy(x).to(self.device)
                                    for x in (ids, pos, mask, last)),
            self.yes_id, vision,
        )
        for (i, _), p in zip(batch, probs.cpu().tolist()):
            out[i] = float(p)


def run_lmm4asd(
    videos: Sequence[str],
    out_dir: str,
    predictor: TalkingHeadPredictor,
    *,
    node: int = 0,
    num_nodes: int = 1,
    part: Optional[int] = None,
    num_parts: Optional[int] = None,
    chunk_size: int = 12500,
) -> list[str]:
    """Node-sharded chunked Yes-prob run with idempotent resume.

    Mirrors the reference driver (:70-100): optional corpus partition
    (``idxs = range(part, len, num_parts)``, the reference's hardcoded
    part 3 of 4), node-stride sharding, chunked result files of
    ``[idx, prob]`` pairs. A chunk file that already exists is skipped, so
    a crashed run resumes where it stopped (the repo-standard idempotent
    eval-file pattern; the reference gets resume only at whole-run
    granularity).
    """
    os.makedirs(out_dir, exist_ok=True)
    idxs = list(range(len(videos)))
    if part is not None and num_parts:
        idxs = idxs[part::num_parts]
    idxs = idxs[node::num_nodes]
    written = []
    for lo in range(0, len(idxs), chunk_size):
        chunk = idxs[lo:lo + chunk_size]
        path = os.path.join(
            out_dir, f"yes_probs_node{node}-{num_nodes}_chunk{lo}+{chunk_size}.json")
        written.append(path)
        if os.path.exists(path):
            continue
        probs = predictor.predict_probs([videos[i] for i in chunk])
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(list(zip(chunk, probs.tolist())), f)
        os.replace(tmp, path)
    return written


def merge_lmm4asd(out_dir: str) -> dict[int, float]:
    """Merge every chunk file in ``out_dir`` into {video_idx: yes_prob}."""
    merged: dict[int, float] = {}
    for name in sorted(os.listdir(out_dir)):
        if not (name.startswith("yes_probs_") and name.endswith(".json")):
            continue
        with open(os.path.join(out_dir, name)) as f:
            for idx, prob in json.load(f):
                merged[int(idx)] = float(prob)
    return merged
