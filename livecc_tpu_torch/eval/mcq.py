"""MCQ predictor: single-forward letter scoring.

Port of ``livecc_tpu/eval/mcq.py`` (the reference's generic MCQ harness,
evaluation/distributed_mcq_predictor.py):

  * each item renders as a chat conversation [video + question + options]
    with the answer prefix (default ``Answer:``) appended AFTER the
    generation prompt (reference :52-70): the model is scored, not sampled;
  * ONE uncached forward per group of items: the final hidden state at the
    last real token goes through the LM head alone (``mcq_letter_logits``,
    ``[B, L]`` over the option letters' token ids, ``tokenizer(': X')[-1]``,
    reference :72-73,90); the argmax over them is the prediction;
  * items are batched over right-padded sequence buckets (``SEQ_BUCKETS``);
    several workers shard items by stride and merge result files
    (reference idx[rank::world] pattern, ``shard_indices``).

Frames, patches, token ids and positions are built on the host as in JAX;
a group's tensors go to the model's device once. On the card the ViT runs
K3's group form (every clip of an item shares one grid) and the text tower
K4's forward, the bool pad mask as segments 0/1; on the CPU their plain
versions. JAX's harness takes XLA's plain attention for the same function
(``forward(use_flash=False)``): real rows are the same, pad rows differ and
nothing reads them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from livecc_tpu_torch.core.config import ModelConfig
from livecc_tpu_torch.data import chat
from livecc_tpu_torch.data.tokenizer import Tokenizer
from livecc_tpu_torch.models.qwen2_vl.model import (
    Qwen2VL, VisionInputs, forward, get_rope_index, prepare_vision_inputs)
from livecc_tpu_torch.models.qwen2_vl.text import lm_logits
from livecc_tpu_torch.vision_io.budget import VisionBudget, linspace_sample, smart_nframes
from livecc_tpu_torch.vision_io.patchify import patchify_video

SEQ_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 32768)


@dataclasses.dataclass
class MCQItem:
    """One multiple-choice question over a video."""

    video: str                         # path
    question: str
    options: list[str]                 # rendered option lines ("A. ...", ...)
    answer: str | None = None          # gold letter
    meta: dict = dataclasses.field(default_factory=dict)
    subtitles: str | None = None
    video_start: float | None = None
    video_end: float | None = None


def build_mcq_text(item: MCQItem, answer_prefix: str = "Answer:") -> str:
    """Conversation text with the scored-answer prefix after the generation
    prompt (reference distributed_mcq_predictor.py:33-50,63-66)."""
    lines = [item.question, *item.options]
    content = []
    if item.subtitles:
        content.append({"type": "text", "text": f"Subtitles: {item.subtitles}\n"})
    content.append({"type": "video", "video": item.video})
    content.append({
        "type": "text",
        "text": "\n".join(lines) + "\nAnswer with the option's letter from the given choices directly.",
    })
    text = chat.render_chat([{"role": "user", "content": content}], add_generation_prompt=True)
    return text + answer_prefix


def letter_token_ids(tokenizer: Tokenizer, letters: Sequence[str]) -> list[int]:
    """Token id of each letter as it appears after 'Answer:' (reference :90)."""
    return [tokenizer.encode(f": {letter}")[-1] for letter in letters]


def mcq_letter_logits(
    model: Qwen2VL,
    cfg: ModelConfig,
    ids: torch.Tensor,                # [B, S] right-padded
    position_ids: torch.Tensor,       # [3, B, S]
    attention_mask: torch.Tensor,     # [B, S] bool
    last_idx: torch.Tensor,           # [B] index of last real token
    letter_ids: torch.Tensor,         # [L]
    vision: Optional[VisionInputs] = None,
) -> torch.Tensor:
    """fp32 ``[B, L]`` logits of the letters at each row's last real token.
    Only that position goes through the LM head (full logits would be
    ``[B, S, 152k]``)."""
    hidden, _ = forward(model, cfg, ids, position_ids, vision=vision,
                        attention_mask=attention_mask, compute_logits=False)
    last_hidden = hidden[torch.arange(ids.shape[0], device=ids.device), last_idx]   # [B, H]
    last = lm_logits(model.text, cfg.text, last_hidden[:, None, :])[:, 0]
    return last[:, letter_ids]


def mcq_logits_at_last(model, cfg, ids, position_ids, attention_mask, last_idx, letter_ids,
                       vision=None) -> torch.Tensor:
    """[B] argmax index into ``letter_ids`` (JAX ``mcq_logits_at_last``)."""
    return mcq_letter_logits(model, cfg, ids, position_ids, attention_mask, last_idx,
                             letter_ids, vision).argmax(dim=-1)


class MCQPredictor:
    """Batched single-forward MCQ scoring over a video benchmark, on the
    model's device."""

    def __init__(
        self,
        model: Qwen2VL,
        cfg: ModelConfig,
        tokenizer: Tokenizer,
        *,
        budget: VisionBudget | None = None,
        max_frames: int | None = 64,
        video_loader=None,
        answer_prefix: str = "Answer:",
    ):
        self.model = model
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = next(model.parameters()).device
        self.budget = budget or VisionBudget()
        self.max_frames = max_frames
        self.answer_prefix = answer_prefix
        if video_loader is None:
            from livecc_tpu_torch.vision_io.video_reader import VideoReader
            video_loader = VideoReader
        self.video_loader = video_loader

    def _read_video(self, item: MCQItem):
        """Frame read with degenerate-video handling.

        Mirrors the reference's OVOBench reader
        (evaluation/ovobench/distributed_evaluate_ovobench.py:12-59,
        ``_read_may1fps_video_decord``): the [video_start, video_end] window
        is clamped into the PTS range with end >= start+1 s (:38-42), and for
        <2-frame clips or sub-FPS videos the frame count fed to smart_nframes
        is inflated (:49-56) so sampling never collapses to zero — indices
        then repeat over the real frames.
        """
        if os.path.isdir(item.video):
            return self._read_frame_dir(item.video)
        reader = self.video_loader(item.video)
        pts = reader.pts_seconds
        base = np.arange(len(pts))
        if item.video_start is not None or item.video_end is not None:
            lo = pts[0] if not item.video_start else item.video_start
            hi = pts[-1] if not item.video_end else item.video_end
            lo = min(max(pts[0], lo), pts[-1])
            hi = min(max(pts[0], hi), pts[-1])
            hi = max(lo + 1.0, hi)
            base = np.where((pts >= lo) & (pts <= hi))[0]
            if len(base) == 0:
                # window falls between sparse PTS samples: nearest frame
                base = np.array([int(np.argmin(np.abs(pts - lo)))])
        total = len(base)
        fps_v = reader.avg_fps
        total_for, fps_for = total, fps_v
        if total < 2:
            total_for = 2
        if 0 < fps_v < self.budget.fps:
            # Inflate from the ALREADY-clamped count, floored at 2: the
            # reference's expression uses the raw count
            # (distributed_evaluate_ovobench.py:52), which degenerates to
            # 1 for a 1-frame window of a 1-2 fps video and crashes
            # smart_nframes — this harness must survive such items.
            total_for = max(int(total_for * self.budget.fps / fps_v), 2)
            fps_for = self.budget.fps
        n = smart_nframes(total_for, fps_for,
                          max_frames=self.max_frames, budget=self.budget)
        idxs = base[linspace_sample(total, n)]
        h, w = reader.frame_size
        rh, rw = self.budget.spatial_target(h, w, nframes=n)
        return reader.get_batch(idxs, out_hw=(rh, rw))

    def _read_frame_dir(self, path: str):
        """Frame-directory items (MVBench tvqa: per-frame images sampled with
        smart_nframes then resized — reference
        evaluation/mvbench/distributed_evaluate_mvbench.py:44-51)."""
        from PIL import Image

        files = sorted(
            f for f in os.listdir(path)
            if f.lower().endswith((".jpg", ".jpeg", ".png"))
        )
        if not files:
            raise IOError(f"no frames in {path}")
        n = smart_nframes(len(files), self.budget.fps,
                          max_frames=self.max_frames, budget=self.budget)
        keep = linspace_sample(len(files), n)
        first = Image.open(os.path.join(path, files[keep[0]])).convert("RGB")
        rh, rw = self.budget.spatial_target(first.height, first.width, nframes=n)
        frames = []
        for i in keep:
            img = Image.open(os.path.join(path, files[i])).convert("RGB")
            frames.append(np.asarray(img.resize((rw, rh), Image.BICUBIC)))
        return np.stack(frames)

    def encode_item(self, item: MCQItem) -> dict:
        """Host work of one item: frames, patches, ids [1, n], positions [3, 1, n]."""
        frames = self._read_video(item)
        patches, grid = patchify_video(np.transpose(frames, (0, 3, 1, 2)))
        text = build_mcq_text(item, self.answer_prefix)
        text = chat.expand_vision_placeholders(text, video_grid_thw=[grid])
        ids = np.asarray(self.tokenizer.encode(text), np.int32)[None]
        pos, _ = get_rope_index(self.cfg, ids, video_grid_thw=np.asarray([grid]))
        return {"ids": ids, "pos": pos, "patches": patches, "grid": grid}

    def predict(
        self,
        items: Sequence[MCQItem],
        letters: Sequence[str] = ("A", "B", "C", "D"),
        batch_size: int = 1,
    ) -> list[str]:
        """Predicted letter per item (one worker; shard items externally)."""
        out: list[str] = []
        for start in range(0, len(items), batch_size):
            group = [self.encode_item(x) for x in items[start:start + batch_size]]
            logits = self.letter_logits(group, letters)
            out.extend(letters[int(i)] for i in logits.argmax(dim=-1).tolist())
        return out

    def group_inputs(self, group: list[dict]) -> dict:
        """A group of encoded items as the forward's inputs on the model's
        device: ids right-padded to the bucket, positions continued over the
        pads, the pads' mask, the last real index and the ViT inputs."""
        b = len(group)
        s = _bucket(max(g["ids"].shape[1] for g in group))
        ids = np.zeros((b, s), np.int32)
        pos = np.zeros((3, b, s), np.int32)
        mask = np.zeros((b, s), bool)
        last = np.zeros((b,), np.int64)
        patches, grids = [], []
        for i, g in enumerate(group):
            n = g["ids"].shape[1]
            ids[i, :n] = g["ids"][0]
            pos[:, i, :n] = g["pos"][:, 0]
            pos[:, i, n:] = pos[:, i, n - 1:n] + np.arange(1, s - n + 1)
            mask[i, :n] = True
            last[i] = n - 1
            patches.append(g["patches"])
            grids.append(g["grid"])
        dev = self.device
        return {
            "ids": torch.from_numpy(ids).to(dev),
            "position_ids": torch.from_numpy(pos).to(dev),
            "attention_mask": torch.from_numpy(mask).to(dev),
            "last_idx": torch.from_numpy(last).to(dev),
            "vision": prepare_vision_inputs(self.cfg, np.concatenate(patches), grids, dev),
        }

    @torch.inference_mode()
    def letter_logits(self, group: list[dict], letters: Sequence[str]) -> torch.Tensor:
        """fp32 ``[B, L]`` letter logits of a group of encoded items."""
        lids = torch.tensor(letter_token_ids(self.tokenizer, letters), dtype=torch.long,
                            device=self.device)
        x = self.group_inputs(group)
        return mcq_letter_logits(self.model, self.cfg, x["ids"], x["position_ids"],
                                 x["attention_mask"], x["last_idx"], lids, vision=x["vision"])


def _bucket(n: int) -> int:
    for b in SEQ_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"sequence of {n} tokens exceeds {SEQ_BUCKETS[-1]}")


def shard_indices(n: int, worker: int, num_workers: int) -> list[int]:
    """Reference worker sharding: idxs[worker::num_workers]
    (distributed_generate_livecc.py:50-51)."""
    return list(range(worker, n, num_workers))
