"""Model-based corpus filters (LM perplexity + LMM talking-head).

Port of ``livecc_tpu/tools/filters.py`` over the port's
``models/qwen2_vl/model.py:forward``. Reference:
  * data/production/lm_loss.py — a small causal LM scores each sample's
    ``title(+previous) -> transcript`` conversation with a PER-SAMPLE mean
    CE (:38-52, explicitly not a batch-mean); keep loss in [1.5, 5] (:94-111)
    to drop both trivial and garbage ASR.
  * data/production/distributed_lmm4asd.py — a small Qwen2-VL is asked
    whether the clip is a talking head; the answer probability is read as
    the softmax of the 'Yes' token at the last position (:61-62).

Both run on the model's device. ``lm_loss_scores`` pads each sample to the
next power of two and runs the uncached forward (K4 on the card) with the
pads as their own segment; its CE is taken from fp32 logits.
``talking_head_prob`` sends only the last position through the LM head.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from livecc_tpu_torch.core.config import ModelConfig
from livecc_tpu_torch.data import chat
from livecc_tpu_torch.data.tokenizer import Tokenizer
from livecc_tpu_torch.models.qwen2_vl.model import Qwen2VL, VisionInputs, forward, get_rope_index
from livecc_tpu_torch.models.qwen2_vl.text import lm_logits


def _device(model: Qwen2VL) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def _per_sample_ce(model: Qwen2VL, cfg: ModelConfig, ids, labels, pos, mask) -> torch.Tensor:
    """Mean CE per sample (not per batch) — lm_loss.py:38-52 semantics."""
    logits, _ = forward(model, cfg, ids, pos, attention_mask=mask)
    shifted = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -100)], dim=1)
    valid = shifted != -100
    safe = torch.where(valid, shifted, 0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    ce = torch.where(valid, logz - gold, 0.0)
    return ce.sum(-1) / valid.sum(-1).clamp(min=1)


def lm_loss_scores(
    model: Qwen2VL,
    cfg: ModelConfig,
    tokenizer: Tokenizer,
    samples: Sequence[dict],
    *,
    max_len: int = 2048,
) -> np.ndarray:
    """Per-sample CE of transcript given title/previous context.

    ``samples`` rows: {"title": ..., "previous": ..., "transcript": ...}.
    """
    device = _device(model)
    out = []
    for sample in samples:
        context = sample.get("title", "")
        if sample.get("previous"):
            context = sample["previous"]
        turns = [
            {"role": "user", "content": [{"type": "text", "text": context}]},
            {"role": "assistant", "content": [{"type": "text", "text": sample["transcript"]}]},
        ]
        text = chat.render_chat(turns)
        ids = np.asarray(tokenizer.encode(text), np.int32)[:max_len][None]
        labels = np.full_like(ids, -100)
        prefix = np.asarray(tokenizer.encode("assistant\n"), np.int32)
        starts = np.where(ids[0] == cfg.im_start_token_id)[0]
        ends = np.where(ids[0] == cfg.im_end_token_id)[0]
        for st, en in zip(starts, ends):
            span = ids[0, st + 1: st + 1 + len(prefix)]
            if len(span) == len(prefix) and np.array_equal(span, prefix):
                labels[0, st + 1 + len(prefix): en + 1] = ids[0, st + 1 + len(prefix): en + 1]
        s = 1 << (ids.shape[1] - 1).bit_length()
        pad = s - ids.shape[1]
        ids_p = np.pad(ids, ((0, 0), (0, pad)))
        labels_p = np.pad(labels, ((0, 0), (0, pad)), constant_values=-100)
        mask = np.pad(np.ones_like(ids, bool), ((0, 0), (0, pad)))
        pos, _ = get_rope_index(cfg, ids_p)
        loss = _per_sample_ce(model, cfg, *(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                                           for x in (ids_p, labels_p, pos, mask)))
        out.append(float(loss[0]))
    return np.asarray(out)


def lm_loss_keep(scores: np.ndarray, lo: float = 1.5, hi: float = 5.0) -> np.ndarray:
    """Keep mask (lm_loss.py:94-111): drop trivial (<1.5) and garbage (>5)."""
    return (scores >= lo) & (scores <= hi)


@torch.no_grad()
def talking_head_prob(
    model: Qwen2VL,
    cfg: ModelConfig,
    tokenizer: Tokenizer,
    vision: VisionInputs,
    grid: tuple[int, int, int],
    *,
    question: str = "Are the visible people always talking heads? Answer Yes or No.",
) -> float:
    """P('Yes') at the last position (distributed_lmm4asd.py:20-62);
    ``vision`` on the model's device (``prepare_vision_inputs``)."""
    content = [{"type": "video", "video": None}, {"type": "text", "text": question}]
    text = chat.render_chat([{"role": "user", "content": content}], add_generation_prompt=True)
    text = chat.expand_vision_placeholders(text, video_grid_thw=[grid])
    ids = np.asarray(tokenizer.encode(text), np.int32)[None]
    pos, _ = get_rope_index(cfg, ids, video_grid_thw=np.asarray([grid]))
    device = _device(model)
    hidden, _ = forward(model, cfg, torch.from_numpy(ids).to(device),
                        torch.from_numpy(np.ascontiguousarray(pos)).to(device), vision=vision,
                        compute_logits=False)
    probs = torch.softmax(lm_logits(model.text, cfg.text, hidden[:, -1:])[0, 0], dim=-1)
    yes_id = tokenizer.encode("Yes")[0]
    return float(probs[yes_id])
