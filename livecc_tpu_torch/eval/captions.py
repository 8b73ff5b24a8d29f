"""Offline whole-clip caption generation (baseline generator).

Reference: evaluation/livesports3kcc/distributed_generate_caption.py:33-113 —
produce a single caption per event with any VLM (used as the judge's
baseline side). Here the same engine generates it as one QA turn over the
clip (strict-fps sampled, smart_nframes-capped), sharded + resumable like
every other offline job.

A copy of ``livecc_tpu/eval/captions.py`` on the port's engine (the JAX
module's package imports jax); ``tests/test_torch_eval.py`` pins the two to
the same results.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Sequence

import numpy as np

from livecc_tpu_torch.engine.generation import GenerationParams
from livecc_tpu_torch.engine.streaming import LiveCCEngine
from livecc_tpu_torch.eval.mcq import shard_indices

CAPTION_PROMPT = (
    "Please describe this sports video clip in detail, as a complete caption."
)


def generate_captions(
    engine: LiveCCEngine,
    events: Sequence[dict],
    output_dir: str,
    *,
    read_clip: Callable[[dict], np.ndarray],
    worker: int = 0,
    num_workers: int = 1,
    max_new_tokens: int = 128,
    prompt: str = CAPTION_PROMPT,
) -> Optional[str]:
    """One caption per event; returns the merged JSONL path when complete."""
    os.makedirs(output_dir, exist_ok=True)
    gen = GenerationParams(
        max_new_tokens=max_new_tokens,
        eos_token_id=engine.cfg.eos_token_id,
        pad_token_id=engine.cfg.pad_token_id,
        repetition_penalty=1.05,
    )
    for i in shard_indices(len(events), worker, num_workers):
        out_path = os.path.join(output_dir, f"caption_{i}.json")
        if os.path.exists(out_path):
            continue
        event = events[i]
        frames = read_clip(event)
        state = engine.new_stream()
        caption = engine.qa_turn(state, frames, prompt, gen)
        with open(out_path, "w") as f:
            json.dump({"video_id": event.get("video_id"), "event_id": event.get("event_id"),
                       "caption": caption}, f)
    if not all(os.path.exists(os.path.join(output_dir, f"caption_{i}.json"))
               for i in range(len(events))):
        return None
    merged = os.path.join(output_dir, "captions.jsonl")
    with open(merged, "w") as f:
        for i in range(len(events)):
            with open(os.path.join(output_dir, f"caption_{i}.json")) as g:
                f.write(json.dumps(json.load(g)) + "\n")
    return merged
