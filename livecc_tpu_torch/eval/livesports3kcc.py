"""LiveSports-3K CC generation harness + pairwise LLM judge.

Reference: evaluation/livesports3kcc/ —
  * distributed_generate_livecc.py: per-event commentator prompt from title/
    preceding ASR (:69-82), chunked streaming generation over [begin, end]
    via live_cc_once_for_evaluation (max_new_tokens=32, repetition 1.15),
    per-chunk texts joined with the ' ...' marker stripped (:91-94),
    per-item JSON files for idempotent resume, stride worker sharding;
  * llm_judge.py: pairwise A/B comparison against a baseline captioner with
    ground-truth ASR as referee, judged in BOTH orderings; win rate over
    2N comparisons (:26-68,108-117). The judge LLM is a pluggable callable
    here (the reference hard-wires Azure GPT-4o, unavailable offline).

A copy of ``livecc_tpu/eval/livesports3kcc.py`` on the port's engine (the
JAX module's package imports jax); ``tests/test_torch_eval.py`` pins the two
to the same results.
"""

from __future__ import annotations

import json
import os
import re
from typing import Callable, Optional, Sequence

from livecc_tpu_torch.engine.streaming import LiveCCEngine
from livecc_tpu_torch.eval.mcq import shard_indices


def build_commentary_query(title: str | None, previous_asr: str | None,
                           instruct: bool = True) -> str:
    """Commentator prompt (reference :69-82 semantics)."""
    context = ""
    if title:
        context += f"The video is about: {title}\n"
    if previous_asr:
        context += f"Previous commentary: {previous_asr}\n"
    if instruct:
        return (
            f"{context}You are an excellent live sports commentator. "
            "Please provide real-time commentary for the current video clip."
        )
    return context.strip()


def join_commentary(responses: list[list]) -> str:
    """Join per-chunk texts, stripping the ' ...' streaming marker
    (reference :91-94)."""
    parts = []
    for _, _, text in responses:
        text = re.sub(r"\s*\.\.\.\s*$", "", text).strip()
        if text:
            parts.append(text)
    return " ".join(parts)


def generate(
    engine: LiveCCEngine,
    events: Sequence[dict],
    output_dir: str,
    *,
    read_clip: Callable[[dict], "object"],
    worker: int = 0,
    num_workers: int = 1,
    max_new_tokens: int = 32,
    repetition_penalty: float = 1.15,
    instruct: bool = True,
) -> Optional[str]:
    """Generate commentary for every event (sharded, resumable).

    ``events`` rows: {video_id, event_id, begin, end, title, preASR, video}.
    ``read_clip(event) -> frames [T, H, W, 3] uint8`` decodes + resizes the
    event window at strict 2 fps. Returns the merged JSONL path once all
    shards finished.
    """
    os.makedirs(output_dir, exist_ok=True)
    idxs = shard_indices(len(events), worker, num_workers)
    for i in idxs:
        out_path = os.path.join(output_dir, f"event_{i}.json")
        if os.path.exists(out_path):        # idempotent resume (:56-58)
            continue
        event = events[i]
        query = build_commentary_query(event.get("title"), event.get("preASR"), instruct)
        frames = read_clip(event)
        responses = engine.live_cc_once_for_evaluation(
            query, frames, video_start=float(event.get("begin", 0.0)),
            max_new_tokens=max_new_tokens, repetition_penalty=repetition_penalty,
        )
        record = {
            "video_id": event.get("video_id"),
            "event_id": event.get("event_id"),
            "begin": event.get("begin"),
            "end": event.get("end"),
            "pred": join_commentary(responses),
            "chunks": responses,
        }
        with open(out_path, "w") as f:
            json.dump(record, f)
    # merge once every event file exists
    if not all(os.path.exists(os.path.join(output_dir, f"event_{i}.json")) for i in range(len(events))):
        return None
    merged = os.path.join(output_dir, "predictions.jsonl")
    with open(merged, "w") as f:
        for i in range(len(events)):
            with open(os.path.join(output_dir, f"event_{i}.json")) as g:
                f.write(json.dumps(json.load(g)) + "\n")
    return merged


JUDGE_TEMPLATE = """You are comparing two live sports commentaries against the \
ground-truth human commentary (ASR transcript) of the same clip.

Ground truth: {ground_truth}

Commentary A: {a}

Commentary B: {b}

Which commentary is more semantically similar to the ground truth? \
Reply with exactly one letter: A or B."""


def judge_pair(llm: Callable[[str], str], ground_truth: str, ours: str, baseline: str) -> int:
    """Both-orderings pairwise judgment (reference llm_judge.py:26-68).
    Returns wins for `ours` out of 2 comparisons."""
    wins = 0
    r1 = llm(JUDGE_TEMPLATE.format(ground_truth=ground_truth, a=ours, b=baseline)).strip().upper()
    if r1[:1] == "A":
        wins += 1
    r2 = llm(JUDGE_TEMPLATE.format(ground_truth=ground_truth, a=baseline, b=ours)).strip().upper()
    if r2[:1] == "B":
        wins += 1
    return wins


def win_rate(
    llm: Callable[[str], str],
    ours: dict[str, str],         # event_id -> commentary
    baseline: dict[str, str],     # event_id -> baseline caption
    ground_truth: dict[str, str], # event_id -> GT ASR
) -> float:
    """Win rate over 2N comparisons (reference llm_judge.py:108-117)."""
    total = wins = 0
    for event_id, pred in ours.items():
        if event_id not in baseline or event_id not in ground_truth:
            continue
        wins += judge_pair(llm, ground_truth[event_id], pred, baseline[event_id])
        total += 2
    return wins / total if total else 0.0


def tally_win_rate(records: Sequence[dict], model_id: str) -> float:
    """Win rate (percent) from recorded per-event winner rows — the exact
    tally of reference llm_judge.py:108-117: each row carries ``ab_winner``
    and ``ba_winner`` (the judged winner under both orderings); every row
    contributes 2 comparisons."""
    win_count = count = 0
    for row in records:
        if row["ab_winner"] == model_id:
            win_count += 1
        if row["ba_winner"] == model_id:
            win_count += 1
        count += 2
    return win_count / count * 100 if count else 0.0


def win_rate_log_line(records: Sequence[dict], model_id: str, baseline_id: str) -> str:
    """The reference's judges/log.txt line format (llm_judge.py:118-120)."""
    rate = tally_win_rate(records, model_id)
    return f"Winning Rate for {model_id} vs. {baseline_id}: {rate:.2f}%"
