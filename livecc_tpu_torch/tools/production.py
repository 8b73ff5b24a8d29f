"""Data-production pipeline: YT-CC/ASR corpora -> streaming-training JSONL.

A copy of ``livecc_tpu/tools/production.py`` (host code; the port imports
nothing of the JAX package), writing through the port's
``data/lmm_dataset.py:write_seek_index``.

Re-implements the reference's offline corpus tooling (data/production/):

  * ``split_subtitles_to_words``  — pretrain_to_clips.py:15-30: per-word
    timestamps by uniform division of each subtitle span, ``[...]`` notation
    skipped, immediate duplicates removed.
  * ``clips_for_pretrain``        — pretrain_to_clips.py:32-49: greedy 30-240 s
    clip segmentation ending at >3 s word gaps, carrying full ``previous``
    ASR context.
  * ``words_per_second_ok``       — pretrain_to_clips.py:51-57: keep 1-4 wps.
  * ``clips_for_sft``             — sft_to_clips.py: clips must start at
    sentence boundaries.
  * ``to_conversation``           — to_conversation.py:7-24: final Qwen
    conversation rows with ``text_stream`` word triples; the seek index is
    appended by data.lmm_dataset.write_seek_index.
  * ``detect_language``           — language_detect.py:7-30 contract (keep
    en >= 0.9) with a pluggable classifier.
  * ``make_prompt`` / ``is_real_commentary`` — make_prompt.py:11-41: LLM
    query generation + YES/NO commentary filter with a pluggable LLM.
"""

from __future__ import annotations

import json
import re
from typing import Callable, Iterable, Optional, Sequence

Word = tuple[float, float, str]      # (start, end, word)


# ---------------------------------------------------------------------------
# subtitle -> word timestamps
# ---------------------------------------------------------------------------

_NOTATION_RE = re.compile(r"\[[^\]]*\]")


def split_subtitles_to_words(subtitles: Sequence[dict]) -> list[Word]:
    """Uniformly divide each subtitle span across its words.

    ``subtitles`` rows: {start, end (or duration), text}. Bracketed notation
    like [Music] is dropped; a word identical to the previous one at the
    same boundary is deduplicated (auto-caption overlap artifact).
    """
    words: list[Word] = []
    for sub in subtitles:
        text = _NOTATION_RE.sub(" ", sub["text"]).strip()
        tokens = [w for w in text.split() if w]
        if not tokens:
            continue
        start = float(sub["start"])
        end = float(sub["end"]) if "end" in sub else start + float(sub["duration"])
        span = max(end - start, 1e-6)
        step = span / len(tokens)
        for i, tok in enumerate(tokens):
            ws = start + i * step
            we = ws + step
            if words and words[-1][2] == tok and ws <= words[-1][1] + 1e-6:
                continue
            words.append((round(ws, 3), round(we, 3), tok))
    return words


# ---------------------------------------------------------------------------
# clip segmentation
# ---------------------------------------------------------------------------

def clips_for_pretrain(
    words: Sequence[Word],
    *,
    min_duration: float = 30.0,
    max_duration: float = 240.0,
    gap_threshold: float = 3.0,
) -> list[dict]:
    """Greedy clips of 30-240 s, preferring to end at >3 s word gaps;
    each clip carries the full preceding transcript as ``previous``
    (pretrain_to_clips.py:32-49)."""
    clips: list[dict] = []
    i = 0
    n = len(words)
    while i < n:
        start_t = words[i][0]
        j = i
        cut = None
        while j < n:
            dur = words[j][1] - start_t
            if dur > max_duration:
                break
            if dur >= min_duration:
                gap = (words[j + 1][0] - words[j][1]) if j + 1 < n else float("inf")
                if gap > gap_threshold:
                    cut = j
                    break
                if cut is None:
                    cut = j  # fallback: earliest valid end if no gap appears
            j += 1
        if cut is None:
            break  # tail shorter than min_duration
        clip_words = list(words[i:cut + 1])
        clips.append({
            "start": start_t,
            "end": words[cut][1],
            "words": clip_words,
            "previous": " ".join(w for _, _, w in words[:i]),
        })
        i = cut + 1
    return clips


def words_per_second_ok(clip: dict, lo: float = 1.0, hi: float = 4.0) -> bool:
    """Density filter (pretrain_to_clips.py:51-57)."""
    dur = clip["end"] - clip["start"]
    if dur <= 0:
        return False
    wps = len(clip["words"]) / dur
    return lo <= wps <= hi


_SENTENCE_END = re.compile(r"[.!?]$")


def clips_for_sft(words: Sequence[Word], **kwargs) -> list[dict]:
    """SFT clips additionally snap starts to sentence boundaries
    (sft_to_clips.py:9)."""
    clips = clips_for_pretrain(words, **kwargs)
    out = []
    for clip in clips:
        ws = clip["words"]
        k = 0
        # advance to the first word starting a sentence (previous word ends one)
        while k < len(ws):
            idx = words.index(ws[k])
            if idx == 0 or _SENTENCE_END.search(words[idx - 1][2]):
                break
            k += 1
        if k and k < len(ws):
            clip = dict(clip, words=ws[k:], start=ws[k][0])
        if clip["words"] and (clip["end"] - clip["start"]) >= kwargs.get("min_duration", 30.0):
            out.append(clip)
    return out


# ---------------------------------------------------------------------------
# packaging
# ---------------------------------------------------------------------------

def to_conversation(
    video_path: str,
    clip: dict,
    query: str,
    *,
    title: str | None = None,
) -> list[dict]:
    """One training row: user(video window + query) + assistant(text_stream)
    (to_conversation.py:7-24 layout)."""
    user_content = [{
        "type": "video", "video": video_path,
        "video_start": clip["start"], "video_end": clip["end"],
    }, {
        "type": "text", "text": query,
        **({"title": title} if title else {}),
        **({"previous": clip["previous"]} if clip.get("previous") else {}),
    }]
    stream = [[ws, we, w] for ws, we, w in clip["words"]]
    return [
        {"role": "user", "content": user_content},
        {"role": "assistant", "content": [{"type": "text", "text_stream": stream}]},
    ]


def write_corpus(rows: Iterable[list], path: str) -> None:
    """Write conversation rows + the trailing seek index."""
    from livecc_tpu_torch.data.lmm_dataset import write_seek_index

    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    write_seek_index(path)


# ---------------------------------------------------------------------------
# LLM-assisted steps (pluggable clients; the reference hard-wires GPT-4o)
# ---------------------------------------------------------------------------

PROMPT_TEMPLATE = """Given the transcript of a video clip{title_part}, write one short
user query that this commentary would naturally answer. Then on a second
line answer YES if the transcript is real-time commentary of visual events,
or NO otherwise.

Transcript: {transcript}"""


def make_prompt(llm: Callable[[str], str], clip: dict, title: str | None = None) -> tuple[str, bool]:
    """(query, is_real_commentary) via an LLM (make_prompt.py:11-41)."""
    transcript = " ".join(w for _, _, w in clip["words"])
    title_part = f" titled {title!r}" if title else ""
    reply = llm(PROMPT_TEMPLATE.format(title_part=title_part, transcript=transcript))
    lines = [l.strip() for l in reply.strip().splitlines() if l.strip()]
    query = lines[0] if lines else "Please describe the video."
    keep = any(l.upper().startswith("YES") for l in lines[1:]) if len(lines) > 1 else True
    return query, keep


def detect_language(text: str, classifier: Optional[Callable[[str], dict]] = None,
                    keep_lang: str = "en", threshold: float = 0.9) -> bool:
    """Language filter (language_detect.py:7-30 contract). ``classifier``
    returns {lang: prob}; the fallback heuristic approximates 'mostly ASCII
    words' as English."""
    if classifier is not None:
        probs = classifier(text)
        return probs.get(keep_lang, 0.0) >= threshold
    tokens = text.split()
    if not tokens:
        return False
    ascii_ratio = sum(t.isascii() for t in tokens) / len(tokens)
    return ascii_ratio >= threshold
