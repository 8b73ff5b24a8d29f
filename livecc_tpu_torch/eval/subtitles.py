"""Subtitle utilities: .srt parsing + merging into benchmark rows.

Reference: evaluation/videomme/add_subtitle.py — attach each video's
subtitle text to its benchmark entries for the with-subtitles track.

A copy of ``livecc_tpu/eval/subtitles.py`` (the JAX module's package imports
jax); ``tests/test_torch_eval.py`` pins the two to the same results.
"""

from __future__ import annotations

import json
import os
import re

_TS = re.compile(r"(\d+):(\d+):(\d+)[,.](\d+)")


def _seconds(ts: str) -> float:
    h, m, s, ms = _TS.match(ts).groups()
    return int(h) * 3600 + int(m) * 60 + int(s) + int(ms) / 1000


def parse_srt(path: str) -> list[dict]:
    """[.srt] -> [{start, end, text}] (tag-stripped)."""
    blocks = re.split(r"\n\s*\n", open(path, encoding="utf-8", errors="replace").read())
    out = []
    for block in blocks:
        lines = [l.strip() for l in block.strip().splitlines() if l.strip()]
        if len(lines) < 2 or "-->" not in "".join(lines[:2]):
            continue
        ts_line = lines[1] if "-->" in lines[1] else lines[0]
        text_lines = lines[2:] if "-->" in lines[1] else lines[1:]
        start_s, end_s = [x.strip() for x in ts_line.split("-->")]
        text = re.sub(r"<[^>]+>", "", " ".join(text_lines)).strip()
        if text:
            out.append({"start": _seconds(start_s), "end": _seconds(end_s), "text": text})
    return out


def srt_text(path: str) -> str:
    return " ".join(e["text"] for e in parse_srt(path))


def add_subtitles(benchmark_path: str, srt_dir: str, output_path: str,
                  key: str = "video_id") -> int:
    """Merge per-video .srt files into a benchmark JSONL; returns #matched."""
    matched = 0
    with open(benchmark_path) as f, open(output_path, "w") as out:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            srt = os.path.join(srt_dir, f"{row.get(key)}.srt")
            if os.path.exists(srt):
                row["subtitles"] = srt_text(srt)
                matched += 1
            out.write(json.dumps(row) + "\n")
    return matched
