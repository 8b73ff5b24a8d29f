"""Corpus inspection utilities (reference debug.py equivalents).

A copy of ``livecc_tpu/tools/corpus_stats.py`` over the port's
``data/lmm_dataset.py``.

The reference's debug.py is ad-hoc corpus wrangling: category filtering and
statistics over annotation JSONLs, clip preparation, threshold tuning for
the ASD ratio (:6-102). The durable pieces live here as proper functions.
"""

from __future__ import annotations

import json
from collections import Counter, defaultdict
from typing import Callable, Iterator

from livecc_tpu_torch.data.lmm_dataset import read_last_line


def iter_rows(path: str) -> Iterator[dict | list]:
    """Rows of a seek-indexed JSONL (skips the trailing index line)."""
    seeks = set(json.loads(read_last_line(path)))
    with open(path) as f:
        offset = 0
        for line in f:
            if offset in seeks or not seeks:
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    pass
            offset += len(line.encode())


def corpus_stats(path: str, category_key: str = "category") -> dict:
    """Counts + duration/word statistics per category over a corpus."""
    counts: Counter = Counter()
    durations: dict[str, float] = defaultdict(float)
    words: dict[str, int] = defaultdict(int)
    total = 0
    for row in iter_rows(path):
        total += 1
        meta = row[0] if isinstance(row, list) else row
        category = "all"
        if isinstance(meta, dict):
            for el in meta.get("content", []):
                if category_key in el:
                    category = el[category_key]
        counts[category] += 1
        if isinstance(row, list):
            for el in row[0].get("content", []):
                if "video_start" in el and "video_end" in el:
                    durations[category] += float(el["video_end"]) - float(el["video_start"])
            for msg in row:
                if msg.get("role") == "assistant":
                    for el in msg["content"]:
                        if "text_stream" in el:
                            words[category] += len(el["text_stream"])
    return {
        "total": total,
        "by_category": dict(counts),
        "duration_s": {k: round(v, 1) for k, v in durations.items()},
        "stream_words": dict(words),
    }


def filter_corpus(
    path: str,
    output_path: str,
    keep: Callable[[dict | list], bool],
) -> int:
    """Write the rows passing ``keep`` + a fresh seek index; returns count."""
    from livecc_tpu_torch.data.lmm_dataset import write_seek_index

    n = 0
    with open(output_path, "w") as out:
        for row in iter_rows(path):
            if keep(row):
                out.write(json.dumps(row) + "\n")
                n += 1
    write_seek_index(output_path)
    return n
