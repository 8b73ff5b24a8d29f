"""VideoMME benchmark harness + official scorer.

Reference: evaluation/videomme/distributed_evaluate_videomme.py (driver) and
evaluation/videomme/eval_your_results.py (the official VideoMME scorer):
letter extraction from free-form answers, category/sub-category/task-type
taxonomies with answer-set validation, and the fixed-format text report.
``official_report`` reproduces the official scorer's output byte-for-byte —
tested against the reference's committed result files
(results/LiveCC-7B-Instruct_*.txt).

Benchmark rows (JSONL): {video_id, duration, domain, sub_category, videoID,
task_type, question_id, question, options: ["A. ...", ...], answer,
video (local path), subtitles (optional)}.

A copy of ``livecc_tpu/eval/videomme.py`` on the port's predictor (the JAX
module's package imports jax); ``tests/test_torch_eval.py`` pins the two to
the same results.
"""

from __future__ import annotations

import json
import os
import re
from collections import defaultdict
from typing import Optional, Sequence

from livecc_tpu_torch.eval.mcq import MCQItem, MCQPredictor, shard_indices

LETTERS = ("A", "B", "C", "D")

# Official taxonomies (eval_your_results.py:8-63). Unknown values raise —
# the official scorer validates by keying pre-built tables.
CATEGORIES = (
    "Knowledge", "Film & Television", "Sports Competition",
    "Artistic Performance", "Life Record", "Multilingual",
)
SUB_CATEGORIES = (
    "Humanity & History", "Literature & Art", "Biology & Medicine",
    "Finance & Commerce", "Astronomy", "Geography", "Law", "Life Tip",
    "Technology", "Animation", "Movie & TV Show", "Documentary",
    "News Report", "Esports", "Basketball", "Football", "Athletics",
    "Other Sports", "Stage Play", "Magic Show", "Variety Show", "Acrobatics",
    "Handicraft", "Food", "Fashion", "Daily Life", "Travel", "Pet & Animal",
    "Exercise", "Multilingual",
)
TASK_CATEGORIES = (
    "Temporal Perception", "Spatial Perception", "Attribute Perception",
    "Action Recognition", "Object Recognition", "OCR Problems",
    "Counting Problem", "Temporal Reasoning", "Spatial Reasoning",
    "Action Reasoning", "Object Reasoning", "Information Synopsis",
)

# eval_your_results.py:68-81 — NOTE: the official list has two missing commas,
# fusing four entries into two via adjacent-literal concatenation; the fused
# strings never match, so this is the scorer's *effective* prefix set.
_OFFICIAL_PREFIXES = (
    "The best answer is",
    "The correct answer is",
    "The answer is",
    "The answer",
    "The best option isThe correct option is",
    "Best answer:Best option:",
    "Answer:",
    "Option:",
    "The correct answer",
    "The correct option",
)


def extract_official(response: str) -> str:
    """Official letter extraction (eval_your_results.py:66-90): strip answer
    prefixes, bail on long letter-free prose, else first A-D hit."""
    s = response.strip()
    for prefix in _OFFICIAL_PREFIXES:
        s = s.replace(prefix, "")
    if len(s.split()) > 10 and not re.search("[ABCD]", s):
        return ""
    m = re.search(r"[ABCD]", s)
    return m[0] if m else ""


def load_items(path: str, with_subtitles: bool = False) -> list[MCQItem]:
    items = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            items.append(MCQItem(
                video=row["video"],
                question=row["question"],
                options=row["options"],
                answer=row.get("answer"),
                subtitles=row.get("subtitles") if with_subtitles else None,
                meta={k: row.get(k) for k in
                      ("video_id", "duration", "domain", "sub_category", "task_type", "question_id")},
            ))
    return items


def extract_letter(response: str, letters: Sequence[str] = LETTERS) -> str | None:
    """Official scorer's robust letter extraction (eval_your_results.py:66-90
    behavior): accept 'A', 'A.', '(A)', 'Answer: A', ... first match wins."""
    if not response:
        return None
    response = response.strip()
    group = "".join(letters)
    for pattern in (
        rf"^\(?([{group}])\)?[.:,)]?$",
        rf"[Aa]nswer\s*(?:is)?\s*:?\s*\(?([{group}])\)?",
        rf"^\(?([{group}])\)?[.:,)]",
        rf"\b([{group}])\b",
    ):
        m = re.search(pattern, response)
        if m:
            return m.group(1)
    return None


def score(items: list[MCQItem], predictions: list[str]) -> dict:
    """Accuracy report grouped the way the official scorer reports."""
    overall = defaultdict(lambda: [0, 0])
    groups = {"duration": defaultdict(lambda: [0, 0]),
              "domain": defaultdict(lambda: [0, 0]),
              "sub_category": defaultdict(lambda: [0, 0]),
              "task_type": defaultdict(lambda: [0, 0])}
    for item, pred in zip(items, predictions):
        letter = extract_letter(pred) or ""
        correct = int(letter == item.answer)
        overall["all"][0] += correct
        overall["all"][1] += 1
        for key, table in groups.items():
            val = item.meta.get(key)
            if val is not None:
                table[val][0] += correct
                table[val][1] += 1
    def pct(c, n):
        return round(100.0 * c / n, 1) if n else 0.0
    report = {"overall": pct(*overall["all"]), "n": overall["all"][1]}
    for key, table in groups.items():
        report[key] = {k: pct(c, n) for k, (c, n) in sorted(table.items())}
    return report


def group_results(items: list[MCQItem], predictions: list[str]) -> list[dict]:
    """Letters -> the official per-video results structure
    (distributed_evaluate_videomme.py:57-78): one record per video with a
    ``questions`` list whose ``response`` is the chosen option line."""
    by_vid: dict[str, dict] = {}
    for item, letter in zip(items, predictions):
        meta = item.meta
        rec = by_vid.setdefault(meta["video_id"], {
            "video_id": meta["video_id"],
            "duration": meta["duration"],
            "domain": meta["domain"],
            "sub_category": meta["sub_category"],
            "questions": [],
        })
        response = next(
            (o for o in (item.options or []) if o.strip().startswith(str(letter))),
            str(letter),
        )
        rec["questions"].append({
            "question_id": meta.get("question_id"),
            "task_type": meta["task_type"],
            "question": item.question,
            "options": list(item.options or []),
            "answer": item.answer,
            "response": response,
        })
    return list(by_vid.values())


def official_report(
    results: list[dict],
    video_types: Sequence[str] = ("short", "medium", "long"),
    *,
    skip_missing: bool = False,
    expected_per_type: int | None = None,
) -> str:
    """The official scorer's text report, byte-identical
    (eval_your_results.py:92-279 with all three accuracy sections on, the
    way distributed_evaluate_videomme.py:96-104 invokes it)."""
    tables = {
        vt: {
            "task": {q: [0, 0] for q in TASK_CATEGORIES},
            "cat": {c: [0, 0] for c in CATEGORIES},
            "sub": {s: [0, 0] for s in SUB_CATEGORIES},
        }
        for vt in video_types
    }
    for vt in video_types:
        rows = [r for r in results if r["duration"] == vt]
        if expected_per_type is not None and len(rows) != expected_per_type:
            raise ValueError(f"{vt}: {len(rows)} videos != {expected_per_type}")
        for row in rows:
            if skip_missing and row.get("missing"):
                continue
            t = tables[vt]
            for q in row["questions"]:
                letter = extract_official(q["response"])
                if letter == "":
                    continue  # unanswered: excluded from the denominator
                hit = int(letter == q["answer"])
                for table, key in ((t["task"], q["task_type"]),
                                   (t["cat"], row["domain"]),
                                   (t["sub"], row["sub_category"])):
                    table[key][0] += hit   # validates key membership (KeyError)
                    table[key][1] += 1

    pct = lambda c, a: f"{(100 * c / a if a > 0 else 0): .1f}%"
    bar = "-------------------------------------"
    eq = "====================================="
    lines: list[str] = []

    def section(title: str, rows: list[tuple[str, int, int]]) -> None:
        lines.extend([bar, title, bar])
        lines.extend(f"{name}: {pct(c, a)}" for name, c, a in rows)

    for vt in video_types:
        t = tables[vt]
        lines.extend([eq, f"Evaluation on video Type: {vt}", eq])
        section("Video Categories", [(k, *v) for k, v in t["cat"].items()])
        section("Video Sub Categories", [(k, *v) for k, v in t["sub"].items()])
        section("Task Categories", [(k, *v) for k, v in t["task"].items()])
        total_c = sum(v[0] for v in t["task"].values())
        total_a = sum(v[1] for v in t["task"].values())
        section("Overall Performance", [("Overall", total_c, total_a)])
        lines.extend(["", ""])  # the scorer's print("\n") spacer

    def across(kind: str) -> list[tuple[str, int, int]]:
        keys = {"cat": CATEGORIES, "sub": SUB_CATEGORIES, "task": TASK_CATEGORIES}[kind]
        return [
            (k,
             sum(tables[vt][kind][k][0] for vt in video_types),
             sum(tables[vt][kind][k][1] for vt in video_types))
            for k in keys
        ]

    lines.extend([eq, "Evaluation on the entire dataset", eq])
    section("Video Domains", across("cat"))
    section("Video Sub Categories", across("sub"))
    section("Task Categories", across("task"))
    total_c = sum(tables[vt]["task"][q][0] for vt in video_types for q in TASK_CATEGORIES)
    total_a = sum(tables[vt]["task"][q][1] for vt in video_types for q in TASK_CATEGORIES)
    section("Overall Performance", [("Overall", total_c, total_a)])
    return "\n".join(lines) + "\n"


def run(
    predictor: MCQPredictor,
    benchmark_path: str,
    output_dir: str,
    *,
    with_subtitles: bool = False,
    worker: int = 0,
    num_workers: int = 1,
    batch_size: int = 1,
) -> Optional[dict]:
    """Shard-predict-merge-score. Returns the report on worker 0 once all
    shards exist (idempotent resume via per-shard files, the reference's
    per-idx output pattern)."""
    os.makedirs(output_dir, exist_ok=True)
    items = load_items(benchmark_path, with_subtitles)
    idxs = shard_indices(len(items), worker, num_workers)
    shard_file = os.path.join(output_dir, f"videomme_shard{worker}.json")
    if not os.path.exists(shard_file):
        preds = predictor.predict([items[i] for i in idxs], letters=LETTERS, batch_size=batch_size)
        with open(shard_file, "w") as f:
            json.dump({str(i): p for i, p in zip(idxs, preds)}, f)
    merged: dict[int, str] = {}
    for w in range(num_workers):
        path = os.path.join(output_dir, f"videomme_shard{w}.json")
        if not os.path.exists(path):
            return None  # other shards still running
        with open(path) as f:
            merged.update({int(k): v for k, v in json.load(f).items()})
    predictions = [merged[i] for i in range(len(items))]
    report = score(items, predictions)
    tag = "with_subtitles" if with_subtitles else "no_subtitles"
    with open(os.path.join(output_dir, f"videomme_{tag}.json"), "w") as f:
        json.dump({"report": report, "predictions": predictions}, f, indent=2)
    # Official artifacts: grouped per-video results + the official text
    # report (distributed_evaluate_videomme.py:84-104 output contract).
    results = group_results(items, predictions)
    video_types = [vt for vt in ("short", "medium", "long")
                   if any(r["duration"] == vt for r in results)]
    with open(os.path.join(output_dir, f"results_{tag}.json"), "w") as f:
        json.dump(results, f)
    with open(os.path.join(output_dir, f"results_{tag}.txt"), "w") as f:
        f.write(official_report(results, video_types))
    return report
