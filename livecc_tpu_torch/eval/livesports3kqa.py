"""LiveSports-3K QA harness: A-D MCQ + per-question-type / OCR accuracy.

Reference: evaluation/livesports3kqa/distributed_evaluate_livesports3kqa.py —
mcq_predict over A-D with accuracy reported per q_type and for the
OCR-dependent subset (:7-28). Rows: {video, question, options, answer,
q_type, ocr (bool)}.

A copy of ``livecc_tpu/eval/livesports3kqa.py`` on the port's predictor (the
JAX module's package imports jax); ``tests/test_torch_eval.py`` pins the two
to the same results.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Optional

from livecc_tpu_torch.eval.mcq import MCQItem, MCQPredictor, shard_indices

LETTERS = ("A", "B", "C", "D")


def load_items(path: str) -> list[MCQItem]:
    items = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            items.append(MCQItem(
                video=row["video"], question=row["question"], options=row["options"],
                answer=row.get("answer"),
                video_start=row.get("begin"), video_end=row.get("end"),
                meta={"q_type": row.get("q_type", "unknown"), "ocr": bool(row.get("ocr", False))},
            ))
    return items


def score(items: list[MCQItem], predictions: list[str]) -> dict:
    per_type = defaultdict(lambda: [0, 0])
    ocr = [0, 0]
    total = [0, 0]
    for item, pred in zip(items, predictions):
        correct = int(pred == item.answer)
        total[0] += correct
        total[1] += 1
        per_type[item.meta["q_type"]][0] += correct
        per_type[item.meta["q_type"]][1] += 1
        if item.meta["ocr"]:
            ocr[0] += correct
            ocr[1] += 1
    pct = lambda c, n: round(100.0 * c / n, 1) if n else 0.0
    return {
        "overall": pct(*total), "n": total[1],
        "q_type": {k: pct(c, n) for k, (c, n) in sorted(per_type.items())},
        "ocr_subset": pct(*ocr),
    }


def run(predictor: MCQPredictor, benchmark_path: str, output_dir: str, *,
        worker: int = 0, num_workers: int = 1, batch_size: int = 1) -> Optional[dict]:
    os.makedirs(output_dir, exist_ok=True)
    items = load_items(benchmark_path)
    idxs = shard_indices(len(items), worker, num_workers)
    shard_file = os.path.join(output_dir, f"ls3kqa_shard{worker}.json")
    if not os.path.exists(shard_file):
        preds = predictor.predict([items[i] for i in idxs], letters=LETTERS, batch_size=batch_size)
        with open(shard_file, "w") as f:
            json.dump({str(i): p for i, p in zip(idxs, preds)}, f)
    merged: dict[int, str] = {}
    for w in range(num_workers):
        path = os.path.join(output_dir, f"ls3kqa_shard{w}.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            merged.update({int(k): v for k, v in json.load(f).items()})
    predictions = [merged[i] for i in range(len(items))]
    report = score(items, predictions)
    with open(os.path.join(output_dir, "livesports3kqa.json"), "w") as f:
        json.dump({"report": report, "predictions": predictions}, f, indent=2)
    return report
