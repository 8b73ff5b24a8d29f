"""MVBench harness: A-E letters, per-task-type accuracy.

Reference: evaluation/mvbench/distributed_evaluate_mvbench.py — options are
built from each row's candidates with the gold answer's letter recorded, and
accuracy is reported per task type (:113-127). Rows: {video, question,
candidates: [...], answer (text), task_type}.

A copy of ``livecc_tpu/eval/mvbench.py`` on the port's predictor (the JAX
module's package imports jax); ``tests/test_torch_eval.py`` pins the two to
the same results.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Optional

from livecc_tpu_torch.eval.mcq import MCQItem, MCQPredictor, shard_indices

LETTERS = ("A", "B", "C", "D", "E")


def load_items(path: str) -> list[MCQItem]:
    items = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            cands = row["candidates"]
            options = [f"{LETTERS[i]}. {c}" for i, c in enumerate(cands)]
            answer = LETTERS[cands.index(row["answer"])] if row.get("answer") in cands else None
            items.append(MCQItem(
                video=row["video"], question=row["question"], options=options,
                answer=answer, meta={"task_type": row.get("task_type", "unknown")},
            ))
    return items


def score(items: list[MCQItem], predictions: list[str]) -> dict:
    per_task = defaultdict(lambda: [0, 0])
    total = [0, 0]
    for item, pred in zip(items, predictions):
        correct = int(pred == item.answer)
        per_task[item.meta["task_type"]][0] += correct
        per_task[item.meta["task_type"]][1] += 1
        total[0] += correct
        total[1] += 1
    pct = lambda c, n: round(100.0 * c / n, 1) if n else 0.0
    return {
        "overall": pct(*total),
        "n": total[1],
        "task_type": {k: pct(c, n) for k, (c, n) in sorted(per_task.items())},
    }


def run(predictor: MCQPredictor, benchmark_path: str, output_dir: str, *,
        worker: int = 0, num_workers: int = 1, batch_size: int = 1) -> Optional[dict]:
    os.makedirs(output_dir, exist_ok=True)
    items = load_items(benchmark_path)
    idxs = shard_indices(len(items), worker, num_workers)
    shard_file = os.path.join(output_dir, f"mvbench_shard{worker}.json")
    if not os.path.exists(shard_file):
        # letters restricted to the candidate count of each item's group; the
        # predictor scores over the max set and unused letters simply lose.
        preds = predictor.predict([items[i] for i in idxs], letters=LETTERS, batch_size=batch_size)
        with open(shard_file, "w") as f:
            json.dump({str(i): p for i, p in zip(idxs, preds)}, f)
    merged: dict[int, str] = {}
    for w in range(num_workers):
        path = os.path.join(output_dir, f"mvbench_shard{w}.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            merged.update({int(k): v for k, v in json.load(f).items()})
    predictions = [merged[i] for i in range(len(items))]
    report = score(items, predictions)
    with open(os.path.join(output_dir, "mvbench.json"), "w") as f:
        json.dump({"report": report, "predictions": predictions}, f, indent=2)
    return report
