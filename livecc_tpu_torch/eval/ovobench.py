"""OVOBench harness: online-video probes with Real-Time / Backward / Forward
tracing score groups.

Reference: evaluation/ovobench/ — transfer_annotation_format.py:4-59 expands
each REC/SSR/CRR ``test_info`` probe into a standalone item whose video
window is [0, realtime] with Yes/No or digit answers; the harness scores
options [No, Yes, 0-9, A-E] with answer_prefix 'The answer is:\\n'
(distributed_evaluate_ovobench.py:193-199) and averages per task into the
three tracing groups (:159-182).

A copy of ``livecc_tpu/eval/ovobench.py`` on the port's predictor (the JAX
module's package imports jax); ``tests/test_torch_eval.py`` pins the two to
the same results.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Optional

from livecc_tpu_torch.eval.mcq import MCQItem, MCQPredictor, shard_indices

BACKWARD_TASKS = ("EPM", "ASI", "HLD")
REALTIME_TASKS = ("STU", "OJR", "ATR", "ACR", "OCR", "FPD")
FORWARD_TASKS = ("REC", "SSR", "CRR")

OPTIONS = ["No", "Yes"] + [str(d) for d in range(10)] + ["A", "B", "C", "D", "E"]
ANSWER_PREFIX = "The answer is:\n"


def flatten_annotations(rows: list[dict]) -> list[dict]:
    """Expand forward-tracing tasks' test_info probes into items
    (transfer_annotation_format.py semantics)."""
    out = []
    for row in rows:
        task = row["task"]
        if task in FORWARD_TASKS:
            for probe in row.get("test_info", []):
                item = {
                    "task": task,
                    "video": row["video"],
                    "video_start": 0.0,
                    "video_end": probe.get("realtime", row.get("realtime")),
                    "question": probe["question"],
                    "answer": str(probe["answer"]),
                    "options": probe.get("options"),
                }
                out.append(item)
        else:
            out.append({
                "task": task,
                "video": row["video"],
                "video_start": 0.0,
                "video_end": row.get("realtime"),
                "question": row["question"],
                "answer": str(row["answer"]),
                "options": row.get("options"),
            })
    return out


def load_items(path: str) -> list[MCQItem]:
    with open(path) as f:
        rows = [json.loads(l) for l in f if l.strip()]
    flat = flatten_annotations(rows)
    items = []
    for row in flat:
        option_lines = row["options"] if row.get("options") else []
        items.append(MCQItem(
            video=row["video"], question=row["question"], options=option_lines,
            answer=row["answer"], video_start=row["video_start"], video_end=row["video_end"],
            meta={"task": row["task"]},
        ))
    return items


def score(items: list[MCQItem], predictions: list[str]) -> dict:
    per_task = defaultdict(lambda: [0, 0])
    for item, pred in zip(items, predictions):
        correct = int(str(pred).strip() == str(item.answer).strip())
        per_task[item.meta["task"]][0] += correct
        per_task[item.meta["task"]][1] += 1
    pct = lambda c, n: round(100.0 * c / n, 2) if n else 0.0
    task_scores = {k: pct(c, n) for k, (c, n) in per_task.items()}
    def group_avg(tasks):
        present = [task_scores[t] for t in tasks if t in task_scores]
        return round(sum(present) / len(present), 2) if present else 0.0
    return {
        "task": dict(sorted(task_scores.items())),
        "backward": group_avg(BACKWARD_TASKS),
        "realtime": group_avg(REALTIME_TASKS),
        "forward": group_avg(FORWARD_TASKS),
    }


def run(predictor: MCQPredictor, benchmark_path: str, output_dir: str, *,
        worker: int = 0, num_workers: int = 1, batch_size: int = 1) -> Optional[dict]:
    os.makedirs(output_dir, exist_ok=True)
    predictor.answer_prefix = ANSWER_PREFIX
    items = load_items(benchmark_path)
    idxs = shard_indices(len(items), worker, num_workers)
    shard_file = os.path.join(output_dir, f"ovobench_shard{worker}.json")
    if not os.path.exists(shard_file):
        preds = predictor.predict([items[i] for i in idxs], letters=OPTIONS, batch_size=batch_size)
        with open(shard_file, "w") as f:
            json.dump({str(i): p for i, p in zip(idxs, preds)}, f)
    merged: dict[int, str] = {}
    for w in range(num_workers):
        path = os.path.join(output_dir, f"ovobench_shard{w}.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            merged.update({int(k): v for k, v in json.load(f).items()})
    predictions = [merged[i] for i in range(len(items))]
    report = score(items, predictions)
    with open(os.path.join(output_dir, "ovobench.json"), "w") as f:
        json.dump({"report": report, "predictions": predictions}, f, indent=2)
    return report
