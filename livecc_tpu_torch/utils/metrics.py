"""Serving latency histograms.

Port of ``LatencyTracker`` from ``livecc_tpu/utils/metrics.py``: streaming
samples keyed by event name with percentile summaries. The engine and the
serving pool record into one tracker (``engine.metrics``):

  * ``chunk_step``                      — one single-stream chunk, host wall;
  * ``serve_tick``                      — one ``StreamServer.tick``;
  * ``chunk_e2e_latency``               — a pool chunk from dispatch until its
                                          tokens reached the host;
  * ``chunk_submit_to_text``            — a chunk from ``submit_chunk`` until
                                          its text reached the host (the
                                          latency a viewer sees);
  * ``cache_compaction_dropped_tokens`` — tokens evicted per compaction.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Iterator

import numpy as np


class LatencyTracker:
    """Streaming latency histograms keyed by event name."""

    def __init__(self, max_samples: int = 4096):
        self._samples: dict[str, list[float]] = defaultdict(list)
        self.max_samples = max_samples

    @contextlib.contextmanager
    def measure(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        buf = self._samples[name]
        buf.append(seconds)
        if len(buf) > self.max_samples:           # keep the most recent samples
            del buf[: len(buf) - self.max_samples]

    def reset(self) -> None:
        """Drop all samples (e.g. after a warm-up, so summaries describe only
        the measured steady state)."""
        self._samples.clear()

    def summary(self, name: str | None = None) -> dict:
        names = [name] if name else sorted(self._samples)
        out = {}
        for n in names:
            xs = np.asarray(self._samples[n])
            if len(xs) == 0:
                continue
            out[n] = {
                "n": int(len(xs)),
                "p50": round(float(np.percentile(xs, 50)), 4),
                "p90": round(float(np.percentile(xs, 90)), 4),
                "p99": round(float(np.percentile(xs, 99)), 4),
                "mean": round(float(xs.mean()), 4),
                "max": round(float(xs.max()), 4),
            }
        return out if name is None else out.get(name, {})

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)
