"""A copy of ``livecc_tpu/utils/multiproc.py``.

Thread/process pool mappers — the reference's entire 'distributed
scheduler' for non-SPMD jobs (utils/multiprocessor.py:4-14): a pool map with
progress reporting, used by the data-production pipeline and eval generation
workers (one worker per accelerator, stride-sharded indices).
"""

from __future__ import annotations

import multiprocessing
import sys
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, Sequence


def _progress(iterable, total, desc):
    done = 0
    for x in iterable:
        done += 1
        if total:
            print(f"\r{desc}: {done}/{total}", end="", file=sys.stderr, flush=True)
        yield x
    if total:
        print(file=sys.stderr)


def local_mt(items: Sequence, fn: Callable, desc: str = "local_mt", num_workers: int = 8) -> list:
    """Thread-pool map (IO-bound work: file reads, network)."""
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        return list(_progress(pool.map(fn, items), len(items), desc))


def local_mp(items: Sequence, fn: Callable, desc: str = "local_mp", num_workers: int = 8) -> list:
    """Process-pool map with spawn (CPU-bound / per-accelerator workers)."""
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=num_workers, mp_context=ctx) as pool:
        return list(_progress(pool.map(fn, items), len(items), desc))
