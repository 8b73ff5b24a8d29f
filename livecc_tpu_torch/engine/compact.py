"""KV-cache compaction: a bounded attended window over an unbounded session.

Port of ``livecc_tpu/engine/compact.py`` (StreamingLLM-style eviction):
keep a row's ``sink`` prefix (system + query + first turn) plus its most
recent ``keep`` tokens and drop the middle. Keys keep their absolute rotary
encoding; the caller folds the dropped length into the stream's rope_delta
so new positions continue globally (``offset + delta`` is invariant).
"""

from __future__ import annotations

import torch

from livecc_tpu_torch.models.qwen2_vl.text import KVCache


def plan_compaction(old_off: int, sink_cap: int, keep_cap: int,
                    max_len: int) -> tuple[int, int, int]:
    """``(sink, keep, new_off)`` for a row whose depth is ``old_off``;
    ``new_off >= old_off`` means nothing to evict."""
    sink = min(sink_cap, old_off)
    keep = min(keep_cap, max_len)
    return sink, keep, min(old_off, sink + keep)


def _evict_index_map(off: torch.Tensor, sink: int, keep: int, n: int) -> torch.Tensor:
    """Position gather map: i < sink -> i; else off - keep + (i - sink);
    the identity when the window already covers the whole history."""
    i = torch.arange(n, device=off.device)
    idx = torch.where(i < sink, i, off - keep + (i - sink)).clamp(0, n - 1)
    return torch.where(off <= sink + keep, i, idx)


@torch.no_grad()
def compact_cache_row(cache: KVCache, row: int, sink: int, keep: int) -> KVCache:
    """Evict the middle of row ``row`` in place: keep ``[0, sink)`` and the
    last ``keep`` positions before its offset; the row's offset becomes
    ``min(offset, sink + keep)``. Other rows are untouched. An int8 cache's
    lane-major scales ``[L, B, Hk, 1, Smax]`` are gathered along their last
    axis."""
    off = cache.offset[row].long()
    idx = _evict_index_map(off, sink, keep, cache.max_len)
    for buf in (cache.k, cache.v):
        buf[:, row] = buf[:, row].index_select(-2, idx)
    if cache.quantized:
        for buf in (cache.k_scale, cache.v_scale):
            buf[:, row] = buf[:, row].index_select(-1, idx)
    offset = cache.offset.clone()
    offset[row] = torch.clamp(off, max=sink + keep).to(torch.int32)
    cache.offset = offset
    return cache


@torch.no_grad()
def compact_token_row(hist: torch.Tensor, off, row: int, sink: int, keep: int) -> torch.Tensor:
    """The same eviction on row ``row`` of the token-history buffer (the
    id-shadow of the KV cache that lookahead decoding drafts from,
    ``engine/speculative.py``), in place: ``hist[row, p]`` stays the id of
    cache position p, since both share ``_evict_index_map``. ``off`` is the
    row's depth before compaction. Returns ``hist``."""
    off = torch.as_tensor(off, dtype=torch.long, device=hist.device)
    hist[row] = hist[row].index_select(0, _evict_index_map(off, sink, keep, hist.shape[-1]))
    return hist
