"""The card's decode loops: one step captured as a CUDA graph, replayed.

JAX runs ``decode_chunk`` and ``decode_chunk_lookahead`` each as one jitted
``lax.while_loop`` that never returns to the host between steps. The
port's counterpart: for each key (``graph_key``: batch, cache length and
dtype, ``GenerationParams``, the sampling generator, the storage of the
cache and the weights, whose addresses a graph bakes in, and the mode:
plain decode, or lookahead with its ``SpecConfig`` and the address of its
``hist`` buffer) one step over a fixed state is captured once and then
replayed up to ``max_new_tokens - 1`` times a chunk: a ``decode_step``
over a ``DecodeState``, or a ``lookahead_step`` (one verify window) over
a ``LookaheadState`` (``engine/speculative.py``). A lookahead window emits
at least one token for every running row, so ``max_new_tokens - 1``
windows after the seed token bound a chunk as they bound the decode steps.
Per chunk:

  * the prologue copies the chunk's starting state into the key's buffers
    (device work only);
  * the first chunk of a key runs step 0 eagerly on a side stream (the
    warm-up capture needs; it is real work and launches are counted), then
    captures the step there; every later step, and every step of later
    chunks, is one replay;
  * after each replay but the last the host reads one flag, "no row runs
    on", through a non-blocking copy into pinned memory and a CUDA event it
    polls, and stops replaying once it is set. That is the only host read
    inside a chunk. Step 0 always runs: where no row runs on from the start
    (idle pool slots only, or every row stopped at its seed token) it is
    one extra step, which in greedy decoding changes no output (a frozen
    offset, pad tokens, counts + 0; a lookahead step writes only at and
    beyond each row's offset and counts no window);
  * the epilogue (the sample-only last token of plain decode) runs eagerly.

The kernels' wrappers count launches in Python (``build.launch_counts``),
so a replay adds nothing by itself: each graph keeps the counts its capture
added, takes them back off (a capture launches nothing), and adds them on
every replay, so the counts say what ran. With ``do_sample`` the graph
registers the caller's generator, so each replay draws new numbers.

A graph of a cache that is gone (grown into new buffers, a finished
stream's, a warm-up's scratch pool) is dropped at the next lookup: each
graph holds a weak reference to its cache's K buffer, and a lookahead graph
also to its ``hist``. A compaction writes the cache and ``hist`` in place
(``compact_cache_row``, ``compact_token_row``), so its graph stays valid.
There is no fallback: a capture or a replay that fails raises.

On a model split over the mesh's model axis (``parallel/sharding.py:
shard_params``) the captured steps hold the layers' all-reduces and the
logits' all-gather, issued by NCCL into the graph. NCCL cannot create a
communicator inside a capture, so one eager all-reduce over the model
group runs before the first capture. Every model rank takes the same
decisions from the same tokens and stop flags, so all capture and replay
the same steps in the same order; the key holds the group's size and
this rank's index.
"""

from __future__ import annotations

import collections
import dataclasses
import time
import weakref
from typing import Optional

import torch
import torch.distributed as dist

from livecc_tpu_torch.core.config import ModelConfig
from livecc_tpu_torch.engine.generation import (
    DecodeState, GenerationParams, decode_epilogue, decode_prologue, decode_step)
from livecc_tpu_torch.engine.speculative import (
    LookaheadState, SpecConfig, lookahead_epilogue, lookahead_prologue, lookahead_step)
from livecc_tpu_torch.models.qwen2_vl.model import Qwen2VL
from livecc_tpu_torch.models.qwen2_vl.text import KVCache
from livecc_tpu_torch.ops import build


def graph_key(model: Qwen2VL, gen: GenerationParams, cache: KVCache, batch: int,
              generator: Optional[torch.Generator] = None, spec: Optional[SpecConfig] = None,
              hist: Optional[torch.Tensor] = None) -> tuple:
    """What a captured step depends on: batch, cache length and dtype, the
    generation settings, the generator it draws from (sampling only), the
    addresses of the cache's buffers and of the weights (parameters and
    buffers: int8 weights are buffers, ``ops/quant.py``), and the mode: a
    plain decode step, or (``spec`` given) a lookahead step with its
    settings and the address of its ``hist``; and the model group's size
    and this rank's index under tensor parallelism."""
    tp = model.text.tp
    buffers = tuple(0 if t is None else t.data_ptr()
                    for t in (cache.k, cache.v, cache.k_scale, cache.v_scale))
    weights = hash(tuple(t.data_ptr() for t in (*model.parameters(), *model.buffers())))
    mode = ("decode",) if spec is None else ("lookahead", spec, hist.data_ptr())
    return (batch, cache.max_len, cache.k.dtype, gen, generator if gen.do_sample else None,
            buffers, weights, mode, None if tp is None else (tp.size, tp.rank))


def run_steps(n_steps: int, step, all_stopped) -> int:
    """The card's step loop: ``step(0)`` always, then ``step(i)`` while
    ``all_stopped()``, read after every step but the last, is false.
    Returns the number of steps run."""
    for i in range(n_steps):
        step(i)
        if i + 1 < n_steps and all_stopped():
            return i + 1
    return n_steps


@dataclasses.dataclass
class StepGraph:
    """One captured step over its own state (``DecodeState`` or ``LookaheadState``)."""

    state: DecodeState | LookaheadState
    owner: weakref.ref                        # the cache's K buffer
    hist: Optional[weakref.ref] = None        # a lookahead step's hist
    graph: Optional[torch.cuda.CUDAGraph] = None
    launches: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    def stale(self) -> bool:
        return self.owner() is None or (self.hist is not None and self.hist() is None)

    def replay(self) -> None:
        self.graph.replay()
        build.launch_counts.update(self.launches)


class DecodeGraphs:
    """The captured steps of one model on the card, by ``graph_key``.

    ``captures``, ``capture_seconds``, ``replays`` (of decode steps),
    ``windows`` (replays of lookahead steps) and ``host_reads`` count what
    the decode loops did since the last ``reset_stats``."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.graphs: dict[tuple, StepGraph] = {}
        self._side: Optional[torch.cuda.Stream] = None
        self._flag: Optional[torch.Tensor] = None
        self._event: Optional[torch.cuda.Event] = None
        self._warm = False                    # the model group's communicator (TP only)
        self.reset_stats()

    def reset_stats(self) -> None:
        self.captures = 0
        self.capture_seconds = 0.0
        self.replays = 0
        self.windows = 0
        self.host_reads = 0

    def stats(self) -> dict:
        return {"graphs": len(self.graphs), "captures": self.captures,
                "capture_seconds": self.capture_seconds, "replays": self.replays,
                "windows": self.windows, "host_reads": self.host_reads}

    def _drop_stale(self) -> None:
        for key in [k for k, g in self.graphs.items() if g.stale()]:
            del self.graphs[key]

    def _lookup(self, model: Qwen2VL, gen: GenerationParams, cache: KVCache, batch: int,
                vocab: int, generator, spec: Optional[SpecConfig] = None,
                hist: Optional[torch.Tensor] = None) -> StepGraph:
        self._drop_stale()
        key = graph_key(model, gen, cache, batch, generator, spec, hist)
        entry = self.graphs.get(key)
        if entry is None or entry.owner() is not cache.k or (
                hist is not None and entry.hist() is not hist):
            dev = cache.k.device
            if spec is None:
                entry = StepGraph(DecodeState.empty(batch, vocab, gen.max_new_tokens, dev),
                                  weakref.ref(cache.k))
            else:
                entry = StepGraph(LookaheadState.empty(batch, vocab, gen.max_new_tokens, dev),
                                  weakref.ref(cache.k), weakref.ref(hist))
            self.graphs[key] = entry
        return entry

    def _all_stopped(self, st: DecodeState | LookaheadState) -> bool:
        """The one host read of a step: the stop flag, copied into pinned
        memory behind the replay, read once an event after the copy has
        completed (polled, so no synchronizing call is made)."""
        if self._flag is None:
            self._flag = torch.zeros((), dtype=torch.bool, pin_memory=True)
            self._event = torch.cuda.Event()
        self._flag.copy_(st.done, non_blocking=True)
        self._event.record()
        while not self._event.query():
            pass
        self.host_reads += 1
        return bool(self._flag)

    def _warm_up(self, model: Qwen2VL, dev: torch.device) -> None:
        """One eager all-reduce over a split model's group before its first
        capture, so that the communicator exists before any capture."""
        tp = model.text.tp
        if tp is None or self._warm:
            return
        dist.all_reduce(torch.zeros(1, device=dev), group=tp.group)
        self._warm = True

    def _capture(self, entry: StepGraph, step, dev: torch.device, gen: GenerationParams,
                 generator) -> None:
        """``step()`` eagerly on a side stream (the warm-up), then captured there."""
        if self._side is None:
            self._side = torch.cuda.Stream(dev)
        current = torch.cuda.current_stream(dev)
        self._side.wait_stream(current)
        with torch.cuda.stream(self._side):
            step()
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            if gen.do_sample and generator is not None:
                graph.register_generator_state(generator)
            before = collections.Counter(build.launch_counts)
            graph.capture_begin()
            try:
                step()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass
                raise
            graph.capture_end()
        current.wait_stream(self._side)
        entry.launches = collections.Counter(build.launch_counts)
        entry.launches.subtract(before)
        build.launch_counts.subtract(entry.launches)      # capture launches nothing
        entry.graph = graph
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0

    def decode(self, model: Qwen2VL, gen: GenerationParams, logits0: torch.Tensor,
               cache: KVCache, counts: torch.Tensor, rope_delta: torch.Tensor,
               generator: Optional[torch.Generator] = None, active=None) -> tuple:
        """``decode_chunk`` on the card: see the module docstring."""
        if gen.max_new_tokens < 1:
            raise ValueError("decode_chunk requires max_new_tokens >= 1")
        batch, vocab = logits0.shape
        entry = self._lookup(model, gen, cache, batch, vocab, generator)
        st = entry.state
        decode_prologue(st, gen, logits0, cache, counts, rope_delta, active)

        def step(_i: int) -> None:
            if entry.graph is None:
                self._warm_up(model, cache.k.device)
                self._capture(entry, lambda: decode_step(model, self.cfg, gen, st, cache,
                                                         generator),
                              cache.k.device, gen, generator)
            else:
                entry.replay()
                self.replays += 1

        run_steps(gen.max_new_tokens - 1, step, lambda: self._all_stopped(st))
        return decode_epilogue(st, gen, cache, counts, generator)

    def lookahead(self, model: Qwen2VL, gen: GenerationParams, spec: SpecConfig,
                  prompt_ids: torch.Tensor, prompt_valid, logits0: torch.Tensor, cache: KVCache,
                  hist: torch.Tensor, counts: torch.Tensor, rope_delta: torch.Tensor,
                  generator: Optional[torch.Generator] = None, active=None) -> tuple:
        """``decode_chunk_lookahead`` on the card: see the module docstring."""
        batch, vocab = logits0.shape
        entry = self._lookup(model, gen, cache, batch, vocab, generator, spec, hist)
        st = entry.state
        lookahead_prologue(st, gen, prompt_ids, prompt_valid, logits0, cache, hist, counts,
                           rope_delta, generator, active)

        def step(_i: int) -> None:
            if entry.graph is None:
                self._warm_up(model, cache.k.device)
                self._capture(entry, lambda: lookahead_step(model, self.cfg, gen, spec, st,
                                                            cache, hist, generator),
                              cache.k.device, gen, generator)
            else:
                entry.replay()
                self.windows += 1

        run_steps(gen.max_new_tokens - 1, step, lambda: self._all_stopped(st))
        return lookahead_epilogue(st, cache, hist, counts)


_GRAPHS: "weakref.WeakKeyDictionary[Qwen2VL, DecodeGraphs]" = weakref.WeakKeyDictionary()


def graphs_for(model: Qwen2VL, cfg: ModelConfig) -> DecodeGraphs:
    """The model's decode graphs (made on first use, dropped with the model)."""
    graphs = _GRAPHS.get(model)
    if graphs is None:
        graphs = _GRAPHS[model] = DecodeGraphs(cfg)
    return graphs
