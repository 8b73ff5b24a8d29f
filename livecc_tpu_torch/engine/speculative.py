"""Speculative decoding: draft tokens verified in one forward pass.

Port of ``livecc_tpu/engine/speculative.py``. A decode step at small batch
reads every weight for one token; a verify window forwards ``k_draft + 1``
tokens for the same read, so when a draft predicts the model's own output,
tokens per weight read rise by the accepted length. Commentary repeats
itself, which is what n-gram lookup drafts exploit.

Two decode loops over one verification core (``accept_scan``):

  * ``decode_chunk_lookahead``: n-gram drafting, verification, acceptance
    and the token-history update all on the device. The history is an
    id-shadow of the KV cache (``hist[b, p]`` = the id at cache position p),
    so per-row offsets, growth and compaction carry over
    (``engine/compact.py:compact_token_row``). Split as ``decode_chunk`` is
    (``engine/generation.py``): a prologue that loads a fixed
    ``LookaheadState``, one ``lookahead_step`` that reads and writes only
    that state, the cache and ``hist``, in place, and an epilogue. On the
    CPU the steps run eagerly (``decode_chunk_lookahead_plain``); on the
    card the step is captured once as a CUDA graph and replayed with one
    host read of a stop flag per replay (``engine/graphs.py``).
  * ``speculative_decode_chunk``: the host-drafted loop with a pluggable
    draft source (``NGramDraftSource`` built in). One host sync per window
    by design; it runs eagerly on both devices.

Both are lossless for greedy decoding: acceptance compares the model's own
selection with the draft position by position, with the penalty and
threshold semantics of ``decode_chunk`` (``adjust_logits``,
``select_token``), and the chunk's final token is never forwarded. A verify
forward writes all W window tokens' KV at the row's offset; the offset then
advances only past the accepted prefix, so rejected drafts' KV lies beyond
every later ``kv_limit`` and the next window overwrites it.

Sampling draws from the caller's torch generator: self-consistent, matching
JAX only in distribution (greedy is the parity mode).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from livecc_tpu_torch.core.config import ModelConfig
from livecc_tpu_torch.engine.generation import GenerationParams, adjust_logits, select_token
from livecc_tpu_torch.models.qwen2_vl.model import Qwen2VL, forward
from livecc_tpu_torch.models.qwen2_vl.text import KVCache, lm_logits
from livecc_tpu_torch.parallel.tp import TensorParallel, agree_max


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative decoding settings (field for field the JAX ``SpecConfig``).

    ``fused=True`` runs the whole chunk through ``decode_chunk_lookahead``;
    ``fused=False`` is the host-drafted window loop. ``adaptive`` turns on
    ``SpecController``, which runs whichever of lookahead and plain decode
    measures faster per emitted token and probes the other every
    ``probe_every`` dispatches."""

    k_draft: int = 8          # drafted tokens per verify window
    max_ngram: int = 3        # longest suffix n-gram tried by the lookup
    fused: bool = True
    adaptive: bool = True
    ema: float = 0.3          # EMA smoothing for the per-mode cost estimates
    probe_every: int = 16


class SpecController:
    """Adaptive lookahead switch driven by measured wall per emitted token.

    Host-only. It EMA-tracks seconds per emitted token for each mode from
    the dispatch walls the host already observes, runs the faster mode and
    probes the slower one every ``probe_every`` dispatches. Bootstrap order:
    lookahead first, then one plain dispatch, then the data. A 3x-of-EMA
    clip keeps one stall from poisoning an estimate; ``force`` pins the
    decision.

    On a model split over the model axis (``tp``) every rank must choose
    alike: a lookahead step and a decode step issue different collectives,
    so two ranks that chose apart would hang the group. Each wall is
    replaced by the largest of the model ranks' (``parallel/tp.py:
    agree_max``) before it enters the EMA, so every rank holds the same
    estimates and makes the same choices."""

    def __init__(self, spec: Optional[SpecConfig], tp: Optional[TensorParallel] = None):
        self.spec = spec
        self.tp = tp
        self.spt: dict[bool, float | None] = {True: None, False: None}
        self.ema: float | None = None        # accepted tokens per window (metric)
        self._dispatch_n = 0
        self.force: bool | None = None
        self.last_choice: bool = True

    @property
    def enabled(self) -> bool:
        """The steady-state decision (ignoring probe dispatches)."""
        s, p = self.spt[True], self.spt[False]
        if s is None or p is None:
            return True
        return s < p

    def use_spec(self) -> bool:
        if self.spec is None:
            return False
        if self.force is not None:
            self.last_choice = self.force
            return self.force
        if not self.spec.adaptive:
            self.last_choice = True
            return True
        self._dispatch_n += 1
        s, p = self.spt[True], self.spt[False]
        if s is None:
            choice = True                    # bootstrap: measure lookahead
        elif p is None:
            choice = False                   # then measure plain once
        elif self._dispatch_n % self.spec.probe_every == 0:
            choice = not (s < p)             # keep the loser's estimate fresh
        else:
            choice = s < p
        self.last_choice = choice
        return choice

    def observe_wall(self, used_spec: bool, wall_s: float, tokens: int) -> None:
        """Feed one dispatch's wall and emitted tokens."""
        if self.spec is None or not self.spec.adaptive or tokens <= 0:
            return
        if self.tp is not None:
            wall_s = agree_max(wall_s, self.tp)
        if wall_s <= 0:
            return
        v = wall_s / tokens
        cur = self.spt[used_spec]
        if cur is not None:
            v = min(v, 3.0 * cur)            # stall clip
        a = self.spec.ema
        self.spt[used_spec] = v if cur is None else (1 - a) * cur + a * v

    def observe(self, tokens_total: int, n_rows: int, n_iters: int) -> None:
        """Acceptance diagnostics (tokens per window EMA, reporting only)."""
        if self.spec is None or n_rows == 0 or n_iters <= 0:
            return
        tpw = tokens_total / (n_rows * n_iters)
        a = self.spec.ema
        self.ema = tpw if self.ema is None else (1 - a) * self.ema + a * tpw


def accept_scan(gen: GenerationParams, k_draft: int, srcs: torch.Tensor, draft: torch.Tensor,
                counts: torch.Tensor, step_idx: torch.Tensor, stopped: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> tuple:
    """The verification core: emit the accepted prefix and one bonus token.

    ``srcs`` [B, K+1, V] fp32 (``srcs[:, j]`` predicts emitted token j),
    ``draft`` [B, K+1] (slot K is never matched), ``counts`` [B, V] int32
    (updated in place), ``step_idx`` int32 [B] (tokens this chunk has
    emitted so far), ``stopped`` bool [B]. Returns ``(tokens_out [B, K+1],
    pad after the window's last emission; emitted [B] int32; counts;
    stopped)``. Token j is emitted while the row is accepting; acceptance
    goes on only while the selection equals the draft, is not eos and the
    chunk's cap has room. A static loop over the K+1 positions (JAX's
    ``lax.scan``)."""
    b = srcs.shape[0]
    accepting = torch.ones((b,), dtype=torch.bool, device=srcs.device)
    emitted = torch.zeros((b,), dtype=torch.int32, device=srcs.device)
    out = []
    for j in range(k_draft + 1):
        logits = adjust_logits(srcs[:, j], counts, gen, step_idx + j)
        cand = select_token(logits, gen, generator)                       # [B]
        emit = accepting & ~stopped
        out.append(torch.where(emit, cand, torch.full_like(cand, gen.pad_token_id)))
        counts.scatter_add_(1, cand.long()[:, None], emit.to(counts.dtype)[:, None])
        is_eos = cand == gen.eos_token_id
        may_continue = (step_idx + j + 1) < gen.max_new_tokens
        accepting = emit & (cand == draft[:, j]) & ~is_eos & may_continue     # slot K: -1
        stopped = stopped | (emit & is_eos)
        emitted = emitted + emit.to(torch.int32)
    return torch.stack(out, dim=1), emitted, counts, stopped


def window_forward(model: Qwen2VL, cfg: ModelConfig, tokens_in: torch.Tensor, cache: KVCache,
                   offset: torch.Tensor, rope_delta: torch.Tensor) -> torch.Tensor:
    """Causal forward of one verify window ``tokens_in`` [B, W] at each
    row's ``offset`` against the cache: fp32 logits at every window
    position [B, W, V]. The W tokens' KV are written in place at [offset,
    offset + W); ``cache.offset`` is left as it is (the caller advances past
    the accepted prefix). W > 1 attends through K1 (K1-int8 on an int8
    cache). A draft of -1 (a hole in the history) is embedded as id V - 1,
    as JAX's indexing wraps it; it is never accepted, so no emitted token
    depends on it."""
    b, w = tokens_in.shape
    pos = (offset[:, None] + rope_delta
           + torch.arange(w, device=offset.device)[None, :]).to(torch.int32)     # [B, W]
    view = dataclasses.replace(cache, offset=offset)      # forward replaces the view's offset
    ids = tokens_in.remainder(cfg.text.vocab_size)
    hidden, _ = forward(model, cfg, ids, pos[None].expand(3, b, w), view,
                        kv_limit=offset + w, compute_logits=False)
    return lm_logits(model.text, cfg.text, hidden)


@torch.no_grad()
def verify_window(
    model: Qwen2VL,
    cfg: ModelConfig,
    gen: GenerationParams,
    tokens_in: torch.Tensor,      # [B, W] int32: (committed +) draft tokens
    logits_in: torch.Tensor,      # [B, V] fp32 frontier logits (used iff first)
    cache: KVCache,
    counts: torch.Tensor,         # [B, V] int32 (updated in place)
    rope_delta: torch.Tensor,     # [B, 1] int32
    step_idx: torch.Tensor,       # [B] int32: tokens emitted so far this chunk
    stopped: torch.Tensor,        # [B] bool
    generator: Optional[torch.Generator] = None,
    first: bool = False,
) -> tuple:
    """One host-driven window. ``first``: ``tokens_in`` is the draft alone
    (W = K) and the chain starts from ``logits_in`` (the prefill's frontier
    logits); otherwise ``tokens_in[:, 0]`` is the previous window's bonus
    token, already emitted, forwarded here (W = K + 1). Returns
    ``(tokens_out, emitted, cache, counts, stopped)``; the cache's offset
    advances past the forwarded history: the committed token and every
    emitted token but the window's last."""
    b, w = tokens_in.shape
    k_draft = w if first else w - 1
    logits_all = window_forward(model, cfg, tokens_in, cache, cache.offset, rope_delta)
    if first:
        srcs = torch.cat([logits_in[:, None], logits_all], dim=1)
        draft = tokens_in
    else:
        srcs = logits_all
        draft = tokens_in[:, 1:]
    draft = F.pad(draft, (0, 1), value=-1)                                     # [B, K+1]
    tokens_out, emitted, counts, stopped = accept_scan(gen, k_draft, srcs, draft, counts,
                                                       step_idx, stopped, generator)
    advance = (emitted - 1).clamp(min=0) if first else emitted
    cache.offset = cache.offset + advance
    return tokens_out, emitted, cache, counts, stopped


def ngram_draft(hist: torch.Tensor, off: torch.Tensor, k: int, max_ngram: int,
                pad: int) -> torch.Tensor:
    """Device n-gram lookup over each row's history ``hist[b, :off[b] + 1]``:
    the longest suffix n-gram (n <= ``max_ngram``) that also occurs earlier,
    its rightmost occurrence, and the up to ``k`` ids that followed it,
    ``pad`` after the history's end or where nothing matched. The semantics
    of ``NGramDraftSource.propose`` on the same ids. [B, k] int32."""
    b, hcap = hist.shape
    dev = hist.device
    off = off.long()
    m = max_ngram
    pat_idx = off[:, None] - (m - 1) + torch.arange(m, device=dev)[None, :]         # [B, m]
    pat = torch.where(pat_idx >= 0, hist.gather(1, pat_idx.clamp(0, hcap - 1)),
                      torch.full_like(pat_idx, -1, dtype=hist.dtype))
    pos_i = torch.arange(hcap, device=dev)
    best_i = torch.full((b,), -1, dtype=torch.long, device=dev)
    best_n = torch.zeros((b,), dtype=torch.long, device=dev)
    for n in range(m, 0, -1):                      # longest first
        match = torch.ones((b, hcap), dtype=torch.bool, device=dev)
        for j in range(n):
            col = hist if j == 0 else F.pad(hist[:, j:], (0, j), value=-1)
            match = match & (col == pat[:, m - n + j][:, None])
        pat_real = (off - (n - 1)) >= 0
        match = match & (pos_i[None, :] + n <= off[:, None]) & pat_real[:, None]
        cand_i = torch.where(match, pos_i[None, :], -1).amax(dim=1)
        take = (best_i < 0) & (cand_i >= 0)
        best_i = torch.where(take, cand_i, best_i)
        best_n = torch.where(take, torch.full_like(best_n, n), best_n)
    didx = (best_i + best_n)[:, None] + torch.arange(k, device=dev)[None, :]        # [B, k]
    in_hist = (didx <= off[:, None]) & (best_i >= 0)[:, None]
    return torch.where(in_hist, hist.gather(1, didx.clamp(0, hcap - 1)),
                       torch.full_like(didx, pad, dtype=hist.dtype)).to(torch.int32)


def _write_window(buf: torch.Tensor, start: torch.Tensor, src: torch.Tensor,
                  length: torch.Tensor) -> None:
    """In place: ``buf[b, start[b] + i] = src[b, i]`` for i < ``length[b]``,
    positions past the row's end dropped (JAX's ``mode="drop"``). Written as
    one select over the row, so no index is duplicated and nothing reads
    the device on the host."""
    w = src.shape[1]
    rel = torch.arange(buf.shape[1], device=buf.device)[None, :] - start.long()[:, None]
    inside = (rel >= 0) & (rel < length.long()[:, None])
    buf.copy_(torch.where(inside, src.gather(1, rel.clamp(0, w - 1)).to(buf.dtype), buf))


@dataclasses.dataclass
class LookaheadState:
    """The buffers one lookahead step reads and writes in place, besides the
    cache and the caller's ``hist``: no Python value changes from step to
    step, so the card can replay the step as a captured graph."""

    counts: torch.Tensor        # [B, V] int32 token counts
    offset: torch.Tensor        # [B] int32 cache depth per row
    rope_delta: torch.Tensor    # [B, 1] int32
    pending: torch.Tensor       # [B] int32: the last emitted token, not yet forwarded
    stopped: torch.Tensor       # [B] bool
    n_emit: torch.Tensor        # [B] int32 tokens emitted this chunk
    tokens: torch.Tensor        # [B, max_new] int32 emitted tokens (pad after)
    n_iters: torch.Tensor       # int32 []: verify windows run
    done: torch.Tensor          # bool []: no row runs on (JAX's ``cond`` is false)

    @staticmethod
    def empty(batch: int, vocab: int, max_new_tokens: int, device) -> "LookaheadState":
        def buf(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        return LookaheadState(
            counts=buf((batch, vocab), torch.int32), offset=buf((batch,), torch.int32),
            rope_delta=buf((batch, 1), torch.int32), pending=buf((batch,), torch.int32),
            stopped=buf((batch,), torch.bool), n_emit=buf((batch,), torch.int32),
            tokens=buf((batch, max_new_tokens), torch.int32), n_iters=buf((), torch.int32),
            done=buf((), torch.bool))


def _set_done(st: LookaheadState, gen: GenerationParams) -> None:
    st.done.copy_(~(~st.stopped & (st.n_emit < gen.max_new_tokens)).any())


def lookahead_prologue(st: LookaheadState, gen: GenerationParams, prompt_ids: torch.Tensor,
                       prompt_valid: torch.Tensor, logits0: torch.Tensor, cache: KVCache,
                       hist: torch.Tensor, counts: torch.Tensor, rope_delta: torch.Tensor,
                       generator=None, active=None) -> None:
    """Load a chunk's starting state into ``st`` (device work only): the
    prompt into ``hist`` at [offset - valid, offset), and the seed token
    from the prefill logits (``accept_scan`` at k = 0, step 0). An inactive
    row starts stopped."""
    b = st.stopped.shape[0]
    dev = st.stopped.device
    valid = torch.as_tensor(prompt_valid, dtype=torch.int32, device=dev).expand(b)
    _write_window(hist, cache.offset - valid, prompt_ids, valid)
    st.counts.copy_(counts)
    st.offset.copy_(cache.offset)
    st.rope_delta.copy_(rope_delta)
    if active is None:
        st.stopped.zero_()
    else:
        st.stopped.copy_(~torch.as_tensor(active, dtype=torch.bool, device=dev).expand(b))
    tok0, emit0, _, stopped = accept_scan(
        gen, 0, logits0[:, None], torch.full((b, 1), -1, dtype=torch.int32, device=dev),
        st.counts, torch.zeros((b,), dtype=torch.int32, device=dev), st.stopped, generator)
    st.stopped.copy_(stopped)
    st.tokens.fill_(gen.pad_token_id)
    st.tokens[:, 0] = tok0[:, 0]
    st.pending.copy_(tok0[:, 0])
    st.n_emit.copy_(emit0)
    st.n_iters.zero_()
    _set_done(st, gen)


def lookahead_step(model: Qwen2VL, cfg: ModelConfig, gen: GenerationParams, spec: SpecConfig,
                   st: LookaheadState, cache: KVCache, hist: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> None:
    """One iteration of JAX's lookahead ``while_loop`` body, in place on
    ``st``, the cache's K/V and ``hist``: the pending token into ``hist`` at
    the offset, the n-gram draft, the window forward of pending + draft,
    ``accept_scan``, the forwarded ids into ``hist``, the emitted tokens
    into the buffer, the offset advanced by what was emitted. Where no row
    runs on it still computes, but changes nothing below any row's offset
    and counts no window."""
    b, hcap = hist.shape
    k, max_new = spec.k_draft, gen.max_new_tokens
    off = st.offset
    hist.scatter_(1, off.long().clamp(0, hcap - 1)[:, None], st.pending[:, None].to(hist.dtype))
    draft = ngram_draft(hist, off, k, spec.max_ngram, gen.pad_token_id)
    tokens_in = torch.cat([st.pending[:, None], draft], dim=1)                # [B, K+1]
    logits_all = window_forward(model, cfg, tokens_in, cache, off, st.rope_delta)
    loop_stopped = st.stopped | (st.n_emit >= max_new)
    tokens_out, emitted, _, stopped = accept_scan(
        gen, k, logits_all, F.pad(draft, (0, 1), value=-1), st.counts, st.n_emit, loop_stopped,
        generator)
    _write_window(hist, off, tokens_in, torch.full_like(off, k + 1))
    _write_window(st.tokens, st.n_emit, tokens_out, emitted)
    last = tokens_out.gather(1, (emitted.long() - 1).clamp(0, k)[:, None])[:, 0]
    st.pending.copy_(torch.where(emitted > 0, last, st.pending))
    st.n_iters.add_((~loop_stopped).any().to(torch.int32))
    st.offset.add_(emitted)
    st.n_emit.add_(emitted)
    st.stopped.copy_(stopped)
    _set_done(st, gen)


def lookahead_epilogue(st: LookaheadState, cache: KVCache, hist: torch.Tensor,
                       counts: torch.Tensor) -> tuple:
    """The cache's offset and ``counts`` (in place) take the state's;
    returns what ``decode_chunk_lookahead`` returns, in tensors of their own."""
    cache.offset = st.offset.clone()
    counts.copy_(st.counts)
    return st.tokens.clone(), st.n_emit.clone(), cache, hist, counts, st.n_iters.clone()


@torch.no_grad()
def decode_chunk_lookahead_plain(
    model: Qwen2VL,
    cfg: ModelConfig,
    gen: GenerationParams,
    spec: SpecConfig,
    prompt_ids: torch.Tensor,
    prompt_valid,
    logits0: torch.Tensor,
    cache: KVCache,
    hist: torch.Tensor,
    counts: torch.Tensor,
    rope_delta: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    active=None,
) -> tuple:
    """The plain version of ``decode_chunk_lookahead``: the steps run eagerly
    in a Python loop that reads the stop flag on the host before each step
    (JAX's ``cond``). ``decode_chunk_lookahead`` runs it on the CPU; on the
    card tests call it by name to hold the graphs to it."""
    b, v = logits0.shape
    st = LookaheadState.empty(b, v, gen.max_new_tokens, logits0.device)
    lookahead_prologue(st, gen, prompt_ids, prompt_valid, logits0, cache, hist, counts,
                       rope_delta, generator, active)
    for _ in range(gen.max_new_tokens - 1):
        if bool(st.done):
            break
        lookahead_step(model, cfg, gen, spec, st, cache, hist, generator)
    return lookahead_epilogue(st, cache, hist, counts)


@torch.no_grad()
def decode_chunk_lookahead(
    model: Qwen2VL,
    cfg: ModelConfig,
    gen: GenerationParams,
    spec: SpecConfig,
    prompt_ids: torch.Tensor,     # [B, Sb] this chunk's (padded) prompt ids
    prompt_valid,                 # int or int32 [B]: real prompt tokens per row
    logits0: torch.Tensor,        # [B, V] fp32 prefill frontier logits
    cache: KVCache,               # offset already past the prompt
    hist: torch.Tensor,           # [B, Hcap] int32 id-shadow of the cache (in place)
    counts: torch.Tensor,         # [B, V] int32 (updated in place)
    rope_delta: torch.Tensor,     # [B, 1] int32
    generator: Optional[torch.Generator] = None,
    active=None,                  # bool [B] (or scalar); False = no-op row
) -> tuple:
    """Fused lookahead decode of one chunk. Returns ``(tokens [B, max_new],
    n_generated [B], cache, hist, counts, n_iters)``: ``n_iters`` (int32 [])
    counts verify windows. Greedy output equals ``decode_chunk``'s; each
    window emits 1 + the accepted drafts per running row.

    CPU tensors run the plain version (``decode_chunk_lookahead_plain``).
    CUDA tensors replay the model's captured lookahead step
    (``engine/graphs.py``); a capture or replay that fails raises. Any
    other device raises."""
    if logits0.device.type == "cpu":
        return decode_chunk_lookahead_plain(model, cfg, gen, spec, prompt_ids, prompt_valid,
                                            logits0, cache, hist, counts, rope_delta,
                                            generator, active)
    if logits0.device.type != "cuda":
        raise RuntimeError(f"decode_chunk_lookahead: no decode path for device {logits0.device}")
    from livecc_tpu_torch.engine.graphs import graphs_for

    return graphs_for(model, cfg).lookahead(model, gen, spec, prompt_ids, prompt_valid, logits0,
                                            cache, hist, counts, rope_delta, generator, active)


class NGramDraftSource:
    """Prompt-lookup drafting: match the longest suffix n-gram of the context
    earlier in the context and propose the ids that followed it."""

    def __init__(self, max_ngram: int = 3, k: int = 8):
        self.max_ngram = max_ngram
        self.k = k

    def propose(self, ids: list[int], pad_token_id: int = 0) -> list[int]:
        k = self.k
        n_ids = len(ids)
        for n in range(min(self.max_ngram, max(n_ids - 1, 0)), 0, -1):
            pat = ids[-n:]
            for i in range(n_ids - n - 1, -1, -1):       # rightmost earlier occurrence
                if ids[i:i + n] == pat:
                    out = ids[i + n:i + n + k]
                    if out:
                        return out + [pad_token_id] * (k - len(out))
        return [pad_token_id] * k


@torch.no_grad()
def speculative_decode_chunk(
    engine,                        # LiveCCEngine (duck-typed to avoid a cycle)
    state,                         # StreamState: cache and counts updated
    logits0: torch.Tensor,         # [1, V] the chunk prefill's frontier logits
    gen: GenerationParams,
    spec: SpecConfig,
    context_ids: list[int],
    draft_source=None,
) -> tuple[list[int], int]:
    """The host loop in place of ``decode_chunk`` for one solo-stream chunk:
    each window's emitted tokens come to the host (the next proposal needs
    them), then the next window runs. Returns the emitted ids and the
    number of windows; the caller does the usual past_ids / length /
    last_token bookkeeping."""
    draft_source = draft_source or NGramDraftSource(spec.max_ngram, spec.k_draft)
    dev = logits0.device
    ctx = list(context_ids)
    generated: list[int] = []
    first = True
    committed: int | None = None
    stopped = torch.zeros((1,), dtype=torch.bool, device=dev)
    rope_delta = torch.tensor([[state.rope_delta]], dtype=torch.int32, device=dev)
    windows = 0
    while len(generated) < gen.max_new_tokens:
        draft = draft_source.propose(ctx, gen.pad_token_id)
        row = draft if first else [committed] + draft
        tokens, n_emit, state.cache, state.counts, stopped = verify_window(
            engine.model, engine.cfg, gen, torch.tensor([row], dtype=torch.int32, device=dev),
            logits0, state.cache, state.counts, rope_delta,
            torch.tensor([len(generated)], dtype=torch.int32, device=dev), stopped,
            engine.generator, first=first)
        windows += 1
        n = int(n_emit[0])
        emitted = tokens[0, :n].tolist()
        generated.extend(emitted)
        ctx.extend(emitted)
        engine.metrics.record("spec_accepted_per_window", float(max(n - 1, 0)))
        if n == 0 or bool(stopped[0]) or len(generated) >= gen.max_new_tokens:
            break
        committed = emitted[-1]
        first = False
    return generated, windows
