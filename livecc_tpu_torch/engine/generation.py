"""Bucketed prefill + decode loop for streaming generation.

Port of ``livecc_tpu/engine/generation.py``. Semantics pinned to the
reference stack, as in JAX:

  * the first prefill uses full 3D M-RoPE positions; later chunks and
    decode steps use flat ``offset + rope_delta`` positions;
  * the final sampled token of each chunk is NOT forwarded (its KV never
    enters the cache; reference ``past_ids = sequences[:, :-1]``);
  * the repetition penalty applies over prompt + generated presence counts,
    kept on the device and updated incrementally.

The decode loop is split as JAX's ``lax.while_loop`` is: a prologue that
loads the state into a fixed set of buffers (``DecodeState``), one decode
step that reads and writes only those buffers and the KV cache, in place
(``decode_step``: the step index is an int32 device counter, the token
columns are written through it, nothing is replaced), and an epilogue that
samples the last token. On the CPU the steps run eagerly in a Python loop
that stops early once every row has stopped (``decode_chunk_plain``, the
plain version); on the card the step is captured once as a CUDA graph and
replayed, with one host read of the stop flag per replay
(``engine/graphs.py``). The KV cache is updated in place; its ``offset`` is
replaced by each call.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from livecc_tpu_torch.core.config import ModelConfig
from livecc_tpu_torch.models.qwen2_vl.model import Qwen2VL, VisionInputs, forward
from livecc_tpu_torch.models.qwen2_vl.text import KVCache, lm_logits
from livecc_tpu_torch.ops.attention import NEG_INF


@dataclasses.dataclass(frozen=True)
class GenerationParams:
    """Generation settings (field-for-field the JAX ``GenerationParams``)."""

    max_new_tokens: int = 16
    eos_token_id: int = 151645            # <|im_end|>
    pad_token_id: int = 151643
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0                        # 0 = disabled
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    # ThresholdLogitsProcessor (reference demo/infer.py:10-23); -1 disables.
    streaming_eos_token_id: int = -1
    streaming_threshold_base: float = -1.0
    streaming_threshold_step: float = 0.0


def apply_repetition_penalty(logits: torch.Tensor, presence: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """HF semantics: seen tokens' scores divided (if >0) or multiplied (if <0)."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits < 0, logits * penalty, logits / penalty)
    return torch.where(presence, penalized, logits)


def adjust_logits(logits: torch.Tensor, counts: torch.Tensor, gen: GenerationParams,
                  step_index) -> torch.Tensor:
    """Repetition penalty + the streaming ThresholdLogitsProcessor.
    ``step_index`` is an int or an int32 tensor (the decode step's device
    counter); the threshold ``base + step * i`` is taken in float32 from an
    int32 ``i``, as JAX's traced index gives it."""
    logits = apply_repetition_penalty(logits, counts > 0, gen.repetition_penalty)
    if gen.streaming_threshold_base >= 0 and gen.streaming_eos_token_id >= 0:
        if not isinstance(step_index, torch.Tensor):
            step_index = torch.tensor(step_index, dtype=torch.int32)
        threshold = gen.streaming_threshold_base + gen.streaming_threshold_step * step_index
        eos = gen.streaming_eos_token_id
        prob = torch.softmax(logits, dim=-1)[:, eos]
        logits = logits.clone()
        logits[:, eos] = torch.where(prob <= threshold,
                                     torch.full_like(prob, NEG_INF), logits[:, eos])
    return logits


def select_token(logits: torch.Tensor, gen: GenerationParams,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy or (temperature, top-k, top-p) sampling. Returns [B] int32.

    Sampling draws from ``generator`` (a torch generator on the logits'
    device); it cannot reproduce JAX's random bits, only their distribution.
    The draw is ``torch.multinomial``'s own for one sample, argmax of p / E
    with E ~ Exp(1) (the same numbers from the same generator), written out
    because ``multinomial`` reads its input's validity on the host, which a
    captured decode step may not do."""
    if not gen.do_sample:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / max(gen.temperature, 1e-6)
    neg = torch.full_like(logits, NEG_INF)
    if gen.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -gen.top_k][:, None]
        logits = torch.where(logits < kth, neg, logits)
    if gen.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest prefix with cumulative prob >= top_p
        cutoff_idx = torch.sum(cum < gen.top_p, dim=-1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, neg, logits)
    probs = torch.softmax(logits, dim=-1)
    race = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / race, dim=-1).to(torch.int32)


def update_counts(
    counts: torch.Tensor,       # [B, V] int32 token-occurrence counts (updated in place)
    ids: torch.Tensor,          # [B, Sb]
    valid_len,                  # int or int32 [B]
    remove_token,               # int or int32 [B]; -1 = nothing to remove
) -> torch.Tensor:
    """Add this chunk's first ``valid_len`` ids (repeated ids accumulate, as
    JAX's ``.at[].add``), and drop the previous chunk's final sampled token
    (it never entered the history). Returns ``counts``."""
    b, sb = ids.shape
    dev = counts.device
    valid_len = torch.as_tensor(valid_len, dtype=torch.int32, device=dev).expand(b)
    valid = (torch.arange(sb, device=dev)[None, :] < valid_len[:, None]).to(counts.dtype)
    counts.scatter_add_(1, ids.long(), valid)
    remove = torch.as_tensor(remove_token, dtype=torch.int64, device=dev).expand(b)
    rm = remove.clamp(0, counts.shape[1] - 1)
    dec = (remove >= 0).to(counts.dtype)
    counts.scatter_add_(1, rm[:, None], -dec[:, None])
    return counts


@torch.no_grad()
def prefill(
    model: Qwen2VL,
    cfg: ModelConfig,
    ids: torch.Tensor,            # [B, Sb] (right-padded to bucket)
    position_ids: torch.Tensor,   # [3, B, Sb]
    valid_len,                    # int or int32 [B] — real tokens per row
    cache: KVCache,
    vision: Optional[VisionInputs] = None,
    counts: Optional[torch.Tensor] = None,    # [B, V] presence counts
    remove_token=None,                        # int or int32 [B], -1 = none
) -> tuple[torch.Tensor, KVCache, Optional[torch.Tensor]]:
    """Write a chunk into the cache; return fp32 logits at the last valid
    token of each row; the cache offset advances by ``valid_len``."""
    b = ids.shape[0]
    dev = ids.device
    valid_len = torch.as_tensor(valid_len, dtype=torch.int32, device=dev).expand(b)
    offset = cache.offset
    kv_limit = offset + valid_len
    hidden, cache = forward(model, cfg, ids, position_ids, cache, vision=vision,
                            kv_limit=kv_limit, compute_logits=False)
    # project only the last valid position per row
    last_hidden = hidden[torch.arange(b, device=dev), (valid_len.long() - 1).clamp(min=0)]
    last = lm_logits(model.text, cfg.text, last_hidden[:, None, :])[:, 0]
    cache.offset = offset + valid_len
    if counts is not None:
        counts = update_counts(counts, ids, valid_len, -1 if remove_token is None else remove_token)
    return last, cache, counts


def continuation_pos(offset: torch.Tensor, rope_delta: torch.Tensor, batch: int) -> torch.Tensor:
    """[3, B, 1] flat positions for a single decode step (per-row offsets)."""
    pos = (offset[:, None] + rope_delta).to(torch.int32)            # [B, 1]
    return pos[None].expand(3, batch, 1)


@dataclasses.dataclass
class DecodeState:
    """The buffers one decode step reads and writes in place: the step holds
    no Python value that changes from step to step, so the card can replay
    it as a captured graph."""

    logits: torch.Tensor        # [B, V] fp32 logits of the next token
    counts: torch.Tensor        # [B, V] int32 token counts
    offset: torch.Tensor        # [B] int32 cache depth per row
    rope_delta: torch.Tensor    # [B, 1] int32
    stopped: torch.Tensor       # [B] bool
    step: torch.Tensor          # int32 []: the step index i
    tokens: torch.Tensor        # [B, max_new] int32 emitted tokens (pad after stop)
    emitted: torch.Tensor       # [B, max_new] bool
    done: torch.Tensor          # bool []: every row has stopped (set by each step)

    @staticmethod
    def empty(batch: int, vocab: int, max_new_tokens: int, device) -> "DecodeState":
        def buf(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        return DecodeState(
            logits=buf((batch, vocab), torch.float32), counts=buf((batch, vocab), torch.int32),
            offset=buf((batch,), torch.int32), rope_delta=buf((batch, 1), torch.int32),
            stopped=buf((batch,), torch.bool), step=buf((), torch.int32),
            tokens=buf((batch, max_new_tokens), torch.int32),
            emitted=buf((batch, max_new_tokens), torch.bool), done=buf((), torch.bool))


def decode_prologue(st: DecodeState, gen: GenerationParams, logits0: torch.Tensor,
                    cache: KVCache, counts: torch.Tensor, rope_delta: torch.Tensor,
                    active=None) -> None:
    """Load a chunk's starting state into ``st`` (device copies only). An
    inactive row (an idle pool slot) starts stopped: it emits only pad, its
    counts stay as they are and its offset never advances."""
    b = st.stopped.shape[0]
    st.logits.copy_(logits0)
    st.counts.copy_(counts)
    st.offset.copy_(cache.offset)
    st.rope_delta.copy_(rope_delta)
    if active is None:
        st.stopped.zero_()
    else:
        st.stopped.copy_(~torch.as_tensor(active, dtype=torch.bool,
                                          device=st.stopped.device).expand(b))
    st.step.zero_()
    st.tokens.fill_(gen.pad_token_id)
    st.emitted.zero_()


def _sample(st: DecodeState, gen: GenerationParams, generator, step_index) -> tuple:
    """Penalty, threshold, token; adds each running row's token to ``st.counts``."""
    logits = adjust_logits(st.logits, st.counts, gen, step_index)
    token = select_token(logits, gen, generator)                      # [B]
    running = ~st.stopped
    token_out = torch.where(st.stopped, torch.full_like(token, gen.pad_token_id), token)
    st.counts.scatter_add_(1, token.long()[:, None], running.to(st.counts.dtype)[:, None])
    return token, token_out


def decode_step(model: Qwen2VL, cfg: ModelConfig, gen: GenerationParams, st: DecodeState,
                cache: KVCache, generator: Optional[torch.Generator] = None) -> None:
    """One decode step, in place on ``st`` and the cache's K/V: sample at
    step ``st.step``, forward the token (a stopped row's offset stays
    frozen, so its write lands on the free slot and is overwritten later),
    write column ``st.step`` of the token buffers through the counter, and
    advance it."""
    b = st.stopped.shape[0]
    token, token_out = _sample(st, gen, generator, st.step)
    now_stopped = st.stopped | (token == gen.eos_token_id)
    pos = continuation_pos(st.offset, st.rope_delta, b)
    view = dataclasses.replace(cache, offset=st.offset)    # forward replaces the view's offset
    step_logits, _ = forward(model, cfg, token[:, None], pos, view,
                             kv_limit=st.offset + 1, compute_logits=True)
    col = st.step.long().reshape(1)
    st.tokens.index_copy_(1, col, token_out[:, None])
    st.emitted.index_copy_(1, col, ~st.stopped[:, None])
    st.offset.add_((~now_stopped).to(torch.int32))
    st.logits.copy_(step_logits[:, -1])
    st.stopped.copy_(now_stopped)
    st.done.copy_(now_stopped.all())
    st.step.add_(1)


def decode_epilogue(st: DecodeState, gen: GenerationParams, cache: KVCache,
                    counts: torch.Tensor, generator=None) -> tuple:
    """The sample-only last token, placed after each row's emitted prefix;
    the cache's offset and ``counts`` (in place) take the state's. Returns
    what ``decode_chunk`` returns, in tensors of their own."""
    b = st.stopped.shape[0]
    rows = torch.arange(b, device=st.tokens.device)
    _, last_out = _sample(st, gen, generator, gen.max_new_tokens - 1)
    n_prefix = st.emitted.sum(dim=-1)                                   # [B]
    tokens = st.tokens.clone()
    tokens[rows, n_prefix] = torch.where(st.stopped, tokens[rows, n_prefix], last_out)
    n_gen = (n_prefix + (~st.stopped).long()).to(torch.int32)
    cache.offset = st.offset.clone()
    counts.copy_(st.counts)
    return tokens, n_gen, cache, counts


@torch.no_grad()
def decode_chunk_plain(
    model: Qwen2VL,
    cfg: ModelConfig,
    gen: GenerationParams,
    logits0: torch.Tensor,
    cache: KVCache,
    counts: torch.Tensor,
    rope_delta: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    active: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, KVCache, torch.Tensor]:
    """The plain version of ``decode_chunk``: the steps run eagerly in a
    Python loop that reads the stop flags on the host before each step and
    exits once every row has stopped. ``decode_chunk`` runs it on the CPU;
    on the card tests call it by name to hold the graphs to it."""
    if gen.max_new_tokens < 1:
        raise ValueError("decode_chunk requires max_new_tokens >= 1")
    b, v = logits0.shape
    st = DecodeState.empty(b, v, gen.max_new_tokens, logits0.device)
    decode_prologue(st, gen, logits0, cache, counts, rope_delta, active)
    for _ in range(gen.max_new_tokens - 1):
        if bool(st.stopped.all()):
            break
        decode_step(model, cfg, gen, st, cache, generator)
    return decode_epilogue(st, gen, cache, counts, generator)


@torch.no_grad()
def decode_chunk(
    model: Qwen2VL,
    cfg: ModelConfig,
    gen: GenerationParams,
    logits0: torch.Tensor,        # [B, V] fp32 logits at the last prompt token
    cache: KVCache,
    counts: torch.Tensor,         # [B, V] int32 — token counts seen so far
    rope_delta: torch.Tensor,     # int32 [B, 1]
    generator: Optional[torch.Generator] = None,
    active: Optional[torch.Tensor] = None,   # bool [B] (or scalar); False = no-op row
) -> tuple[torch.Tensor, torch.Tensor, KVCache, torch.Tensor]:
    """Decode up to max_new_tokens.

    Returns (tokens [B, max_new] — pad after stop, n_generated [B], cache —
    offset advanced by the number of forwarded tokens, counts — updated in
    place). Only the first max_new_tokens - 1 sampled tokens are ever
    forwarded; the last one comes from a sample-only epilogue. The loop
    exits once every row has stopped (stopped rows only ever emit pad, so
    the output is the same).

    CPU tensors run the plain version (``decode_chunk_plain``). CUDA tensors
    replay the model's captured decode step (``engine/graphs.py``); a
    capture or replay that fails raises. Any other device raises."""
    if logits0.device.type == "cpu":
        return decode_chunk_plain(model, cfg, gen, logits0, cache, counts, rope_delta,
                                  generator, active)
    if logits0.device.type != "cuda":
        raise RuntimeError(f"decode_chunk: no decode path for device {logits0.device}")
    from livecc_tpu_torch.engine.graphs import graphs_for     # imports this module

    return graphs_for(model, cfg).decode(model, gen, logits0, cache, counts, rope_delta,
                                         generator, active)
