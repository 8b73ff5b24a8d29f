"""Bucketed prefill + decode loop for streaming generation.

Port of ``livecc_tpu/engine/generation.py``. Semantics pinned to the
reference stack, as in JAX:

  * the first prefill uses full 3D M-RoPE positions; later chunks and
    decode steps use flat ``offset + rope_delta`` positions;
  * the final sampled token of each chunk is NOT forwarded (its KV never
    enters the cache; reference ``past_ids = sequences[:, :-1]``);
  * the repetition penalty applies over prompt + generated presence counts,
    kept on the device and updated incrementally.

The decode loop is a Python loop over cached forwards that stops early once
every row has stopped (one host read of the stop flags per step). The KV
cache is updated in place; its ``offset`` is replaced by each call.
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
                  step_index: int) -> torch.Tensor:
    """Repetition penalty + the streaming ThresholdLogitsProcessor."""
    logits = apply_repetition_penalty(logits, counts > 0, gen.repetition_penalty)
    if gen.streaming_threshold_base >= 0 and gen.streaming_eos_token_id >= 0:
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
    device); it cannot reproduce JAX's random bits, only their distribution."""
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
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


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
    offset advanced by the number of forwarded tokens, counts). Only the
    first max_new_tokens - 1 sampled tokens are ever forwarded; the last one
    comes from a sample-only epilogue. The loop exits once every row has
    stopped (stopped rows only ever emit pad, so the output is the same)."""
    if gen.max_new_tokens < 1:
        raise ValueError("decode_chunk requires max_new_tokens >= 1")
    b = logits0.shape[0]
    dev = logits0.device
    rows = torch.arange(b, device=dev)

    def sample(logits, counts, stopped, i):
        logits = adjust_logits(logits, counts, gen, i)
        token = select_token(logits, gen, generator)                  # [B]
        token_out = torch.where(stopped, torch.full_like(token, gen.pad_token_id), token)
        counts[rows, token.long()] += (~stopped).to(counts.dtype)    # one id per row: no repeats
        return token, token_out, counts

    stopped = torch.zeros(b, dtype=torch.bool, device=dev)
    if active is not None:
        # an inactive row (an idle pool slot) starts stopped: it emits only
        # pad, its counts stay as they are and its offset never advances
        stopped = ~torch.as_tensor(active, dtype=torch.bool, device=dev).expand(b)
    n_steps = gen.max_new_tokens - 1
    tokens_buf = torch.full((b, gen.max_new_tokens), gen.pad_token_id, dtype=torch.int32, device=dev)
    emitted_buf = torch.zeros((b, gen.max_new_tokens), dtype=torch.bool, device=dev)
    logits = logits0
    i = 0
    while i < n_steps and not bool(stopped.all()):
        token, token_out, counts = sample(logits, counts, stopped, i)
        now_stopped = stopped | (token == gen.eos_token_id)
        # forward the sampled token; a stopped row's offset stays frozen, so
        # its write lands on the free slot and is overwritten later
        offset = cache.offset
        pos = continuation_pos(offset, rope_delta, b)
        step_logits, cache = forward(model, cfg, token[:, None], pos, cache,
                                     kv_limit=offset + 1, compute_logits=True)
        cache.offset = offset + (~now_stopped).to(torch.int32)
        tokens_buf[:, i] = token_out
        emitted_buf[:, i] = ~stopped
        logits, stopped = step_logits[:, -1], now_stopped
        i += 1
    _, last_out, counts = sample(logits, counts, stopped, n_steps)
    # the epilogue token follows each row's emitted prefix
    n_prefix = emitted_buf.sum(dim=-1)                                  # [B]
    tokens_buf[rows, n_prefix] = torch.where(stopped, tokens_buf[rows, n_prefix], last_out)
    n_gen = (n_prefix + (~stopped).long()).to(torch.int32)
    return tokens_buf, n_gen, cache, counts
