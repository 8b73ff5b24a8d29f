"""Whisper encoder-decoder in PyTorch (the ASR model of ``tools/asr.py``).

Port of ``livecc_tpu/models/whisper/model.py`` (transformers
WhisperForConditionalGeneration semantics): pre-LN blocks, q scaled by
head_dim^-0.5 after its bias, k projections without bias, the stored
(sinusoidal) encoder positions, learned decoder positions, exact GELU, a
tied LM head with fp32 logits.

The modules carry HF's parameter names below ``model.`` (``encoder.conv1``,
``encoder.layers.{i}.self_attn.q_proj``, ``decoder.embed_tokens``, ...), so
an HF state dict loads with its prefix stripped (``convert.py``). The
convolutions are ``nn.Conv1d`` on HF's ``[out, in, k]`` weights.

Attention (``_mha``) is JAX's einsum formula in plain PyTorch, not a fused
kernel: the scores are computed in the operands' dtype and then widened to
fp32, the softmax is fp32, and the normalised probabilities are rounded to
the value dtype before P·V. (SDPA keeps the scores in fp32, which parts from
JAX in bf16.) Whisper has no Pallas kernel in the JAX package.

Greedy decoding keeps JAX's structure: each step recomputes the decoder
over the whole prefix, padded to a power-of-two bucket, and takes the
argmax at the last real position; only that position goes through the LM
head. A self-attention KV cache and cross-attention K/V computed once per
segment are later work.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """Shapes mirror HF WhisperConfig; defaults = large-v3-turbo."""

    num_mel_bins: int = 128
    d_model: int = 1280
    encoder_layers: int = 32
    decoder_layers: int = 4
    num_heads: int = 20
    ffn_dim: int = 5120
    vocab_size: int = 51866
    max_source_positions: int = 1500
    max_target_positions: int = 448
    # special ids (large-v3 tokenizer)
    decoder_start_token_id: int = 50258   # <|startoftranscript|>
    eos_token_id: int = 50257             # <|endoftext|>
    no_timestamps_token_id: int = 50364
    timestamp_begin: int = 50365          # <|0.00|>

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def tiny_whisper_config(vocab_size: int = 256) -> WhisperConfig:
    return WhisperConfig(
        num_mel_bins=16, d_model=32, encoder_layers=2, decoder_layers=2,
        num_heads=4, ffn_dim=64, vocab_size=vocab_size,
        max_source_positions=32, max_target_positions=32,
        decoder_start_token_id=1, eos_token_id=2,
        no_timestamps_token_id=10, timestamp_begin=11,
    )


def _mha(q, k, v, num_heads: int, causal: bool = False) -> torch.Tensor:
    """[B, Sq, D] x [B, Sk, D] -> [B, Sq, D]; q pre-scaled by the caller."""
    b, sq, d = q.shape
    sk = k.shape[1]
    hd = d // num_heads
    qh = q.reshape(b, sq, num_heads, hd).transpose(1, 2)
    kh = k.reshape(b, sk, num_heads, hd).transpose(1, 2)
    vh = v.reshape(b, sk, num_heads, hd).transpose(1, 2)
    s = (qh @ kh.transpose(-1, -2)).float()
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
        s = torch.where(mask, s, torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1).to(vh.dtype)
    return (p @ vh).transpose(1, 2).reshape(b, sq, d)


class Attention(nn.Module):
    """HF ``WhisperAttention``'s parameters: q / v / out with bias, k without."""

    def __init__(self, cfg: WhisperConfig, device=None, dtype=None):
        super().__init__()
        d, kw = cfg.d_model, dict(device=device, dtype=dtype)
        self.q_proj = nn.Linear(d, d, **kw)
        self.k_proj = nn.Linear(d, d, bias=False, **kw)
        self.v_proj = nn.Linear(d, d, **kw)
        self.out_proj = nn.Linear(d, d, **kw)
        self.num_heads, self.scale = cfg.num_heads, cfg.head_dim ** -0.5

    def forward(self, x, source=None, causal: bool = False) -> torch.Tensor:
        source = x if source is None else source
        q = self.q_proj(x) * self.scale
        o = _mha(q, self.k_proj(source), self.v_proj(source), self.num_heads, causal)
        return self.out_proj(o)


def _mlp(layer, x) -> torch.Tensor:
    y = layer.final_layer_norm(x)
    return layer.fc2(F.gelu(layer.fc1(y)))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.self_attn = Attention(cfg, **kw)
        self.self_attn_layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5, **kw)
        self.fc1 = nn.Linear(cfg.d_model, cfg.ffn_dim, **kw)
        self.fc2 = nn.Linear(cfg.ffn_dim, cfg.d_model, **kw)
        self.final_layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5, **kw)

    def forward(self, x) -> torch.Tensor:
        x = x + self.self_attn(self.self_attn_layer_norm(x))
        return x + _mlp(self, x)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.self_attn = Attention(cfg, **kw)
        self.self_attn_layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5, **kw)
        self.encoder_attn = Attention(cfg, **kw)
        self.encoder_attn_layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5, **kw)
        self.fc1 = nn.Linear(cfg.d_model, cfg.ffn_dim, **kw)
        self.fc2 = nn.Linear(cfg.ffn_dim, cfg.d_model, **kw)
        self.final_layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5, **kw)

    def forward(self, x, encoder_states) -> torch.Tensor:
        x = x + self.self_attn(self.self_attn_layer_norm(x), causal=True)
        x = x + self.encoder_attn(self.encoder_attn_layer_norm(x), encoder_states)
        return x + _mlp(self, x)


class Encoder(nn.Module):
    def __init__(self, cfg: WhisperConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.d_model
        self.conv1 = nn.Conv1d(cfg.num_mel_bins, d, 3, padding=1, **kw)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1, **kw)
        self.embed_positions = nn.Embedding(cfg.max_source_positions, d, **kw)
        self.layers = nn.ModuleList(EncoderLayer(cfg, **kw) for _ in range(cfg.encoder_layers))
        self.layer_norm = nn.LayerNorm(d, eps=1e-5, **kw)


class Decoder(nn.Module):
    def __init__(self, cfg: WhisperConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.d_model
        self.embed_tokens = nn.Embedding(cfg.vocab_size, d, **kw)
        self.embed_positions = nn.Embedding(cfg.max_target_positions, d, **kw)
        self.layers = nn.ModuleList(DecoderLayer(cfg, **kw) for _ in range(cfg.decoder_layers))
        self.layer_norm = nn.LayerNorm(d, eps=1e-5, **kw)


class Whisper(nn.Module):
    """``encoder`` + ``decoder`` (HF ``WhisperModel``'s layout); the LM head
    is the decoder's token embedding. Built frozen: the port only infers."""

    def __init__(self, cfg: WhisperConfig, device=None, dtype=None):
        super().__init__()
        self.encoder = Encoder(cfg, device, dtype)
        self.decoder = Decoder(cfg, device, dtype)
        self.requires_grad_(False)


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> np.ndarray:
    """HF's encoder position table (``modeling_whisper.sinusoids``): sin in
    the first half of the channels, cos in the second."""
    inc = math.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


@torch.no_grad()
def init_whisper(cfg: WhisperConfig, generator: torch.Generator, device=None,
                 dtype=torch.float32) -> Whisper:
    """Random-init model drawn on ``device`` from ``generator`` (which must
    live there): HF's scheme, every matrix, conv and embedding ~ N(0, 0.02),
    norm scales 1, biases 0, and the sinusoidal encoder positions."""
    model = Whisper(cfg, device=device, dtype=dtype)
    for name, p in model.named_parameters():
        if name == "encoder.embed_positions.weight":
            p.copy_(torch.from_numpy(sinusoids(*p.shape)))
        elif p.ndim >= 2:
            p.normal_(0.0, 0.02, generator=generator)
        elif "layer_norm" in name and name.endswith("weight"):
            p.fill_(1.0)
        else:
            p.zero_()
    return model


def whisper_encode(model: Whisper, cfg: WhisperConfig, mel: torch.Tensor) -> torch.Tensor:
    """[B, n_mels, 3000] -> [B, 1500, D] encoder states, in the model's dtype."""
    enc = model.encoder
    x = mel.to(device=enc.conv1.weight.device, dtype=enc.conv1.weight.dtype)
    x = F.gelu(enc.conv1(x))
    x = F.gelu(enc.conv2(x)).transpose(1, 2)                   # [B, 1500, D]
    x = x + enc.embed_positions.weight[: x.shape[1]]
    for layer in enc.layers:
        x = layer(x)
    return enc.layer_norm(x)


def decoder_hidden(model: Whisper, cfg: WhisperConfig, ids: torch.Tensor,
                   encoder_states: torch.Tensor, position_offset: int = 0) -> torch.Tensor:
    """Full-prefix decoder over ``ids`` [B, S] -> final-LN hidden states [B, S, D]."""
    dec = model.decoder
    pos = torch.arange(ids.shape[1], device=ids.device) + position_offset
    x = dec.embed_tokens(ids) + dec.embed_positions(pos)
    for layer in dec.layers:
        x = layer(x, encoder_states)
    return dec.layer_norm(x)


def lm_logits(model: Whisper, hidden: torch.Tensor) -> torch.Tensor:
    """Tied LM head: hidden @ embed^T in the model dtype, then fp32 (JAX
    ``(x @ embed.T).astype(float32)``)."""
    return F.linear(hidden, model.decoder.embed_tokens.weight).float()


def whisper_decode(model: Whisper, cfg: WhisperConfig, ids: torch.Tensor,
                   encoder_states: torch.Tensor, position_offset: int = 0) -> torch.Tensor:
    """Full-prefix decoder forward -> fp32 logits [B, S, V] (no cache)."""
    return lm_logits(model, decoder_hidden(model, cfg, ids, encoder_states, position_offset))


def _bucket(n: int, cap: int) -> int:
    bucket = 8
    while bucket < n:
        bucket *= 2
    return min(bucket, cap)


@torch.no_grad()
def greedy_transcribe_tokens(
    model: Whisper,
    cfg: WhisperConfig,
    mel: np.ndarray,                       # [n_mels, 3000] one 30 s segment
    prompt_ids: list[int],
    max_new_tokens: int | None = None,
) -> list[int]:
    """Greedy token ids for one segment (JAX ``greedy_transcribe_tokens``).

    ``max_new_tokens`` is clamped to ``max_target_positions - len(prompt)``;
    each step runs the decoder over the prefix in a power-of-two bucket (a
    causal decoder leaves the pads inert) and takes the argmax of the fp32
    logits at the last real position; decoding stops at EOS."""
    device = model.decoder.embed_tokens.weight.device
    max_new = max_new_tokens or cfg.max_target_positions
    max_new = min(max_new, cfg.max_target_positions - len(prompt_ids))
    enc = whisper_encode(model, cfg, torch.as_tensor(mel)[None])
    ids = list(prompt_ids)
    buf = torch.zeros(1, cfg.max_target_positions, dtype=torch.long, device=device)
    buf[0, : len(ids)] = torch.tensor(ids, device=device)
    for _ in range(max_new):
        n = len(ids)
        hidden = decoder_hidden(model, cfg, buf[:, : _bucket(n, cfg.max_target_positions)], enc)
        nxt = int(lm_logits(model, hidden[:, n - 1])[0].argmax())
        ids.append(nxt)
        if nxt == cfg.eos_token_id:
            break
        if len(ids) < cfg.max_target_positions:
            buf[0, n] = nxt
    return ids[len(prompt_ids):]
