"""Plain PyTorch reference attention (``livecc_tpu/ops/attention.py`` semantics).

These functions mirror the JAX module's reference attention; the tests
hold them to it (the vision tower's mixed sizes go to K3's bounds form):

  * ``mha`` / ``mha_bhsd`` — full attention, fp32 logits and softmax,
    probabilities cast to the model dtype for the pv product, GQA by head
    repetition. Masked logits take ``finfo(float32).min`` (not ``-inf``), so
    a fully masked row averages uniformly, exactly as in JAX.
  * ``causal_mask``, ``kv_cache_mask`` (per-row offsets), ``segment_mask``.

The serving kernels live in ``ops/flash_attention.py`` (K1, K2) and
``ops/vit_attention.py`` (K3). ``train_flash_attention`` is the training
attention's contract (JAX ``ops/attention.py:39``): both impls, "splash" and
"flash", go to the K4 kernels of ``ops/train_attention.py``;
``train_attention_plain`` is its plain version with splash's semantics,
differentiated by autograd. JAX's ``TRAIN_ATTN`` switch is read at import
and must name one of those impls; as both run K4, it selects nothing.
"""

from __future__ import annotations

import torch

from livecc_tpu_torch.core.config import env_switch
from livecc_tpu_torch.ops.train_attention import TrainAttention, train_attention_fwd_plain

NEG_INF = torch.finfo(torch.float32).min
TRAIN_IMPLS = ("splash", "flash")


def train_attn_switch() -> str:
    """JAX's ``TRAIN_ATTN`` (``ops/attention.py:36``), checked against
    ``TRAIN_IMPLS``."""
    return env_switch("TRAIN_ATTN", "splash", TRAIN_IMPLS)


TRAIN_ATTN = train_attn_switch()            # read at import, as JAX reads it


def segment_ids(q: torch.Tensor, attention_mask: torch.Tensor | None) -> torch.Tensor:
    """int32 [B, S] segment ids: a bool validity mask becomes 0/1 (JAX
    ``astype(int32)``), int ids pass as they are, no mask is one segment."""
    if attention_mask is None:
        return torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
    return attention_mask.to(device=q.device, dtype=torch.int32)


def prescaled(q: torch.Tensor) -> torch.Tensor:
    """Splash takes pre-scaled q, rounded to q's dtype (JAX ``attention.py:140``)."""
    return (q * q.shape[-1] ** -0.5).to(q.dtype)


def train_flash_attention(
    q: torch.Tensor,                 # [B, S, Hq, D]
    k: torch.Tensor,                 # [B, S, Hk, D]
    v: torch.Tensor,                 # [B, S, Hk, D]
    attention_mask: torch.Tensor | None = None,   # bool [B, S] valid, or int32 segment ids
    causal: bool = True,
    impl: str | None = None,
) -> torch.Tensor:
    """TRAINING attention with a backward: K4 on CUDA, its plain version on
    the CPU. Query i attends key j iff their segment ids match and, when
    ``causal`` (JAX's default and every training caller's), j <= i:
    splash's ``CausalMask``, or its ``FullMask`` without the causal term.
    Pads (id 0) attend among themselves. No [S, S] array on CUDA."""
    if impl not in (None, *TRAIN_IMPLS):
        raise ValueError(f"train_flash_attention: unknown impl {impl!r}")
    return TrainAttention.apply(prescaled(q), k, v, segment_ids(q, attention_mask), causal)


def train_attention_plain(q, k, v, attention_mask=None) -> torch.Tensor:
    """Plain version of ``train_flash_attention`` (splash semantics) in plain
    torch ops, for autograd to differentiate."""
    return train_attention_fwd_plain(prescaled(q), k, v, segment_ids(q, attention_mask))[0]


def mha(
    q: torch.Tensor,                 # [B, Sq, Hq, D]
    k: torch.Tensor,                 # [B, Skv, Hk, D]
    v: torch.Tensor,                 # [B, Skv, Hk, D]
    mask: torch.Tensor | None = None,  # bool, broadcastable to [B, Hq, Sq, Skv]; True = attend
    scale: float | None = None,
) -> torch.Tensor:
    """Reference attention: fp32 logits+softmax, GQA via head repetition."""
    out = mha_bhsd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask, scale)
    return out.transpose(1, 2)


def mha_bhsd(
    q: torch.Tensor,                 # [B, Hq, Sq, D]
    k: torch.Tensor,                 # [B, Hk, Skv, D]
    v: torch.Tensor,                 # [B, Hk, Skv, D]
    mask: torch.Tensor | None = None,  # bool, broadcastable to [B, Hq, Sq, Skv]
    scale: float | None = None,
) -> torch.Tensor:
    """BHSD-layout reference attention."""
    hq, d = q.shape[1], q.shape[-1]
    hk = k.shape[1]
    if hq != hk:
        rep = hq // hk
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = d ** -0.5 if scale is None else scale
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def causal_mask(sq: int, skv: int | None = None, device=None) -> torch.Tensor:
    """[Sq, Skv] lower-triangular mask (queries aligned to the cache tail)."""
    skv = sq if skv is None else skv
    qi = torch.arange(sq, device=device)[:, None] + (skv - sq)
    ki = torch.arange(skv, device=device)[None, :]
    return ki <= qi


def kv_cache_mask(sq: int, cache_len: int, offset: torch.Tensor | int) -> torch.Tensor:
    """Causal mask for queries appended at ``offset`` into a static cache.

    Query i (global position offset+i) may attend cache slots [0, offset+i].
    ``offset`` may be a scalar (returns bool [Sq, cache_len]) or a [B] tensor
    of per-row cache depths (returns bool [B, 1, Sq, cache_len]).
    """
    offset = torch.as_tensor(offset)
    kpos = torch.arange(cache_len, device=offset.device)
    qi = torch.arange(sq, device=offset.device)
    if offset.ndim == 0:
        qpos = offset + qi[:, None]
        return kpos[None, :] <= qpos
    qpos = offset[:, None] + qi[None, :]                      # [B, Sq]
    return kpos[None, None, None, :] <= qpos[:, None, :, None]


def segment_mask(seg_ids: torch.Tensor) -> torch.Tensor:
    """Block-diagonal [N, N] mask: attend only within the same segment."""
    return seg_ids[:, None] == seg_ids[None, :]
