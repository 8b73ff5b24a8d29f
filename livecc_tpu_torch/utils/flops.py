"""Analytic FLOP counts for model FLOP/s reporting.

A copy of ``train_step_flops`` and its helpers from
``livecc_tpu/utils/flops.py`` (that module imports the JAX package's
config), counting the matmul and attention FLOPs of the Qwen2-VL towers
from the config; ``tools/train_session.py`` reports model FLOP/s with it.

Conventions: one multiply-accumulate = 2 FLOPs; backward = 2x forward for
trainable weights; frozen modules (the ViT by default) count forward only.
The attention term assumes one causal segment of ``seq_len`` tokens.
"""

from __future__ import annotations

from livecc_tpu_torch.core.config import ModelConfig, TextConfig, VisionConfig


def llm_matmul_params(cfg: TextConfig) -> int:
    """Per-layer matmul weights x layers (excludes embed lookup / lm_head)."""
    h, i = cfg.hidden_size, cfg.intermediate_size
    kv = cfg.num_key_value_heads * cfg.head_dim
    per_layer = (h * h) * 2 + (h * kv) * 2 + (h * i) * 2 + (i * h)
    return cfg.num_hidden_layers * per_layer


def llm_forward_flops(cfg: TextConfig, seq_len: int, causal: bool = True) -> int:
    """Dense matmuls + attention for one [1, seq_len] forward."""
    matmul = 2 * seq_len * llm_matmul_params(cfg)
    # QK^T + AV: 2 * (2 * S^2 * H) per layer, halved for causal masking.
    attn = cfg.num_hidden_layers * 4 * seq_len * seq_len * cfg.hidden_size
    if causal:
        attn //= 2
    return matmul + attn


def vit_forward_flops(cfg: VisionConfig, n_patches: int, group: int | None = None) -> int:
    """ViT blocks + patch embed + merger for n_patches flattened patches.

    ``group`` is the per-temporal-group patch count of the blocked O(N)
    attention path (each group attends within itself); None = full N^2.
    """
    e, m, d = cfg.embed_dim, cfg.mlp_hidden_dim, cfg.depth
    per_patch_block = (e * 3 * e) + (e * e) + (e * m) + (m * e)
    matmul = 2 * n_patches * d * per_patch_block
    span = group if group else n_patches
    attn = d * 4 * n_patches * span * e
    embed = 2 * n_patches * cfg.patch_dim * e
    md = e * cfg.spatial_merge_size**2
    merger = 2 * (n_patches // cfg.spatial_merge_size**2) * (md * md + md * cfg.hidden_size)
    return matmul + attn + embed + merger


def lm_head_flops(cfg: TextConfig, n_positions: int) -> int:
    """Logit projection at ``n_positions`` positions (chunked CE computes
    the full vocab row per supervised position)."""
    return 2 * n_positions * cfg.hidden_size * cfg.vocab_size


def train_step_flops(
    cfg: ModelConfig,
    seq_len: int,
    sup_tokens: int,
    n_patches: int = 0,
    vit_group: int | None = None,
    accum: int = 1,
    vit_frozen: bool = True,
) -> int:
    """Total FLOPs of one compiled train step (accum micro-batches of bs 1)."""
    llm = 3 * llm_forward_flops(cfg.text, seq_len)          # fwd + bwd
    head = 3 * lm_head_flops(cfg.text, sup_tokens)
    vit = vit_forward_flops(cfg.vision, n_patches, vit_group) if n_patches else 0
    vit *= 1 if vit_frozen else 3
    return accum * (llm + head + vit)
