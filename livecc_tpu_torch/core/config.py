"""Model configuration tree: a field-for-field mirror of ``livecc_tpu/core/config.py``.

The JAX package's ``core/__init__.py`` imports its device-mesh module, which
loads ``jax``; the port keeps its own copy of the (pure) dataclasses so that
importing it never does. ``tests/test_torch_package.py`` pins every preset to
the JAX one with ``dataclasses.asdict``.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """Qwen2-VL ViT tower (transformers Qwen2VLVisionConfig semantics)."""

    depth: int = 32
    embed_dim: int = 1280
    num_heads: int = 16
    mlp_ratio: float = 4.0
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    hidden_size: int = 3584          # output dim (LLM hidden)
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_hidden_dim(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size**2


@dataclasses.dataclass(frozen=True)
class TextConfig:
    """Qwen2 LLM (transformers Qwen2VLTextConfig semantics)."""

    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    mrope_section: tuple[int, int, int] = (16, 24, 24)
    max_position_embeddings: int = 32768
    tie_word_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Full multimodal model config + special token ids."""

    vision: VisionConfig = VisionConfig()
    text: TextConfig = TextConfig()

    # Special token ids (Qwen2-VL tokenizer).
    bos_token_id: int = 151643
    eos_token_id: int = 151645       # <|im_end|>
    pad_token_id: int = 151643
    im_start_token_id: int = 151644
    im_end_token_id: int = 151645
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653
    image_token_id: int = 151655
    video_token_id: int = 151656

    name: str = "qwen2-vl-7b"

    @staticmethod
    def qwen2_vl_7b() -> "ModelConfig":
        """LiveCC-7B-Instruct / Qwen2-VL-7B-Instruct shapes."""
        return ModelConfig()

    @staticmethod
    def qwen2_vl_2b() -> "ModelConfig":
        """Qwen2-VL-2B shapes."""
        return ModelConfig(
            vision=VisionConfig(hidden_size=1536),
            text=TextConfig(
                vocab_size=151936,
                hidden_size=1536,
                intermediate_size=8960,
                num_hidden_layers=28,
                num_attention_heads=12,
                num_key_value_heads=2,
                tie_word_embeddings=True,
            ),
            name="qwen2-vl-2b",
        )

    @staticmethod
    def qwen2_vl_72b() -> "ModelConfig":
        """Qwen2-VL-72B shapes (mrope_section scales with head_dim=128)."""
        return ModelConfig(
            vision=VisionConfig(hidden_size=8192),
            text=TextConfig(
                vocab_size=152064,
                hidden_size=8192,
                intermediate_size=29568,
                num_hidden_layers=80,
                num_attention_heads=64,
                num_key_value_heads=8,
                rms_norm_eps=1e-6,
            ),
            name="qwen2-vl-72b",
        )


def tiny_config(vocab_size: int = 1024) -> ModelConfig:
    """Small random-init config for CPU tests.

    head_dim = 16, so mrope_section (2, 3, 3) sums to head_dim // 2 = 8,
    mirroring the 7B's (16, 24, 24) -> 64 relationship.
    """
    return ModelConfig(
        vision=VisionConfig(depth=2, embed_dim=64, num_heads=4, hidden_size=64),
        text=TextConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            mrope_section=(2, 3, 3),
        ),
        bos_token_id=0,
        eos_token_id=3,
        pad_token_id=0,
        im_start_token_id=2,
        im_end_token_id=3,
        vision_start_token_id=4,
        vision_end_token_id=5,
        image_token_id=6,
        video_token_id=7,
        name="tiny",
    )


def env_switch(name: str, default: str, choices: tuple[str, ...]) -> str:
    """Environment variable ``name`` (``default`` where unset), one of
    ``choices``: the JAX package's experiment switches (``TRAIN_ATTN``,
    ``CE_LOGITS``, ``CE_IMPL``), read once at import as JAX reads them.
    Raises on any other value."""
    value = os.environ.get(name, default)
    if value not in choices:
        raise ValueError(f"{name}={value!r}: expected one of {', '.join(choices)}")
    return value
