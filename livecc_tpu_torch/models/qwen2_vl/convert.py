"""HF Qwen2-VL checkpoint -> the port's ``Qwen2VL`` module.

Port of ``livecc_tpu/models/qwen2_vl/convert.py``. An HF state dict keeps
``nn.Linear``'s ``[out, in]`` weights, the port's own layout, so no weight
is transposed; the one reshape is the Conv3d patch embed ``[embed, C, tps,
ps, ps]`` -> ``[embed, C * tps * ps * ps]``. Both HF key eras are read
(``_canonicalize``): hub-era ``visual.*`` / ``model.layers.*`` (the pinned
LiveCC-7B-Instruct) and transformers>=4.52 ``model.visual.*`` /
``model.language_model.*``.

``convert_state_dict`` builds the model on the ``meta`` device, gives it
empty storage on the target device and fills every parameter exactly once,
its shape checked, tensor by tensor: no random init, and no second copy of
the model on the host. ``load_checkpoint`` does so from the shards of a
checkpoint directory (``safetensors_io.Shards``, which reads a tensor's
bytes when it is asked for). A value is
cast with ``copy_``: fp32 -> bf16 rounds to nearest even, as
``jnp.asarray(..., bfloat16)`` does. Checkpoint tensors the model has no
parameter for (``lm_head.weight`` beside tied embeddings) are skipped, as
JAX skips them, with a warning that names them.
"""

from __future__ import annotations

import json
import os
import re
import warnings
from typing import Any, Mapping

import torch

from livecc_tpu_torch.core.config import ModelConfig, TextConfig, VisionConfig
from livecc_tpu_torch.models.qwen2_vl.model import Qwen2VL
from livecc_tpu_torch.models.qwen2_vl.safetensors_io import Shards
from livecc_tpu_torch.utils.device import device_for

# port parameter (relative to a vision block / decoder layer) -> HF name
_VISION_BLOCK = {
    "norm1.weight": "norm1.weight", "norm1.bias": "norm1.bias",
    "norm2.weight": "norm2.weight", "norm2.bias": "norm2.bias",
    "qkv.weight": "attn.qkv.weight", "qkv.bias": "attn.qkv.bias",
    "proj.weight": "attn.proj.weight", "proj.bias": "attn.proj.bias",
    "fc1.weight": "mlp.fc1.weight", "fc1.bias": "mlp.fc1.bias",
    "fc2.weight": "mlp.fc2.weight", "fc2.bias": "mlp.fc2.bias",
}
_DECODER_LAYER = {
    "input_ln.weight": "input_layernorm.weight",
    "post_ln.weight": "post_attention_layernorm.weight",
    "q_proj.weight": "self_attn.q_proj.weight", "q_proj.bias": "self_attn.q_proj.bias",
    "k_proj.weight": "self_attn.k_proj.weight", "k_proj.bias": "self_attn.k_proj.bias",
    "v_proj.weight": "self_attn.v_proj.weight", "v_proj.bias": "self_attn.v_proj.bias",
    "o_proj.weight": "self_attn.o_proj.weight",
    "gate_proj.weight": "mlp.gate_proj.weight",
    "up_proj.weight": "mlp.up_proj.weight",
    "down_proj.weight": "mlp.down_proj.weight",
}
PATCH_EMBED = "visual.patch_embed.weight"


def _canonicalize(key: str) -> str:
    key = re.sub(r"^model\.visual\.", "visual.", key)
    key = re.sub(r"^model\.language_model\.", "llm.", key)
    key = re.sub(r"^model\.", "llm.", key)          # hub-era "model.layers.*"
    key = re.sub(r"^language_model\.", "llm.", key)
    return key


def hf_name_map(cfg: ModelConfig) -> dict[str, str]:
    """port parameter name -> canonical HF name (``_canonicalize``'s)."""
    out = {
        PATCH_EMBED: "visual.patch_embed.proj.weight",
        "visual.merger.ln_q.weight": "visual.merger.ln_q.weight",
        "visual.merger.ln_q.bias": "visual.merger.ln_q.bias",
        "visual.merger.fc1.weight": "visual.merger.mlp.0.weight",
        "visual.merger.fc1.bias": "visual.merger.mlp.0.bias",
        "visual.merger.fc2.weight": "visual.merger.mlp.2.weight",
        "visual.merger.fc2.bias": "visual.merger.mlp.2.bias",
        "text.embed.weight": "llm.embed_tokens.weight",
        "text.final_ln.weight": "llm.norm.weight",
    }
    if not cfg.text.tie_word_embeddings:
        out["text.lm_head.weight"] = "lm_head.weight"
    for i in range(cfg.vision.depth):
        for name, hf in _VISION_BLOCK.items():
            out[f"visual.blocks.{i}.{name}"] = f"visual.blocks.{i}.{hf}"
    for i in range(cfg.text.num_hidden_layers):
        for name, hf in _DECODER_LAYER.items():
            out[f"text.layers.{i}.{name}"] = f"llm.layers.{i}.{hf}"
    return out


@torch.no_grad()
def convert_state_dict(state: Mapping[str, Any], cfg: ModelConfig, device=None,
                       dtype: torch.dtype = torch.float32) -> Qwen2VL:
    """A ``Qwen2VL`` on ``device`` in ``dtype`` holding an HF
    Qwen2VLForConditionalGeneration state dict (numpy arrays or tensors).
    Every port parameter must be in ``state`` (KeyError) with its shape
    (ValueError). Each value is read once, when its parameter is filled."""
    keys: dict[str, str] = {}
    for key in state:
        canon = _canonicalize(key)
        if canon in keys:
            raise ValueError(f"checkpoint keys {keys[canon]} and {key} name one tensor ({canon})")
        keys[canon] = key
    names = hf_name_map(cfg)
    missing = sorted(hf for hf in names.values() if hf not in keys)
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} tensors the model needs: {missing[:8]}")
    model = Qwen2VL(cfg, device="meta", dtype=dtype).to_empty(device=device or "cpu")
    params = dict(model.named_parameters())
    if set(params) != set(names):
        raise KeyError(f"name map and model disagree: {sorted(set(params) ^ set(names))}")
    for name, hf in names.items():
        src = torch.as_tensor(state[keys[hf]])
        if name == PATCH_EMBED:
            src = src.reshape(cfg.vision.embed_dim, -1)
        if tuple(src.shape) != tuple(params[name].shape):
            raise ValueError(f"{name}: checkpoint {keys[hf]} has shape {tuple(src.shape)}, "
                             f"the model {tuple(params[name].shape)}")
        params[name].copy_(src)
        del src
    on_meta = [n for n, t in [*model.named_parameters(), *model.named_buffers()] if t.is_meta]
    if on_meta:
        raise RuntimeError(f"left on the meta device: {on_meta[:8]}")
    skipped = sorted(set(keys) - set(names.values()))
    if skipped:
        warnings.warn(f"convert_state_dict: skipped {len(skipped)} checkpoint tensors the "
                      f"model has no parameter for: {[keys[k] for k in skipped[:8]]}")
    return model


def config_from_hf_json(path: str) -> ModelConfig:
    """A ``ModelConfig`` from the ``config.json`` of a checkpoint directory,
    as JAX's: hub-era Qwen2-VL / LiveCC checkpoints keep the text fields at
    the top level; transformers>=4.52 nests them under ``text_config``."""
    with open(os.path.join(path, "config.json")) as f:
        full = json.load(f)
    hf = full.get("text_config", full)
    v = full.get("vision_config", {})
    rope_scaling = hf.get("rope_scaling") or full.get("rope_scaling") or {}
    return ModelConfig(
        vision=VisionConfig(
            depth=v.get("depth", 32),
            embed_dim=v.get("embed_dim", 1280),
            num_heads=v.get("num_heads", 16),
            mlp_ratio=v.get("mlp_ratio", 4.0),
            in_channels=v.get("in_channels", 3),
            patch_size=v.get("patch_size", 14),
            temporal_patch_size=v.get("temporal_patch_size", 2),
            spatial_merge_size=v.get("spatial_merge_size", 2),
            hidden_size=v.get("hidden_size", hf["hidden_size"]),
        ),
        text=TextConfig(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            num_key_value_heads=hf["num_key_value_heads"],
            rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
            rope_theta=hf.get("rope_theta", 1e6),
            mrope_section=tuple(rope_scaling.get("mrope_section", (16, 24, 24))),
            max_position_embeddings=hf.get("max_position_embeddings", 32768),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
        ),
        bos_token_id=full.get("bos_token_id", hf.get("bos_token_id", 151643)),
        eos_token_id=full.get("eos_token_id", hf.get("eos_token_id", 151645)),
        vision_start_token_id=full.get("vision_start_token_id",
                                       hf.get("vision_start_token_id", 151652)),
        vision_end_token_id=full.get("vision_end_token_id",
                                     hf.get("vision_end_token_id", 151653)),
        image_token_id=full.get("image_token_id", hf.get("image_token_id", 151655)),
        video_token_id=full.get("video_token_id", hf.get("video_token_id", 151656)),
        name=os.path.basename(os.path.normpath(path)),
    )


def load_checkpoint(path: str, device="cuda",
                    dtype: torch.dtype = torch.bfloat16) -> tuple[ModelConfig, Qwen2VL]:
    """(config, model) of an HF checkpoint directory (``config.json`` and
    ``*.safetensors`` shards, with or without an index), loaded onto
    ``device`` in ``dtype`` one tensor at a time from the shards: about
    one tensor is on the host at a time. ``device`` is where the model
    runs: "cuda" raises without a card. For int8 weights an engine built
    with ``quantize_weights=True`` (or ``ops/quant.py:quantize_model``)
    then quantizes it module by module, so no module is held twice but the
    one being quantized."""
    device_for(device, "load_checkpoint")
    cfg = config_from_hf_json(path)
    with Shards(path) as shards:
        model = convert_state_dict(shards, cfg, device=device, dtype=dtype)
    return cfg, model
