"""JAX param pytree (as numpy) -> the port's ``Qwen2VL`` module.

The JAX package keeps parameters as a nested dict: layer-stacked ``[L, ...]``
arrays run under ``lax.scan``, and matrices as ``[in, out]`` kernels for
``x @ W``. The port keeps one module per layer and ``nn.Linear``'s
``[out, in]`` weights. ``params_from_jax`` maps the first onto the second,
so both packages compute the same function on the same weights (the output
of ``init_params`` or ``convert_state_dict``, moved to numpy). A tree that
JAX's ``quantize_model_params`` made holds ``{"q", "scale"}`` nodes in
place of those kernels (``q [L, in, out]`` with a scale ``[L, 1, out]``; the
embedding ``q [V, H]`` with ``[V, 1]``); their modules become the port's
``QuantLinear`` / ``QuantEmbedding`` holding the same codes (``[out, in]``)
and scales, so both packages compute on the same codes.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from livecc_tpu_torch.core.config import ModelConfig
from livecc_tpu_torch.models.qwen2_vl.model import Qwen2VL
from livecc_tpu_torch.ops.quant import (
    QuantEmbedding, QuantLinear, is_quantized, quantized_sites)

# port parameter (relative to a vision block / decoder layer) ->
# (JAX key in the stacked layer dict, transpose?)
_VISION_BLOCK = {
    "norm1.weight": ("norm1_scale", False), "norm1.bias": ("norm1_bias", False),
    "norm2.weight": ("norm2_scale", False), "norm2.bias": ("norm2_bias", False),
    "qkv.weight": ("qkv_kernel", True), "qkv.bias": ("qkv_bias", False),
    "proj.weight": ("proj_kernel", True), "proj.bias": ("proj_bias", False),
    "fc1.weight": ("fc1_kernel", True), "fc1.bias": ("fc1_bias", False),
    "fc2.weight": ("fc2_kernel", True), "fc2.bias": ("fc2_bias", False),
}
_DECODER_LAYER = {
    "input_ln.weight": ("input_ln", False), "post_ln.weight": ("post_ln", False),
    "q_proj.weight": ("q_kernel", True), "q_proj.bias": ("q_bias", False),
    "k_proj.weight": ("k_kernel", True), "k_proj.bias": ("k_bias", False),
    "v_proj.weight": ("v_kernel", True), "v_proj.bias": ("v_bias", False),
    "o_proj.weight": ("o_kernel", True),
    "gate_proj.weight": ("gate_kernel", True),
    "up_proj.weight": ("up_kernel", True),
    "down_proj.weight": ("down_kernel", True),
}


def _jax_name_map(cfg: ModelConfig) -> dict[str, tuple[tuple[str, ...], int | None, bool]]:
    """port parameter name -> (JAX key path, layer index or None, transpose?)."""
    out: dict[str, tuple[tuple[str, ...], int | None, bool]] = {
        "visual.patch_embed.weight": (("visual", "patch_embed", "kernel"), None, True),
        "visual.merger.ln_q.weight": (("visual", "merger", "ln_q_scale"), None, False),
        "visual.merger.ln_q.bias": (("visual", "merger", "ln_q_bias"), None, False),
        "visual.merger.fc1.weight": (("visual", "merger", "fc1_kernel"), None, True),
        "visual.merger.fc1.bias": (("visual", "merger", "fc1_bias"), None, False),
        "visual.merger.fc2.weight": (("visual", "merger", "fc2_kernel"), None, True),
        "visual.merger.fc2.bias": (("visual", "merger", "fc2_bias"), None, False),
        "text.embed.weight": (("text", "embed", "weight"), None, False),
        "text.final_ln.weight": (("text", "final_ln"), None, False),
    }
    if not cfg.text.tie_word_embeddings:
        out["text.lm_head.weight"] = (("text", "lm_head", "kernel"), None, True)
    for i in range(cfg.vision.depth):
        for name, (key, tr) in _VISION_BLOCK.items():
            out[f"visual.blocks.{i}.{name}"] = (("visual", "blocks", key), i, tr)
    for i in range(cfg.text.num_hidden_layers):
        for name, (key, tr) in _DECODER_LAYER.items():
            out[f"text.layers.{i}.{name}"] = (("text", "layers", key), i, tr)
    return out


def _node(tree: Mapping[str, Any], path: tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def _swap_quantized(model: Qwen2VL, tree: Mapping[str, Any],
                    names: dict[str, tuple[tuple[str, ...], int | None, bool]]) -> None:
    """Replace every module whose JAX weight is a ``{"q", "scale"}`` node by
    an empty ``QuantLinear`` / ``QuantEmbedding`` (in place, and in
    ``names``: its ``weight`` entry becomes ``q`` and ``scale`` entries)."""
    for parent, attr in quantized_sites(model):
        mod = getattr(parent, attr)
        prefix = next(n for n, m in model.named_modules() if m is mod)
        path, layer, transpose = names[f"{prefix}.weight"]
        if not is_quantized(_node(tree, path)):
            continue
        out_dim, in_dim = mod.weight.shape
        q = torch.empty((out_dim, in_dim), dtype=torch.int8, device=mod.weight.device)
        scale = torch.empty((out_dim,), dtype=mod.weight.dtype, device=mod.weight.device)
        if isinstance(mod, nn.Embedding):
            setattr(parent, attr, QuantEmbedding(q, scale))
        else:
            bias = None if mod.bias is None else mod.bias.detach()
            setattr(parent, attr, QuantLinear(q, scale, bias))
        del names[f"{prefix}.weight"]
        names[f"{prefix}.q"] = (path + ("q",), layer, transpose)
        names[f"{prefix}.scale"] = (path + ("scale",), layer, False)


@torch.no_grad()
def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig, device=None,
                    dtype=torch.float32) -> Qwen2VL:
    """Build a ``Qwen2VL`` holding the weights of a JAX param tree whose
    leaves are numpy arrays (int8 codes where the tree is quantized). Every
    port tensor must be covered."""
    model = Qwen2VL(cfg, device=device, dtype=dtype)
    names = _jax_name_map(cfg)
    _swap_quantized(model, tree, names)
    tensors = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    if set(tensors) != set(names):
        raise KeyError(f"bridge map and model disagree: {sorted(set(tensors) ^ set(names))}")
    for name, (path, layer, transpose) in names.items():
        arr = np.asarray(_node(tree, path))
        if layer is not None:
            arr = arr[layer]
        if transpose:
            arr = arr.T
        if name.endswith(".scale"):
            arr = arr.reshape(-1)
        if arr.dtype != np.int8:
            arr = np.asarray(arr, dtype=np.float32)
        src = torch.tensor(arr)
        if tuple(src.shape) != tuple(tensors[name].shape):
            raise ValueError(f"{name}: JAX {tuple(src.shape)} vs port {tuple(tensors[name].shape)}")
        tensors[name].copy_(src)
    return model
