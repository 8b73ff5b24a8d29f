"""JAX Whisper param pytree (as numpy) -> the port's ``Whisper`` module.

The JAX package stacks each side's layers on a leading axis (``lax.scan``)
and keeps matrices as ``[in, out]`` kernels and convolutions as ``[k, in,
out]`` (``livecc_tpu/models/whisper/convert.py``). ``whisper_params_from_jax``
maps that tree onto the port's per-layer modules (``[out, in]`` and ``[out,
in, k]``), so both packages compute on the same weights; it is the
counterpart of ``models/qwen2_vl/bridge.py:params_from_jax``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from livecc_tpu_torch.models.whisper.model import Whisper, WhisperConfig

# port attention module -> JAX key prefix of its projections in a layer dict
_ATTENTION = {"self_attn": "", "encoder_attn": "x"}
# port projection -> JAX (weight, bias) suffixes
_PROJ = {"q_proj": ("q_w", "q_b"), "k_proj": ("k_w", None), "v_proj": ("v_w", "v_b"),
         "out_proj": ("o_w", "o_b")}
_ENCODER_NORMS = {"self_attn_layer_norm": "ln1", "final_layer_norm": "ln2"}
_DECODER_NORMS = {"self_attn_layer_norm": "ln1", "encoder_attn_layer_norm": "ln2",
                  "final_layer_norm": "ln3"}


def _name_map(cfg: WhisperConfig) -> dict[str, tuple[tuple[str, ...], int | None, str]]:
    """port parameter -> (JAX key path, layer index or None, layout:
    "as is", "linear" ([in, out] -> [out, in]) or "conv" ([k, in, out] ->
    [out, in, k]))."""
    out = {
        "encoder.conv1.weight": (("encoder", "conv1_w"), None, "conv"),
        "encoder.conv1.bias": (("encoder", "conv1_b"), None, "as is"),
        "encoder.conv2.weight": (("encoder", "conv2_w"), None, "conv"),
        "encoder.conv2.bias": (("encoder", "conv2_b"), None, "as is"),
        "encoder.embed_positions.weight": (("encoder", "pos"), None, "as is"),
        "encoder.layer_norm.weight": (("encoder", "final_ln_w"), None, "as is"),
        "encoder.layer_norm.bias": (("encoder", "final_ln_b"), None, "as is"),
        "decoder.embed_tokens.weight": (("decoder", "embed"), None, "as is"),
        "decoder.embed_positions.weight": (("decoder", "pos"), None, "as is"),
        "decoder.layer_norm.weight": (("decoder", "final_ln_w"), None, "as is"),
        "decoder.layer_norm.bias": (("decoder", "final_ln_b"), None, "as is"),
    }
    for side, n, norms, attns in (("encoder", cfg.encoder_layers, _ENCODER_NORMS, ("self_attn",)),
                                  ("decoder", cfg.decoder_layers, _DECODER_NORMS, tuple(_ATTENTION))):
        for i in range(n):
            pre = f"{side}.layers.{i}."
            for norm, jax in norms.items():
                out[pre + norm + ".weight"] = ((side, "layers", jax + "_w"), i, "as is")
                out[pre + norm + ".bias"] = ((side, "layers", jax + "_b"), i, "as is")
            for fc in ("fc1", "fc2"):
                out[pre + fc + ".weight"] = ((side, "layers", fc + "_w"), i, "linear")
                out[pre + fc + ".bias"] = ((side, "layers", fc + "_b"), i, "as is")
            for attn in attns:
                for proj, (w, b) in _PROJ.items():
                    key = pre + f"{attn}.{proj}."
                    out[key + "weight"] = ((side, "layers", _ATTENTION[attn] + w), i, "linear")
                    if b is not None:
                        out[key + "bias"] = ((side, "layers", _ATTENTION[attn] + b), i, "as is")
    return out


@torch.no_grad()
def whisper_params_from_jax(tree: Mapping[str, Any], cfg: WhisperConfig, device=None,
                            dtype: torch.dtype = torch.float32) -> Whisper:
    """A ``Whisper`` holding the weights of a JAX Whisper param tree whose
    leaves are numpy arrays. Every port parameter must be covered."""
    model = Whisper(cfg, device=device, dtype=dtype)
    params = dict(model.named_parameters())
    names = _name_map(cfg)
    if set(params) != set(names):
        raise KeyError(f"bridge map and model disagree: {sorted(set(params) ^ set(names))}")
    for name, (path, layer, layout) in names.items():
        arr = tree
        for key in path:
            arr = arr[key]
        arr = np.asarray(arr, np.float32)
        if layer is not None:
            arr = arr[layer]
        if layout == "linear":
            arr = arr.T
        elif layout == "conv":
            arr = np.transpose(arr, (2, 1, 0))
        src = torch.tensor(np.ascontiguousarray(arr))
        if tuple(src.shape) != tuple(params[name].shape):
            raise ValueError(f"{name}: JAX {tuple(src.shape)} vs port {tuple(params[name].shape)}")
        params[name].copy_(src)
    return model
